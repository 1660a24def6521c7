"""Fq2, Fq6 and Fq12 on int64 torch lanes: the plain versions of the tower.

Counterpart of ``eth_consensus_specs_tpu/ops/fq12_tower.py``, over
``ops/field_limbs.py``. Formulas are the host oracle's
(``crypto/fields.py``): Fq2 = Fq[u]/(u^2+1), Fq6 = Fq2[v]/(v^3 - xi),
Fq12 = Fq6[w]/(w^2 - v), xi = 1 + u. Elements are loose between
operations (``field_limbs``); every function here ends in ``norm`` where
its additions would let the limbs grow, and ``fq12_is_one`` and the host
conversions canonicalize, so results equal the oracle's and the CUDA
kernels' element for element.

Layouts (leading axes free), as in the JAX package:

    Fq   [..., 15]           Montgomery limbs
    Fq2  [..., 2, 15]        (c0, c1)
    Fq6  [..., 3, 2, 15]     (c0, c1, c2)
    Fq12 [..., 2, 3, 2, 15]  (c0, c1) Fq6 halves

Independent products at each level are stacked onto a new leading axis and
go through one ``field_limbs.mul`` call (an Fq12 product is one call of 54
lanes), which is what keeps the plain path's op count low.
"""

from __future__ import annotations

import torch

from ..crypto.fields import BLS_X, FROB2_GAMMA, FROB_GAMMA, Fq6, Fq12
from . import field_limbs as fl

_S = torch.stack


def _u(a, i):
    return a[..., i, :]


def _v(a, i):
    return a[..., i, :, :]


def _h(a, i):
    return a[..., i, :, :, :]


# ------------------------------------------------------------------- Fq2 --


def fq2_mul(a, b):
    """Karatsuba: the three Fq products in one call."""
    a, b = torch.broadcast_tensors(a, b)
    s = fl.add(_S([_u(a, 0), _u(b, 0)]), _S([_u(a, 1), _u(b, 1)]))
    t0, t1, full = fl.mul(_S([_u(a, 0), _u(a, 1), s[0]]), _S([_u(b, 0), _u(b, 1), s[1]]))
    d = fl.sub(_S([t0, full]), _S([t1, t0]))
    return fl.norm(_S([d[0], fl.sub(d[1], t1)], dim=-2))


def fq2_sqr(a):
    """(c0+c1)(c0-c1) + 2 c0 c1 u."""
    a0, a1 = _u(a, 0), _u(a, 1)
    t, b = fl.mul(_S([fl.add(a0, a1), a0]), _S([fl.sub(a0, a1), a1]))
    return fl.norm(_S([t, fl.dbl(b)], dim=-2))


def fq2_mul_fp(a, s):
    """Fq2 times an Fq scalar ``s`` [..., 15]."""
    return fl.mul(a, s.unsqueeze(-2))


def fq2_mul_xi(a):
    """Multiply by xi = 1 + u: (c0 - c1, c0 + c1)."""
    a0, a1 = _u(a, 0), _u(a, 1)
    return _S([fl.sub(a0, a1), fl.add(a0, a1)], dim=-2)


def fq2_conj(a):
    return _S([_u(a, 0), fl.neg(_u(a, 1))], dim=-2)


def fq2_inv(a):
    sq = fl.sqr(a)
    ninv = fl.inv(fl.norm(fl.add(_u(sq, 0), _u(sq, 1))))
    r = fl.mul(a, ninv.unsqueeze(-2))
    return _S([_u(r, 0), fl.neg(_u(r, 1))], dim=-2)


# ------------------------------------------------------------------- Fq6 --


def fq6_mul(a, b):
    """Toom-style; the six Fq2 products in one fq2_mul call."""
    a, b = torch.broadcast_tensors(a, b)
    a0, a1, a2 = (_v(a, i) for i in range(3))
    b0, b1, b2 = (_v(b, i) for i in range(3))
    s = fl.add(_S([a1, a0, a0, b1, b0, b0]), _S([a2, a1, a2, b2, b1, b2]))
    t0, t1, t2, u12, u01, u02 = fq2_mul(_S([a0, a1, a2, s[0], s[1], s[2]]),
                                        _S([b0, b1, b2, s[3], s[4], s[5]]))
    e = fl.sub(fl.sub(_S([u12, u01, u02]), _S([t1, t0, t0])), _S([t2, t1, t2]))
    x = fq2_mul_xi(_S([e[0], t2]))
    return fl.norm(_S(list(fl.add(_S([t0, e[1], e[2]]), _S([x[0], x[1], t1]))), dim=-3))


def fq6_mul_v(a):
    """Multiply by v: (c0, c1, c2) -> (c2*xi, c0, c1)."""
    return _S([fq2_mul_xi(_v(a, 2)), _v(a, 0), _v(a, 1)], dim=-3)


def fq6_inv(a):
    av, b, c = (_v(a, i) for i in range(3))
    sq_av, sq_c, sq_b, bc, avb, avc = fq2_mul(_S([av, c, b, b, av, av]), _S([av, c, b, c, b, c]))
    x = fq2_mul_xi(_S([bc, sq_c]))
    t = fl.norm(fl.sub(_S([sq_av, x[1], sq_b]), _S([x[0], avb, avc])))
    d0, d1, d2 = fq2_mul(_S([av, c, b]), t)
    denom = fq2_inv(fl.norm(fl.add(d0, fq2_mul_xi(fl.add(d1, d2)))))
    return _S(list(fq2_mul(t, denom.unsqueeze(0))), dim=-3)


# ------------------------------------------------------------------ Fq12 --


def fq12_mul(a, b):
    """Karatsuba over the Fq6 halves: one call of 54 Fq products."""
    a, b = torch.broadcast_tensors(a, b)
    s = fl.add(_S([_h(a, 0), _h(b, 0)]), _S([_h(a, 1), _h(b, 1)]))
    t0, t1, full = fq6_mul(_S([_h(a, 0), _h(a, 1), s[0]]), _S([_h(b, 0), _h(b, 1), s[1]]))
    c0 = fl.add(t0, fq6_mul_v(t1))
    c1 = fl.sub(fl.sub(full, t0), t1)
    return fl.norm(_S([c0, c1], dim=-4))


def fq12_sqr(a):
    """Complex squaring: c0 = (a0+a1)(a0+v a1) - ab - v ab, c1 = 2ab,
    with ab = a0 a1 (two Fq6 products, one call)."""
    a0, a1 = _h(a, 0), _h(a, 1)
    ab, prod = fq6_mul(_S([a0, fl.add(a0, a1)]), _S([a1, fl.norm(fl.add(a0, fq6_mul_v(a1)))]))
    c0 = fl.sub(fl.sub(prod, ab), fq6_mul_v(ab))
    return fl.norm(_S([c0, fl.dbl(ab)], dim=-4))


def fq12_conj(a):
    return _S([_h(a, 0), fl.neg(_h(a, 1))], dim=-4)


def fq12_inv(a):
    sq0, sq1 = fq6_mul(_S([_h(a, 0), _h(a, 1)]), _S([_h(a, 0), _h(a, 1)]))
    t = fq6_inv(fl.norm(fl.sub(sq0, fq6_mul_v(sq1))))
    r0, r1 = fq6_mul(_S([_h(a, 0), _h(a, 1)]), t.unsqueeze(0))
    return _S([r0, fl.neg(r1)], dim=-4)


def _coeff_table(gammas, in_fq: bool, device) -> torch.Tensor:
    """Coefficient i of f = sum a_i w^i sits at [half i % 2][v i // 2]."""
    g = [[gammas[2 * v + h] for v in range(3)] for h in range(2)]
    if in_fq:
        return fl.from_ints([[[e.c0.n] for e in row] for row in g], device)
    return fl.from_ints([[[e.c0.n, e.c1.n] for e in row] for row in g], device)


_TABLES: dict = {}


def _table(name: str, device) -> torch.Tensor:
    key = (name, str(device))
    if key not in _TABLES:
        frob1 = name == "frob1"
        _TABLES[key] = _coeff_table(FROB_GAMMA if frob1 else FROB2_GAMMA, not frob1, device)
    return _TABLES[key]


def fq12_frobenius(a):
    """f -> f^p: conjugate each Fq2 coefficient, times gamma1_i."""
    return fq2_mul(fq2_conj(a), _table("frob1", a.device))


def fq12_frobenius2(a):
    """f -> f^(p^2): each coefficient times gamma2_i, which lie in Fq."""
    return fl.mul(a, _table("frob2", a.device))


def fq12_one(batch_shape=(), device="cpu") -> torch.Tensor:
    one = fl.from_ints(Fq12.one().ints(), device).reshape(2, 3, 2, fl.N_LIMBS)
    return one.expand(*batch_shape, 2, 3, 2, fl.N_LIMBS).clone()


def fq12_is_one(a) -> torch.Tensor:
    return (fl.canon(a) == fq12_one(device=a.device)).flatten(-4).all(dim=-1)


def _fq4_sqr(a, b):
    """(a + b s)^2 in Fq4 = Fq2[s]/(s^2 - xi), for stacked Fq2 pairs:
    (a^2 + xi b^2, (a + b)^2 - a^2 - b^2), three Fq2 squarings each."""
    sq = fq2_sqr(_S([a, b, fl.add(a, b)]))
    t0, t1 = sq[0], sq[1]
    return fl.add(t0, fq2_mul_xi(t1)), fl.sub(fl.sub(sq[2], t0), t1)


def fq12_cyclotomic_sqr(a):
    """Granger-Scott squaring, valid for a in the cyclotomic subgroup (after
    the easy part of a final exponentiation): nine Fq2 squarings in one call,
    against fq12_sqr's two Fq6 products. Fq12 is read as Fq4^3 with the pairs
    (z0, z1) = ([0][0], [1][1]), (z2, z3) = ([1][0], [0][2]) and
    (z4, z5) = ([0][1], [1][2]) of the [half][v] layout; with
    (t0, t1) = fq4_sqr(z0, z1), (t2, t3) = fq4_sqr(z2, z3) and
    (t4, t5) = fq4_sqr(z4, z5) the square is
    z0' = 3 t0 - 2 z0, z1' = 3 t1 + 2 z1, z4' = 3 t2 - 2 z4,
    z5' = 3 t3 + 2 z5, z2' = 3 xi t5 + 2 z2, z3' = 3 t4 - 2 z3."""
    z = [[_v(_h(a, h), v) for v in range(3)] for h in range(2)]
    c0, c1 = _fq4_sqr(_S([z[0][0], z[1][0], z[0][1]]), _S([z[1][1], z[0][2], z[1][2]]))
    t = _S([c0[0], c1[0], c0[1], c1[1], fq2_mul_xi(c1[2]), c0[2]])
    # rows as above: z0', z1', z4', z5', z2', z3'
    zs = _S([z[0][0], z[1][1], z[0][1], z[1][2], z[1][0], z[0][2]])
    sign = torch.tensor([-1, 1, -1, 1, 1, -1], dtype=zs.dtype, device=zs.device)
    sign = sign.reshape(6, *([1] * (zs.dim() - 1)))
    out = fl.norm(fl.add(fl.add(fl.dbl(t), t), fl.dbl(zs) * sign))
    return _S([_S([out[0], out[2], out[5]], dim=-3), _S([out[4], out[1], out[3]], dim=-3)],
              dim=-4)


_BLS_X_ABS_BITS = bin(-BLS_X)[3:]  # after the leading 1


def fq12_powx(a):
    """a^x for the negative BLS parameter, a cyclotomic: a^|x| by
    square-and-multiply with Granger-Scott squarings, then conjugated
    (inversion in the cyclotomic subgroup)."""
    acc = a
    for bit in _BLS_X_ABS_BITS:
        acc = fq12_cyclotomic_sqr(acc)
        if bit == "1":
            acc = fq12_mul(acc, a)
    return fq12_conj(acc)


def fq12_mul_line(f, py, a3, a5):
    """f * (py + a3 w^3 + a5 w^5), sparse. For an Fq6 half (s0, s1, s2),
    (s0, s1, s2) * (0, a3, a5) = (xi(s1 a5 + s2 a3), s0 a3 + xi s2 a5,
    s0 a5 + s1 a3): twelve Fq2 products over both halves in one call, and
    the twelve py * Fq products in another."""
    halves = [_h(f, 0), _h(f, 1)]
    lhs, rhs = [], []
    for s in halves:
        s0, s1, s2 = (_v(s, i) for i in range(3))
        lhs += [s1, s2, s0, s2, s0, s1]
        rhs += [a5, a3, a3, a5, a5, a3]
    p = fq2_mul(_S(lhs), _S(rhs))
    sums = fl.add(_S([p[0], p[4], p[6], p[10]]), _S([p[1], p[5], p[7], p[11]]))
    xi = fq2_mul_xi(_S([sums[0], p[3], sums[2], p[9]]))
    mid = fl.add(_S([p[2], p[8]]), _S([xi[1], xi[3]]))
    sp0 = _S([xi[0], mid[0], sums[1]], dim=-3)
    sp1 = _S([xi[2], mid[1], sums[3]], dim=-3)
    scaled = fl.mul(f, py[..., None, None, None, :])
    c0 = fl.add(_h(scaled, 0), fq6_mul_v(sp1))
    c1 = fl.add(_h(scaled, 1), sp0)
    return fl.norm(_S([c0, c1], dim=-4))


# ------------------------------------------------------------ host <-> ----


def fq12_from_host(fs, device="cpu") -> torch.Tensor:
    """Host Fq12 element(s) -> limbs [..., 2, 3, 2, 15]."""
    if isinstance(fs, Fq12):
        return fl.from_ints(fs.ints(), device).reshape(2, 3, 2, fl.N_LIMBS)
    return torch.stack([fq12_from_host(f, device) for f in fs])


def fq12_to_host(a: torch.Tensor):
    """Limbs [..., 2, 3, 2, 15] -> host Fq12 (a list for a batch)."""
    if a.dim() == 4:
        return Fq12.from_ints(fl.to_ints(a.reshape(12, fl.N_LIMBS)))
    return [fq12_to_host(x) for x in a]


def fq6_from_host(e: Fq6, device="cpu") -> torch.Tensor:
    return fl.from_ints([[c.c0.n, c.c1.n] for c in (e.c0, e.c1, e.c2)], device)
