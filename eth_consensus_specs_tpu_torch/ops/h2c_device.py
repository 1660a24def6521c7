"""Batched hash-to-G2 on the card (RFC 9380 BLS12381G2_XMD:SHA-256_SSWU_RO_):
kernels K13 ``h2c_map`` and K14 ``h2c_finish``.

Counterpart of ``eth_consensus_specs_tpu/ops/h2c_device.py``, with its split
of the pipeline:

* ``hash_to_field`` stays on the host (SHA-256 of short inputs, as in JAX
  :361): every message gives two Fq2 elements u0, u1;
* **K13** ``h2c_map`` (JAX ``_h2c_map`` :307): the simplified SWU map on
  E2' of both elements (``_map_to_curve_sswu`` :224, with the norm-method
  Fq2 square root ``_fq2_sqrt_batch`` :164 and the sgn0 fix-up :147), the
  3-isogeny into Jacobian coordinates (``_iso_map_jacobian`` :270), and the
  complete add of the message's two points (``g2_jacobian.g2_add``);
* **K14** ``h2c_finish`` (JAX ``_h2c_finish`` :333): Budroni-Pintore
  cofactor clearing and the affine conversion by one Fq2 inversion
  (``g2_jacobian`` :156-231), on the cooperative round engine's G2
  programs (``ops/fq12_coop.py``), a warp a point.

The plain versions here mirror the JAX program step by step (its
branchless square root included, so a CPU test holds the root choice
against JAX's). The kernels may take their own road to the affine SSWU
point (it is unique: x is x1 exactly when g(x1) is a square, and sgn0 fixes
y's sign), and then apply the same isogeny and add formulas, so K13's
Jacobian words equal the plain version's.

Boundary (``int32[..., 12]`` little-endian u32 words): K13 takes the u
values canonical, ``[B, 2, 2, 12]`` (message, element, c0/c1), and returns
the Jacobian sums ``[B, 3, 2, 12]`` (X, Y, Z) in the card's Montgomery form
(x * 2^384 mod p), which K14 takes as they are; K14 returns the affine
points canonical, ``[B, 2, 2, 12]`` (x, y), and an infinity flag
``int32[B]`` (x = y = 0 where it is set). The JAX entry pads the batch to a
power of two to spare XLA a retrace; a prebuilt kernel has no such cost,
so the port takes the exact count.
"""

from __future__ import annotations

import time

import torch

from .. import _ext
from ..crypto import hash_to_curve as h2c
from ..crypto.curve import B2, Point
from ..crypto.fields import P as P_INT
from ..crypto.fields import Fq2
from ..device import default_device
from . import field_limbs as fl
from . import fq12_tower as tw
from . import g2_jacobian as gj

N_WORDS = fl.N_WORDS
_S = torch.stack

E_SQRT = (P_INT + 1) // 4
E_INV = P_INT - 2
_WINDOW = 4


def _fq2_ints(a: Fq2) -> list[int]:
    return [a.c0.n, a.c1.n]


# the curve constants of the map, as canonical ints (made into limbs per device)
_CONST_INTS = {
    "A": _fq2_ints(h2c.A_PRIME),
    "B": _fq2_ints(h2c.B_PRIME),
    "Z": _fq2_ints(h2c.Z_SSWU),
    "one2": [1, 0],
    "neg_b_over_a": _fq2_ints(-h2c.B_PRIME * h2c.A_PRIME.inv()),
    "b_over_za": _fq2_ints(h2c.B_PRIME * (h2c.Z_SSWU * h2c.A_PRIME).inv()),
    "inv2": pow(2, P_INT - 2, P_INT),
    # (-1)^((p+1)/4): the (p+1)/4 power of a times it is that of -a
    "zeta": pow(P_INT - 1, E_SQRT, P_INT),
    "K1": [_fq2_ints(c) for c in h2c._K1],
    "K2": [_fq2_ints(c) for c in h2c._K2],
    "K3": [_fq2_ints(c) for c in h2c._K3],
    "K4": [_fq2_ints(c) for c in h2c._K4],
}
_CONST: dict = {}


def _c(name: str, device) -> torch.Tensor:
    key = (name, str(device))
    if key not in _CONST:
        _CONST[key] = fl.from_ints(_CONST_INTS[name], device)
    return _CONST[key]


# ------------------------------------------------------------- primitives --


def _pow_lanes(x: torch.Tensor, e: int) -> torch.Tensor:
    """x^e over any batch shape (Fq limbs ``[..., 15]``), four-bit fixed
    window; every lane shares the public exponent."""
    table = [fl.one_like(x), fl.norm(x)]
    for _ in range(2, 1 << _WINDOW):
        table.append(fl.mul(table[-1], table[1]))
    acc = None
    top = (e.bit_length() + _WINDOW - 1) // _WINDOW * _WINDOW
    for shift in range(top - _WINDOW, -1, -_WINDOW):
        digit = (e >> shift) & ((1 << _WINDOW) - 1)
        if acc is None:
            acc = table[digit]
            continue
        for _ in range(_WINDOW):
            acc = fl.sqr(acc)
        if digit:
            acc = fl.mul(acc, table[digit])
    return acc


def _fq2_eq(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return fl.eq(a, b).all(dim=-1)


def _selq(mask, a, b):
    """Per-lane mask ? a : b for Fq values ``[..., 15]``."""
    return torch.where(mask[..., None], a, b)


def _sgn0(x: torch.Tensor) -> torch.Tensor:
    """RFC 9380 sgn0 for m = 2, on the plain value: the Montgomery factor
    comes off first (``from_mont``), then the parity of the first nonzero
    coordinate."""
    c = fl.from_mont(x)  # canonical limbs [..., 2, 15]
    sign = c[..., 0] & 1
    zero_0 = (c[..., 0, :] == 0).all(dim=-1)
    return (sign[..., 0] | (zero_0.to(sign.dtype) & sign[..., 1])).bool()


# ------------------------------------------------------------- Fq2 sqrt --


def _fq2_sqrt_batch(v: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(root, ok) of Fq2 values ``[..., 2, 15]``: the norm method of the
    host ``Fq2.sqrt``, every branch computed and lane-selected (JAX :164),
    so the root is the host's own choice; ok is False on a non-square."""
    a, b = v[..., 0, :], v[..., 1, :]
    b_zero = fl.is_zero(b)
    v_zero = fl.is_zero(a) & b_zero
    sq = fl.sqr(_S([a, b]))
    norm = fl.add(sq[0], sq[1])
    sn, s_bz = _pow_lanes(_S([norm, a]), E_SQRT)

    # b == 0: s_bz if it squares to a, else zeta * s_bz (the root of -a) times u
    bz_ok = fl.eq(fl.sqr(s_bz), a)
    s_alt = fl.mul(_c("zeta", v.device), s_bz)
    zero = torch.zeros_like(s_bz)
    out_bz = _S([_selq(bz_ok, s_bz, zero), _selq(bz_ok, zero, s_alt)], dim=-2)

    # the general branch
    sn_ok = fl.eq(fl.sqr(sn), norm)
    half_p, half_m = fl.mul(_S([fl.add(a, sn), fl.sub(a, sn)]), _c("inv2", v.device))
    x_p, x_m = _pow_lanes(_S([half_p, half_m]), E_SQRT)
    xp_ok = fl.eq(fl.sqr(x_p), half_p) & ~fl.is_zero(x_p)
    xm_ok = fl.eq(fl.sqr(x_m), half_m) & ~fl.is_zero(x_m)
    ixp, ixm = _pow_lanes(_S([fl.dbl(x_p), fl.dbl(x_m)]), E_INV)
    y_p, y_m = fl.mul(_S([b, b]), _S([ixp, ixm]))
    cand_p = _S([fl.norm(x_p), y_p], dim=-2)
    cand_m = _S([fl.norm(x_m), y_m], dim=-2)
    cp_ok = xp_ok & _fq2_eq(tw.fq2_sqr(cand_p), v)
    cm_ok = xm_ok & _fq2_eq(tw.fq2_sqr(cand_m), v)
    gen_root = gj.sel(cp_ok, cand_p, cand_m)
    gen_ok = sn_ok & (cp_ok | cm_ok)

    root = gj.sel(b_zero, out_bz, gen_root)
    ok = torch.where(b_zero, torch.ones_like(gen_ok), gen_ok)
    root = gj.sel(v_zero, torch.zeros_like(root), root)
    return root, ok


# ------------------------------------------------------------------ SSWU --


def _map_to_curve_sswu(u: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Affine (x', y') on E2' of Fq2 limbs ``[N, 2, 15]``: the branch
    structure of the host ``map_to_curve_sswu_g2``, lane-selected."""
    dev = u.device
    A, B, Z = _c("A", dev), _c("B", dev), _c("Z", dev)
    tv1 = tw.fq2_mul(Z, tw.fq2_sqr(u))
    tv2 = fl.norm(fl.add(tw.fq2_sqr(tv1), tv1))
    tv2_zero = gj.fq2_is_zero(tv2)

    # x1 = (-B/A) (1 + 1/tv2), the inverse through the norm; the zero lane
    # takes the exceptional x1 = B/(Z A)
    t_a, t_b = tv2[..., 0, :], tv2[..., 1, :]
    sq = fl.sqr(_S([t_a, t_b]))
    tnorm = fl.norm(fl.add(sq[0], sq[1]))
    tnorm = _selq(tv2_zero, fl.one_like(tnorm), tnorm)
    tni = _pow_lanes(tnorm, E_INV)
    ia, ib = fl.mul(_S([t_a, fl.neg(t_b)]), tni)
    tv2_inv = _S([ia, ib], dim=-2)
    x1_reg = tw.fq2_mul(_c("neg_b_over_a", dev), fl.add(_c("one2", dev), tv2_inv))
    x1 = gj.sel(tv2_zero, _c("b_over_za", dev).expand_as(x1_reg), x1_reg)

    def gx(x):
        return fl.norm(fl.add(tw.fq2_mul(fl.add(tw.fq2_sqr(x), A), x), B))

    x2 = tw.fq2_mul(tv1, x1)
    gx1, gx2 = gx(_S([x1, x2]))
    (y1, y2), (ok1, _) = _fq2_sqrt_batch(_S([gx1, gx2]))  # one of the two is a square
    x = gj.sel(ok1, x1, x2)
    y = gj.sel(ok1, y1, y2)
    flip = _sgn0(u) != _sgn0(y)
    return x, gj.sel(flip, fl.norm(fl.neg(y)), y)


def _iso_map_jacobian(x: torch.Tensor, y: torch.Tensor) -> tuple:
    """The 3-isogeny E2' -> E2 into Jacobian coordinates, no inversion:
    Z = xd yd, X = xn xd yd^2, Y = y yn xd^3 yd^2. A pole (xd or yd = 0)
    lands on Z = 0, infinity."""
    def horner(name):
        k = _c(name, x.device)
        acc = k[-1].expand_as(x)
        for i in range(k.shape[0] - 2, -1, -1):
            acc = fl.norm(fl.add(tw.fq2_mul(acc, x), k[i]))
        return acc

    xn, xd, yn, yd = (horner(n) for n in ("K1", "K2", "K3", "K4"))
    z, yd2, xd2, xnd, yyn = tw.fq2_mul(_S([xd, yd, xd, xn, y]), _S([yd, yd, xd, xd, yn]))
    X = tw.fq2_mul(xnd, yd2)
    Y = tw.fq2_mul(tw.fq2_mul(yyn, tw.fq2_mul(xd2, xd)), yd2)
    return X, Y, z


# ---------------------------------------------------------- the two stages --


def h2c_map_ref(u: torch.Tensor) -> torch.Tensor:
    """Plain version of K13: canonical u words ``int32[B, 2, 2, 12]`` ->
    the Jacobian sums of each message's two mapped points,
    ``int32[B, 3, 2, 12]`` in the card's Montgomery words."""
    n = u.shape[0]
    limbs = fl.from_words(u)
    x, y = _map_to_curve_sswu(torch.cat([limbs[:, 0], limbs[:, 1]]))
    X, Y, Z = _iso_map_jacobian(x, y)
    s = gj.g2_add((X[:n], Y[:n], Z[:n]), (X[n:], Y[n:], Z[n:]))
    return _S([fl.to_card_words(c) for c in s], dim=1)


def h2c_finish_ref(jac: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain version of K14: Jacobian sums ``int32[B, 3, 2, 12]`` (card
    Montgomery words) -> cofactor-cleared affine points, canonical
    ``int32[B, 2, 2, 12]``, and the infinity flags ``int32[B]``."""
    p = tuple(fl.from_card_words(jac[:, i]) for i in range(3))
    x, y, inf = gj.g2_to_affine(gj.g2_clear_cofactor(p))
    return _S([fl.to_words(x), fl.to_words(y)], dim=1), inf.to(torch.int32)


def _check(t: torch.Tensor, inner: tuple, what: str) -> None:
    if t.dim() != 1 + len(inner) or tuple(t.shape[1:]) != inner or t.shape[0] < 1:
        raise ValueError(f"{what}: expected int32[B, {', '.join(map(str, inner))}], "
                         f"got {tuple(t.shape)}")


def h2c_map(u: torch.Tensor) -> torch.Tensor:
    """K13: canonical u words ``[B, 2, 2, 12]`` -> Jacobian sums
    ``[B, 3, 2, 12]`` (card Montgomery words). CUDA tensors go through the
    kernel (``csrc/h2c.cu``, one launch), CPU tensors through the plain
    version."""
    _check(u, (2, 2, N_WORDS), "h2c_map")
    if u.device.type == "cpu":
        return h2c_map_ref(u)
    _ext.check_cuda(u, torch.int32)
    out = torch.empty((u.shape[0], 3, 2, N_WORDS), dtype=torch.int32, device=u.device)
    _ext.launch("h2c", "h2c_map_launch", u.device, _ext.ptr(u), _ext.ptr(out), u.shape[0],
                counter="h2c_map")
    return out


def h2c_finish(jac: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """K14: Jacobian sums ``[B, 3, 2, 12]`` (card Montgomery words) ->
    (canonical affine ``[B, 2, 2, 12]``, infinity flags ``int32[B]``). CUDA
    tensors go through the kernel (``csrc/h2c.cu``: a warp a point on the
    round engine's G2 programs, the doublings on four lanes a product, the
    affine step's Fq inverse a binary GCD on one thread), CPU tensors
    through the plain version."""
    _check(jac, (3, 2, N_WORDS), "h2c_finish")
    if jac.device.type == "cpu":
        return h2c_finish_ref(jac)
    _ext.check_cuda(jac, torch.int32)
    n = jac.shape[0]
    xy = torch.empty((n, 2, 2, N_WORDS), dtype=torch.int32, device=jac.device)
    inf = torch.empty((n,), dtype=torch.int32, device=jac.device)
    _ext.launch("h2c", "h2c_finish_launch", jac.device, _ext.ptr(jac), _ext.ptr(xy),
                _ext.ptr(inf), n, counter="h2c_finish")
    return xy, inf


def fq2_sqrt(v: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The kernels' Fq2 square root on canonical words ``int32[N, 2, 12]``
    -> (root words ``[N, 2, 12]``, ok ``int32[N]``); a check of the device
    function K13 uses, on values no message is known to reach (the b = 0
    branch). CUDA tensors go through ``csrc/h2c.cu``'s test entry, whose
    root may be the negation of the plain one; CPU tensors through the plain
    ``_fq2_sqrt_batch``."""
    _check(v, (2, N_WORDS), "fq2_sqrt")
    if v.device.type == "cpu":
        root, ok = _fq2_sqrt_batch(fl.from_words(v))
        return fl.to_words(root), ok.to(torch.int32)
    _ext.check_cuda(v, torch.int32)
    root = torch.empty_like(v)
    ok = torch.empty((v.shape[0],), dtype=torch.int32, device=v.device)
    _ext.launch("h2c", "fq2_sqrt_launch", v.device, _ext.ptr(v), _ext.ptr(root), _ext.ptr(ok),
                v.shape[0], counter="fq2_sqrt")
    return root, ok


# ------------------------------------------- K13's steps on host ints --
#
# csrc/h2c.cu map_to_curve_sswu in its order, on canonical ints (the card's
# Montgomery words are these values times R), counting the Fq products the
# kernel takes: a CPU test holds it against the host SSWU map, and
# chip_smoke.py takes the counts for K13's design chain.

POW_WINDOW = 4  # bits of a window of K13's two powers


def _n_zz() -> int:
    return (h2c.Z_SSWU.c0.n ** 2 + h2c.Z_SSWU.c1.n ** 2) % P_INT


# N(Z) c with c = (-N(Z))^((p+1)/4), a root of -N(Z) (csrc/h2c.cu SSWU_NORM_C)
SSWU_NORM_C = _n_zz() * pow(P_INT - _n_zz(), E_SQRT, P_INT) % P_INT


class _Steps:
    """Host Fq and Fq2 arithmetic as the kernel's one thread runs it (Fq2
    products Karatsuba, 3 Fq products; squarings 2), counting products."""

    def __init__(self):
        self.products = 0

    def mul(self, a: int, b: int) -> int:
        self.products += 1
        return a * b % P_INT

    def mul2(self, a, b):
        t0, t1 = self.mul(a[0], b[0]), self.mul(a[1], b[1])
        full = self.mul(a[0] + a[1], b[0] + b[1])
        return ((t0 - t1) % P_INT, (full - t0 - t1) % P_INT)

    def sqr2(self, a):
        t = self.mul(a[0] + a[1], a[0] - a[1])
        return (t, 2 * self.mul(a[0], a[1]) % P_INT)

    def norm(self, a) -> int:
        return (self.mul(a[0], a[0]) + self.mul(a[1], a[1])) % P_INT

    def pow(self, x: int, e: int) -> int:
        """x^e in fixed windows of POW_WINDOW bits from the top window: the
        table x^0..x^15 (a squaring and 13 products), then four squarings
        and, for a nonzero digit, a product a window (fp_pow_sqrt)."""
        table = [1, x, self.mul(x, x)]
        for _ in range(3, 1 << POW_WINDOW):
            table.append(self.mul(table[-1], x))
        top = (e.bit_length() - 1) // POW_WINDOW
        acc = table[(e >> (POW_WINDOW * top)) & 15]
        for w in range(top - 1, -1, -1):
            for _ in range(POW_WINDOW):
                acc = self.mul(acc, acc)
            d = (e >> (POW_WINDOW * w)) & 15
            if d:
                acc = self.mul(acc, table[d])
        return acc

    def root_from_norm(self, v, sn: int):
        """A root of the square v = a + b u from a root sn of N(v): one
        power of h = (a + sn)/2 (fp2_root_from_norm)."""
        inv2 = pow(2, P_INT - 2, P_INT)
        h = self.mul(v[0] + sn, inv2)
        if h == 0:
            h = v[0]
        t = self.pow(h, (P_INT - 3) // 4)
        x = self.mul(t, h)
        if self.mul(x, x) == h:
            return (x, self.mul(self.mul(v[1], t), inv2))
        return (self.mul(self.mul(v[1], t), inv2), (-self.mul(h, t)) % P_INT)


WARP = 32  # K13's elements a warp, which share one inverse
# a lane's products in warp_batch_inverse: at most 5 + 5 in the prefix and
# suffix scans, lane 0's product by R^3 after the GCD, the two of 1/n_i
BATCH_INVERSE_PRODUCTS = 13


def warp_inverse(norms: list[int]) -> tuple[list[int], int]:
    """K13's ``warp_batch_inverse`` on host ints: the inverses of a warp's
    norms (values, none zero; a lane with tv2 = 0 or no element holds 1)
    by prefix and suffix products, the binary GCD of the total's Montgomery
    words (x R -> (x R)^-1, then a product by R^3: x^-1 R, the value x^-1)
    and two products a lane; and the GCD's steps."""
    from .fq12_coop import gcd_inverse

    n = list(norms) + [1] * (WARP - len(norms))
    pre, suf = n[:], n[:]
    d = 1
    while d < WARP:  # Hillis-Steele scans, as the shuffles run them
        pre = [pre[i] * pre[i - d] % P_INT if i >= d else pre[i] for i in range(WARP)]
        suf = [suf[i] * suf[i + d] % P_INT if i + d < WARP else suf[i] for i in range(WARP)]
        d *= 2
    r = 1 << 384
    inv_total, steps = gcd_inverse(pre[-1] * r % P_INT)
    inv_total = inv_total * r % P_INT
    out = [inv_total * (pre[i - 1] if i else 1) % P_INT * (suf[i + 1] if i + 1 < WARP else 1)
           % P_INT for i in range(WARP)]
    return out[: len(norms)], steps


def tv2_norm(u: list[int]) -> int:
    """N(tv2) of one element u (canonical ints), tv2 = Z^2 u^4 + Z u^2: the
    value K13's warp inverts (1 where tv2 = 0)."""
    st = _Steps()
    Z = tuple(_CONST_INTS["Z"])
    tv1 = st.mul2(Z, st.sqr2(tuple(v % P_INT for v in u)))
    tv1_2 = st.sqr2(tv1)
    tv2 = tuple((a + b) % P_INT for a, b in zip(tv1_2, tv1))
    return st.norm(tv2) if tv2 != (0, 0) else 1


def map_steps(u: list[int], ninv: int | None = None) -> tuple[tuple, tuple, int]:
    """(x, y, Fq products) of K13's SSWU map of one element u = [c0, c1]
    (canonical ints), in the kernel's step order: the prelude, the tv2
    inverse from ``ninv`` = 1/N(tv2) (the warp's, ``warp_inverse``; taken
    here by Fermat where not given, counted as a lane's share of the warp's
    inverse, BATCH_INVERSE_PRODUCTS), the norm power of g(x1) that also
    decides the candidate, g(x2)'s norm root by products with SSWU_NORM_C,
    one h power, sgn0."""
    st = _Steps()
    A, B, Z = (tuple(_CONST_INTS[k]) for k in ("A", "B", "Z"))
    u = tuple(v % P_INT for v in u)
    tv1 = st.mul2(Z, st.sqr2(u))
    tv1_2 = st.sqr2(tv1)
    tv2 = tuple((a + b) % P_INT for a, b in zip(tv1_2, tv1))
    if tv2 != (0, 0):
        st.norm(tv2)
    st.products += BATCH_INVERSE_PRODUCTS
    if tv2 == (0, 0):
        x = tuple(_CONST_INTS["b_over_za"])
    else:
        if ninv is None:
            ninv = pow(tv2_norm(u), P_INT - 2, P_INT)
        t = (st.mul(tv2[0], ninv), (-st.mul(tv2[1], ninv)) % P_INT)
        x = st.mul2(tuple(_CONST_INTS["neg_b_over_a"]), ((t[0] + 1) % P_INT, t[1]))

    def g(x):
        x2 = st.sqr2(x)
        t = st.mul2(((x2[0] + A[0]) % P_INT, (x2[1] + A[1]) % P_INT), x)
        return ((t[0] + B[0]) % P_INT, (t[1] + B[1]) % P_INT)

    gx = g(x)
    n = st.norm(gx)
    s = st.pow(n, E_SQRT)
    if st.mul(s, s) == n:
        sn = s
    else:
        gx = st.mul2(st.mul2(tv1_2, tv1), gx)
        x = st.mul2(tv1, x)
        nu = st.norm(u)
        sn = st.mul(st.mul(st.mul(st.mul(nu, nu), nu), SSWU_NORM_C), s)
    y = st.root_from_norm(gx, sn)
    st.products += 2  # sgn0(y): y leaves the Montgomery form

    def sgn0(a):
        return (a[0] & 1) | ((a[0] == 0) & (a[1] & 1))

    if sgn0(y) != sgn0(u):
        y = ((-y[0]) % P_INT, (-y[1]) % P_INT)
    return x, y, st.products


# ------------------------------------------------------------- host side --


def field_elements(msgs: list[bytes], dst: bytes = h2c.DST_G2) -> list:
    """hash_to_field on the host: per message its two Fq2 elements as
    canonical ints ``[[u0.c0, u0.c1], [u1.c0, u1.c1]]``."""
    return [[_fq2_ints(e) for e in h2c.hash_to_field_fq2(bytes(m), 2, dst)] for m in msgs]


def points_from_words(xy: torch.Tensor, inf: torch.Tensor) -> list[Point]:
    """K14's output -> affine G2 Points."""
    vals = fl.words_to_ints(xy)
    flags = inf.cpu().tolist()
    return [Point.infinity(B2) if f else Point(Fq2.from_ints(*x), Fq2.from_ints(*y), B2)
            for (x, y), f in zip(vals, flags)]


def hash_to_g2_device(msgs: list[bytes], dst: bytes = h2c.DST_G2, device=None,
                      parts: dict | None = None) -> list[Point]:
    """Batched hash-to-G2: ``[hash_to_g2(m, dst) for m in msgs]`` with the
    field-to-curve pipeline on ``device`` (the card by default: K13 then
    K14, one launch each) and ``hash_to_field`` on the host. ``parts``,
    where given, collects the seconds of the host hashing
    (``h2c.hash_to_field``), the two stages up to their results
    (``h2c.kernels``) and the conversion to Points (``h2c.points``)."""
    if not msgs:
        return []
    dev = default_device(device)
    t0 = time.perf_counter()
    u = torch.from_numpy(fl.ints_to_words(field_elements(msgs, dst))).to(dev)
    t1 = time.perf_counter()
    xy, inf = h2c_finish(h2c_map(u))
    xy, inf = xy.cpu(), inf.cpu()
    t2 = time.perf_counter()
    out = points_from_words(xy, inf)
    if parts is not None:
        for name, dt in (("h2c.hash_to_field", t1 - t0), ("h2c.kernels", t2 - t1),
                         ("h2c.points", time.perf_counter() - t2)):
            parts[name] = parts.get(name, 0.0) + dt
    return out
