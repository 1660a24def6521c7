"""Batched G2 (E'(Fq2)) Jacobian arithmetic on int64 torch lanes: the plain
versions of the device functions in ``csrc/g2_jac.cuh``.

Counterpart of ``eth_consensus_specs_tpu/ops/g2_jacobian.py``: ``g2_dbl``
(:74), the complete ``g2_add`` (:95, every case chosen by lane mask),
``g2_neg`` (:152), the fixed [|x|] ladder ``g2_mul_z`` (:156), ``g2_psi``
(:195), Budroni-Pintore ``g2_clear_cofactor`` (:210) and ``g2_to_affine``
(:225). A point is a tuple ``(X, Y, Z)`` of Fq2 limb tensors
``[..., 2, 15]`` (``ops/field_limbs``, Montgomery R = 2^390), batched over
the leading axes; Z = 0 is infinity. The formulas are the JAX package's, so
the plain version, the CUDA kernels (K13-K15) and the JAX program give the
same Jacobian coordinates, not only the same points: the kernels' words are
held against these with ``torch.equal``.
"""

from __future__ import annotations

import torch

from ..crypto.curve import BLS_X_ABS, PSI_X, PSI_Y
from . import field_limbs as fl
from . import fq12_tower as tw

_S = torch.stack


def fq2_is_zero(a: torch.Tensor) -> torch.Tensor:
    return fl.is_zero(a).all(dim=-1)


def sel(mask: torch.Tensor, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Per-lane mask ? a : b for Fq2 values ``[..., 2, 15]``."""
    return torch.where(mask[..., None, None], a, b)


def sel_point(mask, p: tuple, q: tuple) -> tuple:
    return tuple(sel(mask, a, b) for a, b in zip(p, q))


def g2_dbl(p: tuple) -> tuple:
    """2P, dbl-2009-l (a = 0): Y = 0 or Z = 0 give Z3 = 0 (Z3 = 2YZ)."""
    X, Y, Z = p
    A, B, YZ = tw.fq2_mul(_S([X, Y, Y]), _S([X, Y, Z]))
    C, t = tw.fq2_sqr(_S([B, fl.add(X, B)]))
    D = fl.norm(fl.dbl(fl.sub(fl.sub(t, A), C)))
    E = fl.norm(fl.add(fl.dbl(A), A))
    X3 = fl.norm(fl.sub(tw.fq2_sqr(E), fl.dbl(D)))
    C8 = fl.dbl(fl.dbl(fl.dbl(C)))
    Y3 = fl.norm(fl.sub(tw.fq2_mul(E, fl.sub(D, X3)), C8))
    return X3, Y3, fl.norm(fl.dbl(YZ))


def g2_add(p: tuple, q: tuple) -> tuple:
    """P + Q, complete (add-2007-bl with the JAX lane masks): P + P takes the
    doubling, P + (-P) gives Z = 0 with the generic formula's X and Y, an
    infinity operand passes the other one through (Q infinite gives P, even
    when P is infinite too)."""
    X1, Y1, Z1 = p
    X2, Y2, Z2 = q
    Z1Z1, Z2Z2 = tw.fq2_sqr(_S([Z1, Z2]))
    U1, U2, YZ1, YZ2 = tw.fq2_mul(_S([X1, X2, Y1, Y2]), _S([Z2Z2, Z1Z1, Z2, Z1]))
    S1, S2 = tw.fq2_mul(_S([YZ1, YZ2]), _S([Z2Z2, Z1Z1]))
    H = fl.sub(U2, U1)
    rr = fl.sub(S2, S1)
    x_eq, y_eq = fq2_is_zero(H), fq2_is_zero(rr)
    I = tw.fq2_sqr(fl.dbl(H))
    r2 = fl.dbl(rr)
    J, V = tw.fq2_mul(_S([H, U1]), I)
    X3 = fl.norm(fl.sub(fl.sub(tw.fq2_sqr(r2), J), fl.dbl(V)))
    S1J = tw.fq2_mul(S1, J)
    Y3 = fl.norm(fl.sub(tw.fq2_mul(r2, fl.sub(V, X3)), fl.dbl(S1J)))
    ZZ = fl.sub(fl.sub(tw.fq2_sqr(fl.add(Z1, Z2)), Z1Z1), Z2Z2)
    Z3 = tw.fq2_mul(ZZ, H)
    added = (X3, Y3, Z3)
    dX, dY, dZ = g2_dbl(p)
    same_x = (sel(y_eq, dX, X3), sel(y_eq, dY, Y3), sel(y_eq, dZ, torch.zeros_like(Z3)))
    out = sel_point(x_eq, same_x, added)
    out = sel_point(fq2_is_zero(Z1), q, out)
    return sel_point(fq2_is_zero(Z2), p, out)


def g2_neg(p: tuple) -> tuple:
    return p[0], fl.neg(p[1]), p[2]


def g2_mul_z(p: tuple) -> tuple:
    """[|x|]P by the fixed ladder: 63 doublings, an add of P after each of
    the 5 set bits below the top one."""
    acc = p
    for bit in bin(BLS_X_ABS)[3:]:
        acc = g2_dbl(acc)
        if bit == "1":
            acc = g2_add(acc, p)
    return acc


_CONST: dict = {}


def _psi_consts(device) -> tuple:
    key = str(device)
    if key not in _CONST:
        _CONST[key] = (fl.from_ints(list(PSI_X), device), fl.from_ints(list(PSI_Y), device))
    return _CONST[key]


def g2_psi(p: tuple) -> tuple:
    """psi (untwist-Frobenius-twist) on Jacobian coordinates: each
    coordinate conjugated, X and Y scaled by the psi constants."""
    px, py = _psi_consts(p[0].device)
    X, Y = tw.fq2_mul(_S([tw.fq2_conj(p[0]), tw.fq2_conj(p[1])]), _S([px.expand_as(p[0]),
                                                                     py.expand_as(p[1])]))
    return X, Y, tw.fq2_conj(p[2])


def g2_clear_cofactor(p: tuple) -> tuple:
    """[h_eff]P by Budroni-Pintore with the shared ladder:
    [z^2]P + [z]P - P - psi([z+1]P) + psi^2(2P), z = |x|."""
    a = g2_mul_z(p)
    b = g2_mul_z(a)
    t = g2_psi(g2_add(a, p))
    acc = g2_add(b, a)
    acc = g2_add(acc, g2_neg(p))
    acc = g2_add(acc, g2_neg(t))
    return g2_add(acc, g2_psi(g2_psi(g2_dbl(p))))


def g2_to_affine(p: tuple) -> tuple:
    """(x, y, infinity mask): one Fq2 inversion a lane; Z = 0 inverts to 0,
    so an infinite lane comes out as x = y = 0 with its mask set."""
    X, Y, Z = p
    zi = tw.fq2_inv(Z)
    zi2 = tw.fq2_sqr(zi)
    zi3 = tw.fq2_mul(zi2, zi)
    x, y = tw.fq2_mul(_S([X, Y]), _S([zi2, zi3]))
    return x, y, fq2_is_zero(Z)


def g2_from_affine(x: torch.Tensor, y: torch.Tensor, inf: torch.Tensor | None = None) -> tuple:
    """Jacobian (x, y, 1) of affine limbs; lanes where ``inf`` is set get
    Z = 0."""
    one = torch.zeros_like(x)
    one[..., 0, :] = fl.one_like(x[..., 0, :])
    if inf is not None:
        one = sel(inf, torch.zeros_like(one), one)
    return x, y, one
