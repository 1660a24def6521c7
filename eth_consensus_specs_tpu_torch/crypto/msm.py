"""G1 multi-scalar multiplication on the host: the KZG oracle's lincomb.

The port's copy of ``eth_consensus_specs_tpu/crypto/msm.py``: Pippenger
with 8-bit windows over raw-integer Jacobian coordinates (dbl-2009-l,
add-2007-bl, mixed additions for the bucket fill). The card's counterpart
is kernel K17 (``ops/g1_msm.msm_many``); this stays the host reference.
"""

from __future__ import annotations

from .curve import B1, Point, g1_infinity
from .fields import Fq, P

_MASK = (1 << 8) - 1


def _jdbl(X1, Y1, Z1):
    if Y1 == 0:
        return 0, 1, 0
    A = X1 * X1 % P
    B = Y1 * Y1 % P
    C = B * B % P
    t = X1 + B
    D = (t * t - A - C) % P
    D = (D + D) % P
    E = (3 * A) % P
    F = E * E % P
    X3 = (F - 2 * D) % P
    Y3 = (E * (D - X3) - 8 * C) % P
    Z3 = (2 * Y1 * Z1) % P
    return X3, Y3, Z3


def _jadd(X1, Y1, Z1, X2, Y2, Z2):
    if Z1 == 0:
        return X2, Y2, Z2
    if Z2 == 0:
        return X1, Y1, Z1
    Z1Z1 = Z1 * Z1 % P
    Z2Z2 = Z2 * Z2 % P
    U1 = X1 * Z2Z2 % P
    U2 = X2 * Z1Z1 % P
    S1 = Y1 * Z2 * Z2Z2 % P
    S2 = Y2 * Z1 * Z1Z1 % P
    if U1 == U2:
        if S1 == S2:
            return _jdbl(X1, Y1, Z1)
        return 0, 1, 0
    H = (U2 - U1) % P
    I = (2 * H) * (2 * H) % P
    J = H * I % P
    rr = (2 * (S2 - S1)) % P
    V = U1 * I % P
    X3 = (rr * rr - J - 2 * V) % P
    Y3 = (rr * (V - X3) - 2 * S1 * J) % P
    Z3 = ((Z1 + Z2) * (Z1 + Z2) - Z1Z1 - Z2Z2) % P
    Z3 = Z3 * H % P
    return X3, Y3, Z3


def _jadd_affine(X1, Y1, Z1, x2, y2):
    """Mixed addition (affine second operand, Z2 = 1): the bucket fill."""
    if Z1 == 0:
        return x2, y2, 1
    Z1Z1 = Z1 * Z1 % P
    U2 = x2 * Z1Z1 % P
    S2 = y2 * Z1 * Z1Z1 % P
    if U2 == X1:
        if S2 == Y1:
            return _jdbl(X1, Y1, Z1)
        return 0, 1, 0
    H = (U2 - X1) % P
    HH = H * H % P
    I = 4 * HH % P
    J = H * I % P
    rr = (2 * (S2 - Y1)) % P
    V = X1 * I % P
    X3 = (rr * rr - J - 2 * V) % P
    Y3 = (rr * (V - X3) - 2 * Y1 * J) % P
    Z3 = ((Z1 + H) * (Z1 + H) - Z1Z1 - HH) % P
    return X3, Y3, Z3


def msm_g1(points: list[Point], scalars: list[int]) -> Point:
    """sum_i scalars[i] * points[i] over G1 (Pippenger, 8-bit windows)."""
    assert len(points) == len(scalars)
    pairs = [
        (int(p.x.n), int(p.y.n), int(s))
        for p, s in zip(points, scalars)
        if not p.is_infinity() and int(s) != 0
    ]
    if not pairs:
        return g1_infinity()
    max_scalar = max(s for _, _, s in pairs)
    n_windows = max(1, (max_scalar.bit_length() + 7) // 8)

    rx, ry, rz = 0, 1, 0
    for w in range(n_windows - 1, -1, -1):
        if rz != 0:
            for _ in range(8):
                rx, ry, rz = _jdbl(rx, ry, rz)
        shift = w * 8
        buckets: dict[int, tuple] = {}
        for x, y, s in pairs:
            digit = (s >> shift) & _MASK
            if digit:
                cur = buckets.get(digit)
                buckets[digit] = (x, y, 1) if cur is None else _jadd_affine(*cur, x, y)
        if not buckets:
            continue
        # running-sum aggregation: sum_b b * bucket[b]
        acc = (0, 1, 0)
        tot = (0, 1, 0)
        for b in range(max(buckets), 0, -1):
            if b in buckets:
                acc = _jadd(*acc, *buckets[b])
            tot = _jadd(*tot, *acc)
        rx, ry, rz = _jadd(rx, ry, rz, *tot)

    if rz == 0:
        return g1_infinity()
    zinv = pow(rz, P - 2, P)
    z2 = zinv * zinv % P
    return Point(Fq(rx * z2 % P), Fq(ry * z2 * zinv % P), B1)
