"""Optimal ate pairing on BLS12-381: the port's host oracle.

The port's copy of ``eth_consensus_specs_tpu/crypto/pairing.py``, chosen for
having few places to be wrong, not for speed: G2 points are untwisted once
into E(Fq12) via psi(x, y) = (x*w^-2, y*w^-3), then the Miller loop runs
with generic affine line functions in Fq12; the negative BLS parameter is
handled by conjugating f after the loop; the final exponentiation is the
easy part by conjugate/inverse and frobenius^2, then one integer power by
(p^4 - p^2 + 1)/r. The tests and ``chip_smoke.py`` hold the card's path
against it; nothing on the card's path calls it.
"""

from __future__ import annotations

from .curve import Point
from .fields import BLS_X, P, R, Fq, Fq2, Fq6, Fq12

# w^-1 in Fq12: w is (0,1) in the (c0,c1) Fq6 split.
_W = Fq12(Fq6.zero(), Fq6.one())
_W_INV = _W.inv()
_W_INV2 = _W_INV * _W_INV
_W_INV3 = _W_INV2 * _W_INV

_B_FQ12 = Fq12(Fq6(Fq2.from_ints(4, 0), Fq2.zero(), Fq2.zero()), Fq6.zero())


def _fq2_to_fq12(a: Fq2) -> Fq12:
    return Fq12(Fq6(a, Fq2.zero(), Fq2.zero()), Fq6.zero())


def _fq_to_fq12(a: Fq) -> Fq12:
    return _fq2_to_fq12(Fq2(a, Fq(0)))


def untwist(q: Point) -> Point:
    """E'(Fq2) -> E(Fq12)."""
    if q.is_infinity():
        return Point.infinity(_B_FQ12)
    x = _fq2_to_fq12(q.x) * _W_INV2
    y = _fq2_to_fq12(q.y) * _W_INV3
    p = Point(x, y, _B_FQ12)
    assert p.is_on_curve(), "untwist image must satisfy y^2 = x^3 + 4"
    return p


def _line(t: Point, q: Point, px: Fq12, py: Fq12) -> Fq12:
    """Line through t and q (tangent if t==q), evaluated at (px, py)."""
    if t.x == q.x:
        if t.y == q.y:
            # tangent
            x_sq = t.x.square()
            lam = (x_sq + x_sq + x_sq) * (t.y + t.y).inv()
        else:
            # vertical
            return px - t.x
    else:
        lam = (q.y - t.y) * (q.x - t.x).inv()
    return (py - t.y) - lam * (px - t.x)


def miller_loop(p: Point, q_untwisted: Point) -> Fq12:
    """f_{|x|, Q}(P), conjugated for the negative BLS parameter. No final exp."""
    if p.is_infinity() or q_untwisted.is_infinity():
        return Fq12.one()
    px, py = _fq_to_fq12(p.x), _fq_to_fq12(p.y)
    t = q_untwisted
    f = Fq12.one()
    for bit in bin(-BLS_X)[3:]:
        f = f.square() * _line(t, t, px, py)
        t = t.double()
        if bit == "1":
            f = f * _line(t, q_untwisted, px, py)
            t = t + q_untwisted
    return f.conjugate()  # x < 0


_HARD_EXP = (P**4 - P**2 + 1) // R


def final_exponentiation(f: Fq12) -> Fq12:
    # easy part: f^((p^6 - 1)(p^2 + 1))
    f = f.conjugate() * f.inv()
    f = f.frobenius().frobenius() * f
    # hard part
    return f.pow(_HARD_EXP)


def pairing(p: Point, q: Point) -> Fq12:
    """e(P, Q) with P in G1(Fq), Q in G2(Fq2). Full pairing with final exp."""
    return final_exponentiation(miller_loop(p, untwist(q)))


def pairing_check(pairs: list[tuple[Point, Point]]) -> bool:
    """prod e(P_i, Q_i) == 1, with one shared final exponentiation."""
    f = Fq12.one()
    for p, q in pairs:
        f = f * miller_loop(p, untwist(q))
    return final_exponentiation(f).is_one()
