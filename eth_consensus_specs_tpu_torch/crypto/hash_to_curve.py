"""Hash-to-G2 for BLS signatures: RFC 9380 ciphersuite
``BLS12381G2_XMD:SHA-256_SSWU_RO_``.

The port's copy of ``eth_consensus_specs_tpu/crypto/hash_to_curve.py``:
expand_message_xmd -> hash_to_field(Fq2, m=2, L=64) -> simplified SWU on
the 3-isogenous curve E2' -> 3-isogeny back to E2 -> add the two mapped
points -> clear the cofactor by h_eff. The constants are the published
parameters, cross-checked at import by structural invariants (SSWU lands
on E2', the isogeny lands on E2 and is a homomorphism, and the cofactor
clearing equals [h_eff]P and lands in the r-torsion).
"""

from __future__ import annotations

import hashlib

from .curve import (
    B2, BLS_X_ABS, F2, Point, in_subgroup, jac_add, jac_double, jac_mul, jac_neg, psi_jac)
from .fields import Fq, Fq2, R

# Ethereum's proof-of-possession ciphersuite DST (the POP_ tag is part of
# the ciphersuite ID; reference backends sign under this exact domain)
DST_G2 = b"BLS_SIG_BLS12381G2_XMD:SHA-256_SSWU_RO_POP_"

# == ciphersuite curve parameters (RFC 9380 §8.8.2) ========================

# E2': y^2 = x^3 + A' x + B', the 3-isogenous SSWU-friendly curve
A_PRIME = Fq2.from_ints(0, 240)
B_PRIME = Fq2.from_ints(1012, 1012)
# Z = -(2 + u)
Z_SSWU = Fq2(Fq(-2), Fq(-1))

# h_eff for G2 cofactor clearing (RFC 9380 §8.8.2)
H_EFF = 0xBC69F08F2EE75B3584C6A0EA91B352888E2A8E9145AD7689986FF031508FFE1329C2F178731DB956D82BF015D1212B02EC0EC69D7477C1AE954CBC06689F6A359894C0ADEBBF6B4E8020005AAA95551

# == 3-isogeny map E2' -> E2 (RFC 9380 Appendix E.3) =======================

_K1 = [  # x numerator, degree 3
    Fq2.from_ints(
        0x5C759507E8E333EBB5B7A9A47D7ED8532C52D39FD3A042A88B58423C50AE15D5C2638E343D9C71C6238AAAAAAAA97D6,
        0x5C759507E8E333EBB5B7A9A47D7ED8532C52D39FD3A042A88B58423C50AE15D5C2638E343D9C71C6238AAAAAAAA97D6,
    ),
    Fq2.from_ints(
        0,
        0x11560BF17BAA99BC32126FCED787C88F984F87ADF7AE0C7F9A208C6B4F20A4181472AAA9CB8D555526A9FFFFFFFFC71A,
    ),
    Fq2.from_ints(
        0x11560BF17BAA99BC32126FCED787C88F984F87ADF7AE0C7F9A208C6B4F20A4181472AAA9CB8D555526A9FFFFFFFFC71E,
        0x8AB05F8BDD54CDE190937E76BC3E447CC27C3D6FBD7063FCD104635A790520C0A395554E5C6AAAA9354FFFFFFFFE38D,
    ),
    Fq2.from_ints(
        0x171D6541FA38CCFAED6DEA691F5FB614CB14B4E7F4E810AA22D6108F142B85757098E38D0F671C7188E2AAAAAAAA5ED1,
        0,
    ),
]
_K2 = [  # x denominator, monic degree 2: x^2 + k21 x + k20
    Fq2.from_ints(
        0,
        0x1A0111EA397FE69A4B1BA7B6434BACD764774B84F38512BF6730D2A0F6B0F6241EABFFFEB153FFFFB9FEFFFFFFFFAA63,
    ),
    Fq2.from_ints(
        0xC,
        0x1A0111EA397FE69A4B1BA7B6434BACD764774B84F38512BF6730D2A0F6B0F6241EABFFFEB153FFFFB9FEFFFFFFFFAA9F,
    ),
    Fq2.one(),
]
_K3 = [  # y numerator, degree 3
    Fq2.from_ints(
        0x1530477C7AB4113B59A4C18B076D11930F7DA5D4A07F649BF54439D87D27E500FC8C25EBF8C92F6812CFC71C71C6D706,
        0x1530477C7AB4113B59A4C18B076D11930F7DA5D4A07F649BF54439D87D27E500FC8C25EBF8C92F6812CFC71C71C6D706,
    ),
    Fq2.from_ints(
        0,
        0x5C759507E8E333EBB5B7A9A47D7ED8532C52D39FD3A042A88B58423C50AE15D5C2638E343D9C71C6238AAAAAAAA97BE,
    ),
    Fq2.from_ints(
        0x11560BF17BAA99BC32126FCED787C88F984F87ADF7AE0C7F9A208C6B4F20A4181472AAA9CB8D555526A9FFFFFFFFC71C,
        0x8AB05F8BDD54CDE190937E76BC3E447CC27C3D6FBD7063FCD104635A790520C0A395554E5C6AAAA9354FFFFFFFFE38F,
    ),
    Fq2.from_ints(
        0x124C9AD43B6CF79BFBF7043DE3811AD0761B0F37A1E26286B0E977C69AA274524E79097A56DC4BD9E1B371C71C718B10,
        0,
    ),
]
_K4 = [  # y denominator, monic degree 3: x^3 + k42 x^2 + k41 x + k40
    Fq2.from_ints(
        0x1A0111EA397FE69A4B1BA7B6434BACD764774B84F38512BF6730D2A0F6B0F6241EABFFFEB153FFFFB9FEFFFFFFFFA8FB,
        0x1A0111EA397FE69A4B1BA7B6434BACD764774B84F38512BF6730D2A0F6B0F6241EABFFFEB153FFFFB9FEFFFFFFFFA8FB,
    ),
    Fq2.from_ints(
        0,
        0x1A0111EA397FE69A4B1BA7B6434BACD764774B84F38512BF6730D2A0F6B0F6241EABFFFEB153FFFFB9FEFFFFFFFFA9D3,
    ),
    Fq2.from_ints(
        0x12,
        0x1A0111EA397FE69A4B1BA7B6434BACD764774B84F38512BF6730D2A0F6B0F6241EABFFFEB153FFFFB9FEFFFFFFFFAA99,
    ),
    Fq2.one(),
]


def _horner(coeffs: list[Fq2], x: Fq2) -> Fq2:
    acc = coeffs[-1]
    for c in reversed(coeffs[:-1]):
        acc = acc * x + c
    return acc


def iso_map_g2(x: Fq2, y: Fq2) -> Point:
    """Evaluate the 3-isogeny E2' -> E2 at an affine (x, y)."""
    x_num = _horner(_K1, x)
    x_den = _horner(_K2, x)
    y_num = _horner(_K3, x)
    y_den = _horner(_K4, x)
    if x_den.is_zero() or y_den.is_zero():
        # the isogeny's poles are the kernel; they map to O
        return Point.infinity(B2)
    xo = x_num * x_den.inv()
    yo = y * y_num * y_den.inv()
    return Point(xo, yo, B2)


# == RFC 9380 primitives ====================================================


def expand_message_xmd(msg: bytes, dst: bytes, len_in_bytes: int) -> bytes:
    """RFC 9380 section 5.3.1, H = SHA-256."""
    b_in_bytes = 32
    r_in_bytes = 64
    ell = (len_in_bytes + b_in_bytes - 1) // b_in_bytes
    if ell > 255 or len(dst) > 255:
        raise ValueError("expand_message_xmd parameter overflow")
    dst_prime = dst + len(dst).to_bytes(1, "big")
    z_pad = b"\x00" * r_in_bytes
    l_i_b_str = len_in_bytes.to_bytes(2, "big")
    b_0 = hashlib.sha256(z_pad + msg + l_i_b_str + b"\x00" + dst_prime).digest()
    b_vals = [hashlib.sha256(b_0 + b"\x01" + dst_prime).digest()]
    for i in range(2, ell + 1):
        prev = bytes(a ^ b for a, b in zip(b_0, b_vals[-1]))
        b_vals.append(hashlib.sha256(prev + i.to_bytes(1, "big") + dst_prime).digest())
    return b"".join(b_vals)[:len_in_bytes]


def hash_to_field_fq2(msg: bytes, count: int, dst: bytes = DST_G2) -> list[Fq2]:
    """RFC 9380 hash_to_field with m=2, L=64."""
    L = 64
    data = expand_message_xmd(msg, dst, count * 2 * L)
    out = []
    for i in range(count):
        limbs = []
        for j in range(2):
            off = L * (j + i * 2)
            limbs.append(Fq(int.from_bytes(data[off : off + L], "big")))
        out.append(Fq2(limbs[0], limbs[1]))
    return out


def _sgn0(x: Fq2) -> int:
    """RFC 9380 §4.1 sgn0 for m=2: parity of the first nonzero limb."""
    sign_0 = x.c0.n & 1
    zero_0 = x.c0.n == 0
    sign_1 = x.c1.n & 1
    return sign_0 | (int(zero_0) & sign_1)


def map_to_curve_sswu_g2(u: Fq2) -> tuple[Fq2, Fq2]:
    """Simplified SWU on E2' (RFC 9380 §6.6.2). Returns affine (x', y')."""
    A, B, Z = A_PRIME, B_PRIME, Z_SSWU
    u2 = u.square()
    tv1 = Z * u2
    tv2 = tv1.square() + tv1  # Z^2 u^4 + Z u^2
    if tv2.is_zero():
        # exceptional case: x1 = B / (Z * A)
        x1 = B * (Z * A).inv()
    else:
        x1 = (-B) * A.inv() * (Fq2.one() + tv2.inv())
    gx1 = (x1.square() + A) * x1 + B
    y1 = gx1.sqrt()
    if y1 is not None:
        x, y = x1, y1
    else:
        x2 = tv1 * x1
        gx2 = (x2.square() + A) * x2 + B
        y2 = gx2.sqrt()
        assert y2 is not None, "SSWU: neither gx1 nor gx2 is square (impossible)"
        x, y = x2, y2
    if _sgn0(u) != _sgn0(y):
        y = -y
    return x, y


def map_to_curve_g2(u: Fq2) -> Point:
    """SSWU + isogeny: field element -> point on E2."""
    xp, yp = map_to_curve_sswu_g2(u)
    return iso_map_g2(xp, yp)


def clear_cofactor_g2(p: Point) -> Point:
    """[h_eff]P, computed as Budroni-Pintore's equal decomposition
    [z^2+z-1]P + [z+1](-psi(P)) + psi^2([2]P) with z = |x| (the JAX
    package's C core does the same; its pure path multiplies by H_EFF)."""
    if p.is_infinity():
        return p
    q = F2.from_point(p)
    a = jac_mul(F2, q, BLS_X_ABS)  # [z]P
    b = jac_mul(F2, a, BLS_X_ABS)  # [z^2]P
    t = psi_jac(jac_add(F2, a, q))  # psi([z+1]P)
    acc = jac_add(F2, jac_add(F2, jac_add(F2, b, a), jac_neg(F2, q)), jac_neg(F2, t))
    acc = jac_add(F2, acc, psi_jac(psi_jac(jac_double(F2, q))))
    return F2.to_point(acc, B2)


def hash_to_g2(msg: bytes, dst: bytes = DST_G2) -> Point:
    """RFC 9380 hash_to_curve for BLS12381G2_XMD:SHA-256_SSWU_RO_."""
    u0, u1 = hash_to_field_fq2(msg, 2, dst)
    q = map_to_curve_g2(u0) + map_to_curve_g2(u1)
    return clear_cofactor_g2(q)


# == import-time structural validation =====================================


def _on_e2_prime(x: Fq2, y: Fq2) -> bool:
    return y.square() == (x.square() + A_PRIME) * x + B_PRIME


def _validate_ciphersuite() -> None:
    probes = [
        Fq2.from_ints(1, 2),
        Fq2.from_ints(0x1234567, 0),
        Fq2.from_ints(0, 0xDEADBEEF),
        hash_to_field_fq2(b"validation", 1)[0],
    ]
    for u in probes:
        xp, yp = map_to_curve_sswu_g2(u)
        assert _on_e2_prime(xp, yp), "SSWU output not on E2' (A'/B'/Z wrong)"
        q = iso_map_g2(xp, yp)
        assert q.is_on_curve(), "isogeny image not on E2 (isogeny constants wrong)"
    # homomorphism probe: double a point on E2' (general Weierstrass law,
    # a = A') and require iso(2P') == 2 * iso(P'). A 3-isogeny is a group
    # morphism; a wrong coefficient that still lands on E2 breaks this.
    xp, yp = map_to_curve_sswu_g2(probes[0])
    lam = (xp.square() + xp.square() + xp.square() + A_PRIME) * (yp + yp).inv()
    x2 = lam.square() - xp - xp
    y2 = lam * (xp - x2) - yp
    assert _on_e2_prime(x2, y2)
    assert iso_map_g2(x2, y2) == iso_map_g2(xp, yp).double(), (
        "isogeny is not a homomorphism (isogeny constants wrong)"
    )
    s = iso_map_g2(x2, y2) + iso_map_g2(*map_to_curve_sswu_g2(probes[3]))
    # cofactor clearing: lands in the r-torsion, and is non-degenerate
    assert H_EFF % R != 0, "h_eff must not be divisible by r"
    cleared = clear_cofactor_g2(s)
    assert cleared == s.mul(H_EFF), "cofactor clearing differs from [h_eff]P"
    assert in_subgroup(cleared), "h_eff fails to clear the G2 cofactor"
    assert not cleared.is_infinity()


_validate_ciphersuite()
