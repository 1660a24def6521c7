"""KZG polynomial commitments over BLS12-381 (EIP-4844 / deneb): the host
oracle of the card's blob verification (``ops/kzg_batch.py``).

The port's copy of ``eth_consensus_specs_tpu/crypto/kzg.py`` (spec
specs/deneb/polynomial-commitments.md): the bit-reversal permutation, the
barycentric evaluation, the Fiat-Shamir challenges, the per-proof and
batched RLC verification, and the commitment and blob-proof construction
the inputs are made with. Scalars are plain ints mod BLS_MODULUS; the G1
linear combinations run through the host Pippenger MSM (``crypto/msm.py``),
the pairing through the host oracle (``crypto/pairing.py``). SHA-256 is
hashlib's.

The trusted setup is the self-generated INSECURE testing setup shipped in
this package (``crypto/kzg_setup.py``), loaded once and decompressed without
per-point subgroup checks (its points are multiples of the generator made
by ``generate_setup``).
"""

from __future__ import annotations

import hashlib
import json
from functools import lru_cache

from . import signature as _sig
from .curve import Point, g1_from_bytes, g1_generator, g1_infinity, g1_to_bytes, g2_from_bytes
from .curve import g2_generator
from .fields import R as BLS_MODULUS
from .kzg_setup import setup_path
from .msm import msm_g1
from .pairing import pairing_check

FIELD_ELEMENTS_PER_BLOB = 4096
BYTES_PER_FIELD_ELEMENT = 32
BYTES_PER_BLOB = BYTES_PER_FIELD_ELEMENT * FIELD_ELEMENTS_PER_BLOB
BYTES_PER_COMMITMENT = 48
BYTES_PER_PROOF = 48
G1_POINT_AT_INFINITY = b"\xc0" + b"\x00" * 47
KZG_ENDIANNESS = "big"
PRIMITIVE_ROOT_OF_UNITY = 7
FIAT_SHAMIR_PROTOCOL_DOMAIN = b"FSBLOBVERIFY_V1_"
RANDOM_CHALLENGE_KZG_BATCH_DOMAIN = b"RCKZGBATCH___V1_"


class TrustedSetup:
    """The shipped testing setup's points, decompressed without subgroup
    checks: they are multiples of the generator that ``generate_setup``
    made. (An external ceremony file needs every point checked; loading one
    is not ported yet.)"""

    def __init__(self, path: str):
        with open(path) as f:
            raw = json.load(f)
        self.g1_monomial = [g1_from_bytes(bytes.fromhex(h[2:]), subgroup_check=False)
                            for h in raw["g1_monomial"]]
        self.g1_lagrange = [g1_from_bytes(bytes.fromhex(h[2:]), subgroup_check=False)
                            for h in raw["g1_lagrange"]]
        self.g2_monomial = [g2_from_bytes(bytes.fromhex(h[2:]), subgroup_check=False)
                            for h in raw["g2_monomial"]]


@lru_cache(maxsize=1)
def get_setup() -> TrustedSetup:
    """The shipped testing setup, loaded once per process."""
    return TrustedSetup(setup_path(FIELD_ELEMENTS_PER_BLOB))


# == bit-reversal permutation (spec :119-151) ===============================


def is_power_of_two(value: int) -> bool:
    return value > 0 and value & (value - 1) == 0


def reverse_bits(n: int, order: int) -> int:
    assert is_power_of_two(order)
    width = order.bit_length() - 1
    return int(format(n, f"0{width}b")[::-1], 2) if width else 0


def bit_reversal_permutation(sequence):
    order = len(sequence)
    return [sequence[reverse_bits(i, order)] for i in range(order)]


# == field helpers ==========================================================


def hash_to_bls_field(data: bytes) -> int:
    return int.from_bytes(hashlib.sha256(data).digest(), KZG_ENDIANNESS) % BLS_MODULUS


def bytes_to_bls_field(b: bytes) -> int:
    field_element = int.from_bytes(b, KZG_ENDIANNESS)
    assert field_element < BLS_MODULUS, "scalar >= BLS modulus"
    return field_element


def bls_field_to_bytes(x: int) -> bytes:
    return int(x).to_bytes(32, KZG_ENDIANNESS)


def compute_powers(x: int, n: int) -> list[int]:
    powers = []
    current = 1
    for _ in range(n):
        powers.append(current)
        current = current * x % BLS_MODULUS
    return powers


@lru_cache(maxsize=4)
def compute_roots_of_unity(order: int) -> tuple[int, ...]:
    assert (BLS_MODULUS - 1) % order == 0
    root = pow(PRIMITIVE_ROOT_OF_UNITY, (BLS_MODULUS - 1) // order, BLS_MODULUS)
    return tuple(compute_powers(root, order))


@lru_cache(maxsize=4)
def _roots_brp(order: int) -> tuple[int, ...]:
    return tuple(bit_reversal_permutation(list(compute_roots_of_unity(order))))


def _batch_inverse(values: list[int]) -> list[int]:
    """Montgomery batch inversion: one exponentiation for N inverses."""
    prefix = []
    acc = 1
    for v in values:
        assert v != 0, "division by zero"
        prefix.append(acc)
        acc = acc * v % BLS_MODULUS
    inv = pow(acc, BLS_MODULUS - 2, BLS_MODULUS)
    out = [0] * len(values)
    for i in range(len(values) - 1, -1, -1):
        out[i] = prefix[i] * inv % BLS_MODULUS
        inv = inv * values[i] % BLS_MODULUS
    return out


# == G1 validation / MSM =====================================================


def validate_kzg_g1(b: bytes) -> None:
    if bytes(b) == G1_POINT_AT_INFINITY:
        return
    assert _sig.key_validate(bytes(b)), "invalid G1 point"


def bytes_to_kzg_commitment(b: bytes) -> bytes:
    validate_kzg_g1(b)
    return bytes(b)


def bytes_to_kzg_proof(b: bytes) -> bytes:
    validate_kzg_g1(b)
    return bytes(b)


def g1_lincomb(points: list[Point], scalars: list[int]) -> bytes:
    assert len(points) == len(scalars)
    return g1_to_bytes(msm_g1(points, scalars))


def _g1_point(b: bytes) -> Point:
    if bytes(b) == G1_POINT_AT_INFINITY:
        return g1_infinity()
    return g1_from_bytes(bytes(b), subgroup_check=False)


# == polynomials ============================================================


def blob_to_polynomial(blob: bytes) -> list[int]:
    assert len(blob) == BYTES_PER_BLOB
    return [bytes_to_bls_field(blob[i * 32:(i + 1) * 32]) for i in range(FIELD_ELEMENTS_PER_BLOB)]


def compute_challenge(blob: bytes, commitment: bytes) -> int:
    degree_poly = FIELD_ELEMENTS_PER_BLOB.to_bytes(16, KZG_ENDIANNESS)
    data = FIAT_SHAMIR_PROTOCOL_DOMAIN + degree_poly + bytes(blob) + bytes(commitment)
    return hash_to_bls_field(data)


def evaluate_polynomial_in_evaluation_form(polynomial: list[int], z: int) -> int:
    """Barycentric evaluation at an arbitrary z (spec :319-351)."""
    width = len(polynomial)
    assert width == FIELD_ELEMENTS_PER_BLOB
    inverse_width = pow(width, BLS_MODULUS - 2, BLS_MODULUS)
    roots = _roots_brp(width)
    if z in roots:
        return polynomial[roots.index(z)]
    denominators = [(z - w) % BLS_MODULUS for w in roots]
    inverses = _batch_inverse(denominators)
    result = 0
    for p_i, w_i, inv_i in zip(polynomial, roots, inverses):
        result += p_i * w_i % BLS_MODULUS * inv_i
    result %= BLS_MODULUS
    r = (pow(z, width, BLS_MODULUS) - 1) % BLS_MODULUS
    return result * r % BLS_MODULUS * inverse_width % BLS_MODULUS


# == KZG core ===============================================================


def blob_to_kzg_commitment(blob: bytes) -> bytes:
    assert len(blob) == BYTES_PER_BLOB
    return g1_lincomb(bit_reversal_permutation(get_setup().g1_lagrange), blob_to_polynomial(blob))


def verify_kzg_proof_impl(commitment: bytes, z: int, y: int, proof: bytes) -> bool:
    """Pairing check: e(P - y*G1, -G2) * e(Q, tau*G2 - z*G2) == 1."""
    setup = get_setup()
    g2 = g2_generator()
    x_minus_z = setup.g2_monomial[1] + g2.mul((-z) % BLS_MODULUS)
    p_minus_y = _g1_point(commitment) + g1_generator().mul((-y) % BLS_MODULUS)
    return pairing_check([(p_minus_y, -g2), (_g1_point(proof), x_minus_z)])


def verify_kzg_proof_batch(commitments, zs, ys, proofs) -> bool:
    """N proofs -> one pairing via a random linear combination (spec :412)."""
    assert len(commitments) == len(zs) == len(ys) == len(proofs)
    degree_poly = FIELD_ELEMENTS_PER_BLOB.to_bytes(8, KZG_ENDIANNESS)
    num = len(commitments).to_bytes(8, KZG_ENDIANNESS)
    data = RANDOM_CHALLENGE_KZG_BATCH_DOMAIN + degree_poly + num
    for commitment, z, y, proof in zip(commitments, zs, ys, proofs):
        data += bytes(commitment) + bls_field_to_bytes(z) + bls_field_to_bytes(y) + bytes(proof)
    r = hash_to_bls_field(data)
    r_powers = compute_powers(r, len(commitments))

    proof_points = [_g1_point(p) for p in proofs]
    proof_lincomb = msm_g1(proof_points, r_powers)
    proof_z_lincomb = msm_g1(proof_points, [z * rp % BLS_MODULUS for z, rp in zip(zs, r_powers)])
    g1 = g1_generator()
    c_minus_ys = [_g1_point(commitment) + g1.mul((-y) % BLS_MODULUS)
                  for commitment, y in zip(commitments, ys)]
    c_minus_y_lincomb = msm_g1(c_minus_ys, r_powers)
    setup = get_setup()
    return pairing_check([
        (proof_lincomb, -setup.g2_monomial[1]),
        (c_minus_y_lincomb + proof_z_lincomb, g2_generator()),
    ])


def compute_quotient_eval_within_domain(z: int, polynomial: list[int], y: int) -> int:
    """q(z) when z is itself a root of unity (spec :481-506)."""
    roots = _roots_brp(FIELD_ELEMENTS_PER_BLOB)
    result = 0
    for i, omega_i in enumerate(roots):
        if omega_i == z:
            continue
        f_i = (polynomial[i] - y) % BLS_MODULUS
        numerator = f_i * omega_i % BLS_MODULUS
        denominator = z * ((z - omega_i) % BLS_MODULUS) % BLS_MODULUS
        result += numerator * pow(denominator, BLS_MODULUS - 2, BLS_MODULUS)
    return result % BLS_MODULUS


def compute_kzg_proof_impl(polynomial: list[int], z: int) -> tuple[bytes, int]:
    roots = _roots_brp(FIELD_ELEMENTS_PER_BLOB)
    y = evaluate_polynomial_in_evaluation_form(polynomial, z)
    polynomial_shifted = [(p - y) % BLS_MODULUS for p in polynomial]
    denominator_poly = [(x - z) % BLS_MODULUS for x in roots]

    quotient = [0] * FIELD_ELEMENTS_PER_BLOB
    nonzero_idx = [i for i, b in enumerate(denominator_poly) if b != 0]
    inverses = _batch_inverse([denominator_poly[i] for i in nonzero_idx])
    for i, inv in zip(nonzero_idx, inverses):
        quotient[i] = polynomial_shifted[i] * inv % BLS_MODULUS
    for i, b in enumerate(denominator_poly):
        if b == 0:  # z is the i-th root of unity: L'Hopital-style special case
            quotient[i] = compute_quotient_eval_within_domain(roots[i], polynomial, y)
    return g1_lincomb(bit_reversal_permutation(get_setup().g1_lagrange), quotient), y


def compute_blob_kzg_proof(blob: bytes, commitment_bytes: bytes) -> bytes:
    assert len(blob) == BYTES_PER_BLOB
    assert len(commitment_bytes) == BYTES_PER_COMMITMENT
    commitment = bytes_to_kzg_commitment(commitment_bytes)
    polynomial = blob_to_polynomial(blob)
    evaluation_challenge = compute_challenge(blob, commitment)
    proof, _ = compute_kzg_proof_impl(polynomial, evaluation_challenge)
    return proof


def verify_blob_kzg_proof(blob: bytes, commitment_bytes: bytes, proof_bytes: bytes) -> bool:
    assert len(blob) == BYTES_PER_BLOB
    assert len(commitment_bytes) == BYTES_PER_COMMITMENT
    assert len(proof_bytes) == BYTES_PER_PROOF
    commitment = bytes_to_kzg_commitment(commitment_bytes)
    polynomial = blob_to_polynomial(blob)
    evaluation_challenge = compute_challenge(blob, commitment)
    y = evaluate_polynomial_in_evaluation_form(polynomial, evaluation_challenge)
    proof = bytes_to_kzg_proof(proof_bytes)
    return verify_kzg_proof_impl(commitment, evaluation_challenge, y, proof)


def verify_blob_kzg_proof_batch(blobs, commitments_bytes, proofs_bytes) -> bool:
    assert len(blobs) == len(commitments_bytes) == len(proofs_bytes)
    commitments, challenges, ys, proofs = [], [], [], []
    for blob, commitment_bytes, proof_bytes in zip(blobs, commitments_bytes, proofs_bytes):
        assert len(blob) == BYTES_PER_BLOB
        assert len(commitment_bytes) == BYTES_PER_COMMITMENT
        assert len(proof_bytes) == BYTES_PER_PROOF
        commitment = bytes_to_kzg_commitment(commitment_bytes)
        commitments.append(commitment)
        polynomial = blob_to_polynomial(blob)
        challenge = compute_challenge(blob, commitment)
        challenges.append(challenge)
        ys.append(evaluate_polynomial_in_evaluation_form(polynomial, challenge))
        proofs.append(bytes_to_kzg_proof(proof_bytes))
    return verify_kzg_proof_batch(commitments, challenges, ys, proofs)
