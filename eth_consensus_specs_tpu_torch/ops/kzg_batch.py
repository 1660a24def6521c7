"""Batched KZG blob verification on the card (kernels K16, K17, K11, K12).

Counterpart of ``eth_consensus_specs_tpu/ops/kzg_batch.py``, the serving
layer's blob-flush entry. A flush of (blob, commitment, proof) triples
verifies as:

1. **Parse** (``parse_item``): lengths, both G1 encodings validated (a
   subgroup check each), every field element below r, the Fiat-Shamir
   challenge z_i; the exact reject surface of ``crypto.kzg``'s
   ``verify_blob_kzg_proof``.
2. **Challenge evaluations** (``challenge_evaluations``): every blob of the
   flush through one inverse FFT on the card (K16), its rows as the blob
   stores them (bit-reversed evaluation order), which is the DIT's input
   order, so no permutation runs; then y_i = f_i(z_i) by a Horner walk over
   the coefficients on the host, as in the JAX package. Exact modular
   arithmetic: y_i equals the host's barycentric evaluation, also where
   z_i is a root of unity.
3. **One RLC check** (``_rlc_check``): the spec's random linear
   combination (``crypto.kzg.verify_kzg_proof_batch``) with its three G1
   lincombs folded by linearity into two MSMs, run as the two items of one
   K17 launch:
   ``A = sum r_i proof_i`` and
   ``B = sum r_i C_i + (-sum r_i y_i) G + sum z_i r_i proof_i``
   (n and 2n + 1 lanes for n blobs), then one pairing check
   ``e(A, -tau G2) e(B, G2) == 1`` through K11 and K12
   (``pairing_device.pairing_check_device``); both G2 points are fixed, so
   their line coefficients are prepared once.
4. **Bisection** (``_bisect``): a rejected subset splits in halves; only
   the Fiat-Shamir fold, the MSMs and the pairing run again, the
   evaluations are reused. A singleton check X^r == 1 with r != 0 mod the
   group order holds iff X == 1, so a leaf verdict equals the per-blob
   ``verify_blob_kzg_proof``.

Every entry point runs on the card unless the caller passes
``device="cpu"``, which runs the same flow through the kernels' plain
torch versions. ``parts``, where given, is a dict that collects the
seconds of each stage (``parse``, ``words``, ``fr_fft``, ``horner``,
``fiat_shamir``, ``msm_pack``, ``g1_msm``, ``pairing``), each kernel stage
up to its result on the host.

Not ported: the JAX package's ``ETH_SPECS_KZG_HOST_EVAL`` switch, which
routes the device path through the host barycentric evaluation; here the
barycentric evaluation is the oracle only (``crypto.kzg``). Not ported
yet: the ``obs`` spans and counters and the watchdog's sampled host
re-check (:268-280), ``buckets.first_dispatch`` and the ``fr_fft`` and
``kzg_msm`` bucket keys, the ``mesh`` arguments, and ``verify_many_blobs``'s
``parsed`` argument (parsing already done by ``slot_pipeline.device_verify``,
which is not ported yet).
"""

from __future__ import annotations

import numpy as np
import torch

from ..crypto import kzg
from ..crypto.curve import g1_generator, g2_generator
from ..crypto.fields import R as BLS_MODULUS
from ..device import default_device
from . import fr_fft, g1_msm, limb_field, pairing_device
from .bls_batch import _stage

BYTES_PER_BLOB = kzg.BYTES_PER_BLOB
BYTES_PER_COMMITMENT = kzg.BYTES_PER_COMMITMENT
BYTES_PER_PROOF = kzg.BYTES_PER_PROOF
N_BLOB = kzg.FIELD_ELEMENTS_PER_BLOB


# ------------------------------------------------------------- parsing --


def parse_item(item: tuple[bytes, bytes, bytes]):
    """(blob, commitment, proof) -> (blob, commitment_bytes, C_point,
    polynomial, challenge, proof_bytes, proof_point), or None on any input
    the host oracle rejects with an assertion, so that per-item verdicts
    match ``verify_blob_host``."""
    blob, commitment_bytes, proof_bytes = item
    blob = bytes(blob)
    commitment_bytes = bytes(commitment_bytes)
    proof_bytes = bytes(proof_bytes)
    if (len(blob) != BYTES_PER_BLOB or len(commitment_bytes) != BYTES_PER_COMMITMENT
            or len(proof_bytes) != BYTES_PER_PROOF):
        return None
    try:
        kzg.bytes_to_kzg_commitment(commitment_bytes)
        polynomial = kzg.blob_to_polynomial(blob)
        kzg.bytes_to_kzg_proof(proof_bytes)
    except AssertionError:
        return None
    challenge = kzg.compute_challenge(blob, commitment_bytes)
    return (blob, commitment_bytes, kzg._g1_point(commitment_bytes), polynomial, challenge,
            proof_bytes, kzg._g1_point(proof_bytes))


def verify_blob_host(blob: bytes, commitment_bytes: bytes, proof_bytes: bytes) -> bool:
    """The per-item host oracle with the serving layer's verdict semantic:
    malformed inputs are False verdicts, not exceptions."""
    try:
        return bool(kzg.verify_blob_kzg_proof(bytes(blob), bytes(commitment_bytes),
                                              bytes(proof_bytes)))
    except AssertionError:
        return False


# ------------------------------------------------- challenge evaluation --


def _eval_coeffs(coeffs: list[int], z: int) -> int:
    """Horner over monomial coefficients, exact mod r: equal to the
    barycentric evaluation of the same polynomial."""
    y = 0
    for c in reversed(coeffs):
        y = (y * z + c) % BLS_MODULUS
    return y


def flush_words(parsed: list) -> np.ndarray:
    """The flush's K16 input: numpy
    int32[B, 4096, 8] words of the blobs in stored order."""
    data = b"".join(p[0] for p in parsed)
    words = limb_field.big_endian_to_words(data, len(parsed) * N_BLOB)
    return words.reshape(len(parsed), N_BLOB, limb_field.N_WORDS)


def challenge_evaluations(parsed: list, device=None, parts: dict | None = None) -> list[int]:
    """y_i = f_i(z_i) for every parsed item: the Lagrange -> monomial
    conversion of the whole flush in one inverse FFT on ``device`` (K16),
    then a host Horner walk a blob."""
    if not parsed:
        return []
    dev = default_device(device)
    with _stage(parts, "words"):
        vals = torch.from_numpy(flush_words(parsed)).to(dev)
    with _stage(parts, "fr_fft"):
        # stored order is the bit reversal of natural order, the DIT's input
        coeffs = fr_fft.batch_fft_words(vals, kzg.compute_roots_of_unity(N_BLOB), inv=True,
                                        bitrev=False).cpu()
    with _stage(parts, "horner"):
        flat = limb_field.words_to_ints(coeffs)
        return [_eval_coeffs(flat[i * N_BLOB:(i + 1) * N_BLOB], p[4])
                for i, p in enumerate(parsed)]


# ------------------------------------------------------------- RLC fold --


def rlc_lincombs(parsed: list, ys: list[int]) -> tuple[list, list]:
    """The Fiat-Shamir RLC of a subset as the two MSMs of one K17 launch:
    (point lists, scalar lists) of A = sum r_i proof_i (n lanes) and
    B = sum r_i C_i + sum z_i r_i proof_i + (-sum r_i y_i) G (2n + 1)."""
    n = len(parsed)
    degree_poly = N_BLOB.to_bytes(8, kzg.KZG_ENDIANNESS)
    data = [kzg.RANDOM_CHALLENGE_KZG_BATCH_DOMAIN, degree_poly, n.to_bytes(8, kzg.KZG_ENDIANNESS)]
    for (_, commitment_bytes, _, _, z, proof_bytes, _), y in zip(parsed, ys):
        data += [commitment_bytes, kzg.bls_field_to_bytes(z), kzg.bls_field_to_bytes(y),
                 proof_bytes]
    r_powers = kzg.compute_powers(kzg.hash_to_bls_field(b"".join(data)), n)
    proof_pts = [p[6] for p in parsed]
    neg_ry = (-sum(rp * y for rp, y in zip(r_powers, ys))) % BLS_MODULUS
    points = [proof_pts, [p[2] for p in parsed] + proof_pts + [g1_generator()]]
    scalars = [r_powers, r_powers + [p[4] * rp % BLS_MODULUS for p, rp in zip(parsed, r_powers)]
               + [neg_ry]]
    return points, scalars


def _rlc_check(parsed: list, ys: list[int], device, parts: dict | None = None) -> bool:
    """One batch verdict for a subset: the spec's Fiat-Shamir RLC with its
    three G1 lincombs folded into the two items of one K17 launch, then one
    pairing check through K11 and K12."""
    with _stage(parts, "fiat_shamir"):
        points, scalars = rlc_lincombs(parsed, ys)
    with _stage(parts, "msm_pack"):
        K, X, Y, Z = (torch.from_numpy(a).to(device) for a in g1_msm.pack_msm(points, scalars))
    with _stage(parts, "g1_msm"):
        a_pt, b_pt = g1_msm.sums_to_points(g1_msm.msm_many(K, X, Y, Z))
    with _stage(parts, "pairing"):
        tau_g2 = kzg.get_setup().g2_monomial[1]
        return pairing_device.pairing_check_device([(a_pt, -tau_g2), (b_pt, g2_generator())],
                                                   device=device)


def verify_blob_kzg_proof_batch_device(blobs, commitments_bytes, proofs_bytes, device=None,
                                       parts: dict | None = None) -> bool:
    """Device twin of ``crypto.kzg.verify_blob_kzg_proof_batch``: the same
    assertion on malformed inputs, the same verdict on well-formed ones."""
    assert len(blobs) == len(commitments_bytes) == len(proofs_bytes)
    if not blobs:
        return True
    dev = default_device(device)
    with _stage(parts, "parse"):
        parsed = [parse_item(item) for item in zip(blobs, commitments_bytes, proofs_bytes)]
    assert all(p is not None for p in parsed), "malformed blob/commitment/proof"
    ys = challenge_evaluations(parsed, dev, parts)
    return _rlc_check(parsed, ys, dev, parts)


# ------------------------------------------------------------ bisection --


def _bisect(parsed: list, ys: list[int], device, parts: dict | None = None) -> list[bool]:
    if _rlc_check(parsed, ys, device, parts):
        return [True] * len(parsed)
    if len(parsed) == 1:
        return [False]
    mid = len(parsed) // 2
    return (_bisect(parsed[:mid], ys[:mid], device, parts)
            + _bisect(parsed[mid:], ys[mid:], device, parts))


def verify_many_blobs(items: list, device=None, parts: dict | None = None) -> list[bool]:
    """Per-item verdicts for many (blob, commitment, proof) triples, the
    serving layer's batch entry: parsing and the challenge evaluations run
    once, one RLC check settles an all-valid flush, and a reject bisects.
    Malformed items are False without poisoning the rest."""
    if not items:
        return []
    dev = default_device(device)
    with _stage(parts, "parse"):
        parsed = [parse_item(it) for it in items]
    out = [False] * len(items)
    live = [i for i, p in enumerate(parsed) if p is not None]
    if not live:
        return out
    sub = [parsed[i] for i in live]
    ys = challenge_evaluations(sub, dev, parts)
    for i, v in zip(live, _bisect(sub, ys, dev, parts)):
        out[i] = v
    return out

