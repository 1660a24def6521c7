"""BLS signature scheme (public keys in G1, signatures in G2): the verbs the
port's batch verification and its inputs need.

The port's copy of the parts of ``eth_consensus_specs_tpu/crypto/signature.py``
that the batched path uses: ``sk_to_pk``, ``sign``, ``aggregate``,
``key_validate``, ``_load_pk`` with its bounded cache, ``_load_sig``, the
host folds ``_sum_g2`` and ``_sum_g1`` (the oracles of the card's committee
sums) and the host ``fast_aggregate_verify`` (the oracle the card's
verdicts are held against). The JAX package's folds go through its native
C core where it is built; these are the plain affine additions, which give
the same points. Byte formats are the standard 48/96-byte compressed encodings.
"""

from __future__ import annotations

import threading

from .curve import (
    Point,
    g1_from_bytes,
    g1_generator,
    g1_infinity,
    g1_to_bytes,
    g2_from_bytes,
    g2_infinity,
    g2_to_bytes,
)
from .fields import R
from .hash_to_curve import hash_to_g2
from .pairing import pairing_check


def sk_to_pk(sk: int) -> bytes:
    if not 0 < sk < R:
        raise ValueError("secret key out of range")
    return g1_to_bytes(g1_generator().mul(sk))


def sign(sk: int, message: bytes) -> bytes:
    if not 0 < sk < R:
        raise ValueError("secret key out of range")
    return g2_to_bytes(hash_to_g2(message).mul(sk))


def key_validate(pk_bytes: bytes) -> bool:
    """Valid compressed encoding, on curve, in subgroup, not infinity."""
    try:
        p = g1_from_bytes(bytes(pk_bytes))
    except ValueError:
        return False
    return not p.is_infinity()


# Decompression and the subgroup check are the fixed cost of every key, and
# validator keys repeat every block: a bounded cache of validated points
# (None for a rejected key). At the cap it clears wholesale, as the JAX
# package's does, so one key past 2^16 makes the next call re-validate all.
# Each cached point keeps its limb row (Point.row), which is what a batch
# packs for the card.
_PK_CACHE: dict[bytes, Point | None] = {}
_PK_CACHE_MAX = 1 << 16
_PK_LOCK = threading.Lock()


def _load_pk(pk_bytes: bytes) -> Point | None:
    key = bytes(pk_bytes)
    with _PK_LOCK:
        hit = _PK_CACHE.get(key, False)
    if hit is not False:
        return hit
    try:
        p = g1_from_bytes(key)
    except ValueError:
        p = None
    if p is not None and p.is_infinity():
        p = None
    if p is not None:
        p.row  # noqa: B018  (made once, kept with the cached point)
    with _PK_LOCK:
        if len(_PK_CACHE) >= _PK_CACHE_MAX:
            _PK_CACHE.clear()
        _PK_CACHE[key] = p
    return p


def _load_sig(sig_bytes: bytes) -> Point | None:
    try:
        return g2_from_bytes(bytes(sig_bytes))
    except ValueError:
        return None


def _sum(points: list[Point], zero: Point) -> Point:
    acc = zero
    for p in points:
        acc = acc + p
    return acc


def _sum_g2(points: list[Point]) -> Point:
    """The host fold of G2 points (signatures), one affine addition each:
    the oracle of the card's committee sums (``ops/g2_aggregate``)."""
    return _sum(points, g2_infinity())


def _sum_g1(points: list[Point]) -> Point:
    """The host fold of G1 points (public keys)."""
    return _sum(points, g1_infinity())


def aggregate(signatures: list[bytes]) -> bytes:
    if len(signatures) == 0:
        raise ValueError("cannot aggregate zero signatures")
    points = []
    for s in signatures:
        p = _load_sig(s)
        if p is None:
            raise ValueError("invalid signature in aggregate")
        points.append(p)
    return g2_to_bytes(_sum(points, g2_infinity()))


def fast_aggregate_verify(pks: list[bytes], message: bytes, sig_bytes: bytes) -> bool:
    """The host FastAggregateVerify: affine sums and the pairing oracle."""
    if len(pks) == 0:
        return False
    points = []
    for pk_b in pks:
        pk = _load_pk(pk_b)
        if pk is None:
            return False
        points.append(pk)
    sig = _load_sig(sig_bytes)
    if sig is None:
        return False
    return fast_aggregate_verify_points(points, message, sig)


def fast_aggregate_verify_points(points: list[Point], message: bytes, sig: Point) -> bool:
    """FastAggregateVerify on parsed keys and signature, all on the host."""
    acc = _sum(points, g1_infinity())
    return pairing_check([(acc, hash_to_g2(bytes(message))), (-g1_generator(), sig)])
