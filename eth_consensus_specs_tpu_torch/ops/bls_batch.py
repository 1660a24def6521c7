"""Batched BLS aggregate verification on the card.

Counterpart of ``eth_consensus_specs_tpu/ops/bls_batch.py`` under its device
backend: the hot spot of a block is many independent FastAggregateVerify
checks (up to 128 attestation aggregates), settled by one pairing check
over a random linear combination,

    prod_i e(r_i * aggpk_i, H(m_i)) * e(-G1, sum_i r_i * sig_i) == 1,

which a forged item passes with probability about 2^-64 over the 64-bit
odd r_i. The flow of ``verify_many`` and ``batch_verify_aggregates``:

1. parse every item (``_parse_item``): the keys through the cached,
   validated ``_load_pk`` (a malformed, infinity or off-subgroup key rejects
   its item), the signature through ``_load_sig``;
2. K10 sums every item's committee in one call (``g1_msm.sum_many``: a
   lanes pass and the fold at 512 lanes, ``len(sum_plan(L)) + 1``
   launches); each sum is multiplied by its r_i on the host;
3. items that share a message merge into one pair; the distinct messages
   are hashed to G2 (cached, at most 512 entries): when more than one is
   new, by K13 and K14 on the card (``h2c_device.hash_to_g2_device``, the
   host's ``hash_to_field`` before them), else on the host; the G2 sum
   sum_i r_i * sig_i is a host multi-exponentiation, and ``prepare_g2``
   makes each Q's line coefficients on the host;
4. K11 runs every pair's Miller loop and multiplies the values, K12 checks
   the product's final exponentiation (``pairing_device``);
5. on a reject, ``verify_many`` bisects with the same per-item G1 terms.

Every entry point runs on the card unless the caller passes
``device="cpu"``, which runs the same flow through the kernels' plain
torch versions. ``rng`` is the source of the r_i: a ``random.Random``, or
``None`` for ``secrets.randbits``. The device picks the hash to G2: K13
and K14 on a CUDA device, ``crypto.hash_to_curve.hash_to_g2`` on the CPU
(the plain K13/K14 pipeline is ``h2c_device.hash_to_g2_device(...,
device="cpu")``). The JAX package makes its device hash opt-in
(``ETH_SPECS_TPU_DEVICE_H2C``) for XLA's compile time; a prebuilt kernel
has none, so on the card it is the default. ``parts``, where given, is a dict that collects the seconds of
each host stage and of the kernels' calls (up to their results), keyed by
stage (``h2c.*`` are the parts of ``hash_to_g2``); the ``obs`` spans, once
ported, take its place.

Not ported yet: the ``obs`` spans and counters and the watchdog's
``check_bls_item`` re-check, and the ``mesh`` arguments.
"""

from __future__ import annotations

import os
import secrets
import threading
import time
from contextlib import contextmanager

import torch

from ..crypto.curve import B2, F2, Point, g1_generator, g2_infinity
from ..crypto.hash_to_curve import DST_G2, hash_to_g2
from ..crypto.signature import _load_pk, _load_sig
from ..device import default_device
from . import g1_msm, h2c_device, pairing_device

# hash-to-G2 results keyed by (dst, message). All mutation holds the lock:
# a server may verify off-thread, and an unlocked evict (clear + update)
# racing a concurrent prime could publish a half-rebuilt dict.
_H2G2_CACHE: dict[tuple[bytes, bytes], Point] = {}
_H2G2_MAX = 512
_H2G2_LOCK = threading.Lock()


def _reinit_lock_after_fork_in_child() -> None:
    global _H2G2_LOCK
    _H2G2_LOCK = threading.Lock()


os.register_at_fork(after_in_child=_reinit_lock_after_fork_in_child)


def _host_h2g2_batch(msgs: list[bytes], dst: bytes) -> list[Point]:
    return [hash_to_g2(m, dst) for m in msgs]


def _prime_h2g2_cache(msgs: list[bytes], batch_fn=_host_h2g2_batch, dst: bytes = DST_G2) -> None:
    """Hash every message not yet cached with ``batch_fn`` and cache the
    points, keeping the cache at most 512 entries. Eviction happens before
    deciding what to hash (and again at insert time), and keeps this call's
    own messages."""
    keys = [(dst, m) for m in msgs]
    with _H2G2_LOCK:
        if len(_H2G2_CACHE) + len(keys) > _H2G2_MAX:
            keep = {k: _H2G2_CACHE[k] for k in keys if k in _H2G2_CACHE}
            _H2G2_CACHE.clear()
            _H2G2_CACHE.update(keep)
        fresh = [m for m in msgs if (dst, m) not in _H2G2_CACHE]
    if not fresh:
        return
    points = batch_fn(fresh, dst)  # outside the lock: racing primes both compute
    with _H2G2_LOCK:
        if len(_H2G2_CACHE) + len(fresh) > _H2G2_MAX:
            keep = {k: _H2G2_CACHE[k] for k in keys if k in _H2G2_CACHE}
            _H2G2_CACHE.clear()
            _H2G2_CACHE.update(keep)
        for m, p in zip(fresh, points):
            _H2G2_CACHE[(dst, m)] = p


def _h2g2(msg: bytes, dst: bytes = DST_G2) -> Point:
    with _H2G2_LOCK:
        hit = _H2G2_CACHE.get((dst, msg))
    return hit if hit is not None else hash_to_g2(msg, dst)


@contextmanager
def _stage(parts: dict | None, name: str):
    t0 = time.perf_counter()
    try:
        yield
    finally:
        if parts is not None:
            parts[name] = parts.get(name, 0.0) + time.perf_counter() - t0


_RLC_WINDOW = 5  # Pippenger digit bits for 64-bit scalars over ~128 points


def g2_multi_exp(points: list[Point], scalars: list[int]) -> Point:
    """sum_i scalars[i] * points[i] over G2 (scalars >= 0), bucketed by
    5-bit digits (Pippenger) in Jacobian coordinates."""
    from ..crypto.curve import jac_add, jac_double

    inf = (F2.one, F2.one, F2.zero)
    live = [(F2.from_point(p), int(k)) for p, k in zip(points, scalars)
            if not p.is_infinity() and k]
    if not live:
        return g2_infinity()
    window = _RLC_WINDOW
    bits = max(k.bit_length() for _, k in live)
    mask = (1 << window) - 1
    acc = inf
    for w in range((bits + window - 1) // window - 1, -1, -1):
        for _ in range(window):
            acc = jac_double(F2, acc)
        buckets = [inf] * (1 << window)
        for j, k in live:
            d = (k >> (w * window)) & mask
            if d:
                buckets[d] = jac_add(F2, buckets[d], j)
        running, total = inf, inf
        for d in range(mask, 0, -1):
            running = jac_add(F2, running, buckets[d])
            total = jac_add(F2, total, running)
        acc = jac_add(F2, acc, total)
    return F2.to_point(acc, B2)


def fast_aggregate_verify_device(pks: list[bytes], message: bytes, sig: bytes,
                                 device=None) -> bool:
    """FastAggregateVerify with the key sum (K10) and the pairing check
    (K11, K12) on ``device``. Semantics are the host path's: a key that
    does not validate rejects, an infinity aggregate goes on into the
    pairing."""
    dev = default_device(device)
    parsed = _parse_item((pks, message, sig))
    if parsed is None:
        return False
    points, msg, sig_pt, _ = parsed
    aggpk = g1_msm.sum_g1_device(points, device=dev)
    return pairing_device.pairing_check_device(
        [(aggpk, hash_to_g2(msg)), (-g1_generator(), sig_pt)], device=dev)


def _draw(rng) -> int:
    return (secrets.randbits(64) if rng is None else rng.getrandbits(64)) | 1


def _parse_item(item, rng=None):
    """(pubkeys, message, signature) -> (points, msg, sig, r), or None for
    an empty committee, a key that does not validate or bad signature
    bytes."""
    pks, msg, sig_b = item
    if len(pks) == 0:
        return None
    points = []
    for pk in pks:
        p = _load_pk(bytes(pk))
        if p is None:
            return None
        points.append(p)
    sig = _load_sig(bytes(sig_b))
    if sig is None:
        return None
    return (points, bytes(msg), sig, _draw(rng))


def _rlc_pubkey_terms(parsed: list, device, parts: dict | None = None) -> list[Point]:
    """Per-item r_i * aggpk_i: every committee summed by K10 in one launch,
    then one 64-bit multiplication per item on the host. The terms do not
    depend on which subset a later check verifies, so a bisection reuses
    them."""
    if not parsed:
        return []
    with _stage(parts, "g1_pack"):
        X, Y, Z = (torch.from_numpy(a).to(device)
                   for a in g1_msm.pack_lanes([points for points, _, _, _ in parsed]))
    with _stage(parts, "g1_sum_kernel"):
        out = g1_msm.sum_many(X, Y, Z).cpu()
    with _stage(parts, "g1_affine_and_rlc"):
        sums = g1_msm.sums_to_points(out)
        return [s.mul(r) for s, (_, _, _, r) in zip(sums, parsed)]


def _rlc_pairing_check(parsed: list, rpk: list, device, parts: dict | None = None) -> bool:
    # items that share a message merge into one pair: k items over m
    # distinct messages give m + 1 pairs and m hashes to G2
    merged: dict[bytes, Point] = {}
    for (_, msg, _, _), rp in zip(parsed, rpk):
        merged[msg] = rp if msg not in merged else merged[msg] + rp
    with _stage(parts, "hash_to_g2"):
        if device.type == "cuda" and len(merged) > 1:
            _prime_h2g2_cache(list(merged), lambda msgs, dst: h2c_device.hash_to_g2_device(
                msgs, dst, device=device, parts=parts))
        else:
            _prime_h2g2_cache(list(merged))
        qs = {msg: _h2g2(msg) for msg in merged}
    with _stage(parts, "g2_rlc_sum"):
        sig_acc = g2_multi_exp([sig for _, _, sig, _ in parsed], [r for _, _, _, r in parsed])
    pairs = [(rp, qs[msg]) for msg, rp in merged.items()]
    pairs.append((-g1_generator(), sig_acc))
    with _stage(parts, "prepare_g2"):
        packed = pairing_device.pack_pairs(pairs)
    with _stage(parts, "pairing_kernels"):
        args = [torch.from_numpy(a).to(device) for a in packed]
        return bool(pairing_device.final_exp_is_one(pairing_device.miller_product(*args)))


def batch_verify_aggregates(items: list, device=None, rng=None, parts: dict | None = None) -> bool:
    """Verify many (pubkeys, message, aggregate_signature) triples with one
    pairing check over a random linear combination; False if any item does
    not parse."""
    if not items:
        return True
    dev = default_device(device)
    parsed = []
    with _stage(parts, "parse"):
        for item in items:
            p = _parse_item(item, rng)
            if p is None:
                return False
            parsed.append(p)
    rpk = _rlc_pubkey_terms(parsed, dev, parts)
    return _rlc_pairing_check(parsed, rpk, dev, parts)


def verify_many(items: list, device=None, rng=None, parts: dict | None = None) -> list[bool]:
    """Per-item verdicts for many (pubkeys, message, aggregate_signature)
    triples: parse and the G1 terms once, one RLC pairing check for an
    all-valid batch, and a bisection on a reject, so each invalid item
    costs about 2 log2(n) checks. A verdict is exactly what
    ``batch_verify_aggregates([item])`` returns: a singleton check is
    X^r == 1 in the prime-order group with odd r, which holds iff X == 1."""
    if not items:
        return []
    dev = default_device(device)
    out = [False] * len(items)
    with _stage(parts, "parse"):
        parsed = [_parse_item(it, rng) for it in items]
    live = [i for i, p in enumerate(parsed) if p is not None]
    if not live:
        return out
    sub = [parsed[i] for i in live]
    rpk = _rlc_pubkey_terms(sub, dev, parts)
    for i, v in zip(live, _bisect_rlc(sub, rpk, dev, parts)):
        out[i] = v
    return out


def _bisect_rlc(parsed: list, rpk: list, device, parts: dict | None = None) -> list[bool]:
    if _rlc_pairing_check(parsed, rpk, device, parts):
        return [True] * len(parsed)
    if len(parsed) == 1:
        return [False]
    mid = len(parsed) // 2
    return (_bisect_rlc(parsed[:mid], rpk[:mid], device, parts)
            + _bisect_rlc(parsed[mid:], rpk[mid:], device, parts))

