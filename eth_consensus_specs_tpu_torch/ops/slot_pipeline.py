"""The whole-slot state-transition pipeline on the card (kernel K18 and
everything the slot composes).

Counterpart of ``eth_consensus_specs_tpu/ops/slot_pipeline.py``: wire types
(:83-140), ``FLAG_MASK`` (:67), ``sync_reward_gwei`` (:70),
``prep_request`` (:143), ``plan_updates`` (:172), ``_compiled_slot_apply``
(:205, kernel K18 ``csrc/slot_apply.cu`` here), ``slot_apply_device``
(:265), ``_root_bytes`` (:339), ``host_verify`` (:348), ``device_verify``
(:367), ``_valid_by_subnet`` (:391), ``host_aggregate`` (:401),
``device_aggregate`` (:412) and ``host_slot_fold`` (:483); the JAX
``advance_epoch`` (:450) is ``parallel.resident.advance`` over K4 here.
One ``SlotRequest`` carries a block's attestations, its sync aggregate and
its blob sidecars; the device pipeline chains

* **verify**: every attestation's aggregate signature and the sync
  aggregate in one ``bls_batch.verify_many`` (K10-K14; a reject bisects),
  every blob in one ``kzg_batch.verify_many_blobs`` (K16, K17, K11, K12);
* **aggregate**: the valid attestations' signatures summed per subnet in
  one ``g2_aggregate.sum_g2_many_device`` launch (K15);
* **apply and re-root**: the participation/balance scatter of the valid
  items (K18) and the incremental state root against the resident forest
  (``state_root.post_epoch_state_root_inc``: the forest update, K2), the forest
  updated in place (JAX donates it); the committed columns are not touched,
  K18 writes new ones, so a failed slot leaves the state as it was. An
  epoch-boundary slot also runs one accounting epoch (K4), in
  ``serve/slot.py``.

Semantics, as in the JAX package: a valid attestation sets its
participating members' previous-epoch participation flags
(source | target | head) and the current TIMELY_TARGET column; a valid sync
aggregate credits each sync index ``sync_reward_gwei()`` (duplicates
accumulate, mod 2^64). The state root re-roots balances incrementally; the
participation list roots in the forest are the static stand-ins, so flag
writes move the accounting columns but not the root. An invalid item is a
False verdict and changes nothing; the rest of the slot lands.

``host_slot_fold`` is the whole slot as a plain fold: per-item host
verification, the host aggregation, K18's plain version and the full
(non-incremental) root through the plain torch hashing. It is the oracle
the device pipeline is held against, never a route the pipeline falls back
to.

Deliberate difference: K18 launches at the exact lane counts of the plan;
JAX pads them to the pow2 ``buckets.slot_key`` so that XLA compiles few
shapes. Not ported: ``request_capacity`` (the key's input), the ``obs``
counters (``count_slot``) and the ``fault`` sites.

Every entry point runs on the card unless the caller passes
``device="cpu"``, which runs the same flow through the kernels' plain
versions.
"""

from __future__ import annotations

import os
from dataclasses import dataclass

import numpy as np
import torch

from .. import _ext
from ..device import default_device
from ..parallel.resident import _to, advance
from .altair_epoch import altair_epoch_accounting_ref
from .bls_batch import _stage
from .state_root import post_epoch_state_root_inc, post_epoch_state_root_ref

# altair participation bits: TIMELY_SOURCE | TIMELY_TARGET | TIMELY_HEAD
FLAG_MASK = 0b111


def sync_reward_gwei() -> int:
    """Per-participant balance credit of a valid sync aggregate,
    ``ETH_SPECS_SLOT_SYNC_REWARD`` when set and valid (negative values are
    0), else 1024."""
    raw = os.environ.get("ETH_SPECS_SLOT_SYNC_REWARD", "")
    try:
        return max(int(raw), 0) if raw else 1024
    except ValueError:
        return 1024


# ------------------------------------------------------------ wire types --


@dataclass(frozen=True)
class SlotAttestation:
    """One aggregated attestation as a block carries it: the claimed
    aggregate signature over the participating committee members."""

    subnet: int
    root: bytes  # attestation data root, the signed message
    committee: tuple  # validator indices of the full committee
    bits: tuple  # participation bits over the full committee
    pubkeys: tuple  # participating members' compressed pubkeys (48 B)
    sig: bytes  # claimed aggregate signature (96 B)


@dataclass(frozen=True)
class SlotRequest:
    """Everything one block submits. ``slot`` is the idempotency key: a
    retried slot that already committed replays its recorded result.
    ``epoch_boundary`` marks the slot that closes an epoch (one accounting
    epoch runs after the column updates)."""

    slot: int
    attestations: tuple = ()
    sync_pubkeys: tuple = ()  # compressed pubkeys of the sync participants
    sync_message: bytes = b""
    sync_sig: bytes = b""
    sync_indices: tuple = ()  # validator indices credited when valid
    blobs: tuple = ()  # (blob, commitment, proof) byte triples
    epoch_boundary: bool = False


@dataclass(frozen=True)
class SlotResult:
    """What a slot resolves to: the verdicts, the per-subnet aggregates of
    the valid attestations and the canonical post-slot state root."""

    slot: int
    att_verdicts: tuple  # bool per attestation
    sync_verdict: bool
    blob_verdicts: tuple  # bool per blob sidecar
    subnet_aggregates: tuple  # ((subnet, 96 B aggregate signature), ...)
    state_root: bytes  # canonical combined root after this slot
    epoch: int  # accounting epoch after this slot
    replayed: bool = False  # True: the replay of a committed slot


@dataclass
class SlotPrep:
    """Host prep of one request, done before (and, in a server, beside) the
    device work: decompressed signature points for the aggregation and
    parsed blob items for the KZG check."""

    sig_points: tuple = ()  # G2 Point | None per attestation
    blob_parsed: tuple = ()  # kzg_batch.parse_item output per blob


def prep_request(req: SlotRequest) -> SlotPrep:
    """Decompress and parse what the device legs need: every key into the
    validated-key cache, every attestation signature, every blob."""
    from ..crypto.signature import _load_pk, _load_sig
    from .kzg_batch import parse_item

    for att in req.attestations:
        for pk in att.pubkeys:
            _load_pk(pk)
    for pk in req.sync_pubkeys:
        _load_pk(pk)
    return SlotPrep(sig_points=tuple(_load_sig(att.sig) for att in req.attestations),
                    blob_parsed=tuple(parse_item(b) for b in req.blobs))


# -------------------------------------------------------- update planning --


def plan_updates(req: SlotRequest, att_verdicts, sync_verdict: bool, n_validators: int):
    """The scatter plan of the valid items: (flag_idx i32[], reward_idx
    i32[], reward_amt u64[]) as numpy arrays, exact lengths. Indices outside
    the registry are dropped; duplicates stay (the flags are idempotent, the
    rewards accumulate)."""
    flag_idx: list[int] = []
    for att, ok in zip(req.attestations, att_verdicts):
        if not ok:
            continue
        for vi, bit in zip(att.committee, att.bits):
            if bit and 0 <= int(vi) < n_validators:
                flag_idx.append(int(vi))
    reward = sync_reward_gwei()
    reward_idx: list[int] = []
    if sync_verdict and reward > 0:
        reward_idx = [int(vi) for vi in req.sync_indices if 0 <= int(vi) < n_validators]
    return (
        np.asarray(flag_idx, np.int32),
        np.asarray(reward_idx, np.int32),
        np.full(len(reward_idx), reward, np.uint64),
    )


# ------------------------------------------------------------- kernel K18 --


def _plan_lanes(n: int, flag_idx, reward_idx, reward_amt) -> tuple:
    """The plan as CPU tensors (int32, int32, int64 with the u64 bits),
    every index checked against [0, n) on the host. Raises ``ValueError``
    on an index outside the registry or a reward count mismatch."""

    def host(a, dtype):
        a = a.cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
        return np.ascontiguousarray(a.reshape(-1).astype(dtype))

    fi, ri = host(flag_idx, np.int64), host(reward_idx, np.int64)
    amt = host(reward_amt, np.uint64)
    if ri.shape != amt.shape:
        raise ValueError(f"{ri.shape[0]} reward indices for {amt.shape[0]} amounts")
    for name, idx in (("flag", fi), ("reward", ri)):
        if idx.size and (idx.min() < 0 or idx.max() >= n):
            raise ValueError(f"a {name} index lies outside the registry [0, {n})")
    return (torch.from_numpy(fi.astype(np.int32)), torch.from_numpy(ri.astype(np.int32)),
            torch.from_numpy(amt.view(np.int64)))


def slot_apply_ref(balance, prev_flags, cur_tgt_att, flag_idx, reward_idx, reward_amt):
    """Plain version of K18 on the columns' device: (new balance int64[n],
    new flags uint8[n], new target bool[n]), new tensors."""
    n = int(balance.shape[0])
    fi, ri, amt = (t.to(balance.device) for t in _plan_lanes(n, flag_idx, reward_idx,
                                                             reward_amt))
    fi, ri = fi.long(), ri.long()
    new_flags = prev_flags.clone()
    new_flags[fi] = prev_flags[fi] | FLAG_MASK
    new_tgt = cur_tgt_att.clone()
    new_tgt[fi] = True
    # int64 lanes add with the u64 bits: two's complement wraps mod 2^64
    return balance.clone().index_add_(0, ri, amt), new_flags, new_tgt


def slot_apply(balance, prev_flags, cur_tgt_att, flag_idx, reward_idx, reward_amt):
    """One slot's scatter: ``prev_flags | FLAG_MASK`` and the target bit at
    every flag index, each reward added at its index (duplicates accumulate,
    mod 2^64). Returns new (balance int64[n], prev_flags uint8[n],
    cur_tgt_att bool[n]); the inputs are left as they are. The plan (numpy
    arrays or CPU tensors) is checked on the host: an index outside [0, n)
    raises ``ValueError``.

    CUDA tensors go through kernel K18 (``csrc/slot_apply.cu``): the copy
    pass ``slot_apply`` and, for a non-empty plan, ``slot_apply_scatter``;
    CPU tensors through the plain version."""
    if balance.device.type == "cpu":
        return slot_apply_ref(balance, prev_flags, cur_tgt_att, flag_idx, reward_idx, reward_amt)
    n = int(balance.shape[0])
    _ext.check_cuda(balance, torch.int64, (n,))
    _ext.check_cuda(prev_flags, torch.uint8, (n,))
    _ext.check_cuda(cur_tgt_att, torch.bool, (n,))
    fi, ri, amt = _plan_lanes(n, flag_idx, reward_idx, reward_amt)
    dev = balance.device
    new_balance, new_flags, new_tgt = (torch.empty_like(t) for t in
                                       (balance, prev_flags, cur_tgt_att))
    _ext.launch("slot_apply", "slot_apply_launch", dev, _ext.ptr(balance), _ext.ptr(prev_flags),
                _ext.ptr(cur_tgt_att), _ext.ptr(new_balance), _ext.ptr(new_flags),
                _ext.ptr(new_tgt), n)
    if fi.numel() + ri.numel():
        fi, ri, amt = (t.to(dev) for t in (fi, ri, amt))
        _ext.launch("slot_apply", "slot_apply_scatter_launch", dev, _ext.ptr(prev_flags),
                    _ext.ptr(new_balance), _ext.ptr(new_flags), _ext.ptr(new_tgt), _ext.ptr(fi),
                    fi.numel(), _ext.ptr(ri), _ext.ptr(amt), ri.numel(),
                    counter="slot_apply_scatter")
    return new_balance, new_flags, new_tgt


def slot_apply_device(static, plan, forest, cols, just, flag_idx, reward_idx, reward_amt,
                      device=None):
    """Apply one slot's plan and re-root incrementally on ``device`` (the
    card unless the caller names another; the forest must already live
    there). Returns (new_cols, forest, root_bytes): new columns (the
    committed ones untouched), the forest updated in place (JAX donates
    it), the 32-byte state root."""
    dev = default_device(device)
    arrays, meta = static
    arrays, cols, just = _to(arrays, dev), _to(cols, dev), _to(just, dev)
    if forest.val_nodes.device.type != dev.type:
        raise ValueError(f"the forest lies on {forest.val_nodes.device}, not on {dev}")
    balance, flags, tgt = slot_apply(cols.balance, cols.prev_flags, cols.cur_tgt_att, flag_idx,
                                     reward_idx, reward_amt)
    forest, root = post_epoch_state_root_inc(
        arrays, meta, plan, forest, cols.balance, cols.effective_balance,
        cols.inactivity_scores, balance, cols.effective_balance, cols.inactivity_scores, just)
    new_cols = cols._replace(balance=balance, prev_flags=flags, cur_tgt_att=tgt)
    return new_cols, forest, _root_bytes(root)


def _root_bytes(words) -> bytes:
    """int32[8] root words (u32 bits) -> the canonical 32 big-endian bytes
    (the encoding ``snapshot.state_root_bytes`` commits to manifests)."""
    a = words.cpu().numpy() if isinstance(words, torch.Tensor) else np.asarray(words)
    return a.astype(np.int64).astype(np.uint32).astype(">u4").tobytes()


# ------------------------------------------------------------ verification --


def _verify_aggregate(item) -> bool:
    """FastAggregateVerify of one (pubkeys, message, signature) on the host."""
    from ..crypto.signature import fast_aggregate_verify

    pks, msg, sig = item
    return bool(fast_aggregate_verify(list(pks), msg, sig))


def _verify_blob(item) -> bool:
    from .kzg_batch import verify_blob_host

    return bool(verify_blob_host(*item))


def host_verify(req: SlotRequest, map_fn=map) -> tuple[list, bool, list]:
    """The verify leg's host oracle: ``crypto.signature.fast_aggregate_verify``
    per attestation and for the sync aggregate, ``kzg_batch.verify_blob_host``
    per blob. ``map_fn`` maps the per-item checks (a process pool's ``map``
    spreads them; the functions are module-level, so they pickle)."""
    items = [(a.pubkeys, a.root, a.sig) for a in req.attestations]
    if req.sync_pubkeys:
        items.append((req.sync_pubkeys, req.sync_message, req.sync_sig))
    verdicts = [bool(v) for v in map_fn(_verify_aggregate, items)]
    blobs = [bool(v) for v in map_fn(_verify_blob, req.blobs)]
    n_att = len(req.attestations)
    sync = bool(verdicts[n_att]) if req.sync_pubkeys else False
    return verdicts[:n_att], sync, blobs


def device_verify(req: SlotRequest, prep: SlotPrep | None, device=None,
                  parts: dict | None = None) -> tuple[list, bool, list]:
    """The verify leg on ``device``: one RLC-batched ``verify_many`` over the
    attestations and the sync aggregate (a reject bisects), one
    ``verify_many_blobs`` over the sidecars with the prep's parsed items.
    ``parts``, where given, collects the seconds of each (``bls``, ``kzg``)."""
    from .bls_batch import verify_many
    from .kzg_batch import verify_many_blobs

    dev = default_device(device)
    items = [(list(a.pubkeys), a.root, a.sig) for a in req.attestations]
    n_att = len(items)
    if req.sync_pubkeys:
        items.append((list(req.sync_pubkeys), req.sync_message, req.sync_sig))
    with _stage(parts, "bls"):
        verdicts = verify_many(items, device=dev) if items else []
    att = [bool(v) for v in verdicts[:n_att]]
    sync = bool(verdicts[n_att]) if req.sync_pubkeys else False
    blobs = []
    if req.blobs:
        parsed = list(prep.blob_parsed) if prep is not None else None
        with _stage(parts, "kzg"):
            blobs = [bool(v) for v in verify_many_blobs(list(req.blobs), device=dev,
                                                        parsed=parsed)]
    return att, sync, blobs


# ------------------------------------------------------------- aggregation --


def _valid_by_subnet(req: SlotRequest, att_verdicts) -> list[tuple[int, list[int]]]:
    """(subnet, [attestation index, ...]) groups of the valid attestations,
    sorted by subnet: the aggregation order both legs share."""
    groups: dict[int, list[int]] = {}
    for i, (att, ok) in enumerate(zip(req.attestations, att_verdicts)):
        if ok:
            groups.setdefault(int(att.subnet), []).append(i)
    return sorted(groups.items())


def host_aggregate(req: SlotRequest, att_verdicts) -> tuple:
    """The aggregation leg's host oracle: ``crypto.signature.aggregate`` of
    each subnet's valid signatures."""
    from ..crypto.signature import aggregate

    return tuple((subnet, aggregate([req.attestations[i].sig for i in idxs]))
                 for subnet, idxs in _valid_by_subnet(req, att_verdicts))


def device_aggregate(req: SlotRequest, att_verdicts, prep: SlotPrep | None,
                     device=None) -> tuple:
    """The aggregation leg on ``device``: every subnet's valid signatures in
    one ``sum_g2_many_device`` launch (K15)."""
    from ..crypto.curve import g2_to_bytes
    from ..crypto.signature import _load_sig
    from .g2_aggregate import sum_g2_many_device

    groups = _valid_by_subnet(req, att_verdicts)
    if not groups:
        return ()
    pts = list(prep.sig_points) if prep is not None else [None] * len(req.attestations)
    lists = [[pts[i] if pts[i] is not None else _load_sig(req.attestations[i].sig)
              for i in idxs] for _, idxs in groups]
    sums = sum_g2_many_device(lists, device=default_device(device))
    return tuple((subnet, g2_to_bytes(p)) for (subnet, _), p in zip(groups, sums))


# ------------------------------------------------------------ epoch and fold --


def host_slot_fold(params, static, cols, just, req: SlotRequest, epoch: int, map_fn=map,
                   device=None):
    """The whole slot as a plain fold on ``device`` (the card unless the
    caller names another): ``host_verify`` (its checks mapped by
    ``map_fn``), ``host_aggregate``, K18's plain version, on a boundary slot
    K4's plain version, and the full non-incremental root through
    ``post_epoch_state_root_ref``. Returns (SlotResult, new_cols, new_just);
    the inputs are left as they are."""
    dev = default_device(device)
    arrays, meta = static
    arrays, cols, just = _to(arrays, dev), _to(cols, dev), _to(just, dev)
    att_v, sync_v, blob_v = host_verify(req, map_fn)
    aggs = host_aggregate(req, att_v)
    plan = plan_updates(req, att_v, sync_v, int(cols.balance.shape[0]))
    balance, flags, tgt = slot_apply_ref(cols.balance, cols.prev_flags, cols.cur_tgt_att, *plan)
    new_cols = cols._replace(balance=balance, prev_flags=flags, cur_tgt_att=tgt)
    new_just, new_epoch = just, int(epoch)
    if req.epoch_boundary:
        new_cols, new_just = advance(altair_epoch_accounting_ref, params, new_cols, new_just)
        new_epoch += 1
    root = post_epoch_state_root_ref(arrays, meta, new_cols.balance, new_cols.effective_balance,
                                     new_cols.inactivity_scores, new_just)
    result = SlotResult(slot=int(req.slot), att_verdicts=tuple(att_v), sync_verdict=bool(sync_v),
                        blob_verdicts=tuple(blob_v), subnet_aggregates=aggs,
                        state_root=_root_bytes(root), epoch=new_epoch)
    return result, new_cols, new_just
