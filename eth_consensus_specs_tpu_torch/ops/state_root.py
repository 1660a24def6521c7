"""The full post-epoch BeaconState root from device columns.

Counterpart of ``eth_consensus_specs_tpu/ops/state_root.py``
(``_post_epoch_state_root_impl`` :554 and its helpers). Of each
Validator's tree only the effective-balance path changes in the
accounting epoch, so the static nodes A = H(pubkey_root,
withdrawal_credentials) and F = H(H(aee, ae), H(exit, withdrawable)) are
inputs, and each epoch recomputes three hashes per validator (kernel K3,
``csrc/validator_leaves.cu``), reduces the registry and the big columns
with kernel K2 (``ops/merkle.py``), folds each to its SSZ limit with
zero-hash siblings and mixes in the length (kernel K1, ``ops/sha256.py``),
and combines the top container. Every other field's root is a static
chunk. Packing and the combine are torch glue.

The incremental path (``build_state_forest`` :731, ``post_epoch_state_root_inc``
:805 and ``state_root_from_forest`` :894 there) keeps the three big subtrees
resident as flat forests (``merkle_inc.py``) and re-hashes only the dirty
paths: effective balances move only on hysteresis crossings, and the
balance and score columns diff chunk by chunk (kernel K5); past the
crossover a tree is rebuilt whole (K6, and K3 for the validator leaves).
Both roots share the folds, mix-ins, small roots and top combine below, so
they cannot disagree on the shared fields.

The hashing goes through a ``Hashers`` bundle: ``KERNELS`` dispatches by
device (CUDA kernels for CUDA tensors, plain torch for CPU tensors);
``PLAIN`` is the plain torch version of every kernel, which the slice's
reference path (``post_epoch_state_root_ref``) uses on any device.
"""

from __future__ import annotations

import hashlib
from functools import lru_cache, partial
from typing import Callable, NamedTuple

import numpy as np
import torch

from .. import _ext
from ..config import inc_dense_count, inc_dirty_bucket, state_fields, top_depth as fork_top_depth
from ..lanes import MASK32, bswap32, to_i32, to_u32_lanes
from . import merkle_inc
from .merkle import tree_real_hashes, tree_root, tree_root_ref
from .sha256 import hash_rows, sha256_pairs, sha256_pairs_ref

VALIDATOR_REGISTRY_LIMIT_LOG2 = 40  # List[Validator, 2**40]
BALANCE_LIMIT_CHUNKS_LOG2 = 38  # 2**40 u64 -> 2**38 chunks
PARTICIPATION_LIMIT_CHUNKS_LOG2 = 35  # 2**40 bytes -> 2**35 chunks
ZEROHASH_DEPTH = 41

DYNAMIC_FIELDS = frozenset({
    "validators", "balances", "inactivity_scores", "previous_epoch_participation",
    "current_epoch_participation", "justification_bits", "previous_justified_checkpoint",
    "current_justified_checkpoint", "finalized_checkpoint",
})


class Hashers(NamedTuple):
    """One implementation of every kernel the state roots use. The last five
    serve the incremental forest (K3's in-place and indexed entries, and
    ``merkle_inc.py``)."""

    sha256_pairs: Callable
    tree_root: Callable
    validator_leaves: Callable
    validator_leaves_into: Callable
    validator_leaves_at: Callable
    dirty_leaves: Callable
    apply_update: Callable
    merkle_levels: Callable


class StateRootArrays(NamedTuple):
    """Static tree content resident on the device (int32 word chunks)."""

    val_node_a: torch.Tensor  # int32[N, 8] H(pubkey_root, withdrawal_credentials)
    val_node_f: torch.Tensor  # int32[N, 8] H(H(aee, ae), H(exit, withdrawable))
    slashed_chunk: torch.Tensor  # int32[N, 8] SSZ chunk of `slashed`
    prev_part_flags: torch.Tensor  # uint8[N] participation rotated into prev
    top_chunks: torch.Tensor  # int32[2^top_depth, 8] field roots, static slots filled
    zerohashes: torch.Tensor  # int32[42, 8]
    # constants of the registry size, made once on the host so the epoch
    # loop never copies from the host: the u64 chunk of the list length N,
    # and the root of the all-zero current participation list of length N
    len_chunk: torch.Tensor  # int32[8]
    cur_part_root: torch.Tensor  # int32[8]


class StateRootMeta(NamedTuple):
    dynamic_slots: tuple  # ((field index, field name), ...)
    n_validators: int
    top_depth: int


def _words_of(b: bytes) -> np.ndarray:
    """Bytes -> big-endian u32 words carried as int32."""
    return np.frombuffer(b, dtype=">u4").astype(np.uint32).view(np.int32)


@lru_cache(maxsize=None)
def zerohashes(max_depth: int = ZEROHASH_DEPTH) -> tuple:
    """zerohashes[d]: root of a depth-d tree of zero chunks, as bytes."""
    z = [b"\x00" * 32]
    for _ in range(max_depth):
        z.append(hashlib.sha256(z[-1] + z[-1]).digest())
    return tuple(z)


def zerohash_words(max_depth: int) -> np.ndarray:
    """int32[max_depth+1, 8]: zerohashes[d] as big-endian words."""
    return np.stack([_words_of(z) for z in zerohashes(max_depth)])


def zero_u8_list_root_words(n: int) -> np.ndarray:
    """Root words of an all-zero participation list of length n, on the
    host: the zero subtree, folded to the limit depth, length-mixed."""
    z = zerohashes()
    chunks = (n + 31) // 32
    depth = max(chunks - 1, 0).bit_length() if n else 0
    root = z[depth]
    for d in range(depth, PARTICIPATION_LIMIT_CHUNKS_LOG2):
        root = hashlib.sha256(root + z[d]).digest()
    root = hashlib.sha256(root + int(n).to_bytes(8, "little") + b"\x00" * 24).digest()
    return _words_of(root)


def u64_chunk_words(vals: torch.Tensor) -> torch.Tensor:
    """int64[N] (u64) -> SSZ chunks int32[N, 8]: the value little-endian in
    the chunk's first 8 bytes."""
    lo = bswap32(vals & MASK32)
    hi = bswap32((vals >> 32) & MASK32)
    z = torch.zeros_like(lo)
    return to_i32(torch.stack([lo, hi, z, z, z, z, z, z], dim=-1))


def length_chunk(n: int, device) -> torch.Tensor:
    """The u64 chunk of a list length, int32[8]."""
    return u64_chunk_words(torch.tensor([n], dtype=torch.int64, device=device))[0]


def packed_u64_leaves(vals: torch.Tensor, n: int) -> torch.Tensor:
    """int64[n] (n % 4 == 0) -> int32[n//4, 8] packed SSZ chunk words."""
    w = to_u32_lanes(vals.contiguous().view(torch.int32)).reshape(n // 4, 8)
    return to_i32(bswap32(w))


def packed_u8_leaves(vals: torch.Tensor, n: int) -> torch.Tensor:
    """uint8[n] (n % 32 == 0) -> int32[n//32, 8] packed SSZ chunk words."""
    w = vals.reshape(n // 32, 8, 4).to(torch.int64)
    return to_i32((w[..., 0] << 24) | (w[..., 1] << 16) | (w[..., 2] << 8) | w[..., 3])


def _validator_chain_ref(eff, slashed_chunk, node_a, node_f) -> torch.Tensor:
    h = sha256_pairs_ref
    node_b = hash_rows(u64_chunk_words(eff), slashed_chunk, h)
    node_e = hash_rows(node_a, node_b, h)
    return hash_rows(node_e, node_f, h)


def validator_leaves_ref(eff, slashed_chunk, node_a, node_f, depth: int) -> torch.Tensor:
    """Plain torch version of K3: the 2^depth validator-root leaf level
    (zero rows past N)."""
    return pad_pow2(_validator_chain_ref(eff, slashed_chunk, node_a, node_f), depth)


def validator_leaves_into_ref(rows, eff, slashed_chunk, node_a, node_f, count=None, dense=0):
    """Plain torch version of K3 writing into ``rows``."""
    if not merkle_inc._gate_open(count, dense, sparse=False):
        return rows
    rows[:eff.shape[0]] = _validator_chain_ref(eff, slashed_chunk, node_a, node_f)
    return rows


def _check_validator_inputs(eff, slashed_chunk, node_a, node_f) -> int:
    n = eff.shape[0]
    _ext.check_cuda(eff, torch.int64, (n,))
    for t in (slashed_chunk, node_a, node_f):
        _ext.check_cuda(t, torch.int32, (n, 8))
    return n


def validator_leaves_into(rows, eff, slashed_chunk, node_a, node_f, count=None, dense: int = 0):
    """Write the validator roots H(H(A, H(eb_chunk, slashed)), F) of all N
    validators into rows 0..N-1 of ``rows`` (int32[>= N, 8]; the rows past N
    are left as they are). With ``count`` (int32[1]), only when
    ``count > dense``: the dense branch of the incremental update.

    CUDA tensors go through kernel K3; CPU tensors through the plain
    version."""
    if eff.device.type == "cpu":
        return validator_leaves_into_ref(rows, eff, slashed_chunk, node_a, node_f, count, dense)
    n = _check_validator_inputs(eff, slashed_chunk, node_a, node_f)
    _ext.check_cuda(rows, torch.int32)
    if rows.dim() != 2 or rows.shape[0] < n or rows.shape[1] != 8:
        raise ValueError(f"{n} validator roots do not fit rows {tuple(rows.shape)}")
    if count is not None:
        _ext.check_cuda(count, torch.int32, (1,))
    _ext.launch("validator_leaves", "validator_leaves_launch", eff.device,
                _ext.ptr(eff), _ext.ptr(slashed_chunk), _ext.ptr(node_a), _ext.ptr(node_f),
                _ext.ptr(rows), n, _ext.ptr(count), int(dense))
    return rows


def validator_leaves(eff, slashed_chunk, node_a, node_f, depth: int) -> torch.Tensor:
    """Validator roots H(H(A, H(eb_chunk, slashed)), F) as the 2^depth leaf
    level of the registry tree, int32[2^depth, 8], zero rows past N.

    CUDA tensors go through kernel K3; CPU tensors through the plain
    version."""
    if eff.device.type == "cpu":
        return validator_leaves_ref(eff, slashed_chunk, node_a, node_f, depth)
    n = eff.shape[0]
    if n > (1 << depth):
        raise ValueError(f"{n} validators do not fit a depth-{depth} tree")
    out = torch.empty((1 << depth, 8), dtype=torch.int32, device=eff.device)
    out[n:].zero_()
    return validator_leaves_into(out, eff, slashed_chunk, node_a, node_f)


def validator_leaves_at_ref(eff, slashed_chunk, node_a, node_f, idx, count=None, dense=-1):
    """Plain torch version of K3's indexed entry."""
    cap = idx.shape[0]
    out = torch.zeros((cap, 8), dtype=torch.int32, device=eff.device)
    if not merkle_inc._gate_open(count, dense, sparse=True):
        return out
    live = cap if count is None else min(int(count.reshape(-1)[0]), cap)
    i = idx[:live].to(torch.int64)
    ok = (i >= 0) & (i < eff.shape[0])
    i = torch.where(ok, i, torch.zeros_like(i))
    leaf = _validator_chain_ref(eff[i], slashed_chunk[i], node_a[i], node_f[i])
    out[:live] = torch.where(ok[:, None], leaf, torch.zeros_like(leaf))
    return out


def validator_leaves_at(eff, slashed_chunk, node_a, node_f, idx, count=None,
                        dense: int = -1) -> torch.Tensor:
    """Validator roots at the leaf indices ``idx`` (int32[cap]) ->
    int32[cap, 8]; the SSZ zero chunk for an index outside [0, N). With
    ``count`` (int32[1]) only rows j < count are computed (the rest are
    zero), and with ``dense >= 0`` none when ``count > dense``: the sparse
    branch of the incremental update.

    CUDA tensors go through K3's indexed entry; CPU tensors through the
    plain version."""
    if eff.device.type == "cpu":
        return validator_leaves_at_ref(eff, slashed_chunk, node_a, node_f, idx, count, dense)
    n = _check_validator_inputs(eff, slashed_chunk, node_a, node_f)
    _ext.check_cuda(idx, torch.int32)
    if count is not None:
        _ext.check_cuda(count, torch.int32, (1,))
    cap = idx.shape[0]
    out = torch.zeros((cap, 8), dtype=torch.int32, device=eff.device)
    _ext.launch("validator_leaves", "validator_leaves_at_launch", eff.device,
                _ext.ptr(eff), _ext.ptr(slashed_chunk), _ext.ptr(node_a), _ext.ptr(node_f),
                _ext.ptr(idx), _ext.ptr(count), int(dense), n, cap, _ext.ptr(out),
                counter="validator_leaves_at")
    return out


KERNELS = Hashers(sha256_pairs, tree_root, validator_leaves, validator_leaves_into,
                  validator_leaves_at, merkle_inc.dirty_leaves, merkle_inc.apply_update,
                  merkle_inc.merkle_levels)
PLAIN = Hashers(sha256_pairs_ref, tree_root_ref, validator_leaves_ref, validator_leaves_into_ref,
                validator_leaves_at_ref, merkle_inc.dirty_leaves_ref,
                partial(merkle_inc.apply_update, plain=True), merkle_inc.merkle_levels_ref)


def pad_pow2(leaves: torch.Tensor, depth: int) -> torch.Tensor:
    pad = (1 << depth) - leaves.shape[0]
    if pad:
        leaves = torch.cat([leaves, leaves.new_zeros((pad, 8))])
    return leaves


def fold_many(roots, depths, limits, zh, h: Hashers = KERNELS) -> list:
    """Chain each subtree root ``roots[i]`` (of depth ``depths[i]``) up to
    its SSZ limit depth ``limits[i]``, the right sibling at level d being
    zerohashes[d]. The chains advance together: one hash launch per level
    for all chains still below their limit."""
    roots = list(roots)
    steps = max((lim - d for d, lim in zip(depths, limits)), default=0)
    for s in range(steps):
        live = [i for i, (d, lim) in enumerate(zip(depths, limits)) if d + s < lim]
        out = hash_rows(torch.stack([roots[i] for i in live]),
                        torch.stack([zh[depths[i] + s] for i in live]), h.sha256_pairs)
        for j, i in enumerate(live):
            roots[i] = out[j]
    return roots


def mix_length(roots, len_chunk, h: Hashers = KERNELS):
    """H(root, length chunk) for each row of int32[B, 8] roots, one launch."""
    return hash_rows(roots, len_chunk.expand(roots.shape[0], 8), h.sha256_pairs)


def list_roots(subtrees, arrays: StateRootArrays, h: Hashers = KERNELS) -> torch.Tensor:
    """int32[B, 8] list roots from (subtree root, depth, limit depth)
    triples: every chain folded to its limit, then the length (the
    registry size, ``arrays.len_chunk``) mixed into each."""
    roots, depths, limits = zip(*subtrees)
    folded = fold_many(roots, depths, limits, arrays.zerohashes, h)
    return mix_length(torch.stack(folded), arrays.len_chunk, h)


def validator_subtree(arrays: StateRootArrays, n: int, eff, h: Hashers = KERNELS):
    """(root, depth) of the validator leaf tree: 3 hashes per validator,
    then the reduction of the 2^depth leaf level."""
    depth = max(n - 1, 0).bit_length()
    leaves = h.validator_leaves(eff, arrays.slashed_chunk, arrays.val_node_a,
                                arrays.val_node_f, depth)
    return h.tree_root(leaves, depth), depth


def _subtree(leaves, chunks: int, h: Hashers):
    depth = max(chunks - 1, 0).bit_length()
    return h.tree_root(pad_pow2(leaves, depth), depth), depth


def u64_subtree(vals, n: int, h: Hashers = KERNELS):
    """(root, depth) of the packed chunk tree of n >= 1 u64 values."""
    if n % 4:
        vals = torch.cat([vals, vals.new_zeros(4 - n % 4)])
    return _subtree(packed_u64_leaves(vals, vals.shape[0]), (n + 3) // 4, h)


def u8_subtree(vals, n: int, h: Hashers = KERNELS):
    """(root, depth) of the packed chunk tree of n >= 1 bytes."""
    if n % 32:
        vals = torch.cat([vals, vals.new_zeros(32 - n % 32)])
    return _subtree(packed_u8_leaves(vals, vals.shape[0]), (n + 31) // 32, h)


def checkpoint_roots(checkpoints, h: Hashers = KERNELS) -> torch.Tensor:
    """Checkpoint container roots H(chunk(epoch), root) for a list of
    (epoch, uint8[32] root) pairs, one launch -> int32[B, 8]."""
    epochs = torch.stack([e.reshape(()) for e, _ in checkpoints])
    r = torch.stack([root for _, root in checkpoints]).reshape(-1, 8, 4).to(torch.int64)
    r_chunks = to_i32((r[..., 0] << 24) | (r[..., 1] << 16) | (r[..., 2] << 8) | r[..., 3])
    return hash_rows(u64_chunk_words(epochs), r_chunks, h.sha256_pairs)


def bitvector4_chunk(bits) -> torch.Tensor:
    """Bitvector[4] (bool[4]) -> its SSZ chunk, int32[8]."""
    byte = (bits.to(torch.int64) << torch.arange(4, device=bits.device)).sum()
    return to_i32(torch.cat([(byte << 24).reshape(1), byte.new_zeros(7)]))


def combine_state_root(arrays: StateRootArrays, meta: StateRootMeta, dynamic_roots: dict,
                       h: Hashers = KERNELS):
    """Write the dynamic roots into their top-level slots and reduce the
    container tree."""
    chunks = arrays.top_chunks.clone()
    for slot, root in dynamic_roots.items():
        chunks[slot] = root
    return h.tree_root(chunks, meta.top_depth)


def small_dynamic_roots(slot_of: dict, just, h: Hashers = KERNELS) -> dict:
    """Roots of the justification bits and the three checkpoints."""
    cps = checkpoint_roots([
        (just.prev_justified_epoch, just.prev_justified_root),
        (just.cur_justified_epoch, just.cur_justified_root),
        (just.finalized_epoch, just.finalized_root),
    ], h)
    return {
        slot_of["justification_bits"]: bitvector4_chunk(just.justification_bits),
        slot_of["previous_justified_checkpoint"]: cps[0],
        slot_of["current_justified_checkpoint"]: cps[1],
        slot_of["finalized_checkpoint"]: cps[2],
    }


def _post_epoch_state_root(h: Hashers, arrays, meta, balances, effective_balance,
                           inactivity_scores, just):
    n = meta.n_validators
    slot_of = {name: i for i, name in meta.dynamic_slots}
    lists = {"validators": (*validator_subtree(arrays, n, effective_balance, h),
                            VALIDATOR_REGISTRY_LIMIT_LOG2),
             "balances": (*u64_subtree(balances, n, h), BALANCE_LIMIT_CHUNKS_LOG2)}
    if "inactivity_scores" in slot_of:
        lists["inactivity_scores"] = (*u64_subtree(inactivity_scores, n, h),
                                      BALANCE_LIMIT_CHUNKS_LOG2)
    if "previous_epoch_participation" in slot_of:
        lists["previous_epoch_participation"] = (*u8_subtree(arrays.prev_part_flags, n, h),
                                                 PARTICIPATION_LIMIT_CHUNKS_LOG2)
    roots = list_roots(list(lists.values()), arrays, h)
    dyn = {slot_of[name]: roots[i] for i, name in enumerate(lists)}
    if "current_epoch_participation" in slot_of:
        # the rotated-in current participation is all zero: a constant of n
        dyn[slot_of["current_epoch_participation"]] = arrays.cur_part_root
    dyn.update(small_dynamic_roots(slot_of, just, h))
    return combine_state_root(arrays, meta, dyn, h)


def post_epoch_state_root(arrays: StateRootArrays, meta: StateRootMeta, balances,
                          effective_balance, inactivity_scores, just) -> torch.Tensor:
    """hash_tree_root of the post-accounting BeaconState as int32[8] words;
    kernels K1-K3 on a CUDA device, their plain versions on the CPU."""
    return _post_epoch_state_root(KERNELS, arrays, meta, balances, effective_balance,
                                  inactivity_scores, just)


def post_epoch_state_root_ref(arrays: StateRootArrays, meta: StateRootMeta, balances,
                              effective_balance, inactivity_scores, just) -> torch.Tensor:
    """The same root through the plain torch version of every kernel."""
    return _post_epoch_state_root(PLAIN, arrays, meta, balances, effective_balance,
                                  inactivity_scores, just)


def state_root_real_hashes(meta: StateRootMeta) -> int:
    """64-byte messages hashed by one ``post_epoch_state_root`` (two SHA-256
    compressions each): validator chains, every tree, fold, mix-in,
    checkpoint and the top container, exactly as this module runs them."""
    n = meta.n_validators
    names = {name for _, name in meta.dynamic_slots}
    hashes = 3 * n + _list_hashes(n, VALIDATOR_REGISTRY_LIMIT_LOG2)
    hashes += _list_hashes((n + 3) // 4, BALANCE_LIMIT_CHUNKS_LOG2)
    if "inactivity_scores" in names:
        hashes += _list_hashes((n + 3) // 4, BALANCE_LIMIT_CHUNKS_LOG2)
    if "previous_epoch_participation" in names:
        hashes += _list_hashes((n + 31) // 32, PARTICIPATION_LIMIT_CHUNKS_LOG2)
    return hashes + 3 + tree_real_hashes(meta.top_depth)


def _list_hashes(chunks: int, limit_log2: int) -> int:
    """Messages of one list root: its chunk tree, the fold to the limit and
    the length mix-in."""
    d = max(chunks - 1, 0).bit_length()
    return tree_real_hashes(d) + (limit_log2 - d) + 1


def slot_root_real_hashes(n: int, top_depth: int) -> int:
    """64-byte messages hashed by one per-slot root of the block plane
    (``ops/block_epoch.slot_root``): the balance and both participation
    list roots and the top container, exactly as the port runs them. The
    JAX package's count (``ops/state_root.py`` :447) is of its full-width
    trees and leaves out the folds and mix-ins."""
    return (_list_hashes((n + 3) // 4, BALANCE_LIMIT_CHUNKS_LOG2)
            + 2 * _list_hashes((n + 31) // 32, PARTICIPATION_LIMIT_CHUNKS_LOG2)
            + tree_real_hashes(top_depth))


def dynamic_slots(fields) -> tuple:
    return tuple((i, name) for i, name in enumerate(fields) if name in DYNAMIC_FIELDS)


def arrays_from_host(val_node_a, val_node_f, slashed_chunk, prev_part_flags, top_chunks,
                     n: int, device) -> StateRootArrays:
    """StateRootArrays on ``device`` from host arrays of the static tree
    content (int32 word chunks, uint8 flags), adding the size constants."""
    dev = torch.device(device)

    def put(a):
        return torch.as_tensor(a).contiguous().to(dev)

    return StateRootArrays(
        val_node_a=put(val_node_a),
        val_node_f=put(val_node_f),
        slashed_chunk=put(slashed_chunk),
        prev_part_flags=put(prev_part_flags),
        top_chunks=put(top_chunks),
        zerohashes=put(zerohash_words(ZEROHASH_DEPTH)),
        len_chunk=length_chunk(n, dev),
        cur_part_root=put(zero_u8_list_root_words(n)),
    )


def synthetic_static(n: int, seed: int = 0, device=None, fork: str = "deneb"):
    """Static content of an n-validator ``fork`` state without building one:
    random static nodes and field roots, unslashed validators. The same
    hash count and tree shape as a real state's; the roots mean nothing, the
    work is real. The arrays are the JAX package's ``synthetic_static(spec,
    n, seed)`` word for word: the same numpy generator, drawn in its order."""
    from ..device import default_device

    dev = default_device(device)
    rng = np.random.default_rng(seed)
    depth = fork_top_depth(fork)

    def rnd(shape):
        return rng.integers(0, 2**32, size=shape, dtype=np.uint64).astype(np.uint32).view(np.int32)

    node_a = rnd((n, 8))
    node_f = rnd((n, 8))
    flags = rng.integers(0, 8, size=n, dtype=np.int64).astype(np.uint8)
    arrays = arrays_from_host(node_a, node_f, np.zeros((n, 8), np.int32), flags,
                              rnd((1 << depth, 8)), n, dev)
    meta = StateRootMeta(dynamic_slots(state_fields(fork)), n, depth)
    return arrays, meta


# --------------------------------------------- incremental (forest) path --


class StateForest(NamedTuple):
    """Resident incremental tree state. ``run_epochs`` updates the node
    buffers in place (JAX donates them) and returns them in its carry."""

    val_nodes: torch.Tensor  # int32[S, 2^(dvl+1)-1, 8] validator-root forest
    bal_nodes: torch.Tensor  # int32[S, 2^(dbl+1)-1, 8] balance-chunk forest
    inact_nodes: torch.Tensor | None  # scores forest (None pre-altair)
    part_root: torch.Tensor  # int32[8] previous-participation list root (static)


class ForestPlan(NamedTuple):
    """Static plan of an incremental forest; written into checkpoint
    manifests as a list, so the fields and their order are the JAX
    package's. Capacities and thresholds are per shard."""

    depth_val: int  # validator-leaf tree depth
    depth_bal: int  # u64-chunk tree depth (scores share it)
    shards: int  # leaf-axis shard count (1: the port has no mesh yet)
    cap_val: int  # dirty capacity, validator leaves
    cap_bal: int  # dirty capacity, chunk leaves
    dense_val: int  # dirty count past which the dense rebuild runs
    dense_bal: int
    has_inact: bool  # the state has inactivity_scores


def forest_plan(meta: StateRootMeta, dirty_cap: int | None = None) -> ForestPlan:
    """Plan an incremental forest for this registry: tree depths from the
    leaf counts, dirty capacities from the pow2 bucket grid
    (``config.inc_dirty_bucket``) for a hint of n/256 dirty validators (or
    ``dirty_cap``), dense thresholds from the crossover model
    (``config.inc_dense_count``)."""
    n = meta.n_validators
    depth_val = max(n - 1, 0).bit_length()
    depth_bal = max((n + 3) // 4 - 1, 0).bit_length()
    hint = int(dirty_cap) if dirty_cap else max(n >> 8, 8)
    cap_val = min(inc_dirty_bucket(hint), 1 << depth_val)
    cap_bal = min(inc_dirty_bucket(max(hint // 4, 1)), 1 << depth_bal)
    return ForestPlan(
        depth_val=depth_val,
        depth_bal=depth_bal,
        shards=1,
        cap_val=cap_val,
        cap_bal=cap_bal,
        dense_val=inc_dense_count(depth_val, cap_val, leaf_hashes=3),
        dense_bal=inc_dense_count(depth_bal, cap_bal),
        has_inact="inactivity_scores" in {name for _, name in meta.dynamic_slots},
    )


def _pad_col(vals: torch.Tensor, cap: int) -> torch.Tensor:
    pad = cap - vals.shape[0]
    if pad:
        vals = torch.cat([vals, vals.new_zeros((pad, *vals.shape[1:]))])
    return vals


def _u64_chunk_leaves(vals: torch.Tensor, n: int, depth: int) -> torch.Tensor:
    """int64[n] (u64) column -> int32[2^depth, 8] packed SSZ chunk leaf
    level, zero past the live chunks (the full path's padding)."""
    vals = _pad_col(vals, -(-n // 4) * 4)
    return pad_pow2(packed_u64_leaves(vals, vals.shape[0]), depth)


def _u64_forest(vals, n: int, depth: int, h: Hashers) -> torch.Tensor:
    nodes = vals.new_empty((1, merkle_inc.tree_nodes(depth), 8), dtype=torch.int32)
    nodes[0, :1 << depth] = _u64_chunk_leaves(vals, n, depth)
    return h.merkle_levels(nodes)


def build_state_forest(arrays: StateRootArrays, meta: StateRootMeta, plan: ForestPlan, balances,
                       effective_balance, inactivity_scores, h: Hashers = KERNELS) -> StateForest:
    """One-time forest ingest: every validator root and all levels of the
    three big trees (K3 into the leaf rows, K6), plus the static
    previous-participation list root."""
    n = meta.n_validators
    val_nodes = torch.zeros((1, merkle_inc.tree_nodes(plan.depth_val), 8), dtype=torch.int32,
                            device=balances.device)
    h.validator_leaves_into(val_nodes[0], effective_balance, arrays.slashed_chunk,
                            arrays.val_node_a, arrays.val_node_f)
    h.merkle_levels(val_nodes)
    part = list_roots([(*u8_subtree(arrays.prev_part_flags, n, h), PARTICIPATION_LIMIT_CHUNKS_LOG2)],
                      arrays, h)
    return StateForest(
        val_nodes=val_nodes,
        bal_nodes=_u64_forest(balances, n, plan.depth_bal, h),
        inact_nodes=_u64_forest(inactivity_scores, n, plan.depth_bal, h) if plan.has_inact else None,
        part_root=part[0],
    )


def state_root_inc_real_hashes(meta: StateRootMeta, plan: ForestPlan) -> int:
    """Compressions one incremental post-epoch root is charged in the JAX
    package's capacity model: per tree the smaller of the sparse update at
    capacity and the dense rebuild, plus the folds, mix-ins, checkpoints and
    the top combine, counted as ``state_root_real_hashes`` counts them."""
    n = meta.n_validators

    def tree_cost(depth: int, cap: int, leaf_hashes: int, dense_leaf_total: int) -> int:
        sparse = merkle_inc.inc_update_hashes(depth, cap, leaf_hashes)
        return min(sparse, tree_real_hashes(depth) + dense_leaf_total)

    hashes = tree_cost(plan.depth_val, plan.cap_val, 3, 3 * n)
    hashes += tree_cost(plan.depth_bal, plan.cap_bal, 0, 0)
    folds = (VALIDATOR_REGISTRY_LIMIT_LOG2 - plan.depth_val) + (
        BALANCE_LIMIT_CHUNKS_LOG2 - plan.depth_bal)
    mixes = 2
    if plan.has_inact:
        hashes += tree_cost(plan.depth_bal, plan.cap_bal, 0, 0)
        folds += BALANCE_LIMIT_CHUNKS_LOG2 - plan.depth_bal
        mixes += 1
    return hashes + folds + mixes + 3 + (1 << meta.top_depth)


def _update_u64_tree(h: Hashers, nodes, old_vals, vals, plan: ForestPlan) -> torch.Tensor:
    """Chunk-wise diff of a u64 column into its forest tree: K5 compacts
    the dirty chunks and writes their new leaves, then either K5 re-hashes
    their paths or K6 rebuilds the tree, as the live count decides on the
    device. Returns the live count."""
    tree = nodes[0]
    idx, count = h.dirty_leaves(old_vals, vals, 4, 1 << plan.depth_bal, plan.cap_bal, tree)
    h.apply_update(tree, idx, count, plan.dense_bal)
    return count


def _update_forest(h: Hashers, arrays: StateRootArrays, meta: StateRootMeta, plan: ForestPlan,
                   forest: StateForest, old_balances, old_effective_balance, old_inactivity_scores,
                   balances, effective_balance, inactivity_scores) -> list:
    """Apply one epoch's column changes to the forest in place, with no host
    synchronisation: both branches of every tree are launched and the live
    dirty count on the device picks one (``merkle_inc.apply_update``).
    Returns the live counts (int32[1] each) of the trees updated."""
    inputs = (effective_balance, arrays.slashed_chunk, arrays.val_node_a, arrays.val_node_f)
    # validator registry: dirty = hysteresis crossings; the new leaves are
    # K3's chain at the dirty rows (sparse) or at every row (dense), the SSZ
    # zero chunk past the registry
    idx, count = h.dirty_leaves(old_effective_balance, effective_balance, 1,
                                1 << plan.depth_val, plan.cap_val)
    h.apply_update(forest.val_nodes[0], idx, count, plan.dense_val,
                   leaves_at=lambda idx, count, dense: h.validator_leaves_at(*inputs, idx, count,
                                                                             dense),
                   leaves_into=lambda rows, count, dense: h.validator_leaves_into(rows, *inputs,
                                                                                  count, dense))
    counts = [count, _update_u64_tree(h, forest.bal_nodes, old_balances, balances, plan)]
    if plan.has_inact and forest.inact_nodes is not None:
        counts.append(_update_u64_tree(h, forest.inact_nodes, old_inactivity_scores,
                                       inactivity_scores, plan))
    return counts


def state_root_from_forest(arrays: StateRootArrays, meta: StateRootMeta, plan: ForestPlan,
                           forest: StateForest, just, h: Hashers = KERNELS) -> torch.Tensor:
    """The full post-epoch state root from a resident forest, with no dirty
    work: the tree roots folded to their limits and length-mixed, the
    participation roots, the small roots and the top combine. The root a
    checkpoint manifest carries and a restore re-verifies."""
    slot_of = {name: i for i, name in meta.dynamic_slots}
    lists = {
        "validators": (merkle_inc.forest_root(forest.val_nodes), plan.depth_val,
                       VALIDATOR_REGISTRY_LIMIT_LOG2),
        "balances": (merkle_inc.forest_root(forest.bal_nodes), plan.depth_bal,
                     BALANCE_LIMIT_CHUNKS_LOG2),
    }
    if plan.has_inact and "inactivity_scores" in slot_of:
        lists["inactivity_scores"] = (merkle_inc.forest_root(forest.inact_nodes), plan.depth_bal,
                                      BALANCE_LIMIT_CHUNKS_LOG2)
    roots = list_roots(list(lists.values()), arrays, h)
    dyn = {slot_of[name]: roots[i] for i, name in enumerate(lists)}
    if "previous_epoch_participation" in slot_of:
        dyn[slot_of["previous_epoch_participation"]] = forest.part_root
        dyn[slot_of["current_epoch_participation"]] = arrays.cur_part_root
    dyn.update(small_dynamic_roots(slot_of, just, h))
    return combine_state_root(arrays, meta, dyn, h)


def post_epoch_state_root_inc(arrays: StateRootArrays, meta: StateRootMeta, plan: ForestPlan,
                              forest: StateForest, old_balances, old_effective_balance,
                              old_inactivity_scores, balances, effective_balance,
                              inactivity_scores, just, h: Hashers = KERNELS):
    """The post-epoch state root through the incremental forest: the
    columns' changes applied to the forest in place, then the root from
    the forest. Returns (forest, root), the root bit-identical to
    ``post_epoch_state_root`` on the same columns. Kernels K1-K3, K5 and K6
    on a CUDA device, their plain versions on the CPU."""
    _update_forest(h, arrays, meta, plan, forest, old_balances, old_effective_balance,
                   old_inactivity_scores, balances, effective_balance, inactivity_scores)
    return forest, state_root_from_forest(arrays, meta, plan, forest, just, h)
