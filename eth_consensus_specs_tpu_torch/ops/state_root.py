"""The full post-epoch BeaconState root from device columns.

Counterpart of ``eth_consensus_specs_tpu/ops/state_root.py``
(``_post_epoch_state_root_impl`` :554 and its helpers). Of each
Validator's tree only the effective-balance path changes in the
accounting epoch, so the static nodes A = H(pubkey_root,
withdrawal_credentials) and F = H(H(aee, ae), H(exit, withdrawable)) are
inputs, and each epoch recomputes three hashes per validator (kernel K3,
``csrc/validator_leaves.cu``), then writes every dynamic top chunk in one
launch of kernel K2 (``ops/merkle.py``): the list roots of the registry and
the big columns (each column packed as it loads, its tree reduced, folded
to its SSZ limit with zero-hash siblings and length-mixed), the three
checkpoints (one entry of three depth-1 trees over their packed bytes),
and the justification bits' and the participation roots' chunks (depth-0
entries); a second K2 launch reduces the top container. Every other
field's root is a static chunk.

The incremental path (``build_state_forest`` :731, ``post_epoch_state_root_inc``
:805 and ``state_root_from_forest`` :894 there) keeps the three big subtrees
resident as flat forests (``merkle_inc.py``) and re-hashes only the nodes
above a dirty leaf: effective balances move only on hysteresis crossings
(a dirty validator's leaf is K3's chain), and the balance and score columns
diff chunk by chunk. On the card the three trees of an epoch are one
launch of the forest kernel (``merkle_inc.forest_update``); the plain twin
takes JAX's sparse or dense branch per tree. Both roots share the folds,
mix-ins, small roots and top reduction below, so they cannot disagree on
the shared fields.

The hashing goes through a ``Hashers`` bundle: ``KERNELS`` dispatches by
device (CUDA kernels for CUDA tensors, plain torch for CPU tensors);
``PLAIN`` is the plain torch version of every kernel, which the slice's
reference path (``post_epoch_state_root_ref``) uses on any device.
"""

from __future__ import annotations

import hashlib
from functools import lru_cache
from typing import Callable, NamedTuple

import numpy as np
import torch

from .. import _ext
from ..config import inc_dense_count, inc_dirty_bucket, state_fields, top_depth as fork_top_depth
from ..lanes import udiv64, ule64, umod64
from . import merkle_inc
from .merkle import (ListTree, _words_of, list_roots, list_roots_ref, packed_u64_leaves, pad_pow2,
                     tree_real_hashes, tree_root, tree_root_ref, u64_chunk_words, zerohash_words,
                     zerohashes)
from .sha256 import hash_rows, sha256_pairs_ref

VALIDATOR_REGISTRY_LIMIT_LOG2 = 40  # List[Validator, 2**40]
BALANCE_LIMIT_CHUNKS_LOG2 = 38  # 2**40 u64 -> 2**38 chunks
PARTICIPATION_LIMIT_CHUNKS_LOG2 = 35  # 2**40 bytes -> 2**35 chunks
ZEROHASH_DEPTH = 41

CHECKPOINT_FIELDS = ("previous_justified_checkpoint", "current_justified_checkpoint",
                     "finalized_checkpoint")
DYNAMIC_FIELDS = frozenset({
    "validators", "balances", "inactivity_scores", "previous_epoch_participation",
    "current_epoch_participation", "justification_bits", "previous_justified_checkpoint",
    "current_justified_checkpoint", "finalized_checkpoint",
})


class Hashers(NamedTuple):
    """One implementation of every kernel the state roots use. Three serve
    the incremental forest: K3's in-place entry and ``merkle_levels`` build
    it, ``forest_update`` (``merkle_inc.forest_update(trees) -> counts``)
    updates it; ``list_roots`` is K2's list-root entry
    (``merkle.list_roots``, ``list_roots(trees, out, rows)``), which also
    takes the checkpoints and the top's other small roots."""

    tree_root: Callable
    validator_leaves: Callable
    validator_leaves_into: Callable
    merkle_levels: Callable
    forest_update: Callable
    list_roots: Callable


class StateRootArrays(NamedTuple):
    """Static tree content resident on the device (int32 word chunks)."""

    val_node_a: torch.Tensor  # int32[N, 8] H(pubkey_root, withdrawal_credentials)
    val_node_f: torch.Tensor  # int32[N, 8] H(H(aee, ae), H(exit, withdrawable))
    slashed_chunk: torch.Tensor  # int32[N, 8] SSZ chunk of `slashed`
    prev_part_flags: torch.Tensor  # uint8[N] participation rotated into prev
    top_chunks: torch.Tensor  # int32[2^top_depth, 8] field roots, static slots filled
    zerohashes: torch.Tensor  # int32[42, 8]
    # the root of the all-zero current participation list of length N, a
    # constant of the registry size made once on the host, so the epoch
    # loop never copies from the host
    cur_part_root: torch.Tensor  # int32[8]


class StateRootMeta(NamedTuple):
    dynamic_slots: tuple  # ((field index, field name), ...)
    n_validators: int
    top_depth: int


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


def validator_leaves_ref(eff, slashed_chunk, node_a, node_f, depth: int) -> torch.Tensor:
    """Plain torch version of K3: the 2^depth validator-root leaf level
    (zero rows past N)."""
    return pad_pow2(merkle_inc.validator_chain_ref(eff, slashed_chunk, node_a, node_f), depth)


def validator_leaves_into_ref(rows, eff, slashed_chunk, node_a, node_f, count=None, dense=0):
    """Plain torch version of K3 writing into ``rows`` (the plain forest
    update's dense branch)."""
    if not merkle_inc._gate_open(count, dense, sparse=False):
        return rows
    rows[:eff.shape[0]] = merkle_inc.validator_chain_ref(eff, slashed_chunk, node_a, node_f)
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
    ``count > dense``: the dense branch of JAX's incremental update (on the
    card the forest kernel now computes the registry's leaves itself).

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
    leaf = merkle_inc.validator_chain_ref(eff[i], slashed_chunk[i], node_a[i], node_f[i])
    out[:live] = torch.where(ok[:, None], leaf, torch.zeros_like(leaf))
    return out


# K3's indexed entry takes B = H(chunk(eff), slashed_chunk) from a table
# where it can (csrc/validator_leaves.cu: kIncrement, kTableIncrements,
# kSlashedWord): for eff = k increments, k <= 2048, and the chunk of false
# or true, row 2k + slashed.
EFFECTIVE_BALANCE_INCREMENT = 10**9  # Gwei, every preset
B_TABLE_INCREMENTS = 2048  # MAX_EFFECTIVE_BALANCE_ELECTRA / EFFECTIVE_BALANCE_INCREMENT
B_TABLE_ROWS = 2 * (B_TABLE_INCREMENTS + 1)
SLASHED_WORD = 0x01000000  # the first big-endian word of the SSZ chunk of true


def b_table_row(eff, slashed_chunk) -> torch.Tensor:
    """The table row K3's indexed entry reads for each validator, int64[N]:
    2k + slashed where eff is k increments (k <= 2048) and the slashed
    chunk is that of false or true, else -1 (the row hashes B)."""
    inc = EFFECTIVE_BALANCE_INCREMENT
    first = slashed_chunk[:, 0]
    hit = ((umod64(eff, inc) == 0) & ule64(eff, B_TABLE_INCREMENTS * inc)
           & ((first == 0) | (first == SLASHED_WORD)) & (slashed_chunk[:, 1:] == 0).all(1))
    return torch.where(hit, 2 * udiv64(eff, inc) + (first != 0).to(torch.int64), -1)


def b_table_ref(device=None) -> torch.Tensor:
    """Plain torch version of K3's table, int32[4098, 8]: row 2k + s is
    H(chunk(k increments), the chunk of s)."""
    k = torch.arange(B_TABLE_INCREMENTS + 1, dtype=torch.int64, device=device)
    slashed = torch.zeros((B_TABLE_ROWS, 8), dtype=torch.int32, device=device)
    slashed[1::2, 0] = SLASHED_WORD
    return hash_rows(u64_chunk_words((k * EFFECTIVE_BALANCE_INCREMENT).repeat_interleave(2)),
                     slashed, sha256_pairs_ref)


@lru_cache(maxsize=16)
def b_table(device: torch.device) -> torch.Tensor:
    """K3's table on the card ``device``, built at its first use by a
    launch of its own (counted as ``validator_b_table``) and kept."""
    table = torch.empty((B_TABLE_ROWS, 8), dtype=torch.int32, device=device)
    _ext.launch("validator_leaves", "validator_b_table_launch", table.device, _ext.ptr(table),
                counter="validator_b_table")
    return table


def validator_leaves_at(eff, slashed_chunk, node_a, node_f, idx, count=None,
                        dense: int = -1) -> torch.Tensor:
    """Validator roots at the leaf indices ``idx`` (int32[cap]) ->
    int32[cap, 8]; the SSZ zero chunk for an index outside [0, N). With
    ``count`` (int32[1]) only rows j < count are computed (the rest are
    zero), and with ``dense >= 0`` none when ``count > dense``: the sparse
    branch of JAX's incremental update (``_validator_leaf_fn`` :721; on the
    card the forest kernel now computes the registry's leaves itself, so no
    path calls this entry).

    CUDA tensors go through K3's indexed entry, one launch a call that
    writes every row (the table ``b_table`` is built at the card's first
    call); CPU tensors through the plain version."""
    if eff.device.type == "cpu":
        return validator_leaves_at_ref(eff, slashed_chunk, node_a, node_f, idx, count, dense)
    n = _check_validator_inputs(eff, slashed_chunk, node_a, node_f)
    _ext.check_cuda(idx, torch.int32)
    if count is not None:
        _ext.check_cuda(count, torch.int32, (1,))
    cap = idx.shape[0]
    out = torch.empty((cap, 8), dtype=torch.int32, device=eff.device)
    _ext.launch("validator_leaves", "validator_leaves_at_launch", eff.device,
                _ext.ptr(eff), _ext.ptr(slashed_chunk), _ext.ptr(node_a), _ext.ptr(node_f),
                _ext.ptr(idx), _ext.ptr(count), int(dense), n, cap,
                _ext.ptr(b_table(eff.device)), _ext.ptr(out), counter="validator_leaves_at")
    return out


KERNELS = Hashers(tree_root, validator_leaves, validator_leaves_into, merkle_inc.merkle_levels,
                  merkle_inc.forest_update, list_roots)
PLAIN = Hashers(tree_root_ref, validator_leaves_ref, validator_leaves_into_ref,
                merkle_inc.merkle_levels_ref, merkle_inc.forest_update_ref, list_roots_ref)


def validator_list(arrays: StateRootArrays, n: int, eff, h: Hashers = KERNELS) -> ListTree:
    """The validator registry as a list of K3's n validator roots (3 hashes
    each), folded to its limit and mixed with n."""
    depth = max(n - 1, 0).bit_length()
    leaves = h.validator_leaves(eff, arrays.slashed_chunk, arrays.val_node_a,
                                arrays.val_node_f, depth)
    return ListTree(leaves, n, VALIDATOR_REGISTRY_LIMIT_LOG2, n)


def checkpoint_list(checkpoints) -> ListTree:
    """(epoch, uint8[32] root) pairs as one K2 table entry of like trees:
    a uint8[64] row a checkpoint, the epoch's 8 little-endian bytes, 24 zero
    bytes and the root, which K2 packs into the chunks of the epoch and the
    root, one depth-1 tree each: its root H(chunk(epoch), root), no mix.
    The rows are made on the epoch tensors' device, with no host copy."""
    epochs = torch.stack([e.reshape(()) for e, _ in checkpoints]).view(torch.uint8)
    epochs = epochs.reshape(len(checkpoints), 8)
    rows = torch.cat([epochs, epochs.new_zeros((len(checkpoints), 24)),
                      torch.stack([root for _, root in checkpoints])], dim=1)
    return ListTree(rows, 64, 1, trees=len(checkpoints))


def checkpoint_roots(checkpoints, h: Hashers = KERNELS) -> torch.Tensor:
    """Checkpoint container roots H(chunk(epoch), root) for a list of
    (epoch, uint8[32] root) pairs, one K2 launch -> int32[B, 8]."""
    return h.list_roots([checkpoint_list(checkpoints)])


@lru_cache(maxsize=16)
def _bit_shifts(device: str) -> torch.Tensor:
    return torch.arange(4, dtype=torch.uint8, device=device)


def bits_list(bits) -> ListTree:
    """Bitvector[4] (bool[4]) as a K2 entry: its one byte, packed into its
    SSZ chunk, a depth-0 list of limit 0."""
    byte = (bits.to(torch.uint8) << _bit_shifts(str(bits.device))).sum(dtype=torch.uint8)
    return ListTree(byte.reshape(1), 1, 0)


def bitvector4_chunk(bits, h: Hashers = KERNELS) -> torch.Tensor:
    """Bitvector[4] (bool[4]) -> its SSZ chunk, int32[8]."""
    return h.list_roots([bits_list(bits)])[0]


def chunk_list(chunk: torch.Tensor) -> ListTree:
    """One int32[8] chunk as a depth-0 K2 entry: its root is the chunk."""
    return ListTree(chunk.reshape(1, 8), 1, 0)


def checkpoint_slot(slot_of: dict) -> int:
    """The top row of the first checkpoint. The three checkpoints are one
    K2 entry whose roots land in consecutive rows: raise unless their
    fields are consecutive."""
    first = slot_of[CHECKPOINT_FIELDS[0]]
    if [slot_of[f] for f in CHECKPOINT_FIELDS] != [first, first + 1, first + 2]:
        raise ValueError("the three checkpoint fields are not consecutive in the top container: "
                         f"{[slot_of[f] for f in CHECKPOINT_FIELDS]}")
    return first


def small_lists(slot_of: dict, just) -> dict:
    """The justification bits and the three checkpoints as K2 entries, by
    the top row each writes (the checkpoints' first of three)."""
    return {
        slot_of["justification_bits"]: bits_list(just.justification_bits),
        checkpoint_slot(slot_of): checkpoint_list([
            (just.prev_justified_epoch, just.prev_justified_root),
            (just.cur_justified_epoch, just.cur_justified_root),
            (just.finalized_epoch, just.finalized_root),
        ]),
    }


def top_state_root(h: Hashers, top_chunks, top_depth: int, entries: dict) -> torch.Tensor:
    """Every dynamic top chunk in one K2 list launch (``entries``: the
    ``ListTree`` of each, by its top row) over a copy of the static top
    chunks, then the container's root (a second K2 launch)."""
    chunks = top_chunks.clone()
    h.list_roots(list(entries.values()), chunks, list(entries))
    return h.tree_root(chunks, top_depth)


def _post_epoch_state_root(h: Hashers, arrays, meta, balances, effective_balance,
                           inactivity_scores, just):
    n = meta.n_validators
    slot_of = {name: i for i, name in meta.dynamic_slots}
    lists = {"validators": validator_list(arrays, n, effective_balance, h),
             "balances": ListTree(balances, n, BALANCE_LIMIT_CHUNKS_LOG2, n)}
    if "inactivity_scores" in slot_of:
        lists["inactivity_scores"] = ListTree(inactivity_scores, n, BALANCE_LIMIT_CHUNKS_LOG2, n)
    if "previous_epoch_participation" in slot_of:
        lists["previous_epoch_participation"] = ListTree(arrays.prev_part_flags, n,
                                                         PARTICIPATION_LIMIT_CHUNKS_LOG2, n)
    if "current_epoch_participation" in slot_of:
        # the rotated-in current participation is all zero: a constant of n
        lists["current_epoch_participation"] = chunk_list(arrays.cur_part_root)
    entries = {slot_of[name]: t for name, t in lists.items()}
    entries.update(small_lists(slot_of, just))
    return top_state_root(h, arrays.top_chunks, meta.top_depth, entries)


def post_epoch_state_root(arrays: StateRootArrays, meta: StateRootMeta, balances,
                          effective_balance, inactivity_scores, just) -> torch.Tensor:
    """hash_tree_root of the post-accounting BeaconState as int32[8] words;
    kernels K2 and K3 on a CUDA device (every dynamic top chunk in one K2
    launch, the top in a second), their plain versions on the CPU."""
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
    checkpoint and the top container, exactly as the plain path runs them.
    K2 hashes no node wholly past a list's chunks, so where a list does not
    fill its tree it runs fewer (``merkle.live_hashes``)."""
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
    three big trees (K3 into the leaf rows, then ``merkle_levels``), plus
    the static previous-participation list root."""
    n = meta.n_validators
    val_nodes = torch.zeros((1, merkle_inc.tree_nodes(plan.depth_val), 8), dtype=torch.int32,
                            device=balances.device)
    h.validator_leaves_into(val_nodes[0], effective_balance, arrays.slashed_chunk,
                            arrays.val_node_a, arrays.val_node_f)
    h.merkle_levels(val_nodes)
    part = h.list_roots([ListTree(arrays.prev_part_flags, n, PARTICIPATION_LIMIT_CHUNKS_LOG2, n)])
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


def _update_forest(h: Hashers, arrays: StateRootArrays, meta: StateRootMeta, plan: ForestPlan,
                   forest: StateForest, old_balances, old_effective_balance, old_inactivity_scores,
                   balances, effective_balance, inactivity_scores) -> list:
    """Apply one epoch's column changes to the forest in place, with no host
    synchronisation: the registry (dirty = hysteresis crossings; a dirty
    leaf is K3's chain of the new balance, the SSZ zero chunk past the
    registry) and the balance and score trees (dirty = a changed chunk) in
    one ``forest_update`` call. Returns the live dirty counts (int32[1]
    each) of the trees updated."""
    p = merkle_inc.ForestTree
    trees = [p(forest.val_nodes[0], "registry", old_effective_balance, effective_balance,
               static=(arrays.slashed_chunk, arrays.val_node_a, arrays.val_node_f),
               cap=plan.cap_val, dense=plan.dense_val),
             p(forest.bal_nodes[0], "u64", old_balances, balances, cap=plan.cap_bal,
               dense=plan.dense_bal)]
    if plan.has_inact and forest.inact_nodes is not None:
        trees.append(p(forest.inact_nodes[0], "u64", old_inactivity_scores, inactivity_scores,
                       cap=plan.cap_bal, dense=plan.dense_bal))
    return h.forest_update(trees)


def state_root_from_forest(arrays: StateRootArrays, meta: StateRootMeta, plan: ForestPlan,
                           forest: StateForest, just, h: Hashers = KERNELS) -> torch.Tensor:
    """The full post-epoch state root from a resident forest, with no dirty
    work: the tree roots folded to their limits and length-mixed, the
    participation roots, the small roots and the top combine. The root a
    checkpoint manifest carries and a restore re-verifies."""
    n = meta.n_validators
    slot_of = {name: i for i, name in meta.dynamic_slots}

    def folded(nodes, depth: int, limit: int) -> ListTree:  # a root reduced in the forest
        return ListTree(merkle_inc.forest_root(nodes).reshape(1, 8), 1, limit, mix=n, depth=0,
                        base=depth)

    lists = {"validators": folded(forest.val_nodes, plan.depth_val, VALIDATOR_REGISTRY_LIMIT_LOG2),
             "balances": folded(forest.bal_nodes, plan.depth_bal, BALANCE_LIMIT_CHUNKS_LOG2)}
    if plan.has_inact and "inactivity_scores" in slot_of:
        lists["inactivity_scores"] = folded(forest.inact_nodes, plan.depth_bal,
                                            BALANCE_LIMIT_CHUNKS_LOG2)
    if "previous_epoch_participation" in slot_of:
        lists["previous_epoch_participation"] = chunk_list(forest.part_root)
        lists["current_epoch_participation"] = chunk_list(arrays.cur_part_root)
    entries = {slot_of[name]: t for name, t in lists.items()}
    entries.update(small_lists(slot_of, just))
    return top_state_root(h, arrays.top_chunks, meta.top_depth, entries)


def post_epoch_state_root_inc(arrays: StateRootArrays, meta: StateRootMeta, plan: ForestPlan,
                              forest: StateForest, old_balances, old_effective_balance,
                              old_inactivity_scores, balances, effective_balance,
                              inactivity_scores, just, h: Hashers = KERNELS):
    """The post-epoch state root through the incremental forest: the
    columns' changes applied to the forest in place, then the root from
    the forest. Returns (forest, root), the root bit-identical to
    ``post_epoch_state_root`` on the same columns. K2 and the forest kernel
    on a CUDA device, their plain versions on the CPU."""
    _update_forest(h, arrays, meta, plan, forest, old_balances, old_effective_balance,
                   old_inactivity_scores, balances, effective_balance, inactivity_scores)
    return forest, state_root_from_forest(arrays, meta, plan, forest, just, h)
