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
from ..config import state_fields, top_depth as fork_top_depth
from ..lanes import MASK32, bswap32, to_i32, to_u32_lanes
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
    sha256_pairs: Callable
    tree_root: Callable
    validator_leaves: Callable


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


def validator_leaves_ref(eff, slashed_chunk, node_a, node_f, depth: int) -> torch.Tensor:
    """Plain torch version of K3: the 2^depth validator-root leaf level
    (zero rows past N)."""
    h = sha256_pairs_ref
    node_b = hash_rows(u64_chunk_words(eff), slashed_chunk, h)
    node_e = hash_rows(node_a, node_b, h)
    return pad_pow2(hash_rows(node_e, node_f, h), depth)


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
    _ext.check_cuda(eff, torch.int64, (n,))
    for t in (slashed_chunk, node_a, node_f):
        _ext.check_cuda(t, torch.int32, (n, 8))
    out = torch.empty((1 << depth, 8), dtype=torch.int32, device=eff.device)
    out[n:].zero_()
    _ext.launch("validator_leaves", "validator_leaves_launch", eff.device,
                _ext.ptr(eff), _ext.ptr(slashed_chunk), _ext.ptr(node_a), _ext.ptr(node_f),
                _ext.ptr(out), n)
    return out


KERNELS = Hashers(sha256_pairs, tree_root, validator_leaves)
PLAIN = Hashers(sha256_pairs_ref, tree_root_ref, validator_leaves_ref)


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

    def list_hashes(chunks: int, limit_log2: int) -> int:
        d = max(chunks - 1, 0).bit_length()
        return tree_real_hashes(d) + (limit_log2 - d) + 1

    hashes = 3 * n + list_hashes(n, VALIDATOR_REGISTRY_LIMIT_LOG2)
    hashes += list_hashes((n + 3) // 4, BALANCE_LIMIT_CHUNKS_LOG2)
    if "inactivity_scores" in names:
        hashes += list_hashes((n + 3) // 4, BALANCE_LIMIT_CHUNKS_LOG2)
    if "previous_epoch_participation" in names:
        hashes += list_hashes((n + 31) // 32, PARTICIPATION_LIMIT_CHUNKS_LOG2)
    return hashes + 3 + tree_real_hashes(meta.top_depth)


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
    random static nodes and field roots from a seeded ``torch.Generator``,
    unslashed validators. The same hash count and tree shape as a real
    state's; the roots mean nothing, the work is real."""
    from ..device import default_device

    dev = default_device(device)
    gen = torch.Generator().manual_seed(seed)
    depth = fork_top_depth(fork)

    def rnd(shape):
        return to_i32(torch.randint(0, 1 << 32, shape, generator=gen, dtype=torch.int64))

    arrays = arrays_from_host(
        rnd((n, 8)), rnd((n, 8)), torch.zeros((n, 8), dtype=torch.int32),
        torch.randint(0, 8, (n,), generator=gen, dtype=torch.int64).to(torch.uint8),
        rnd((1 << depth, 8)), n, dev,
    )
    meta = StateRootMeta(dynamic_slots(state_fields(fork)), n, depth)
    return arrays, meta
