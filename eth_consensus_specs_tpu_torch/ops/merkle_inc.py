"""Incremental dirty-path merkleization of a resident flat tree (kernels K5
``csrc/merkle_inc.cu`` and K6 ``csrc/merkle_levels.cu``).

Counterpart of ``eth_consensus_specs_tpu/ops/merkle_inc.py``. Every tree
keeps all its levels resident as one flat buffer, leaves first, root last::

    nodes: int32[S, 2^(d+1)-1, 8]      level k at row 2^(d+1) - 2^(d-k+1)

(S = 1: the port has no mesh yet), the JAX package's layout exactly, so
checkpoints and forests cross between the packages. An update re-hashes
only the ancestor paths of the dirty leaves (K5), or, past the crossover
where that loses to one rebuild, every level (K6). Both give identical
buffers for the same leaf content.

JAX donates the node buffer; the port updates it in place. The wrappers
dispatch by device: CUDA tensors launch the kernels, CPU tensors run the
plain torch versions (``*_ref``).

Branching without the host. JAX picks the sparse or dense branch with a
``lax.cond`` on the live dirty count. Here the compaction (K5) writes that
count to the device; every update (``apply_update``) then launches both
branches, and each kernel reads the count and returns at once when the
branch is not its own: the sparse side (``path_update``, and
``validator_leaves_at`` in ``state_root.py``) runs when ``count <= dense``,
the dense side (``merkle_levels`` and ``validator_leaves_into``) when
``count > dense``. The epoch loop thus never waits for the card. The plain
versions read the count on the host.
"""

from __future__ import annotations

import torch

from .. import _ext
from ..config import inc_dense_count, inc_dirty_bucket
from ..lanes import bswap32, to_i32, to_u32_lanes
from .sha256 import sha256_pairs_ref

MAX_LEVELS_PER_LAUNCH = 9  # K6: 512 nodes of 32 bytes in one block's shared memory
_COMPACT_SCRATCH = 4096  # K5 compaction: one int per cooperative block, at most


def tree_nodes(depth: int) -> int:
    """Rows of the flat node buffer of a depth-``depth`` tree."""
    return (1 << (depth + 1)) - 1


def tree_depth(n_nodes: int) -> int:
    """Inverse of :func:`tree_nodes`."""
    return (n_nodes + 1).bit_length() - 2


def level_offset(depth: int, k: int) -> int:
    """First row of level ``k`` (0 = leaves) in a depth-``depth`` tree."""
    return (2 << depth) - (2 << (depth - k))


def inc_update_hashes(depth: int, cap: int, leaf_hashes: int = 0) -> int:
    """Compressions one sparse update at capacity ``cap`` is charged in the
    JAX package's capacity model: cap rows per level plus ``leaf_hashes``
    per dirty leaf. (K5 hashes only the live rows.)"""
    return cap * (depth + leaf_hashes)


def _gate_open(count, dense: int, sparse: bool) -> bool:
    """Host-side reading of a branch gate, for the plain versions."""
    if count is None or (sparse and dense < 0):
        return True
    live = int(count.reshape(-1)[0])
    return live <= dense if sparse else live > dense


def _trees(nodes: torch.Tensor) -> torch.Tensor:
    """A [B, M, 8] view of one tree ([M, 8]) or a batch of trees."""
    return nodes if nodes.dim() == 3 else nodes.unsqueeze(0)


# ----------------------------------------------------------------- K6 --


def merkle_levels_ref(nodes: torch.Tensor, count=None, dense: int = 0) -> torch.Tensor:
    """Plain torch version of K6: level by level with the plain SHA."""
    trees = _trees(nodes)
    if not _gate_open(count, dense, sparse=False):
        return nodes
    depth = tree_depth(trees.shape[1])
    for k in range(depth):
        off, w = level_offset(depth, k), 1 << (depth - k)
        parents = sha256_pairs_ref(trees[:, off:off + w].reshape(-1, 16))
        trees[:, off + w:off + w + w // 2] = parents.reshape(trees.shape[0], w // 2, 8)
    return nodes


def merkle_levels(nodes: torch.Tensor, count=None, dense: int = 0) -> torch.Tensor:
    """Recompute every internal level of a flat tree ([M, 8]) or a batch of
    trees of one depth ([B, M, 8]) from its leaf rows, in place. With
    ``count`` (int32[1] on the device), only when ``count > dense``: the
    dense branch of an incremental update.

    CUDA tensors go through kernel K6, one launch per up to nine levels;
    CPU tensors through the plain version."""
    if nodes.device.type == "cpu":
        return merkle_levels_ref(nodes, count, dense)
    _ext.check_cuda(nodes, torch.int32)
    trees = _trees(nodes)
    if trees.shape[-1] != 8 or tree_nodes(tree_depth(trees.shape[1])) != trees.shape[1]:
        raise ValueError(f"expected [B, 2^(d+1)-1, 8] nodes, got {tuple(nodes.shape)}")
    if count is not None:
        _ext.check_cuda(count, torch.int32, (1,))
    depth, k = tree_depth(trees.shape[1]), 0
    while k < depth:
        levels = min(MAX_LEVELS_PER_LAUNCH, depth - k)
        _ext.launch("merkle_levels", "merkle_levels_launch", nodes.device, _ext.ptr(nodes),
                    trees.shape[0], depth, k, levels, _ext.ptr(count), int(dense))
        k += levels
    return nodes


def build_levels(leaves: torch.Tensor) -> torch.Tensor:
    """int32[..., 2^d, 8] leaves -> int32[..., 2^(d+1)-1, 8] all levels,
    leaves first, root last (batched over the leading dims)."""
    n = leaves.shape[-2]
    if n & (n - 1) or leaves.shape[-1] != 8:
        raise ValueError(f"expected [..., 2^d, 8] leaves, got {tuple(leaves.shape)}")
    out = leaves.new_empty((*leaves.shape[:-2], 2 * n - 1, 8))
    out[..., :n, :] = leaves
    merkle_levels(out.reshape(-1, 2 * n - 1, 8))
    return out


# ----------------------------------------------------------------- K5 --


def dirty_indices_ref(mask: torch.Tensor, cap: int):
    """Plain torch version of K5's compaction of a bool mask: a prefix sum,
    then a scatter whose entries past ``cap`` land in a dropped slot."""
    pos = torch.cumsum(mask.to(torch.int64), 0) - 1
    slot = torch.where(mask & (pos < cap), pos, torch.full_like(pos, cap))
    idx = torch.zeros(cap + 1, dtype=torch.int32, device=mask.device)
    idx.scatter_(0, slot, torch.arange(mask.shape[0], dtype=torch.int32, device=mask.device))
    return idx[:cap], mask.sum(dtype=torch.int32).reshape(1)


def _u64_chunks(vals: torch.Tensor, per: int, n_leaves: int) -> torch.Tensor:
    """int64[n] (u64) -> int32[n_leaves, 8] chunks of ``per`` values each,
    little-endian, zero past n."""
    vals = torch.cat([vals, vals.new_zeros(n_leaves * per - vals.shape[0])])
    w = to_i32(bswap32(to_u32_lanes(vals.view(torch.int32)))).reshape(n_leaves, 2 * per)
    return torch.cat([w, w.new_zeros((n_leaves, 8 - 2 * per))], dim=1)


def dirty_leaves_ref(old, new, per: int, n_leaves: int, cap: int, leaf_rows=None):
    """Plain torch version of K5's compaction of an old/new u64 column."""
    diff = old != new
    diff = torch.cat([diff, diff.new_zeros(n_leaves * per - diff.shape[0])])
    mask = diff.reshape(n_leaves, per).any(dim=1)
    if leaf_rows is not None:
        rows = leaf_rows[:n_leaves]
        rows.copy_(torch.where(mask[:, None], _u64_chunks(new, per, n_leaves), rows))
    return dirty_indices_ref(mask, cap)


def _compact(dev, mask, old, new, n_items: int, per: int, leaf_rows, n_leaves: int, cap: int):
    idx = torch.empty(cap, dtype=torch.int32, device=dev)
    count = torch.empty(1, dtype=torch.int32, device=dev)
    scratch = torch.empty(_COMPACT_SCRATCH, dtype=torch.int32, device=dev)
    _ext.launch("merkle_inc", "merkle_dirty_launch", dev, _ext.ptr(mask), _ext.ptr(old),
                _ext.ptr(new), n_items, per, _ext.ptr(leaf_rows), n_leaves, cap, _ext.ptr(idx),
                _ext.ptr(count), _ext.ptr(scratch), _COMPACT_SCRATCH)
    return idx, count


def dirty_indices(mask: torch.Tensor, cap: int):
    """bool[L] -> (int32[cap] indices of the True entries, ascending, padded
    with 0; int32[1] live count). Entries past ``cap`` are dropped: the
    caller's dense branch must take such masks.

    CUDA tensors go through kernel K5's compaction; CPU tensors through the
    plain version. (JAX's ``dirty_indices`` returns the indices alone; the
    count is what the port's branch gates read.)"""
    if mask.device.type == "cpu":
        return dirty_indices_ref(mask, cap)
    _ext.check_cuda(mask, torch.bool)
    if mask.dim() != 1 or cap < 1:
        raise ValueError(f"expected a 1-d mask and cap >= 1, got {tuple(mask.shape)}, {cap}")
    return _compact(mask.device, mask, None, None, mask.shape[0], 1, None, mask.shape[0], cap)


def dirty_leaves(old: torch.Tensor, new: torch.Tensor, per: int, n_leaves: int, cap: int,
                 leaf_rows: torch.Tensor | None = None):
    """Dirty leaves of an update of a u64 column, ``per`` values a leaf
    (1: a validator's effective balance; 4: a packed chunk), as
    ``dirty_indices`` gives them. With ``leaf_rows`` (the tree's flat
    buffer), each dirty leaf's new chunk is also written to its row.

    CUDA tensors go through kernel K5's compaction; CPU tensors through the
    plain version."""
    if not 1 <= per <= 4 or old.shape != new.shape or old.shape[0] > n_leaves * per or cap < 1:
        raise ValueError(f"bad column update: {tuple(old.shape)} vs {tuple(new.shape)}, "
                         f"{per} per leaf, {n_leaves} leaves, cap {cap}")
    if old.device.type == "cpu":
        return dirty_leaves_ref(old, new, per, n_leaves, cap, leaf_rows)
    for t in (old, new):
        _ext.check_cuda(t, torch.int64)
    if leaf_rows is not None:
        _ext.check_cuda(leaf_rows, torch.int32)
        if leaf_rows.shape[0] < n_leaves or leaf_rows.shape[1:] != (8,):
            raise ValueError(f"leaf rows {tuple(leaf_rows.shape)} hold fewer than {n_leaves} leaves")
    return _compact(old.device, None, old, new, old.shape[0], per, leaf_rows, n_leaves, cap)


def path_update_ref(nodes, idx, vals=None, count=None, dense: int = -1):
    """Plain torch version of K5's path update."""
    if not _gate_open(count, dense, sparse=True):
        return nodes
    live = idx.shape[0] if count is None else min(int(count.reshape(-1)[0]), idx.shape[0])
    if live == 0:
        return nodes
    depth = tree_depth(nodes.shape[0])
    leaf = idx[:live].to(torch.int64)
    if vals is not None:
        nodes[leaf] = vals[:live]
    for k in range(depth):
        parent = leaf >> (k + 1)
        child = level_offset(depth, k) + 2 * parent
        pair = torch.cat([nodes[child], nodes[child + 1]], dim=1)
        nodes[level_offset(depth, k + 1) + parent] = sha256_pairs_ref(pair)
    return nodes


def path_update(nodes: torch.Tensor, idx: torch.Tensor, vals: torch.Tensor | None = None,
                count: torch.Tensor | None = None, dense: int = -1) -> torch.Tensor:
    """Re-hash the ancestor paths of dirty leaves of one flat tree
    (int32[2^(d+1)-1, 8]) in place, after writing ``vals[j]`` (when given)
    to leaf ``idx[j]``. With ``count`` (int32[1]) only the first ``count``
    entries, and with ``dense >= 0`` nothing when ``count > dense``: the
    sparse branch of an incremental update. Duplicate indices are allowed
    (with equal values); indices must lie in [0, 2^d).

    CUDA tensors go through kernel K5, one cooperative launch; CPU tensors
    through the plain version."""
    if nodes.device.type == "cpu":
        return path_update_ref(nodes, idx, vals, count, dense)
    _ext.check_cuda(nodes, torch.int32)
    if nodes.dim() != 2 or tree_nodes(tree_depth(nodes.shape[0])) != nodes.shape[0]:
        raise ValueError(f"expected [2^(d+1)-1, 8] nodes, got {tuple(nodes.shape)}")
    _ext.check_cuda(idx, torch.int32)
    cap = idx.shape[0]
    if vals is not None:
        _ext.check_cuda(vals, torch.int32, (cap, 8))
    if count is not None:
        _ext.check_cuda(count, torch.int32, (1,))
    _ext.launch("merkle_inc", "merkle_path_update_launch", nodes.device, _ext.ptr(nodes),
                tree_depth(nodes.shape[0]), _ext.ptr(idx), cap, _ext.ptr(vals), _ext.ptr(count),
                int(dense))
    return nodes


# -------------------------------------------------------------- forests --


def apply_update(nodes: torch.Tensor, idx: torch.Tensor, count: torch.Tensor, dense_count: int,
                 leaves_at=None, leaves_into=None, plain: bool = False) -> torch.Tensor:
    """One tree's update from a compacted dirty set (``dirty_indices`` or
    ``dirty_leaves``), in place, with the branch decided on the device:
    the sparse path re-hash runs when the live ``count`` is at most
    ``dense_count``, the dense rebuild when it is above. Both are launched;
    each gated step returns at once when the branch is not its own.

    ``leaves_at(idx, count, dense_count) -> int32[cap, 8]`` gives the new
    leaves at the dirty indices for the sparse branch, and
    ``leaves_into(rows, count, dense_count)`` writes every leaf for the
    dense one; either is None when the compaction already wrote the leaf
    rows. ``plain`` takes the plain versions of K5 and K6 on any device
    (the reference path); otherwise they dispatch by device."""
    update, levels = (path_update_ref, merkle_levels_ref) if plain else (path_update, merkle_levels)
    vals = None if leaves_at is None else leaves_at(idx, count, dense_count)
    update(nodes, idx, vals, count, dense_count)
    if leaves_into is not None:
        leaves_into(nodes[:(nodes.shape[0] + 1) // 2], count, dense_count)
    return levels(nodes, count, dense_count)


def apply_dirty(nodes: torch.Tensor, mask: torch.Tensor, leaf_fn, cap: int,
                dense_count: int) -> torch.Tensor:
    """One tree's update, in place: the sparse path re-hash when the live
    dirty count is at most ``dense_count``, else the dense rebuild.
    ``leaf_fn(idx: int32[J]) -> int32[J, 8]`` gives the new leaf chunks at
    the given leaf indices (the SSZ zero chunk past the live leaves).

    The mask is compacted (K5) and the update goes through
    :func:`apply_update`, the step the resident epoch loop takes, so the
    host never reads the count. The dense leaves are written with a
    device-side select on the count."""
    n_leaves = (nodes.shape[0] + 1) // 2
    idx, count = dirty_indices(mask, cap)

    def leaves_into(rows, count, dense):
        new = leaf_fn(torch.arange(n_leaves, dtype=torch.int32, device=rows.device))
        rows.copy_(torch.where(count > dense, new, rows))

    return apply_update(nodes, idx, count, dense_count,
                        leaves_at=lambda idx, count, dense: leaf_fn(idx), leaves_into=leaves_into)


def build_forest(leaves: torch.Tensor, shards: int = 1) -> torch.Tensor:
    """int32[2^d, 8] leaves -> int32[S, 2^(dl+1)-1, 8] local trees."""
    n = leaves.shape[-2]
    return build_levels(leaves.reshape(shards, n // shards, 8))


def forest_root(nodes: torch.Tensor) -> torch.Tensor:
    """int32[S, M, 8] forest tree -> int32[8] root (S = 1: the stored root;
    else the shard roots combined)."""
    if nodes.shape[0] == 1:
        return nodes[0, -1]
    return build_levels(nodes[:, -1])[-1]


def forest_apply(nodes: torch.Tensor, mask: torch.Tensor, leaf_inputs: tuple, leaf_fn, cap: int,
                 dense_count: int):
    """Apply one dirty set to a single-shard forest tree (int32[1, M, 8]) in
    place: ``mask`` bool[1, L], ``leaf_fn(inputs, idx)`` with the per-leaf
    inputs' shard-0 rows. Returns (nodes, root)."""
    if nodes.shape[0] != 1:
        raise NotImplementedError("sharded forests are not ported yet")
    inputs = tuple(a[0] for a in leaf_inputs)
    apply_dirty(nodes[0], mask[0], lambda idx: leaf_fn(inputs, idx), cap, dense_count)
    return nodes, nodes[0, -1]


def update_forest(nodes: torch.Tensor, mask: torch.Tensor, leaves: torch.Tensor,
                  cap: int | None = None):
    """One forest-tree update from a whole new leaf level (int32[1, L, 8]):
    the dirty capacity is the live count's bucket unless ``cap`` is given.
    Returns (nodes, root)."""
    n_local = mask.shape[1]
    if cap is None:
        cap = inc_dirty_bucket(max(int(mask.sum()), 1))
    cap = min(cap, n_local)
    dense = inc_dense_count(tree_depth(nodes.shape[-2]), cap)
    return forest_apply(nodes, mask, (leaves,), lambda inputs, idx: inputs[0][idx.to(torch.int64)],
                        cap, dense)
