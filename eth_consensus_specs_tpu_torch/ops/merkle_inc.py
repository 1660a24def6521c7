"""The incremental forest: resident flat merkle trees updated in place
(the forest update, ``csrc/forest_update.cu``, in place of kernel K5's
path update and of K6; K5's compaction, ``csrc/merkle_inc.cu``).

Counterpart of ``eth_consensus_specs_tpu/ops/merkle_inc.py``. Every tree
keeps all its levels resident as one flat buffer, leaves first, root last::

    nodes: int32[S, 2^(d+1)-1, 8]      level k at row 2^(d+1) - 2^(d-k+1)

(S = 1: the port has no mesh yet), the JAX package's layout exactly, so
checkpoints and forests cross between the packages. JAX donates the node
buffer; the port updates it in place.

The update. JAX re-hashes the ancestor paths of the dirty leaves (the
sparse branch) or, past the crossover where that loses to one rebuild,
every level (the dense branch), picked by a ``lax.cond`` on the live dirty
count. Both give the same buffer for the same leaf content. On the card
one kernel covers both with one rule, hashing a node when one of its
children is dirty: ``forest_update`` takes a table of trees (``ForestTree``:
a u64 column diff, the registry's effective-balance diff with K3's leaf
chain in the kernel, a mask with new leaf rows, or every leaf of a batch)
and updates all of them in one launch, writing each tree's dirty count on
the device. ``merkle_levels``/``build_levels`` (every leaf dirty) and
``apply_dirty`` are one launch a call; ``path_update`` two (a mark pass,
then the update). Nothing waits for the card: no branch is decided on the
host or launched only to return at its gate.

The plain twin keeps JAX's branches: ``forest_update_ref`` compacts each
tree's dirty set (``dirty_leaves_ref``/``dirty_indices_ref``) and takes
the sparse path update or the dense rebuild by the forest plan's capacity
and dense count (``apply_update_ref``). The wrappers dispatch by device:
CUDA tensors launch the kernels, CPU tensors run the plain versions.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import numpy as np
import torch

from .. import _ext
from ..config import inc_dense_count, inc_dirty_bucket
from ..lanes import bswap32, to_i32, to_u32_lanes
from .merkle import GROUP_LOG, climb_plan, u64_chunk_words
from .sha256 import hash_rows, sha256_pairs_ref

MAX_TREES = 8  # entries of one forest_update table (csrc/forest_update.cu kMaxTrees)
KINDS = {"u64": 0, "registry": 1, "mask": 2, "all": 3}
# K5's compaction (csrc/merkle_inc.cu): a tile is 256 threads of 16 values (mask bytes, or
# u64 of each column), its status words carry generations in [1, 2^30)
COMPACT_THREADS, COMPACT_VALUES = 256, 16
COMPACT_GENERATIONS = 1 << 30

# csrc/forest_update.cu's ForestTree, field for field
FOREST_TREE_DTYPE = np.dtype([
    ("nodes", "<u8"), ("old_v", "<u8"), ("new_v", "<u8"), ("mask", "<u8"), ("rows", "<u8"),
    ("slashed", "<u8"), ("node_a", "<u8"), ("node_f", "<u8"), ("count", "<u8"), ("gate", "<u8"),
    ("n", "<i8"), ("live", "<i8"), ("block0", "<i8"), ("blocks", "<i8"), ("nodes_stride", "<i8"),
    ("cnt0", "<i8"), ("cnt_stride", "<i8"), ("flag0", "<i8"), ("flag_stride", "<i8"),
    ("trees", "<i4"), ("kind", "<i4"), ("depth", "<i4"), ("per", "<i4"), ("gate_dense", "<i4"),
    ("clear", "<i4"),
])
assert FOREST_TREE_DTYPE.itemsize == 176


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
    per dirty leaf. (The forest kernel hashes only the dirty parents.)"""
    return cap * (depth + leaf_hashes)


def _gate_open(count, dense: int, sparse: bool) -> bool:
    """Host-side reading of a branch gate, for the plain versions."""
    if count is None or (sparse and dense < 0):
        return True
    live = int(count.reshape(-1)[0])
    return live <= dense if sparse else live > dense


# ------------------------------------------------------ the forest update --


class ForestTree(NamedTuple):
    """One tree of a ``forest_update`` call: its flat node buffer ``nodes``
    (int32[2^(d+1)-1, 8]; kind ``"all"`` also int32[B, 2^(d+1)-1, 8], B like
    trees) and its leaf source, by ``kind``:

    * ``"u64"``: a column diff, ``old`` and ``new`` int64 (u64) values,
      ``per`` a leaf (4: a packed balance or score chunk); a leaf is dirty
      where a value differs, and its new chunk is written to its row;
    * ``"registry"``: the effective balances ``old`` and ``new``, one a
      leaf, with ``static`` = (slashed chunks, node A, node F), int32[n, 8]
      each; a dirty leaf's row is K3's validator chain of the new balance;
    * ``"mask"``: ``mask`` bool or uint8[L] (L <= 2^d), the new rows in
      ``rows`` (int32[>= L, 8]) or, when None, already in the leaf rows;
      with ``clear``, the kernel resets each set entry as it reads it (the
      plain twin leaves the mask as it is);
    * ``"all"``: every leaf dirty, rows in place; with ``gate`` (int32[1])
      only when ``gate > dense``.

    Leaves outside the dirty set must hold their stored rows (as JAX's
    sparse branch assumes). ``cap`` and ``dense`` are the forest plan's
    capacity and dense count, which the plain twin's branches read; the
    kernel does not."""

    nodes: torch.Tensor
    kind: str
    old: torch.Tensor | None = None
    new: torch.Tensor | None = None
    per: int = 4
    static: tuple | None = None
    mask: torch.Tensor | None = None
    rows: torch.Tensor | None = None
    gate: torch.Tensor | None = None
    dense: int = 0
    cap: int = 1
    clear: bool = False


def _trees(nodes: torch.Tensor) -> torch.Tensor:
    """A [B, M, 8] view of one tree ([M, 8]) or a batch of trees."""
    return nodes if nodes.dim() == 3 else nodes.unsqueeze(0)


def forest_depth(t: ForestTree) -> int:
    return tree_depth(t.nodes.shape[-2])


def live_leaves(t: ForestTree) -> int:
    """Leaves of a tree that hold a value: the rest are never dirty."""
    if t.kind == "u64":
        return -(-t.old.shape[0] // t.per)
    if t.kind == "registry":
        return t.old.shape[0]
    if t.kind == "mask":
        return t.mask.shape[0]
    return 1 << forest_depth(t)


def _check_tree(t: ForestTree) -> None:
    if t.kind not in KINDS:
        raise ValueError(f"unknown forest tree kind {t.kind!r}")
    nodes = t.nodes
    if (nodes.dim() not in ((2, 3) if t.kind == "all" else (2,)) or nodes.shape[-1] != 8
            or tree_nodes(tree_depth(nodes.shape[-2])) != nodes.shape[-2]
            or nodes.dtype != torch.int32):
        raise ValueError(f"expected int32 [2^(d+1)-1, 8] nodes, got {tuple(nodes.shape)}")
    n_leaves = 1 << forest_depth(t)
    if t.kind in ("u64", "registry"):
        if t.old is None or t.new is None or t.old.shape != t.new.shape or t.old.dim() != 1:
            raise ValueError("a column diff needs old and new values of one shape")
        per = t.per if t.kind == "u64" else 1
        if not 1 <= per <= 4 or t.old.shape[0] > n_leaves * per:
            raise ValueError(f"{t.old.shape[0]} values at {per} a leaf exceed {n_leaves} leaves")
        if t.kind == "registry" and (t.static is None or len(t.static) != 3):
            raise ValueError("a registry diff needs (slashed, node_a, node_f)")
    elif t.kind == "mask":
        if t.mask is None or t.mask.dim() != 1 or t.mask.shape[0] > n_leaves:
            raise ValueError(f"a mask over at most {n_leaves} leaves is needed")
        if t.rows is not None and (t.rows.dim() != 2 or t.rows.shape[0] < t.mask.shape[0]
                                   or t.rows.shape[1] != 8):
            raise ValueError(f"leaf rows {tuple(t.rows.shape)} do not cover the mask")


def validator_chain_ref(eff, slashed_chunk, node_a, node_f) -> torch.Tensor:
    """Plain torch version of K3's chain: H(H(A, H(eb_chunk, slashed)), F)
    a validator."""
    h = sha256_pairs_ref
    node_b = hash_rows(u64_chunk_words(eff), slashed_chunk, h)
    node_e = hash_rows(node_a, node_b, h)
    return hash_rows(node_e, node_f, h)


def forest_update_ref(trees) -> list:
    """Plain torch version of the forest update, JAX's composition: each
    tree's dirty set compacted at its capacity (``dirty_leaves_ref``,
    ``dirty_indices_ref``), then the sparse path update or the dense rebuild
    by its dense count (``apply_update_ref``), K3's plain chain for the
    registry's leaves. Returns each tree's live dirty count (int32[1]; None
    for kind ``"all"``)."""
    from .state_root import validator_leaves_at_ref, validator_leaves_into_ref

    counts = []
    for t in trees:
        _check_tree(t)
        nodes, n_leaves = t.nodes, 1 << forest_depth(t)
        if t.kind == "all":
            merkle_levels_ref(nodes, t.gate, t.dense)
            counts.append(None)
            continue
        if t.kind == "u64":
            idx, count = dirty_leaves_ref(t.old, t.new, t.per, n_leaves, t.cap, nodes)
            apply_update_ref(nodes, idx, count, t.dense)
        elif t.kind == "registry":
            inputs = (t.new, *t.static)
            idx, count = dirty_leaves_ref(t.old, t.new, 1, n_leaves, t.cap)
            apply_update_ref(
                nodes, idx, count, t.dense,
                leaves_at=lambda idx, count, dense: validator_leaves_at_ref(*inputs, idx, count,
                                                                            dense),
                leaves_into=lambda rows, count, dense: validator_leaves_into_ref(rows, *inputs,
                                                                                 count, dense))
        else:
            mask = t.mask.to(torch.bool)
            idx, count = dirty_indices_ref(mask, t.cap)
            rows = t.rows

            def leaves_into(dst, count, dense, rows=rows, live=mask.shape[0]):
                if _gate_open(count, dense, sparse=False):
                    dst[:live] = rows[:live]

            apply_update_ref(nodes, idx, count, t.dense,
                             leaves_at=None if rows is None else
                             lambda idx, count, dense, rows=rows: rows[idx.to(torch.int64)],
                             leaves_into=None if rows is None else leaves_into)
        counts.append(count)
    return counts


def forest_table(trees, group_log: int = GROUP_LOG) -> tuple:
    """The forest kernel's table of ``trees`` (``FOREST_TREE_DTYPE``, the
    tensors' addresses in it), the grid's leaf blocks and the scratch
    counters and flags the launch uses: each tree cut as K2 cuts it
    (``merkle.climb_plan`` over its live leaves), its counters the climb's
    groups and one accumulator."""
    if not 1 <= len(trees) <= MAX_TREES:
        raise ValueError(f"one launch takes 1 to {MAX_TREES} trees, got {len(trees)}")
    table = np.zeros(len(trees), FOREST_TREE_DTYPE)
    addr = lambda x: 0 if x is None else x.data_ptr()  # noqa: E731
    block0 = cnt0 = flag0 = 0
    for e, t in zip(table, trees):
        depth, live = forest_depth(t), live_leaves(t)
        plan = climb_plan(live, depth, group_log)
        batch = t.nodes.shape[0] if t.nodes.dim() == 3 else 1
        slashed, node_a, node_f = t.static if t.kind == "registry" else (None, None, None)
        e["nodes"], e["old_v"], e["new_v"] = addr(t.nodes), addr(t.old), addr(t.new)
        e["mask"], e["rows"], e["gate"] = addr(t.mask), addr(t.rows), addr(t.gate)
        e["slashed"], e["node_a"], e["node_f"] = addr(slashed), addr(node_a), addr(node_f)
        e["n"] = t.old.shape[0] if t.kind in ("u64", "registry") else live
        e["live"], e["kind"], e["depth"] = live, KINDS[t.kind], depth
        e["per"] = t.per if t.kind == "u64" else 1
        e["gate_dense"] = t.dense
        e["clear"] = int(t.kind == "mask" and t.clear)
        e["trees"], e["blocks"], e["block0"] = batch, plan.blocks, block0
        e["nodes_stride"] = t.nodes.shape[-2]
        e["cnt0"], e["cnt_stride"] = cnt0, plan.counters + 1
        e["flag0"], e["flag_stride"] = flag0, plan.nodes
        block0 += batch * plan.blocks
        cnt0 += batch * (plan.counters + 1)
        flag0 += batch * plan.nodes
    return table, block0, cnt0, flag0


class _Scratch:
    """The forest kernel's scratch on one stream of one card: the climb's
    group counters and accumulators, zero between launches (each launch's
    finishers reset what they complete), its child flags, written before
    they are read, and ``path_update``'s leaf mask, zero between calls (the
    mark pass sets it, the forest kernel resets what it reads); and K5's
    compaction's ticket counter and tile status words. Launches on two
    streams would overlap, so each stream has a scratch of its own."""

    def __init__(self):
        self.counters = None
        self.flags = None
        self.mask = None
        self.status = None
        self.gen = 0

    def leaf_mask(self, n_leaves: int, dev: torch.device) -> torch.Tensor:
        if self.mask is None or self.mask.shape[0] < n_leaves:
            self.mask = torch.zeros(n_leaves, dtype=torch.uint8, device=dev)
        return self.mask[:n_leaves]

    def compact_status(self, words: int, dev: torch.device):
        """K5's compaction scratch of at least ``words`` u64 words (the
        ticket counter, zero between launches, then a status word a tile)
        and this call's generation. Status words are never reset: each call
        tags them with a new generation, and the array is zeroed only when
        the generations wrap."""
        if self.status is None or self.status.shape[0] < words:
            self.status = torch.zeros(max(words, 1 << 10), dtype=torch.int64, device=dev)
        self.gen += 1
        if self.gen >= COMPACT_GENERATIONS:
            self.status.zero_()
            self.gen = 1
        return self.status, self.gen

    def get(self, counters: int, flags: int, dev: torch.device):
        if self.counters is None or self.counters.shape[0] < counters:
            self.counters = torch.zeros(max(counters, 1 << 10), dtype=torch.int32, device=dev)
        if self.flags is None or self.flags.shape[0] < flags:
            self.flags = torch.empty(max(flags, 1 << 12), dtype=torch.int32, device=dev)
        return self.counters, self.flags


_scratch: dict[tuple, _Scratch] = {}  # by (device, stream)


def _stream_scratch(dev: torch.device) -> _Scratch:
    key = (_ext.device_index(dev), _ext.stream(dev))
    scratch = _scratch.get(key)
    if scratch is None:
        scratch = _scratch[key] = _Scratch()
    return scratch


def _check_cuda_tree(t: ForestTree) -> None:
    _ext.check_cuda(t.nodes, torch.int32)
    if t.nodes.data_ptr() % 16:
        raise ValueError("the forest kernel reads node rows 16 bytes at a time: align them")
    if t.kind in ("u64", "registry"):
        for v in (t.old, t.new):
            _ext.check_cuda(v, torch.int64)
    if t.kind == "registry":
        n = t.old.shape[0]
        for a in t.static:
            _ext.check_cuda(a, torch.int32, (n, 8))
    if t.kind == "mask":
        _ext.check_cuda(t.mask, t.mask.dtype)
        if t.mask.dtype not in (torch.bool, torch.uint8):
            raise ValueError(f"expected a bool or uint8 mask, got {t.mask.dtype}")
        if t.rows is not None:
            _ext.check_cuda(t.rows, torch.int32)
            if t.rows.data_ptr() % 16:
                raise ValueError("the forest kernel reads leaf rows 16 bytes at a time: align them")
    if t.gate is not None:
        _ext.check_cuda(t.gate, torch.int32, (1,))


def forest_update(trees) -> list:
    """Update up to ``MAX_TREES`` flat trees (``ForestTree``) in place and
    return each tree's live dirty count (int32[1] on its device; None for
    kind ``"all"``). The trees must not share a buffer.

    CUDA tensors go through the forest kernel, one launch for every tree
    (counted as ``forest_update``); CPU tensors through the plain version."""
    if not trees:
        raise ValueError("no trees")
    if trees[0].nodes.device.type == "cpu":
        return forest_update_ref(trees)
    dev = trees[0].nodes.device
    for t in trees:
        _check_tree(t)
        _check_cuda_tree(t)
    counted = [i for i, t in enumerate(trees) if t.kind != "all"]
    out = torch.empty(len(counted), dtype=torch.int32, device=dev) if counted else None
    counts = [None] * len(trees)
    for j, i in enumerate(counted):
        counts[i] = out[j:j + 1]
    table, blocks, n_cnt, n_flags = forest_table(trees)
    for e, c in zip(table, counts):
        e["count"] = 0 if c is None else c.data_ptr()
    cnt, flags = _stream_scratch(dev).get(n_cnt, n_flags, dev)
    _ext.launch("forest_update", "forest_update_launch", dev, ctypes.c_void_p(table.ctypes.data),
                len(trees), _ext.ptr(cnt), _ext.ptr(flags), blocks)
    return counts


def merkle_levels_ref(nodes: torch.Tensor, count=None, dense: int = 0) -> torch.Tensor:
    """Plain torch version of the rebuild: level by level with the plain
    SHA."""
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

    CUDA tensors go through the forest kernel, one launch at any depth
    (every leaf dirty); CPU tensors through the plain version."""
    if nodes.device.type == "cpu":
        return merkle_levels_ref(nodes, count, dense)
    trees = _trees(nodes)
    if trees.shape[-1] != 8 or tree_nodes(tree_depth(trees.shape[1])) != trees.shape[1]:
        raise ValueError(f"expected [B, 2^(d+1)-1, 8] nodes, got {tuple(nodes.shape)}")
    if trees.shape[0] > 0x7FFFFFFF:
        raise ValueError(f"{trees.shape[0]} trees do not fit one launch")
    forest_update([ForestTree(trees, "all", gate=count, dense=int(dense))])
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


# -------------------------------------------------------- K5 compaction --


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


def compact_tile_leaves(per: int, mask: bool) -> int:
    """Leaves of one tile of K5's compaction: 4,096 of a mask, 4,096 // per
    values' worth of a diff (16 // per leaves a thread)."""
    return COMPACT_THREADS * (COMPACT_VALUES if mask else COMPACT_VALUES // per)


def _compact(dev, mask, old, new, n_items: int, per: int, leaf_rows, n_leaves: int, cap: int):
    # one allocation: the indices, then the count (the wrapper's host time
    # is most of a call: addresses go to the launch as plain ints)
    out = torch.empty(cap + 1, dtype=torch.int32, device=dev)
    tile = compact_tile_leaves(per, mask is not None)
    status, gen = _stream_scratch(dev).compact_status(1 + -(-n_leaves // tile), dev)
    addr = out.data_ptr()
    _ext.launch("merkle_inc", "merkle_dirty_launch", dev, *(
        None if t is None else t.data_ptr() for t in (mask, old, new)), n_items, per,
        None if leaf_rows is None else leaf_rows.data_ptr(), n_leaves, cap, addr, addr + 4 * cap,
        status.data_ptr(), status.shape[0], gen)
    return out.split_with_sizes((cap, 1))


def dirty_indices(mask: torch.Tensor, cap: int):
    """bool[L] -> (int32[cap] indices of the True entries, ascending, padded
    with 0; int32[1] live count). Entries past ``cap`` are dropped: the
    caller's dense branch must take such masks.

    CUDA tensors go through kernel K5's compaction; CPU tensors through the
    plain version. (JAX's ``dirty_indices`` returns the indices alone.) No
    path of the port compacts since the forest update."""
    dev = mask.device
    if dev.type == "cpu":
        return dirty_indices_ref(mask, cap)
    _ext.check_cuda(mask, torch.bool)
    if mask.dim() != 1 or cap < 1:
        raise ValueError(f"expected a 1-d mask and cap >= 1, got {tuple(mask.shape)}, {cap}")
    n = mask.shape[0]
    return _compact(dev, mask, None, None, n, 1, None, n, cap)


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


# ------------------------------------------------------------ path update --


def path_update_ref(nodes, idx, vals=None, count=None, dense: int = -1):
    """Plain torch version of the path update: level by level, a hash a
    dirty path."""
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


def mark_leaves_ref(nodes, idx, vals=None, count=None, dense: int = -1,
                    out=None) -> torch.Tensor:
    """Plain torch version of path_update's mark pass."""
    n_leaves = (nodes.shape[0] + 1) // 2
    mask = torch.zeros(n_leaves, dtype=torch.uint8, device=nodes.device) if out is None else out
    if not _gate_open(count, dense, sparse=True):
        return mask
    live = idx.shape[0] if count is None else min(int(count.reshape(-1)[0]), idx.shape[0])
    leaf = idx[:live].to(torch.int64)
    keep = (leaf >= 0) & (leaf < n_leaves)
    if vals is not None:
        nodes[leaf[keep]] = vals[:live][keep]
    mask[leaf[keep]] = 1
    return mask


def mark_leaves(nodes: torch.Tensor, idx: torch.Tensor, vals: torch.Tensor | None = None,
                count: torch.Tensor | None = None, dense: int = -1,
                out: torch.Tensor | None = None) -> torch.Tensor:
    """The first pass of ``path_update``: ``vals[j]`` (when given) written to
    leaf ``idx[j]`` of a flat tree and the leaf marked, for the entries
    ``path_update`` takes (an index outside [0, 2^d) is skipped). Returns
    the uint8[2^d] mask: ``out`` when given (its other entries left as they
    are), else a new zero one.

    CUDA tensors go through the mark kernel of ``csrc/forest_update.cu``
    (counted as ``forest_mark``); CPU tensors through the plain version."""
    if nodes.device.type == "cpu":
        return mark_leaves_ref(nodes, idx, vals, count, dense, out)
    _ext.check_cuda(nodes, torch.int32)
    if nodes.dim() != 2 or tree_nodes(tree_depth(nodes.shape[0])) != nodes.shape[0]:
        raise ValueError(f"expected [2^(d+1)-1, 8] nodes, got {tuple(nodes.shape)}")
    _ext.check_cuda(idx, torch.int32)
    cap = idx.shape[0]
    if cap < 1:
        raise ValueError("no indices")
    if vals is not None:
        _ext.check_cuda(vals, torch.int32, (cap, 8))
    if count is not None:
        _ext.check_cuda(count, torch.int32, (1,))
    n_leaves = (nodes.shape[0] + 1) // 2
    if out is None:
        mask = torch.zeros(n_leaves, dtype=torch.uint8, device=nodes.device)
    else:
        mask = out
        _ext.check_cuda(mask, torch.uint8, (n_leaves,))
    _ext.launch("forest_update", "forest_mark_launch", nodes.device, _ext.ptr(nodes), n_leaves,
                _ext.ptr(idx), cap, _ext.ptr(vals), _ext.ptr(count), int(dense), _ext.ptr(mask),
                counter="forest_mark")
    return mask


def path_update(nodes: torch.Tensor, idx: torch.Tensor, vals: torch.Tensor | None = None,
                count: torch.Tensor | None = None, dense: int = -1) -> torch.Tensor:
    """Re-hash the ancestor paths of dirty leaves of one flat tree
    (int32[2^(d+1)-1, 8]) in place, after writing ``vals[j]`` (when given)
    to leaf ``idx[j]``. With ``count`` (int32[1]) only the first ``count``
    entries, and with ``dense >= 0`` nothing when ``count > dense``: the
    sparse branch of an incremental update. Duplicate indices are allowed
    (with equal values); indices must lie in [0, 2^d).

    CUDA tensors take two launches, ``mark_leaves`` into the stream's
    scratch mask and the forest kernel over the marked leaves, which resets
    the mask as it reads it; CPU tensors go through the plain version."""
    if nodes.device.type == "cpu":
        return path_update_ref(nodes, idx, vals, count, dense)
    _ext.check_cuda(nodes, torch.int32)
    n_leaves = (nodes.shape[0] + 1) // 2
    tree = ForestTree(nodes, "mask", mask=_stream_scratch(nodes.device).leaf_mask(
        n_leaves, nodes.device), clear=True)
    _check_tree(tree)  # before the mark pass sets the scratch mask
    _check_cuda_tree(tree)
    mark_leaves(nodes, idx, vals, count, dense, out=tree.mask)
    forest_update([tree])
    return nodes


# -------------------------------------------------------------- forests --


def apply_update_ref(nodes: torch.Tensor, idx: torch.Tensor, count: torch.Tensor,
                     dense_count: int, leaves_at=None, leaves_into=None) -> torch.Tensor:
    """One tree's update from a compacted dirty set (``dirty_indices_ref``
    or ``dirty_leaves_ref``), in place, JAX's two branches in plain torch:
    the sparse path re-hash when the live ``count`` is at most
    ``dense_count``, the dense rebuild when it is above.

    ``leaves_at(idx, count, dense_count) -> int32[cap, 8]`` gives the new
    leaves at the dirty indices for the sparse branch, and
    ``leaves_into(rows, count, dense_count)`` writes every leaf for the
    dense one; either is None when the leaf rows already hold them."""
    vals = None if leaves_at is None else leaves_at(idx, count, dense_count)
    path_update_ref(nodes, idx, vals, count, dense_count)
    if leaves_into is not None:
        leaves_into(nodes[:(nodes.shape[0] + 1) // 2], count, dense_count)
    return merkle_levels_ref(nodes, count, dense_count)


def apply_dirty(nodes: torch.Tensor, mask: torch.Tensor, leaf_fn, cap: int,
                dense_count: int) -> torch.Tensor:
    """One tree's update, in place: the sparse path re-hash when the live
    dirty count is at most ``dense_count``, else the dense rebuild.
    ``leaf_fn(idx: int32[J]) -> int32[J, 8]`` gives the new leaf chunks at
    the given leaf indices (the SSZ zero chunk past the live leaves).

    CUDA tensors go through the forest kernel in one launch, the new leaf
    level from ``leaf_fn`` over every leaf and only the masked ones taken;
    CPU tensors through the plain branches (K5's compaction's plain
    version, then ``apply_update_ref``)."""
    n_leaves = (nodes.shape[0] + 1) // 2
    if nodes.device.type != "cpu":
        rows = leaf_fn(torch.arange(n_leaves, dtype=torch.int32, device=nodes.device))
        forest_update([ForestTree(nodes, "mask", mask=mask, rows=rows.contiguous(), cap=cap,
                                  dense=dense_count)])
        return nodes
    idx, count = dirty_indices_ref(mask, cap)

    def leaves_into(rows, count, dense):
        new = leaf_fn(torch.arange(n_leaves, dtype=torch.int32, device=rows.device))
        rows.copy_(torch.where(count > dense, new, rows))

    return apply_update_ref(nodes, idx, count, dense_count,
                            leaves_at=lambda idx, count, dense: leaf_fn(idx),
                            leaves_into=leaves_into)


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
