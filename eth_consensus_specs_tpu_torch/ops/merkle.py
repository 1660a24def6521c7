"""SSZ list roots and binary merkle reduction on the card (kernel K2,
``csrc/merkle.cu``), and the subtree-root entry points around them.

Counterpart of ``eth_consensus_specs_tpu/ops/merkle.py`` and of the list
roots of ``eth_consensus_specs_tpu/ops/state_root.py``:

* ``list_roots`` of ``fold_to_limit`` (:121), ``mix_length`` (:138),
  ``validator_registry_root`` (:161), ``u64_list_root`` (:182) and
  ``u8_list_root`` (:194): the roots of a batch of lists (``ListTree``),
  each its subtree over chunk words, packed u64 values or packed bytes,
  folded with zero-hash siblings to its limit depth and mixed with its
  length, every tree in one launch;
* ``tree_root`` of ``tree_root_words`` (:68): int32[2^d, 8] leaf chunks ->
  int32[8] root, one launch;
* ``many_tree_root`` of ``many_tree_root_words`` (:97): int32[B, 2^d, 8] ->
  int32[B, 8], one launch;
* ``chunks_to_words``, ``merkleize_many_device`` and
  ``merkleize_subtree_device`` of the same names: 32-byte chunks from the
  host (or pre-packed big-endian words) to 32-byte roots, zero-padded to
  2^d leaves, which gives the SSZ root of the padded subtree;
* the SSZ packing and zero-hash helpers the state roots share.

The plain version of K2 (``list_roots_ref``) is the composition the JAX
package runs: the padded leaf level, the tree level by level
(``tree_root_ref``), the fold a hash a level (``fold_many``) and the mix
(``mix_length``), over the plain SHA.

The JAX entry points also take a device ``mesh`` that splits the tree axis;
the port's sharded form waits for its multi-card slice.
"""

from __future__ import annotations

import ctypes
import hashlib
from functools import lru_cache
from typing import NamedTuple

import numpy as np
import torch

from .. import _ext
from ..device import default_device
from ..lanes import MASK32, bswap32, to_i32, to_u32_lanes
from .sha256 import hash_rows, sha256_pairs, sha256_pairs_ref

GROUP_LOG = 9  # csrc/merkle.cu's kGroupLog: 512 nodes of 32 bytes in one block's shared memory
MAX_TREES = 8  # entries of one launch's table (kMaxTrees)
MAX_LEVEL = 63  # the deepest limit a root is folded to (kMaxLevel)
ITEM_BYTES = {torch.int32: 0, torch.int64: 8, torch.uint8: 1}  # chunk words, u64, u8

# csrc/merkle.cu's ListTree, field for field
LIST_TREE_DTYPE = np.dtype([
    ("src", "<u8"), ("out", "<u8"), ("n", "<i8"), ("mix_len", "<u8"), ("block0", "<i8"),
    ("blocks", "<i8"), ("src_stride", "<i8"), ("nodes0", "<i8"), ("nodes_stride", "<i8"),
    ("cnt0", "<i8"), ("cnt_stride", "<i8"), ("out_stride", "<i8"), ("trees", "<i4"),
    ("item_bytes", "<i4"), ("depth", "<i4"), ("base", "<i4"), ("limit", "<i4"), ("mix", "<i4"),
    ("pad", "<i8"),
])
assert LIST_TREE_DTYPE.itemsize == 128


class ListTree(NamedTuple):
    """One list of a ``list_roots`` call, or ``trees`` like lists.

    ``src`` holds the leaves: int32[>= n, 8] chunk words (n chunks), or the
    items packed 32 bytes a chunk: int64[>= n] u64 values or uint8[>= n]
    bytes. The subtree has 2^depth leaves (by default the fewest that hold
    its chunks; past them the leaves are zero) at level ``base`` (0, or the
    level of a subtree root reduced elsewhere: chunk words, n = 1, depth 0).
    Its root is folded with zerohashes[l] up to level ``limit`` and, where
    ``mix`` is not None, hashed with the u64 chunk of ``mix``. A depth-0
    list of limit 0 is its one chunk.

    With ``trees`` = B, ``src`` has a leading batch dimension of B lists of
    that shape (one K2 table entry of B like trees), whose roots land in B
    consecutive rows."""

    src: torch.Tensor
    n: int
    limit: int
    mix: int | None = None
    depth: int | None = None
    base: int = 0
    trees: int | None = None


def _words_of(b: bytes) -> np.ndarray:
    """Bytes -> big-endian u32 words carried as int32."""
    return np.frombuffer(b, dtype=">u4").astype(np.uint32).view(np.int32)


@lru_cache(maxsize=None)
def zerohashes(max_depth: int = MAX_LEVEL) -> tuple:
    """zerohashes[d]: root of a depth-d tree of zero chunks, as bytes."""
    z = [b"\x00" * 32]
    for _ in range(max_depth):
        z.append(hashlib.sha256(z[-1] + z[-1]).digest())
    return tuple(z)


def zerohash_words(max_depth: int) -> np.ndarray:
    """int32[max_depth+1, 8]: zerohashes[d] as big-endian words."""
    return np.stack([_words_of(z) for z in zerohashes(max_depth)])


@lru_cache(maxsize=16)
def _zerohash_table(device: str) -> torch.Tensor:
    """zerohashes[0..MAX_LEVEL] on ``device``, uploaded once."""
    return torch.from_numpy(zerohash_words(MAX_LEVEL)).to(device)


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


def pad_pow2(leaves: torch.Tensor, depth: int) -> torch.Tensor:
    pad = (1 << depth) - leaves.shape[0]
    if pad:
        leaves = torch.cat([leaves, leaves.new_zeros((pad, 8))])
    return leaves


def fold_many(roots, depths, limits, zh, sha=sha256_pairs) -> list:
    """Chain each subtree root ``roots[i]`` (of depth ``depths[i]``) up to
    its SSZ limit depth ``limits[i]``, the right sibling at level d being
    zerohashes[d]. The chains advance together: one hash call per level
    for all chains still below their limit."""
    roots = list(roots)
    steps = max((lim - d for d, lim in zip(depths, limits)), default=0)
    for s in range(steps):
        live = [i for i, (d, lim) in enumerate(zip(depths, limits)) if d + s < lim]
        out = hash_rows(torch.stack([roots[i] for i in live]),
                        torch.stack([zh[depths[i] + s] for i in live]), sha)
        for j, i in enumerate(live):
            roots[i] = out[j]
    return roots


def mix_length(roots, len_chunk, sha=sha256_pairs):
    """H(root, length chunk) for each row of int32[B, 8] roots, one call;
    ``len_chunk`` int32[8], or int32[B, 8] a length a row."""
    return hash_rows(roots, len_chunk.expand(roots.shape[0], 8), sha)


def tree_real_hashes(depth: int) -> int:
    """Pair hashes of one ``tree_root`` at ``depth``: the exact tree."""
    return (1 << depth) - 1


def live_nodes(chunks: int, level: int) -> int:
    """Nodes of ``level`` that hold a live chunk of a tree over ``chunks``
    (one at least: an empty tree's zero chunk). The nodes past them are
    zerohashes[level], which K2 never hashes."""
    return 1 if chunks == 0 else ((chunks - 1) >> level) + 1


def live_hashes(chunks: int, depth: int) -> int:
    """Pair hashes K2 runs for a depth-``depth`` tree over ``chunks`` live
    chunks: the live nodes of every level above the leaves."""
    return sum(live_nodes(chunks, level) for level in range(1, depth + 1))


class ClimbPlan(NamedTuple):
    """How K2 cuts one tree: ``rounds`` of (first level, levels), the first
    the leaf blocks' and each next one a group's last block's; the leaf
    blocks launched; the scratch nodes and counters the climb uses."""

    rounds: tuple
    blocks: int
    nodes: int
    counters: int


def climb_plan(chunks: int, depth: int, group_log: int = GROUP_LOG) -> ClimbPlan:
    """K2's cut of a depth-``depth`` tree over ``chunks`` live chunks into
    groups of 2^group_log nodes (``csrc/merkle.cu``'s loop, step for step)."""
    rounds, level = [], 0
    while True:
        lv = min(group_log, depth - level)
        rounds.append((level, lv))
        level += lv
        if level >= depth:
            break
    climb = rounds[1:]
    return ClimbPlan(tuple(rounds), live_nodes(chunks, rounds[0][1]),
                     sum(live_nodes(chunks, lvl) for lvl, _ in climb),
                     sum(live_nodes(chunks, lvl + lv) for lvl, lv in climb))


def chunk_count(t: ListTree) -> int:
    """Chunks of a list's leaves: n words, or its packed bytes over 32."""
    ib = ITEM_BYTES[t.src.dtype]
    return t.n if ib == 0 else -(-t.n * ib // 32)


def tree_depth(t: ListTree) -> int:
    """The subtree depth of a list: its own, or the fewest levels that hold
    its chunks."""
    return max(chunk_count(t) - 1, 0).bit_length() if t.depth is None else t.depth


def tree_count(t: ListTree) -> int:
    """Roots of a ``ListTree``: 1, or its batch of like lists."""
    return 1 if t.trees is None else t.trees


def _singles(t: ListTree) -> list:
    """A batched ``ListTree`` as its lists, one ``ListTree`` each."""
    return [t] if t.trees is None else [t._replace(src=t.src[b], trees=None)
                                        for b in range(t.trees)]


def _check_list(t: ListTree) -> None:
    src = t.src
    if t.trees is not None:
        if t.trees < 1 or src.dim() < 2 or src.shape[0] != t.trees:
            raise ValueError(f"{t.trees} like lists need a source of [{t.trees}, ...], "
                             f"got {tuple(src.shape)}")
        src = src[0]
    if src.dtype not in ITEM_BYTES:
        raise ValueError(f"expected int32 chunk words, int64 or uint8 items, got {src.dtype}")
    if src.dtype == torch.int32:
        if src.dim() != 2 or src.shape[1] != 8:
            raise ValueError(f"expected int32[n, 8] chunk words, got {tuple(src.shape)}")
    elif src.dim() != 1:
        raise ValueError(f"expected a column of {src.dtype} items, got {tuple(src.shape)}")
    elif t.base:
        raise ValueError("packed items are leaves of level 0")
    d = tree_depth(t)
    if not 0 <= t.n <= src.shape[0]:
        raise ValueError(f"{t.n} items do not fit a source of {src.shape[0]}")
    if chunk_count(t) > 1 << d:
        raise ValueError(f"{chunk_count(t)} chunks do not fit a depth-{d} tree")
    if not (0 <= t.base and t.base + d <= t.limit <= MAX_LEVEL):
        raise ValueError(f"limit {t.limit} is not between {t.base + d} and {MAX_LEVEL}")
    if t.mix is not None and not 0 <= t.mix < 1 << 64:
        raise ValueError(f"the length {t.mix} is not a u64")


def leaf_level(t: ListTree) -> torch.Tensor:
    """The 2^depth leaf chunks of a list, int32[2^depth, 8]: its chunk
    words, or its items packed, then zero chunks (zerohashes[base] for
    chunk words of a higher level)."""
    d, src = tree_depth(t), t.src
    ib = ITEM_BYTES[src.dtype]
    if ib == 0:
        rows = src[:t.n]
        fill = torch.from_numpy(zerohash_words(t.base)[t.base]).to(src.device)
        return torch.cat([rows, fill.expand((1 << d) - t.n, 8)])
    per = 32 // ib  # items a chunk
    vals = src[:t.n]
    if t.n % per:
        vals = torch.cat([vals, vals.new_zeros(per - t.n % per)])
    packed = packed_u64_leaves if ib == 8 else packed_u8_leaves
    return pad_pow2(packed(vals, vals.shape[0]), d)


def _rows(trees, out: torch.Tensor | None, rows) -> list:
    """The row of every root: root b of list i at ``rows[i] + b`` of ``out``,
    or one after another from row 0 without ``out``."""
    counts = [tree_count(t) for t in trees]
    if out is None:
        rows = np.cumsum([0] + counts[:-1]).tolist()
    elif rows is None or len(rows) != len(trees):
        raise ValueError("out needs a row a list")
    elif out.dim() != 2 or out.shape[1] != 8 or not all(
            0 <= r and r + c <= out.shape[0] for r, c in zip(rows, counts)):
        raise ValueError(f"rows {list(rows)} of {counts} roots do not fit out {tuple(out.shape)}")
    return [int(r) for r in rows]


def _place(roots: torch.Tensor, out, first: list, trees) -> torch.Tensor:
    if out is None:
        return roots
    rows = [r + b for r, t in zip(first, trees) for b in range(tree_count(t))]
    out[torch.as_tensor(rows, dtype=torch.int64, device=out.device)] = roots
    return out


def list_roots_ref(trees, out: torch.Tensor | None = None, rows=None, sha=sha256_pairs_ref,
                   tree=None) -> torch.Tensor:
    """Plain torch version of K2: each list's padded leaf level reduced by
    ``tree`` (``tree_root_ref``), the roots folded together a level a call
    (``fold_many``) and length-mixed (``mix_length``), over ``sha``.
    Returns int32[R, 8], R the lists' roots (a batched list's B roots one
    after another), or writes root b of list i into ``out[rows[i] + b]``
    and returns ``out``."""
    tree = tree or (lambda leaves, depth: tree_root_ref(leaves, depth, sha))
    if not trees:
        raise ValueError("no lists")
    for t in trees:
        _check_list(t)
    first = _rows(trees, out, rows)
    singles = [s for t in trees for s in _singles(t)]
    dev = trees[0].src.device
    zh = torch.from_numpy(zerohash_words(MAX_LEVEL)).to(dev)
    depths = [tree_depth(t) for t in singles]
    roots = [tree(leaf_level(t), d) for t, d in zip(singles, depths)]
    roots = fold_many(roots, [t.base + d for t, d in zip(singles, depths)],
                      [t.limit for t in singles], zh, sha)
    mixed = [i for i, t in enumerate(singles) if t.mix is not None]
    if mixed:
        lengths = torch.from_numpy(np.stack([
            _words_of(int(singles[i].mix).to_bytes(8, "little") + bytes(24))
            for i in mixed])).to(dev)
        done = mix_length(torch.stack([roots[i] for i in mixed]), lengths, sha)
        for j, i in enumerate(mixed):
            roots[i] = done[j]
    return _place(torch.stack(roots), out, first, trees)


def _check_leaves(leaves: torch.Tensor, depth: int, batched: bool = False) -> None:
    want = ((leaves.shape[0],) if batched and leaves.dim() == 3 else ()) + (1 << depth, 8)
    if leaves.dim() != 2 + batched or tuple(leaves.shape) != want:
        shape = ("[B, " if batched else "[") + f"{1 << depth}, 8]"
        raise ValueError(f"expected {shape} leaves, got {tuple(leaves.shape)}")


def tree_root_ref(leaves: torch.Tensor, depth: int, sha=sha256_pairs_ref) -> torch.Tensor:
    """Plain torch version of K2 on one full tree: level by level with the
    plain SHA."""
    _check_leaves(leaves, depth)
    return many_tree_root_ref(leaves[None], depth, sha)[0]


def many_tree_root_ref(leaves: torch.Tensor, depth: int, sha=sha256_pairs_ref) -> torch.Tensor:
    """Plain torch version of K2's batched entry: every tree level by level
    with the plain SHA (a level's pairs never straddle two trees)."""
    _check_leaves(leaves, depth, batched=True)
    buf = leaves
    for _ in range(depth):
        buf = sha(buf.reshape(-1, 16))
    return buf.reshape(leaves.shape[0], 8)


class _Scratch:
    """K2's scratch on one stream of one card: the climb's nodes and its
    group counters. The counters are zero between launches (each launch's
    finishers reset what they completed), so they are zeroed only when they
    are made. The launches of one stream run one after another; launches on
    two streams would overlap, so each stream has a scratch of its own."""

    def __init__(self):
        self.nodes = None
        self.counters = None

    def get(self, nodes: int, counters: int, dev: torch.device):
        if self.nodes is None or self.nodes.shape[0] < nodes:
            self.nodes = torch.empty((max(nodes, 1 << 12), 8), dtype=torch.int32, device=dev)
        if self.counters is None or self.counters.shape[0] < counters:
            self.counters = torch.zeros(max(counters, 1 << 10), dtype=torch.int32, device=dev)
        return self.nodes, self.counters


_scratch: dict[tuple, _Scratch] = {}  # by (device, stream)


def launch_table(entries: list, group_log: int = GROUP_LOG) -> tuple:
    """K2's table of ``entries``: (source address, item bytes, n, depth,
    base, limit, mix or None, trees, source stride in bytes, root address,
    root stride in words). Returns the table (``LIST_TREE_DTYPE``), the
    grid's leaf blocks and the scratch nodes and counters the launch uses."""
    if not 1 <= len(entries) <= MAX_TREES:
        raise ValueError(f"one launch takes 1 to {MAX_TREES} lists, got {len(entries)}")
    table = np.zeros(len(entries), LIST_TREE_DTYPE)
    block0 = nodes0 = cnt0 = 0
    for e, (src, ib, n, depth, base, limit, mix, trees, stride, out, out_stride) in zip(
            table, entries):
        plan = climb_plan(n if ib == 0 else -(-n * ib // 32), depth, group_log)
        e["src"], e["out"], e["n"], e["item_bytes"] = src, out, n, ib
        e["mix_len"], e["mix"] = (0, 0) if mix is None else (int(mix), 1)
        e["block0"], e["blocks"], e["trees"] = block0, plan.blocks, trees
        e["src_stride"], e["out_stride"] = stride, out_stride
        e["nodes0"], e["nodes_stride"], e["cnt0"], e["cnt_stride"] = (nodes0, plan.nodes, cnt0,
                                                                      plan.counters)
        e["depth"], e["base"], e["limit"] = depth, base, limit
        block0 += trees * plan.blocks
        nodes0 += trees * plan.nodes
        cnt0 += trees * plan.counters
    return table, block0, nodes0, cnt0


def _launch(entries: list, dev: torch.device, counter: str) -> None:
    """One K2 launch over ``entries`` as ``launch_table`` takes them, with
    the source tensors in place of their addresses."""
    for src, *_, stride, _out, _ in entries:
        _ext.check_cuda(src, src.dtype)
        if src.data_ptr() % 16 or stride % 16:
            raise ValueError("K2 reads its sources 16 bytes at a time: align them to 16 bytes")
    table, blocks, nodes, counters = launch_table([(src.data_ptr(), *rest)
                                                   for src, *rest in entries])
    key = (str(dev), torch.cuda.current_stream(dev).cuda_stream)
    scratch, cnt = _scratch.setdefault(key, _Scratch()).get(nodes, counters, dev)
    _ext.launch("merkle", "merkle_lists_launch", dev, ctypes.c_void_p(table.ctypes.data),
                len(entries), _ext.ptr(_zerohash_table(str(dev))), _ext.ptr(scratch),
                _ext.ptr(cnt), blocks, counter=counter)


def list_roots(trees, out: torch.Tensor | None = None, rows=None) -> torch.Tensor:
    """The roots of up to ``MAX_TREES`` table entries (``ListTree``: a list,
    or a batch of like lists), int32[R, 8], a batch's roots one after
    another; with ``out`` (int32[M, 8]) root b of entry i is written into
    ``out[rows[i] + b]`` and ``out`` is returned.

    CUDA tensors go through kernel K2, one launch for all the lists (counted
    as ``merkle_lists``); CPU tensors through the plain version."""
    if not trees:
        raise ValueError("no lists")
    if trees[0].src.device.type == "cpu":
        return list_roots_ref(trees, out, rows)
    for t in trees:
        _check_list(t)
    dev = trees[0].src.device
    first = _rows(trees, out, rows)
    if out is None:
        out = torch.empty((first[-1] + tree_count(trees[-1]), 8), dtype=torch.int32, device=dev)
    _ext.check_cuda(out, torch.int32)
    _launch([(t.src, ITEM_BYTES[t.src.dtype], t.n, tree_depth(t), t.base, t.limit, t.mix,
              tree_count(t), 0 if t.trees is None else t.src.stride(0) * t.src.element_size(),
              out.data_ptr() + 32 * r, 8) for t, r in zip(trees, first)], dev, "merkle_lists")
    return out


def tree_root(leaves: torch.Tensor, depth: int) -> torch.Tensor:
    """Root of int32[2^depth, 8] leaf chunks -> int32[8].

    CUDA tensors go through kernel K2, one launch; CPU tensors through the
    plain version."""
    if leaves.device.type == "cpu":
        return tree_root_ref(leaves, depth)
    _check_leaves(leaves, depth)
    out = torch.empty(8, dtype=torch.int32, device=leaves.device)
    _launch([(leaves, 0, 1 << depth, depth, 0, depth, None, 1, 0, out.data_ptr(), 0)],
            leaves.device, "merkle")
    return out


def many_tree_root(leaves: torch.Tensor, depth: int) -> torch.Tensor:
    """Roots of B trees of one depth, int32[B, 2^depth, 8] -> int32[B, 8];
    depth 0 gives each tree's one leaf.

    CUDA tensors go through K2, one launch for all trees (one table entry of
    B like trees); CPU tensors through the plain version."""
    if leaves.device.type == "cpu":
        return many_tree_root_ref(leaves, depth)
    _check_leaves(leaves, depth, batched=True)
    b = leaves.shape[0]
    if b > 0x7FFFFFFF:
        raise ValueError(f"{b} trees do not fit one launch")
    out = torch.empty((b, 8), dtype=torch.int32, device=leaves.device)
    _launch([(leaves, 0, 1 << depth, depth, 0, depth, None, b, 32 << depth, out.data_ptr(), 8)],
            leaves.device, "merkle_many")
    return out


def _be_words(raw: torch.Tensor) -> torch.Tensor:
    """uint8[N, 32] chunks -> int32[N, 8] big-endian words: each word's four
    bytes reversed, then read as the (little-endian) int32 carrier."""
    n = raw.shape[0]
    return raw.reshape(n, 8, 4).flip(-1).contiguous().view(torch.int32).reshape(n, 8)


def _be_bytes(chunks: np.ndarray) -> np.ndarray:
    """Host chunks (uint8[N, 32], or pre-packed uint32[N, 8] words) as
    uint8[N, 32] bytes."""
    a = np.ascontiguousarray(chunks)
    if a.dtype == np.uint32:
        a = a.astype(">u4").view(np.uint8)
    elif a.dtype != np.uint8:
        raise ValueError(f"expected uint8 chunks or uint32 words, got {a.dtype}")
    return a.reshape(-1, 32)


def chunks_to_words(chunks, cap: int) -> torch.Tensor:
    """uint8[N, 32] chunks, or pre-packed big-endian words [N, 8] (uint32
    numpy or the int32 carrier), numpy or a tensor -> int32[cap, 8]
    big-endian words, zero-padded; on the tensor's device (the CPU for
    numpy input)."""
    if isinstance(chunks, np.ndarray):
        chunks = torch.from_numpy(np.array(_be_bytes(chunks)))
    n = chunks.shape[0]
    if n > cap:
        raise ValueError(f"{n} chunks do not fit {cap} leaves")
    if chunks.dtype == torch.uint8:
        words = _be_words(chunks)
    elif chunks.dtype == torch.int32:
        words = chunks.reshape(n, 8)
    else:
        raise ValueError(f"expected uint8 chunks or 32-bit words, got {chunks.dtype}")
    return torch.cat([words, words.new_zeros((cap - n, 8))])


def _root_bytes(words: torch.Tensor) -> list[bytes]:
    rows = words.cpu().numpy().view(np.uint32).astype(">u4")
    return [r.tobytes() for r in rows]


def _flush_words(trees: list, cap: int, batch: int, dev) -> torch.Tensor:
    """The zero-padded leaf levels of host ``trees`` as int32[batch, cap, 8]
    on ``dev``. The trees travel as one copy of their chunks, without the
    padding; the rows land in place with one scatter."""
    counts = [int(t.shape[0]) for t in trees]
    if max(counts, default=0) > cap:
        raise ValueError(f"a tree of {max(counts)} chunks does not fit {cap} leaves")
    words = torch.zeros((batch * cap, 8), dtype=torch.int32, device=dev)
    total = sum(counts)
    if total:
        packed = _be_words(torch.from_numpy(np.concatenate([_be_bytes(t) for t in trees])).to(dev))
        n_t = torch.tensor(counts, dtype=torch.int64).to(dev)
        starts = torch.arange(len(trees), dtype=torch.int64, device=dev) * cap
        shift = torch.repeat_interleave(starts - (torch.cumsum(n_t, 0) - n_t), n_t, output_size=total)
        words[shift + torch.arange(total, device=dev)] = packed
    return words.reshape(batch, cap, 8)


def merkleize_many_device(trees: list, depth: int, pad_batch: int | None = None,
                          device=None) -> list[bytes]:
    """Roots of many independent subtrees of one depth, in one batched
    reduction. Each tree is uint8[N_i, 32] chunks or pre-packed uint32[N_i, 8]
    words on the host (N_i <= 2^depth); the batch is padded with
    all-zero trees up to ``pad_batch``. Returns one 32-byte root per tree,
    each equal to ``merkleize_subtree_device`` of the tree."""
    dev = default_device(device)
    b, cap = len(trees), 1 << depth
    batch = pad_batch or b
    if b > batch:
        raise ValueError(f"{b} trees do not fit a batch of {pad_batch}")
    if batch == 0:
        return []
    return _root_bytes(many_tree_root(_flush_words(trees, cap, batch, dev), depth)[:b])


def merkleize_subtree_device(chunks, depth: int, device=None) -> bytes:
    """Root of one depth-``depth`` subtree over uint8[N, 32] chunks (or
    pre-packed words), N <= 2^depth, zero-padded."""
    leaves = _flush_words([chunks], 1 << depth, 1, default_device(device))[0]
    return _root_bytes(tree_root(leaves, depth)[None])[0]
