"""Binary merkle reduction of power-of-two leaf levels (kernel K2 and its
batched entry, ``csrc/merkle.cu``), and the subtree-root entry points
around them.

Counterpart of ``eth_consensus_specs_tpu/ops/merkle.py``:

* ``tree_root`` of ``tree_root_words``: int32[2^d, 8] leaf chunks ->
  int32[8] root;
* ``many_tree_root`` of ``many_tree_root_words``: int32[B, 2^d, 8] -> int32[B, 8];
* ``chunks_to_words``, ``merkleize_many_device`` and
  ``merkleize_subtree_device`` of the same names: 32-byte chunks from the
  host (or pre-packed big-endian words) to 32-byte roots, zero-padded to
  2^d leaves, which gives the SSZ root of the padded subtree.

The JAX entry points also take a device ``mesh`` that splits the tree axis;
the port's sharded form waits for its multi-card slice.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import _ext
from ..device import default_device
from .sha256 import sha256_pairs_ref

MAX_LEVELS_PER_LAUNCH = 9  # 512 nodes of 32 bytes in one block's shared memory


def tree_real_hashes(depth: int) -> int:
    """Pair hashes of one ``tree_root`` at ``depth``: the exact tree."""
    return (1 << depth) - 1


def _check_leaves(leaves: torch.Tensor, depth: int, batched: bool = False) -> None:
    want = ((leaves.shape[0],) if batched and leaves.dim() == 3 else ()) + (1 << depth, 8)
    if leaves.dim() != 2 + batched or tuple(leaves.shape) != want:
        shape = ("[B, " if batched else "[") + f"{1 << depth}, 8]"
        raise ValueError(f"expected {shape} leaves, got {tuple(leaves.shape)}")


def tree_root_ref(leaves: torch.Tensor, depth: int) -> torch.Tensor:
    """Plain torch version of K2: level by level with the plain SHA."""
    _check_leaves(leaves, depth)
    return many_tree_root_ref(leaves[None], depth)[0]


def many_tree_root_ref(leaves: torch.Tensor, depth: int) -> torch.Tensor:
    """Plain torch version of K2's batched entry: every tree level by level
    with the plain SHA (a level's pairs never straddle two trees)."""
    _check_leaves(leaves, depth, batched=True)
    buf = leaves
    for _ in range(depth):
        buf = sha256_pairs_ref(buf.reshape(-1, 16))
    return buf.reshape(leaves.shape[0], 8)


def _reduce(leaves: torch.Tensor, depth: int, counter: str) -> torch.Tensor:
    """Launch K2 on [B, 2^depth, 8] leaves until one node per tree is left,
    counting the launches under ``counter``."""
    _ext.check_cuda(leaves, torch.int32)
    trees = leaves.shape[0]
    buf, left = leaves, depth
    while left:
        levels = min(left, MAX_LEVELS_PER_LAUNCH)
        nodes = buf.shape[1]
        out = torch.empty((trees, nodes >> levels, 8), dtype=torch.int32, device=buf.device)
        _ext.launch("merkle", "merkle_reduce_launch", buf.device, _ext.ptr(buf), _ext.ptr(out),
                    trees, nodes, levels, counter=counter)
        buf, left = out, left - levels
    return buf[:, 0]


def tree_root(leaves: torch.Tensor, depth: int) -> torch.Tensor:
    """Root of int32[2^depth, 8] leaf chunks -> int32[8].

    CUDA tensors go through kernel K2, one launch per up to nine levels;
    CPU tensors through the plain version."""
    if leaves.device.type == "cpu":
        return tree_root_ref(leaves, depth)
    _check_leaves(leaves, depth)
    return _reduce(leaves[None], depth, "merkle")[0]


def many_tree_root(leaves: torch.Tensor, depth: int) -> torch.Tensor:
    """Roots of B trees of one depth, int32[B, 2^depth, 8] -> int32[B, 8];
    depth 0 gives each tree's one leaf.

    CUDA tensors go through K2's batched entry (the tree axis is the grid's
    second dimension; one launch per up to nine levels for all trees);
    CPU tensors through the plain version."""
    if leaves.device.type == "cpu":
        return many_tree_root_ref(leaves, depth)
    _check_leaves(leaves, depth, batched=True)
    return _reduce(leaves, depth, "merkle_many")


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
