"""Binary merkle reduction of a power-of-two leaf level (kernel K2,
``csrc/merkle.cu``).

Counterpart of ``eth_consensus_specs_tpu/ops/merkle.py`` ``tree_root_words``:
int32[2^d, 8] leaf chunks -> int32[8] root.
"""

from __future__ import annotations

import torch

from .. import _ext
from .sha256 import sha256_pairs_ref

MAX_LEVELS_PER_LAUNCH = 9  # 512 nodes of 32 bytes in one block's shared memory


def tree_real_hashes(depth: int) -> int:
    """Pair hashes of one ``tree_root`` at ``depth``: the exact tree."""
    return (1 << depth) - 1


def _check_leaves(leaves: torch.Tensor, depth: int) -> None:
    if leaves.dim() != 2 or leaves.shape != (1 << depth, 8):
        raise ValueError(f"expected [{1 << depth}, 8] leaves, got {tuple(leaves.shape)}")


def tree_root_ref(leaves: torch.Tensor, depth: int) -> torch.Tensor:
    """Plain torch version of K2: level by level with the plain SHA."""
    _check_leaves(leaves, depth)
    buf = leaves
    for _ in range(depth):
        buf = sha256_pairs_ref(buf.reshape(-1, 16))
    return buf[0]


def tree_root(leaves: torch.Tensor, depth: int) -> torch.Tensor:
    """Root of int32[2^depth, 8] leaf chunks -> int32[8].

    CUDA tensors go through kernel K2, one launch per up to nine levels;
    CPU tensors through the plain version."""
    if leaves.device.type == "cpu":
        return tree_root_ref(leaves, depth)
    _check_leaves(leaves, depth)
    _ext.check_cuda(leaves, torch.int32)
    buf, left = leaves, depth
    while left:
        levels = min(left, MAX_LEVELS_PER_LAUNCH)
        out = torch.empty((buf.shape[0] >> levels, 8), dtype=torch.int32, device=buf.device)
        _ext.launch("merkle", "merkle_reduce_launch", buf.device,
                    _ext.ptr(buf), _ext.ptr(out), buf.shape[0], levels)
        buf, left = out, left - levels
    return buf[0]
