"""Swap-or-not shuffle in whole-permutation form (kernels K7 and K8).

Counterpart of ``eth_consensus_specs_tpu/ops/shuffle.py``. The spec
defines the shuffle per index (``compute_shuffled_index``, 90 hash-driven
rounds on mainnet); in whole-permutation form each round maps every lane at
once:

    flip = (pivot - idx) mod n
    pos  = max(idx, flip)
    idx  = flip where bit(pos) else idx

with the decision bit read from one 32-byte hash per 256 positions, the
hash of (seed, round byte, little-endian u32 chunk).

* ``shuffle_permutation`` and ``shuffle_list`` are the host form in numpy,
  the port's own copy of the JAX package's.
* ``shuffle_permutation_device`` is the card's: the pivots are hashed on
  the host (``rounds`` small hashes), the rounds x chunks decision blocks
  are built with tensor ops on the device (``single_block_words``), hashed
  by K7 (``sha256_single_block``), and K8 (``shuffle_rounds``,
  ``csrc/shuffle.cu``) runs every round over the whole array in one
  launch: the rounds in reverse, each step X'[j] = X[g_r(j)] from the
  identity, where g_r is one round of one lane. g_r swaps the pairs
  (j, flip) whose decision bit is set, so a step swaps in place, and its
  reads of X and of the bits are runs of consecutive addresses; one grid
  barrier separates two steps.
"""

from __future__ import annotations

import hashlib

import numpy as np
import torch

from .. import _ext
from ..device import default_device
from ..lanes import to_i32
from .sha256 import sha256_single_block

MAX_ROUNDS = 256  # the round is one byte of the hashed message
BLOCK_BITS = 37 * 8  # seed (32 B), round (1 B), chunk (4 B)


def shuffle_permutation(index_count: int, seed: bytes, rounds: int) -> np.ndarray:
    """perm[i] == compute_shuffled_index(i, index_count, seed) for all i, as
    int64 on the host."""
    if index_count == 0:
        return np.empty(0, dtype=np.int64)
    n = index_count
    idx = np.arange(n, dtype=np.int64)
    num_chunks = (n + 255) // 256
    sha = hashlib.sha256
    for rnd in range(rounds):
        rb = bytes([rnd])
        pivot = int.from_bytes(sha(seed + rb).digest()[:8], "little") % n
        src = np.frombuffer(
            b"".join(sha(seed + rb + c.to_bytes(4, "little")).digest() for c in range(num_chunks)),
            dtype=np.uint8,
        ).reshape(num_chunks, 32)
        flip = (pivot - idx) % n
        pos = np.maximum(idx, flip)
        bits = (src[pos // 256, (pos % 256) // 8] >> (pos % 8).astype(np.uint8)) & 1
        idx = np.where(bits == 1, flip, idx)
    return idx


def shuffle_list(items: list, seed: bytes, rounds: int) -> list:
    """The shuffled sequence itself: out[i] = items[perm[i]]."""
    perm = shuffle_permutation(len(items), seed, rounds)
    return [items[int(p)] for p in perm]


def pivots(index_count: int, seed: bytes, rounds: int) -> list[int]:
    """Each round's pivot: the first 8 bytes of H(seed, round), little-endian,
    mod ``index_count``."""
    sha = hashlib.sha256
    return [int.from_bytes(sha(seed + bytes([r])).digest()[:8], "little") % index_count
            for r in range(rounds)]


def single_block_words(seed: bytes, rounds: int, num_chunks: int, device) -> torch.Tensor:
    """The padded SHA-256 blocks of every decision message, round-major:
    int32[rounds * num_chunks, 16] big-endian words on ``device``. Message
    (r, c) is seed || r || c as 4 little-endian bytes (37 bytes), so word 8
    is r<<24 | c0<<16 | c1<<8 | c2, word 9 is c3<<24 | 0x80<<16 (the
    delimiter), and word 15 the bit length 296."""
    if len(seed) != 32:
        raise ValueError(f"expected a 32-byte seed, got {len(seed)} bytes")
    dev = torch.device(device)
    template = np.zeros(16, np.uint32)
    template[:8] = np.frombuffer(seed, ">u4")
    template[15] = BLOCK_BITS
    words = torch.from_numpy(template.view(np.int32)).to(dev).expand(rounds * num_chunks, 16).clone()
    k = torch.arange(rounds * num_chunks, dtype=torch.int64, device=dev)
    r = k // num_chunks
    c = k - r * num_chunks
    words[:, 8] = to_i32((r << 24) | ((c & 0xFF) << 16) | (c & 0xFF00) | ((c >> 16) & 0xFF))
    words[:, 9] = to_i32((c & 0xFF000000) | (0x80 << 16))
    return words


def shuffle_rounds_ref(digests: torch.Tensor, pivots: torch.Tensor, n: int) -> torch.Tensor:
    """Plain torch version of K8, the JAX kernel's loop body round by round:
    int32[rounds * chunks, 8] digests and int32[rounds] pivots -> int32[n]."""
    rounds = pivots.shape[0]
    table = digests.to(torch.int64).reshape(rounds, -1, 8)
    idx = torch.arange(n, dtype=torch.int64, device=digests.device)
    for r in range(rounds):
        flip = torch.remainder(pivots[r].to(torch.int64) - idx, n)
        pos = torch.maximum(idx, flip)
        byte_idx = (pos % 256) // 8
        word = table[r, pos // 256, byte_idx // 4]
        byte_val = (word >> (8 * (3 - byte_idx % 4))) & 0xFF
        bit = (byte_val >> (pos % 8)) & 1
        idx = torch.where(bit == 1, flip, idx)
    return idx.to(torch.int32)


def _check_rounds_args(digests: torch.Tensor, pivots: torch.Tensor, n: int) -> None:
    rounds = pivots.shape[0] if pivots.dim() == 1 else -1
    if n < 1 or not 0 <= rounds <= MAX_ROUNDS:
        raise ValueError(f"expected n >= 1 and int32[rounds <= {MAX_ROUNDS}] pivots")
    if tuple(digests.shape) != (rounds * ((n + 255) // 256), 8):
        raise ValueError(f"expected [{rounds} * {(n + 255) // 256}, 8] digests, "
                         f"got {tuple(digests.shape)}")


def shuffle_rounds(digests: torch.Tensor, pivots: torch.Tensor, n: int) -> torch.Tensor:
    """Every swap-or-not round over lanes 0..n-1 -> int32[n] permutation.

    CUDA tensors go through kernel K8 (one cooperative launch: the rounds in
    reverse as whole-array steps from the identity, each step the round's
    swaps of pairs (j, flip) done in place on the output, a grid barrier
    between steps); CPU tensors through the plain version."""
    _check_rounds_args(digests, pivots, n)
    if digests.device.type == "cpu":
        return shuffle_rounds_ref(digests, pivots, n)
    _ext.check_cuda(digests, torch.int32)
    _ext.check_cuda(pivots, torch.int32)
    out = torch.empty(n, dtype=torch.int32, device=digests.device)
    _ext.launch("shuffle", "shuffle_rounds_launch", digests.device, _ext.ptr(digests),
                _ext.ptr(pivots), _ext.ptr(out), n, pivots.shape[0], (n + 255) // 256)
    return out


def shuffle_permutation_device(index_count: int, seed: bytes, rounds: int, device=None):
    """Whole-permutation swap-or-not on ``device`` (the card by default):
    int32[index_count], bit-equal to ``shuffle_permutation`` and to
    ``compute_shuffled_index`` at every index."""
    dev = default_device(device)
    if index_count == 0:
        return torch.empty(0, dtype=torch.int32, device=dev)
    if not 0 <= rounds <= MAX_ROUNDS:
        raise ValueError(f"expected at most {MAX_ROUNDS} rounds, got {rounds}")
    n = index_count
    num_chunks = (n + 255) // 256
    piv = torch.tensor(pivots(n, seed, rounds), dtype=torch.int32).to(dev)
    digests = sha256_single_block(single_block_words(seed, rounds, num_chunks, dev))
    return shuffle_rounds(digests, piv, n)
