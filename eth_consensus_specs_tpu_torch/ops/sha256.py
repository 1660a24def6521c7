"""SHA-256 of N independent messages (kernels K1 and K7, ``csrc/sha256.cu``).

Counterparts of ``eth_consensus_specs_tpu/ops/sha256.py``:

* ``sha256_pairs`` (K1) of ``sha256_pair_words``: int32[N, 16] big-endian
  words of 64-byte messages -> int32[N, 8] digest words, each a data-block
  compression plus the constant padding block's;
* ``sha256_single_block`` (K7) of ``sha256_single_block``: int32[N, 16]
  blocks the caller has already padded (messages of at most 55 bytes) ->
  int32[N, 8], one compression each.
"""

from __future__ import annotations

import torch

from .. import _ext
from ..lanes import MASK32, rotr32, to_i32, to_u32_lanes

K = (
    0x428A2F98, 0x71374491, 0xB5C0FBCF, 0xE9B5DBA5, 0x3956C25B, 0x59F111F1,
    0x923F82A4, 0xAB1C5ED5, 0xD807AA98, 0x12835B01, 0x243185BE, 0x550C7DC3,
    0x72BE5D74, 0x80DEB1FE, 0x9BDC06A7, 0xC19BF174, 0xE49B69C1, 0xEFBE4786,
    0x0FC19DC6, 0x240CA1CC, 0x2DE92C6F, 0x4A7484AA, 0x5CB0A9DC, 0x76F988DA,
    0x983E5152, 0xA831C66D, 0xB00327C8, 0xBF597FC7, 0xC6E00BF3, 0xD5A79147,
    0x06CA6351, 0x14292967, 0x27B70A85, 0x2E1B2138, 0x4D2C6DFC, 0x53380D13,
    0x650A7354, 0x766A0ABB, 0x81C2C92E, 0x92722C85, 0xA2BFE8A1, 0xA81A664B,
    0xC24B8B70, 0xC76C51A3, 0xD192E819, 0xD6990624, 0xF40E3585, 0x106AA070,
    0x19A4C116, 0x1E376C08, 0x2748774C, 0x34B0BCB5, 0x391C0CB3, 0x4ED8AA4A,
    0x5B9CCA4F, 0x682E6FF3, 0x748F82EE, 0x78A5636F, 0x84C87814, 0x8CC70208,
    0x90BEFFFA, 0xA4506CEB, 0xBEF9A3F7, 0xC67178F2,
)
IV = (
    0x6A09E667, 0xBB67AE85, 0x3C6EF372, 0xA54FF53A,
    0x510E527F, 0x9B05688C, 0x1F83D9AB, 0x5BE0CD19,
)
# message words of the constant second block of a 64-byte message:
# 0x80 delimiter, zeros, bit length 512 in the last word
PAD_BLOCK = (0x80000000,) + (0,) * 14 + (512,)


# K[t] + W[t] of the constant padding block, its schedule run ahead of time
def _pad_schedule() -> tuple:
    w = list(PAD_BLOCK)
    for t in range(16, 64):
        x, y = w[t - 15], w[t - 2]
        s0 = rotr32(x, 7) ^ rotr32(x, 18) ^ (x >> 3)
        s1 = rotr32(y, 17) ^ rotr32(y, 19) ^ (y >> 10)
        w.append((w[t - 16] + s0 + w[t - 7] + s1) & MASK32)
    return tuple((k + x) & MASK32 for k, x in zip(K, w))


KW_PAD = _pad_schedule()


def _rot3(x: torch.Tensor, r1: int, r2: int, r3: int) -> torch.Tensor:
    """rotr(x, r1) ^ rotr(x, r2) ^ rotr(x, r3) for u32 values in int64
    lanes: with x doubled into both halves of the lane, a right shift is
    a rotation of the low 32 bits (sign fill never reaches them)."""
    xx = x | (x << 32)
    return ((xx >> r1) ^ (xx >> r2) ^ (xx >> r3)) & MASK32


def _compress_ref(state: list, w: list | None) -> list:
    """One compression over int64 lanes holding u32 values; ``w=None``
    compresses the constant padding block."""
    if w is not None:
        ws = list(w)
        for t in range(16, 64):
            x, y = ws[t - 15], ws[t - 2]
            xx, yy = x | (x << 32), y | (y << 32)
            s0 = ((xx >> 7) ^ (xx >> 18)) & MASK32 ^ (x >> 3)
            s1 = ((yy >> 17) ^ (yy >> 19)) & MASK32 ^ (y >> 10)
            ws.append((ws[t - 16] + s0 + ws[t - 7] + s1) & MASK32)
    a, b, c, d, e, f, g, h = state
    for t in range(64):
        kw = KW_PAD[t] if w is None else ws[t] + K[t]
        ch = (e & f) ^ (~e & g)
        t1 = h + _rot3(e, 6, 11, 25) + ch + kw
        maj = (a & b) ^ (a & c) ^ (b & c)
        h, g, f, e, d, c, b, a = (
            g, f, e, (d + t1) & MASK32, c, b, a, (t1 + _rot3(a, 2, 13, 22) + maj) & MASK32
        )
    return [(s + o) & MASK32 for s, o in zip(state, [a, b, c, d, e, f, g, h])]


def sha256_pairs_ref(words: torch.Tensor) -> torch.Tensor:
    """Plain torch version of K1: int32[N, 16] -> int32[N, 8]."""
    lanes = to_u32_lanes(words)
    n = lanes.shape[0]
    state = [torch.full((n,), v, dtype=torch.int64, device=words.device) for v in IV]
    state = _compress_ref(state, [lanes[:, i] for i in range(16)])
    state = _compress_ref(state, None)
    return to_i32(torch.stack(state, dim=-1))


def sha256_single_block_ref(words: torch.Tensor) -> torch.Tensor:
    """Plain torch version of K7: int32[N, 16] padded blocks -> int32[N, 8]."""
    lanes = to_u32_lanes(words)
    n = lanes.shape[0]
    state = [torch.full((n,), v, dtype=torch.int64, device=words.device) for v in IV]
    return to_i32(torch.stack(_compress_ref(state, [lanes[:, i] for i in range(16)]), dim=-1))


def _launch_rows(fn: str, counter: str, words: torch.Tensor) -> torch.Tensor:
    _ext.check_cuda(words, torch.int32)
    if words.dim() != 2 or words.shape[1] != 16:
        raise ValueError(f"expected [N, 16] words, got {tuple(words.shape)}")
    out = torch.empty((words.shape[0], 8), dtype=torch.int32, device=words.device)
    _ext.launch("sha256", fn, words.device, _ext.ptr(words), _ext.ptr(out), words.shape[0],
                counter=counter)
    return out


def sha256_pairs(words: torch.Tensor) -> torch.Tensor:
    """SHA-256 of each row of int32[N, 16] big-endian words -> int32[N, 8].

    CUDA tensors go through kernel K1; CPU tensors through the plain
    version."""
    if words.device.type == "cpu":
        return sha256_pairs_ref(words)
    return _launch_rows("sha256_pairs_launch", "sha256", words)


def sha256_single_block(words: torch.Tensor) -> torch.Tensor:
    """One compression from the initial hash value of each row of
    int32[N, 16] big-endian words, already padded by the caller ->
    int32[N, 8]: the SHA-256 digest of a message of at most 55 bytes.

    CUDA tensors go through kernel K7; CPU tensors through the plain
    version."""
    if words.device.type == "cpu":
        return sha256_single_block_ref(words)
    return _launch_rows("sha256_single_block_launch", "sha256_single_block", words)


def hash_rows(a: torch.Tensor, b: torch.Tensor, sha=sha256_pairs) -> torch.Tensor:
    """H(a || b) rowwise for int32[..., 8] word chunks."""
    return sha(torch.cat([a, b], dim=-1).reshape(-1, 16)).reshape(a.shape)
