"""Batched FFTs over the BLS scalar field Fr on the card (kernel K16).

Counterpart of ``eth_consensus_specs_tpu/ops/fr_fft.py``: ``fft_rows``
replaces ``fft_stages`` (:61) as ``_compiled_fft`` (:101) runs it, with the
inverse's final n^-1 scaling (:205-207) folded into the last stage: a
radix-2 DIT over every row of a ``[B, n]`` batch, on input in the DIT's
order (the bit reversal of natural order), stage m taking twiddles
w_m[k] = roots[k * n / (2m)]. ``batch_fft_words`` is ``batch_fft_mont``
(:160) on the card's words (natural order in and out: the wrapper has the
kernel gather by bit reversal), ``batch_fft_field`` (:184) and
``fft_field_device`` (:215) are the host-int entry points, bit-exact with
the host ``crypto.das.fft_field`` applied row by row.

Values cross to the card canonical, as ``int32[..., 8]`` little-endian u32
words, and stay canonical there: the twiddles and n^-1 are uploaded once
per root table in the card's Montgomery form x * 2^256 mod r (the JAX
package's ``_device_twiddles`` :80), so a Montgomery product of a value and
a twiddle is the canonical product and no value is converted to or from
Montgomery form. The plain version (``fft_rows_ref``, on ``ops/limb_field``)
takes the same tensors.

Differences from the JAX module: the input is read, not donated (the kernel
writes a separate output); a caller whose rows are already in the DIT's
order passes ``bitrev=False`` and no permutation runs at all (the KZG flush,
whose blobs are stored in bit-reversed order: ``ops/kzg_batch``). Not
ported yet: the ``mesh=`` path (``_sharded_fft`` :126) and ``pad_batch``
(the serve layer's compile buckets).
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from .. import _ext
from ..device import default_device
from . import limb_field as lf

BLS_MODULUS = lf.R_MOD
N_WORDS = lf.N_WORDS
CHUNK_LOG = 12  # csrc/fr_fft.cu's kChunkLog: rows of up to 4,096 run in shared memory


@lru_cache(maxsize=None)
def _bit_reversal_indices(n: int) -> np.ndarray:
    bits = n.bit_length() - 1
    idx = np.arange(n, dtype=np.int64)
    out = np.zeros(n, np.int64)
    for b in range(bits):
        out |= ((idx >> b) & 1) << (bits - 1 - b)
    return out.astype(np.int32)


@lru_cache(maxsize=8)
def _stage_twiddles(roots: tuple, n: int) -> tuple:
    """Canonical twiddles per DIT stage: stage with half-size m uses
    w[k] = roots[k * (n // (2m))] for k in range(m)."""
    tables = []
    m = 1
    while m < n:
        stride = n // (2 * m)
        tables.append(tuple(roots[k * stride] % BLS_MODULUS for k in range(m)))
        m *= 2
    return tuple(tables)


def twiddle_words(roots: tuple, n: int) -> np.ndarray:
    """The kernel's twiddle table: int32[n - 1, 8] words of the card's
    Montgomery form, stage m at rows m - 1 .. 2m - 2."""
    flat = [w for table in _stage_twiddles(roots, n) for w in table]
    if not flat:
        return np.zeros((0, N_WORDS), np.int32)
    return lf.ints_to_card_words(flat)


@lru_cache(maxsize=16)
def _device_twiddles(roots: tuple, n: int, device: str) -> torch.Tensor:
    """The twiddle table on ``device``, uploaded once per (roots, n)."""
    return torch.from_numpy(twiddle_words(roots, n)).to(device)


@lru_cache(maxsize=16)
def _device_scale(n: int, device: str) -> torch.Tensor:
    """n^-1 in the card's Montgomery form, on ``device``."""
    return torch.from_numpy(lf.ints_to_card_words([pow(n, -1, BLS_MODULUS)])[0]).to(device)


def _log2(n: int) -> int:
    if n < 1 or n & (n - 1):
        raise ValueError(f"the FFT size must be a power of two, got {n}")
    return n.bit_length() - 1


def _check_fft_args(vals, tw, scale) -> int:
    if vals.dim() != 3 or vals.shape[-1] != N_WORDS or vals.shape[0] < 1:
        raise ValueError(f"expected int32[B, n, {N_WORDS}] values, got {tuple(vals.shape)}")
    n = vals.shape[1]
    log_n = _log2(n)
    if tuple(tw.shape) != (n - 1, N_WORDS):
        raise ValueError(f"expected int32[{n - 1}, {N_WORDS}] twiddles, got {tuple(tw.shape)}")
    if scale is not None and tuple(scale.shape) != (N_WORDS,):
        raise ValueError(f"expected an int32[{N_WORDS}] scale, got {tuple(scale.shape)}")
    return log_n


def fft_rows_ref(vals: torch.Tensor, tw: torch.Tensor, scale: torch.Tensor | None = None,
                 bitrev: bool = True) -> torch.Tensor:
    """Plain torch version of K16: the same arguments, the same canonical
    words out."""
    log_n = _check_fft_args(vals, tw, scale)
    n = vals.shape[1]
    x = lf.from_words(vals)
    if bitrev:
        x = x[:, torch.from_numpy(_bit_reversal_indices(n)).long().to(vals.device)]
    w_all = lf.from_card_words(tw)  # this module's Montgomery form
    b = x.shape[0]
    for ls in range(log_n):
        m = 1 << ls
        shaped = x.reshape(b, n // (2 * m), 2, m, lf.N_LIMBS)
        t = lf.mont_mul(shaped[:, :, 1], w_all[m - 1:2 * m - 1])
        a = shaped[:, :, 0]
        x = torch.stack([lf.add(a, t), lf.sub(a, t)], dim=2).reshape(b, n, lf.N_LIMBS)
    if scale is not None:
        x = lf.mont_mul(x, lf.from_card_words(scale))
    return lf.to_words(x)


def fft_rows(vals: torch.Tensor, tw: torch.Tensor, scale: torch.Tensor | None = None,
             bitrev: bool = True) -> torch.Tensor:
    """The DIT over every row of ``int32[B, n, 8]`` canonical values (below
    r) with the stage twiddles ``tw`` (``twiddle_words``), then times
    ``scale`` where given (Montgomery words, e.g. n^-1 for an inverse);
    ``bitrev`` gathers natural-order rows into the DIT's order first.
    Returns new ``int32[B, n, 8]`` canonical words.

    CUDA tensors go through kernel K16 (``csrc/fr_fft.cu``): one launch
    of the shared-memory chunk kernel (counted as ``fr_fft``) for every
    stage up to n = 2^CHUNK_LOG, then one launch of the global stage kernel
    (counted as ``fr_fft_stage``) for each stage above; CPU tensors go
    through the plain version."""
    log_n = _check_fft_args(vals, tw, scale)
    if vals.device.type == "cpu":
        return fft_rows_ref(vals, tw, scale, bitrev)
    for t in (vals, tw) + (() if scale is None else (scale,)):
        _ext.check_cuda(t, torch.int32)
    out = torch.empty_like(vals)
    rows, log_c = vals.shape[0], min(log_n, CHUNK_LOG)
    _ext.launch("fr_fft", "fr_fft_chunk_launch", vals.device, _ext.ptr(vals), _ext.ptr(out),
                _ext.ptr(tw), _ext.ptr(scale if log_c == log_n else None), rows, log_n, log_c,
                int(bool(bitrev)))
    for ls in range(log_c, log_n):
        _ext.launch("fr_fft", "fr_fft_stage_launch", vals.device, _ext.ptr(out), _ext.ptr(tw),
                    _ext.ptr(scale if ls == log_n - 1 else None), rows, log_n, ls,
                    counter="fr_fft_stage")
    return out


def inverse_roots(roots: tuple) -> tuple:
    """The roots of the inverse transform: roots[0], then the rest reversed."""
    return (roots[0],) + tuple(roots[:0:-1])


def batch_fft_words(vals: torch.Tensor, roots, inv: bool = False,
                    bitrev: bool = True) -> torch.Tensor:
    """``int32[B, n, 8]`` canonical words -> their DFT (natural order in and
    out), or the inverse DFT with ``inv``, on ``vals``' device. With
    ``bitrev=False`` the rows are taken as already in the DIT's order."""
    if not isinstance(roots, tuple):
        roots = tuple(int(r) for r in roots)
    n = len(roots)
    if vals.shape[1] != n:
        raise ValueError(f"{vals.shape[1]}-point rows against {n} roots")
    dev = str(vals.device)
    if inv:
        return fft_rows(vals, _device_twiddles(inverse_roots(roots), n, dev),
                        _device_scale(n, dev), bitrev)
    return fft_rows(vals, _device_twiddles(roots, n, dev), None, bitrev)


def batch_fft_field(batches, roots_of_unity, inv: bool = False, device=None) -> list[list[int]]:
    """Many same-length FFTs at once on ``device`` (the card by default):
    host ints in, host ints out, bit-exact with ``crypto.das.fft_field``
    applied row by row."""
    dev = default_device(device)
    roots = tuple(int(r) for r in roots_of_unity)
    n = len(roots)
    rows = [[int(x) % BLS_MODULUS for x in row] for row in batches]
    if not rows:
        return []
    words = torch.from_numpy(lf.ints_to_words(rows)).to(dev)
    flat = lf.words_to_ints(batch_fft_words(words, roots, inv=inv))
    return [flat[i * n:(i + 1) * n] for i in range(len(rows))]


def fft_field_device(vals, roots_of_unity, inv: bool = False, device=None) -> list[int]:
    """Device twin of ``crypto.das.fft_field`` (one vector)."""
    return batch_fft_field([list(vals)], roots_of_unity, inv=inv, device=device)[0]
