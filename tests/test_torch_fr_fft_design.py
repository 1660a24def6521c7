"""K16's design (csrc/fr_fft.cu) run on host ints: the stages cut into passes
(``fr_fft.fft_passes``), each pass's tiles taken by teams whose threads hold four
positions a phase and run two stages there, against the plain version
(``fft_rows_ref``), the JAX package's ``batch_fft_field`` and the host ``fft_field``."""

import random

import numpy as np
import pytest
import torch

from eth_consensus_specs_tpu.crypto import kzg as jkzg
from eth_consensus_specs_tpu.ops import fr_fft as jfft
from eth_consensus_specs_tpu_torch.crypto import das, kzg
from eth_consensus_specs_tpu_torch.ops import fr_fft
from eth_consensus_specs_tpu_torch.ops import limb_field as lf

R = lf.R_MOD


def pass_model(row: list, roots: tuple, inv: bool = False, bitrev: bool = True,
               seed: int = 0, tail_rehashes: bool = False) -> list:
    """One row through K16's schedule, step for step: ``fft_passes``' cut,
    every tile of a pass taken in a shuffled order, the team's thread j in
    phase k holding the positions ``base + loc << a`` with loc the kernel's
    (bits q and q + 1 of the tile index from u, the rest from j), the
    butterflies of tile bit q (where q == 2k) and q + 1 with the table's
    twiddle of the lower position, the tile kept in a dict between phases.
    ``tail_rehashes`` runs bit q on an odd pass's last phase too (a bit
    already done), the fault the q == 2k guard keeps out."""
    n = len(row)
    log_n = n.bit_length() - 1
    table = [w for stage in fr_fft._stage_twiddles(fr_fft.inverse_roots(roots) if inv else roots, n)
             for w in stage]
    x = [row[int(i)] for i in fr_fft._bit_reversal_indices(n)] if bitrev else list(row)

    def butterfly(i: int, j: int, ls: int) -> None:
        m = 1 << ls
        t = x[j] * table[m - 1 + (i & (m - 1))] % R
        x[i], x[j] = (x[i] + t) % R, (x[i] - t) % R

    if log_n == 1:
        butterfly(0, 1, 0)
    a = 0
    for s in fr_fft.fft_passes(log_n):
        tiles = list(range(n >> s))
        random.Random(seed + a).shuffle(tiles)
        for tl in tiles:
            base = (tl & ((1 << a) - 1)) | ((tl >> a) << (a + s))
            for k in range((s + 1) // 2):
                q = min(2 * k, s - 2)
                for j in range(1 << (s - 2)):
                    g = [base + (((j & ((1 << q) - 1)) | (u << q) | ((j >> q) << (q + 2))) << a)
                         for u in range(4)]
                    if q == 2 * k or tail_rehashes:
                        butterfly(g[0], g[1], a + q)
                        butterfly(g[2], g[3], a + q)
                    butterfly(g[0], g[2], a + q + 1)
                    butterfly(g[1], g[3], a + q + 1)
        a += s
    if inv:
        scale = pow(n, -1, R)
        x = [v * scale % R for v in x]
    return x


def _row(n: int, seed: int) -> list:
    rng = np.random.default_rng(seed)
    w = rng.integers(0, 2**32, size=(n, 8), dtype=np.uint64)
    w[..., 7] %= R >> 224
    row = lf.words_to_ints(w.astype(np.uint32).view(np.int32))
    row[: min(n, 4)] = [0, 1, R - 1, 1 << 254][: min(n, 4)]
    return row


def test_passes_cut_the_stages():
    for log_n in range(27):
        passes = fr_fft.fft_passes(log_n)
        assert sum(passes) == (log_n if log_n >= 2 else 0)
        assert all(2 <= s <= fr_fft.MAX_PASS for s in passes)
        assert max(passes, default=0) - min(passes, default=0) <= 1
    assert fr_fft.fft_passes(12) == (6, 6) and fr_fft.fft_passes(13) == (7, 6)


def _plain(rows: list, roots: tuple, inv: bool, bitrev: bool = True) -> list:
    n = len(roots)
    vals = torch.from_numpy(lf.ints_to_words(rows))
    tw = fr_fft._device_twiddles(fr_fft.inverse_roots(roots) if inv else roots, n, "cpu")
    scale = fr_fft._device_scale(n, "cpu") if inv else None
    flat = lf.words_to_ints(fr_fft.fft_rows_ref(vals, tw, scale, bitrev))
    return [flat[i * n:(i + 1) * n] for i in range(len(rows))]


@pytest.mark.parametrize("n", [16, 64])
@pytest.mark.parametrize("inv", [False, True], ids=["forward", "inverse"])
def test_model_matches_plain_jax_and_host(n, inv):
    """One pass of 4 and of 6 stages."""
    roots = kzg.compute_roots_of_unity(n)
    rows = [_row(n, n + i) for i in range(2)]
    got = [pass_model(r, roots, inv, seed=i) for i, r in enumerate(rows)]
    assert got == [das.fft_field(r, roots, inv=inv) for r in rows]
    assert got == jfft.batch_fft_field(rows, jkzg.compute_roots_of_unity(n), inv=inv)
    assert got == _plain(rows, roots, inv)


@pytest.mark.parametrize("n", [2, 4, 8, 512, 8192])
def test_model_matches_plain_and_host(n):
    """A thread a row (2), one pass of 2 and 3 stages, passes of 5 + 4 and
    of 7 + 6 (the DAS width)."""
    roots = kzg.compute_roots_of_unity(n)
    row = _row(n, n)
    got = pass_model(row, roots, seed=n)
    assert got == das.fft_field(row, roots) == _plain([row], roots, False)[0]


def test_model_at_the_blob_width():
    """4,096 points (two passes of 6) on a blob as the flush stores it, in
    the DIT's order, inverse, against the plain version, the host and the
    JAX package."""
    n = 4096
    roots = kzg.compute_roots_of_unity(n)
    row = _row(n, 3)
    stored = kzg.bit_reversal_permutation(row)
    got = pass_model(stored, roots, inv=True, bitrev=False)
    assert got == das.fft_field(row, roots, inv=True)
    assert got == _plain([stored], roots, True, bitrev=False)[0]
    assert [got] == jfft.batch_fft_field([row], jkzg.compute_roots_of_unity(n), inv=True)


@pytest.mark.parametrize("n", [8, 512])
def test_odd_pass_rehashing_its_held_bit_fails(n):
    """An odd pass's last phase holds tile bits s-2 and s-1 and must run
    only s-1: a model that runs both differs (n = 8: one pass of 3; 512:
    passes of 5 and 4)."""
    roots = kzg.compute_roots_of_unity(n)
    row = _row(n, 11)
    assert pass_model(row, roots) == das.fft_field(row, roots)
    assert pass_model(row, roots, tail_rehashes=True) != das.fft_field(row, roots)
