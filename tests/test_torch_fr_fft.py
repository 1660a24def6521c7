"""The port's Fr FFT on the CPU (the plain version of K16) against the JAX
package's ``ops/fr_fft.py`` and the host ``fft_field``.

``batch_fft_field`` forward and inverse at n = 2, 16 and 64 on seeded rows
that hold the corners 0, 1, r - 1 and 2^254; the twiddle tables and
``FR.ints_to_mont_batch`` rows carried across by ``convert``; the plain Fr
arithmetic (``ops/limb_field``) against Python ints; the DIT-order input
that skips the bit reversal; the blob width (4096) and the DAS width (8192)
against the host. Ints compare exactly; limb arrays never cross packages.
"""

import numpy as np
import pytest
import torch

from eth_consensus_specs_tpu.crypto import das as jdas
from eth_consensus_specs_tpu.crypto import kzg as jkzg
from eth_consensus_specs_tpu.ops import fr_fft as jfft
from eth_consensus_specs_tpu_torch import convert
from eth_consensus_specs_tpu_torch.crypto import das, kzg
from eth_consensus_specs_tpu_torch.ops import fr_fft
from eth_consensus_specs_tpu_torch.ops import limb_field as lf

R = lf.R_MOD
CORNERS = [0, 1, R - 1, 1 << 254]


def _rows(b: int, n: int, seed: int) -> list[list[int]]:
    """Seeded values below r (numpy words, the top one below r's), the
    corners at the head of row 0."""
    rng = np.random.default_rng(seed)
    w = rng.integers(0, 2**32, size=(b, n, 8), dtype=np.uint64)
    w[..., 7] %= R >> 224
    flat = lf.words_to_ints(w.astype(np.uint32).view(np.int32))
    rows = [flat[i * n:(i + 1) * n] for i in range(b)]
    rows[0][: min(n, 4)] = CORNERS[: min(n, 4)]
    return rows


@pytest.mark.parametrize("inv", [False, True], ids=["forward", "inverse"])
@pytest.mark.parametrize("n", [2, 16, 64])
def test_batch_fft_field_matches_jax(n, inv):
    rows = _rows(3, n, n)
    roots = jkzg.compute_roots_of_unity(n)
    assert kzg.compute_roots_of_unity(n) == roots
    port = fr_fft.batch_fft_field(rows, roots, inv=inv, device="cpu")
    assert port == jfft.batch_fft_field(rows, roots, inv=inv)
    assert port == [das.fft_field(r, roots, inv=inv) for r in rows]
    assert port == [jdas.fft_field(r, roots, inv=inv) for r in rows]


def test_fft_field_device_matches_jax_and_reduces_its_input():
    rows = _rows(1, 16, 7)
    rows[0][5] += R  # the entry points reduce mod r, as the JAX package does
    roots = kzg.compute_roots_of_unity(16)
    got = fr_fft.fft_field_device(rows[0], roots, inv=True, device="cpu")
    assert got == jfft.fft_field_device(rows[0], roots, inv=True)
    assert fr_fft.batch_fft_field([], roots, device="cpu") == []


@pytest.mark.parametrize("n", [2, 16, 4096])
def test_stage_twiddles_through_convert(n):
    roots = kzg.compute_roots_of_unity(n)
    for table in (roots, fr_fft.inverse_roots(roots)):
        jax_tables = jfft._stage_twiddles(tuple(table), n)
        assert [convert.fr_ints_from_jax_limbs(t) for t in jax_tables] == [
            list(t) for t in fr_fft._stage_twiddles(tuple(table), n)]
        assert np.array_equal(convert.twiddles_from_jax(jax_tables),
                              fr_fft.twiddle_words(tuple(table), n))


def test_mont_batch_through_convert():
    vals = _rows(2, 8, 3)
    jax_limbs = jfft.FR.ints_to_mont_batch(vals)
    assert convert.fr_ints_from_jax_limbs(jax_limbs) == vals
    assert np.array_equal(convert.fr_words_from_jax_limbs(jax_limbs), lf.ints_to_words(vals))


@pytest.mark.parametrize("n", [1, 2, 8, 4096])
def test_bit_reversal_indices_match_jax(n):
    assert np.array_equal(fr_fft._bit_reversal_indices(n), jfft._bit_reversal_indices(n))
    assert fr_fft._bit_reversal_indices(n).tolist() == [
        kzg.reverse_bits(i, n) for i in range(n)]


def test_plain_fr_arithmetic_against_ints():
    vals = CORNERS + [R - 2, (1 << 255) % R, 1 << 200] + _rows(1, 64, 11)[0]
    other = vals[::-1]
    a, b = (lf.from_words(torch.from_numpy(lf.ints_to_words(v))) for v in (vals, other))

    def ints(t):
        return lf.words_to_ints(lf.to_words(t))

    rinv = pow(lf.R_INT, -1, R)
    assert ints(lf.add(a, b)) == [(x + y) % R for x, y in zip(vals, other)]
    assert ints(lf.sub(a, b)) == [(x - y) % R for x, y in zip(vals, other)]
    assert ints(lf.mont_mul(a, b)) == [x * y * rinv % R for x, y in zip(vals, other)]
    card = torch.from_numpy(lf.ints_to_card_words(vals))
    assert lf.words_to_ints(card) == [x * lf.CARD_R % R for x in vals]
    assert ints(lf.from_card_words(card)) == [x * lf.R_INT % R for x in vals]
    # every limb of a product of the largest operands stays a 26-bit canonical limb
    top = lf.mont_mul(a, a)
    assert int(top.min()) >= 0 and int(top.max()) <= lf.MASK


def test_big_endian_words():
    vals = CORNERS + _rows(1, 12, 5)[0]
    blob = b"".join(v.to_bytes(32, "big") for v in vals)
    assert lf.words_to_ints(lf.big_endian_to_words(blob, len(vals))) == vals


@pytest.mark.parametrize("n", [2, 64, 4096])
def test_dit_order_rows_skip_the_permutation(n):
    """A row already in the DIT's order (a blob as stored) through
    ``bitrev=False`` equals its natural order through the gather."""
    rows = _rows(2, n, n + 1)
    roots = kzg.compute_roots_of_unity(n)
    stored = torch.from_numpy(lf.ints_to_words([kzg.bit_reversal_permutation(r) for r in rows]))
    natural = torch.from_numpy(lf.ints_to_words(rows))
    got = fr_fft.batch_fft_words(stored, roots, inv=True, bitrev=False)
    assert torch.equal(got, fr_fft.batch_fft_words(natural, roots, inv=True))
    assert lf.words_to_ints(got[1]) == das.fft_field(rows[1], roots, inv=True)


@pytest.mark.parametrize("n,inv", [(4096, True), (8192, False)])
def test_plain_fft_at_blob_and_das_widths(n, inv):
    rows = _rows(2, n, 3 * n)
    roots = kzg.compute_roots_of_unity(n)
    got = fr_fft.batch_fft_field(rows, roots, inv=inv, device="cpu")
    assert got[0] == das.fft_field(rows[0], roots, inv=inv)
    assert got[1] == jdas.fft_field(rows[1], roots, inv=inv)


def test_fft_rows_rejects_bad_shapes():
    tw = torch.from_numpy(fr_fft.twiddle_words(kzg.compute_roots_of_unity(4), 4))
    with pytest.raises(ValueError):
        fr_fft.fft_rows(torch.zeros((1, 6, 8), dtype=torch.int32), tw)
    with pytest.raises(ValueError):
        fr_fft.fft_rows(torch.zeros((1, 4, 8), dtype=torch.int32), tw[:2])
    with pytest.raises(ValueError):
        fr_fft.fft_rows(torch.zeros((1, 4, 7), dtype=torch.int32), tw)
