"""Port parity: the committee shuffle (eth_consensus_specs_tpu_torch/ops/shuffle.py) and the
single-block SHA-256 behind it (ops/sha256.py ``sha256_single_block``) against the JAX
package, the spec's per-index form and hashlib, bit for bit."""

import hashlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eth_consensus_specs_tpu.forks import get_spec
from eth_consensus_specs_tpu.ops import shuffle as js
from eth_consensus_specs_tpu.ops.sha256 import sha256_single_block as jax_single_block
from eth_consensus_specs_tpu_torch.config import shuffle_round_count
from eth_consensus_specs_tpu_torch.ops import shuffle as ts
from eth_consensus_specs_tpu_torch.ops.sha256 import sha256_single_block, sha256_single_block_ref

SEEDS = {"counting": bytes(range(32)), "5a": b"\x5a" * 32, "sha": hashlib.sha256(b"seed").digest()}
SIZES = [0, 1, 2, 255, 256, 257, 1000, 4096]


@pytest.fixture(scope="module")
def specs():
    return {p: get_spec("phase0", p) for p in ("mainnet", "minimal")}


def _indices(n: int) -> list[int]:
    """Every index of a small registry; a spread of 40 of a larger one,
    both ends and both sides of each chunk boundary included."""
    if n <= 300:
        return list(range(n))
    picks = {0, 1, 255, 256, 257, n - 2, n - 1} | set(np.linspace(0, n - 1, 33).astype(int).tolist())
    return sorted(picks)


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("preset", ["mainnet", "minimal"])
def test_permutation_matches_jax_and_spec(specs, preset, n, seed):
    s = SEEDS[seed]
    rounds = shuffle_round_count(preset)
    assert rounds == specs[preset].SHUFFLE_ROUND_COUNT
    want = np.asarray(js.shuffle_permutation_device(n, s, rounds))
    got = ts.shuffle_permutation_device(n, s, rounds, device="cpu")
    assert got.dtype == torch.int32 and got.shape == (n,)
    assert np.array_equal(got.numpy(), want)
    host = ts.shuffle_permutation(n, s, rounds)
    assert host.dtype == np.int64 and np.array_equal(host, js.shuffle_permutation(n, s, rounds))
    assert np.array_equal(host, want)
    assert sorted(host.tolist()) == list(range(n))
    for i in _indices(n):
        assert int(host[i]) == specs[preset].compute_shuffled_index(i, n, s), i


def test_shuffle_list():
    items = [f"v{i}" for i in range(300)]
    assert ts.shuffle_list(items, SEEDS["5a"], 10) == js.shuffle_list(items, SEEDS["5a"], 10)


@pytest.mark.parametrize("rounds,chunks", [(1, 1), (3, 5), (90, 4), (10, 1 << 10)])
def test_single_block_words_match_jax(rounds, chunks):
    s = SEEDS["sha"]
    msgs = [s + bytes([r]) + c.to_bytes(4, "little") for r in range(rounds) for c in range(chunks)]
    want = js._single_block_words(msgs)
    got = ts.single_block_words(s, rounds, chunks, "cpu")
    assert np.array_equal(got.numpy().view(np.uint32), want)


def test_single_block_words_high_chunk_bytes():
    """Chunk indices past 2^16 and 2^24 fill every little-endian byte."""
    s = SEEDS["counting"]
    got = ts.single_block_words(s, 1, (1 << 24) + 3, "cpu")[[0x10000, 0x10203, (1 << 24) + 2]]
    msgs = [s + b"\x00" + c.to_bytes(4, "little") for c in (0x10000, 0x10203, (1 << 24) + 2)]
    assert np.array_equal(got.numpy().view(np.uint32), js._single_block_words(msgs))


def _blocks(messages: list[bytes]) -> torch.Tensor:
    return torch.from_numpy(js._single_block_words(messages).view(np.int32).copy())


@pytest.mark.parametrize("length", [37, 33])
def test_single_block_ref_matches_hashlib_and_jax(length):
    rng = np.random.default_rng(length)
    msgs = [rng.integers(0, 256, length, dtype=np.uint8).tobytes() for _ in range(64)]
    msgs += [b"\x00" * length, b"\xff" * length]
    got = sha256_single_block_ref(_blocks(msgs)).numpy().view(np.uint32)
    for m, row in zip(msgs, got):
        assert row.astype(">u4").tobytes() == hashlib.sha256(m).digest()
    want = np.asarray(jax.jit(jax_single_block)(jnp.asarray(js._single_block_words(msgs))))
    assert np.array_equal(got, want)
    assert np.array_equal(sha256_single_block(_blocks(msgs)).numpy().view(np.uint32), got)


@pytest.mark.parametrize("n", [1, 255, 256, 257, 1000])
def test_rounds_ref_is_the_jax_loop(n):
    """The plain twin of K8 on the JAX kernel's own digest table and pivots."""
    s, rounds = SEEDS["5a"], 90
    chunks = (n + 255) // 256
    blocks = ts.single_block_words(s, rounds, chunks, "cpu")
    digests = sha256_single_block_ref(blocks)
    pivots = torch.tensor(ts.pivots(n, s, rounds), dtype=torch.int32)
    want = np.asarray(js._device_shuffle_kernel(n, rounds, chunks)(
        jnp.asarray(blocks.numpy().view(np.uint32)), jnp.asarray(pivots.numpy())))
    assert np.array_equal(ts.shuffle_rounds_ref(digests, pivots, n).numpy(), want)
    assert np.array_equal(ts.shuffle_rounds(digests, pivots, n).numpy(), want)


def _rounds_array_form(digests: torch.Tensor, pivots: torch.Tensor, n: int) -> np.ndarray:
    """K8's design on the host: X starts as the identity and the rounds run in
    reverse as whole-array steps X'[j] = X[g_r(j)], g_r one round of one lane.
    g_r swaps each pair (j, f = flip(j)), j < f, whose decision bit at f is
    set: the pairs are j < ceil(p/2) with f = p - j and p < j < (p + n + 1) / 2
    with f = p + n - j, and the one or two fixed points stay."""
    rounds = pivots.shape[0]
    table = digests.numpy().view(np.uint32).reshape(rounds, -1, 8).astype(np.int64)
    x = np.arange(n, dtype=np.int64)
    for r in reversed(range(rounds)):
        p = int(pivots[r])
        low = (p + 1) // 2
        m = np.arange(low + (p + n - 1) // 2 - p, dtype=np.int64)
        j = np.where(m < low, m, p + 1 + (m - low))
        f = np.where(m < low, p - m, p + n - j)
        fixed = [v for v, even in ((p // 2, p % 2 == 0), ((p + n) // 2, (p + n) % 2 == 0)) if even]
        assert sorted(np.concatenate([j, f, fixed]).tolist()) == list(range(n))
        assert (j < f).all() and ((p - j) % n == f).all()
        in_chunk = f & 255
        word = table[r, f >> 8, in_chunk >> 5]
        byte = (word >> (8 * (3 - ((in_chunk >> 3) & 3)))) & 0xFF
        swap = (byte >> (in_chunk & 7)) & 1 == 1
        x[j[swap]], x[f[swap]] = x[f[swap]], x[j[swap]]
    return x


@pytest.mark.parametrize("rounds", [90, 10])
@pytest.mark.parametrize("n", [1, 2, 255, 256, 257, 1000])
def test_reverse_array_form_is_the_lane_form(n, rounds):
    """The whole-array steps in reverse equal the plain twin's lane rounds and
    the JAX host permutation."""
    s = SEEDS["sha"]
    digests = sha256_single_block_ref(ts.single_block_words(s, rounds, (n + 255) // 256, "cpu"))
    pivots = torch.tensor(ts.pivots(n, s, rounds), dtype=torch.int32)
    got = _rounds_array_form(digests, pivots, n)
    assert np.array_equal(got, ts.shuffle_rounds_ref(digests, pivots, n).numpy())
    assert np.array_equal(got, js.shuffle_permutation(n, s, rounds))


def test_flip_wraps_below_zero():
    """A pivot below the index must wrap to pivot + n - idx (floored mod),
    never a negative lane: with every decision bit set, round r maps lane i
    to (pivot_r - i) mod n."""
    n, pivots = 300, torch.tensor([0, 7, 299], dtype=torch.int32)
    digests = torch.full((3 * 2, 8), -1, dtype=torch.int32)
    got = ts.shuffle_rounds_ref(digests, pivots, n)
    idx = np.arange(n)
    for p in (0, 7, 299):
        idx = (p - idx) % n
    assert np.array_equal(got.numpy(), idx)


def test_decision_byte_is_big_endian():
    """Position 8k + b reads byte k of the digest: the high byte of its
    big-endian word first. Only byte 1's bit 0 set flips exactly the lanes
    whose position is 8."""
    n = 16
    digests = torch.zeros((1, 8), dtype=torch.int32)
    digests[0, 0] = 0x00010000  # digest byte 1 = 0x01: position 8
    got = ts.shuffle_rounds_ref(digests, torch.tensor([8], dtype=torch.int32), n)
    want = np.arange(n)
    want[0], want[8] = 8, 0  # flip of lane 0 is 8 (position 8); lane 8 is its own flip's partner
    assert np.array_equal(got.numpy(), want)


def test_empty_and_rejected_inputs():
    assert ts.shuffle_permutation_device(0, SEEDS["5a"], 90, device="cpu").shape == (0,)
    with pytest.raises(ValueError):
        ts.shuffle_rounds(torch.zeros((3, 8), dtype=torch.int32), torch.zeros(2, dtype=torch.int32), 300)
    with pytest.raises(ValueError):
        ts.single_block_words(b"short", 1, 1, "cpu")


def test_device_default_needs_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError):
        ts.shuffle_permutation_device(8, SEEDS["5a"], 10)
