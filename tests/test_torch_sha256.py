"""Port parity: SHA-256 of 64-byte messages (eth_consensus_specs_tpu_torch/ops/sha256.py)
against hashlib and the JAX package's sha256_pair_words, bit for bit."""

import hashlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eth_consensus_specs_tpu.ops.sha256 import sha256_pair_words
from eth_consensus_specs_tpu_torch.ops.sha256 import sha256_pairs, sha256_pairs_ref


@pytest.fixture(scope="module")
def messages() -> np.ndarray:
    """257 random messages plus an all-zero and an all-0xFFFFFFFF one, as u32[N, 16]."""
    rng = np.random.default_rng(2024)
    rand = rng.integers(0, 2**32, size=(257, 16), dtype=np.uint64).astype(np.uint32)
    corners = np.stack([np.zeros(16, np.uint32), np.full(16, 0xFFFFFFFF, np.uint32)])
    return np.concatenate([rand, corners])


@pytest.fixture(scope="module")
def port_digests(messages) -> np.ndarray:
    out = sha256_pairs_ref(torch.from_numpy(messages.view(np.int32).copy()))
    return out.numpy().view(np.uint32)



def _digest_bytes(words: np.ndarray) -> bytes:
    return words.astype(">u4").tobytes()


@pytest.mark.parametrize("rows", ["random", "all_zero", "all_ones"])
def test_ref_matches_hashlib(messages, port_digests, rows):
    idx = {"random": range(257), "all_zero": [257], "all_ones": [258]}[rows]
    for i in idx:
        want = hashlib.sha256(_digest_bytes(messages[i])).digest()
        assert _digest_bytes(port_digests[i]) == want, i


def test_ref_matches_jax(messages, port_digests):
    want = np.asarray(jax.jit(sha256_pair_words)(jnp.asarray(messages)))
    assert np.array_equal(port_digests, want)


def test_dispatch_on_cpu_is_plain_version(messages, port_digests):
    out = sha256_pairs(torch.from_numpy(messages.view(np.int32).copy()))
    assert np.array_equal(out.numpy().view(np.uint32), port_digests)


@pytest.mark.parametrize("n", [1, 5, 0])
def test_ref_shapes(n):
    out = sha256_pairs_ref(torch.zeros((n, 16), dtype=torch.int32))
    assert out.shape == (n, 8) and out.dtype == torch.int32
