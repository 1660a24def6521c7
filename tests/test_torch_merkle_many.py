"""Port parity: batched subtree roots (eth_consensus_specs_tpu_torch/ops/merkle.py
``many_tree_root``, ``chunks_to_words``, ``merkleize_many_device``,
``merkleize_subtree_device``) against the JAX package, bit for bit."""

import hashlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eth_consensus_specs_tpu.ops import merkle as jm
from eth_consensus_specs_tpu.serve import buckets
from eth_consensus_specs_tpu.serve.config import ServeConfig
from eth_consensus_specs_tpu_torch import config
from eth_consensus_specs_tpu_torch.ops import merkle as tm

DEPTHS = [0, 1, 5, 9, 12]


def _ragged(batch: int, depth: int, seed: int) -> list[np.ndarray]:
    """``batch`` trees of uint8 chunks, tree i holding (2^d - 37 i) mod
    (2^d + 1) of them: full, ragged and empty trees."""
    rng = np.random.default_rng(seed)
    cap = 1 << depth
    return [rng.integers(0, 256, ((cap - 37 * i) % (cap + 1), 32), dtype=np.uint8)
            for i in range(batch)]


def _packed(chunks: np.ndarray) -> np.ndarray:
    return chunks.view(">u4").astype(np.uint32).reshape(chunks.shape[0], 8)


@pytest.mark.parametrize("depth", DEPTHS)
@pytest.mark.parametrize("bucket", [1, 4, 64])
def test_merkleize_many_matches_jax(bucket, depth):
    trees = _ragged(bucket, depth, bucket * 100 + depth)
    want = jm.merkleize_many_device(trees, depth, pad_batch=bucket)
    got = tm.merkleize_many_device(trees, depth, pad_batch=bucket, device="cpu")
    assert got == want
    for i, (tree, root) in enumerate(zip(trees, got)):
        assert jm.merkleize_subtree_device(tree, depth) == root
        if i % 16 == 0 or i == bucket - 1:
            assert tm.merkleize_subtree_device(tree, depth, device="cpu") == root


@pytest.mark.parametrize("depth", [0, 5, 9])
def test_pad_batch_and_prepacked_words(depth):
    trees = _ragged(3, depth, depth)
    want = jm.merkleize_many_device(trees, depth, pad_batch=8)
    assert len(want) == 3
    assert tm.merkleize_many_device(trees, depth, pad_batch=8, device="cpu") == want
    assert tm.merkleize_many_device(trees, depth, device="cpu") == want
    packed = [_packed(t) for t in trees]
    assert jm.merkleize_many_device(packed, depth, pad_batch=4) == want
    assert tm.merkleize_many_device(packed, depth, pad_batch=4, device="cpu") == want


@pytest.mark.parametrize("depth", [0, 1, 4, 10])
def test_many_tree_root_ref_matches_jax(depth):
    rng = np.random.default_rng(depth)
    words = rng.integers(0, 2**32, size=(5, 1 << depth, 8), dtype=np.uint64).astype(np.uint32)
    want = np.asarray(jm._many_tree_root_fused(jnp.asarray(words), depth))
    got = tm.many_tree_root_ref(torch.from_numpy(words.view(np.int32)), depth)
    assert np.array_equal(got.numpy().view(np.uint32), want)
    assert np.array_equal(tm.many_tree_root(torch.from_numpy(words.view(np.int32)), depth).numpy(),
                          got.numpy())
    for b in range(5):
        assert torch.equal(tm.tree_root_ref(got.new_tensor(words[b].view(np.int32)), depth), got[b])


@pytest.mark.parametrize("n,cap", [(0, 4), (3, 4), (4, 4), (100, 128)])
def test_chunks_to_words_matches_jax(n, cap):
    chunks = np.random.default_rng(n).integers(0, 256, (n, 32), dtype=np.uint8)
    want = jm._chunks_to_words(chunks, cap)
    assert np.array_equal(tm.chunks_to_words(chunks, cap).numpy().view(np.uint32), want)
    assert np.array_equal(tm.chunks_to_words(_packed(chunks), cap).numpy().view(np.uint32), want)
    assert np.array_equal(tm.chunks_to_words(torch.from_numpy(chunks), cap).numpy().view(np.uint32), want)
    words = torch.from_numpy(_packed(chunks).view(np.int32))
    assert np.array_equal(tm.chunks_to_words(words, cap).numpy().view(np.uint32), want)


def test_depth_zero_root_is_the_leaf():
    leaf = bytes(range(32))
    chunks = np.frombuffer(leaf, np.uint8).reshape(1, 32)
    assert tm.merkleize_subtree_device(chunks, 0, device="cpu") == leaf
    assert tm.merkleize_many_device([chunks, chunks[:0]], 0, device="cpu") == [leaf, bytes(32)]


def test_root_against_hashlib():
    chunks = _ragged(1, 5, 9)[0]
    level = [bytes(c) for c in chunks] + [bytes(32)] * (32 - len(chunks))
    while len(level) > 1:
        level = [hashlib.sha256(level[i] + level[i + 1]).digest() for i in range(0, len(level), 2)]
    assert tm.merkleize_subtree_device(chunks, 5, device="cpu") == level[0]


def test_rejected_inputs():
    trees = _ragged(3, 2, 1)
    with pytest.raises(ValueError):
        tm.merkleize_many_device(trees, 2, pad_batch=2, device="cpu")
    with pytest.raises(ValueError):
        tm.chunks_to_words(np.zeros((5, 32), np.uint8), 4)
    with pytest.raises(ValueError):
        tm.many_tree_root(torch.zeros((2, 6, 8), dtype=torch.int32), 3)
    assert tm.merkleize_many_device([], 4, device="cpu") == []


def test_serving_constants_match_jax():
    cfg = ServeConfig()
    assert config.FLUSH_BUCKETS == cfg.buckets and config.MAX_BATCH == cfg.max_batch
    assert config.DEVICE_SUBTREE_THRESHOLD == buckets.DEVICE_SUBTREE_THRESHOLD


def test_device_default_needs_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError):
        tm.merkleize_many_device(_ragged(2, 3, 0), 3)
    with pytest.raises(RuntimeError):
        tm.merkleize_subtree_device(_ragged(1, 3, 0)[0], 3)
