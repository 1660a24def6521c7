"""Port parity: merkle reduction and SSZ packing (eth_consensus_specs_tpu_torch/ops/merkle.py,
ops/state_root.py helpers) against the JAX package, bit for bit."""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eth_consensus_specs_tpu.ops import state_root as jsr
from eth_consensus_specs_tpu.ops.merkle import tree_root_words
from eth_consensus_specs_tpu_torch.convert import tensor_from_numpy, to_numpy
from eth_consensus_specs_tpu_torch.ops import merkle, state_root as tsr

_jax_tree = jax.jit(tree_root_words, static_argnums=(1,))


def _t(a):
    return tensor_from_numpy(a, "cpu")


@pytest.fixture(scope="module")
def leaves() -> np.ndarray:
    rng = np.random.default_rng(77)
    return rng.integers(0, 2**32, size=(1 << 10, 8), dtype=np.uint64).astype(np.uint32)



@pytest.mark.parametrize("depth", range(11))
def test_tree_root_ref_matches_jax(leaves, depth):
    lv = leaves[: 1 << depth]
    want = np.asarray(_jax_tree(jnp.asarray(lv), depth))
    got = to_numpy(merkle.tree_root_ref(_t(lv), depth))
    assert np.array_equal(got, want)
    assert np.array_equal(to_numpy(merkle.tree_root(_t(lv), depth)), want)


def test_tree_root_rejects_wrong_leaf_count(leaves):
    with pytest.raises(ValueError):
        merkle.tree_root_ref(_t(leaves[:6]), 3)


def test_zerohash_table_matches_jax():
    assert np.array_equal(merkle.zerohash_words(41).view(np.uint32), jsr.zerohash_words(41))


@pytest.mark.parametrize("n", [4, 64, 1000])
def test_packed_u64_leaves(n):
    rng = np.random.default_rng(n)
    vals = rng.integers(0, 2**64, size=n, dtype=np.uint64)
    vals[0] = np.iinfo(np.uint64).max
    want = np.asarray(jsr.packed_u64_leaves(jnp.asarray(vals), n))
    assert np.array_equal(to_numpy(merkle.packed_u64_leaves(_t(vals), n)), want)


@pytest.mark.parametrize("n", [32, 1024])
def test_packed_u8_leaves(n):
    vals = np.random.default_rng(n).integers(0, 256, size=n, dtype=np.uint8)
    want = np.asarray(jsr.packed_u8_leaves(jnp.asarray(vals), n))
    assert np.array_equal(to_numpy(merkle.packed_u8_leaves(_t(vals), n)), want)


def test_u64_chunk_words():
    vals = np.array([0, 1, 2**32 - 1, 2**32, 2**63, 2**64 - 1, 32_000_000_000], np.uint64)
    want = np.asarray(jsr._u64_chunk_words(jnp.asarray(vals)))
    assert np.array_equal(to_numpy(merkle.u64_chunk_words(_t(vals))), want)


@pytest.mark.parametrize("depth,limit", [(0, 3), (5, 35), (18, 38), (20, 40), (7, 7)])
def test_fold_to_limit(leaves, depth, limit):
    zh = jsr.zerohash_words(41)
    root = leaves[depth % 8]
    want = np.asarray(jax.jit(partial(jsr.fold_to_limit, depth=depth, limit_log2=limit))(
        jnp.asarray(root), zh=jnp.asarray(zh)))
    got = merkle.fold_many([_t(root)], [depth], [limit], _t(zh))[0]
    assert np.array_equal(to_numpy(got), want)


def test_fold_many_matches_single_chains(leaves):
    zh = _t(jsr.zerohash_words(41))
    depths, limits = [3, 10, 0], [40, 38, 2]
    roots = [_t(leaves[i]) for i in range(3)]
    many = merkle.fold_many(roots, depths, limits, zh)
    for r, d, lim, got in zip(roots, depths, limits, many):
        assert torch.equal(got, merkle.fold_many([r], [d], [lim], zh)[0])


@pytest.mark.parametrize("length", [0, 1, 64, 1000, 2**40])
def test_mix_length(leaves, length):
    want = np.asarray(jsr.mix_length(jnp.asarray(leaves[1]), length))
    got = merkle.mix_length(_t(leaves[1:2]), merkle.length_chunk(length, "cpu"))[0]
    assert np.array_equal(to_numpy(got), want)


@pytest.mark.parametrize("n", [1, 31, 32, 1000, 1 << 20])
def test_zero_participation_root(n):
    assert np.array_equal(tsr.zero_u8_list_root_words(n).view(np.uint32),
                          jsr._zero_u8_list_root_words(n))


@pytest.mark.parametrize("epoch", [0, 7, 2**64 - 1])
def test_checkpoint_root(epoch):
    root = np.arange(32, dtype=np.uint8) * 7
    want = np.asarray(jsr.checkpoint_root(jnp.asarray(np.uint64(epoch)), jnp.asarray(root)))
    got = tsr.checkpoint_roots([(_t(np.array(epoch, np.uint64)), _t(root))])[0]
    assert np.array_equal(to_numpy(got), want)


@pytest.mark.parametrize("bits", [[0, 0, 0, 0], [1, 0, 1, 1], [1, 1, 1, 1]])
def test_bitvector4_chunk(bits):
    b = np.array(bits, bool)
    want = np.asarray(jsr.bitvector4_chunk(jnp.asarray(b)))
    assert np.array_equal(to_numpy(tsr.bitvector4_chunk(_t(b))), want)
