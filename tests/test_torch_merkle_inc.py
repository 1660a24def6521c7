"""Port parity: the incremental flat-tree kernels (eth_consensus_specs_tpu_torch/ops/merkle_inc.py,
K5 and K6 through their plain versions on the CPU) against the JAX package's
ops/merkle_inc.py on the same seeded inputs, bit for bit."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eth_consensus_specs_tpu.ops import merkle_inc as jmi
from eth_consensus_specs_tpu.ops.state_root import _u64_chunk_leaves as jax_chunk_leaves
from eth_consensus_specs_tpu_torch.convert import tensor_from_numpy, to_numpy
from eth_consensus_specs_tpu_torch.ops import merkle_inc as tmi


# jitted once per shape: the cases of a test share one compile
_jax_build_levels = jax.jit(jmi.build_levels)
_jax_dirty_indices = jax.jit(jmi.dirty_indices, static_argnums=1)
_jax_path_update = jax.jit(jmi.path_update)
_jax_apply_dirty = jax.jit(
    lambda nodes, mask, new, cap, dense: jmi.apply_dirty(nodes, mask, lambda i: new[i], cap, dense),
    static_argnums=(3, 4))


def _t(a):
    return tensor_from_numpy(a, "cpu")


def _words(rows: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return rng.integers(0, 2**32, size=(rows, 8), dtype=np.uint64).astype(np.uint32)


@pytest.mark.parametrize("depth", range(7))
def test_build_levels_matches_jax(depth):
    leaves = _words(1 << depth, depth)
    want = np.asarray(_jax_build_levels(jnp.asarray(leaves)))
    got = to_numpy(tmi.build_levels(_t(leaves)))
    assert got.shape == (tmi.tree_nodes(depth), 8) and tmi.tree_depth(got.shape[0]) == depth
    assert np.array_equal(got, want)


def test_build_levels_batched_matches_jax():
    leaves = _words(4 * 16, 9).reshape(4, 16, 8)
    want = np.asarray(_jax_build_levels(jnp.asarray(leaves)))
    assert np.array_equal(to_numpy(tmi.build_levels(_t(leaves))), want)


@pytest.mark.parametrize("case", ["empty", "full", "over_capacity", "random"])
def test_dirty_indices_matches_jax(case):
    n, cap = 64, 16
    mask = {
        "empty": np.zeros(n, bool),
        "full": np.ones(n, bool),
        "over_capacity": np.arange(n) % 3 == 0,  # 22 dirty, cap 16: the tail drops
        "random": np.random.default_rng(5).random(n) < 0.15,
    }[case]
    want = np.asarray(_jax_dirty_indices(jnp.asarray(mask), cap))
    idx, count = tmi.dirty_indices(torch.from_numpy(mask), cap)
    assert np.array_equal(to_numpy(idx), want)
    assert int(count) == int(mask.sum())


def test_path_update_duplicates_siblings_and_padding_match_jax():
    depth = 5
    leaves = _words(1 << depth, 1)
    nodes = np.asarray(_jax_build_levels(jnp.asarray(leaves)))
    new = _words(1 << depth, 2)
    # 6 and 7 are siblings, 6 repeats, and the trailing zeros are padding
    # (leaf 0 written with its own new value, as JAX's leaf_fn gives it)
    idx = np.array([6, 7, 6, 21, 0, 0, 0, 0], np.int32)
    vals = new[idx]
    want = np.asarray(_jax_path_update(jnp.asarray(nodes), jnp.asarray(idx), jnp.asarray(vals)))
    got = tmi.path_update(_t(nodes), _t(idx), _t(vals))
    assert np.array_equal(to_numpy(got), want)
    # the update equals a rebuild of the changed leaf level
    changed = leaves.copy()
    changed[idx] = vals
    assert np.array_equal(to_numpy(got), np.asarray(_jax_build_levels(jnp.asarray(changed))))


def test_path_update_count_and_gate():
    depth = 4
    nodes = tmi.build_levels(_t(_words(1 << depth, 3)))
    vals = _t(_words(4, 4))
    idx = torch.tensor([1, 9, 0, 0], dtype=torch.int32)
    count = torch.tensor([2], dtype=torch.int32)
    gated = tmi.path_update(nodes.clone(), idx, vals, count, dense=1)  # 2 > 1: the dense side's
    assert torch.equal(gated, nodes)
    got = tmi.path_update(nodes.clone(), idx, vals, count, dense=2)
    leaves = nodes[:1 << depth].clone()
    leaves[[1, 9]] = vals[:2]
    assert torch.equal(got, tmi.build_levels(leaves))


@pytest.mark.parametrize("extra", [0, 1], ids=["sparse_at_dense_count", "dense_past_it"])
def test_apply_dirty_both_branches_match_jax(extra):
    depth, cap, dense_count = 6, 16, 10
    leaves = _words(1 << depth, 6)
    nodes = np.asarray(_jax_build_levels(jnp.asarray(leaves)))
    new = leaves.copy()
    dirty = np.random.default_rng(7).choice(1 << depth, dense_count + extra, replace=False)
    new[dirty] ^= np.uint32(0x5A5A5A5A)
    mask = np.zeros(1 << depth, bool)
    mask[dirty] = True
    want = np.asarray(_jax_apply_dirty(jnp.asarray(nodes), jnp.asarray(mask), jnp.asarray(new),
                                       cap, dense_count))
    new_t = _t(new)
    got = tmi.apply_dirty(_t(nodes), torch.from_numpy(mask),
                          lambda i: new_t[i.to(torch.int64)], cap, dense_count)
    assert np.array_equal(to_numpy(got), want)
    assert np.array_equal(want, np.asarray(_jax_build_levels(jnp.asarray(new))))


@pytest.mark.parametrize("shards", [1, 2, 4])
def test_forest_root_matches_jax(shards):
    leaves = _words(64, 8)
    forest = np.asarray(jmi.build_forest(jnp.asarray(leaves), shards))
    got = tmi.build_forest(_t(leaves), shards)
    assert np.array_equal(to_numpy(got), forest)
    assert np.array_equal(to_numpy(tmi.forest_root(got)), np.asarray(jmi.forest_root(jnp.asarray(forest))))


def test_update_forest_matches_jax():
    depth = 7
    leaves = _words(1 << depth, 10)
    new = leaves.copy()
    new[[3, 4, 100]] ^= np.uint32(1)
    mask = (new != leaves).any(axis=1)
    forest = np.asarray(jmi.build_forest(jnp.asarray(leaves), 1))
    want_nodes, want_root = jmi.update_forest_device(
        jnp.asarray(forest), jnp.asarray(mask[None]), jnp.asarray(new[None]))
    got_nodes, got_root = tmi.update_forest(_t(forest), torch.from_numpy(mask[None]), _t(new[None]))
    assert np.array_equal(to_numpy(got_nodes), np.asarray(want_nodes))
    assert np.array_equal(to_numpy(got_root), np.asarray(want_root))


@pytest.mark.parametrize("n", [64, 1000])
def test_dirty_leaves_of_a_u64_column_match_jax_mask(n):
    """K5's column modes against JAX's chunk-wise diff: the dirty chunks
    of the packed leaf levels, compacted by JAX's dirty_indices, and the
    leaf rows left equal to the new column's chunks."""
    rng = np.random.default_rng(n)
    old = rng.integers(0, 2**64, size=n, dtype=np.uint64)
    new = old.copy()
    new[rng.choice(n, 40, replace=False)] += np.uint64(3)
    depth = max((n + 3) // 4 - 1, 0).bit_length()
    old_leaves = np.asarray(jax_chunk_leaves(jnp.asarray(old), n, depth))
    new_leaves = np.asarray(jax_chunk_leaves(jnp.asarray(new), n, depth))
    mask = (old_leaves != new_leaves).any(axis=1)
    cap = 64
    rows = _t(old_leaves)
    idx, count = tmi.dirty_leaves(_t(old), _t(new), 4, 1 << depth, cap, rows)
    assert np.array_equal(to_numpy(idx), np.asarray(_jax_dirty_indices(jnp.asarray(mask), cap)))
    assert int(count) == int(mask.sum())
    assert np.array_equal(to_numpy(rows), new_leaves)
    # one value a leaf, no rows: the effective-balance diff of the registry
    lv = 1 << max(n - 1, 0).bit_length()
    mask1 = np.zeros(lv, bool)
    mask1[:n] = old != new
    idx1, count1 = tmi.dirty_leaves(_t(old), _t(new), 1, lv, cap)
    assert np.array_equal(to_numpy(idx1), np.asarray(_jax_dirty_indices(jnp.asarray(mask1), cap)))
    assert int(count1) == 40


def test_merkle_levels_gate_and_counts():
    nodes = tmi.build_levels(_t(_words(16, 11)))
    stale = nodes.clone()
    stale[16:] = 0
    count = torch.tensor([3], dtype=torch.int32)
    assert torch.equal(tmi.merkle_levels(stale.clone(), count, dense=3), stale)  # 3 <= 3: sparse
    assert torch.equal(tmi.merkle_levels(stale.clone(), count, dense=2), nodes)
    assert tmi.inc_update_hashes(20, 4096, 3) == jmi.inc_update_hashes(20, 4096, 3)
    assert [tmi.level_offset(4, k) for k in range(5)] == [0, 16, 24, 28, 30]


def test_jitted_jax_kernel_matches():
    """The JAX package's own jitted single-device kernel, as the resident
    loop composes it, agrees with the port's forest_apply."""
    depth, cap = 6, 8
    dense = 5
    leaves = _words(1 << depth, 12)
    new = leaves.copy()
    new[[0, 1, 63]] ^= np.uint32(7)
    mask = (new != leaves).any(axis=1)
    forest = np.asarray(jmi.build_forest(jnp.asarray(leaves), 1))
    run = jmi._apply_kernel(depth, cap, dense)
    want_nodes, want_root = run(jax.device_put(forest), jnp.asarray(mask[None]), jnp.asarray(new[None]))
    new_t = _t(new)
    got_nodes, got_root = tmi.forest_apply(_t(forest), torch.from_numpy(mask[None]), (new_t[None],),
                                           lambda inputs, i: inputs[0][i.to(torch.int64)], cap, dense)
    assert np.array_equal(to_numpy(got_nodes), np.asarray(want_nodes))
    assert np.array_equal(to_numpy(got_root), np.asarray(want_root))
