"""Port parity: the full post-epoch BeaconState root
(eth_consensus_specs_tpu_torch/ops/state_root.py) against the JAX package on the same
inputs, with JAX's synthetic_static carried across by convert.py, bit for bit."""

import functools

import jax
import numpy as np
import pytest

import __graft_entry__ as graft
from eth_consensus_specs_tpu.forks import get_spec
from eth_consensus_specs_tpu.ops import state_root as jsr
from eth_consensus_specs_tpu_torch import convert
from eth_consensus_specs_tpu_torch.ops import state_root as tsr
from eth_consensus_specs_tpu_torch.ops.sha256 import sha256_pairs_ref


@pytest.fixture(scope="module")
def specs():
    return {fork: get_spec(fork, "mainnet") for fork in ("deneb", "electra")}



def _case(spec, n, seed=0):
    cols, just = graft._example_altair_inputs(n)
    arrays, meta = jsr.synthetic_static(spec, n, seed=seed)
    # a few slashed validators, so the slashed chunk is not all zero
    slashed = np.zeros((n, 8), np.uint32)
    slashed[np.flatnonzero(cols.slashed), 0] = 0x01000000
    arrays = arrays._replace(slashed_chunk=jax.numpy.asarray(slashed))
    return cols, just, arrays, meta


def _jax_root(arrays, meta, cols, just):
    fn = jax.jit(lambda a, b, e, s, j: jsr._post_epoch_state_root_impl(a, meta, b, e, s, j))
    return np.asarray(fn(arrays, cols.balance, cols.effective_balance, cols.inactivity_scores, just))


def _port_root(arrays, meta, cols, just, fn=tsr.post_epoch_state_root):
    pa, pm = convert.static_from_numpy(arrays, meta, "cpu")
    pc, pj = convert.columns_from_numpy(cols, just, "cpu")
    root = fn(pa, pm, pc.balance, pc.effective_balance, pc.inactivity_scores, pj)
    return convert.to_numpy(root)


@pytest.mark.parametrize("n", [64, 1000, 1024])
def test_state_root_matches_jax(specs, n):
    cols, just, arrays, meta = _case(specs["deneb"], n)
    assert np.array_equal(_port_root(arrays, meta, cols, just), _jax_root(arrays, meta, cols, just))


def test_electra_state_root_matches_jax(specs):
    cols, just, arrays, meta = _case(specs["electra"], 64, seed=5)
    assert meta.top_depth == 6
    assert np.array_equal(_port_root(arrays, meta, cols, just), _jax_root(arrays, meta, cols, just))


def test_plain_path_equals_dispatch_on_cpu(specs):
    cols, just, arrays, meta = _case(specs["deneb"], 64)
    assert np.array_equal(_port_root(arrays, meta, cols, just, tsr.post_epoch_state_root_ref),
                          _port_root(arrays, meta, cols, just))


@pytest.mark.parametrize("fork", ["deneb", "electra"])
def test_synthetic_static_layout_matches_jax(specs, fork):
    _, meta = jsr.synthetic_static(specs[fork], 64)
    arrays, pmeta = tsr.synthetic_static(64, seed=0, device="cpu", fork=fork)
    assert pmeta.dynamic_slots == meta.dynamic_slots
    assert pmeta.top_depth == meta.top_depth and pmeta.n_validators == 64
    assert arrays.top_chunks.shape == (1 << meta.top_depth, 8)
    assert arrays.zerohashes.shape == (42, 8)


@pytest.mark.parametrize("n", [64, 1000])
def test_real_hashes_count_what_runs(specs, n):
    """state_root_real_hashes equals the messages the path actually hashes."""
    cols, just, arrays, meta = _case(specs["deneb"], n)
    pa, pm = convert.static_from_numpy(arrays, meta, "cpu")
    pc, pj = convert.columns_from_numpy(cols, just, "cpu")
    count = [0]

    def sha(words):
        count[0] += words.shape[0]
        return sha256_pairs_ref(words)

    def tree(leaves, depth):
        count[0] += (1 << depth) - 1
        return tsr.PLAIN.tree_root(leaves, depth)

    def leaves(eff, *rest):
        count[0] += 3 * eff.shape[0]
        return tsr.PLAIN.validator_leaves(eff, *rest)

    # the list roots are one K2 call; its plain twin hashes through the same hooks
    lists = functools.partial(tsr.PLAIN.list_roots, sha=sha, tree=tree)
    h = tsr.PLAIN._replace(tree_root=tree, validator_leaves=leaves, list_roots=lists)
    tsr._post_epoch_state_root(h, pa, pm, pc.balance, pc.effective_balance, pc.inactivity_scores,
                               pj)
    assert count[0] == tsr.state_root_real_hashes(pm)
