"""Port parity: the incremental forest half of the state root
(eth_consensus_specs_tpu_torch/ops/state_root.py: forest_plan, build_state_forest,
post_epoch_state_root_inc, state_root_from_forest) against the JAX package on the
same seeded inputs, bit for bit in every forest buffer and root; and the
incremental root against the port's own full recompute."""

from functools import lru_cache

import jax
import numpy as np
import pytest

import __graft_entry__ as graft
from eth_consensus_specs_tpu.forks import get_spec
from eth_consensus_specs_tpu.ops import state_root as jsr
from eth_consensus_specs_tpu.parallel import resident as jres
from eth_consensus_specs_tpu_torch import convert
from eth_consensus_specs_tpu_torch.ops import state_root as tsr
from eth_consensus_specs_tpu_torch.parallel import resident as tres

GWEI = 10**9


@lru_cache(maxsize=None)
def _jax_inc_root(meta, plan):
    """JAX post_epoch_state_root_inc jitted once per registry shape."""
    return jax.jit(lambda a, f, ob, oe, os, b, e, s, j: jsr.post_epoch_state_root_inc(
        a, meta, plan, f, ob, oe, os, b, e, s, j))


@pytest.fixture(scope="module")
def specs():
    return {fork: get_spec(fork, "mainnet") for fork in ("deneb", "electra")}


def _world(spec, n, electra=False, seed=3):
    cols, just = graft._example_altair_inputs(n, electra=electra)
    static = jsr.synthetic_static(spec, n, seed=seed)
    pc, pj = convert.columns_from_numpy(cols, just, "cpu")
    return cols, just, static, pc, pj, convert.static_from_numpy(*static, "cpu")


def _assert_forests_equal(want, got):
    got = convert.to_numpy(got)
    for name in want._fields:
        a, b = getattr(want, name), getattr(got, name)
        assert (a is None) == (b is None), name
        if a is not None:
            assert np.array_equal(np.asarray(a), b), name


@pytest.mark.parametrize("n", [64, 1000, 4096])
def test_forest_plan_matches_jax(specs, n):
    static = jsr.synthetic_static(specs["deneb"], n)
    want = jsr.forest_plan(static[1])
    got = tsr.forest_plan(convert.static_from_numpy(*static, "cpu")[1])
    assert tuple(got) == tuple(want)
    # the capacity model charges less than the full recompute (the JAX
    # package's count differs: its tree reduction pads its last levels)
    assert 0 < tsr.state_root_inc_real_hashes(static[1], got) < tsr.state_root_real_hashes(static[1])
    assert tuple(tsr.forest_plan(static[1], dirty_cap=64)) == tuple(
        jsr.forest_plan(static[1], dirty_cap=64))


@pytest.mark.parametrize("fork,n", [("deneb", 64), ("electra", 64)])
def test_build_state_forest_matches_jax(specs, fork, n):
    cols, just, static, pc, pj, ps = _world(specs[fork], n, electra=fork == "electra")
    want, want_plan = jres.build_state_forest_device(static, cols)
    got, plan = tres.build_state_forest_device(ps, pc, device="cpu")
    assert tuple(plan) == tuple(want_plan)
    _assert_forests_equal(want, got)
    # the forest's root is the full path's root of the same columns
    root = tsr.state_root_from_forest(ps[0], ps[1], plan, got, pj)
    full = tsr.post_epoch_state_root(*ps, pc.balance, pc.effective_balance, pc.inactivity_scores, pj)
    assert np.array_equal(convert.to_numpy(root), convert.to_numpy(full))
    jroot = jax.jit(lambda a, f, j: jsr.state_root_from_forest(a, static[1], want_plan, f, j))(
        static[0], want, just)
    assert np.array_equal(convert.to_numpy(root), np.asarray(jroot))


def _next_columns(cols, n, case):
    """Post-epoch columns: the balance and score columns move everywhere;
    the registry's effective balances cross the hysteresis at two
    validators ("few": the sparse branch) or at a third of them ("many":
    past the crossover, the dense branch)."""
    rng = np.random.default_rng(n)
    bal = np.asarray(cols.balance) + rng.integers(0, 5000, n).astype(np.uint64)
    scores = np.asarray(cols.inactivity_scores) + (np.arange(n) % 2).astype(np.uint64)
    eff = np.asarray(cols.effective_balance).copy()
    crossed = [1, n // 2] if case == "few" else slice(None, None, 3)
    eff[crossed] -= np.uint64(GWEI)
    return bal, eff, scores


@pytest.mark.parametrize("n", [64, 1000])
@pytest.mark.parametrize("case", ["few", "many"])
def test_post_epoch_state_root_inc_matches_jax_and_full(specs, n, case):
    cols, just, static, pc, pj, ps = _world(specs["deneb"], n)
    bal, eff, scores = _next_columns(cols, n, case)
    forest, plan = jres.build_state_forest_device(static, cols)
    want_forest, want_root = _jax_inc_root(static[1], plan)(static[0], forest, cols.balance, cols.effective_balance,
                                 cols.inactivity_scores, bal, eff, scores, just)

    built, built_plan = tres.build_state_forest_device(ps, pc, device="cpu")
    _assert_forests_equal(forest, built)  # the ingest, at n = 1000 too
    # both packages update the same forest: JAX's, carried across
    tforest, tplan = convert.forest_from_numpy(forest, "cpu"), convert.plan_from_numpy(plan)
    assert tplan == built_plan
    t = lambda a: convert.tensor_from_numpy(a, "cpu")  # noqa: E731
    got_forest, got_root = tsr.post_epoch_state_root_inc(
        *ps[:2], tplan, tforest, pc.balance, pc.effective_balance, pc.inactivity_scores,
        t(bal), t(eff), t(scores), pj)
    assert got_forest is tforest  # updated in place
    _assert_forests_equal(want_forest, got_forest)
    assert np.array_equal(convert.to_numpy(got_root), np.asarray(want_root))
    full = tsr.post_epoch_state_root(*ps, t(bal), t(eff), t(scores), pj)
    assert np.array_equal(convert.to_numpy(got_root), convert.to_numpy(full))
    # which branch the validator tree took
    dirty = int((eff != np.asarray(cols.effective_balance)).sum())
    assert (dirty <= plan.dense_val) == (case == "few")


def test_plain_path_equals_dispatch_on_cpu(specs):
    _, _, _, pc, pj, ps = _world(specs["deneb"], 64)
    a = tsr.build_state_forest(*ps, tsr.forest_plan(ps[1]), pc.balance, pc.effective_balance,
                               pc.inactivity_scores)
    b = tsr.build_state_forest(*ps, tsr.forest_plan(ps[1]), pc.balance, pc.effective_balance,
                               pc.inactivity_scores, tsr.PLAIN)
    _assert_forests_equal(convert.to_numpy(a), b)
