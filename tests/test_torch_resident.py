"""Port parity for the slice as a whole: the port's run_epochs
(eth_consensus_specs_tpu_torch/parallel/resident.py) on the CPU against the JAX
package's resident.run_epochs, deneb mainnet, bit for bit in root_acc, the columns
and every justification output."""

import numpy as np
import pytest
import torch

import __graft_entry__ as graft
from eth_consensus_specs_tpu.forks import get_spec
from eth_consensus_specs_tpu.ops.state_root import synthetic_static
from eth_consensus_specs_tpu.parallel import resident as jres
from eth_consensus_specs_tpu_torch import convert
from eth_consensus_specs_tpu_torch.config import epoch_params
from eth_consensus_specs_tpu_torch.inputs import lower_balances
from eth_consensus_specs_tpu_torch.parallel import resident as tres

N = 64


def _case(n):
    spec = get_spec("deneb", "mainnet")
    cols, just = graft._example_altair_inputs(n)
    static = synthetic_static(spec, n, seed=11)
    port_cols, port_just = convert.columns_from_numpy(cols, just, "cpu")
    port_static = convert.static_from_numpy(*static, "cpu")
    return spec, (cols, just, static), (port_cols, port_just, port_static)


@pytest.fixture(scope="module")
def case():
    return _case(N)


@pytest.fixture(scope="module")
def case_1000():
    return _case(1000)



def _assert_carries_equal(want, got):
    got = convert.to_numpy(got)
    assert np.array_equal(np.asarray(want.root_acc), got.root_acc), "root_acc"
    for name in ("balance", "effective_balance", "inactivity_scores"):
        assert np.array_equal(np.asarray(getattr(want.cols, name)), getattr(got.cols, name)), name
    for name in want.just._fields:
        assert np.array_equal(np.asarray(getattr(want.just, name)), getattr(got.just, name)), name
    if want.forest is not None:
        for name in want.forest._fields:
            a, b = getattr(want.forest, name), getattr(got.forest, name)
            assert np.array_equal(np.asarray(a), b), f"forest.{name}"


@pytest.mark.parametrize(
    "with_root,epochs",
    [(False, 1), (False, 3), (True, 1), (True, 2), (True, 3), ("state", 1), ("state", 2), ("state", 3)],
)
def test_run_epochs_matches_jax(case, with_root, epochs):
    spec, (cols, just, static), (pc, pj, ps) = case
    want = jres.run_epochs(spec, cols, just, epochs, with_root=with_root, static=static)
    got = tres.run_epochs(epoch_params("deneb", "mainnet"), pc, pj, epochs, with_root=with_root,
                          static=ps, device="cpu")
    _assert_carries_equal(want, got)


@pytest.mark.parametrize("n", [64, 1000])
@pytest.mark.parametrize("epochs", [1, 2, 3])
def test_state_inc_matches_jax(case, case_1000, n, epochs):
    """The incremental forest path, bit for bit in root_acc, the columns,
    the justification state and every forest buffer; n = 1000 is not a
    power of two, so the leaf levels and the last chunk are padded."""
    spec, (cols, just, static), (pc, pj, ps) = case if n == 64 else case_1000
    want = jres.run_epochs(spec, cols, just, epochs, with_root="state_inc", static=static)
    got = tres.run_epochs(epoch_params("deneb", "mainnet"), pc, pj, epochs, with_root="state_inc",
                          static=ps, device="cpu")
    _assert_carries_equal(want, got)
    assert tuple(got.dirty.shape) == (epochs, 3)


def test_state_inc_equals_state_and_chains(case):
    """state_inc gives the full path's root_acc; 2 epochs equal 1 + 1 with
    the forest threaded through carry.forest and updated in place."""
    _, _, (pc, pj, ps) = case
    params = epoch_params("deneb", "mainnet")
    full = tres.run_epochs(params, pc, pj, 2, with_root="state", static=ps, device="cpu")
    two = tres.run_epochs(params, pc, pj, 2, with_root="state_inc", static=ps, device="cpu")
    assert torch.equal(two.root_acc, full.root_acc)
    forest, _ = tres.build_state_forest_device(ps, pc, device="cpu")
    one = tres.run_epochs(params, pc, pj, 1, with_root="state_inc", static=ps, device="cpu",
                          forest=forest)
    assert one.forest.val_nodes is forest.val_nodes  # in place, handed back
    again = tres.run_epochs(params, one.cols, one.just, 1, with_root="state_inc", static=ps,
                            device="cpu", forest=one.forest)
    assert torch.equal(two.root_acc, one.root_acc ^ again.root_acc)
    assert torch.equal(two.cols.balance, again.cols.balance)
    for name in ("val_nodes", "bal_nodes", "inact_nodes", "part_root"):
        assert torch.equal(getattr(two.forest, name), getattr(again.forest, name)), name
    ref = tres.run_epochs_ref(params, pc, pj, 2, with_root="state_inc", static=ps, device="cpu")
    assert torch.equal(ref.root_acc, two.root_acc) and torch.equal(ref.dirty, two.dirty)


def test_state_inc_dirty_registry_matches_jax(case):
    """Effective balances that cross the hysteresis: every 32nd validator's
    balance lowered by 2 ETH, so the validator tree's sparse path carries
    live dirty leaves (3 of 64 with the one the example columns cross
    anyway: the plan's dense count, the most the sparse branch takes)."""
    spec, (cols, just, static), (pc, pj, ps) = case
    low = lower_balances(pc, every=32)
    jcols = cols._replace(balance=convert.to_numpy(low.balance))
    want = jres.run_epochs(spec, jcols, just, 1, with_root="state_inc", static=static)
    got = tres.run_epochs(epoch_params("deneb", "mainnet"), low, pj, 1, with_root="state_inc",
                          static=ps, device="cpu")
    _assert_carries_equal(want, got)
    plan = tres.forest_plan_for(ps)
    assert 0 < int(got.dirty[0, 0]) <= plan.dense_val
    assert int(got.dirty[0, 0]) == int((low.effective_balance != got.cols.effective_balance).sum())


def test_plain_path_equals_run_epochs_on_cpu(case):
    _, _, (pc, pj, ps) = case
    params = epoch_params("deneb", "mainnet")
    a = tres.run_epochs(params, pc, pj, 2, with_root="state", static=ps, device="cpu")
    b = tres.run_epochs_ref(params, pc, pj, 2, with_root="state", static=ps, device="cpu")
    assert torch.equal(a.root_acc, b.root_acc)
    assert torch.equal(a.cols.balance, b.cols.balance)


def test_chaining(case):
    """run_epochs(2) == run_epochs(1) applied twice, roots folded by xor."""
    _, _, (pc, pj, ps) = case
    params = epoch_params("deneb", "mainnet")
    two = tres.run_epochs(params, pc, pj, 2, with_root=True, device="cpu")
    one = tres.run_epochs(params, pc, pj, 1, with_root=True, device="cpu")
    again = tres.run_epochs(params, one.cols, one.just, 1, with_root=True, device="cpu")
    assert torch.equal(two.cols.balance, again.cols.balance)
    assert torch.equal(two.root_acc, one.root_acc ^ again.root_acc)
    assert int(two.just.current_epoch) == int(pj.current_epoch) + 2


def test_modes_that_are_not_ported_or_wrong(case):
    _, _, (pc, pj, ps) = case
    params = epoch_params("deneb", "mainnet")
    with pytest.raises(ValueError):
        tres.run_epochs(params, pc, pj, 1, with_root="bogus", device="cpu")
    with pytest.raises(ValueError):
        tres.run_epochs(params, pc, pj, 1, with_root="state", device="cpu")
    odd = pc._replace(**{f: getattr(pc, f)[:40] for f in pc._fields if getattr(pc, f) is not None})
    with pytest.raises(ValueError):
        tres.run_epochs(params, odd, pj, 1, with_root=True, device="cpu")
