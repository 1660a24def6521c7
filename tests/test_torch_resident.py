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
from eth_consensus_specs_tpu_torch.parallel import resident as tres

N = 64


@pytest.fixture(scope="module")
def case():
    spec = get_spec("deneb", "mainnet")
    cols, just = graft._example_altair_inputs(N)
    static = synthetic_static(spec, N, seed=11)
    port_cols, port_just = convert.columns_from_numpy(cols, just, "cpu")
    port_static = convert.static_from_numpy(*static, "cpu")
    return spec, (cols, just, static), (port_cols, port_just, port_static)



def _assert_carries_equal(want, got):
    got = convert.to_numpy(got)
    assert np.array_equal(np.asarray(want.root_acc), got.root_acc), "root_acc"
    for name in ("balance", "effective_balance", "inactivity_scores"):
        assert np.array_equal(np.asarray(getattr(want.cols, name)), getattr(got.cols, name)), name
    for name in want.just._fields:
        assert np.array_equal(np.asarray(getattr(want.just, name)), getattr(got.just, name)), name


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
    with pytest.raises(NotImplementedError, match="next slice"):
        tres.run_epochs(params, pc, pj, 1, with_root="state_inc", static=ps, device="cpu")
    with pytest.raises(ValueError):
        tres.run_epochs(params, pc, pj, 1, with_root="bogus", device="cpu")
    with pytest.raises(ValueError):
        tres.run_epochs(params, pc, pj, 1, with_root="state", device="cpu")
    odd = pc._replace(**{f: getattr(pc, f)[:40] for f in pc._fields if getattr(pc, f) is not None})
    with pytest.raises(ValueError):
        tres.run_epochs(params, odd, pj, 1, with_root=True, device="cpu")
