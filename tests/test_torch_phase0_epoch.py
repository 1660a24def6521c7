"""Port parity: the phase0 accounting epoch (eth_consensus_specs_tpu_torch/ops/state_columns.py
``epoch_accounting``, inputs.py ``example_inputs`` and the phase0 corners) against the JAX
package's ``epoch_accounting``, bit for bit."""

import ctypes

import numpy as np
import pytest
import torch

import __graft_entry__ as graft
from eth_consensus_specs_tpu.forks import get_spec
from eth_consensus_specs_tpu.ops import state_columns as jsc
from eth_consensus_specs_tpu_torch.config import phase0_epoch_params
from eth_consensus_specs_tpu_torch.convert import phase0_columns_from_numpy, to_numpy
from eth_consensus_specs_tpu_torch.inputs import PHASE0_CORNERS, example_inputs, phase0_corner_inputs
from eth_consensus_specs_tpu_torch.ops import state_columns as tsc

HALF = {"mainnet": 4096, "minimal": 32}  # EPOCHS_PER_SLASHINGS_VECTOR // 2


@pytest.fixture(scope="module")
def jax_params():
    return {p: jsc.EpochParams.from_spec(get_spec("phase0", p)) for p in HALF}


def _numpy(cols, just):
    """The port's CPU inputs as the JAX package's numpy layouts (the
    includer index stays signed, as the JAX columns carry it)."""
    ncols, njust = to_numpy(cols), to_numpy(just)
    return ncols._replace(incl_proposer=ncols.incl_proposer.view(np.int64)), njust


def _port_inputs(case, n, preset):
    if case == "example":
        return example_inputs(n, slashings_half_vector=HALF[preset], device="cpu")
    return phase0_corner_inputs(case, n, slashings_half_vector=HALF[preset], device="cpu")


def _assert_equal(want, got):
    for name in want._fields:
        assert np.array_equal(np.asarray(getattr(want, name)), getattr(got, name)), name


@pytest.mark.parametrize("epoch", [3, 10])
@pytest.mark.parametrize("n", [64, 1000])
def test_example_inputs_match_graft(n, epoch):
    want_cols, want_just = graft._example_inputs(n, epoch=epoch)
    cols, just = _numpy(*example_inputs(n, epoch=epoch, device="cpu"))
    _assert_equal(want_cols, cols)
    _assert_equal(want_just, just)
    assert cols.incl_proposer.dtype == np.asarray(want_cols.incl_proposer).dtype


@pytest.mark.parametrize("case", ("example",) + PHASE0_CORNERS)
@pytest.mark.parametrize("n", [64, 1000])
@pytest.mark.parametrize("preset", ["mainnet", "minimal"])
def test_epoch_matches_jax(jax_params, preset, n, case):
    cols, just = _port_inputs(case, n, preset)
    want = jsc.epoch_accounting(jax_params[preset], *_numpy(cols, just))
    got = to_numpy(tsc.epoch_accounting_ref(phase0_epoch_params(preset), cols, just))
    _assert_equal(want, got)


def test_dispatch_on_cpu_is_plain_version(jax_params):
    cols, just = example_inputs(64, device="cpu")
    want = jsc.epoch_accounting(jax_params["mainnet"], *_numpy(cols, just))
    _assert_equal(want, to_numpy(tsc.epoch_accounting(phase0_epoch_params("mainnet"), cols, just)))


def test_columns_from_jax_layout(jax_params):
    """The JAX package's own numpy columns, carried across by convert.py."""
    cols, just = graft._example_inputs(1000)
    want = jsc.epoch_accounting(jax_params["mainnet"], cols, just)
    got = tsc.epoch_accounting(phase0_epoch_params("mainnet"), *phase0_columns_from_numpy(cols, just, "cpu"))
    _assert_equal(want, to_numpy(got))


@pytest.mark.parametrize("preset", ["mainnet", "minimal"])
def test_chained_epochs_match_jax(jax_params, preset):
    """Three epochs, each feeding its balances, effective balances and
    justification state into the next (the epoch advancing by one)."""
    cols, just = example_inputs(1000, slashings_half_vector=HALF[preset], device="cpu")
    jcols, jjust = _numpy(cols, just)
    params = phase0_epoch_params(preset)
    for _ in range(3):
        want = jsc.epoch_accounting(jax_params[preset], jcols, jjust)
        got = tsc.epoch_accounting(params, cols, just)
        _assert_equal(want, to_numpy(got))
        carried = dict(zip(("justification_bits", "prev_justified_epoch", "prev_justified_root",
                            "cur_justified_epoch", "cur_justified_root", "finalized_epoch",
                            "finalized_root"), got[2:9]))
        cols = cols._replace(balance=got.balance, effective_balance=got.effective_balance)
        just = just._replace(current_epoch=just.current_epoch + 1, **carried)
        jcols = jcols._replace(balance=np.asarray(want.balance),
                               effective_balance=np.asarray(want.effective_balance))
        jjust = jjust._replace(current_epoch=np.uint64(jjust.current_epoch + 1),
                               **{k: np.asarray(getattr(want, k)) for k in carried})


def test_genesis_epoch_pays_nothing():
    cols, just = phase0_corner_inputs("epoch0", 64, device="cpu")
    got = tsc.epoch_accounting(phase0_epoch_params("mainnet"), cols, just)
    assert not got.rewards.any() and not got.penalties.any()


def test_proposer_scatter_clips_indices():
    """Includers below 0 land on validator 0, those past the registry on the
    last one, as the JAX scatter clips them."""
    n = 8
    cols, just = example_inputs(n, device="cpu")
    cols = cols._replace(slashed=torch.zeros(n, dtype=torch.bool), src_att=torch.ones(n, dtype=torch.bool),
                         incl_proposer=torch.tensor([-5, 100, 3, 3, 3, 3, 3, 3]))
    base = cols._replace(incl_proposer=torch.full((n,), 3))
    params = phase0_epoch_params("mainnet")
    got = tsc.epoch_accounting(params, cols, just).rewards
    ref = tsc.epoch_accounting(params, base, just).rewards
    assert torch.equal(got[1:3], ref[1:3]) and torch.equal(got[4:7], ref[4:7])
    assert got[0] > ref[0] and got[-1] > ref[-1] and got[3] < ref[3]
    assert int(got.sum()) == int(ref.sum())


def test_kernel_args_hold_every_address():
    """K9's argument block keeps each column, scalar and output address in
    its own slot, in the kernel's order, after the constants and the
    reciprocals of its three constant divisors."""
    cols, just = example_inputs(16, device="cpu")
    scratch = torch.zeros(8, dtype=torch.int64)
    out = tsc.EpochResult(*(torch.zeros(1) for _ in tsc.EpochResult._fields))
    params = phase0_epoch_params("mainnet")
    args = tsc.kernel_args(params, cols, just, scratch, out)
    fields = [name for name, _ in type(args)._fields_]
    addrs = [getattr(args, f) for f in fields[fields.index("n") + 1:]]
    want = [t.data_ptr() for t in (*cols, *just, scratch, *out)]
    assert addrs == want and len(set(want)) == len(want)
    assert tuple(tsc._COLUMN_DTYPES) == tsc.EpochColumns._fields
    assert tuple(tsc.JUST_DTYPES) == tsc.JustificationState._fields
    assert getattr(args, "n") == 16 and args.base_rewards_per_epoch == 4
    for name, d in (("d_incr", params.effective_balance_increment),
                    ("d_prq", params.proposer_reward_quotient),
                    ("d_ipq", params.inactivity_penalty_quotient)):
        div = getattr(args, name)
        assert (div.magic, div.sh1, div.sh2) == tsc.divisor_magic(d), name
    assert ctypes.sizeof(args) == 8 * (len(fields) - 3) + 16 * 3  # no padding
