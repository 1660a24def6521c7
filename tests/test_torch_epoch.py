"""Port parity: the altair+ accounting epoch (eth_consensus_specs_tpu_torch/ops/altair_epoch.py,
ops/state_columns.py, lanes.py) against the JAX package, bit for bit."""

import numpy as np
import pytest

import __graft_entry__ as graft
from eth_consensus_specs_tpu.forks import get_spec
from eth_consensus_specs_tpu.ops.altair_epoch import AltairEpochParams, altair_epoch_accounting
from eth_consensus_specs_tpu.ops.state_columns import isqrt_u64
from eth_consensus_specs_tpu_torch import lanes
from eth_consensus_specs_tpu_torch.config import epoch_params
from eth_consensus_specs_tpu_torch.convert import columns_from_numpy, tensor_from_numpy, to_numpy
from eth_consensus_specs_tpu_torch.inputs import ALTAIR_CORNERS, altair_corner_inputs, example_altair_inputs
from eth_consensus_specs_tpu_torch.ops import altair_epoch as tae
from eth_consensus_specs_tpu_torch.ops.state_columns import isqrt_u64 as port_isqrt

FAR = np.iinfo(np.uint64).max


@pytest.fixture(scope="module")
def jax_params():
    return {fork: AltairEpochParams.from_spec(get_spec(fork, "mainnet"))
            for fork in ("deneb", "electra")}



def _inputs(n, fork, epoch=10):
    cols, just = graft._example_altair_inputs(n, epoch=epoch, electra=fork == "electra")
    return cols, just


def _assert_same(jax_params, fork, cols, just, fn=tae.altair_epoch_accounting_ref):
    want = altair_epoch_accounting(jax_params[fork], cols, just)
    pc, pj = columns_from_numpy(cols, just, "cpu")
    got = to_numpy(fn(epoch_params(fork, "mainnet"), pc, pj))
    for name in want._fields:
        assert np.array_equal(np.asarray(getattr(want, name)), getattr(got, name)), name


@pytest.mark.parametrize("fork", ["deneb", "electra"])
@pytest.mark.parametrize("n", [64, 1000])
def test_accounting_matches_jax(jax_params, fork, n):
    _assert_same(jax_params, fork, *_inputs(n, fork))


@pytest.mark.parametrize("fork", ["deneb", "electra"])
def test_dispatch_on_cpu_is_plain_version(jax_params, fork):
    _assert_same(jax_params, fork, *_inputs(64, fork), fn=tae.altair_epoch_accounting)


@pytest.mark.parametrize("epoch", [0, 1, 2])
@pytest.mark.parametrize("fork", ["deneb", "electra"])
def test_genesis_epochs(jax_params, fork, epoch):
    cols, just = _inputs(64, fork, epoch=max(epoch, 3))
    just = just._replace(current_epoch=np.uint64(epoch),
                         prev_justified_epoch=np.uint64(0), cur_justified_epoch=np.uint64(0),
                         finalized_epoch=np.uint64(0))
    _assert_same(jax_params, fork, cols, just)


@pytest.mark.parametrize("fork", ["deneb", "electra"])
def test_all_slashed(jax_params, fork):
    cols, just = _inputs(64, fork)
    n = cols.slashed.shape[0]
    wd = np.where(np.arange(n) % 2 == 0, np.uint64(10 + 4096), np.uint64(10 + 4)).astype(np.uint64)
    _assert_same(jax_params, fork, cols._replace(slashed=np.ones(n, bool), withdrawable_epoch=wd), just)


@pytest.mark.parametrize("fork", ["deneb", "electra"])
def test_inactivity_leak(jax_params, fork):
    cols, just = _inputs(64, fork, epoch=100)
    just = just._replace(justification_bits=np.zeros(4, bool), prev_justified_epoch=np.uint64(3),
                         cur_justified_epoch=np.uint64(3), finalized_epoch=np.uint64(3))
    _assert_same(jax_params, fork, cols, just)
    # still leaking after this epoch's justification: no score falls by more than 1
    got = to_numpy(tae.altair_epoch_accounting_ref(epoch_params(fork, "mainnet"),
                                                   *columns_from_numpy(cols, just, "cpu")))
    assert got.finalized_epoch == 3
    assert (got.inactivity_scores + 1 >= cols.inactivity_scores).all()
    assert (got.inactivity_scores > cols.inactivity_scores).any()


@pytest.mark.parametrize("fork", ["deneb", "electra"])
def test_far_future_and_wide_values(jax_params, fork):
    """FAR_FUTURE_EPOCH in every epoch column, and scores and slashings wide
    enough that the u64 products pass 2**63 (unsigned division on the port)."""
    cols, just = _inputs(64, fork)
    n = cols.balance.shape[0]
    idx = np.arange(n)
    act = np.where(idx % 5 == 0, FAR, cols.activation_epoch).astype(np.uint64)
    scores = np.where(idx % 3 == 0, np.uint64(2**40), cols.inactivity_scores).astype(np.uint64)
    cols = cols._replace(activation_epoch=act, inactivity_scores=scores)
    just = just._replace(slashings_sum=np.uint64(2**62))
    _assert_same(jax_params, fork, cols, just)


@pytest.mark.parametrize("fork", ["deneb", "electra"])
@pytest.mark.parametrize("case", ALTAIR_CORNERS)
def test_corner_inputs_match_jax(jax_params, fork, case):
    """The corners that the card tests and chip_smoke.py hold the kernel to,
    through the JAX package and the port's plain version."""
    cols, just = to_numpy(altair_corner_inputs(case, 64, electra=fork == "electra", device="cpu"))
    _assert_same(jax_params, fork, cols, just)
    if case == "leak":
        got = to_numpy(tae.altair_epoch_accounting_ref(epoch_params(fork, "mainnet"),
                                                       *columns_from_numpy(cols, just, "cpu")))
        assert got.finalized_epoch == 3
        assert (got.inactivity_scores + 1 >= cols.inactivity_scores).all()


@pytest.mark.parametrize("fork", ["deneb", "electra"])
@pytest.mark.parametrize("n", [64, 1000])
def test_example_inputs_match_graft_entry(fork, n):
    cols, just = graft._example_altair_inputs(n, electra=fork == "electra")
    pc, pj = to_numpy(example_altair_inputs(n, electra=fork == "electra", device="cpu"))
    for name in cols._fields:
        want = getattr(cols, name)
        if want is None:
            assert getattr(pc, name) is None
        else:
            assert np.array_equal(np.asarray(want), getattr(pc, name)), name
    for name in just._fields:
        assert np.array_equal(np.asarray(getattr(just, name)), getattr(pj, name)), name


ISQRT_CASES = [0, 1, 2, 3, 4, 2**32 - 1, 2**32, 2**63, 2**64 - 1] + [
    k * k + d for k in (3, 65535, 2**31 + 5, 2**32 - 1) for d in (-1, 0, 1)
]


def test_isqrt_matches_jax():
    x = np.array(ISQRT_CASES, np.uint64)
    want = np.asarray(isqrt_u64(x))
    got = to_numpy(port_isqrt(tensor_from_numpy(x, "cpu")))
    assert np.array_equal(got, want)
    assert all(int(r) == __import__("math").isqrt(int(v)) for r, v in zip(got, x))


@pytest.fixture(scope="module")
def u64_pairs():
    rng = np.random.default_rng(99)
    a = rng.integers(0, 2**64, 4096, dtype=np.uint64)
    b = rng.integers(1, 2**63, 4096, dtype=np.uint64)
    b[:1024] = rng.integers(1, 2**20, 1024).astype(np.uint64)
    a[:4] = [0, 2**63, 2**64 - 1, 2**63 - 1]
    return a, b


def test_udiv64_and_umod64(u64_pairs):
    a, b = u64_pairs
    ta, tb = tensor_from_numpy(a, "cpu"), tensor_from_numpy(b, "cpu")
    assert np.array_equal(to_numpy(lanes.udiv64(ta, tb)), a // b)
    assert np.array_equal(to_numpy(lanes.umod64(ta, tb)), a % b)


def test_unsigned_compares(u64_pairs):
    a, b = u64_pairs
    ta, tb = tensor_from_numpy(a, "cpu"), tensor_from_numpy(b, "cpu")
    assert np.array_equal(lanes.ult64(ta, tb).numpy(), a < b)
    assert np.array_equal(lanes.ule64(ta, tb).numpy(), a <= b)
    assert np.array_equal(lanes.ult64(ta, ta).numpy(), np.zeros(a.shape, bool))
    assert np.array_equal(to_numpy(lanes.umin64(ta, tb)), np.minimum(a, b))
    assert np.array_equal(to_numpy(lanes.umax64(ta, tb)), np.maximum(a, b))
