"""Port parity: the block-epoch plane (``ops/block_epoch.py``: K19's plain version
``block_slot_ref``, the chain and its per-slot roots; the numpy and hashlib oracle
``ops/block_epoch_host.py``) against the JAX package's ``ops/block_epoch.py`` on the
CPU. Every comparison is exact: u64 balances, u8 participation flags, the withdrawal
pointers and the root chain as u32 words.

The JAX chain with roots is one module-scoped run (deneb mainnet, 2^10 validators, 32
slots of 8 rows); the JAX slot function compiles once for every corner."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import __graft_entry__ as graft
from eth_consensus_specs_tpu.forks import get_spec
from eth_consensus_specs_tpu.ops import block_epoch as jbe
from eth_consensus_specs_tpu.ops.state_root import synthetic_static as jax_synthetic_static
from eth_consensus_specs_tpu.test_infra.context import spec_state_test, with_phases
from eth_consensus_specs_tpu_torch import config, convert
from eth_consensus_specs_tpu_torch.inputs import BLOCK_SLOT_CORNERS, block_slot_corners
from eth_consensus_specs_tpu_torch.ops import block_epoch as tbe
from eth_consensus_specs_tpu_torch.ops import block_epoch_host as tbeh
from eth_consensus_specs_tpu_torch.ops.state_root import synthetic_static
from tests.test_block_epoch import _build_epoch_blocks, _static_from_state

N = 1 << 10
ATTS = 8
SEED = 3


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def spec():
    return get_spec("deneb", "mainnet")


@pytest.fixture(scope="module")
def params():
    return config.block_epoch_params("deneb", "mainnet")


@pytest.fixture(scope="module")
def jax_epoch(spec):
    return jbe.synthetic_block_columns(spec, N, seed=SEED, atts_per_slot=ATTS)


@pytest.fixture(scope="module")
def port_epoch(params):
    return tbe.synthetic_block_columns(params, N, seed=SEED, atts_per_slot=ATTS, device="cpu")


@pytest.fixture(scope="module")
def scores():
    return np.random.default_rng(9).integers(0, 50, N, dtype=np.int64).astype(np.uint64)


@pytest.fixture(scope="module")
def jax_chain(spec, jax_epoch, scores):
    """The JAX chain with a root every slot, as tests/test_block_epoch.py runs it."""
    cols, st0, static = jax_epoch
    _, just = graft._example_altair_inputs(N)
    arrays, meta = jax_synthetic_static(spec, N)
    ctx = jbe.make_root_ctx(spec, arrays, meta, static, jnp.asarray(scores), just)
    st, acc = jbe.block_epoch_chain(jbe.BlockEpochParams.from_spec(spec), N, st0, cols, static,
                                    root_ctx=ctx)
    return st, np.asarray(acc)


@pytest.fixture(scope="module")
def root_inputs(scores):
    """The port's static tree, scores and justification state of the same epoch."""
    arrays, meta = synthetic_static(N, device="cpu", fork="deneb")
    cols, just = graft._example_altair_inputs(N)
    _, just = convert.columns_from_numpy(cols, just, "cpu")
    return arrays, meta, convert.tensor_from_numpy(scores, "cpu"), just


@pytest.fixture(scope="module")
def port_chain(params, port_epoch, root_inputs):
    cols, st0, static = port_epoch
    arrays, meta, scores, just = root_inputs
    ctx = tbe.make_root_ctx("deneb", arrays, meta, static, scores, just)
    return tbe.block_epoch_chain(params, N, st0, cols, static, root_ctx=ctx, device="cpu")


def _assert_state_equal(got, want, pointers=True):
    names = ("balance", "cur_part", "prev_part")
    names += ("next_wd_index", "next_wd_validator") if pointers else ()
    for name in names:
        assert np.array_equal(convert.to_numpy(getattr(got, name)),
                              np.asarray(getattr(want, name))), name


def test_block_epoch_params_are_the_spec_constants(params, spec):
    import dataclasses

    assert dataclasses.asdict(params) == dataclasses.asdict(jbe.BlockEpochParams.from_spec(spec))


def test_synthetic_block_columns_are_the_jax_columns(jax_epoch, port_epoch):
    for got, want in zip(port_epoch, jax_epoch):
        for name in want._fields:
            g, w = convert.to_numpy(getattr(got, name)), np.asarray(getattr(want, name))
            assert g.dtype.itemsize == w.dtype.itemsize and np.array_equal(g, w), name
    far = convert.to_numpy(port_epoch[2].withdrawable_epoch)
    assert (far == np.uint64(2**64 - 1)).mean() > 0.99


def test_chain_with_roots_equals_the_jax_chain(port_chain, jax_chain):
    (st, acc), (jst, jacc) = port_chain, jax_chain
    _assert_state_equal(st, jst)
    assert np.array_equal(convert.to_numpy(acc), jacc)
    assert int(st.next_wd_index) > 0 and np.any(jacc)


def test_chain_without_withdrawals_equals_the_jax_chain(spec, params, jax_epoch, port_epoch):
    cols, st0, static = jax_epoch
    jst, _ = jbe.block_epoch_chain(jbe.BlockEpochParams.from_spec(spec), N, st0, cols, static,
                                   with_withdrawals=False)
    cols, st0, static = port_epoch
    st, acc = tbe.block_epoch_chain(params, N, st0, cols, static, with_withdrawals=False,
                                    device="cpu")
    _assert_state_equal(st, jst)
    assert int(st.next_wd_index) == 0 and not acc.any()


def test_numpy_oracle_equals_the_chain(params, port_epoch, port_chain, root_inputs):
    cols, st0, static = port_epoch
    root_fn = tbeh.slot_root_fn_np("deneb", *root_inputs[:2], static, *root_inputs[2:])
    bal, cur, prev, wdi, wdv, acc = tbeh.replay_block_epoch_np(
        params, N, st0, cols, static.eff_balance, static.withdrawable_epoch,
        static.has_eth1_cred, int(static.epoch), root_fn=root_fn)
    st, chain_acc = port_chain
    assert np.array_equal(bal, convert.to_numpy(st.balance))
    assert np.array_equal(cur, convert.to_numpy(st.cur_part))
    assert np.array_equal(prev, convert.to_numpy(st.prev_part))
    assert (wdi, wdv) == (int(st.next_wd_index), int(st.next_wd_validator))
    assert np.array_equal(acc, convert.to_numpy(chain_acc))


def _extracted_parity(spec, state, with_withdrawals):
    """JAX's extract_block_columns on real blocks, then the port's chain against
    the JAX chain and the object path's post-state."""
    pre = state.copy()
    blocks = _build_epoch_blocks(spec, state)
    jparams = jbe.BlockEpochParams.from_spec(spec)
    n = len(pre.validators)
    jcols, jst0 = jbe.extract_block_columns(spec, pre, blocks)
    jstatic = _static_from_state(spec, jparams, pre)[0]
    jst, _ = jbe.block_epoch_chain(jparams, n, jst0, jcols, jstatic,
                                   with_withdrawals=with_withdrawals)
    params = config.block_epoch_params(spec.fork_name, spec.config.PRESET_BASE)
    st, _ = tbe.block_epoch_chain(
        params, n, convert.block_state_from_jax(jst0, "cpu"),
        convert.block_columns_from_jax(jcols, "cpu"),
        convert.block_static_from_jax(jstatic, "cpu"), with_withdrawals=with_withdrawals,
        device="cpu")
    _assert_state_equal(st, jst, pointers=with_withdrawals)
    assert np.array_equal(convert.to_numpy(st.balance),
                          np.array([int(b) for b in state.balances], np.uint64))
    assert np.array_equal(convert.to_numpy(st.cur_part),
                          np.array([int(f) for f in state.current_epoch_participation], np.uint8))
    return jcols


@with_phases(["altair"])
@spec_state_test
def test_chain_on_extracted_altair_blocks(spec, state):
    _extracted_parity(spec, state, with_withdrawals=False)


@with_phases(["electra"])
@spec_state_test
def test_chain_on_extracted_electra_aggregates(spec, state):
    """EIP-7549 on-chain aggregates expand into per-committee rows that share a
    numerator up to their pay row."""
    jcols = _extracted_parity(spec, state, with_withdrawals=True)
    assert not np.asarray(jcols.att_pay).all()


@pytest.fixture(scope="module")
def corners(params):
    return block_slot_corners(params, N, atts_per_slot=ATTS, device="cpu")


@pytest.fixture(scope="module")
def jax_slot_fn(spec):
    return jax.jit(functools.partial(jbe.process_slot_columnar, jbe.BlockEpochParams.from_spec(spec),
                                     N))


@pytest.mark.parametrize("case", BLOCK_SLOT_CORNERS)
def test_block_slot_ref_corner_equals_jax(case, params, corners, jax_slot_fn):
    st, slot, static = corners[case]
    u = convert.to_numpy
    jst = jbe.BlockState(u(st.balance), u(st.cur_part), u(st.prev_part),
                         jnp.uint64(int(u(st.next_wd_index))),
                         jnp.uint64(int(u(st.next_wd_validator))))
    want = jax_slot_fn(jst, tuple(u(t) for t in slot), *(u(t) for t in static))
    scal = tbe._scalars(st)
    bal, cur, prev = (t.clone() for t in (st.balance, st.cur_part, st.prev_part))
    tbe.block_slot_ref(params, N, bal, cur, prev, scal, slot, static)
    _assert_state_equal(tbe.BlockState(bal, cur, prev, scal[0], scal[1]), want)
    if case == "pay_runs":
        assert int(scal[2]) != 0  # the numerator left after the last, unpaid row
    if case == "partial_payload":
        assert int(scal[0]) == 1005
    if case == "high_balances":
        assert int(u(want.balance)[int(slot.proposer)]) < 1 << 63  # the proposer wrapped


def test_corners_differ_from_the_cell(corners):
    cell = corners["cell"]
    for case in BLOCK_SLOT_CORNERS[1:]:
        assert any(not torch.equal(a, b) for x, y in zip(corners[case], cell)
                   for a, b in zip(x, y)), case


def test_bad_indices_raise(params, port_epoch):
    cols, st0, static = port_epoch
    for field, value in (("att_idx", N + 1), ("dep_idx", -1), ("sync_idx", N), ("proposer", N)):
        t = getattr(cols, field).clone()
        t.reshape(-1)[0] = value
        with pytest.raises(ValueError):
            tbe.block_epoch_chain(params, N, st0, cols._replace(**{field: t}), static,
                                  device="cpu")


def test_pre_capella_sweep_raises(port_epoch):
    cols, st0, static = port_epoch
    altair = config.block_epoch_params("altair", "mainnet")
    with pytest.raises(ValueError):
        tbe.block_epoch_chain(altair, N, st0, cols, static, device="cpu")


def test_chain_without_a_device_raises_where_cuda_is_absent(params, port_epoch, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cols, st0, static = port_epoch
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tbe.block_epoch_chain(params, N, st0, cols, static)
    assert int(st0.next_wd_index) == 0  # the caller's state is untouched


def test_chain_leaves_the_callers_state(port_epoch, port_chain):
    _, st0, _ = port_epoch
    st, _ = port_chain
    assert not torch.equal(st.balance, st0.balance)
    assert int(st0.next_wd_validator) == 0
