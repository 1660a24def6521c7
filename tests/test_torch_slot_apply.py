"""Port parity: the slot-apply scatter (K18's plain version ``slot_apply_ref``,
the CPU route of ``ops/slot_pipeline.slot_apply_device``) and its re-root
against the JAX package's ``slot_apply_device``, and ``plan_updates`` against
the JAX one; altair minimal, 64 validators, on the CPU, every comparison
exact (u64 words, forest words, root bytes).

The JAX side pads its lanes to one bucket (``cap_flags`` = ``cap_rewards`` =
8) for every case, so its program compiles once for the file."""

import jax
import numpy as np
import pytest

import __graft_entry__ as graft
from eth_consensus_specs_tpu.forks import get_spec
from eth_consensus_specs_tpu.ops import slot_pipeline as jsp
from eth_consensus_specs_tpu.ops.state_root import synthetic_static as jax_synthetic_static
from eth_consensus_specs_tpu.parallel import resident as jres
from eth_consensus_specs_tpu_torch import convert
from eth_consensus_specs_tpu_torch.ops import slot_pipeline as tsp
from eth_consensus_specs_tpu_torch.ops.state_root import synthetic_static
from eth_consensus_specs_tpu_torch.parallel import resident as tres

N = 64
CAP = 8
U64_MAX = (1 << 64) - 1

# (flag_idx, reward_idx, reward_amt): K18's corners at the registry's size
PLANS = {
    "plain": ([1, 2, 3, 5, 8], [5, 9], [1024, 1024]),
    "duplicates": ([3, 3, 7, 7, 7, 3], [4, 4, 4, 10], [1024, 1024, 7, 1]),
    "ends": ([0, N - 1], [0, N - 1, 0], [1024, 1 << 40, 3]),
    "already_set": ([6, 11, 12], [6], [1024]),
    "wrap": ([5], [5, 6, 6], [1024, 1, 1 << 62]),
    "empty": ([], [], []),
}


def _columns(case):
    """The example columns bent to the case's corner: flags and target bits
    already set, or balances at 2^64 - 1 and 2^63 - 1 that the rewards wrap
    or carry across the sign bit of the int64 lane."""
    cols, just = graft._example_altair_inputs(N)
    if case == "already_set":
        flags = np.array(cols.prev_flags)
        tgt = np.array(cols.cur_tgt_att)
        flags[[6, 11, 12]] = 0b111
        tgt[[6, 11, 12]] = True
        cols = cols._replace(prev_flags=flags, cur_tgt_att=tgt)
    if case == "wrap":
        bal = np.array(cols.balance)
        bal[5], bal[6] = np.uint64(U64_MAX), np.uint64((1 << 63) - 1)
        cols = cols._replace(balance=bal)
    return cols, just


def _plan(case):
    f, r, a = PLANS[case]
    return np.asarray(f, np.int32), np.asarray(r, np.int32), np.asarray(a, np.uint64)


@pytest.fixture(scope="module")
def spec():
    return get_spec("altair", "minimal")


@pytest.fixture(scope="module")
def jax_static(spec):
    return jax_synthetic_static(spec, N)


def test_synthetic_static_altair_is_the_jax_static(jax_static):
    arrays, meta = synthetic_static(N, device="cpu", fork="altair")
    want_arrays, want_meta = jax_static
    assert meta.dynamic_slots == tuple(want_meta.dynamic_slots)
    assert (meta.top_depth, meta.n_validators) == (want_meta.top_depth, want_meta.n_validators)
    for name in ("val_node_a", "val_node_f", "slashed_chunk", "prev_part_flags", "top_chunks",
                 "zerohashes"):
        assert np.array_equal(convert.to_numpy(getattr(arrays, name)),
                              np.asarray(getattr(want_arrays, name))), name


@pytest.mark.parametrize("case", list(PLANS))
def test_slot_apply_ref_and_reroot_equal_jax(spec, jax_static, case):
    cols, just = _columns(case)
    jcols, jjust = jax.device_put(cols), jax.device_put(just)
    jforest, jplan = jres.build_state_forest_device(jax_static, jcols)
    pcols, pjust = convert.columns_from_numpy(cols, just, "cpu")
    pstatic = synthetic_static(N, device="cpu", fork="altair")
    pforest = convert.forest_from_numpy(jforest, "cpu")  # before JAX donates its own
    plan = _plan(case)

    want_cols, want_forest, want_root = jsp.slot_apply_device(
        jax_static, jplan, jforest, jcols, jjust, *plan, cap_flags=CAP, cap_rewards=CAP)
    got_cols, got_forest, got_root = tsp.slot_apply_device(
        pstatic, tres.forest_plan_for(pstatic), pforest, pcols, pjust, *plan, device="cpu")

    assert got_root == want_root
    for name in ("balance", "prev_flags", "cur_tgt_att"):
        assert np.array_equal(convert.to_numpy(getattr(got_cols, name)),
                              np.asarray(getattr(want_cols, name))), name
    for name in ("val_nodes", "bal_nodes", "inact_nodes", "part_root"):
        assert np.array_equal(convert.to_numpy(getattr(got_forest, name)),
                              np.asarray(getattr(want_forest, name))), name
    # the committed columns stay as they were
    assert np.array_equal(convert.to_numpy(pcols.balance), np.asarray(cols.balance))
    if case == "empty":
        assert np.array_equal(convert.to_numpy(got_cols.balance), np.asarray(cols.balance))


@pytest.mark.parametrize("case", list(PLANS))
def test_slot_apply_dispatch_on_cpu_is_the_plain_version(case):
    pcols, _ = convert.columns_from_numpy(*_columns(case), "cpu")
    args = (pcols.balance, pcols.prev_flags, pcols.cur_tgt_att, *_plan(case))
    for got, want in zip(tsp.slot_apply(*args), tsp.slot_apply_ref(*args)):
        assert got.dtype == want.dtype and bool((got == want).all())


def test_slot_apply_checks_the_plan_on_the_host():
    pcols, _ = convert.columns_from_numpy(*graft._example_altair_inputs(N), "cpu")
    base = (pcols.balance, pcols.prev_flags, pcols.cur_tgt_att)
    ok = np.zeros(0, np.int32), np.zeros(0, np.int32), np.zeros(0, np.uint64)
    for bad in ([N], [-1]):
        with pytest.raises(ValueError):
            tsp.slot_apply(*base, np.asarray(bad), *ok[1:])
        with pytest.raises(ValueError):
            tsp.slot_apply(*base, ok[0], np.asarray(bad), np.ones(1, np.uint64))
    with pytest.raises(ValueError):
        tsp.slot_apply(*base, ok[0], np.asarray([1, 2]), np.ones(1, np.uint64))


def _req(committees, bits, sync_indices):
    atts = tuple(jsp.SlotAttestation(subnet=i, root=b"\x00" * 32, committee=tuple(c),
                                     bits=tuple(b), pubkeys=(), sig=b"\x00" * 96)
                 for i, (c, b) in enumerate(zip(committees, bits)))
    return jsp.SlotRequest(slot=0, attestations=atts, sync_indices=tuple(sync_indices))


@pytest.mark.parametrize("verdicts,sync", [
    ((True, True, True), True), ((True, False, True), True), ((False, False, False), False),
    ((True, True, False), False)])
@pytest.mark.parametrize("reward", [None, "7", "-3", "x", "0"])
def test_plan_updates_equal_jax(monkeypatch, verdicts, sync, reward):
    """Valid items only; indices outside [0, n) dropped (below 0, at n, far
    past it), duplicates kept; the reward from the same environment read."""
    if reward is None:
        monkeypatch.delenv("ETH_SPECS_SLOT_SYNC_REWARD", raising=False)
    else:
        monkeypatch.setenv("ETH_SPECS_SLOT_SYNC_REWARD", reward)
    jreq = _req([[1, 2, 3, -1], [N - 1, N, 5], [2, 2, N + 40, 0]],
                [[1, 1, 0, 1], [1, 1, 1], [1, 0, 1, 1]], [3, 3, -2, N, N - 1, 0])
    want = jsp.plan_updates(jreq, list(verdicts), sync, N)
    got = tsp.plan_updates(convert.slot_request_from_jax(jreq), list(verdicts), sync, N)
    assert tsp.sync_reward_gwei() == jsp.sync_reward_gwei()
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and np.array_equal(g, w)


def test_advance_epoch_equals_jax(spec):
    """The slot's boundary epoch: the JAX ``advance_epoch`` and the port's
    ``resident.advance`` over K4's entry (its plain version on the CPU) on
    the example columns."""
    from eth_consensus_specs_tpu_torch.config import epoch_params
    from eth_consensus_specs_tpu_torch.ops.altair_epoch import altair_epoch_accounting
    from eth_consensus_specs_tpu_torch.parallel.resident import advance

    cols, just = graft._example_altair_inputs(N)
    want_cols, want_just = jsp.advance_epoch(spec, jax.device_put(cols), jax.device_put(just))
    got_cols, got_just = advance(altair_epoch_accounting, epoch_params("altair", "minimal"),
                                 *convert.columns_from_numpy(cols, just, "cpu"))
    for got, want in ((got_cols, want_cols), (got_just, want_just)):
        for name in want._fields:
            if getattr(want, name) is not None:
                assert np.array_equal(convert.to_numpy(getattr(got, name)),
                                      np.asarray(getattr(want, name))), name
