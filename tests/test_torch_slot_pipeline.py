"""Port parity: the whole slot (``ops/slot_pipeline`` and ``serve/slot.SlotWorld``)
against the JAX package's sequential host fold (``ops/slot_pipeline.host_slot_fold``,
as ``tests/test_slot.py``'s ``host_oracle`` runs it) and against the port's own
``host_slot_fold``; the durable commit read back by the JAX package's
``ops/snapshot.restore`` and by the port's own, with a replay.

Altair minimal, 64 validators, on the CPU (the plain versions of every kernel).
Three slots from ``inputs.slot_schedule``: a plain slot, one with a bad
attestation and a bad sparse blob, and an epoch-boundary slot; committees of 4
to 8 over two subnets, a sync aggregate of 4 drawn with replacement, one blob
a slot. Every comparison is exact: verdicts, aggregates and roots as bytes,
epochs, columns and forest words."""

from dataclasses import replace
from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch

import __graft_entry__ as graft
from eth_consensus_specs_tpu.forks import get_spec
from eth_consensus_specs_tpu.ops import slot_pipeline as jsp
from eth_consensus_specs_tpu.ops import snapshot as jsnap
from eth_consensus_specs_tpu.ops.state_root import synthetic_static as jax_synthetic_static
from eth_consensus_specs_tpu.serve.slot import _result_json as jax_result_json
from eth_consensus_specs_tpu_torch import convert
from eth_consensus_specs_tpu_torch.config import epoch_params
from eth_consensus_specs_tpu_torch.inputs import example_altair_inputs, slot_schedule
from eth_consensus_specs_tpu_torch.ops import slot_pipeline as tsp
from eth_consensus_specs_tpu_torch.ops import snapshot as tsnap
from eth_consensus_specs_tpu_torch.ops.state_root import synthetic_static
from eth_consensus_specs_tpu_torch.serve import slot as tslot

N = 64
SPOIL = (("att", 1, 1), ("blob", 1, 0))
SLOTS = (0, 1, 2)


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _to_jax(req):
    """The JAX package's SlotRequest with the port request's fields."""
    atts = tuple(jsp.SlotAttestation(subnet=a.subnet, root=a.root, committee=a.committee,
                                     bits=a.bits, pubkeys=a.pubkeys, sig=a.sig)
                 for a in req.attestations)
    return jsp.SlotRequest(slot=req.slot, attestations=atts, sync_pubkeys=req.sync_pubkeys,
                           sync_message=req.sync_message, sync_sig=req.sync_sig,
                           sync_indices=req.sync_indices, blobs=req.blobs,
                           epoch_boundary=req.epoch_boundary)


def _jax_result(r):
    return jsp.SlotResult(**{f: getattr(r, f) for f in r.__dataclass_fields__})


def _columns_equal(port_cols, jax_cols):
    for name in ("balance", "effective_balance", "inactivity_scores", "prev_flags",
                 "cur_tgt_att"):
        if not np.array_equal(convert.to_numpy(getattr(port_cols, name)),
                              np.asarray(getattr(jax_cols, name))):
            return False
    return True


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    reqs = slot_schedule(N, slots=len(SLOTS), committees=3, committee=(4, 8), subnets=2,
                         sync_size=4, blobs=1, slots_per_epoch=len(SLOTS), spoil=SPOIL, seed=3)
    ckpt = str(tmp_path_factory.mktemp("slot_ckpt"))
    world = tslot.SlotWorld(N, ckpt_dir=ckpt, device="cpu")
    results, carries = [], []
    for req in reqs:
        res, phases = world.execute(req, prep=tsp.prep_request(req))
        assert set(phases) >= {"slot.verify", "slot.aggregate", "slot.reroot", "slot.commit"}
        results.append(res)
        carries.append(world._carry)

    spec = get_spec("altair", "minimal")
    jcols, jjust = jax.device_put(graft._example_altair_inputs(N))
    jstatic = jax_synthetic_static(spec, N)
    jax_results, jax_cols, epoch = [], [], 0
    for req in reqs:
        res, jcols, jjust = jsp.host_slot_fold(spec, jstatic, jcols, jjust, _to_jax(req), epoch)
        epoch = res.epoch
        jax_results.append(res)
        jax_cols.append(jcols)

    params = epoch_params("altair", "minimal")
    pstatic = synthetic_static(N, device="cpu", fork="altair")
    pcols, pjust = example_altair_inputs(N, device="cpu")
    fold_results, fold_cols, epoch = [], [], 0
    for req in reqs:
        res, pcols, pjust = tsp.host_slot_fold(params, pstatic, pcols, pjust, req, epoch,
                                               device="cpu")
        epoch = res.epoch
        fold_results.append(res)
        fold_cols.append(pcols)
    return SimpleNamespace(reqs=reqs, ckpt=ckpt, world=world, results=results, carries=carries,
                           jax_results=jax_results, jax_cols=jax_cols, jstatic=jstatic,
                           fold_results=fold_results, fold_cols=fold_cols)


@pytest.mark.parametrize("slot", SLOTS)
def test_world_equals_the_jax_host_fold(run, slot):
    got, want = run.results[slot], convert.slot_result_from_jax(run.jax_results[slot])
    assert got.att_verdicts == want.att_verdicts
    assert got.sync_verdict == want.sync_verdict
    assert got.blob_verdicts == want.blob_verdicts
    assert got.subnet_aggregates == want.subnet_aggregates
    assert got.state_root == want.state_root
    assert got.epoch == want.epoch
    assert got == want


@pytest.mark.parametrize("slot", SLOTS)
def test_world_equals_the_port_host_fold(run, slot):
    assert run.results[slot] == run.fold_results[slot]
    assert _columns_equal(run.carries[slot].cols, run.jax_cols[slot])
    assert _columns_equal(run.fold_cols[slot], run.jax_cols[slot])


def test_verdicts_follow_the_construction(run):
    for req, res in zip(run.reqs, run.results):
        assert res.att_verdicts == tuple(("att", req.slot, i) not in SPOIL
                                         for i in range(len(req.attestations)))
        assert res.blob_verdicts == tuple(("blob", req.slot, i) not in SPOIL
                                          for i in range(len(req.blobs)))
        assert res.sync_verdict
        # two subnets, committees 0 and 2 share subnet 0: both valid ones summed
        assert [s for s, _ in res.subnet_aggregates] == sorted(
            {a.subnet for a, ok in zip(req.attestations, res.att_verdicts) if ok})
    assert [r.epoch for r in run.results] == [0, 0, 1]
    assert len({r.state_root for r in run.results}) == len(SLOTS)


def test_checkpoint_restores_in_the_jax_package(run):
    rs = jsnap.restore(run.ckpt, static=run.jstatic)
    carry = run.carries[-1]
    assert rs.manifest["state_root"] == run.results[-1].state_root.hex()
    assert _columns_equal(carry.cols, rs.cols)
    for name in ("val_nodes", "bal_nodes", "inact_nodes", "part_root"):
        assert np.array_equal(convert.to_numpy(getattr(carry.forest, name)),
                              np.asarray(getattr(rs.forest, name))), name
    extra = rs.manifest["extra"]["slot"]
    assert extra["epoch"] == 1
    assert extra["applied"] == [jax_result_json(_jax_result(r)) for r in run.results]


def test_restore_replays_a_committed_slot(run):
    world = tslot.SlotWorld(N, ckpt_dir=run.ckpt, device="cpu")
    world.boot()
    assert world.status()["lineage"]["verdict"] == "restored"
    assert (world.root, world.epoch) == (run.results[-1].state_root, 1)
    got, phases = world.execute(run.reqs[1])
    assert got.replayed and phases == {}
    assert replace(got, replayed=False) == run.results[1]
    assert world.root == run.results[-1].state_root
    assert world.status()["slots"] == len(SLOTS)


def test_result_codec_is_the_jax_packages(run):
    for res in run.results:
        assert tslot._result_json(res) == jax_result_json(_jax_result(res))
        assert tslot._result_from_json(tslot._result_json(res)) == res


def test_request_and_result_cross_from_jax(run):
    for req, res in zip(run.reqs, run.jax_results):
        assert convert.slot_request_from_jax(_to_jax(req)) == req
        assert _jax_result(convert.slot_result_from_jax(res)) == res


def test_failed_commit_rolls_back_and_the_next_slot_lands(tmp_path, monkeypatch):
    """A checkpoint that fails leaves memory where disk is; the forest, moved
    in place by the failed slot, is rebuilt, and the retry equals the fold."""
    req = slot_schedule(N, slots=1, committees=0, sync_size=4, blobs=0, seed=9)[0]
    world = tslot.SlotWorld(N, ckpt_dir=str(tmp_path), device="cpu")
    world.boot()
    root0 = world.root

    def broken(*args, **kwargs):
        raise OSError("disk full")

    monkeypatch.setattr(tsnap, "checkpoint", broken)
    with pytest.raises(OSError):
        world.execute(req)
    assert world.root == root0 and world.status()["slots"] == 0
    monkeypatch.undo()
    got, _ = world.execute(req)
    cols, just = example_altair_inputs(N, device="cpu")
    want, _, _ = tsp.host_slot_fold(epoch_params("altair", "minimal"),
                                    synthetic_static(N, device="cpu", fork="altair"),
                                    cols, just, req, 0, device="cpu")
    assert got == want and got.state_root != root0
    assert tsnap.restore(str(tmp_path), device="cpu").manifest["state_root"] == got.state_root.hex()
