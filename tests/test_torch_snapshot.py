"""Port parity: durable resident state (eth_consensus_specs_tpu_torch/ops/snapshot.py)
against the JAX package's ops/snapshot.py. Checkpoints cross between the packages
in both directions, the same state gives the same manifest in each, damaged
checkpoints are refused, and the scrub catches flipped words; deneb mainnet, 64
validators, on the CPU."""

import json
import os
from types import SimpleNamespace

import jax
import numpy as np
import pytest

import __graft_entry__ as graft
from eth_consensus_specs_tpu.forks import get_spec
from eth_consensus_specs_tpu.ops import snapshot as jsnap
from eth_consensus_specs_tpu.ops.state_root import synthetic_static
from eth_consensus_specs_tpu.parallel import resident as jres
from eth_consensus_specs_tpu_torch import convert
from eth_consensus_specs_tpu_torch.config import epoch_params
from eth_consensus_specs_tpu_torch.ops import snapshot as tsnap
from eth_consensus_specs_tpu_torch.parallel import resident as tres

N = 64


@pytest.fixture(scope="module")
def world():
    spec = get_spec("deneb", "mainnet")
    cols, just = graft._example_altair_inputs(N)
    cols, just = jax.device_put(cols), jax.device_put(just)
    static = synthetic_static(spec, N, seed=2)
    forest, plan = jres.build_state_forest_device(static, cols)
    pc, pj = convert.columns_from_numpy(cols, just, "cpu")
    ps = convert.static_from_numpy(*static, "cpu")
    pforest, pplan = tres.build_state_forest_device(ps, pc, device="cpu")
    return SimpleNamespace(
        spec=spec, cols=cols, just=just, static=static, forest=forest, plan=plan,
        root=jsnap.state_root_bytes(static, plan, forest, just),
        pc=pc, pj=pj, ps=ps, pforest=pforest, pplan=pplan,
    )


def _port_ckpt(w, d, **kw):
    kw.setdefault("epoch", 0)
    return tsnap.checkpoint(d, w.pforest, w.pc, w.pj, plan=w.pplan, static=w.ps, **kw)


def _jax_ckpt(w, d, **kw):
    kw.setdefault("epoch", 0)
    return jsnap.checkpoint(d, w.forest, w.cols, w.just, plan=w.plan, static=w.static, **kw)


def _assert_trees_equal(want, got):
    want, got = jax.tree_util.tree_leaves(want), jax.tree_util.tree_leaves(convert.to_numpy(got))
    assert len(want) == len(got)
    for a, b in zip(want, got):
        assert np.array_equal(np.asarray(a), np.asarray(b))


def test_port_state_root_bytes_match_jax(world):
    assert tsnap.state_root_bytes(world.ps, world.pplan, world.pforest, world.pj) == world.root


def test_same_state_writes_the_same_manifest(world, tmp_path):
    j = _jax_ckpt(world, str(tmp_path / "jax"))
    p = _port_ckpt(world, str(tmp_path / "port"))
    assert p.manifest["content_digest"] == j.manifest["content_digest"]
    assert p.manifest["state_root"] == j.manifest["state_root"] == world.root.hex()
    assert p.manifest == j.manifest and p.digest == j.digest
    assert sorted(os.listdir(tmp_path / "port" / "objects")) == sorted(
        os.listdir(tmp_path / "jax" / "objects"))


def test_port_checkpoint_restores_in_jax(world, tmp_path):
    d = str(tmp_path)
    _port_ckpt(world, d, epoch=7)
    rs = jsnap.restore(d, verify="host")
    assert rs.verdict == "verified-host" and rs.epoch == 7
    assert tuple(rs.plan) == tuple(world.plan)
    _assert_trees_equal(world.forest, rs.forest)
    _assert_trees_equal(world.cols, rs.cols)
    _assert_trees_equal(world.just, rs.just)


def test_jax_checkpoint_restores_in_port(world, tmp_path):
    d = str(tmp_path)
    _jax_ckpt(world, d, epoch=3)
    rs = tsnap.restore(d, static=world.ps, verify="device", device="cpu")
    assert rs.verdict == "verified-device" and rs.epoch == 3
    assert tuple(rs.plan) == tuple(world.plan)
    _assert_trees_equal(world.forest, rs.forest)
    _assert_trees_equal(world.cols, rs.cols)
    _assert_trees_equal(world.just, rs.just)
    assert tsnap.state_root_bytes(world.ps, rs.plan, rs.forest, rs.just) == world.root
    host = tsnap.restore(d, verify="host", device="cpu")
    assert host.verdict == "verified-host"
    _assert_trees_equal(world.forest, host.forest)


def test_empty_store_restores_none(tmp_path):
    assert tsnap.restore(str(tmp_path), verify="host", device="cpu") is None


def test_incremental_checkpoint_equals_full(world, tmp_path):
    da, db = str(tmp_path / "a"), str(tmp_path / "b")
    inc0 = _port_ckpt(world, da, incremental=True)
    full = _port_ckpt(world, db, incremental=False)
    assert inc0.manifest["content_digest"] == full.manifest["content_digest"]
    inc1 = _port_ckpt(world, da, incremental=True)
    assert inc1.written == 0 and inc1.reused > 0
    assert inc1.manifest["parent"] == inc0.digest


def test_corrupt_blob_is_refused(world, tmp_path):
    d = str(tmp_path)
    res = _port_ckpt(world, d)
    path = os.path.join(d, "objects", res.manifest["trees"]["val_nodes"]["shards"][0])
    raw = bytearray(open(path, "rb").read())
    raw[len(raw) // 2] ^= 0xFF
    open(path, "wb").write(bytes(raw))
    for verify in ("host", "device"):
        with pytest.raises(tsnap.TornCheckpoint):
            tsnap.restore(d, static=world.ps, verify=verify, device="cpu")


def test_tampered_manifest_state_root_is_refused(world, tmp_path):
    d = str(tmp_path)
    res = _port_ckpt(world, d)
    # a wrong root under a consistent manifest digest: the device
    # re-verification still refuses it
    bad = dict(res.manifest, state_root="00" * 32)
    data = json.dumps(bad, sort_keys=True).encode()
    name = os.path.basename(res.path)
    open(res.path, "wb").write(data)
    open(os.path.join(d, "LATEST"), "w").write(
        json.dumps({"manifest": name, "digest": tsnap._digest(data)}))
    with pytest.raises(tsnap.RestoreMismatch):
        tsnap.restore(d, static=world.ps, verify="device", device="cpu")


def test_torn_write_is_retried(world, tmp_path, monkeypatch):
    real, calls = tsnap._write_verified, []

    def torn_once(path, data, want):
        calls.append(path)
        if len(calls) == 1:
            raise tsnap.TornCheckpoint("torn")
        return real(path, data, want)

    monkeypatch.setattr(tsnap, "_write_verified", torn_once)
    d = str(tmp_path)
    _port_ckpt(world, d)
    assert calls[0] == calls[1]  # the first blob written again
    assert tsnap.restore(d, verify="host", device="cpu").epoch == 0


def test_failed_checkpoint_leaves_previous_latest_intact(world, tmp_path, monkeypatch):
    d = str(tmp_path)
    _port_ckpt(world, d, epoch=0)

    def always_torn(path, data, want):
        raise tsnap.TornCheckpoint("torn")

    monkeypatch.setattr(tsnap, "_write_verified", always_torn)
    with pytest.raises(tsnap.TornCheckpoint):
        _port_ckpt(world, d, epoch=1, incremental=False)
    monkeypatch.undo()
    assert tsnap.restore(d, verify="host", device="cpu").epoch == 0


# ------------------------------------------------------------------ scrub --


def _val_root(forest):
    return jsnap._host_combine(convert.to_numpy(forest.val_nodes)[:, -1, :])


def test_scrub_clean_forest_matches_jax(world):
    want = jsnap.scrub_forest(world.forest, k=2, salt=1, expect_root=_val_root(world.pforest))
    got = tsnap.scrub_forest(world.pforest, k=2, salt=1, expect_root=_val_root(world.pforest))
    assert got.mismatches == 0 and not got.bad and got.checks > 0
    assert (got.checks, got.mismatches, got.bad, got.root) == tuple(want)


def test_scrub_catches_upper_region_flip(world):
    # node 124 of the depth-6 val tree is level 5, above the subtree cut
    dmg = tsnap.flip_resident_word(world.pforest, "val_nodes", 124)
    rep = tsnap.scrub_forest(dmg, k=2, salt=3)
    assert rep.mismatches >= 1 and -1 in rep.bad["val_nodes"]
    want = jsnap.scrub_forest(jsnap.flip_resident_word(world.forest, "val_nodes", 124), k=2, salt=3)
    assert (rep.checks, rep.mismatches, rep.bad) == (want.checks, want.mismatches, want.bad)
    assert not tsnap.scrub_forest(world.pforest, k=2, salt=3).mismatches  # the original untouched


def test_scrub_catches_internal_flip_and_quarantine_heals(world):
    # node 100 is level 2, inside a sampled subtree: walk the salts until
    # the sampler covers it
    dmg = tsnap.flip_resident_word(world.pforest, "val_nodes", 100)
    rep = None
    for salt in range(16):
        rep = tsnap.scrub_forest(dmg, k=2, salt=salt)
        if rep.mismatches:
            break
    assert rep is not None and rep.mismatches >= 1 and -1 not in rep.bad["val_nodes"]
    healed = tsnap.quarantine_rebuild(dmg, "val_nodes")
    assert healed.val_nodes is dmg.val_nodes  # rebuilt in place
    assert tsnap.state_root_bytes(world.ps, world.pplan, healed, world.pj) == world.root
    assert not tsnap.scrub_forest(healed, k=2, salt=salt).mismatches


def test_scrub_leaf_flip_survives_rebuild(world):
    dmg = tsnap.flip_resident_word(world.pforest, "val_nodes", 3)
    healed = tsnap.quarantine_rebuild(dmg, "val_nodes")
    assert tsnap.state_root_bytes(world.ps, world.pplan, healed, world.pj) != world.root


def test_run_epochs_checkpointed_matches_jax(world, tmp_path):
    dj, dp = str(tmp_path / "jax"), str(tmp_path / "port")
    jcarry, jroot, jepoch = jres.run_epochs_checkpointed(
        world.spec, world.cols, world.just, 2, static=world.static, ckpt_dir=dj, ckpt_interval=1,
        epoch0=10)
    pcarry, proot, pepoch = tres.run_epochs_checkpointed(
        epoch_params("deneb", "mainnet"), world.pc, world.pj, 2, static=world.ps, ckpt_dir=dp,
        ckpt_interval=1, epoch0=10, device="cpu")
    assert (proot, pepoch) == (jroot, jepoch) and pepoch == 12
    _assert_trees_equal(jcarry.forest, pcarry.forest)
    _assert_trees_equal(jcarry.cols, pcarry.cols)
    assert np.array_equal(np.asarray(jcarry.root_acc), convert.to_numpy(pcarry.root_acc))
    jm, pm = jsnap.latest(dj)[0], tsnap.latest(dp)[0]
    assert pm["content_digest"] == jm["content_digest"] and pm["epoch_span"] == [10, 12]
    rs = tsnap.restore(dp, static=world.ps, verify="device", device="cpu")
    assert rs.epoch == 12 and tsnap.state_root_bytes(world.ps, rs.plan, rs.forest, rs.just) == proot
