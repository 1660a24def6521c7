"""The owner of one whole-slot pipeline world: the resident validator state
a stream of slot requests runs against, and its durable commit.

Counterpart of ``eth_consensus_specs_tpu/serve/slot.py`` ``SlotWorld``.
The world is deterministic: altair minimal, the example columns
(``inputs.example_altair_inputs``) and the synthetic static tree
(``ops.state_root.synthetic_static(fork="altair")``), so the same size gives
the same state as the JAX package's world, bit for bit. ``execute`` runs one
slot:

* **compute**: ``slot.verify`` -> ``slot.aggregate`` -> ``slot.reroot``
  (``ops/slot_pipeline``) against the current carry; the forest is updated
  in place, the committed columns are not touched;
* **commit**: durable first. With a checkpoint directory the post-slot state
  checkpoints (``ops/snapshot.checkpoint``, the window of applied slots in
  the manifest's digest-covered ``extra``) before the result is returned; if
  that checkpoint fails, the in-memory state rolls back and the forest,
  already moved, is rebuilt from the committed columns before the next slot;
* **replay**: a slot already in the window returns its recorded result with
  ``replayed`` set, and applies nothing.

``boot`` restores the latest checkpoint (verified on the device) or builds
the world fresh and checkpoints it. A checkpoint of another registry plan is
a configuration change and boots fresh; a damaged one raises.

Not ported: the ``fault.degrade("slot.reroot", device, host)`` ladder and
the ``fault.check`` sites (a device failure raises here; the host fold is
the oracle, never a silent route), the ``obs`` events and counters, the
booting estimate (``mark_booting``, ``retry_after_s``), and the compile
warm-up (``_prewarm``, ``precompile_key``): a prebuilt kernel has nothing to
compile.
"""

from __future__ import annotations

import threading
import time
from collections import OrderedDict
from dataclasses import replace

from ..device import default_device
from ..ops import slot_pipeline
from ..ops.slot_pipeline import SlotRequest, SlotResult

_DEDUP = 256  # slots kept in the replay window
FORK, PRESET = "altair", "minimal"


def _result_json(r: SlotResult) -> dict:
    """A SlotResult as the JSON the checkpoint's ``extra`` carries (the JAX
    package's encoding; ``replayed`` is not stored)."""
    return {
        "slot": int(r.slot),
        "att": [int(v) for v in r.att_verdicts],
        "sync": int(r.sync_verdict),
        "blob": [int(v) for v in r.blob_verdicts],
        "aggs": [[int(s), sig.hex()] for s, sig in r.subnet_aggregates],
        "root": r.state_root.hex(),
        "epoch": int(r.epoch),
    }


def _result_from_json(d: dict) -> SlotResult:
    return SlotResult(
        slot=int(d["slot"]),
        att_verdicts=tuple(bool(v) for v in d["att"]),
        sync_verdict=bool(d["sync"]),
        blob_verdicts=tuple(bool(v) for v in d["blob"]),
        subnet_aggregates=tuple((int(s), bytes.fromhex(h)) for s, h in d["aggs"]),
        state_root=bytes.fromhex(d["root"]),
        epoch=int(d["epoch"]),
    )


class SlotWorld:
    """Owner of the durable slot-pipeline state on ``device`` (the card
    unless the caller names another)."""

    def __init__(self, n_validators: int, ckpt_dir: str = "", device=None):
        self.n_validators = int(n_validators)
        self.ckpt_dir = ckpt_dir
        self.device = default_device(device)
        self._lock = threading.RLock()
        self._booted = False
        self._params = None
        self._static = None
        self._plan = None
        self._carry = None
        self._forest_consumed = False
        self._seq = 0  # slots committed (the manifest's epoch axis)
        self._epoch = 0  # accounting epoch (advances on boundary slots)
        self._root = b""
        self._applied: OrderedDict[int, SlotResult] = OrderedDict()
        self._lineage: dict = {"verdict": "unbooted"}

    # ------------------------------------------------------------- boot --

    def _build_world(self):
        """The deterministic world: altair minimal constants, the example
        columns and the synthetic static tree of ``n_validators``."""
        from ..config import epoch_params
        from ..inputs import example_altair_inputs
        from ..ops.state_root import synthetic_static

        self._params = epoch_params(FORK, PRESET)
        self._static = synthetic_static(self.n_validators, device=self.device, fork=FORK)
        return example_altair_inputs(self.n_validators, device=self.device)

    def boot(self) -> None:
        """Idempotent boot: restore the latest checkpoint or build the world
        fresh (and checkpoint it, with a checkpoint directory)."""
        with self._lock:
            if self._booted:
                return
            t0 = time.monotonic()
            self._boot_inner()
            self._booted = True
            self._lineage["boot_ms"] = (time.monotonic() - t0) * 1e3

    def _boot_inner(self) -> None:
        from ..ops import snapshot
        from ..parallel import resident
        from ..parallel.resident import ResidentCarry

        cols0, just0 = self._build_world()
        plan = resident.forest_plan_for(self._static)
        rs = None
        if self.ckpt_dir:
            rs = snapshot.restore(self.ckpt_dir, static=self._static, device=self.device)
            if rs is not None and tuple(rs.plan)[:3] != tuple(plan)[:3]:
                rs = None  # another registry size under the same store: boot fresh
        if rs is not None:
            self._carry = ResidentCarry(cols=rs.cols, just=rs.just, root_acc=None,
                                        forest=rs.forest)
            self._plan = rs.plan
            self._seq = int(rs.epoch)
            self._root = bytes.fromhex(rs.manifest["state_root"] or "")
            extra = (rs.manifest.get("extra") or {}).get("slot") or {}
            self._epoch = int(extra.get("epoch", 0))
            self._applied = OrderedDict((int(d["slot"]), _result_from_json(d))
                                        for d in extra.get("applied", []))
            self._lineage = {"verdict": "restored", "manifest": rs.digest}
            return
        forest, self._plan = resident.build_state_forest_device(self._static, cols0,
                                                                device=self.device)
        self._carry = ResidentCarry(cols=cols0, just=just0, root_acc=None, forest=forest)
        self._seq = 0
        self._epoch = 0
        self._root = snapshot.state_root_bytes(self._static, self._plan, forest, just0)
        self._lineage = {"verdict": "cold"}
        if self.ckpt_dir:
            # a durable base world, so a crash before the first slot restores it
            self._lineage["manifest"] = self._checkpoint_locked().digest

    # ---------------------------------------------------------- serving --

    @property
    def root(self) -> bytes:
        return self._root

    @property
    def epoch(self) -> int:
        return self._epoch

    def status(self) -> dict:
        return {
            "booted": self._booted,
            "slots": self._seq,
            "epoch": self._epoch,
            "root": self._root.hex(),
            "dedup_window": len(self._applied),
            "lineage": dict(self._lineage),
        }

    def execute(self, req: SlotRequest, prep=None) -> tuple[SlotResult, dict]:
        """Run one slot end to end and commit it. Returns the result and the
        milliseconds of each phase (``slot.verify`` with its parts
        ``slot.verify.bls`` and ``slot.verify.kzg``, ``slot.aggregate``,
        ``slot.reroot``, ``slot.commit``). Slots serialize: they share one
        state. A replay returns the recorded result and no phases."""
        with self._lock:
            self.boot()
            hit = self._applied.get(int(req.slot))
            if hit is not None:
                return replace(hit, replayed=True), {}
            result, carry, phases = self._device_slot(req, prep)
            t0 = time.monotonic()
            window = OrderedDict(self._applied)
            window[int(req.slot)] = result
            while len(window) > _DEDUP:
                window.popitem(last=False)
            staged = (self._carry, self._seq, self._epoch, self._root, self._applied)
            self._carry = carry
            self._seq += 1
            self._epoch = int(result.epoch)
            self._root = result.state_root
            self._applied = window
            if self.ckpt_dir:
                try:
                    self._checkpoint_locked()
                except BaseException:
                    # memory never outruns disk: roll back; the forest was
                    # updated in place, so the next slot rebuilds it
                    self._carry, self._seq, self._epoch, self._root, self._applied = staged
                    self._forest_consumed = True
                    raise
            self._forest_consumed = False
            phases["slot.commit"] = (time.monotonic() - t0) * 1e3
            return result, phases

    def _checkpoint_locked(self):
        from ..ops import snapshot

        return snapshot.checkpoint(
            self.ckpt_dir, self._carry.forest, self._carry.cols, self._carry.just,
            epoch=self._seq, plan=self._plan, state_root=self._root,
            extra={"slot": {"epoch": int(self._epoch),
                            "applied": [_result_json(r) for r in self._applied.values()]}},
        )

    def _fresh_forest(self):
        """The forest the next slot updates: the carry's, unless a failed
        slot or commit already moved it; then rebuilt from the committed
        columns."""
        from ..parallel import resident

        if self._forest_consumed:
            forest, _ = resident.build_state_forest_device(self._static, self._carry.cols,
                                                           device=self.device)
            return forest
        return self._carry.forest

    def _device_slot(self, req: SlotRequest, prep):
        from ..ops import snapshot
        from ..parallel import resident
        from ..parallel.resident import ResidentCarry

        dev = self.device
        phases: dict[str, float] = {}
        parts: dict[str, float] = {}
        t0 = time.monotonic()
        att_v, sync_v, blob_v = slot_pipeline.device_verify(req, prep, device=dev, parts=parts)
        t1 = time.monotonic()
        phases["slot.verify"] = (t1 - t0) * 1e3
        phases.update({f"slot.verify.{k}": v * 1e3 for k, v in parts.items()})
        aggs = slot_pipeline.device_aggregate(req, att_v, prep, device=dev)
        t2 = time.monotonic()
        phases["slot.aggregate"] = (t2 - t1) * 1e3

        carry = self._carry
        plan = slot_pipeline.plan_updates(req, att_v, sync_v, self.n_validators)
        forest = self._fresh_forest()
        self._forest_consumed = True  # the update below moves it in place
        new_cols, forest, root = slot_pipeline.slot_apply_device(
            self._static, self._plan, forest, carry.cols, carry.just, *plan, device=dev)
        new_just, epoch = carry.just, self._epoch
        if req.epoch_boundary:
            run = resident.run_epochs(self._params, new_cols, new_just, 1, with_root="state_inc",
                                      static=self._static, device=dev, forest=forest)
            new_cols, new_just, forest = run.cols, run.just, run.forest
            root = snapshot.state_root_bytes(self._static, self._plan, forest, new_just)
            epoch += 1
        phases["slot.reroot"] = (time.monotonic() - t2) * 1e3
        result = SlotResult(slot=int(req.slot), att_verdicts=tuple(att_v),
                            sync_verdict=bool(sync_v), blob_verdicts=tuple(blob_v),
                            subnet_aggregates=aggs, state_root=root, epoch=epoch)
        return (result, ResidentCarry(cols=new_cols, just=new_just, root_acc=None, forest=forest),
                phases)
