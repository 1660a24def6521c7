"""Trace ``chip_smoke.py``'s slot cell on the card: each kernel's device time a slot.

Builds the cell as ``chip_smoke.run_slot`` does (``SlotWorld`` at 2^20
validators, the same 8 requests from the same seed and spoils; the keys go
into the key cache as the oracle's pool seeds them, not validated again),
serves one warm slot on a world of its own, then serves the 8 slots on two
fresh worlds: once under ``torch.profiler``, a trace a slot (the device time
of each kernel, memcpy and memset, summed by name), and once with a CUDA
event pair around every launch (``_ext.timing``, as ``chip_smoke.py``'s busy
split takes it; a pair takes in its launch's host gap). The two worlds'
results must be equal. ``--root`` imports the port and its ``chip_smoke.py``
from another checkout (for example an unpacked parent commit), so two
versions can be traced in one call on one card, in turns.

Needs a card; writes the whole record to ``--out`` and prints a summary as
one JSON line:

    python3 tools/slot_trace.py [--root DIR] [--out FILE]
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
import tempfile
import time
from pathlib import Path


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=str(Path(__file__).resolve().parents[1]))
    ap.add_argument("--out", default="")
    args = ap.parse_args()
    sys.path.insert(0, args.root)
    import torch

    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from eth_consensus_specs_tpu_torch import _ext
    from eth_consensus_specs_tpu_torch.crypto.curve import g1_to_bytes
    from eth_consensus_specs_tpu_torch.inputs import g1_keys, slot_schedule
    from eth_consensus_specs_tpu_torch.ops import bls_batch, pairing_device
    from eth_consensus_specs_tpu_torch.ops import slot_pipeline as sp
    from eth_consensus_specs_tpu_torch.serve.slot import SlotWorld

    dev = torch.device("cuda")
    n = cs.SLOT_VALIDATORS
    t0 = time.perf_counter()
    points = g1_keys(cs.SLOT_KEYS)
    pubkeys = [g1_to_bytes(p) for p in points]
    cs._seed_pk_cache([(b, p.x.n, p.y.n) for b, p in zip(pubkeys, points)])

    def schedule(slots, seed, spoil=()):
        return slot_schedule(n, slots=slots, committees=cs.SLOT_COMMITTEES,
                             committee=cs.SLOT_COMMITTEE, subnets=cs.SLOT_COMMITTEES,
                             keys=cs.SLOT_KEYS, pubkeys=pubkeys, sync_size=cs.SLOT_SYNC,
                             blobs=cs.SLOT_BLOBS, spoil=spoil, seed=seed)

    reqs = schedule(cs.SLOT_SLOTS, cs.SLOT_SEED, cs.SLOT_SPOIL)
    warm_req = schedule(1, cs.SLOT_SEED + 1)[0]
    tmp = tempfile.TemporaryDirectory(prefix="slot_trace_")
    SlotWorld(n, ckpt_dir=os.path.join(tmp.name, "warm"), device=dev).execute(
        warm_req, prep=sp.prep_request(warm_req))
    setup_s = time.perf_counter() - t0

    def fresh_world(name):
        with bls_batch._H2G2_LOCK:
            bls_batch._H2G2_CACHE.clear()
        with pairing_device._PREP_LOCK:
            pairing_device._PREP_CACHE.clear()
        w = SlotWorld(n, ckpt_dir=os.path.join(tmp.name, name), device=dev)
        w.boot()
        torch.cuda.synchronize()
        return w

    def serve(w, req):
        before = dict(_ext.launches)
        result, _ = w.execute(req, prep=sp.prep_request(req))
        torch.cuda.synchronize()
        return result, {k: v - before.get(k, 0) for k, v in _ext.launches.items()
                        if v - before.get(k, 0)}

    # the traced run: one profiler window a slot
    world = fresh_world("traced")
    traced, results, launches = [], [], []
    for req in reqs:
        box = {}
        prof = cs.device_profile(lambda: box.update(zip(("result", "launches"), serve(world, req))))
        results.append(box["result"])
        launches.append(box["launches"])
        traced.append(dict(busy_ms=prof["device_busy_ms"], by_name=prof["by_name"],
                           counts=prof["counts"]))
    del world

    # the event run: a CUDA event pair around every launch
    world = fresh_world("events")
    _ext.timing = []
    events = []
    for req, got, made in zip(reqs, results, launches):
        mark = len(_ext.timing)
        result, again = serve(world, req)
        if result != got or again != made:
            raise RuntimeError(f"slot {req.slot}: the event run differs from the traced run")
        by = cs.event_ms(_ext.timing[mark:])
        events.append(dict(busy_ms=sum(by.values()), by_counter=by))
    _ext.timing = None
    del world
    tmp.cleanup()

    spoiled = {s for _, s, _ in cs.SLOT_SPOIL}
    plain = [i for i, r in enumerate(reqs) if not r.epoch_boundary]
    clean = [i for i in plain if reqs[i].slot not in spoiled]

    def mean_by(rows, key, idx):
        names = sorted({k for i in idx for k in rows[i][key]})
        return {k: sum(rows[i][key].get(k, 0.0) for i in idx) / len(idx) for k in names}

    name = torch.cuda.get_device_name(0)
    record = dict(
        root=args.root, device=name, validators=n, slots=len(reqs), spoiled_slots=sorted(spoiled),
        clean_slots=[reqs[i].slot for i in clean],
        traced_busy_ms=[t["busy_ms"] for t in traced], event_busy_ms=[e["busy_ms"] for e in events],
        traced_busy_ms_plain_median=statistics.median(traced[i]["busy_ms"] for i in plain),
        event_busy_ms_plain_median=statistics.median(events[i]["busy_ms"] for i in plain),
        traced_busy_ms_clean_mean=sum(traced[i]["busy_ms"] for i in clean) / len(clean),
        event_busy_ms_clean_mean=sum(events[i]["busy_ms"] for i in clean) / len(clean),
        traced_ms_clean_mean_by_kernel=mean_by(traced, "by_name", clean),
        traced_count_clean_mean_by_kernel=mean_by(traced, "counts", clean),
        event_ms_clean_mean_by_counter=mean_by(events, "by_counter", clean),
        launches_clean_mean_by_counter=mean_by([dict(l=l) for l in launches], "l", clean),
        per_slot=[dict(slot=r.slot, traced=t, events=e, launches=l)
                  for r, t, e, l in zip(reqs, traced, events, launches)],
        setup_s=setup_s,
    )
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(record, indent=1))
    summary = {k: v for k, v in record.items() if k != "per_slot"}
    top = sorted(record["traced_ms_clean_mean_by_kernel"].items(), key=lambda kv: -kv[1])[:24]
    summary["traced_ms_clean_mean_by_kernel"] = {k[:60]: v for k, v in top}
    summary["traced_count_clean_mean_by_kernel"] = {
        k[:60]: record["traced_count_clean_mean_by_kernel"][k] for k, _ in top}
    print(json.dumps(summary), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
