"""Time K2 (``ops/merkle.py``) on every path that launches it, by CUDA events
and traced.

On one checkout of the port (``--root``, by default this one): ``tree_root``
at 2^20 leaves, ``many_tree_root`` at [64, 4096], [64, 65536] and [2048,
512] (the 2^20 tree's leaf blocks without its climb), the
serving flush ``merkleize_many_device`` of 64 ragged trees at depths 12 and
16 (host clock, the chunks copied from the host as the server copies them),
the slot root ``block_epoch.slot_root`` at 2^20 validators (its balance and
participation lists and the top container) and the ``"state"`` root of
``run_epochs`` over 8 epochs at 2^20. Each kernel call is timed by a pair of
CUDA events around 10 calls (median of 20) and under ``torch.profiler`` (the
device time of the hashing kernels, K1 and K2, a call); each path's launches
are counted by kernel and its root printed, so that two checkouts can be
held equal. Run it on an unpacked parent commit and on this tree in turns,
in one call on one card, to compare them.

Needs a card; prints one JSON line (and writes it to ``--out``):

    python3 tools/merkle_times.py [--root DIR] [--out FILE]
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys
import time
from pathlib import Path

N = 1 << 20  # the registry: validators, and the tree's leaves
# many_tree_root: trees, depth; 2,048 trees of one group each (no climb) hold the leaf
# blocks of the 2^20 tree apart from its climb
MANY = ((64, 12), (64, 16), (2048, 9))
FLUSH_DEPTHS = (12, 16)
FLUSH_TREES = 64
FLUSH_RUNS = 5
EPOCHS = 8
HASHING = ("merkle", "sha256_pairs")  # the kernel names of K2 and K1


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=str(Path(__file__).resolve().parents[1]))
    ap.add_argument("--out", default="")
    args = ap.parse_args()
    sys.path.insert(0, args.root)
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 1
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from eth_consensus_specs_tpu_torch import _ext
    from eth_consensus_specs_tpu_torch.config import block_epoch_params, epoch_params
    from eth_consensus_specs_tpu_torch.inputs import example_altair_inputs
    from eth_consensus_specs_tpu_torch.ops import block_epoch as be
    from eth_consensus_specs_tpu_torch.ops import merkle
    from eth_consensus_specs_tpu_torch.ops.state_root import synthetic_static
    from eth_consensus_specs_tpu_torch.parallel.resident import run_epochs

    if not merkle.__file__.startswith(str(Path(args.root).resolve())):
        raise RuntimeError(f"imported {merkle.__file__}, not the port under {args.root}")
    dev = torch.device("cuda")
    _ext.build()

    def ev_ms(fn, reps=20, inner=10):
        fn()
        torch.cuda.synchronize()
        ts = []
        for _ in range(reps):
            a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            a.record()
            for _ in range(inner):
                fn()
            b.record()
            b.synchronize()
            ts.append(a.elapsed_time(b) / inner)
        return statistics.median(ts)

    def traced(fn, calls=10):
        """Device ms a call: every kernel, and the hashing kernels."""
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            torch.ones(1, device=dev).add_(1)
            torch.cuda.synchronize()
            time.sleep(0.1)
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        busy = hashing = 0.0
        for e in prof.key_averages():
            if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0:
                busy += e.self_device_time_total
                if e.key.startswith(HASHING):
                    hashing += e.self_device_time_total
        return busy / 1e3 / calls, hashing / 1e3 / calls

    def launches(fn):
        _ext.reset_launches()
        fn()
        torch.cuda.synchronize()
        return dict(_ext.launches)

    def words(t):
        return [int(x) & 0xFFFFFFFF for x in t.reshape(-1)[:8].cpu()]

    gen = torch.Generator().manual_seed(1)
    out = {"root": str(Path(args.root).resolve())}

    leaves = torch.randint(-(1 << 31), 1 << 31, (N, 8), generator=gen, dtype=torch.int64)
    leaves = leaves.to(torch.int32).to(dev)
    tree = lambda: merkle.tree_root(leaves, 20)  # noqa: E731
    out["tree_root_2^20"] = dict(ms=ev_ms(tree), traced_ms=traced(tree)[1],
                                 launches=launches(tree), root=words(tree()))

    for b, d in MANY:
        w = torch.randint(-(1 << 31), 1 << 31, (b, 1 << d, 8), generator=gen, dtype=torch.int64)
        w = w.to(torch.int32).to(dev)
        many = lambda: merkle.many_tree_root(w, d)  # noqa: E731
        out[f"many_tree_root_{b}x2^{d}"] = dict(ms=ev_ms(many), traced_ms=traced(many)[1],
                                                launches=launches(many), root=words(many()))
        del w

    rng = np.random.default_rng(112)
    for d in FLUSH_DEPTHS:
        trees = [rng.integers(0, 256, (max((1 << d) - 37 * i, 0), 32), dtype=np.uint8)
                 for i in range(FLUSH_TREES)]
        flush = lambda: merkle.merkleize_many_device(trees, d, pad_batch=FLUSH_TREES, device=dev)  # noqa: E731
        roots = flush()
        runs = []
        for _ in range(FLUSH_RUNS):
            t0 = time.perf_counter()
            flush()
            runs.append((time.perf_counter() - t0) * 1e3)
        out[f"flush_2^{d}"] = dict(ms=statistics.median(runs), runs=runs,
                                   traced_ms=traced(flush, calls=2)[1], launches=launches(flush),
                                   root=list(roots[1][:8]))

    params = block_epoch_params("deneb", "mainnet")
    cols, st0, static = be.synthetic_block_columns(params, N, seed=11, atts_per_slot=128,
                                                   device=dev)
    ecols, just = example_altair_inputs(N, device=dev)
    arrays, meta = synthetic_static(N, device=dev)
    ctx = be.make_root_ctx("deneb", arrays, meta, static, ecols.inactivity_scores, just)
    cur = (torch.arange(N, device=dev) % 7).to(torch.uint8)
    slot = lambda: be.slot_root(ctx, st0.balance, cur, st0.prev_part, 12345)  # noqa: E731
    busy, hashing = traced(slot)
    out["slot_root"] = dict(ms=ev_ms(slot), traced_busy_ms=busy, traced_ms=hashing,
                            launches=launches(slot), root=words(slot()))
    del cols, st0, static, ctx, arrays, meta

    ep = epoch_params("deneb", "mainnet")
    scols, sjust = example_altair_inputs(N, device=dev)
    static_s = synthetic_static(N, seed=0, device=dev)
    state = lambda: run_epochs(ep, scols, sjust, EPOCHS, with_root="state", static=static_s,  # noqa: E731
                               device=dev)
    state()
    torch.cuda.synchronize()
    busy, hashing = traced(state, calls=1)
    out["state_epoch"] = dict(traced_busy_ms=busy / EPOCHS, traced_ms=hashing / EPOCHS,
                              launches={k: v / EPOCHS for k, v in launches(state).items()},
                              root=words(state().root_acc))

    line = json.dumps(out)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        with open(args.out, "a") as f:
            f.write(line + "\n")
    print(line, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
