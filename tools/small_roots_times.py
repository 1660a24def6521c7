"""Time the state root's small top chunks and K3's indexed entry on one
checkout of the port, by CUDA events and traced, with the epoch paths that
run them.

On one checkout (``--root``, by default this one): K1 (``sha256_pairs``)
at [3, 16], the three checkpoints' shape; the two K2 launches of a
``state_inc`` epoch and of a ``"state"`` epoch (the list launch, then the
top), each launch's device time from the trace's kernels in the order they
ran; the device busy time, the launches, the host enqueue (the host clock
around 8 chained epochs before the synchronisation) and the wall time an
epoch of both paths at 2^20 validators, deneb mainnet, and each kernel's
busy time an epoch; K3's indexed entry at 4,096 gathered rows of 2^20 on
the example columns (effective balances whole increments: on its table of
first pair hashes where the checkout has one) and on the same rows with
every effective balance one Gwei more (off any table: each row hashes its
first pair), each with its wrapper's host time a call (the host clock
around 10 calls, no synchronisation inside, median of 20). Each call is
timed by ``chip_smoke.cuda_ms`` (CUDA events around 10 calls, median of
20) and under ``chip_smoke.device_profile`` (the device time a call,
``per_call_ms``); each output's first words are printed, so that two
checkouts can be held equal. The measuring helpers come from this tool's
own checkout, whatever ``--root`` is. Run it on an unpacked parent commit
and on this tree in turns, in one call on one card, to compare them.

Needs a card; prints one JSON line (and writes it to ``--out``):

    python3 tools/small_roots_times.py [--root DIR] [--out FILE]
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

N = 1 << 20  # validators
CAP = 4096  # K3's indexed rows
CALLS = 10  # calls a traced window
EPOCHS = 8
RUNS = 5  # timed 8-epoch runs an epoch path


def _chip_smoke():
    """chip_smoke.py of this tool's checkout, for its measuring helpers."""
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("small_roots_times_chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def kernel_sequence(cs, fn) -> list:
    """(name, device µs) of every kernel fn() ran, in the order they
    started, from torch.profiler's CUDA events; the window opens with
    ``chip_smoke``'s spin kernels, left out."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(cs.OPEN_KERNELS):
            torch.cuda._sleep(1)
        torch.cuda.synchronize()
        time.sleep(0.1)
        fn()
        torch.cuda.synchronize()
    events = [e for e in prof.events() if e.device_type == DeviceType.CUDA
              and cs.OPEN_KERNEL_NAME not in e.name]
    events.sort(key=lambda e: e.time_range.start)
    return [(e.name.split("(")[0][:60], e.time_range.elapsed_us()) for e in events]


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=str(Path(__file__).resolve().parents[1]))
    ap.add_argument("--out", default="")
    args = ap.parse_args()
    args.root = str(Path(args.root).resolve())  # as the imported modules' paths read
    sys.path.insert(0, args.root)
    import torch

    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 1
    cs = _chip_smoke()

    from eth_consensus_specs_tpu_torch import _ext
    from eth_consensus_specs_tpu_torch.config import epoch_params
    from eth_consensus_specs_tpu_torch.inputs import example_altair_inputs
    from eth_consensus_specs_tpu_torch.ops import sha256, state_root
    from eth_consensus_specs_tpu_torch.parallel.resident import run_epochs

    if not state_root.__file__.startswith(args.root):
        raise RuntimeError(f"imported {state_root.__file__}, not the port under {args.root}")
    dev = torch.device("cuda")
    _ext.build()
    gen = torch.Generator().manual_seed(18)

    def traced(fn, calls=CALLS):
        """Device ms a call, in all and by kernel."""
        per = cs.per_call_ms(cs.device_profile(lambda: [fn() for _ in range(calls)]), calls)
        return sum(per.values()), {k.split("(")[0][:60]: v for k, v in per.items()}

    def launches(fn):
        _ext.reset_launches()
        fn()
        torch.cuda.synchronize()
        return dict(_ext.launches)

    def words(t):
        return [int(x) & 0xFFFFFFFF for x in t.reshape(-1)[:4].tolist()]

    def row(fn):
        busy, by = traced(fn)
        return dict(ms=cs.cuda_ms(fn, inner=CALLS), traced_ms=busy, traced_by_kernel=by,
                    launches=launches(fn), host_us=cs.host_us(fn), words=words(fn()))

    out = {"root": args.root,
           "nvidia_smi": subprocess.run(
               ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
               capture_output=True, text=True).stdout.strip()}

    msgs = torch.randint(-(1 << 31), 1 << 31, (3, 16), generator=gen).to(torch.int32).to(dev)
    out["sha256_pairs_3x16"] = row(lambda: sha256.sha256_pairs(msgs))

    params = epoch_params("deneb", "mainnet")
    cols, just = example_altair_inputs(N, device=dev)
    static = state_root.synthetic_static(N, seed=0, device=dev)
    for path in ("state_inc", "state"):
        carry = run_epochs(params, cols, just, 1, with_root=path, static=static, device=dev)
        extra = {"forest": carry.forest} if path == "state_inc" else {}
        chained = lambda: run_epochs(  # noqa: E731
            params, carry.cols, carry.just, EPOCHS,  # noqa: B023
            with_root=path, static=static, device=dev, **extra)  # noqa: B023
        chained()
        torch.cuda.synchronize()
        enqueue, wall = [], []
        for _ in range(RUNS):
            t0 = time.perf_counter()
            acc = chained().root_acc
            enqueue.append((time.perf_counter() - t0) * 1e3 / EPOCHS)
            torch.cuda.synchronize()
            wall.append((time.perf_counter() - t0) * 1e3 / EPOCHS)
        busy, by = traced(chained, calls=1)
        seq = [us for name, us in kernel_sequence(cs, chained)
               if name.startswith("merkle_lists")]
        out[f"{path}_epoch"] = dict(
            ms_per_epoch=statistics.median(wall), ms_runs=wall,
            host_enqueue_ms_per_epoch=statistics.median(enqueue), host_enqueue_runs=enqueue,
            busy_ms_per_epoch=busy / EPOCHS,
            busy_by_kernel_per_epoch={k: v / EPOCHS for k, v in by.items()},
            launches_per_epoch={k: v / EPOCHS for k, v in launches(chained).items()},
            # K2's two launches an epoch in the order they ran: the lists, the top
            k2_list_us=statistics.median(seq[0::2]) if len(seq) >= 2 else None,
            k2_top_us=statistics.median(seq[1::2]) if len(seq) >= 2 else None,
            k2_launches_traced=len(seq), root_acc=words(acc))
        del carry

    arrays = static[0]
    vargs = (cols.effective_balance, arrays.slashed_chunk, arrays.val_node_a, arrays.val_node_f)
    valid = torch.randint(0, N, (CAP,), generator=gen).to(torch.int32).to(dev)
    state_root.validator_leaves_at(*vargs, valid)  # a table, where the checkout has one
    out["validator_leaves_at_4096"] = row(lambda: state_root.validator_leaves_at(*vargs, valid))
    off = (vargs[0] + 1, *vargs[1:])
    out["validator_leaves_at_4096_hashed"] = row(
        lambda: state_root.validator_leaves_at(*off, valid))
    line = json.dumps(out)
    print(line)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
