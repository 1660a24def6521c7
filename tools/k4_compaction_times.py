"""Time kernels K4 (the altair accounting epoch, ``ops/altair_epoch.py``),
K9 (the phase0 accounting epoch, ``ops/state_columns.py``) and K5's
compaction (``ops/merkle_inc.py`` ``dirty_indices``/``dirty_leaves``) by
CUDA events and traced, beside ``torch.nonzero_static`` on the same mask,
and the epoch paths that run K4 and K9.

On one checkout of the port (``--root``, by default this one), at 2^20
validators: K4 on the deneb and the electra example columns; the compaction
of a mask of 4,096 dirty leaves of 2^20 at capacity 4,096 (chip_smoke's: the
effective balance of every 256th validator lowered), of the same update as
the effective-balance diff (one value a leaf), and of a balance column's
chunk diff (four values a leaf, every 97th balance raised, leaf rows
written); ``torch.nonzero_static(mask, size=4096, fill_value=0)``; the
device busy time and launches an epoch of 8 chained ``state_inc`` epochs and
of 2 ``"state"`` epochs; K9 at 10^6 validators on the phase0 example
columns (``epoch_phase0``'s), with its wrapper's host time a call (``host_us``:
the host clock around 10 calls, no synchronisation inside, median of 20) and
the SASS a validator of that checkout's ``csrc/state_columns.cu``
(``tools/fq_mul_sass.py``'s ``phase0_epoch_sass``, this checkout's tool), and
the busy time and launches an epoch of ``epoch_phase0``'s 8 chained
epochs. Each call is timed by ``chip_smoke.cuda_ms`` (CUDA
events around 10 calls, median of 20) and under ``chip_smoke.device_profile``
(the device time a call of every kernel, ``per_call_ms``); each call's
launches are counted by kernel and its first output words printed, so that
two checkouts can be held equal. The measuring helpers come from this
tool's own checkout, whatever ``--root`` is. Run it on an unpacked parent
commit and on this tree in turns, in one call on one card, to compare them.

Needs a card; prints one JSON line (and writes it to ``--out``):

    python3 tools/k4_compaction_times.py [--root DIR] [--out FILE]
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
PHASE0_N = 1_000_000  # epoch_phase0's registry
CAP = 4096
CALLS = 10  # calls a traced window
EPOCHS = 8


def _chip_smoke():
    """chip_smoke.py of this tool's checkout, for its measuring helpers."""
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("k4_compaction_times_chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


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
    from eth_consensus_specs_tpu_torch.config import epoch_params, phase0_epoch_params
    from eth_consensus_specs_tpu_torch.inputs import example_altair_inputs, example_inputs
    from eth_consensus_specs_tpu_torch.ops import (
        altair_epoch, merkle_inc, state_columns, state_root)
    from eth_consensus_specs_tpu_torch.parallel.resident import run_epochs

    if not merkle_inc.__file__.startswith(args.root):
        raise RuntimeError(f"imported {merkle_inc.__file__}, not the port under {args.root}")
    dev = torch.device("cuda")
    _ext.build()

    def traced(fn, calls=CALLS):
        """Device ms a call, in all and by kernel."""
        per = cs.per_call_ms(cs.device_profile(lambda: [fn() for _ in range(calls)]), calls)
        return sum(per.values()), {k.split("(")[0][:60]: v for k, v in per.items()}

    def launches(fn):
        _ext.reset_launches()
        fn()
        torch.cuda.synchronize()
        return dict(_ext.launches)

    def words(ts):
        return [int(t.reshape(-1)[:4].sum()) for t in ts if torch.is_tensor(t)]

    def row(fn):
        busy, by = traced(fn)
        return dict(ms=cs.cuda_ms(fn, inner=CALLS), traced_ms=busy, traced_by_kernel=by,
                    launches=launches(fn), words=words(fn()))

    def host_us(fn):
        """Host microseconds a call: the host clock around CALLS calls."""
        times = []
        for _ in range(20):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(CALLS):
                fn()
            times.append((time.perf_counter() - t0) / CALLS * 1e6)
        torch.cuda.synchronize()
        return statistics.median(times)

    out = {"root": args.root,
           "nvidia_smi": subprocess.run(
               ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
               capture_output=True, text=True).stdout.strip()}
    for fork in ("deneb", "electra"):
        params = epoch_params(fork, "mainnet")
        cols, just = example_altair_inputs(N, electra=fork == "electra", device=dev)
        out[f"altair_epoch_{fork}"] = row(
            lambda: altair_epoch.altair_epoch_accounting(params, cols, just))  # noqa: B023

    cols, just = example_altair_inputs(N, device=dev)
    ids = torch.arange(N, device=dev)
    old_eff = cols.effective_balance
    new_eff = torch.where(ids % 256 == 0, old_eff - 10**9, old_eff)
    mask = old_eff != new_eff
    out["compaction_mask"] = row(lambda: merkle_inc.dirty_indices(mask, CAP))
    out["nonzero_static"] = row(lambda: (torch.nonzero_static(mask, size=CAP, fill_value=0),))
    out["compaction_diff_per1"] = row(lambda: merkle_inc.dirty_leaves(old_eff, new_eff, 1, N, CAP))
    bal_new = torch.where(ids % 97 == 0, cols.balance + 12345, cols.balance)
    depth = N.bit_length() - 3
    leaf_rows = state_root._u64_chunk_leaves(cols.balance, N, depth)
    out["compaction_diff_per4_rows"] = row(lambda: merkle_inc.dirty_leaves(
        cols.balance, bal_new, 4, 1 << depth, 1024, leaf_rows))

    p0 = phase0_epoch_params("mainnet")
    p0_cols, p0_just = example_inputs(PHASE0_N, device=dev)
    k9 = lambda: state_columns.epoch_accounting(p0, p0_cols, p0_just)  # noqa: E731
    out["phase0_epoch"] = dict(row(k9), host_us=host_us(k9))

    def phase0_chain():
        c, res = p0_cols, None
        for _ in range(EPOCHS):
            res = state_columns.epoch_accounting(p0, c, p0_just)
            c = c._replace(balance=res.balance, effective_balance=res.effective_balance)
        return res

    busy, by = traced(phase0_chain, calls=1)
    out[f"epoch_phase0_{EPOCHS}_epochs"] = dict(
        busy_ms_per_epoch=busy / EPOCHS,
        busy_by_kernel_per_epoch={k: v / EPOCHS for k, v in by.items()},
        launches_per_epoch={k: v / EPOCHS for k, v in launches(phase0_chain).items()},
        words=words(phase0_chain()))
    del p0_cols, p0_just

    params = epoch_params("deneb", "mainnet")
    static = state_root.synthetic_static(N, seed=0, device=dev)
    for path, epochs in (("state_inc", EPOCHS), ("state", 2)):
        carry = run_epochs(params, cols, just, 1, with_root=path, static=static, device=dev)
        extra = {"forest": carry.forest} if path == "state_inc" else {}
        chained = lambda: run_epochs(  # noqa: E731
            params, carry.cols, carry.just, epochs,  # noqa: B023
            with_root=path, static=static, device=dev, **extra)  # noqa: B023
        busy, by = traced(chained, calls=1)
        out[f"{path}_{epochs}_epochs"] = dict(
            busy_ms_per_epoch=busy / epochs,
            busy_by_kernel_per_epoch={k: v / epochs for k, v in by.items()},
            launches_per_epoch={k: v / epochs for k, v in launches(chained).items()})
        del carry
    k9_source = Path(args.root) / "eth_consensus_specs_tpu_torch" / "csrc" / "state_columns.cu"
    out["phase0_sass"] = cs._sass_tool().phase0_epoch_sass(str(k9_source))
    line = json.dumps(out)
    print(line)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
