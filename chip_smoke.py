#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``eth_consensus_specs_tpu_torch``) on one card.

    python3 chip_smoke.py

Phases, each printing one JSON line:

1. device: the card's name, and its name and power limit as nvidia-smi
   reports them (also printed alone on its own line);
2. build: every CUDA kernel of the slice compiled from ``csrc/`` (one nvcc
   per source, all at once), with the seconds it took;
3. kernels: each kernel (K1 sha256_pairs, K2 merkle tree_root, K3
   validator_leaves, K4 altair_epoch) called at the main path's shapes and
   held bit for bit (``torch.equal``) against its plain torch version on the
   same card and inputs; K1 also against hashlib. Median times with CUDA
   events, the plain version's time, and the least time the card could take;
4. main path: deneb mainnet, 2^20 validators, the example columns and a
   synthetic static tree; a warm-up epoch, then ``run_epochs(..., 8,
   with_root="state")`` with every launch counter at 0 just before it.
   ``root_acc``, the columns and the justification state are held against
   the plain path (``run_epochs_ref``) on the same card, and a 1,024-validator
   run against the CPU path.

Then the ``{"kernels": [...]}`` line (launches are those of the timed
main-path run) and, last, ``{"ok": true, "device": {...}}``. Any failure
raises and the script exits non-zero without the last line; so does a
machine without CUDA, or a directory without the package.
"""

from __future__ import annotations

import hashlib
import json
import statistics
import subprocess
import sys
import time

N_VALIDATORS = 1 << 20
EPOCHS = 8
TIMED_RUNS = 5
REPEATS = 20

# H100 SXM peaks (NVIDIA data sheet, 700 W): 3.35 TB/s of HBM; 67 TFLOP/s of
# float32 outside the tensor cores = 132 SMs x 128 lanes x 2 (FMA) x 1.98 GHz.
# 32-bit integer instructions issue on two pipes of 64 lanes per SM: the ALU
# pipe (LOP3, shifts, funnel shifts, IADD3) and the FMA pipe, where ptxas
# issues additions as IMAD.IADD. Logic and shifts have the ALU pipe alone,
# 67e12 / 4 per second; all integer instructions together have both pipes,
# 67e12 / 2 per second, which is also one warp instruction per clock on each
# of the SM's four schedulers.
HBM_BYTES_PER_S = 3.35e12
ALU_OPS_PER_S = 67e12 / 4
INT_OPS_PER_S = 67e12 / 2
# 32-bit instructions of one SHA-256 compression at the least Hopper's ISA
# allows: a rotation is one funnel shift, a three-input LOP3 folds each
# sigma's xors, Ch and Maj, and IADD3 adds three terms. A round has two big
# sigmas of 3 shifts + 1 LOP3, Ch and Maj (10 logic) and 4 additions; a
# schedule word two small sigmas of 3 shifts + 1 LOP3 (8 logic) and 2
# additions; 8 final additions. The padding block's schedule is a constant,
# folded into K, so its compression has no schedule words.
LOGIC_DATA_COMPRESSION = 64 * 10 + 48 * 8  # 1,024
ADDS_DATA_COMPRESSION = 64 * 4 + 48 * 2 + 8  # 360
LOGIC_PAD_COMPRESSION = 64 * 10  # 640
ADDS_PAD_COMPRESSION = 64 * 4 + 8  # 264
LOGIC_PER_MESSAGE = LOGIC_DATA_COMPRESSION + LOGIC_PAD_COMPRESSION  # 1,664
ADDS_PER_MESSAGE = ADDS_DATA_COMPRESSION + ADDS_PAD_COMPRESSION  # 624
# K4: u64 operations per validator over both launches (masks, five sums, the
# scalar recompute, the rewards/penalties chain, hysteresis), each counted as
# two 32-bit instructions that may issue on either pipe.
OPS_EPOCH_PER_VALIDATOR = 2 * 120


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def bound(nbytes: float, messages: float = 0, other_ops: float = 0) -> tuple[float, str]:
    """Least milliseconds for ``nbytes`` of HBM traffic, ``messages`` SHA-256
    pair hashes and ``other_ops`` integer instructions free to use either pipe:
    the larger of the bytes' time and the busier pipe's time."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    logic = messages * LOGIC_PER_MESSAGE
    every = logic + messages * ADDS_PER_MESSAGE + other_ops
    t_ops = max(logic / ALU_OPS_PER_S, every / INT_OPS_PER_S) * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def cuda_ms(fn, repeats: int = REPEATS) -> float:
    """Median milliseconds of fn() on the card, by CUDA events, after a warm-up."""
    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(repeats):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def max_abs_err(a, b) -> int:
    import torch

    if not torch.equal(a, b):
        diff = (a.to(torch.float64) - b.to(torch.float64)).abs().max().item()
        raise RuntimeError(f"kernel result differs from its plain version (max abs err {diff})")
    return 0


def check_kernels(dev):
    """Phase 3: each kernel against its plain version at the main path's shapes."""
    import numpy as np
    import torch

    from eth_consensus_specs_tpu_torch.config import epoch_params
    from eth_consensus_specs_tpu_torch.inputs import (
        ALTAIR_CORNERS, altair_corner_inputs, example_altair_inputs)
    from eth_consensus_specs_tpu_torch.ops import altair_epoch, merkle, sha256, state_root

    n = N_VALIDATORS
    gen = torch.Generator().manual_seed(7)

    def words(rows, cols):
        w = torch.randint(-(1 << 31), 1 << 31, (rows, cols), generator=gen, dtype=torch.int64)
        return w.to(torch.int32).to(dev)

    rows = []

    # K1 at the main path's shape: the four list-root fold chains hashed together
    msgs = words(4, 16)
    out = sha256.sha256_pairs(msgs)
    torch.cuda.synchronize()
    err = max_abs_err(out, sha256.sha256_pairs_ref(msgs))
    corner = torch.cat([torch.zeros(1, 16, dtype=torch.int32), torch.full((1, 16), -1, dtype=torch.int32),
                        words(6, 16).cpu()]).to(dev)
    got = sha256.sha256_pairs(corner).cpu().numpy().view(np.uint32).astype(">u4")
    msg_bytes = corner.cpu().numpy().view(np.uint32).astype(">u4")
    for i in range(corner.shape[0]):
        if got[i].tobytes() != hashlib.sha256(msg_bytes[i].tobytes()).digest():
            raise RuntimeError(f"sha256_pairs row {i} differs from hashlib")
    bulk = words(n, 16)
    max_abs_err(sha256.sha256_pairs(bulk), sha256.sha256_pairs_ref(bulk))
    b_ms, b_by = bound(96 * 4, 4)
    bulk_ms = cuda_ms(lambda: sha256.sha256_pairs(bulk))
    rows.append(dict(
        name="sha256_pairs", route="cuda", source="eth_consensus_specs_tpu_torch/csrc/sha256.cu",
        replaces="eth_consensus_specs_tpu/ops/sha256.py:153", shape=[4, 16], max_abs_err=err,
        ms=cuda_ms(lambda: sha256.sha256_pairs(msgs)),
        plain_ms=cuda_ms(lambda: sha256.sha256_pairs_ref(msgs), 5),
        bound_ms=b_ms, bound_by=b_by, library_ms=None, work_compressions=8,
        hashlib_checked=int(corner.shape[0]), bulk_rows=n, bulk_ms=bulk_ms,
        bulk_bound_ms=bound(96 * n, n)[0],
        bulk_compressions_per_s=2 * n / (bulk_ms / 1e3),
    ))

    # K2 at the registry tree: 2^20 leaves, depth 20 (the column trees are 2^18 and 2^15)
    depth = n.bit_length() - 1
    leaves = words(1 << depth, 8)
    err = max_abs_err(merkle.tree_root(leaves, depth), merkle.tree_root_ref(leaves, depth))
    for d in (depth - 2, depth - 5, 5, 1):
        max_abs_err(merkle.tree_root(leaves[: 1 << d], d), merkle.tree_root_ref(leaves[: 1 << d], d))
    hashes = merkle.tree_real_hashes(depth)
    b_ms, b_by = bound(32 * (1 << depth) + 32, hashes)
    k_ms = cuda_ms(lambda: merkle.tree_root(leaves, depth))
    rows.append(dict(
        name="merkle_tree_root", route="cuda", source="eth_consensus_specs_tpu_torch/csrc/merkle.cu",
        replaces="eth_consensus_specs_tpu/ops/merkle.py:68", shape=[1 << depth, 8], max_abs_err=err,
        ms=k_ms, plain_ms=cuda_ms(lambda: merkle.tree_root_ref(leaves, depth), 3),
        bound_ms=b_ms, bound_by=b_by, library_ms=None, work_compressions=2 * hashes,
        compressions_per_s=2 * hashes / (k_ms / 1e3),
    ))

    # K3 at the full registry
    arrays, _ = state_root.synthetic_static(n, seed=1, device=dev)
    arrays = arrays._replace(slashed_chunk=torch.where(
        torch.rand(n, 1, generator=gen).to(dev) < 0.01,
        torch.tensor([0x01000000, 0, 0, 0, 0, 0, 0, 0], dtype=torch.int32, device=dev),
        arrays.slashed_chunk))
    cols, just = example_altair_inputs(n, device=dev)
    eff = cols.effective_balance
    args = (eff, arrays.slashed_chunk, arrays.val_node_a, arrays.val_node_f, depth)
    err = max_abs_err(state_root.validator_leaves(*args), state_root.validator_leaves_ref(*args))
    b_ms, b_by = bound((8 + 3 * 32 + 32) * n, 3 * n)
    k_ms = cuda_ms(lambda: state_root.validator_leaves(*args))
    rows.append(dict(
        name="validator_leaves", route="cuda",
        source="eth_consensus_specs_tpu_torch/csrc/validator_leaves.cu",
        replaces="eth_consensus_specs_tpu/ops/state_root.py:143", shape=[n], max_abs_err=err,
        ms=k_ms, plain_ms=cuda_ms(lambda: state_root.validator_leaves_ref(*args), 3),
        bound_ms=b_ms, bound_by=b_by, library_ms=None, work_compressions=6 * n,
        compressions_per_s=6 * n / (k_ms / 1e3),
    ))

    # K4 on the example columns and on each corner the example columns never
    # reach (genesis epochs, a leak, all slashed, FAR_FUTURE_EPOCH lanes with
    # wrapping products): electra with its MaxEB column, then deneb mainnet
    err = 0
    for fork, electra in (("electra", True), ("deneb", False)):
        params = epoch_params(fork, "mainnet")
        for case in ("example",) + ALTAIR_CORNERS:
            if case == "example":
                cols, just = example_altair_inputs(n, electra=electra, device=dev)
            else:
                cols, just = altair_corner_inputs(case, n, electra=electra, device=dev)
            got = altair_epoch.altair_epoch_accounting(params, cols, just)
            want = altair_epoch.altair_epoch_accounting_ref(params, cols, just)
            err = max([err] + [max_abs_err(g, w) for g, w in zip(got, want)])
    cols, just = example_altair_inputs(n, device=dev)
    col_bytes = sum(t.element_size() * t.numel() for t in cols if t is not None)
    out_bytes = 3 * 8 * n
    b_ms, b_by = bound(col_bytes + out_bytes, other_ops=n * OPS_EPOCH_PER_VALIDATOR)
    rows.append(dict(
        name="altair_epoch", route="cuda", source="eth_consensus_specs_tpu_torch/csrc/altair_epoch.cu",
        replaces="eth_consensus_specs_tpu/ops/altair_epoch.py:142", shape=[n], max_abs_err=err,
        ms=cuda_ms(lambda: altair_epoch.altair_epoch_accounting(params, cols, just)),
        plain_ms=cuda_ms(lambda: altair_epoch.altair_epoch_accounting_ref(params, cols, just), 5),
        bound_ms=b_ms, bound_by=b_by, library_ms=None, work_validators=n,
        corners_checked=[f"{fork}:{case}" for fork in ("electra", "deneb") for case in ALTAIR_CORNERS],
    ))
    return rows


def device_profile(fn) -> dict:
    """Kernel time on the card during fn(), from torch.profiler's CUDA
    activity events (each kernel, memcpy and memset counted once)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    rows = [
        (e.key, e.self_device_time_total / 1e3, e.count)
        for e in prof.key_averages()
        if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0
    ]
    rows.sort(key=lambda r: -r[1])
    return dict(device_busy_ms=sum(r[1] for r in rows),
                top=[dict(name=k[:80], ms=ms, count=c) for k, ms, c in rows[:12]])


def run_main_path(dev) -> tuple[dict, dict]:
    """Phase 4: the slice's main path at 2^20 validators, held against the plain path."""
    import torch

    from eth_consensus_specs_tpu_torch import _ext
    from eth_consensus_specs_tpu_torch.config import epoch_params
    from eth_consensus_specs_tpu_torch.inputs import example_altair_inputs
    from eth_consensus_specs_tpu_torch.ops.state_root import state_root_real_hashes, synthetic_static
    from eth_consensus_specs_tpu_torch.parallel.resident import run_epochs, run_epochs_ref

    params = epoch_params("deneb", "mainnet")
    cols, just = example_altair_inputs(N_VALIDATORS, device=dev)
    static = synthetic_static(N_VALIDATORS, seed=0, device=dev)
    run_epochs(params, cols, just, 1, with_root="state", static=static, device=dev)  # warm-up
    torch.cuda.synchronize()

    times = []
    for i in range(TIMED_RUNS):
        if i == 0:
            _ext.reset_launches()
        t0 = time.perf_counter()
        carry = run_epochs(params, cols, just, EPOCHS, with_root="state", static=static, device=dev)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3 / EPOCHS)
        if i == 0:
            launches = dict(_ext.launches)

    prof = device_profile(
        lambda: run_epochs(params, cols, just, EPOCHS, with_root="state", static=static, device=dev))

    t0 = time.perf_counter()
    ref = run_epochs_ref(params, cols, just, EPOCHS, with_root="state", static=static,
                         device=dev)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3 / EPOCHS
    for name, got, want in (
        ("root_acc", carry.root_acc, ref.root_acc),
        *((f"cols.{f}", getattr(carry.cols, f), getattr(ref.cols, f))
          for f in ("balance", "effective_balance", "inactivity_scores")),
        *((f"just.{f}", getattr(carry.just, f), getattr(ref.just, f)) for f in carry.just._fields),
    ):
        if not torch.equal(got, want):
            raise RuntimeError(f"main path {name} differs from the plain path on the card")
    if carry.root_acc.shape != (8,) or not bool((carry.root_acc != 0).any()):
        raise RuntimeError("main path root_acc is empty")

    # a small registry through the kernels against the CPU path
    small = 1024
    s_cols, s_just = example_altair_inputs(small, device=dev)
    s_static = synthetic_static(small, seed=3, device=dev)
    s_gpu = run_epochs(params, s_cols, s_just, 2, with_root="state", static=s_static, device=dev)
    s_cpu = run_epochs(params, s_cols, s_just, 2, with_root="state", static=s_static, device="cpu")
    if not torch.equal(s_gpu.root_acc.cpu(), s_cpu.root_acc):
        raise RuntimeError("1,024-validator root_acc differs between the card and the CPU path")

    messages = state_root_real_hashes(static[1])
    ms = statistics.median(times)
    summary = dict(
        phase="main_path", fork="deneb", preset="mainnet", n_validators=N_VALIDATORS,
        epochs=EPOCHS, with_root="state", ms_per_epoch=ms, ms_per_epoch_runs=times,
        plain_ms_per_epoch=plain_ms, messages_per_epoch=messages,
        compressions_per_epoch=2 * messages, compressions_per_s=2 * messages / (ms / 1e3),
        device_busy_ms_per_epoch=prof["device_busy_ms"] / EPOCHS,
        # None where the profiler saw no device activity: not measured
        device_idle_share=(1 - prof["device_busy_ms"] / EPOCHS / ms) if prof["device_busy_ms"] else None,
        device_top_kernels=prof["top"],
        launches=launches, root_acc_equal_plain=True, small_n_equal_cpu=True,
        root_acc=[int(x) & 0xFFFFFFFF for x in carry.root_acc.cpu().tolist()],
    )
    return summary, launches


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; the port's smoke run needs a card",
              file=sys.stderr)
        return 1
    from eth_consensus_specs_tpu_torch import _ext

    dev = torch.device("cuda")
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    emit(dict(phase="device", name=name, nvidia_smi=smi, count=torch.cuda.device_count(),
              torch=torch.__version__, cuda=torch.version.cuda))

    t0 = time.perf_counter()
    report = _ext.build()
    emit(dict(phase="build", seconds=time.perf_counter() - t0, kernels=report))

    rows = check_kernels(dev)
    emit(dict(phase="kernels_checked", kernels=[r["name"] for r in rows], nvidia_smi=smi))

    summary, launches = run_main_path(dev)
    summary["nvidia_smi"] = smi
    emit(summary)

    for r in rows:
        r["launches"] = launches.get(_KERNEL_OF[r["name"]], 0)
    missing = [r["name"] for r in rows if r["launches"] == 0]
    emit({"kernels": rows})
    if missing:
        raise RuntimeError(f"kernels never launched on the main path: {missing}")
    emit({"ok": True, "device": {"platform": "gpu", "kind": name,
                                  "count": torch.cuda.device_count()}})
    return 0


_KERNEL_OF = {"sha256_pairs": "sha256", "merkle_tree_root": "merkle",
              "validator_leaves": "validator_leaves", "altair_epoch": "altair_epoch"}


if __name__ == "__main__":
    sys.exit(main())
