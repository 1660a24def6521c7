#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``eth_consensus_specs_tpu_torch``) on one card.

    python3 chip_smoke.py

Phases, each printing one JSON line:

1. device: the card's name, and its name and power limit as nvidia-smi
   reports them (also printed alone on its own line);
2. build: every CUDA kernel of the port compiled from ``csrc/`` (one nvcc
   per source, all at once), with the seconds it took;
3. kernels: each kernel (K1 sha256_pairs, K2 merkle tree_root, K3
   validator_leaves and its indexed entry validator_leaves_at, K4
   altair_epoch, K5 merkle_inc, K6 merkle_levels) called at the paths'
   shapes and held bit for bit (``torch.equal``) against its plain torch
   version on the same card and inputs; K1 and K6 also against hashlib.
   Median times with CUDA events, the plain version's time, and the least
   time the card could take;
4. main_path: deneb mainnet, 2^20 validators, the example columns and a
   synthetic static tree; a warm-up epoch, then ``run_epochs(..., 8,
   with_root="state")`` with every launch counter at 0 just before it.
   ``root_acc``, the columns and the justification state are held against
   the plain path (``run_epochs_ref``) on the same card, and a 1,024-validator
   run against the CPU path;
5. state_inc: the same inputs through the incremental forest: the forest
   built outside the timing, a warm-up epoch, then five chained 8-epoch
   runs, each continuing from the last one's carry (columns, justification
   state and forest, updated in place). The last run is held against
   ``with_root="state"`` from the same inputs; one more chained run under
   ``torch.cuda.set_sync_debug_mode("error")`` shows the loop never waits
   for the card; both roots timed in turns on the same host; 2^14 validators (the example
   columns, and a registry where every 4th validator crosses the
   hysteresis, so the validator tree takes its dense branch) against
   ``run_epochs_ref`` on the card, and 1,024 against the CPU path. Per-epoch
   dirty counts and the branch of each tree, read after the timed runs;
6. dirty_registry: the example columns with every 256th validator's balance
   lowered by 2 ETH, so 4,096 effective balances cross in the first epoch:
   the validator tree's sparse path at the plan's full capacity. Held
   against ``with_root="state"``; epoch times and K5's share of the card;
7. durability: ``run_epochs_checkpointed`` for 8 epochs with a checkpoint
   every 4 into a temporary directory; ``restore(verify="device")`` equal
   to the carry and the manifest; a clean ``scrub_forest(k=8)``; a flipped
   internal word caught by the scrub and healed by ``quarantine_rebuild``.

Each path runs with every launch counter at 0 just before it and read just
after. Then the ``{"kernels": [...]}`` line (``launches``: the state_inc
main path's counts, which take every kernel; ``launches_by_path``: each
path's) and, last, ``{"ok": true, "device": {...}}``. Any failure raises and
the script exits non-zero without the last line; so does a machine without
CUDA, or a directory without the package.
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
INNER = 10  # kernel calls back to back in one timed sample

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
# A warp dispatches at most one instruction per clock, so a message hashed
# by one thread takes at least its 2,288 instructions' worth of clocks; at
# the boost clock above, that is the floor of each level of K5's path update
# and of K6, whose levels run one after another.
CLOCK_HZ = 1.98e9
MESSAGE_SERIAL_S = (LOGIC_PER_MESSAGE + ADDS_PER_MESSAGE) / CLOCK_HZ


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def bound(nbytes: float, messages: float = 0, other_ops: float = 0,
          serial_messages: int = 0) -> tuple[float, str]:
    """Least milliseconds for ``nbytes`` of HBM traffic, ``messages`` SHA-256
    pair hashes and ``other_ops`` integer instructions free to use either pipe:
    the larger of the bytes' time and the busier pipe's time, or of
    ``serial_messages`` hashes that depend one on the next."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    logic = messages * LOGIC_PER_MESSAGE
    every = logic + messages * ADDS_PER_MESSAGE + other_ops
    t_ops = max(logic / ALU_OPS_PER_S, every / INT_OPS_PER_S,
                serial_messages * MESSAGE_SERIAL_S) * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def cuda_ms(fn, repeats: int = REPEATS, inner: int = 1) -> float:
    """Median milliseconds of fn() on the card, by CUDA events, after a warm-up:
    each of ``repeats`` samples times ``inner`` calls back to back, so that a
    kernel shorter than its host-side launch is not timed as the launch."""
    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(repeats):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(inner):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / inner)
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
    bulk_ms = cuda_ms(lambda: sha256.sha256_pairs(bulk), inner=INNER)
    rows.append(dict(
        name="sha256_pairs", route="cuda", source="eth_consensus_specs_tpu_torch/csrc/sha256.cu",
        replaces="eth_consensus_specs_tpu/ops/sha256.py:153", shape=[4, 16], max_abs_err=err,
        ms=cuda_ms(lambda: sha256.sha256_pairs(msgs), inner=INNER),
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
    k_ms = cuda_ms(lambda: merkle.tree_root(leaves, depth), inner=INNER)
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
    k_ms = cuda_ms(lambda: state_root.validator_leaves(*args), inner=INNER)
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
        ms=cuda_ms(lambda: altair_epoch.altair_epoch_accounting(params, cols, just), inner=INNER),
        plain_ms=cuda_ms(lambda: altair_epoch.altair_epoch_accounting_ref(params, cols, just), 5),
        bound_ms=b_ms, bound_by=b_by, library_ms=None, work_validators=n,
        corners_checked=[f"{fork}:{case}" for fork in ("electra", "deneb") for case in ALTAIR_CORNERS],
    ))
    return rows


def hashlib_tree_root(leaves) -> bytes:
    """Root of a power-of-two leaf level (uint32[L, 8] big-endian words) by hashlib."""
    level = [row.astype(">u4").tobytes() for row in leaves]
    while len(level) > 1:
        level = [hashlib.sha256(level[i] + level[i + 1]).digest() for i in range(0, len(level), 2)]
    return level[0]


def check_forest_kernels(dev):
    """Phase 3, continued: K6, K5 and K3's indexed entry at the incremental
    paths' shapes, each against its plain version."""
    import numpy as np
    import torch

    from eth_consensus_specs_tpu_torch import _ext
    from eth_consensus_specs_tpu_torch.inputs import example_altair_inputs
    from eth_consensus_specs_tpu_torch.ops import merkle, merkle_inc, state_root

    n = N_VALIDATORS
    depth = n.bit_length() - 1
    gen = torch.Generator().manual_seed(11)

    def words(*shape):
        w = torch.randint(-(1 << 31), 1 << 31, shape, generator=gen, dtype=torch.int64)
        return w.to(torch.int32).to(dev)

    def plain_levels(leaves):
        nodes = leaves.new_zeros((*leaves.shape[:-2], 2 * leaves.shape[-2] - 1, 8))
        nodes[..., :leaves.shape[-2], :] = leaves
        return merkle_inc.merkle_levels_ref(nodes)

    rows = []

    # K6: every level of the registry tree (2^20 leaves) and of a column tree
    # (2^18); the root against K2's; a small tree against hashlib; the
    # scrub's batch of 8 subtrees of 2^5 leaves; the dense-branch gate
    k6, trees = {}, {}
    for d in (depth, depth - 2):
        leaves = words(1 << d, 8)
        nodes = merkle_inc.build_levels(leaves)
        plain = plain_levels(leaves)
        torch.cuda.synchronize()
        err = max_abs_err(nodes, plain)
        if not torch.equal(nodes[-1], merkle.tree_root(leaves, d)):
            raise RuntimeError(f"merkle_levels root at depth {d} differs from merkle tree_root")
        b_ms, b_by = bound(32 * (1 << d) + 32 * ((1 << d) - 1), (1 << d) - 1, serial_messages=d)
        _ext.reset_launches()
        merkle_inc.merkle_levels(nodes)
        k6[d] = dict(err=err, launches=_ext.launches["merkle_levels"],
                     ms=cuda_ms(lambda: merkle_inc.merkle_levels(nodes), inner=INNER),
                     plain_ms=cuda_ms(lambda: merkle_inc.merkle_levels_ref(plain), 2),
                     bound_ms=b_ms, bound_by=b_by)
        trees[d] = (leaves, nodes)
    small = words(32, 8)
    got = merkle_inc.build_levels(small)[-1].cpu().numpy().view(np.uint32).astype(">u4").tobytes()
    if got != hashlib_tree_root(small.cpu().numpy().view(np.uint32)):
        raise RuntimeError("merkle_levels root differs from hashlib")
    batch = words(8, 32, 8)
    max_abs_err(merkle_inc.build_levels(batch), plain_levels(batch))
    stale = trees[depth - 2][1].clone()
    stale[1 << (depth - 2):] = 0
    five = torch.tensor([5], dtype=torch.int32, device=dev)
    max_abs_err(merkle_inc.merkle_levels(stale.clone(), five, 5), stale)  # 5 <= 5: not its branch
    max_abs_err(merkle_inc.merkle_levels(stale.clone(), five, 4), trees[depth - 2][1])
    rows.append(dict(
        name="merkle_levels", route="cuda", source="eth_consensus_specs_tpu_torch/csrc/merkle_levels.cu",
        replaces="eth_consensus_specs_tpu/ops/merkle_inc.py:109", shape=[1 << depth, 8],
        max_abs_err=k6[depth]["err"], ms=k6[depth]["ms"], plain_ms=k6[depth]["plain_ms"],
        bound_ms=k6[depth]["bound_ms"], bound_by=k6[depth]["bound_by"], library_ms=None,
        launches_per_tree=k6[depth]["launches"], work_compressions=2 * ((1 << depth) - 1),
        depth18=dict(ms=k6[depth - 2]["ms"], plain_ms=k6[depth - 2]["plain_ms"],
                     bound_ms=k6[depth - 2]["bound_ms"], launches=k6[depth - 2]["launches"]),
        hashlib_checked=True, batch_checked=[8, 63, 8],
    ))

    # K5 compaction: the registry's effective-balance diff at the plan's
    # capacity (4,096 crossings); a mask over capacity (5,000 dirty, the
    # first 4,096 kept); a balance column's chunk diff writing its leaf rows
    cap = 4096
    cols, _ = example_altair_inputs(n, device=dev)
    ids = torch.arange(n, device=dev)
    old_eff = cols.effective_balance
    new_eff = torch.where(ids % 256 == 0, old_eff - 10**9, old_eff)
    got = merkle_inc.dirty_leaves(old_eff, new_eff, 1, n, cap)
    want = merkle_inc.dirty_leaves_ref(old_eff, new_eff, 1, n, cap)
    err = max(max_abs_err(g, w) for g, w in zip(got, want))
    if int(got[1]) != n // 256:
        raise RuntimeError(f"dirty count {int(got[1])}, expected {n // 256}")
    over = torch.zeros(n, dtype=torch.bool, device=dev)
    over[torch.randperm(n, generator=gen)[:5000].to(dev)] = True
    for g, w in zip(merkle_inc.dirty_indices(over, cap), merkle_inc.dirty_indices_ref(over, cap)):
        max_abs_err(g, w)
    bal_new = torch.where(ids % 97 == 0, cols.balance + 12345, cols.balance)
    d_bal = depth - 2
    rows_k = state_root._u64_chunk_leaves(cols.balance, n, d_bal)
    rows_p = rows_k.clone()
    got = merkle_inc.dirty_leaves(cols.balance, bal_new, 4, 1 << d_bal, 1024, rows_k)
    want = merkle_inc.dirty_leaves_ref(cols.balance, bal_new, 4, 1 << d_bal, 1024, rows_p)
    for g, w in zip((*got, rows_k), (*want, rows_p)):
        max_abs_err(g, w)
    compact_ms = cuda_ms(lambda: merkle_inc.dirty_leaves(old_eff, new_eff, 1, n, cap), inner=INNER)
    compact_plain = cuda_ms(lambda: merkle_inc.dirty_leaves_ref(old_eff, new_eff, 1, n, cap), 3)

    # K5 path update at depth 20: 4,000 distinct leaves, 48 of their
    # siblings, 24 repeats, then padding zeros the count leaves out
    leaves, nodes = trees[depth]
    new_leaves = words(1 << depth, 8)
    uniq = torch.randperm(1 << depth, generator=gen)[:4000]
    idx = torch.cat([uniq, uniq[:48] ^ 1, uniq[:24], torch.zeros(24, dtype=torch.int64)])
    idx = idx.to(torch.int32).to(dev)
    vals = new_leaves[idx.to(torch.int64)]
    live = 4000 + 48 + 24
    count = torch.tensor([live], dtype=torch.int32, device=dev)
    tree_k, tree_p = nodes.clone(), nodes.clone()
    merkle_inc.path_update(tree_k, idx, vals, count, cap)
    merkle_inc.path_update_ref(tree_p, idx, vals, count, cap)
    err = max(err, max_abs_err(tree_k, tree_p))
    max_abs_err(tree_k, merkle_inc.build_levels(tree_k[:1 << depth].clone()))
    gated = nodes.clone()
    max_abs_err(merkle_inc.path_update(gated, idx, vals, count, live - 1), nodes)  # count > dense
    path_ms = cuda_ms(lambda: merkle_inc.path_update(tree_k, idx, vals, count, cap), inner=INNER)
    path_plain = cuda_ms(lambda: merkle_inc.path_update_ref(tree_p, idx, vals, count, cap), 3)
    c_ms, _ = bound(2 * 8 * n + 4 * cap + 4)
    p_ms, p_by = bound(live * 32 + live * depth * 96, live * depth, serial_messages=depth)
    rows.append(dict(
        name="merkle_inc", route="cuda", source="eth_consensus_specs_tpu_torch/csrc/merkle_inc.cu",
        replaces="eth_consensus_specs_tpu/ops/merkle_inc.py:140", shape=[1 << depth, cap],
        max_abs_err=err, ms=compact_ms + path_ms, plain_ms=compact_plain + path_plain,
        bound_ms=c_ms + p_ms, bound_by=p_by, library_ms=None,
        compaction=dict(ms=compact_ms, plain_ms=compact_plain, bound_ms=c_ms, bound_by="bytes",
                        replaces="eth_consensus_specs_tpu/ops/merkle_inc.py:125"),
        path_update=dict(ms=path_ms, plain_ms=path_plain, bound_ms=p_ms, bound_by=p_by,
                         live_paths=live, depth=depth, work_compressions=2 * live * depth,
                         dependency_floor_ms=depth * MESSAGE_SERIAL_S * 1e3),
        checked=["registry diff at capacity", "mask over capacity", "chunk diff with leaf rows",
                 "siblings, repeats and padding", "sparse gate"],
    ))

    # K3's indexed entry: 4,096 gathered rows, some past the registry
    arrays, _ = state_root.synthetic_static(n, seed=5, device=dev)
    vargs = (cols.effective_balance, arrays.slashed_chunk, arrays.val_node_a, arrays.val_node_f)
    idx = torch.cat([torch.randint(0, n, (cap - 64,), generator=gen),
                     torch.randint(n, n + 1000, (32,), generator=gen),
                     -torch.randint(1, 100, (32,), generator=gen)]).to(torch.int32).to(dev)
    err = max_abs_err(state_root.validator_leaves_at(*vargs, idx),
                      state_root.validator_leaves_at_ref(*vargs, idx))
    part = torch.tensor([3000], dtype=torch.int32, device=dev)
    max_abs_err(state_root.validator_leaves_at(*vargs, idx, part, cap),
                state_root.validator_leaves_at_ref(*vargs, idx, part, cap))
    if state_root.validator_leaves_at(*vargs, idx, part, 2999).any():
        raise RuntimeError("validator_leaves_at ran past its sparse gate")
    valid = torch.randint(0, n, (cap,), generator=gen).to(torch.int32).to(dev)
    b_ms, b_by = bound(cap * (4 + 8 + 3 * 32 + 32), 3 * cap)
    rows.append(dict(
        name="validator_leaves_at", route="cuda",
        source="eth_consensus_specs_tpu_torch/csrc/validator_leaves.cu",
        replaces="eth_consensus_specs_tpu/ops/state_root.py:721", shape=[cap], max_abs_err=err,
        ms=cuda_ms(lambda: state_root.validator_leaves_at(*vargs, valid), inner=INNER),
        plain_ms=cuda_ms(lambda: state_root.validator_leaves_at_ref(*vargs, valid), 5),
        bound_ms=b_ms, bound_by=b_by, library_ms=None, work_compressions=6 * cap,
    ))
    return rows


def device_profile(fn) -> dict:
    """Kernel time on the card during fn(), from torch.profiler's CUDA
    activity events (each kernel, memcpy and memset counted once)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        # the tracer can miss the first kernels of its window: open it with
        # one small kernel and a pause before the measured work
        torch.ones(1, device="cuda").add_(1)
        torch.cuda.synchronize()
        time.sleep(0.1)
        fn()
        torch.cuda.synchronize()
    rows = [
        (e.key, e.self_device_time_total / 1e3, e.count)
        for e in prof.key_averages()
        if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0
    ]
    rows.sort(key=lambda r: -r[1])
    return dict(device_busy_ms=sum(r[1] for r in rows),
                top=[dict(name=k[:80], ms=ms, count=c) for k, ms, c in rows[:12]],
                by_name={k: ms for k, ms, _ in rows}, counts={k: c for k, _, c in rows})


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


def _equal_or_raise(what: str, pairs) -> None:
    import torch

    for name, got, want in pairs:
        if (got is None) != (want is None) or (got is not None and not torch.equal(got, want)):
            raise RuntimeError(f"{what}: {name} differs")


def _carry_pairs(got, want, forest: bool = False):
    pairs = [("root_acc", got.root_acc, want.root_acc)]
    pairs += [(f"cols.{f}", getattr(got.cols, f), getattr(want.cols, f))
              for f in ("balance", "effective_balance", "inactivity_scores")]
    pairs += [(f"just.{f}", getattr(got.just, f), getattr(want.just, f)) for f in got.just._fields]
    if forest:
        pairs += [(f"forest.{f}", getattr(got.forest, f), getattr(want.forest, f))
                  for f in got.forest._fields]
    return pairs


def _branches(dirty, plan) -> list:
    """Per epoch: the branch each tree took (validator, balance, score)."""
    dense = (plan.dense_val, plan.dense_bal, plan.dense_bal)
    return [["none" if c < 0 else ("sparse" if c <= d else "dense") for c, d in zip(row, dense)]
            for row in dirty]


def _clone_forest(forest):
    return type(forest)(*(None if t is None else t.clone() for t in forest))


def run_state_inc(dev) -> tuple[dict, dict]:
    """Phase 5: the incremental forest path at 2^20 validators, chained, held
    against the full-recompute root; smaller registries against the plain
    path on the card and against the CPU path."""
    import torch

    from eth_consensus_specs_tpu_torch import _ext
    from eth_consensus_specs_tpu_torch.config import epoch_params
    from eth_consensus_specs_tpu_torch.inputs import example_altair_inputs, lower_balances
    from eth_consensus_specs_tpu_torch.ops.state_root import synthetic_static
    from eth_consensus_specs_tpu_torch.parallel.resident import (
        build_state_forest_device, forest_plan_for, run_epochs, run_epochs_ref)

    params = epoch_params("deneb", "mainnet")
    cols, just = example_altair_inputs(N_VALIDATORS, device=dev)
    static = synthetic_static(N_VALIDATORS, seed=0, device=dev)
    forest, plan = build_state_forest_device(static, cols, device=dev)
    carry = run_epochs(params, cols, just, 1, with_root="state_inc", static=static, device=dev,
                       forest=forest)  # warm-up
    torch.cuda.synchronize()

    times, enqueue = [], []
    for i in range(TIMED_RUNS):
        start = carry
        if i == 0:
            _ext.reset_launches()
        t0 = time.perf_counter()
        carry = run_epochs(params, start.cols, start.just, EPOCHS, with_root="state_inc",
                           static=static, device=dev, forest=start.forest)
        enqueue.append((time.perf_counter() - t0) * 1e3 / EPOCHS)  # the host's share
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3 / EPOCHS)
        if i == 0:
            launches, first_dirty = dict(_ext.launches), carry.dirty
    if carry.forest.val_nodes.data_ptr() != forest.val_nodes.data_ptr():
        raise RuntimeError("the forest was not updated in place")
    full = run_epochs(params, start.cols, start.just, EPOCHS, with_root="state", static=static,
                      device=dev)
    _equal_or_raise("state_inc vs state at 2^20", _carry_pairs(carry, full))

    def chained():
        nonlocal carry
        carry = run_epochs(params, carry.cols, carry.just, EPOCHS, with_root="state_inc",
                           static=static, device=dev, forest=carry.forest)

    prof = device_profile(chained)
    dirty = first_dirty.cpu().tolist()
    # no host synchronisation inside the epoch loop: torch raises on any
    torch.cuda.set_sync_debug_mode("error")
    try:
        chained()
    finally:
        torch.cuda.set_sync_debug_mode("default")

    # the two roots' epoch times in turns (state, state_inc, state_inc, state,
    # ...), so both see the same host
    turns = {"state": [], "state_inc": []}
    for mode in ("state", "state_inc", "state_inc", "state") * 2:
        t0 = time.perf_counter()
        out = run_epochs(params, carry.cols, carry.just, EPOCHS, with_root=mode, static=static,
                         device=dev, forest=carry.forest if mode == "state_inc" else None)
        torch.cuda.synchronize()
        turns[mode].append((time.perf_counter() - t0) * 1e3 / EPOCHS)
        if mode == "state_inc":
            carry = out

    small_checked = []
    s_cols, s_just = example_altair_inputs(1 << 14, device=dev)
    s_static = synthetic_static(1 << 14, seed=3, device=dev)
    for label, c in (("example", s_cols), ("every_4th_crosses", lower_balances(s_cols, every=4))):
        got = run_epochs(params, c, s_just, 2, with_root="state_inc", static=s_static, device=dev)
        ref = run_epochs_ref(params, c, s_just, 2, with_root="state_inc", static=s_static,
                             device=dev)
        _equal_or_raise(f"state_inc 2^14 {label} vs plain", _carry_pairs(got, ref, forest=True)
                        + [("dirty", got.dirty, ref.dirty)])
        small_checked.append(dict(registry=label, dirty=got.dirty.cpu().tolist(),
                                  branches=_branches(got.dirty.cpu().tolist(),
                                                     forest_plan_for(s_static))))
    t_cols, t_just = example_altair_inputs(1024, device=dev)
    t_static = synthetic_static(1024, seed=3, device=dev)
    gpu = run_epochs(params, t_cols, t_just, 2, with_root="state_inc", static=t_static, device=dev)
    cpu = run_epochs(params, t_cols, t_just, 2, with_root="state_inc", static=t_static,
                     device="cpu")
    _equal_or_raise("state_inc 1,024 card vs CPU",
                    [(n, g.cpu(), w) for n, g, w in _carry_pairs(gpu, cpu, forest=True)])

    ms = statistics.median(times)
    summary = dict(
        phase="state_inc", fork="deneb", preset="mainnet", n_validators=N_VALIDATORS,
        epochs=EPOCHS, with_root="state_inc", plan=plan._asdict(), ms_per_epoch=ms,
        ms_per_epoch_runs=times, host_enqueue_ms_per_epoch=statistics.median(enqueue),
        host_enqueue_runs=enqueue, in_turns_ms_per_epoch=turns,
        in_turns_median={k: statistics.median(v) for k, v in turns.items()},
        device_busy_ms_per_epoch=prof["device_busy_ms"] / EPOCHS,
        device_idle_share=(1 - prof["device_busy_ms"] / EPOCHS / ms) if prof["device_busy_ms"] else None,
        device_top_kernels=prof["top"], launches=launches,
        launches_per_epoch={k: v / EPOCHS for k, v in launches.items()},
        dirty_per_epoch=dirty, branches=_branches(dirty, plan),
        root_acc_equal_state=True, no_host_sync=True, small_checked=small_checked,
        n1024_equal_cpu=True,
        root_acc=[int(x) & 0xFFFFFFFF for x in carry.root_acc.cpu().tolist()],
    )
    return summary, launches


def run_dirty_registry(dev) -> tuple[dict, dict]:
    """Phase 6: 4,096 effective balances cross in the first epoch at 2^20
    validators, the validator tree's sparse path at full capacity."""
    import torch

    from eth_consensus_specs_tpu_torch import _ext
    from eth_consensus_specs_tpu_torch.config import epoch_params
    from eth_consensus_specs_tpu_torch.inputs import example_altair_inputs, lower_balances
    from eth_consensus_specs_tpu_torch.ops.state_root import synthetic_static
    from eth_consensus_specs_tpu_torch.parallel.resident import build_state_forest_device, run_epochs

    params = epoch_params("deneb", "mainnet")
    cols, just = example_altair_inputs(N_VALIDATORS, device=dev)
    cols = lower_balances(cols, every=256)
    static = synthetic_static(N_VALIDATORS, seed=0, device=dev)
    forest0, plan = build_state_forest_device(static, cols, device=dev)

    def run(epochs, forest):
        return run_epochs(params, cols, just, epochs, with_root="state_inc", static=static,
                          device=dev, forest=forest)

    run(1, _clone_forest(forest0))  # warm-up
    forest = _clone_forest(forest0)
    torch.cuda.synchronize()
    _ext.reset_launches()
    carry = run(EPOCHS, forest)
    torch.cuda.synchronize()
    launches = dict(_ext.launches)
    full = run_epochs(params, cols, just, EPOCHS, with_root="state", static=static, device=dev)
    _equal_or_raise("dirty registry state_inc vs state", _carry_pairs(carry, full))
    dirty = carry.dirty.cpu().tolist()
    if not 0 < dirty[0][0] <= plan.dense_val:
        raise RuntimeError(f"first epoch dirtied {dirty[0][0]} validators; the sparse branch "
                           f"takes 1..{plan.dense_val}")

    def timed(epochs):
        out = []
        for _ in range(3):
            f = _clone_forest(forest0)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            run(epochs, f)
            torch.cuda.synchronize()
            out.append((time.perf_counter() - t0) * 1e3 / epochs)
        return out

    runs8, runs1 = timed(EPOCHS), timed(1)
    f = _clone_forest(forest0)
    torch.cuda.synchronize()
    prof = device_profile(lambda: run(1, f))
    k5 = sum(ms for k, ms in prof["by_name"].items()
             if "dirty_compact_kernel" in k or "path_update_kernel" in k)
    traced = {k.split("(")[0]: c for k, c in prof["counts"].items()}
    summary = dict(
        phase="dirty_registry", n_validators=N_VALIDATORS, lowered_every=256, epochs=EPOCHS,
        dirty_per_epoch=dirty, branches=_branches(dirty, plan), launches=launches,
        ms_per_epoch=statistics.median(runs8), ms_per_epoch_runs=runs8,
        first_epoch_ms=statistics.median(runs1), first_epoch_ms_runs=runs1,
        first_epoch_device_busy_ms=prof["device_busy_ms"], first_epoch_k5_ms=k5,
        first_epoch_k5_share=k5 / prof["device_busy_ms"] if prof["device_busy_ms"] else None,
        # the trace is whole when it holds every launch of the epoch
        first_epoch_traced_launches={k: traced.get(k, 0) for k in (
            "epoch_sums_kernel", "epoch_apply_kernel", "dirty_compact_kernel",
            "validator_leaves_at_kernel", "path_update_kernel", "merkle_levels_kernel")},
        device_top_kernels=prof["top"], root_acc_equal_state=True,
    )
    return summary, launches


def run_durability(dev) -> tuple[dict, dict]:
    """Phase 7: checkpoint, restore, scrub and quarantine at 2^20 validators."""
    import tempfile

    import torch

    from eth_consensus_specs_tpu_torch import _ext
    from eth_consensus_specs_tpu_torch.config import epoch_params
    from eth_consensus_specs_tpu_torch.inputs import example_altair_inputs
    from eth_consensus_specs_tpu_torch.ops import merkle_inc, snapshot
    from eth_consensus_specs_tpu_torch.ops.state_root import synthetic_static
    from eth_consensus_specs_tpu_torch.parallel.resident import (
        build_state_forest_device, run_epochs_checkpointed)

    params = epoch_params("deneb", "mainnet")
    cols, just = example_altair_inputs(N_VALIDATORS, device=dev)
    static = synthetic_static(N_VALIDATORS, seed=0, device=dev)
    forest, plan = build_state_forest_device(static, cols, device=dev)
    torch.cuda.synchronize()
    _ext.reset_launches()
    with tempfile.TemporaryDirectory() as d, tempfile.TemporaryDirectory() as d2:
        t0 = time.perf_counter()
        carry, root, epoch = run_epochs_checkpointed(
            params, cols, just, EPOCHS, static=static, forest=forest, ckpt_dir=d, ckpt_interval=4,
            device=dev)
        run_s = time.perf_counter() - t0
        manifest, _ = snapshot.latest(d)
        if epoch != EPOCHS or manifest["state_root"] != root.hex() or manifest["epoch"] != EPOCHS:
            raise RuntimeError("checkpoint manifest disagrees with the run")
        t0 = time.perf_counter()
        rs = snapshot.restore(d, static=static, verify="device", device=dev)
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t0
        _equal_or_raise("restore", [(f"forest.{f}", getattr(rs.forest, f), getattr(carry.forest, f))
                                    for f in carry.forest._fields]
                        + [(f"cols.{f}", getattr(rs.cols, f), getattr(carry.cols, f))
                           for f in carry.cols._fields]
                        + [(f"just.{f}", getattr(rs.just, f), getattr(carry.just, f))
                           for f in carry.just._fields])
        if snapshot.state_root_bytes(static, rs.plan, rs.forest, rs.just) != root:
            raise RuntimeError("restored forest's root differs from the manifest's")
        t0 = time.perf_counter()
        full = snapshot.checkpoint(d2, carry.forest, carry.cols, carry.just, epoch=epoch,
                                   plan=plan, static=static, incremental=False)
        ckpt_s = time.perf_counter() - t0

        val_root = snapshot._words_bytes(merkle_inc.forest_root(carry.forest.val_nodes))
        t0 = time.perf_counter()
        clean = snapshot.scrub_forest(carry.forest, k=8, salt=0, expect_root=val_root)
        scrub_s = time.perf_counter() - t0
        if clean.mismatches:
            raise RuntimeError(f"scrub of the clean forest found {clean.bad}")
        # an internal row above the subtree cut (level 10), caught every pass;
        # one inside the first sampled subtree (level 2), caught at its position
        upper_row = merkle_inc.level_offset(plan.depth_val, 10) + (1 << (plan.depth_val - 10)) // 3
        pos = snapshot._salted_positions(0, "val_nodes", 8, 1 << (plan.depth_val - 5))[0]
        low_row = merkle_inc.level_offset(plan.depth_val, 2) + pos * (32 >> 2) + 3
        caught = {}
        for label, row in (("upper", upper_row), ("subtree", low_row)):
            dmg = snapshot.flip_resident_word(carry.forest, "val_nodes", row)
            rep = snapshot.scrub_forest(dmg, k=8, salt=0)
            want = -1 if label == "upper" else pos
            if want not in rep.bad.get("val_nodes", []):
                raise RuntimeError(f"scrub missed the {label} flip: {rep.bad}")
            healed = snapshot.quarantine_rebuild(dmg, "val_nodes")
            if snapshot.state_root_bytes(static, plan, healed, carry.just) != root:
                raise RuntimeError(f"quarantine_rebuild did not heal the {label} flip")
            caught[label] = dict(row=row, bad=rep.bad, checks=rep.checks)
    launches = dict(_ext.launches)
    summary = dict(
        phase="durability", n_validators=N_VALIDATORS, epochs=EPOCHS, ckpt_interval=4,
        run_with_checkpoints_s=run_s, last_manifest_counts=manifest["counts"],
        full_checkpoint_s=ckpt_s, full_checkpoint_bytes=full.bytes_written,
        full_checkpoint_blobs=full.written, restore_device_verified_s=restore_s,
        scrub_k8_s=scrub_s, scrub_checks=clean.checks, flips_caught_and_healed=caught,
        state_root=root.hex(), launches=launches,
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

    rows = check_kernels(dev) + check_forest_kernels(dev)
    emit(dict(phase="kernels_checked", kernels=[r["name"] for r in rows], nvidia_smi=smi))

    by_path = {}
    for path, phase in (("state", run_main_path), ("state_inc", run_state_inc),
                        ("dirty_registry", run_dirty_registry), ("durability", run_durability)):
        summary, by_path[path] = phase(dev)
        summary["nvidia_smi"] = smi
        emit(summary)

    for r in rows:
        key = _KERNEL_OF[r["name"]]
        r["launches"] = by_path["state_inc"].get(key, 0)
        r["launches_by_path"] = {path: counts.get(key, 0) for path, counts in by_path.items()}
    missing = [r["name"] for r in rows if not any(r["launches_by_path"].values())]
    emit({"kernels": rows})
    if missing:
        raise RuntimeError(f"kernels never launched on any path: {missing}")
    emit({"ok": True, "device": {"platform": "gpu", "kind": name,
                                  "count": torch.cuda.device_count()}})
    return 0


_KERNEL_OF = {"sha256_pairs": "sha256", "merkle_tree_root": "merkle",
              "validator_leaves": "validator_leaves", "altair_epoch": "altair_epoch",
              "merkle_levels": "merkle_levels", "merkle_inc": "merkle_inc",
              "validator_leaves_at": "validator_leaves_at"}


if __name__ == "__main__":
    sys.exit(main())
