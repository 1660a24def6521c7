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
   ``root_acc``, the columns and the justification state of a 2-epoch run
   are held against the plain path (``run_epochs_ref``) on the same card,
   and a 1,024-validator run against the CPU path;
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
   internal word caught by the scrub and healed by ``quarantine_rebuild``;
8. shuffle: ``shuffle_permutation_device`` at mainnet's 90 rounds for
   2^20 lanes (the registry) and 1,000,000 (not a multiple of 256), two
   seeds each; every permutation held against the plain chain on the card
   (``single_block_words``, ``sha256_single_block_ref``,
   ``shuffle_rounds_ref``) and the numpy host form. Time of the whole call
   and its host share: the pivots, the blocks, K7 and K8;
9. epoch_phase0: phase0 mainnet at 1,000,000 validators (``bench.py``'s
   epoch section), the ``example_inputs`` columns, a warm-up, then 8
   chained epochs that feed balances and effective balances back in; held
   against ``epoch_accounting_ref`` on the card and, at 1,024 validators,
   against the CPU path. ms/epoch and K9's share of the card;
10. merkle_many: a full serving flush of 64 trees (``max_batch``) through
   ``merkleize_many_device`` at depth 12 (the device threshold of 4,096
   chunks) and 16, filled raggedly (tree i holds 2^d - 37 i chunks); every
   root held against the plain batched reduction on the card, one against
   hashlib.

Phase 3 also holds K7 (sha256_single_block), K8 (shuffle_rounds), K9
(phase0_epoch, on the example columns and every phase0 corner) and K2's
batched entry (merkle_many_tree_root) against their plain versions at the
shapes of phases 8-10. Each path runs with every launch counter at 0 just
before it and read just after. Then the ``{"kernels": [...]}`` line
(``launches``: the counts of the kernel's own path, the state_inc main path
for K1-K6; ``launches_by_path``: each path's) and, last, ``{"ok": true,
"device": {...}}``. Any failure raises and the script exits non-zero
without the last line; so does a machine without CUDA, or a directory
without the package.
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
PLAIN_EPOCHS = 2  # epochs of the main path held against the plain path
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
# two 32-bit instructions that may issue on either pipe. K9 (phase0) does
# about as many over its three launches.
OPS_EPOCH_PER_VALIDATOR = 2 * 120
# K8: 32-bit instructions per lane and round at the least: the flip and its
# wrap (2), the max (1), the table address (4), the load (1), the byte and
# bit extraction (6), the select and the loop (2).
OPS_SHUFFLE_LANE_ROUND = 16
# A warp dispatches at most one instruction per clock, so a message hashed
# by one thread takes at least its 2,288 instructions' worth of clocks; at
# the boost clock above, that is the floor of each level of K5's path update
# and of K6, whose levels run one after another.
CLOCK_HZ = 1.98e9
MESSAGE_SERIAL_S = (LOGIC_PER_MESSAGE + ADDS_PER_MESSAGE) / CLOCK_HZ


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def bound(nbytes: float, messages: float = 0, other_ops: float = 0,
          serial_messages: int = 0, single_blocks: float = 0) -> tuple[float, str]:
    """Least milliseconds for ``nbytes`` of HBM traffic, ``messages`` SHA-256
    pair hashes, ``single_blocks`` lone data compressions and ``other_ops``
    integer instructions free to use either pipe: the larger of the bytes'
    time and the busier pipe's time, or of ``serial_messages`` hashes that
    depend one on the next."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    logic = messages * LOGIC_PER_MESSAGE + single_blocks * LOGIC_DATA_COMPRESSION
    every = (logic + messages * ADDS_PER_MESSAGE + single_blocks * ADDS_DATA_COMPRESSION
             + other_ops)
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
        device_ms=device_ms(lambda: altair_epoch.altair_epoch_accounting(params, cols, just),
                            ("epoch_sums_kernel", "epoch_apply_kernel")),
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


def per_call_ms(prof: dict, calls: int) -> dict:
    """Device milliseconds per call of each kernel in a profile of ``calls``
    calls: its mean time times its launches per call (its count over
    ``calls``, rounded, at least one), so a launch the tracer loses does not
    count as zero."""
    return {name: ms / prof["counts"][name] * max(1, round(prof["counts"][name] / calls))
            for name, ms in prof["by_name"].items()}


def device_ms(fn, prefixes: tuple) -> float:
    """Device milliseconds of one fn() in the kernels whose names start with
    ``prefixes``, from torch.profiler over INNER calls back to back. Beside
    the CUDA-event time, which reads the host's enqueue rate when the host
    is slower than the card."""
    per = per_call_ms(device_profile(lambda: [fn() for _ in range(INNER)]), INNER)
    mine = [ms for name, ms in per.items() if name.startswith(prefixes)]
    if not mine:
        raise RuntimeError(f"the trace holds no kernel named {prefixes}")
    return sum(mine)


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

    # the plain path is about 2,000 times slower: held over PLAIN_EPOCHS
    short = run_epochs(params, cols, just, PLAIN_EPOCHS, with_root="state", static=static, device=dev)
    t0 = time.perf_counter()
    ref = run_epochs_ref(params, cols, just, PLAIN_EPOCHS, with_root="state", static=static,
                         device=dev)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3 / PLAIN_EPOCHS
    carry_8 = carry
    carry = short
    for name, got, want in (
        ("root_acc", carry.root_acc, ref.root_acc),
        *((f"cols.{f}", getattr(carry.cols, f), getattr(ref.cols, f))
          for f in ("balance", "effective_balance", "inactivity_scores")),
        *((f"just.{f}", getattr(carry.just, f), getattr(ref.just, f)) for f in carry.just._fields),
    ):
        if not torch.equal(got, want):
            raise RuntimeError(f"main path {name} differs from the plain path on the card")
    carry = carry_8
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
        plain_ms_per_epoch=plain_ms, plain_epochs_held=PLAIN_EPOCHS, messages_per_epoch=messages,
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


SHUFFLE_SIZES = (N_VALIDATORS, 1_000_000)  # the registry, and one that leaves a short last chunk
PHASE0_VALIDATORS = 1_000_000  # bench.py's epoch section
FLUSH_DEPTHS = (12, 16)  # the device threshold of 4,096 chunks, and a wide subtree


def shuffle_seed(i: int) -> bytes:
    return hashlib.sha256(f"chip_smoke shuffle seed {i}".encode()).digest()


def ragged_flush(depth: int, trees: int, seed: int):
    """``trees`` uint8 chunk arrays, tree i holding 2^depth - 37 i chunks (or none)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, (max((1 << depth) - 37 * i, 0), 32), dtype=np.uint8)
            for i in range(trees)]


def check_slice3_kernels(dev):
    """Phase 3, continued: K7, K8, K9 and K2's batched entry at the shapes of
    the shuffle, epoch_phase0 and merkle_many phases, each against its plain
    version."""
    import numpy as np
    import torch

    from eth_consensus_specs_tpu_torch.config import MAX_BATCH, phase0_epoch_params, shuffle_round_count
    from eth_consensus_specs_tpu_torch.inputs import PHASE0_CORNERS, example_inputs, phase0_corner_inputs
    from eth_consensus_specs_tpu_torch.ops import merkle, sha256, shuffle, state_columns

    rows = []
    rounds = shuffle_round_count("mainnet")

    # K7 and K8 at the registry: 90 rounds x 4,096 chunks of decision blocks
    n = N_VALIDATORS
    chunks = (n + 255) // 256
    seed = shuffle_seed(0)
    blocks = shuffle.single_block_words(seed, rounds, chunks, dev)
    digests = sha256.sha256_single_block(blocks)
    err = max_abs_err(digests, sha256.sha256_single_block_ref(blocks))
    got = digests[[0, chunks - 1, rounds * chunks - 1]].cpu().numpy().view(np.uint32).astype(">u4")
    for row, (r, c) in zip(got, ((0, 0), (0, chunks - 1), (rounds - 1, chunks - 1))):
        if row.tobytes() != hashlib.sha256(seed + bytes([r]) + c.to_bytes(4, "little")).digest():
            raise RuntimeError(f"sha256_single_block of round {r} chunk {c} differs from hashlib")
    msgs = rounds * chunks
    b_ms, b_by = bound(96 * msgs, single_blocks=msgs)
    k7_ms = cuda_ms(lambda: sha256.sha256_single_block(blocks), inner=INNER)
    rows.append(dict(
        name="sha256_single_block", route="cuda", source="eth_consensus_specs_tpu_torch/csrc/sha256.cu",
        replaces="eth_consensus_specs_tpu/ops/sha256.py:137", shape=[msgs, 16], max_abs_err=err,
        ms=k7_ms, plain_ms=cuda_ms(lambda: sha256.sha256_single_block_ref(blocks), 3),
        device_ms=device_ms(lambda: sha256.sha256_single_block(blocks), ("sha256_single_block",)),
        bound_ms=b_ms, bound_by=b_by, library_ms=None, work_compressions=msgs,
        compressions_per_s=msgs / (k7_ms / 1e3), hashlib_checked=3,
    ))

    pivots = torch.tensor(shuffle.pivots(n, seed, rounds), dtype=torch.int32, device=dev)
    err = 0
    for size in SHUFFLE_SIZES + (1, 257):
        c = (size + 255) // 256
        piv = torch.tensor(shuffle.pivots(size, seed, rounds), dtype=torch.int32, device=dev)
        dig = digests.reshape(rounds, chunks, 8)[:, :c].reshape(-1, 8).contiguous()
        err = max(err, max_abs_err(shuffle.shuffle_rounds(dig, piv, size),
                                   shuffle.shuffle_rounds_ref(dig, piv, size)))
    b_ms, b_by = bound(32 * msgs + 4 * rounds + 4 * n, other_ops=n * rounds * OPS_SHUFFLE_LANE_ROUND)
    k8_ms = cuda_ms(lambda: shuffle.shuffle_rounds(digests, pivots, n), inner=INNER)
    rows.append(dict(
        name="shuffle_rounds", route="cuda", source="eth_consensus_specs_tpu_torch/csrc/shuffle.cu",
        replaces="eth_consensus_specs_tpu/ops/shuffle.py:78", shape=[n, rounds], max_abs_err=err,
        ms=k8_ms, plain_ms=cuda_ms(lambda: shuffle.shuffle_rounds_ref(digests, pivots, n), 5),
        device_ms=device_ms(lambda: shuffle.shuffle_rounds(digests, pivots, n), ("shuffle_rounds",)),
        bound_ms=b_ms, bound_by=b_by, library_ms=None, lane_rounds=n * rounds,
        lane_rounds_per_s=n * rounds / (k8_ms / 1e3), l2_table_bytes=32 * msgs,
        sizes_checked=list(SHUFFLE_SIZES) + [1, 257],
    ))

    # K9 on the example columns and each corner the example never reaches
    n = PHASE0_VALIDATORS
    err, checked = 0, []
    for preset in ("mainnet", "minimal"):
        params = phase0_epoch_params(preset)
        half = params.epochs_per_slashings_vector // 2
        for case in ("example",) + (PHASE0_CORNERS if preset == "mainnet" else ()):
            if case == "example":
                cols, just = example_inputs(n, slashings_half_vector=half, device=dev)
            else:
                cols, just = phase0_corner_inputs(case, n, slashings_half_vector=half, device=dev)
            got = state_columns.epoch_accounting(params, cols, just)
            want = state_columns.epoch_accounting_ref(params, cols, just)
            err = max([err] + [max_abs_err(g, w) for g, w in zip(got, want)])
            checked.append(f"{preset}:{case}")
    params = phase0_epoch_params("mainnet")
    cols, just = example_inputs(n, device=dev)
    col_bytes = sum(t.element_size() * t.numel() for t in cols)
    b_ms, b_by = bound(col_bytes + 4 * 8 * n, other_ops=n * OPS_EPOCH_PER_VALIDATOR)
    rows.append(dict(
        name="phase0_epoch", route="cuda", source="eth_consensus_specs_tpu_torch/csrc/state_columns.cu",
        replaces="eth_consensus_specs_tpu/ops/state_columns.py:232", shape=[n], max_abs_err=err,
        ms=cuda_ms(lambda: state_columns.epoch_accounting(params, cols, just), inner=INNER),
        device_ms=device_ms(lambda: state_columns.epoch_accounting(params, cols, just), ("phase0_",)),
        plain_ms=cuda_ms(lambda: state_columns.epoch_accounting_ref(params, cols, just), 5),
        bound_ms=b_ms, bound_by=b_by, library_ms=None, work_validators=n,
        bytes_per_validator=(col_bytes + 4 * 8 * n) / n, corners_checked=checked,
    ))

    # K2's batched entry at a full flush: 64 trees of 2^12 leaves; of 2^16
    # timed only (phase 10 holds every root of that flush against the plain
    # version)
    timed = {}
    for depth in FLUSH_DEPTHS:
        words = torch.stack([merkle.chunks_to_words(torch.from_numpy(t).to(dev), 1 << depth)
                             for t in ragged_flush(depth, MAX_BATCH, depth)])
        hashes = MAX_BATCH * merkle.tree_real_hashes(depth)
        b_ms, b_by = bound(32 * MAX_BATCH * ((1 << depth) + 1), hashes)
        k_ms = cuda_ms(lambda: merkle.many_tree_root(words, depth), inner=INNER)
        timed[depth] = dict(ms=k_ms, bound_ms=b_ms, bound_by=b_by,
                            device_ms=device_ms(lambda: merkle.many_tree_root(words, depth),
                                                ("merkle_reduce_kernel",)),
                            compressions_per_s=2 * hashes / (k_ms / 1e3))
    d = FLUSH_DEPTHS[0]
    words = torch.stack([merkle.chunks_to_words(torch.from_numpy(t).to(dev), 1 << d)
                         for t in ragged_flush(d, MAX_BATCH, d)])
    err = max_abs_err(merkle.many_tree_root(words, d), merkle.many_tree_root_ref(words, d))
    for trees, depth in ((3, 0), (3, 1), (5, 9), (2, 10)):
        if depth > d:
            continue
        w = words[:trees, : 1 << depth].contiguous()
        max_abs_err(merkle.many_tree_root(w, depth), merkle.many_tree_root_ref(w, depth))
    rows.append(dict(
        name="merkle_many_tree_root", route="cuda", source="eth_consensus_specs_tpu_torch/csrc/merkle.cu",
        replaces="eth_consensus_specs_tpu/ops/merkle.py:97", shape=[MAX_BATCH, 1 << d, 8],
        max_abs_err=err, ms=timed[d]["ms"], device_ms=timed[d]["device_ms"],
        plain_ms=cuda_ms(lambda: merkle.many_tree_root_ref(words, d), 2),
        bound_ms=timed[d]["bound_ms"], bound_by=timed[d]["bound_by"],
        library_ms=None, work_compressions=2 * MAX_BATCH * ((1 << d) - 1),
        compressions_per_s=timed[d]["compressions_per_s"], depth16=timed[FLUSH_DEPTHS[1]],
    ))
    return rows


def run_shuffle(dev) -> tuple[dict, dict]:
    """Phase 8: the committee shuffle at the registry's width, held against
    the plain chain on the card and the numpy host form."""
    import numpy as np
    import torch

    from eth_consensus_specs_tpu_torch import _ext
    from eth_consensus_specs_tpu_torch.config import shuffle_round_count
    from eth_consensus_specs_tpu_torch.ops import sha256, shuffle

    rounds = shuffle_round_count("mainnet")
    seeds = [shuffle_seed(i) for i in range(2)]
    shuffle.shuffle_permutation_device(1000, seeds[0], rounds, device=dev)  # warm-up
    torch.cuda.synchronize()
    _ext.reset_launches()
    perms, first = {}, {}
    for n in SHUFFLE_SIZES:
        for i, seed in enumerate(seeds):
            t0 = time.perf_counter()
            perms[n, i] = shuffle.shuffle_permutation_device(n, seed, rounds, device=dev)
            torch.cuda.synchronize()
            first[f"{n}:{i}"] = (time.perf_counter() - t0) * 1e3
    launches = dict(_ext.launches)

    host_s = {}
    for (n, i), perm in perms.items():
        seed = seeds[i]
        chunks = (n + 255) // 256
        piv = torch.tensor(shuffle.pivots(n, seed, rounds), dtype=torch.int32, device=dev)
        plain = shuffle.shuffle_rounds_ref(
            sha256.sha256_single_block_ref(shuffle.single_block_words(seed, rounds, chunks, dev)), piv, n)
        _equal_or_raise(f"shuffle n={n} seed {i} vs the plain chain", [("perm", perm, plain)])
        t0 = time.perf_counter()
        host = shuffle.shuffle_permutation(n, seed, rounds)
        host_s[f"{n}:{i}"] = time.perf_counter() - t0
        if not np.array_equal(perm.cpu().numpy(), host):
            raise RuntimeError(f"shuffle n={n} seed {i} differs from the numpy host form")

    # the whole call and its parts at the registry's width
    n, seed = N_VALIDATORS, seeds[1]
    chunks = (n + 255) // 256
    whole = []
    for _ in range(REPEATS):
        t0 = time.perf_counter()
        shuffle.shuffle_permutation_device(n, seed, rounds, device=dev)
        torch.cuda.synchronize()
        whole.append((time.perf_counter() - t0) * 1e3)
    piv_ms = []
    for _ in range(REPEATS):
        t0 = time.perf_counter()
        piv = torch.tensor(shuffle.pivots(n, seed, rounds), dtype=torch.int32).to(dev)
        torch.cuda.synchronize()
        piv_ms.append((time.perf_counter() - t0) * 1e3)
    blocks_host = []
    for _ in range(REPEATS):
        t0 = time.perf_counter()
        blocks = shuffle.single_block_words(seed, rounds, chunks, dev)
        torch.cuda.synchronize()
        blocks_host.append((time.perf_counter() - t0) * 1e3)
    digests = sha256.sha256_single_block(blocks)
    parts = dict(
        pivots_host_ms=statistics.median(piv_ms), blocks_host_ms=statistics.median(blocks_host),
        blocks_device_ms=cuda_ms(lambda: shuffle.single_block_words(seed, rounds, chunks, dev)),
        k7_ms=cuda_ms(lambda: sha256.sha256_single_block(blocks)),
        k8_ms=cuda_ms(lambda: shuffle.shuffle_rounds(digests, piv, n)),
    )
    ms = statistics.median(whole)
    prof = device_profile(lambda: shuffle.shuffle_permutation_device(n, seed, rounds, device=dev))
    summary = dict(
        phase="shuffle", preset="mainnet", rounds=rounds, sizes=list(SHUFFLE_SIZES), seeds=2,
        launches=launches, first_call_ms=first, ms=ms, ms_runs=whole, parts=parts,
        device_busy_ms=prof["device_busy_ms"],
        device_idle_share=(1 - prof["device_busy_ms"] / ms) if prof["device_busy_ms"] else None,
        device_top_kernels=prof["top"], numpy_host_s=host_s,
        equal_plain_chain=True, equal_numpy=True,
    )
    return summary, launches


def run_epoch_phase0(dev) -> tuple[dict, dict]:
    """Phase 9: 8 chained phase0 accounting epochs at 1,000,000 validators."""
    import torch

    from eth_consensus_specs_tpu_torch import _ext
    from eth_consensus_specs_tpu_torch.config import phase0_epoch_params
    from eth_consensus_specs_tpu_torch.inputs import example_inputs
    from eth_consensus_specs_tpu_torch.ops.state_columns import epoch_accounting, epoch_accounting_ref

    params = phase0_epoch_params("mainnet")
    cols, just = example_inputs(PHASE0_VALIDATORS, device=dev)

    def chain(c, fn=epoch_accounting, epochs=EPOCHS):
        res = None
        for _ in range(epochs):
            res = fn(params, c, just)
            c = c._replace(balance=res.balance, effective_balance=res.effective_balance)
        return c, res

    chain(cols)  # warm-up
    torch.cuda.synchronize()
    times = []
    for i in range(TIMED_RUNS):
        if i == 0:
            _ext.reset_launches()
        t0 = time.perf_counter()
        out, res = chain(cols)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3 / EPOCHS)
        if i == 0:
            launches = dict(_ext.launches)
    ref_cols, ref_res = chain(cols, epoch_accounting_ref)
    _equal_or_raise("phase0 epochs vs plain on the card",
                    [(f"result.{f}", getattr(res, f), getattr(ref_res, f)) for f in res._fields]
                    + [("cols.balance", out.balance, ref_cols.balance),
                       ("cols.effective_balance", out.effective_balance, ref_cols.effective_balance)])
    if not bool((out.balance != cols.balance).any()):
        raise RuntimeError("phase0 epochs left every balance unchanged")

    prof = device_profile(lambda: chain(cols))
    per_epoch = per_call_ms(prof, EPOCHS)
    busy = sum(per_epoch.values())
    k9 = sum(ms for k, ms in per_epoch.items() if k.startswith("phase0_"))
    s_cols, s_just = example_inputs(1024, device=dev)
    gpu = epoch_accounting(params, s_cols, s_just)
    cpu = epoch_accounting(params, *(type(x)(*(t.cpu() for t in x)) for x in (s_cols, s_just)))
    _equal_or_raise("phase0 1,024 card vs CPU", [(f, getattr(gpu, f).cpu(), getattr(cpu, f))
                                                 for f in gpu._fields])
    ms = statistics.median(times)
    summary = dict(
        phase="epoch_phase0", fork="phase0", preset="mainnet", n_validators=PHASE0_VALIDATORS,
        epochs=EPOCHS, ms_per_epoch=ms, ms_per_epoch_runs=times, launches=launches,
        launches_per_epoch={k: v / EPOCHS for k, v in launches.items()},
        device_busy_ms_per_epoch=busy, k9_ms_per_epoch=k9,
        k9_share_of_busy=k9 / busy if busy else None, k9_share_of_epoch=k9 / ms,
        device_idle_share=(1 - busy / ms) if busy else None, device_top_kernels=prof["top"], equal_plain=True, n1024_equal_cpu=True,
        finalized_epoch=int(res.finalized_epoch),
    )
    return summary, launches


def run_merkle_many(dev) -> tuple[dict, dict]:
    """Phase 10: a full serving flush of ragged subtrees at depths 12 and 16."""
    import numpy as np
    import torch

    from eth_consensus_specs_tpu_torch import _ext
    from eth_consensus_specs_tpu_torch.config import MAX_BATCH
    from eth_consensus_specs_tpu_torch.ops import merkle

    flushes = {d: ragged_flush(d, MAX_BATCH, 100 + d) for d in FLUSH_DEPTHS}
    merkle.merkleize_many_device([t[:16] for t in flushes[FLUSH_DEPTHS[0]][:2]], 4, pad_batch=2,
                                 device=dev)  # warm-up
    torch.cuda.synchronize()
    _ext.reset_launches()
    roots, flush_ms = {}, {}
    for d, trees in flushes.items():
        t0 = time.perf_counter()
        roots[d] = merkle.merkleize_many_device(trees, d, pad_batch=MAX_BATCH, device=dev)
        flush_ms[d] = (time.perf_counter() - t0) * 1e3
    launches = dict(_ext.launches)

    per_depth = {}
    for d, trees in flushes.items():
        words = torch.stack([merkle.chunks_to_words(torch.from_numpy(t).to(dev), 1 << d) for t in trees])
        plain = merkle.many_tree_root_ref(words, d).cpu().numpy().view(np.uint32).astype(">u4")
        if [r.tobytes() for r in plain] != roots[d]:
            raise RuntimeError(f"merkle_many depth {d}: a root differs from the plain reduction")
        if hashlib_tree_root(merkle.chunks_to_words(trees[1], 1 << d).numpy().view(np.uint32)) != roots[d][1]:
            raise RuntimeError(f"merkle_many depth {d}: tree 1's root differs from hashlib")
        runs = []
        for _ in range(5):
            t0 = time.perf_counter()
            merkle.merkleize_many_device(trees, d, pad_batch=MAX_BATCH, device=dev)
            runs.append((time.perf_counter() - t0) * 1e3)
        per_depth[d] = dict(first_flush_ms=flush_ms[d], flush_ms=statistics.median(runs), flush_runs=runs,
                            kernel_ms=cuda_ms(lambda: merkle.many_tree_root(words, d), inner=INNER),
                            chunks=sum(len(t) for t in trees), trees=len(trees))
    summary = dict(phase="merkle_many", trees=MAX_BATCH, depths=list(FLUSH_DEPTHS), launches=launches,
                   per_depth=per_depth, equal_plain=True, hashlib_checked=True)
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

    t0 = time.perf_counter()
    rows = check_kernels(dev) + check_forest_kernels(dev) + check_slice3_kernels(dev)
    emit(dict(phase="kernels_checked", kernels=[r["name"] for r in rows], nvidia_smi=smi,
              phase_s=time.perf_counter() - t0))

    by_path = {}
    for path, phase in (("state", run_main_path), ("state_inc", run_state_inc),
                        ("dirty_registry", run_dirty_registry), ("durability", run_durability),
                        ("shuffle", run_shuffle), ("epoch_phase0", run_epoch_phase0),
                        ("merkle_many", run_merkle_many)):
        t0 = time.perf_counter()
        summary, by_path[path] = phase(dev)
        summary["phase_s"] = time.perf_counter() - t0
        summary["nvidia_smi"] = smi
        emit(summary)

    for r in rows:
        key = _KERNEL_OF[r["name"]]
        r["launches"] = by_path[_PATH_OF.get(r["name"], "state_inc")].get(key, 0)
        r["launches_by_path"] = {path: counts.get(key, 0) for path, counts in by_path.items()}
    missing = [r["name"] for r in rows if not any(r["launches_by_path"].values())]
    missing += [r["name"] for r in rows if r["name"] in _PATH_OF and not r["launches"]]
    emit({"kernels": rows})
    if missing:
        raise RuntimeError(f"kernels never launched on their paths: {missing}")
    emit({"ok": True, "device": {"platform": "gpu", "kind": name,
                                  "count": torch.cuda.device_count()}})
    return 0


_KERNEL_OF = {"sha256_pairs": "sha256", "merkle_tree_root": "merkle",
              "validator_leaves": "validator_leaves", "altair_epoch": "altair_epoch",
              "merkle_levels": "merkle_levels", "merkle_inc": "merkle_inc",
              "validator_leaves_at": "validator_leaves_at",
              "sha256_single_block": "sha256_single_block", "shuffle_rounds": "shuffle",
              "phase0_epoch": "state_columns", "merkle_many_tree_root": "merkle_many"}
# the path whose counts a kernel's row reports, where it is not state_inc
_PATH_OF = {"sha256_single_block": "shuffle", "shuffle_rounds": "shuffle",
            "phase0_epoch": "epoch_phase0", "merkle_many_tree_root": "merkle_many"}


if __name__ == "__main__":
    sys.exit(main())
