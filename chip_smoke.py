#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``eth_consensus_specs_tpu_torch``) on one card.

    python3 chip_smoke.py

Phases, each printing one JSON line:

1. device: the card's name, and its name and power limit as nvidia-smi
   reports them (also printed alone on its own line);
2. build: every CUDA kernel of the port compiled from ``csrc/`` (one nvcc
   per source, all at once), with the seconds it took;
3. kernels: each kernel (K1 sha256_pairs, K2 merkle tree_root and its
   list-root entry list_roots, K3 validator_leaves and its indexed entry
   validator_leaves_at, K4 altair_epoch, the forest update forest_update
   and its mark pass forest_mark, K5's compaction merkle_inc) called at the
   paths' shapes and held bit for bit (``torch.equal``) against its plain
   torch version on the same card and inputs; K1, K2 and the forest update
   also against hashlib; K1 at [3, 16], traced, and in bulk; K3's indexed
   entry at 4,096 rows on and off its table of first pair hashes (the
   table against hashlib), one launch a call. The forest update at a ``state_inc`` epoch's three
   trees, at ``dirty_registry``'s 4,096 crossings and on all-dirty trees of
   2^18 and 2^20 leaves (one launch a call, its dirty parents, bytes and
   chain), and as the path update of 4,072 paths at depth 20; K5's
   compaction beside ``torch.nonzero_static`` on the same mask, each by
   events and traced; K4 at one launch a call, with its SASS a validator.
   K2 at the 2^20 registry tree and at the slot
   root's batch (the balances as 2^20 u64, both participation lists as 2^20
   bytes, folded and length-mixed), with its launches a call and its chain
   of dependent pair hashes (``serial_bound_ms``). Median times with CUDA
   events, the plain version's time, and the least time the card could
   take;
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
   against ``with_root="state"``; epoch times and the forest update's
   share of the card;
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
   against the CPU path. ms/epoch, K9's share of the card and its launches
   an epoch (one);
10. merkle_many: a full serving flush of 64 trees (``max_batch``) through
   ``merkleize_many_device`` at depth 12 (the device threshold of 4,096
   chunks) and 16, filled raggedly (tree i holds 2^d - 37 i chunks); every
   root held against the plain batched reduction on the card, one against
   hashlib;
11. bls_block: ``verify_many`` on a deneb mainnet block (128 aggregates over
   128 distinct messages, fresh messages each call): a warm call, three
   timed calls with their host stages (``parts_ms``) apart from the card's
   time, a block with item 17 tampered (exactly that verdict false), and
   every verdict of the checked blocks against the host oracle's per-item
   FastAggregateVerify in a pool of worker processes. The committee is cut
   from 512 to a fixed 128, printed as ``reduced`` with the measured host
   key-validation time that justifies it: the run fails if twice the
   committee's one-time validation would fit 60 s. Its 128 distinct messages
   hash to G2 through K13 and K14 (``hash_to_field`` on the host), timed
   apart in ``parts_ms`` (``h2c.*``) and by CUDA events;
12. agg_slot: one mainnet slot at 2^20 validators, 32,768 attesters in 64
   committees of 512 over 64 subnets, every 17th abstaining, 2 roots, 2
   invalid committees (``inputs.slot_committees``, the defaults of
   ``scripts/agg_bench.py`` but mainnet's committee): ``aggregate_slot`` on
   the card (K15 and K10 at each tier) held against ``aggregate_slot_host``
   at every tier (points, bytes, bits), ``verify_slot`` (false on every root
   that holds an invalid committee, true on a root once its invalid
   committee is dropped), ``isolate_invalid_subnets`` equal to the injected
   (subnet, root) set; ms per slot of each, signatures aggregated per
   second;
13. kzg_flush: ``verify_many_blobs`` on a 64-blob serving flush of full
   4096-element blobs (``scripts/das_bench.py``'s defaults: degree-8
   polynomials, the tampered items at i * 64 / 2), two of them dense
   ``sample_blob`` triples so that K16 sees full rows: a warm flush, three
   timed clean flushes with their stages (``parts_ms``: parse, words, K16,
   Horner, Fiat-Shamir, packing, K17, K11 + K12), three with items 0 and 32
   tampered (the bisection, 23 RLC checks); the clean flush against the
   host batch oracle, the tampered items and two clean ones against the
   per-item oracle; K16, K17, K11 and K12 timed on one flush's inputs;
14. das_fft: ``bench.py``'s das cell at its card size, 8 chained forward
   FFTs over 16 rows of 8192 points, fresh values each repeat, the last
   chain held against the plain version on the card;
15. slot: the whole slot at 2^20 validators through ``serve/slot.SlotWorld``
   (altair minimal, durable commits into a temporary directory): a warm slot
   on a separate world, then one epoch of 8 mainnet-shaped slots (64
   attestations of 512-member committees, a 512-index sync aggregate, 6
   sparse blobs; one attestation of slot 2, the sync aggregate of slot 4 and
   one blob of slot 5 spoiled; slot 7 closes the epoch): ms per slot and its
   phases (verify, aggregate, re-root, commit), the card's busy time by CUDA
   events around every launch, launches per slot. Verdicts against the
   construction, aggregates against the host's, every root against the full
   root of the plain scatter chain, slots 2 and 7 whole against
   ``host_slot_fold``; a fresh world restores and replays slot 5 unchanged.
   The distinct keys are cut to 16,384 (``reduced``), by bls_block's rule;
16. block_epoch: ``bench.py``'s block_epoch cell at its card size (BASELINE
   config #4): an epoch of blocks over the dense plane through
   ``ops.block_epoch.block_epoch_chain``, deneb mainnet, 2^20 validators, 32
   slots of 128 attestation rows x 512 lanes, a 512-index sync aggregate, 16
   deposits a slot, the withdrawal sweep and a state root every slot (one K19
   launch a slot, the root two K2 launches: the lists, the top). The first 4 slots against the
   plain chain on the card; a warm chain, then 5 timed chains from fresh
   balance columns: ms an epoch against the 1 s limit, ms a slot, host
   enqueue, K19's and the root's event ms a slot, the card's busy time,
   launches an epoch; the last chain's digest sha256(acc || balance) against
   the port's numpy replay with hashlib roots (``ops/block_epoch_host.py``,
   the 32 roots in a process pool);
17. gt_export: ``pairing_device`` (K11, then K20) of 4 pairs (a G1, b G2)
   and one at infinity, against the host ``pairing`` and bilinearity; ms a
   pairing and the kernels' event ms.

Phase 3 also holds K7 (sha256_single_block), K8 (shuffle_rounds), K9
(phase0_epoch, on the example columns and every phase0 corner; one launch a
call, its SASS a validator) and K2's
batched entry (merkle_many_tree_root) against their plain versions at the
shapes of phases 8-10, and K10 (g1_sum_many at [128, 512], [8, 32768],
``agg_slot``'s tier-0 [1, 512], the slot's [64, 512] and corner items,
against (sum of k) * G on the host; each shape's launches a call read from
its counter), K11 (miller_product at
1, 2, 31, 32, 33 and 129 pairs, some inactive, against the host Miller
loops; 20 launches each giving the same words), K12 (final_exp_is_one on 1,
on 0, on a product that is 1, one that is not and the 129-pair product,
against the host; 20 launches each) and the cooperative tower's check entry
(fq12_coop_check: an Fq12 product, both squarings and a line product on a
batch, one lane and four lanes an Fq product, word for word against the plain
tower, and each split's time a round), K13 (h2c_map) and K14 (h2c_finish) at a block's 128
messages plus rows holding u = 0 and u with c1 = 0 (against the host
``hash_to_g2`` and ``map_to_curve_g2``; K13's square root alone also on
values in Fq, the branch no message is known to reach), and K15
(g2_sum_many at ``agg_slot``'s tier shapes [1, 512], [64, 1] and [2, 32],
at [64, 512], each shape's launches a call against its plan's passes, and
on corner items: all infinity, one lane, P + P, P - P, ragged, sums that
meet across the passes' boundaries, against the host ``_sum_g2``;
``agg_slot`` holds K15 and K10 word
for word against their plain versions again on each tier's own points),
K16 (fr_fft at the flush's [64, 4096] inverse, the das cell's [16, 8192]
both ways and n = 2, 4, 8, 16, on dense rows and corner rows, word for word
and against the host ``fft_field``; one launch a call, traced time, the Fr
product's SASS count) and K17 (g1_msm_many at [2, 129],
[2, 65], [2, 7], [2, 3], [1, 300] and on scalar and point corners, word for word
and on affine points against the host ``msm_g1``; every shape but [3, 2],
whose four half-lanes fill one block, spans several blocks and takes the
fold), and K18 (slot_apply and
slot_apply_scatter at 2^20 validators, at the slot cell's lane counts and on
duplicate, end, already-set, wrapping and empty plans), K19 (block_slot at
2^20 validators x 128 rows x 512 lanes on the cell's first slot and every
corner of ``inputs.block_slot_corners``: a window that wraps, full and partial
payloads, repeated rows, unpaid runs, the proposer in the sync committee,
repeated sync indices, duplicate deposits, values at and above 2^63, an
all-pad slot, bits set first in one pay group and carried again after the
last pay row) and K20 (final_exp_gt on 4 Miller values, against its plain
version and the host ``final_exponentiation``, over 20 repeated launches;
K12's verdict against K20 == 1).
Each path runs with every launch counter at 0 just
before it and read just after. Then the ``{"kernels": [...]}`` line
(``launches``: the counts of the kernel's own paths, the state_inc main path
for K1-K6 and the forest update, both kzg_flush and das_fft for K16, summed over its kernels where
an entry launches two, as K2's tree_root and list_roots, K10's lanes passes and fold, K11's loop
and fold, K17's lanes and fold and K18's copy and scatter; ``launches_by_path``: each path's; every kernel must have launched on
one of its own paths, but those that no path runs since the forest update,
K5's compaction, K3's indexed entry and the mark pass, and K1 since K2's
list launch took the checkpoints, each held by its own check and marked
``launched_by`` with the reason; the epoch, durability, slot and
block_epoch paths fail if they launch K1) and, last, ``{"ok": true,
"device": {...}}``. Any failure raises and the script exits non-zero
without the last line; so does a machine without CUDA, or a directory
without the package. On every exit the script stops what it started and
what is left of it: the process pools' workers, multiprocessing's resource
tracker and, the script being their subreaper, their orphans.
"""

from __future__ import annotations

import functools
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
# about as many.
OPS_EPOCH_PER_VALIDATOR = 2 * 120
# K8: 32-bit instructions per lane and round at the least: the flip and its
# wrap (2), the max (1), the table address (4), the load (1), the byte and
# bit extraction (6), the select and the loop (2).
OPS_SHUFFLE_LANE_ROUND = 16
# A warp dispatches at most one instruction per clock, so a message hashed
# by one thread takes at least its 2,288 instructions' worth of clocks; at
# the boost clock above, that is the floor of each level of a tree's climb
# (K2, the forest update), whose levels run one after another.
CLOCK_HZ = 1.98e9
MESSAGE_SERIAL_S = (LOGIC_PER_MESSAGE + ADDS_PER_MESSAGE) / CLOCK_HZ
# An L2 hit's latency on Hopper, about 260 SM clocks in published
# microbenchmarks (Luo et al., "Benchmarking and Dissecting the Nvidia
# Hopper GPU Architecture", 2024); not measured here. K3's indexed entry
# reads its first pair hash from a table in L2.
L2_READ_CLOCKS = 260
CORNER_ROWS = [0, 1, 2, 3, 6, 8, 9, 10]  # K3's indexed corners that miss its table


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


def host_us(fn, calls: int = INNER) -> float:
    """Host microseconds a call of fn(): the host clock around ``calls``
    calls with no synchronisation inside, median of 20."""
    import torch

    times = []
    for _ in range(20):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        times.append((time.perf_counter() - t0) / calls * 1e6)
    torch.cuda.synchronize()
    return statistics.median(times)


def max_abs_err(a, b) -> int:
    import torch

    if not torch.equal(a, b):
        diff = (a.to(torch.float64) - b.to(torch.float64)).abs().max().item()
        raise RuntimeError(f"kernel result differs from its plain version (max abs err {diff})")
    return 0


def check_kernels(dev, k4_sass: dict):
    """Phase 3: each kernel against its plain version at the main path's shapes."""
    import numpy as np
    import torch

    from eth_consensus_specs_tpu_torch import _ext
    from eth_consensus_specs_tpu_torch.config import epoch_params
    from eth_consensus_specs_tpu_torch.inputs import (
        ALTAIR_CORNERS, altair_corner_inputs, example_altair_inputs)
    from eth_consensus_specs_tpu_torch.ops import altair_epoch, merkle, sha256, state_root
    from eth_consensus_specs_tpu_torch.ops import block_epoch_host as beh

    n = N_VALIDATORS
    gen = torch.Generator().manual_seed(7)

    def words(rows, cols):
        w = torch.randint(-(1 << 31), 1 << 31, (rows, cols), generator=gen, dtype=torch.int64)
        return w.to(torch.int32).to(dev)

    rows = []

    # K1 at the shape the epoch paths gave it until K2's list launch took
    # the three checkpoints: no path launches it now (own check)
    msgs = words(3, 16)
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
    b_ms, b_by = bound(96 * 3, 3)
    bulk_ms = cuda_ms(lambda: sha256.sha256_pairs(bulk), inner=INNER)
    rows.append(dict(
        name="sha256_pairs", route="cuda", source="eth_consensus_specs_tpu_torch/csrc/sha256.cu",
        replaces="eth_consensus_specs_tpu/ops/sha256.py:153", shape=[3, 16], max_abs_err=err,
        ms=cuda_ms(lambda: sha256.sha256_pairs(msgs), inner=INNER),
        device_ms=device_ms(lambda: sha256.sha256_pairs(msgs), ("sha256_pairs_kernel",)),
        plain_ms=cuda_ms(lambda: sha256.sha256_pairs_ref(msgs), 5),
        bound_ms=b_ms, bound_by=b_by, library_ms=None, work_compressions=6,
        serial_bound_ms=MESSAGE_SERIAL_S * 1e3,  # the three pair hashes side by side
        hashlib_checked=int(corner.shape[0]), bulk_rows=n, bulk_ms=bulk_ms,
        bulk_bound_ms=bound(96 * n, n)[0],
        bulk_compressions_per_s=2 * n / (bulk_ms / 1e3),
    ))

    # K2 at the registry tree (2^20 leaves, depth 20) and at the slot root's
    # batch: the balances (2^20 u64, 2^18 chunks) and both participation
    # lists (2^20 bytes, 2^15 chunks each), packed, folded and length-mixed
    depth = n.bit_length() - 1
    leaves = words(1 << depth, 8)
    _ext.reset_launches()
    got = merkle.tree_root(leaves, depth)
    tree_launches = dict(_ext.launches)
    err = max_abs_err(got, merkle.tree_root_ref(leaves, depth))
    if words_bytes(got) != hashlib_tree_root(leaves.cpu().numpy().view(np.uint32)):
        raise RuntimeError("merkle tree_root at 2^20 leaves differs from hashlib")
    for d in (depth - 2, depth - 5, 5, 1, 0):
        max_abs_err(merkle.tree_root(leaves[: 1 << d], d), merkle.tree_root_ref(leaves[: 1 << d], d))
    hashes = merkle.tree_real_hashes(depth)
    b_ms, b_by = bound(32 * (1 << depth) + 32, hashes)
    k_ms = cuda_ms(lambda: merkle.tree_root(leaves, depth), inner=INNER)

    lists, slot_msgs, slot_chain = slot_batch(dev, n, gen)
    _ext.reset_launches()
    roots = merkle.list_roots(lists)
    slot_launches = dict(_ext.launches)
    if sum(tree_launches.values()) != 1 or sum(slot_launches.values()) != 1:
        raise RuntimeError(f"K2 launched {tree_launches} for a tree, {slot_launches} for a slot")
    err = max(err, max_abs_err(roots, merkle.list_roots_ref(lists)))
    for t, root in zip(lists, roots):
        raw = t.src.cpu().numpy().tobytes()
        if words_bytes(root) != beh.list_root_bytes(beh._chunks(raw), t.n, t.limit):
            raise RuntimeError(f"merkle list_roots: the {t.src.dtype} list differs from hashlib")
    slot_bytes = sum(t.src.element_size() * t.n for t in lists) + 32 * len(lists)
    s_ms, s_by = bound(slot_bytes, slot_msgs)
    slot_ms = cuda_ms(lambda: merkle.list_roots(lists), inner=INNER)
    rows.append(dict(
        name="merkle_tree_root", route="cuda", source="eth_consensus_specs_tpu_torch/csrc/merkle.cu",
        replaces="eth_consensus_specs_tpu/ops/merkle.py:68", shape=[1 << depth, 8], max_abs_err=err,
        ms=k_ms, device_ms=device_ms(lambda: merkle.tree_root(leaves, depth), ("merkle_lists",)),
        plain_ms=cuda_ms(lambda: merkle.tree_root_ref(leaves, depth), 3),
        bound_ms=b_ms, bound_by=b_by, serial_bound_ms=depth * MESSAGE_SERIAL_S * 1e3,
        library_ms=None, work_compressions=2 * hashes, compressions_per_s=2 * hashes / (k_ms / 1e3),
        launches_a_call=sum(tree_launches.values()), hashlib_checked=True,
        slot_batch=dict(
            shape=[[str(t.src.dtype).split(".")[-1], t.n, t.limit] for t in lists],
            ms=slot_ms,
            device_ms=device_ms(lambda: merkle.list_roots(lists), ("merkle_lists",)),
            plain_ms=cuda_ms(lambda: merkle.list_roots_ref(lists), 3),
            bound_ms=s_ms, bound_by=s_by, serial_bound_ms=slot_chain * MESSAGE_SERIAL_S * 1e3,
            chain_messages=slot_chain, messages=slot_msgs,
            launches_a_call=sum(slot_launches.values()), hashlib_checked=True),
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
    call = lambda: altair_epoch.altair_epoch_accounting(params, cols, just)  # noqa: E731
    _ext.reset_launches()
    call()
    k4_launches = dict(_ext.launches)
    if k4_launches != {"altair_epoch": 1}:
        raise RuntimeError(f"K4 launched {k4_launches} for one epoch")
    rows.append(dict(
        name="altair_epoch", route="cuda", source="eth_consensus_specs_tpu_torch/csrc/altair_epoch.cu",
        replaces="eth_consensus_specs_tpu/ops/altair_epoch.py:142", shape=[n], max_abs_err=err,
        ms=cuda_ms(call, inner=INNER), device_ms=device_ms(call, ("altair_epoch_kernel",)),
        plain_ms=cuda_ms(lambda: altair_epoch.altair_epoch_accounting_ref(params, cols, just), 5),
        bound_ms=b_ms, bound_by=b_by, library_ms=None, work_validators=n,
        launches_a_call=k4_launches["altair_epoch"],
        sass_per_validator=k4_sass.get("per_validator"), sass=k4_sass,
        corners_checked=[f"{fork}:{case}" for fork in ("electra", "deneb") for case in ALTAIR_CORNERS],
    ))
    return rows


def words_bytes(root) -> bytes:
    """int32[8] root words on any device -> the root's 32 bytes."""
    import numpy as np

    return root.cpu().numpy().view(np.uint32).astype(">u4").tobytes()


def slot_batch(dev, n: int, gen):
    """The slot root's three lists at n validators (``ops/block_epoch.slot_root``):
    random balances as u64, participation flags as u8, each length-mixed
    and folded to its SSZ limit. Returns the lists, the pair hashes they
    need (``merkle.live_hashes``, the folds and the mixes) and the longest
    chain of pair hashes among them (the tree's depth, its fold, its mix)."""
    import torch

    from eth_consensus_specs_tpu_torch.ops import merkle
    from eth_consensus_specs_tpu_torch.ops.state_root import (BALANCE_LIMIT_CHUNKS_LOG2,
                                                              PARTICIPATION_LIMIT_CHUNKS_LOG2)

    bal = torch.randint(0, 1 << 62, (n,), generator=gen, dtype=torch.int64).to(dev)
    part = [torch.randint(0, 8, (n,), generator=gen, dtype=torch.int64).to(torch.uint8).to(dev)
            for _ in range(2)]
    lists = [merkle.ListTree(bal, n, BALANCE_LIMIT_CHUNKS_LOG2, n)] + [
        merkle.ListTree(p, n, PARTICIPATION_LIMIT_CHUNKS_LOG2, n) for p in part]
    msgs = chain = 0
    for t in lists:
        d = merkle.tree_depth(t)
        msgs += merkle.live_hashes(merkle.chunk_count(t), d) + t.limit - d + 1
        chain = max(chain, t.limit + 1)
    return lists, msgs, chain


def hashlib_tree_root(leaves) -> bytes:
    """Root of a power-of-two leaf level (uint32[L, 8] big-endian words) by hashlib."""
    level = [row.astype(">u4").tobytes() for row in leaves]
    while len(level) > 1:
        level = [hashlib.sha256(level[i] + level[i + 1]).digest() for i in range(0, len(level), 2)]
    return level[0]


def dirty_parents(leaves, depth: int) -> int:
    """Internal nodes above a set of dirty leaf indices (int64, any device):
    the pair hashes the forest kernel runs for them."""
    import torch

    total, level = 0, leaves
    for _ in range(depth):
        level = torch.unique(level >> 1)
        total += level.numel()
    return total


def forest_work(trees) -> dict:
    """The need of one forest_update call over ``trees`` (kinds u64,
    registry, all): the dirty leaves and parents of each tree, the bytes
    (each value read once, each written row once, a dirty validator's
    static rows), the messages (the dirty parents and three a dirty
    validator) and the longest chain of dependent pair hashes (a tree's
    depth, three more for a registry leaf)."""
    import torch

    from eth_consensus_specs_tpu_torch.ops import merkle_inc

    work = dict(dirty=[], parents=[], nbytes=0, messages=0, chain=0)
    for t in trees:
        depth = merkle_inc.forest_depth(t)
        batch = t.nodes.shape[0] if t.nodes.dim() == 3 else 1
        if t.kind == "all":
            leaves = torch.arange(1 << depth, device=t.nodes.device)
            work["nbytes"] += batch * 32 * (1 << depth)  # the leaf rows read
        else:
            diff = t.old != t.new
            if t.kind == "u64":
                live = merkle_inc.live_leaves(t)
                diff = torch.cat([diff, diff.new_zeros(live * t.per - diff.shape[0])])
                diff = diff.reshape(live, t.per).any(1)
            leaves = torch.nonzero(diff).reshape(-1)
            work["nbytes"] += 16 * t.old.shape[0] + 32 * leaves.numel()
        parents = dirty_parents(leaves, depth)
        dirty = leaves.numel()
        work["nbytes"] += batch * 32 * parents
        work["messages"] += batch * parents
        if t.kind == "registry":
            work["nbytes"] += 96 * dirty
            work["messages"] += 3 * dirty
        if dirty:
            work["chain"] = max(work["chain"], depth + 3 * (t.kind == "registry"))
        work["dirty"].append(dirty)
        work["parents"].append(batch * parents)
    return work


def check_forest_kernels(dev):
    """Phase 3, continued: the forest update (one launch for every tree of
    the forest), its mark pass, K5's compaction and K3's indexed entry at
    the incremental paths' shapes, each against its plain version."""
    import numpy as np
    import torch

    from eth_consensus_specs_tpu_torch import _ext
    from eth_consensus_specs_tpu_torch.config import epoch_params
    from eth_consensus_specs_tpu_torch.inputs import example_altair_inputs, lower_balances
    from eth_consensus_specs_tpu_torch.ops import altair_epoch, merkle, merkle_inc, state_root
    from eth_consensus_specs_tpu_torch.parallel.resident import build_state_forest_device

    n = N_VALIDATORS
    depth = n.bit_length() - 1
    gen = torch.Generator().manual_seed(11)
    params = epoch_params("deneb", "mainnet")
    static = state_root.synthetic_static(n, seed=0, device=dev)
    arrays = static[0]

    def words(*shape):
        w = torch.randint(-(1 << 31), 1 << 31, shape, generator=gen, dtype=torch.int64)
        return w.to(torch.int32).to(dev)

    def clone(trees):
        return [t._replace(nodes=t.nodes.clone()) for t in trees]

    def root_bytes(nodes) -> bytes:
        return nodes.reshape(-1, 8)[-1].cpu().numpy().view(np.uint32).astype(">u4").tobytes()

    def timed(trees, label):
        """One forest_update call over ``trees`` against the plain twin on
        clones, its launches, times and bounds."""
        want = clone(trees)
        _ext.reset_launches()
        got_counts = merkle_inc.forest_update(trees)
        torch.cuda.synchronize()
        calls = dict(_ext.launches)
        if calls != {"forest_update": 1}:
            raise RuntimeError(f"forest_update {label}: launches {calls}, expected one")
        want_counts = merkle_inc.forest_update_ref(want)
        for g, w in zip(got_counts, want_counts):
            if (g is None) != (w is None) or (g is not None and not torch.equal(g, w)):
                raise RuntimeError(f"forest_update {label}: dirty counts {g} against {w}")
        err = max(max_abs_err(t.nodes, w.nodes) for t, w in zip(trees, want))
        work = forest_work(trees)
        if [int(c) for c in got_counts if c is not None] != [
                d for t, d in zip(trees, work["dirty"]) if t.kind != "all"]:
            raise RuntimeError(f"forest_update {label}: counts disagree with the diff")
        b_ms, b_by = bound(work["nbytes"], work["messages"])
        call = lambda: merkle_inc.forest_update(trees)  # noqa: E731
        plain = lambda: merkle_inc.forest_update_ref(want)  # noqa: E731
        return dict(max_abs_err=err, launches_a_call=1, ms=cuda_ms(call, inner=INNER),
                    plain_ms=cuda_ms(plain, 2), bound_ms=b_ms, bound_by=b_by,
                    serial_bound_ms=work["chain"] * MESSAGE_SERIAL_S * 1e3,
                    chain_pair_hashes=work["chain"], dirty=work["dirty"],
                    parents_hashed=work["parents"], messages=work["messages"],
                    bytes=work["nbytes"], kinds=[t.kind for t in trees])

    def epoch_trees(cols, forest, plan):
        """One accounting epoch's registry, balance and score trees, as
        ``state_root._update_forest`` hands them to the kernel."""
        just = example_altair_inputs(n, device=dev)[1]
        new = altair_epoch.altair_epoch_accounting(params, cols, just)
        p = merkle_inc.ForestTree
        return [p(forest.val_nodes[0], "registry", cols.effective_balance, new.effective_balance,
                  static=(arrays.slashed_chunk, arrays.val_node_a, arrays.val_node_f),
                  cap=plan.cap_val, dense=plan.dense_val),
                p(forest.bal_nodes[0], "u64", cols.balance, new.balance, cap=plan.cap_bal,
                  dense=plan.dense_bal),
                p(forest.inact_nodes[0], "u64", cols.inactivity_scores, new.inactivity_scores,
                  cap=plan.cap_bal, dense=plan.dense_bal)]

    rows = []

    # the forest update: a state_inc epoch's three trees (the example
    # columns), dirty_registry's (4,096 crossings), and every level of an
    # all-dirty tree at 2^18 and 2^20 leaves; buffers against the plain
    # twin, roots against K2's tree root and hashlib. Timed by events only:
    # the tracer loses later phases' kernels after many windows in one
    # process (tools/forest_times.py traces these shapes)
    cols, _ = example_altair_inputs(n, device=dev)
    shapes = {}
    for label, c in (("state_inc_epoch", cols), ("dirty_registry_epoch",
                                                 lower_balances(cols, every=256))):
        forest, plan = build_state_forest_device(static, c, device=dev)
        trees = epoch_trees(c, forest, plan)
        shapes[label] = timed(trees, label)
        leaves = merkle_inc._u64_chunks(trees[1].new, 4, 1 << plan.depth_bal)
        if root_bytes(trees[1].nodes) != hashlib_tree_root(leaves.cpu().numpy().view(np.uint32)):
            raise RuntimeError(f"forest_update {label}: balance root differs from hashlib")
        del forest, trees
    if shapes["dirty_registry_epoch"]["dirty"][0] != n // 256:
        raise RuntimeError(f"dirty_registry crossings {shapes['dirty_registry_epoch']['dirty']}")
    for d in (depth - 2, depth):
        leaves = words(1 << d, 8)
        nodes = leaves.new_zeros((merkle_inc.tree_nodes(d), 8))
        nodes[:1 << d] = leaves
        shapes[f"all_dirty_2^{d}"] = timed([merkle_inc.ForestTree(nodes, "all")], f"2^{d}")
        if not torch.equal(nodes[-1], merkle.tree_root(leaves, d)):
            raise RuntimeError(f"forest_update root at depth {d} differs from merkle tree_root")
        if d == depth - 2 and root_bytes(nodes) != hashlib_tree_root(
                leaves.cpu().numpy().view(np.uint32)):
            raise RuntimeError("forest_update root differs from hashlib")
    # the batched rebuild (the scrub's 8 subtrees of 2^5 leaves) and the gate
    batch = words(8, 32, 8)
    built = merkle_inc.build_levels(batch)
    max_abs_err(built, merkle_inc.merkle_levels_ref(
        built.clone().index_fill_(1, torch.arange(32, 63, device=dev), 0)))
    full = merkle_inc.build_levels(words(64, 8))
    stale = full.clone()
    stale[64:] = 0
    five = torch.tensor([5], dtype=torch.int32, device=dev)
    max_abs_err(merkle_inc.merkle_levels(stale.clone(), five, 5), stale)  # 5 <= 5: closed
    max_abs_err(merkle_inc.merkle_levels(stale.clone(), five, 4), full)

    # the path update at depth 20: 4,000 distinct leaves, 48 of their
    # siblings, 24 repeats, then padding the count leaves out: the mark pass
    # and the forest kernel over the marked leaves
    cap = 4096
    nodes = merkle_inc.build_levels(words(1 << depth, 8))
    new_leaves = words(1 << depth, 8)
    uniq = torch.randperm(1 << depth, generator=gen)[:4000]
    idx = torch.cat([uniq, uniq[:48] ^ 1, uniq[:24], torch.zeros(24, dtype=torch.int64)])
    idx = idx.to(torch.int32).to(dev)
    vals = new_leaves[idx.to(torch.int64)]
    live = 4000 + 48 + 24
    count = torch.tensor([live], dtype=torch.int32, device=dev)
    tree_k, tree_p = nodes.clone(), nodes.clone()
    _ext.reset_launches()
    merkle_inc.path_update(tree_k, idx, vals, count, cap)
    path_calls = dict(_ext.launches)
    merkle_inc.path_update_ref(tree_p, idx, vals, count, cap)
    path_err = max_abs_err(tree_k, tree_p)
    max_abs_err(tree_k, merkle_inc.build_levels(tree_k[:1 << depth].clone()))
    gated = nodes.clone()
    max_abs_err(merkle_inc.path_update(gated, idx, vals, count, live - 1), nodes)  # count > dense
    if merkle_inc._stream_scratch(tree_k.device).mask.any():
        raise RuntimeError("path_update left its scratch mask set")
    marked = idx[:live].to(torch.int64).unique()
    p_parents = dirty_parents(marked, depth)
    # the need: the indices and values read, the leaf rows and the dirty
    # parents written (no mask: JAX's path update scatters at the indices)
    p_ms, p_by = bound(live * 4 + 2 * 32 * marked.numel() + 32 * p_parents, p_parents)
    path = dict(
        ms=cuda_ms(lambda: merkle_inc.path_update(tree_k, idx, vals, count, cap), inner=INNER),
        plain_ms=cuda_ms(lambda: merkle_inc.path_update_ref(tree_p, idx, vals, count, cap), 3),
        bound_ms=p_ms, bound_by=p_by, serial_bound_ms=depth * MESSAGE_SERIAL_S * 1e3,
        launches_a_call=path_calls, live_paths=live, parents_hashed=p_parents,
        max_abs_err=path_err)
    main = shapes["state_inc_epoch"]
    rows.append(dict(
        name="forest_update", route="cuda",
        source="eth_consensus_specs_tpu_torch/csrc/forest_update.cu",
        replaces="eth_consensus_specs_tpu/ops/merkle_inc.py:170",
        also_replaces=["eth_consensus_specs_tpu/ops/merkle_inc.py:109",
                       "eth_consensus_specs_tpu/ops/merkle_inc.py:140",
                       "eth_consensus_specs_tpu/ops/merkle_inc.py:219",
                       "eth_consensus_specs_tpu/ops/state_root.py:721",
                       "eth_consensus_specs_tpu/ops/state_root.py:805"],
        shape=[n, 3], max_abs_err=max(r["max_abs_err"] for r in shapes.values()),
        ms=main["ms"], plain_ms=main["plain_ms"],
        bound_ms=main["bound_ms"], bound_by=main["bound_by"],
        serial_bound_ms=main["serial_bound_ms"], library_ms=None,
        launches_a_call=1, shapes=shapes, path_update=path,
        hashlib_checked=True, batch_checked=[8, 63, 8], gate_checked=True,
    ))

    # path_update's mark pass alone, into a mask zeroed beforehand (as
    # path_update's scratch mask is: the forest kernel resets it); the bound
    # is the scatter's need, the indices and values read, the rows written
    # and a byte marked for each
    mark_k, mark_p = nodes.clone(), nodes.clone()
    out = torch.zeros(1 << depth, dtype=torch.uint8, device=dev)
    err = max(max_abs_err(merkle_inc.mark_leaves(mark_k, idx, vals, count, cap, out=out),
                          merkle_inc.mark_leaves_ref(mark_p, idx, vals, count, cap)),
              max_abs_err(mark_k, mark_p))
    if merkle_inc.mark_leaves(nodes.clone(), idx, vals, count, live - 1).any():
        raise RuntimeError("mark_leaves ran past its sparse gate")
    m_ms, m_by = bound(live * 4 + 2 * 32 * live + live)
    rows.append(dict(
        name="forest_mark", route="cuda",
        source="eth_consensus_specs_tpu_torch/csrc/forest_update.cu",
        replaces="eth_consensus_specs_tpu/ops/merkle_inc.py:163", shape=[1 << depth, cap],
        max_abs_err=err,
        ms=cuda_ms(lambda: merkle_inc.mark_leaves(mark_k, idx, vals, count, cap, out=out),
                   inner=INNER),
        device_ms=device_ms(lambda: merkle_inc.mark_leaves(mark_k, idx, vals, count, cap, out=out),
                            ("forest_mark_kernel",)),
        plain_ms=cuda_ms(lambda: merkle_inc.mark_leaves_ref(mark_p, idx, vals, count, cap), 3),
        bound_ms=m_ms, bound_by=m_by, library_ms=None, live=live,
    ))

    # K5's compaction: a mask of 4,096 dirty leaves of 2^20 at the plan's
    # capacity, against torch.nonzero_static on the same mask (the library
    # call, timed here, used nowhere in the port); the registry's
    # effective-balance diff (4,096 crossings); a mask over capacity; a
    # balance column's chunk diff writing its leaf rows
    ids = torch.arange(n, device=dev)
    old_eff = cols.effective_balance
    new_eff = torch.where(ids % 256 == 0, old_eff - 10**9, old_eff)
    mask = old_eff != new_eff
    got = merkle_inc.dirty_indices(mask, cap)
    err = max(max_abs_err(g, w) for g, w in zip(got, merkle_inc.dirty_indices_ref(mask, cap)))
    library = lambda: torch.nonzero_static(mask, size=cap, fill_value=0)  # noqa: E731
    if not torch.equal(library().reshape(-1).to(torch.int32), got[0]):
        raise RuntimeError("torch.nonzero_static disagrees with K5's compaction")
    got = merkle_inc.dirty_leaves(old_eff, new_eff, 1, n, cap)
    err = max(err, *(max_abs_err(g, w) for g, w in zip(
        got, merkle_inc.dirty_leaves_ref(old_eff, new_eff, 1, n, cap))))
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
    c_ms, c_by = bound(n + 4 * cap + 4)
    d_ms, _ = bound(2 * 8 * n + 4 * cap + 4)
    compact = lambda: merkle_inc.dirty_indices(mask, cap)  # noqa: E731
    diff = lambda: merkle_inc.dirty_leaves(old_eff, new_eff, 1, n, cap)  # noqa: E731
    _ext.reset_launches()
    compact()
    diff()
    if dict(_ext.launches) != {"merkle_inc": 2}:
        raise RuntimeError(f"K5's compaction launched {dict(_ext.launches)} for two calls")
    rows.append(dict(
        name="merkle_inc", route="cuda", source="eth_consensus_specs_tpu_torch/csrc/merkle_inc.cu",
        replaces="eth_consensus_specs_tpu/ops/merkle_inc.py:125", shape=[n, cap], max_abs_err=err,
        # the kernel and the library call in turns, each by events and traced
        ms=cuda_ms(compact, inner=INNER), library_ms=cuda_ms(library, inner=INNER),
        device_ms=device_ms(compact, ("void dirty_compact_kernel",)),
        library_device_ms=device_total_ms(library),
        plain_ms=cuda_ms(lambda: merkle_inc.dirty_indices_ref(mask, cap), 3),
        bound_ms=c_ms, bound_by=c_by, launches_a_call=1,
        library_call="torch.nonzero_static(mask, size=4096, fill_value=0)",
        diff=dict(ms=cuda_ms(diff, inner=INNER),
                  device_ms=device_ms(diff, ("void dirty_compact_kernel",)),
                  plain_ms=cuda_ms(lambda: merkle_inc.dirty_leaves_ref(old_eff, new_eff, 1, n,
                                                                        cap), 3),
                  bound_ms=d_ms, bound_by="bytes"),
        checked=["mask at capacity against nonzero_static", "registry diff at capacity",
                 "mask over capacity", "chunk diff with leaf rows"],
    ))

    # K3's indexed entry: 4,096 gathered rows, some past the registry; its
    # table of B = H(chunk(eff), slashed_chunk) built at the first call
    vargs = (cols.effective_balance, arrays.slashed_chunk, arrays.val_node_a, arrays.val_node_f)
    _ext.reset_launches()
    table = state_root.b_table(cols.effective_balance.device)
    table_launches = dict(_ext.launches)
    err = max_abs_err(table, state_root.b_table_ref(dev))
    inc = state_root.EFFECTIVE_BALANCE_INCREMENT
    for k, s in ((0, 0), (2048, 1), (32, 1)):
        want = hashlib.sha256((k * inc).to_bytes(8, "little") + bytes(24) + bytes([s])
                              + bytes(31)).digest()
        if words_bytes(table[2 * k + s]) != want:
            raise RuntimeError(f"K3's table row {2 * k + s} differs from hashlib")
    idx = torch.cat([torch.randint(0, n, (cap - 64,), generator=gen),
                     torch.randint(n, n + 1000, (32,), generator=gen),
                     -torch.randint(1, 100, (32,), generator=gen)]).to(torch.int32).to(dev)
    err = max(err, max_abs_err(state_root.validator_leaves_at(*vargs, idx),
                               state_root.validator_leaves_at_ref(*vargs, idx)))
    part = torch.tensor([3000], dtype=torch.int32, device=dev)
    max_abs_err(state_root.validator_leaves_at(*vargs, idx, part, cap),
                state_root.validator_leaves_at_ref(*vargs, idx, part, cap))
    if state_root.validator_leaves_at(*vargs, idx, part, 2999).any():
        raise RuntimeError("validator_leaves_at ran past its sparse gate")
    # the rows off the table: effective balances off the increments and
    # past 2048 of them, 2^63, 2^64 - 1; slashed chunks with another word set
    corner_eff = torch.tensor([inc + 1, 2049 * inc, -(1 << 63), -1, 2048 * inc, 0, 7, 32 * inc],
                              dtype=torch.int64, device=dev)
    c_eff = cols.effective_balance.clone()
    c_slashed = arrays.slashed_chunk.clone()
    c_eff[:8] = corner_eff
    c_slashed[8:12] = 0
    c_slashed[8, 3] = 1
    c_slashed[9, 0], c_slashed[9, 7] = state_root.SLASHED_WORD, -1
    c_slashed[10, 0] = 2
    c_args = (c_eff, c_slashed, arrays.val_node_a, arrays.val_node_f)
    c_idx = torch.cat([torch.arange(16, device=dev), idx[:cap - 16].long()]).to(torch.int32)
    max_abs_err(state_root.validator_leaves_at(*c_args, c_idx),
                state_root.validator_leaves_at_ref(*c_args, c_idx))
    if not bool((state_root.b_table_row(c_eff[:16], c_slashed[:16])[CORNER_ROWS] == -1).all()):
        raise RuntimeError("K3's corner rows do not miss its table as built")
    valid = torch.randint(0, n, (cap,), generator=gen).to(torch.int32).to(dev)
    v_long = valid.long()
    def share(args) -> float:  # of the timed rows, those whose B the table serves
        return float((state_root.b_table_row(args[0][v_long], args[1][v_long]) >= 0).double().mean())

    _ext.reset_launches()
    state_root.validator_leaves_at(*vargs, valid)
    at_launches = dict(_ext.launches)
    if at_launches != {"validator_leaves_at": 1}:
        raise RuntimeError(f"K3's indexed entry launched {at_launches} in one call")
    # the same rows with every effective balance off the increments: each row
    # hashes B, the chain of three with its loads hoisted
    h_args = (vargs[0] + 1, *vargs[1:])
    b_ms, b_by = bound(cap * (4 + 8 + 3 * 32 + 32), 3 * cap)
    rows.append(dict(
        name="validator_leaves_at", route="cuda",
        source="eth_consensus_specs_tpu_torch/csrc/validator_leaves.cu",
        replaces="eth_consensus_specs_tpu/ops/state_root.py:721", shape=[cap], max_abs_err=err,
        ms=cuda_ms(lambda: state_root.validator_leaves_at(*vargs, valid), inner=INNER),
        device_ms=device_ms(lambda: state_root.validator_leaves_at(*vargs, valid),
                            ("validator_leaves_at_kernel",)),
        plain_ms=cuda_ms(lambda: state_root.validator_leaves_at_ref(*vargs, valid), 5),
        bound_ms=b_ms, bound_by=b_by, library_ms=None, work_compressions=6 * cap,
        # a row's three pair hashes depend one on the next
        serial_bound_ms=3 * MESSAGE_SERIAL_S * 1e3,
        # the design's chain: B read from the table, then two pair hashes
        design_chain_bound_ms=(L2_READ_CLOCKS / CLOCK_HZ + 2 * MESSAGE_SERIAL_S) * 1e3,
        table_share=share(vargs), launches_a_call=at_launches["validator_leaves_at"],
        table_build_launches=table_launches.get("validator_b_table", 0),
        hashed=dict(table_share=share(h_args),
                    ms=cuda_ms(lambda: state_root.validator_leaves_at(*h_args, valid), inner=INNER),
                    device_ms=device_ms(lambda: state_root.validator_leaves_at(*h_args, valid),
                                        ("validator_leaves_at_kernel",))),
        host_us=host_us(lambda: state_root.validator_leaves_at(*vargs, valid)),
        checked=["4,096 rows, 64 past the registry", "the sparse gate open and closed",
                 "16 rows on and off the table", "the table against its plain version and "
                 "hashlib"],
    ))
    torch.cuda.empty_cache()  # the plain twins' 2^20 temporaries
    return rows


OPEN_KERNELS = 256  # spin kernels that open a trace window
OPEN_KERNEL_NAME = "::spin_kernel("  # torch.cuda._sleep's kernel, in the trace's key


def device_profile(fn) -> dict:
    """Kernel time on the card during fn(), from torch.profiler's CUDA
    activity events (each kernel, memcpy and memset counted once)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        # the tracer misses the first kernels of its window, more of them the
        # longer the process has run (none at the start, a dozen and more
        # three minutes into the kernel checks): open it with spin kernels
        # that take the loss, left out of the sums, and a pause
        for _ in range(OPEN_KERNELS):
            torch.cuda._sleep(1)
        torch.cuda.synchronize()
        time.sleep(0.1)
        fn()
        torch.cuda.synchronize()
    rows = [
        (e.key, e.self_device_time_total / 1e3, e.count)
        for e in prof.key_averages()
        if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0
        and OPEN_KERNEL_NAME not in e.key
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
    is slower than the card. The tracer has been seen to lose a whole
    window's kernels after many windows in one process: a window that holds
    none of them is traced again, five times at most, each after the
    allocator's cached blocks are released and a pause."""
    import torch

    for attempt in range(5):
        if attempt:
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
            time.sleep(1.0)
        per = per_call_ms(device_profile(lambda: [fn() for _ in range(INNER)]), INNER)
        mine = [ms for name, ms in per.items() if name.startswith(prefixes)]
        if mine:
            return sum(mine)
    raise RuntimeError(f"the trace holds no kernel named {prefixes} (it holds {sorted(per)[:8]}; "
                       f"{torch.cuda.memory_reserved() / 2**30:.1f} GiB reserved)")


def device_total_ms(fn) -> float:
    """Device milliseconds of one fn() in every kernel it runs (a library
    call's, whatever their names), from torch.profiler over INNER calls."""
    return sum(per_call_ms(device_profile(lambda: [fn() for _ in range(INNER)]), INNER).values())


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
    forest_ms = sum(ms for k, ms in prof["by_name"].items() if "forest_update_kernel" in k)
    traced = {k.split("(")[0]: c for k, c in prof["counts"].items()}
    summary = dict(
        phase="dirty_registry", n_validators=N_VALIDATORS, lowered_every=256, epochs=EPOCHS,
        dirty_per_epoch=dirty, branches=_branches(dirty, plan), launches=launches,
        ms_per_epoch=statistics.median(runs8), ms_per_epoch_runs=runs8,
        first_epoch_ms=statistics.median(runs1), first_epoch_ms_runs=runs1,
        first_epoch_device_busy_ms=prof["device_busy_ms"], first_epoch_forest_ms=forest_ms,
        first_epoch_forest_share=(forest_ms / prof["device_busy_ms"] if prof["device_busy_ms"]
                                  else None),
        # the trace is whole when it holds every launch of the epoch
        first_epoch_traced_launches={k: traced.get(k, 0) for k in (
            "altair_epoch_kernel", "forest_update_kernel")},
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


def check_slice3_kernels(dev, k9_sass: dict):
    """Phase 3, continued: K7, K8, K9 and K2's batched entry at the shapes of
    the shuffle, epoch_phase0 and merkle_many phases, each against its plain
    version."""
    import numpy as np
    import torch

    from eth_consensus_specs_tpu_torch import _ext
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
    # the design's L2 traffic at most: every step writes X (4 B a lane) and
    # reads the bits at the pairs' upper ends (half the round's table), every
    # step but the first reads X
    rows.append(dict(
        name="shuffle_rounds", route="cuda", source="eth_consensus_specs_tpu_torch/csrc/shuffle.cu",
        replaces="eth_consensus_specs_tpu/ops/shuffle.py:78", shape=[n, rounds], max_abs_err=err,
        ms=k8_ms, plain_ms=cuda_ms(lambda: shuffle.shuffle_rounds_ref(digests, pivots, n), 5),
        device_ms=device_ms(lambda: shuffle.shuffle_rounds(digests, pivots, n), ("shuffle_rounds",)),
        bound_ms=b_ms, bound_by=b_by, library_ms=None, lane_rounds=n * rounds,
        lane_rounds_per_s=n * rounds / (k8_ms / 1e3), l2_table_bytes=32 * msgs,
        design_l2_bytes=rounds * (4 * n + 16 * chunks) + (rounds - 1) * 4 * n,
        grid_barriers=rounds - 1, sizes_checked=list(SHUFFLE_SIZES) + [1, 257],
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
    call = lambda: state_columns.epoch_accounting(params, cols, just)  # noqa: E731
    _ext.reset_launches()
    call()
    k9_launches = dict(_ext.launches)
    if k9_launches != {"state_columns": 1}:
        raise RuntimeError(f"K9 launched {k9_launches} for one epoch")
    if not state_columns.stream_scratch(dev).eq(0).all():
        raise RuntimeError("K9 left its sums' scratch set")
    rows.append(dict(
        name="phase0_epoch", route="cuda", source="eth_consensus_specs_tpu_torch/csrc/state_columns.cu",
        replaces="eth_consensus_specs_tpu/ops/state_columns.py:232", shape=[n], max_abs_err=err,
        ms=cuda_ms(call, inner=INNER), device_ms=device_ms(call, ("phase0_",)),
        plain_ms=cuda_ms(lambda: state_columns.epoch_accounting_ref(params, cols, just), 5),
        bound_ms=b_ms, bound_by=b_by, library_ms=None, work_validators=n,
        bytes_per_validator=(col_bytes + 4 * 8 * n) / n, corners_checked=checked,
        launches_a_call=k9_launches["state_columns"],
        sass_per_validator=k9_sass.get("per_validator"), sass=k9_sass,
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
        _ext.reset_launches()
        merkle.many_tree_root(words, depth)
        launches = sum(_ext.launches.values())
        if launches != 1:
            raise RuntimeError(f"K2's batched entry took {launches} launches at depth {depth}")
        k_ms = cuda_ms(lambda: merkle.many_tree_root(words, depth), inner=INNER)
        timed[depth] = dict(ms=k_ms, bound_ms=b_ms, bound_by=b_by,
                            serial_bound_ms=depth * MESSAGE_SERIAL_S * 1e3,
                            device_ms=device_ms(lambda: merkle.many_tree_root(words, depth),
                                                ("merkle_lists",)),
                            launches_a_call=launches,
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
        serial_bound_ms=timed[d]["serial_bound_ms"], launches_a_call=timed[d]["launches_a_call"],
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
    if launches != {"state_columns": EPOCHS}:
        raise RuntimeError(f"epoch_phase0 launched {launches} for {EPOCHS} epochs")
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


# --- slice 4: batched BLS aggregate verification (K10-K12) -----------------------

BLS_ITEMS = 128  # MAX_ATTESTATIONS of a deneb block
BLS_COMMITTEE = 512  # 2^20 validators / (32 slots x 64 committees)
# bls_block's committee: the largest power of two whose one-time host key
# validation (2.4-3.6 ms a key measured on the H100 machine's host) fits
# KEY_BUDGET_S; fixed so that every run measures one workload
BLS_BLOCK_COMMITTEE = 128
ELECTRA_SHAPE = (8, 32768)  # 8 aggregates over 64 committees each
SLOT_K10_ITEMS = 64  # the slot's K10 items: its 64 attestations' committees of 512
BLS_TIMED_CALLS = 3
BLS_TAMPERED = 17
# K11's pair counts against the group (a pair) and block (2 pairs) sizes, and
# the inactive pairs among them
K11_CASES = ((1, ()), (2, (1,)), (31, (3,)), (32, ()), (33, (0, 32)), (129, (5, 64)))
COOP_BATCH = 8  # elements of the cooperative tower's check
COOP_WIDE = 129  # elements of its throughput timing: K11's pairs
COOP_REPS = (32, 64)  # chained rounds of its two timed runs
COOP_SEED = 9
KEY_BUDGET_S = 60.0  # the one-time host validation of the block's keys
# 32-bit instructions of one Fq product (12 x 32-bit CIOS Montgomery): 2 x 144
# multiply-adds for a * b and m * p, each an IMAD.WIDE, and about 160 carry
# additions. Fq additions are not counted, so the bounds below are low.
FQ_MUL_INSTR = 450
# One lane's chain for one Fq product split over L lanes of the cooperative
# tower (csrc/fp12_coop.cuh coop_mul<L>), counted as FQ_MUL_INSTR is: the
# lane's share of the multiply-adds and carry additions, FQ_MUL_INSTR / L,
# and the shuffles the split adds (a row's quotient and shifted low word, 24;
# the final gather of three 12-word vectors, 36). The tower allows 1, 2 and 4
# lanes; a product round's shortest chain is the 4-lane split's 172.5. The
# compiled code issues more (tools/fq_mul_sass.py counts its SASS).
FQ_ROUND_INSTR = FQ_MUL_INSTR / 4 + 2 * 12 + 3 * 12
# SASS instructions one lane issues for one Fq product on one lane, as the
# toolkit compiles it (tools/fq_mul_sass.py, nvcc 12.9, sm_90a: the PTX carry
# chains of csrc/bls_fp.cuh; 1244 for the C product before them). The
# one-lane bounds (``one_lane_bound_ms``) count a product at this many.
FQ_MUL_SASS = 1199
FQ_PER_G1_ADD = 16  # add-2007-bl: 11 products and 5 squarings
FQ_PER_FQ6_MUL = 18  # 6 Karatsuba Fq2 products of 3
FQ_PER_FQ12_MUL = 54  # Karatsuba over Fq6 (3 Fq6 products)
FQ_PER_FQ12_SQR = 36  # complex squaring: 2 Fq6 products
FQ_PER_LINE = 50  # 12 sparse Fq2 products (36), 12 py scalings, a5 (2)
# After the easy part of a final exponentiation every value lies in the
# cyclotomic subgroup, where a Granger-Scott squaring needs 9 Fq2 squarings
# of 2 products: what the chain needs, against the kernels' complex
# squaring (FQ_PER_FQ12_SQR), the design's count.
FQ_PER_CYC_SQR = 9 * 2


def powx_products(sqr: int) -> int:
    """The Fq products of a power by |x| (63 squarings, 5 products)."""
    return 63 * sqr + 5 * FQ_PER_FQ12_MUL


def committee_indices(items: int, lanes: int, keys_count: int, stride: int):
    """The key indices of a synthetic committee layout: item i takes keys
    (i * stride + j) mod keys_count for j < lanes."""
    return [[(i * stride + j) % keys_count for j in range(lanes)] for i in range(items)]


def miller_fq_products(pairs: int, steps: int, squarings: int) -> int:
    """The Fq products the Miller loops need: squarings and line products
    (the kernel's conversions of its canonical inputs are not counted)."""
    return pairs * (squarings * FQ_PER_FQ12_SQR + steps * FQ_PER_LINE)


def _fq12_inv_products() -> int:
    from eth_consensus_specs_tpu_torch.crypto.fields import P

    p2 = P - 2
    fq_inv = p2.bit_length() + bin(p2).count("1")
    fq2_inv = 2 + fq_inv + 2
    fq6_inv = 3 * 2 + 9 * 3 + fq2_inv  # 3 Fq2 squarings, 9 Fq2 products
    return 4 * FQ_PER_FQ6_MUL + fq6_inv


def final_exp_fq_products(sqr: int = FQ_PER_CYC_SQR) -> int:
    """The Fq products of K12's chain, without its input conversion, with
    ``sqr`` products a squaring after the easy part (the default: what
    the chain needs; FQ_PER_FQ12_SQR: the design's count)."""
    return (_fq12_inv_products() + 5 * powx_products(sqr) + 9 * FQ_PER_FQ12_MUL + sqr
            + 18 + 2 * 12)  # one Frobenius (6 Fq2 products), two p^2-Frobenius


def fq_window_inverse_products() -> int:
    """The Fq inverse as a Fermat chain in 4-bit windows over p - 2: the
    table x^2..x^15 in 4 rounds of independent products, then 4 squarings a
    window below the top bit and a product a nonzero window."""
    from eth_consensus_specs_tpu_torch.crypto.fields import P

    e = P - 2
    windows = (e.bit_length() - 1) // 4
    nonzero = sum(1 for i in range(windows) if (e >> (4 * i)) & 15)
    return 4 + 4 * windows + nonzero


def miller_rounds(pairs: int, steps: int, squarings: int) -> int:
    """K11's chain at full tower parallelism: a pair's squarings and lines,
    one product round each, then the product tree over the pairs."""
    return squarings + steps + (pairs - 1).bit_length()


def final_exp_rounds() -> int:
    """K12's chain at full tower parallelism: an Fq12 product, squaring,
    Frobenius map or line counts one product round. The Fq12 inverse is 7
    rounds and the Fq inverse's window chain; then the easy part's conj
    product, p^2-Frobenius and product; five powers by x (63 squarings and
    5 products each); the hard part's 10 other operations."""
    return 7 + fq_window_inverse_products() + 3 + 5 * (63 + 5) + 10


def round_bound(rounds: int, products: float,
                round_instr: float = FQ_ROUND_INSTR) -> tuple[float, str]:
    """Least milliseconds for a chain of ``rounds`` dependent product rounds
    (each one Fq product, ``round_instr`` instructions a lane at one a clock:
    by default the 4-lane split's) and for ``products`` Fq products of
    FQ_MUL_INSTR instructions spread over the card: the larger."""
    t_chain = rounds * round_instr / CLOCK_HZ * 1e3
    t_thru = products * FQ_MUL_INSTR / INT_OPS_PER_S * 1e3
    return max(t_chain, t_thru), "operations"


def fq_bound(products: float, serial_products: float) -> tuple[float, str]:
    """Least milliseconds for ``products`` Fq products spread over the card,
    or ``serial_products`` that depend one on the next (one warp, one
    instruction a clock): the larger of the two."""
    t_thru = products * FQ_MUL_INSTR / INT_OPS_PER_S * 1e3
    t_chain = serial_products * FQ_MUL_INSTR / CLOCK_HZ * 1e3
    return max(t_thru, t_chain), "operations"


def check_bls_kernels(dev):
    """Phase 3, continued: K10 at a deneb block's [128, 512], an electra
    block's [8, 32768], ``agg_slot``'s tier 0 [1, 512] and the slot's
    [64, 512], each shape's launches a call read from the counter, and on
    corner items; K11 at the pair counts of K11_CASES, some pairs inactive;
    K12 on 1, 0, a product that is 1, one that is not and the 129-pair
    product; the cooperative tower's check entry. Each against its plain
    version on the card and against the host oracle in canonical ints, K11
    and K12 also over REPEATS launches. K10's, K11's and K12's bounds are
    their chains of product rounds at full parallelism, a product on the
    4-lane split (``round_bound``; K10's chain is log2(L) round-engine adds
    of CURVE_ADD_ROUNDS); beside them the same chains at a one-lane product
    as ``one_lane_bound_ms`` and the one-thread chains as
    ``serial_bound_ms``."""
    import torch

    from eth_consensus_specs_tpu_torch import _ext
    from eth_consensus_specs_tpu_torch.crypto import pairing as oracle
    from eth_consensus_specs_tpu_torch.crypto.curve import g1_generator, g1_infinity
    from eth_consensus_specs_tpu_torch.crypto.hash_to_curve import hash_to_g2
    from eth_consensus_specs_tpu_torch.inputs import g1_keys
    from eth_consensus_specs_tpu_torch.ops import g1_msm
    from eth_consensus_specs_tpu_torch.ops import pairing_device as pd

    rows = []
    g = g1_generator()
    n_keys = BLS_ITEMS * BLS_COMMITTEE
    keys = g1_keys(n_keys)  # key k is (k + 1) * G

    def lanes_of(index_lists):
        return [[keys[k] for k in ks] for ks in index_lists]

    # K10: both block shapes, agg_slot's tier 0 and the slot's shape, every
    # sum against (sum of k) * G on the host
    shapes, timed = {}, {}
    for items, lanes, stride in ((BLS_ITEMS, BLS_COMMITTEE, BLS_COMMITTEE),
                                 (*ELECTRA_SHAPE, 4096), (1, BLS_COMMITTEE, BLS_COMMITTEE),
                                 (SLOT_K10_ITEMS, BLS_COMMITTEE, BLS_COMMITTEE)):
        idx = committee_indices(items, lanes, n_keys, stride)
        X, Y, Z = (torch.from_numpy(a).to(dev) for a in g1_msm.pack_lanes(lanes_of(idx)))
        out = g1_msm.sum_many(X, Y, Z)
        err = max_abs_err(out, g1_msm.sum_many_ref(X, Y, Z))
        got = g1_msm.sums_to_points(out)
        for i, ks in enumerate(idx):
            if got[i] != g.mul(sum(k + 1 for k in ks)):
                raise RuntimeError(
                    f"g1_sum_many [{items}, {lanes}] item {i} differs from the host sum")
        products = items * (lanes - 1) * FQ_PER_G1_ADD
        serial = (lanes.bit_length() - 1) * FQ_PER_G1_ADD
        rounds = (lanes.bit_length() - 1) * CURVE_ADD_ROUNDS
        b_ms, b_by = round_bound(rounds, products)
        b_bytes = 3 * 48 * items * lanes / HBM_BYTES_PER_S * 1e3
        before = _ext.launches["g1_sum"]
        g1_msm.sum_many(X, Y, Z)
        launches_a_call = _ext.launches["g1_sum"] - before
        if launches_a_call != len(g1_msm.sum_plan(lanes)) + 1:
            raise RuntimeError(f"g1_sum_many [{items}, {lanes}] launched {launches_a_call} "
                               "kernels, not its plan's passes and the fold")
        k_ms = cuda_ms(lambda: g1_msm.sum_many(X, Y, Z), repeats=10)
        shapes[(items, lanes)] = dict(
            shape=[items, lanes], max_abs_err=err, ms=k_ms,
            device_ms=device_ms(lambda: g1_msm.sum_many(X, Y, Z), ("g1_sum_", "void g1_sum_")),
            plain_ms=cuda_ms(lambda: g1_msm.sum_many_ref(X, Y, Z), 2),
            bound_ms=max(b_ms, b_bytes), bound_by=b_by if b_ms >= b_bytes else "bytes",
            product_rounds=rounds, round_instr=FQ_ROUND_INSTR,
            one_lane_bound_ms=round_bound(rounds, products, FQ_MUL_SASS)[0],
            serial_bound_ms=fq_bound(products, serial)[0],
            fq_products=products, serial_fq_products=serial, host_checked=items,
            launches_a_call=launches_a_call)
    # corner items at the deneb width: ragged, padded, P + P, P - P, all Z = 0
    p = keys[5]
    corners = [keys[:BLS_COMMITTEE], keys[:37], [p, p] + keys[10:20], [p, -p] + keys[20:30],
               [g1_infinity()] * BLS_COMMITTEE, [g1_infinity(), p, g1_infinity(), keys[9]]]
    X, Y, Z = (torch.from_numpy(a).to(dev) for a in g1_msm.pack_lanes(corners, BLS_COMMITTEE))
    out = g1_msm.sum_many(X, Y, Z)
    err = max_abs_err(out, g1_msm.sum_many_ref(X, Y, Z))
    want = []
    for pts in corners:
        acc = g1_infinity()
        for q in pts:
            acc = acc + q
        want.append(acc)
    if g1_msm.sums_to_points(out) != want:
        raise RuntimeError("g1_sum_many corner items differ from the host sums")
    deneb = shapes[(BLS_ITEMS, BLS_COMMITTEE)]
    rows.append(dict(
        name="g1_sum_many", route="cuda", source="eth_consensus_specs_tpu_torch/csrc/g1_sum.cu",
        replaces="eth_consensus_specs_tpu/ops/g1_msm.py:168",
        **{k: deneb[k] for k in ("shape", "ms", "device_ms", "plain_ms", "bound_ms", "bound_by")},
        max_abs_err=max(max(v["max_abs_err"] for v in shapes.values()), err), library_ms=None,
        electra=shapes[ELECTRA_SHAPE], agg_tier0=shapes[(1, BLS_COMMITTEE)],
        slot=shapes[(SLOT_K10_ITEMS, BLS_COMMITTEE)], corners_checked=len(corners),
        **{k: deneb[k] for k in ("launches_a_call", "product_rounds", "round_instr",
                                 "one_lane_bound_ms", "serial_bound_ms", "fq_products",
                                 "serial_fq_products")},
    ))

    # K11 at a block's 129 pairs (128 messages and the signature pair) and at
    # ragged counts against the group and block size, some pairs inactive
    qs = [hash_to_g2(b"smoke-pair-%d" % i) for i in range(BLS_ITEMS)]
    pairs = [(keys[i], qs[i]) for i in range(BLS_ITEMS)] + [(-g, qs[0])]
    host = {}  # host Miller values by pair index

    def host_product(idx):
        want = oracle.Fq12.one()
        for j in idx:
            if j not in host:
                pt, q = pairs[j]
                host[j] = oracle.miller_loop(pt, oracle.untwist(q))
            want = want * host[j]
        return want

    err, args, counts = 0, {}, {}
    for n, inactive in K11_CASES:
        chosen = [(g1_infinity(), q) if j in inactive else (pt, q)
                  for j, (pt, q) in enumerate(pairs[:n])]
        a = [torch.from_numpy(x).to(dev) for x in pd.pack_pairs(chosen)]
        got = pd.miller_product(*a)
        err = max(err, max_abs_err(got, pd.miller_product_ref(*a)))
        if pd.fq12_from_words(got) != host_product([j for j in range(n) if j not in inactive]):
            raise RuntimeError(f"miller_product of {n} pairs differs from the host oracle")
        repeats_equal(f"miller_product of {n} pairs", lambda: pd.miller_product(*a), got)
        args[n], counts[n] = a, n - len(inactive)
    a = args[len(pairs)]
    squarings = sum(pd._SQR_FLAGS.tolist())
    products = (miller_fq_products(len(pairs), pd.N_STEPS, squarings)
                + (len(pairs) - 1) * FQ_PER_FQ12_MUL)
    serial = (miller_fq_products(1, pd.N_STEPS, squarings)
              + (len(pairs) - 1).bit_length() * FQ_PER_FQ12_MUL)
    rounds = miller_rounds(len(pairs), pd.N_STEPS, squarings)
    b_ms, b_by = round_bound(rounds, products)
    rows.append(dict(
        name="miller_product", route="cuda", source="eth_consensus_specs_tpu_torch/csrc/miller.cu",
        replaces="eth_consensus_specs_tpu/ops/pairing_device.py:170",
        shape=[len(pairs), pd.N_STEPS],
        max_abs_err=err, ms=cuda_ms(lambda: pd.miller_product(*a), repeats=10, inner=INNER),
        device_ms=device_ms(lambda: pd.miller_product(*a), ("miller_",)),
        plain_ms=cuda_ms(lambda: pd.miller_product_ref(*a), 2),
        ms_by_pairs={n: cuda_ms(lambda: pd.miller_product(*args[n]), repeats=10, inner=INNER)
                     for n, _ in K11_CASES},
        active_by_pairs=counts, bound_ms=b_ms, bound_by=b_by, library_ms=None,
        product_rounds=rounds, round_instr=FQ_ROUND_INSTR,
        one_lane_bound_ms=round_bound(rounds, products, FQ_MUL_SASS)[0],
        fq_products=products, serial_fq_products=serial,
        serial_bound_ms=fq_bound(products, serial)[0], oracle_checked=[n for n, _ in K11_CASES],
        repeats_equal=REPEATS,
    ))

    # K12 on 1, on 0, on e(6P, 5Q) e(-cP, Q) for c = 30 (one) and 31 (not),
    # and on the 129-pair product (not one)
    q = qs[1]
    cases = {"one": torch.from_numpy(pd.fq12_to_words(oracle.Fq12.one())).to(dev),
             "zero": torch.zeros((2, 3, 2, 12), dtype=torch.int32, device=dev)}
    inactive_129 = dict(K11_CASES)[len(pairs)]
    want = {"one": True, "zero": False, "pairs_129": oracle.final_exponentiation(
        host_product([j for j in range(len(pairs)) if j not in inactive_129])).is_one()}
    for c in (30, 31):
        pr = [(g.mul(6), q.mul(5)), (-g.mul(c), q)]
        cases[f"c{c}"] = pd.miller_product(*[torch.from_numpy(x).to(dev) for x in pd.pack_pairs(pr)])
        want[f"c{c}"] = oracle.pairing_check(pr)
        if want[f"c{c}"] != (c == 30):
            raise RuntimeError("the host pairing check is wrong on e(6P, 5Q) e(-cP, Q)")
    cases["pairs_129"] = f = pd.miller_product(*a)
    verdicts, err = {}, 0
    for name, fw in cases.items():
        got = pd.final_exp_is_one(fw)
        err = max(err, max_abs_err(got, pd.final_exp_is_one_ref(fw)))
        if bool(got) != want[name]:
            raise RuntimeError(f"final_exp_is_one differs from the host on {name}")
        repeats_equal(f"final_exp_is_one on {name}", lambda: pd.final_exp_is_one(fw), got)
        verdicts[name] = bool(got)
    products, design = final_exp_fq_products(), final_exp_fq_products(FQ_PER_FQ12_SQR)
    rounds = final_exp_rounds()
    b_ms, b_by = round_bound(rounds, products)
    rows.append(dict(
        name="final_exp_is_one", route="cuda",
        source="eth_consensus_specs_tpu_torch/csrc/final_exp.cu",
        replaces="eth_consensus_specs_tpu/ops/pairing_device.py:259", shape=[2, 3, 2, 12],
        max_abs_err=err, ms=cuda_ms(lambda: pd.final_exp_is_one(f), repeats=5, inner=INNER),
        device_ms=device_ms(lambda: pd.final_exp_is_one(f), ("final_exp_is_one_kernel",)),
        plain_ms=cuda_ms(lambda: pd.final_exp_is_one_ref(f), 2),
        bound_ms=b_ms, bound_by=b_by, library_ms=None, product_rounds=rounds,
        round_instr=FQ_ROUND_INSTR,
        one_lane_bound_ms=round_bound(rounds, products, FQ_MUL_SASS)[0],
        fq_products=products, serial_fq_products=products,
        serial_bound_ms=fq_bound(products, products)[0], design_fq_products=design,
        verdicts_checked=verdicts, repeats_equal=REPEATS,
        coop_tower=check_coop_tower(dev),
    ))
    return rows


def repeats_equal(what: str, fn, first) -> None:
    """``fn()`` gives ``first``'s words on every one of REPEATS launches."""
    import torch

    for _ in range(REPEATS):
        if not torch.equal(fn(), first):
            raise RuntimeError(f"{what}: a repeated launch gave other words")


def check_coop_tower(dev) -> dict:
    """The cooperative tower's check entry (``fq12_coop_check``): an Fq12
    product, a complex squaring, a Granger-Scott squaring and a line product
    on a batch, chained 1 and 3 times, with one lane and with four lanes an
    Fq product, word for word against the plain tower; the Granger-Scott
    squares of elements in the cyclotomic subgroup also equal the complex
    squares. Then each split's time per round of the four operations (ten
    rounds: 4 product, 6 add) for one element and for COOP_WIDE, from the
    difference of COOP_REPS chained rounds."""
    import numpy as np
    import torch

    from eth_consensus_specs_tpu_torch import _ext
    from eth_consensus_specs_tpu_torch.crypto.fields import P
    from eth_consensus_specs_tpu_torch.ops import field_limbs as fl
    from eth_consensus_specs_tpu_torch.ops import pairing_device as pd

    rng = np.random.default_rng(COOP_SEED)

    def words(*shape):
        vals = [int.from_bytes(rng.bytes(48), "little") % P for _ in range(int(np.prod(shape)))]
        return torch.from_numpy(fl.ints_to_words(vals).reshape(*shape, 12)).to(dev)

    n = COOP_BATCH
    a, b, line = words(n, 2, 3, 2), words(n, 2, 3, 2), words(n, 5)
    a = fl.to_words(pd._easy_part(fl.from_words(a)))  # cyclotomic
    _ext.reset_launches()
    for reps in (1, 3):
        want = pd.fq12_coop_check_ref(a, b, line, reps)
        if not torch.equal(want[:, 1], want[:, 2]):
            raise RuntimeError("the plain Granger-Scott squares differ from the complex squares")
        for lanes in (1, 4):
            got = pd.fq12_coop_check(a, b, line, reps, lanes)
            max_abs_err(got, want)
            repeats_equal(f"fq12_coop_check ({lanes} lanes)",
                          lambda: pd.fq12_coop_check(a, b, line, reps, lanes), got)
    launches = _ext.launches["fq12_coop"]
    us = {}
    r0, r1 = COOP_REPS
    for lanes in (1, 4):
        for m in (1, COOP_WIDE):
            aa, bb, ll = (x[:1].expand(m, *x.shape[1:]).contiguous() for x in (a, b, line))
            t = [cuda_ms(lambda: pd.fq12_coop_check(aa, bb, ll, r, lanes), repeats=5)
                 for r in (r0, r1)]
            us[f"lanes_{lanes}_elements_{m}"] = (t[1] - t[0]) / (r1 - r0) / 10 * 1e3
    return dict(batch=n, launches=launches, equal_plain=True, us_per_round=us)


def _oracle_verdict(item) -> bool:
    """FastAggregateVerify of one item on the host: affine sums and the
    pairing oracle (a worker of the pool in run_bls_block)."""
    from eth_consensus_specs_tpu_torch.crypto.signature import fast_aggregate_verify

    return fast_aggregate_verify(*item)


def run_bls_block(dev) -> tuple[dict, dict]:
    """Phase 11: ``verify_many`` on a deneb mainnet block: 128 aggregates
    over 128 distinct messages, fresh messages for every call, hashed to G2
    by K13 and K14; a warm call, three timed calls, a batch with item 17
    tampered; every verdict against the host oracle's per-item
    FastAggregateVerify. The card's busy time is its five kernels timed by
    CUDA events on one call's packed inputs:
    torch.profiler returned no device events for windows around this work."""
    import multiprocessing as mp
    import random
    from concurrent.futures import ProcessPoolExecutor

    import torch

    from eth_consensus_specs_tpu_torch import _ext
    from eth_consensus_specs_tpu_torch.crypto.curve import g1_generator, g1_to_bytes
    from eth_consensus_specs_tpu_torch.crypto.signature import _load_pk
    from eth_consensus_specs_tpu_torch.inputs import attestation_block, g1_keys
    from eth_consensus_specs_tpu_torch.ops import (
        bls_batch, field_limbs, g1_msm, h2c_device, pairing_device)

    # the cut: validate a sample of fresh keys to size the one-time validation
    sample = [g1_to_bytes(k) for k in g1_keys(64, first=1 << 40)]
    t0 = time.perf_counter()
    for b in sample:
        if _load_pk(b) is None:
            raise RuntimeError("a valid key was rejected")
    ms_per_key = (time.perf_counter() - t0) * 1e3 / len(sample)
    committee = BLS_BLOCK_COMMITTEE
    if BLS_ITEMS * 2 * committee * ms_per_key / 1e3 <= KEY_BUDGET_S:
        raise RuntimeError(
            f"{ms_per_key:.3f} ms/key no longer justifies the committee cut to {committee}: "
            f"twice it would validate within {KEY_BUDGET_S:.0f} s")
    reduced = {"committee": [BLS_COMMITTEE, committee],
               "why": f"one-time host key validation, {ms_per_key:.3f} ms/key, "
                      f"{BLS_ITEMS * BLS_COMMITTEE * ms_per_key / 1e3:.1f} s at full size "
                      f"against a {KEY_BUDGET_S:.0f} s budget"}
    keys = g1_keys(BLS_ITEMS * committee)
    rng = random.Random(4)

    def block(call, tamper=()):
        return attestation_block(BLS_ITEMS, committee, distinct=BLS_ITEMS, call=call,
                                 tamper=tamper, keys=keys)[0]

    batches = {0: block(0)}
    t0 = time.perf_counter()
    first = bls_batch.verify_many(batches[0], device=dev, rng=rng)
    first_s = time.perf_counter() - t0  # includes validating every key once
    if first != [True] * BLS_ITEMS:
        raise RuntimeError("the warm block was not accepted")

    _ext.reset_launches()
    runs, parts_runs = [], []
    for call in range(1, BLS_TIMED_CALLS + 1):
        batches[call] = block(call)
        parts = {}
        t0 = time.perf_counter()
        verdicts = bls_batch.verify_many(batches[call], device=dev, rng=rng, parts=parts)
        runs.append((time.perf_counter() - t0) * 1e3)
        parts_runs.append({k: v * 1e3 for k, v in parts.items()})
        if verdicts != [True] * BLS_ITEMS:
            raise RuntimeError(f"timed block {call} was not accepted")
    launches = dict(_ext.launches)

    tampered_call = BLS_TIMED_CALLS + 1
    batches[tampered_call] = block(tampered_call, tamper=(BLS_TAMPERED,))
    parts_t = {}
    t0 = time.perf_counter()
    got = bls_batch.verify_many(batches[tampered_call], device=dev, rng=rng, parts=parts_t)
    tampered_ms = (time.perf_counter() - t0) * 1e3
    want = [True] * BLS_TAMPERED + [False] + [True] * (BLS_ITEMS - BLS_TAMPERED - 1)
    if got != want:
        raise RuntimeError("the tampered block's verdicts are not item 17 alone")

    # the card's work of one call: its inputs packed on the host as the call
    # packs them, then K10, K11 and K12, each timed by CUDA events
    items = batches[BLS_TIMED_CALLS]
    parsed = [bls_batch._parse_item(it, rng) for it in items]
    lanes = [torch.from_numpy(a).to(dev) for a in g1_msm.pack_lanes([p[0] for p in parsed])]
    rpk = bls_batch._rlc_pubkey_terms(parsed, dev)
    pairs = [(rp, bls_batch._h2g2(msg)) for rp, (_, msg, _, _) in zip(rpk, parsed)]
    sig_acc = bls_batch.g2_multi_exp([p[2] for p in parsed], [p[3] for p in parsed])
    pairs.append((-g1_generator(), sig_acc))
    packed = [torch.from_numpy(a).to(dev) for a in pairing_device.pack_pairs(pairs)]
    if not bool(pairing_device.final_exp_is_one(pairing_device.miller_product(*packed))):
        raise RuntimeError("the traced block's pairing check failed")

    f = pairing_device.miller_product(*packed)
    u = torch.from_numpy(field_limbs.ints_to_words(
        h2c_device.field_elements([msg for _, msg, _, _ in parsed]))).to(dev)
    jac = h2c_device.h2c_map(u)
    kernel_ms = {
        "h2c_map": cuda_ms(lambda: h2c_device.h2c_map(u), repeats=5),
        "h2c_finish": cuda_ms(lambda: h2c_device.h2c_finish(jac), repeats=5),
        "g1_sum_many": cuda_ms(lambda: g1_msm.sum_many(*lanes), repeats=5),
        "miller_product": cuda_ms(lambda: pairing_device.miller_product(*packed), repeats=5),
        "final_exp_is_one": cuda_ms(lambda: pairing_device.final_exp_is_one(f), repeats=5),
    }

    # the host oracle, item by item, on every batch checked above
    t0 = time.perf_counter()
    checked = {c: batches[c] for c in [*range(1, BLS_TIMED_CALLS + 1), tampered_call]}
    with ProcessPoolExecutor(max_workers=7, mp_context=mp.get_context("spawn")) as pool:
        oracle = {c: list(pool.map(_oracle_verdict, items)) for c, items in checked.items()}
    oracle_s = time.perf_counter() - t0
    for c, verdicts in oracle.items():
        expect = want if c == tampered_call else [True] * BLS_ITEMS
        if verdicts != expect:
            raise RuntimeError(f"block {c}: the card's verdicts differ from the host oracle's")

    ms = statistics.median(runs)
    host_parts = {k: statistics.median(p.get(k, 0.0) for p in parts_runs) for k in parts_runs[0]}
    busy = sum(kernel_ms.values())
    summary = dict(
        phase="bls_block", fork="deneb", preset="mainnet", items=BLS_ITEMS, committee=committee,
        distinct_messages=BLS_ITEMS, pairs=BLS_ITEMS + 1, reduced=reduced, ms=ms, ms_runs=runs,
        parts_ms=host_parts, parts_ms_runs=parts_runs, first_call_s=first_s,
        launches=launches, launches_per_call={k: v / BLS_TIMED_CALLS for k, v in launches.items()},
        tampered_ms=tampered_ms, tampered_parts_ms={k: v * 1e3 for k, v in parts_t.items()},
        tampered_verdicts_ok=True, device_kernel_ms=kernel_ms, device_busy_ms=busy,
        device_idle_share=1 - busy / ms,
        oracle_batches=len(checked), oracle_items=sum(len(v) for v in checked.values()),
        oracle_s=oracle_s, equal_host_oracle=True,
    )
    return summary, launches



# --- slice 5: G2 on the card: hash-to-G2 (K13, K14), committee sums (K15) ---------

FQ_PER_FQ2_MUL = 3  # Karatsuba
FQ_PER_FQ2_SQR = 2
FQ_PER_G2_ADD = 5 * FQ_PER_FQ2_SQR + 11 * FQ_PER_FQ2_MUL  # add-2007-bl in Fq2: 43
FQ_PER_G2_DBL = 5 * FQ_PER_FQ2_SQR + 2 * FQ_PER_FQ2_MUL  # dbl-2009-l in Fq2: 16
AGG_VALIDATORS = 1 << 20
AGG_SUBNETS = 64
AGG_COMMITTEE = AGG_VALIDATORS // 32 // AGG_SUBNETS  # 512: mainnet's committee
AGG_ATTESTERS = AGG_VALIDATORS // 32  # one slot's attesters
AGG_ROOTS = 2
AGG_INVALID = 2
K15_CORNER_ITEMS = 16  # with 512 lanes, enough adds for K15's plan to take a lanes pass
AGG_TIMED = 3


def _pow_products(e: int, loop_bits: int) -> int:
    """Fq products of a square-and-multiply loop over ``loop_bits`` bits of
    the public exponent e, as the kernels run it (a squaring every bit)."""
    return loop_bits + bin(e).count("1")


def h2c_element_products(u) -> int:
    """Fq products K13 spends on one field element (a host Fq2 u): the load,
    the SSWU map in the kernel's own steps (``ops.h2c_device.map_steps``:
    the prelude, a lane's share of the warp's batch inverse of N(tv2), one
    norm power that also decides the candidate, the second candidate's norm
    root by products, one h power, sgn0) and the isogeny, as
    ``csrc/h2c.cu`` runs them."""
    from eth_consensus_specs_tpu_torch.ops import h2c_device as hd

    iso = 11 * FQ_PER_FQ2_MUL + 7 * FQ_PER_FQ2_MUL + 2 * FQ_PER_FQ2_SQR  # Horner, X, Y, Z
    return 2 + hd.map_steps([u.c0.n, u.c1.n])[2] + iso


def h2c_element_needed_products() -> int:
    """Fq products the SSWU map needs for one field element, with one root
    serving both candidates and no inverse (RFC 9380's sqrt_ratio carried to
    this design's square root by Fq powers): the prelude; x1 = N/D and
    g(x1) = U/V as fractions; the norm's ratio root (one power a (a b)^e,
    which also decides the candidate: g(x2) = tv1^3 g(x1) gives the other
    norm root by constants); one h power for the square candidate's root;
    sgn0 and the isogeny. The built design (:func:`h2c_element_products`)
    keeps x1 affine by the tv2 inverse (a binary GCD), so that the words
    stay the plain version's, and takes its powers in 4-bit windows."""
    from eth_consensus_specs_tpu_torch.crypto.fields import P

    p_ratio = _pow_products((P - 3) // 4, 379)
    iso = 11 * FQ_PER_FQ2_MUL + 4 * FQ_PER_FQ2_MUL + 2 * FQ_PER_FQ2_SQR + 6 * FQ_PER_FQ2_MUL
    n = 2 + FQ_PER_FQ2_SQR + FQ_PER_FQ2_MUL + FQ_PER_FQ2_SQR  # load, u^2, tv1, tv1^2
    n += 2 * FQ_PER_FQ2_MUL  # N = B'(tv2 + 1), D = -A' tv2
    n += 2 * FQ_PER_FQ2_SQR + 5 * FQ_PER_FQ2_MUL  # U = N^3 + A' N D^2 + B' D^3, V = D^3
    n += FQ_PER_FQ2_MUL + 4  # W = U conj(V), the norms of W and V
    n += 1 + p_ratio + 2  # the norm's ratio root and its check
    n += FQ_PER_FQ2_MUL + 2  # x2 = tv1 x1, its norm root by constants
    n += 3 + p_ratio + 6  # h as a ratio, its power, the root's two coordinates
    return n + 2 + iso  # sgn0(y), the isogeny


def h2c_finish_products() -> int:
    """Fq products K14 spends on one point: two [|x|] ladders, the psi terms
    and four adds, the affine conversion (one Fq2 inversion) and the store."""
    from eth_consensus_specs_tpu_torch.crypto.fields import P

    ladder = 63 * FQ_PER_G2_DBL + 5 * FQ_PER_G2_ADD
    psi = 2 * FQ_PER_FQ2_MUL
    clear = 2 * ladder + 5 * FQ_PER_G2_ADD + 3 * psi + FQ_PER_G2_DBL
    affine = 2 + _pow_products(P - 2, 381) + 3 + FQ_PER_FQ2_SQR + 3 * FQ_PER_FQ2_MUL
    return clear + affine + 4


def sswu_shape(u) -> tuple[bool, bool]:
    """(g(x1) is not a square, tv2 = 0) for one host Fq2 u: the branches K13
    takes on it (the host map's own steps)."""
    from eth_consensus_specs_tpu_torch.crypto import hash_to_curve as h2c
    from eth_consensus_specs_tpu_torch.crypto.fields import Fq2

    tv1 = h2c.Z_SSWU * u.square()
    tv2 = tv1.square() + tv1
    if tv2.is_zero():
        x1 = h2c.B_PRIME * (h2c.Z_SSWU * h2c.A_PRIME).inv()
    else:
        x1 = (-h2c.B_PRIME) * h2c.A_PRIME.inv() * (Fq2.one() + tv2.inv())
    gx1 = (x1.square() + h2c.A_PRIME) * x1 + h2c.B_PRIME
    return gx1.sqrt() is None, tv2.is_zero()


def h2c_map_products(rows) -> tuple[int, int, int]:
    """(all Fq products, the longest chain of products, the most GCD steps a
    warp takes) K13 spends on ``rows`` of host u pairs: per message its two
    elements, then the pair's add by one thread; a warp's 16 messages share
    one GCD inverse (``ops.h2c_device.warp_inverse``)."""
    from eth_consensus_specs_tpu_torch.crypto.fields import Fq2
    from eth_consensus_specs_tpu_torch.ops import h2c_device as hd

    per = [[h2c_element_products(Fq2.from_ints(*e)) for e in pair] for pair in rows]
    total = sum(a + b + FQ_PER_G2_ADD for a, b in per)
    warp = hd.WARP // 2
    gcd = max(hd.warp_inverse([hd.tv2_norm(e) for pair in rows[i:i + warp] for e in pair])[1]
              for i in range(0, len(rows), warp))
    return total, max(max(a, b) for a, b in per) + FQ_PER_G2_ADD, gcd


def check_g2_kernels(dev):
    """Phase 3, continued: K13 and K14 at a deneb block's 128 messages and on
    rows holding u = 0 and u with c1 = 0; K13's square root on values in Fq;
    K15 at ``agg_slot``'s three tier shapes ([1, 512], [64, 1], [2, 32], by
    the shape function its tiers launch at), at [64, 512] and on corner
    items. Each against its plain version on the card (word for word) and
    the host oracle."""
    import torch

    from eth_consensus_specs_tpu_torch import _ext
    from eth_consensus_specs_tpu_torch.crypto.curve import g2_generator, g2_infinity
    from eth_consensus_specs_tpu_torch.crypto.fields import P, Fq, Fq2
    from eth_consensus_specs_tpu_torch.crypto.hash_to_curve import (
        clear_cofactor_g2, hash_to_g2, map_to_curve_g2)
    from eth_consensus_specs_tpu_torch.crypto.signature import _sum_g2
    from eth_consensus_specs_tpu_torch.inputs import point_multiples, block_message
    from eth_consensus_specs_tpu_torch.ops import field_limbs as fl
    from eth_consensus_specs_tpu_torch.ops import g2_aggregate as ga
    from eth_consensus_specs_tpu_torch.ops import h2c_device as hd

    rows = []
    msgs = [block_message(100, i) for i in range(BLS_ITEMS)]
    block = hd.field_elements(msgs)
    corner_rows = [[[0, 0], [3, 0]], [[P - 1, 0], [12345, 0]]]  # u = 0 (tv2 = 0); c1 = 0
    u = torch.from_numpy(fl.ints_to_words(block + corner_rows)).to(dev)
    jac = hd.h2c_map(u)
    err_map = max_abs_err(jac, hd.h2c_map_ref(u))
    # K14 also on the point at infinity (Z = 0): the flag, x = y = 0
    jac = torch.cat([jac, torch.zeros_like(jac[:1])])
    xy, inf = hd.h2c_finish(jac)
    rxy, rinf = hd.h2c_finish_ref(jac)
    err_finish = max(max_abs_err(xy, rxy), max_abs_err(inf, rinf))
    want = [hash_to_g2(m) for m in msgs] + [
        clear_cofactor_g2(map_to_curve_g2(Fq2.from_ints(*a)) + map_to_curve_g2(Fq2.from_ints(*b)))
        for a, b in corner_rows] + [g2_infinity()]
    if int(inf[-1]) != 1 or bool(xy[-1].any()):
        raise RuntimeError("h2c_finish of the point at infinity is not flagged with x = y = 0")
    if hd.points_from_words(xy, inf) != want:
        raise RuntimeError("h2c_map/h2c_finish differ from the host hash_to_g2 or map_to_curve_g2")
    # the square root alone: values in Fq (b = 0), zero, a non-square, general squares
    cases = [Fq2(Fq(11), Fq(0)).square(), Fq2(Fq(0), Fq(13)).square(), Fq2(Fq(5), Fq(0)),
             Fq2(Fq(P - 5), Fq(0)), Fq2(Fq(0), Fq(0)), Fq2(Fq(3), Fq(1)),
             Fq2(Fq(5), Fq(7)).square(), Fq2(Fq(P - 2), Fq(P - 5)).square()]
    v = torch.from_numpy(fl.ints_to_words([[c.c0.n, c.c1.n] for c in cases]))
    root, ok = hd.fq2_sqrt(v.to(dev))
    if not torch.equal(ok.cpu(), hd.fq2_sqrt(v)[1]):
        raise RuntimeError("the kernels' Fq2 square root flags differ from the plain version")
    for c, r, flag in zip(cases, fl.words_to_ints(root), ok.tolist()):
        if flag and Fq2.from_ints(*r).square() != c:
            raise RuntimeError(f"the kernels' Fq2 square root of {c} is wrong")
    u_block = u[:BLS_ITEMS].contiguous()
    jac_block = jac[:BLS_ITEMS].contiguous()
    design, design_serial, design_gcd = h2c_map_products(block)
    serial = h2c_element_needed_products() + FQ_PER_G2_ADD
    products = BLS_ITEMS * (2 * serial - FQ_PER_G2_ADD)
    b_ms, b_by = round_bound(serial, products)
    rows.append(dict(
        name="h2c_map", route="cuda", source="eth_consensus_specs_tpu_torch/csrc/h2c.cu",
        replaces="eth_consensus_specs_tpu/ops/h2c_device.py:307", shape=[BLS_ITEMS, 2, 2, 12],
        max_abs_err=err_map, ms=cuda_ms(lambda: hd.h2c_map(u_block), repeats=5),
        plain_ms=cuda_ms(lambda: hd.h2c_map_ref(u_block), 1),
        bound_ms=b_ms, bound_by=b_by, library_ms=None, product_rounds=serial,
        round_instr=FQ_ROUND_INSTR, serial_bound_ms=fq_bound(products, serial)[0],
        fq_products=products, serial_fq_products=serial, design_fq_products=design,
        design_serial_fq_products=design_serial, design_gcd_steps_max=design_gcd,
        design_chain_bound_ms=(design_serial * FQ_MUL_SASS + design_gcd * GCD_STEP_INSTR)
        / CLOCK_HZ * 1e3, host_checked=len(want), corner_rows=corner_rows,
        sqrt_cases_checked=len(cases),
        second_root_elements=sum(sswu_shape(Fq2.from_ints(*e))[0] for pair in block for e in pair),
    ))
    per_point = h2c_finish_products()
    # the norms of the cleared points' Z, the GCD's inputs: the plain
    # formulas give the kernel's Jacobian Z
    from eth_consensus_specs_tpu_torch.ops import g2_jacobian as gj

    zc = gj.g2_clear_cofactor(tuple(fl.from_card_words(jac_block[:, i]) for i in range(3)))[2]
    rinv = pow(1 << 384, -1, P)
    norms = [(a * a + b * b) * rinv % P for a, b in fl.words_to_ints(fl.to_card_words(zc))]
    fermat_instr = fq_window_inverse_products() * FQ_ROUND_INSTR
    gcd_instr = gcd_chain_instr(norms)
    rounds = h2c_finish_rounds()
    products = BLS_ITEMS * per_point
    chain_ms = (rounds * FQ_ROUND_INSTR + min(fermat_instr, gcd_instr)) / CLOCK_HZ * 1e3
    thru_ms = products * FQ_MUL_INSTR / INT_OPS_PER_S * 1e3
    rows.append(dict(
        name="h2c_finish", route="cuda", source="eth_consensus_specs_tpu_torch/csrc/h2c.cu",
        replaces="eth_consensus_specs_tpu/ops/h2c_device.py:333", shape=[BLS_ITEMS, 3, 2, 12],
        max_abs_err=err_finish, ms=cuda_ms(lambda: hd.h2c_finish(jac_block), repeats=5),
        device_ms=device_ms(lambda: hd.h2c_finish(jac_block),
                            ("h2c_finish_kernel", "void h2c_finish_kernel")),
        plain_ms=cuda_ms(lambda: hd.h2c_finish_ref(jac_block), 1),
        bound_ms=max(chain_ms, thru_ms), bound_by="operations", library_ms=None,
        product_rounds=rounds, round_instr=FQ_ROUND_INSTR,
        inverse_bound_ms={"fermat": fermat_instr / CLOCK_HZ * 1e3,
                          "gcd": gcd_instr / CLOCK_HZ * 1e3},
        gcd_steps_max=gcd_instr / GCD_STEP_INSTR, gcd_step_instr=GCD_STEP_INSTR,
        one_lane_bound_ms=(rounds * FQ_MUL_SASS + min(fermat_instr * FQ_MUL_SASS / FQ_ROUND_INSTR,
                                                      gcd_instr)) / CLOCK_HZ * 1e3,
        fq_products=products, serial_fq_products=per_point,
        serial_bound_ms=fq_bound(products, per_point)[0], host_checked=len(want),
    ))

    # K15: k * G2 for k = 1 .. 32,768, item i the lanes i L + 1 .. (i + 1) L;
    # agg_slot's tiers: a committee a subnet, the 64 (subnet, root) partials
    # of one lane, the 2 roots' 32 partials
    g = g2_generator()
    pts = point_multiples(g, 1, 64 * AGG_COMMITTEE)
    tiers = [ga.g2_many_sum_shape(*t) for t in (
        (1, AGG_COMMITTEE), (AGG_SUBNETS, 1), (AGG_ROOTS, AGG_SUBNETS // AGG_ROOTS))]
    shapes = {}
    for items, lanes in tiers + [(64, AGG_COMMITTEE)]:
        lists = [pts[i * lanes:(i + 1) * lanes] for i in range(items)]
        X, Y, Z = (torch.from_numpy(a).to(dev) for a in ga._points_to_lanes(lists, items, lanes))
        out = ga.g2_sum_many(X, Y, Z)
        err = max_abs_err(out, ga.g2_sum_many_ref(X, Y, Z))
        want_sums = [g.mul(sum(range(i * lanes + 1, (i + 1) * lanes + 1))) for i in range(items)]
        if ga.sums_to_points(out) != want_sums:
            raise RuntimeError(f"g2_sum_many [{items}, {lanes}] differs from the host sums")
        repeats_equal(f"g2_sum_many [{items}, {lanes}]", lambda: ga.g2_sum_many(X, Y, Z), out)
        before = _ext.launches["g2_sum"]
        ga.g2_sum_many(X, Y, Z)
        launches_a_call = _ext.launches["g2_sum"] - before
        plan = ga.sum_plan(items, lanes)
        if launches_a_call != len(plan):
            raise RuntimeError(f"g2_sum_many [{items}, {lanes}] launched {launches_a_call} "
                               "kernels, not its plan's passes")
        products = items * (lanes - 1) * FQ_PER_G2_ADD
        serial = (lanes.bit_length() - 1) * FQ_PER_G2_ADD
        rounds = (lanes.bit_length() - 1) * CURVE_ADD_ROUNDS
        b_ms, b_by = round_bound(rounds, products)
        b_bytes = (3 * items * lanes + 3 * items) * 96 / HBM_BYTES_PER_S * 1e3
        shapes[(items, lanes)] = dict(
            shape=[items, lanes], max_abs_err=err, ms=cuda_ms(lambda: ga.g2_sum_many(X, Y, Z),
                                                              repeats=10),
            device_ms=device_ms(lambda: ga.g2_sum_many(X, Y, Z), ("g2_sum_", "void g2_sum_")),
            plain_ms=cuda_ms(lambda: ga.g2_sum_many_ref(X, Y, Z), 1),
            bound_ms=max(b_ms, b_bytes), bound_by=b_by if b_ms >= b_bytes else "bytes",
            product_rounds=rounds, round_instr=FQ_ROUND_INSTR,
            one_lane_bound_ms=round_bound(rounds, products, FQ_MUL_SASS)[0],
            serial_bound_ms=fq_bound(products, serial)[0], fq_products=products,
            serial_fq_products=serial, host_checked=items, launches_a_call=launches_a_call,
            plan=plan, repeats_equal=REPEATS)
    # corners, padded to K15_CORNER_ITEMS items (all infinity) so that the
    # plan starts with a lanes pass: sums that meet as P + P and P + (-P)
    # within a pass, across the lanes pass's boundary (blocks of 2) and
    # across the warp passes' (blocks of 8)
    p, q, inf = pts[5], pts[6], g2_infinity()
    corners = [[inf] * AGG_COMMITTEE, [p], [p, p] + pts[10:20], [p, -p] + pts[20:30], pts[:37],
               [inf, p, inf, pts[9]], [p, q, p, q], [p, q, -p, -q], pts[:8] + pts[:8],
               pts[16:24] + [-x for x in pts[16:24]]]
    corners += [[] for _ in range(K15_CORNER_ITEMS - len(corners))]
    X, Y, Z = (torch.from_numpy(a).to(dev)
               for a in ga._points_to_lanes(corners, len(corners), AGG_COMMITTEE))
    if ga.sum_plan(len(corners), AGG_COMMITTEE)[0][0] != "thread":
        raise RuntimeError("K15's corner items do not reach a lanes pass")
    out = ga.g2_sum_many(X, Y, Z)
    err = max_abs_err(out, ga.g2_sum_many_ref(X, Y, Z))
    if ga.sums_to_points(out) != [_sum_g2(c) for c in corners]:
        raise RuntimeError("g2_sum_many corner items differ from the host _sum_g2")
    tier0 = shapes[tiers[0]]
    rows.append(dict(
        name="g2_sum_many", route="cuda", source="eth_consensus_specs_tpu_torch/csrc/g2_sum.cu",
        replaces="eth_consensus_specs_tpu/ops/g2_aggregate.py:103",
        **{k: tier0[k] for k in ("shape", "ms", "device_ms", "plain_ms", "bound_ms", "bound_by",
                                 "product_rounds", "round_instr", "one_lane_bound_ms",
                                 "serial_bound_ms", "fq_products", "serial_fq_products",
                                 "launches_a_call", "plan")},
        max_abs_err=max(max(r["max_abs_err"] for r in shapes.values()), err), library_ms=None,
        at_64x512=shapes[(64, AGG_COMMITTEE)], at_tier1=shapes[tiers[1]],
        at_tier2=shapes[tiers[2]], corners_checked=len(corners),
    ))
    return rows


def _tiers_equal(a, b) -> bool:
    """(slot aggregates, subnet aggregates) equal at every tier: points,
    compressed bytes and participation bits."""
    (slot_a, subs_a), (slot_b, subs_b) = a, b
    if len(slot_a) != len(slot_b) or len(subs_a) != len(subs_b):
        return False
    for x, y in zip(subs_a, subs_b):
        if ((x.subnet, x.root, x.sig, x.pubkey, x.sig_bytes, x.pubkey_bytes)
                != (y.subnet, y.root, y.sig, y.pubkey, y.sig_bytes, y.pubkey_bytes)
                or not (x.bits == y.bits).all()):
            return False
    for x, y in zip(slot_a, slot_b):
        if ((x.root, x.sig, x.pubkey, x.sig_bytes, x.pubkey_bytes)
                != (y.root, y.sig, y.pubkey, y.sig_bytes, y.pubkey_bytes)
                or not (x.bits == y.bits).all()):
            return False
    return True


def run_agg_slot(dev) -> tuple[dict, dict]:
    """Phase 12: one mainnet slot's attestations through the committee tree
    on the card, its verification and the bisection's isolation, each held
    against the host: 32,768 attesters in 64 committees of 512 over 64
    subnets, 2 roots, 2 invalid committees, every 17th validator abstaining.
    The card's busy time is each tier's K15 and K10 launch timed by CUDA
    events at the tier's shape, times the tier's launches."""
    import random

    import torch

    from eth_consensus_specs_tpu_torch import _ext
    from eth_consensus_specs_tpu_torch.inputs import slot_committees
    from eth_consensus_specs_tpu_torch.ops import agg_tree, bls_batch, g1_msm
    from eth_consensus_specs_tpu_torch.ops import g2_aggregate as ga

    t0 = time.perf_counter()
    atts, bad = slot_committees(AGG_ATTESTERS, AGG_SUBNETS, AGG_COMMITTEE, AGG_ROOTS, AGG_INVALID)
    build_s = time.perf_counter() - t0
    signatures = sum(len(a.sigs) for a in atts)
    t0 = time.perf_counter()
    warm = agg_tree.aggregate_slot(atts, device=dev)
    warm_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    host = agg_tree.aggregate_slot_host(atts)
    host_s = time.perf_counter() - t0
    if not _tiers_equal(warm, host):
        raise RuntimeError("the card's aggregation tiers differ from the host oracle's")
    bad_roots = {root for _, root in bad}
    want = [sa.root not in bad_roots for sa in warm[0]]
    rng = random.Random(7)

    bls_batch._H2G2_CACHE.clear()
    _ext.reset_launches()
    tree_ms, verify_ms, isolate_ms, launches = [], [], [], None
    for rep in range(AGG_TIMED):
        t0 = time.perf_counter()
        tiers = agg_tree.aggregate_slot(atts, device=dev)
        t1 = time.perf_counter()
        verdicts = agg_tree.verify_slot(tiers[0], device=dev, rng=rng)
        t2 = time.perf_counter()
        isolated = agg_tree.isolate_invalid_subnets(tiers[1], device=dev, rng=rng)
        t3 = time.perf_counter()
        if rep == 0:
            launches = dict(_ext.launches)
        tree_ms.append((t1 - t0) * 1e3)
        verify_ms.append((t2 - t1) * 1e3)
        isolate_ms.append((t3 - t2) * 1e3)
        if not _tiers_equal(tiers, host):
            raise RuntimeError(f"timed slot {rep}: tiers differ from the host oracle's")
        if verdicts != want:
            raise RuntimeError(f"timed slot {rep}: verify_slot gave {verdicts}, not {want}")
        if isolated != bad:
            raise RuntimeError(f"timed slot {rep}: isolated {isolated}, injected {bad}")
    # a root once its invalid committee is dropped verifies; the other does not
    last = warm[0][-1].root
    kept = [a for a in atts if (a.subnet, a.root) not in bad or a.root != last]
    clean = agg_tree.verify_slot(agg_tree.aggregate_slot(kept, device=dev)[0], device=dev, rng=rng)
    if clean != [False, True]:
        raise RuntimeError(f"with root {last.hex()[:8]}'s invalid committee dropped: {clean}")

    # the card's busy time of one tree: each tier's launches, on the tier's
    # own points at the shapes its wrappers pad to, each kernel held word
    # for word against its plain version on the card
    subs = tiers[1]
    roots = sorted({sa.root for sa in subs})
    tier_lists = {
        "tier0": ([list(atts[0].sigs)], [list(atts[0].pubkeys)], AGG_SUBNETS),
        "tier1": ([[sa.sig] for sa in subs], [[sa.pubkey] for sa in subs], 1),
        "tier2": ([[sa.sig for sa in subs if sa.root == r] for r in roots],
                  [[sa.pubkey for sa in subs if sa.root == r] for r in roots], 1),
    }
    busy, tier_ms = 0.0, {}
    for name, (g2_lists, g1_lists, count) in tier_lists.items():
        shape = ga.g2_many_sum_shape(len(g2_lists), max(len(x) for x in g2_lists))
        g2_lanes = [torch.from_numpy(a).to(dev) for a in ga._points_to_lanes(g2_lists, *shape)]
        g1_lanes = [torch.from_numpy(a).to(dev) for a in g1_msm.pack_lanes(g1_lists)]
        err = max(max_abs_err(ga.g2_sum_many(*g2_lanes), ga.g2_sum_many_ref(*g2_lanes)),
                  max_abs_err(g1_msm.sum_many(*g1_lanes), g1_msm.sum_many_ref(*g1_lanes)))
        k15 = cuda_ms(lambda: ga.g2_sum_many(*g2_lanes), repeats=5)
        k10 = cuda_ms(lambda: g1_msm.sum_many(*g1_lanes), repeats=5)
        tier_ms[name] = dict(g2_shape=list(shape), g2_sum_many=k15,
                             g1_shape=list(g1_lanes[0].shape[:2]), g1_sum_many=k10,
                             launches_each=count, max_abs_err=err)
        busy += count * (k15 + k10)
    ms = statistics.median(tree_ms)
    summary = dict(
        phase="agg_slot", preset="mainnet", validators=AGG_VALIDATORS, attesters=AGG_ATTESTERS,
        committees=len(atts), committee=AGG_COMMITTEE, subnets=AGG_SUBNETS, roots=AGG_ROOTS,
        invalid=AGG_INVALID, signatures=signatures, registry_build_s=build_s, warm_s=warm_s,
        host_oracle_s=host_s, tree_ms=ms, tree_ms_runs=tree_ms,
        verify_ms=statistics.median(verify_ms), verify_ms_runs=verify_ms,
        isolate_ms=statistics.median(isolate_ms), isolate_ms_runs=isolate_ms,
        signatures_per_s=signatures / (ms / 1e3), launches=launches, verdicts=want,
        isolated=[[s, r.hex()] for s, r in bad], clean_root_verdicts=clean,
        device_tier_ms=tier_ms, device_busy_ms=busy, device_idle_share=1 - busy / ms,
        equal_host_oracle=True,
    )
    return summary, launches

# --- KZG blob verification: the Fr FFT (K16), full-scalar MSMs (K17) --------------

KZG_BLOBS = 64  # scripts/das_bench.py's flush: 64 full blobs, degree 8, 2 tampered
KZG_DEGREE = 8
KZG_INVALID = 2
KZG_DENSE = (17, 49)  # two sample_blob triples: full rows through the FFT
KZG_TIMED = 3
KZG_ORACLE_CLEAN = (5, 17)  # clean items the host also verifies one by one
DAS_FFT = (16, 8192)  # bench.py's das cell on the card: batch 16, n 8192, chain 8
DAS_CHAIN = 8
DAS_REPEATS = 5
# 32-bit instructions of one Fr product (8 x 32-bit CIOS Montgomery, fr.cuh):
# 2 x 64 multiply-adds for a * b and m * r, each an IMAD.WIDE, and about 70
# carry additions. Fr additions are not counted, so the bounds below are low.
# The compiled product issues more: the run counts its SASS
# (tools/fq_mul_sass.py) and reports the bound at that count beside this one.
FR_MUL_INSTR = 200
FQ_PER_G1_DBL = 7  # dbl-2009-l: 2 products and 5 squarings
# product rounds of a curve formula at full formula parallelism, over Fq or
# Fq2 (csrc/curve_coop.cuh): a doubling {X^2, Y^2, YZ}, {8B^2, 4XB, 9A^2},
# {3A (3D - F)}; a complete add {Z1^2, Z2^2, Y1 Z2, Y2 Z1}, {U1, U2, S1, S2,
# (Z1 + Z2)^2}, {I, r^2, Z3, r U1, r H, S1 H}, {H I, U1 I, r U1 I, r H I,
# r^3, S1 H I}
CURVE_DBL_ROUNDS = 3
CURVE_ADD_ROUNDS = 4
# K17's window table: T2; T3 beside T4; T5..T7 beside T8; T9..T15
MSM_TABLE_ROUNDS = CURVE_DBL_ROUNDS + 3 * CURVE_ADD_ROUNDS
# one step of the binary GCD inverse (fp_gcd.cuh fp_inv_gcd), counted as
# FQ_MUL_INSTR is: a halving step's two 12-word halvings (an add with carry
# and a funnel shift a word), or a subtraction step's 12-word subtraction and
# 12-word modular subtraction; the compares and tests not counted
GCD_STEP_INSTR = 48
# G1's endomorphism phi(x, y) = (beta * x, y) acts as the scalar lambda =
# z^2 - 1 (128 bits; lambda^2 + lambda + 1 = 0 mod r), so k * P = k1 * P +
# k2 * phi(P) with k1, k2 = k mod lambda, k // lambda, each 128 bits at most
# (Gallant, Lambert and Vanstone, CRYPTO 2001)
GLV_LAMBDA = 0xD201000000010000 ** 2 - 1
R_SCALAR = 0x73EDA753299D7D483339D80809A1D80553BDA402FFFE5BFEFFFFFFFF00000001  # r
MSM_WINDOW = 4  # the window width of the needed chain: one add a window
FR_MAX_TOP = 0x73EDA753  # r's top word: words below it are below r


def fr_fft_products(rows: int, n: int, inverse: bool) -> int:
    """The Fr products of ``rows`` DITs of n points: one a butterfly, and
    the n^-1 scaling of an inverse."""
    log_n = n.bit_length() - 1
    return rows * (n // 2 * log_n + (n if inverse else 0))


def fr_fft_bound(rows: int, n: int, inverse: bool,
                 per_product: float = FR_MUL_INSTR) -> tuple[float, str]:
    """Least milliseconds of a batch of FFTs: each value read and written
    once (32 B) and the twiddles read once, against the Fr products at
    ``per_product`` instructions each on both integer pipes."""
    t_bytes = (2 * rows * n + n - 1) * 32 / HBM_BYTES_PER_S * 1e3
    t_ops = fr_fft_products(rows, n, inverse) * per_product / INT_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def msm_needed_products(scalar_lists: list) -> tuple[int, int]:
    """(all, the longest dependent chain) of the Fq products the MSMs need
    at least: each scalar split in two halves by G1's endomorphism (one
    product for beta * x), each half a lane of its own that takes, from its
    top bit, a doubling a bit and one add a window of MSM_WINDOW bits (the
    windows' tables are not counted, so this is low); then a tree over an
    item's half-lanes: the one-thread chain (serial_bound_ms)."""
    total, serial = 0, 0
    for scalars in scalar_lists:
        chains = []
        for k in map(int, scalars):
            halves = [h for h in divmod(k % R_SCALAR, GLV_LAMBDA) if h]
            for h in halves:
                bits = h.bit_length()
                chains.append((bits - 1) * FQ_PER_G1_DBL
                              + (-(-bits // MSM_WINDOW) - 1) * FQ_PER_G1_ADD + (len(halves) - 1))
        if not chains:
            continue
        total += sum(chains) + (len(chains) - 1) * FQ_PER_G1_ADD
        serial = max(serial, max(chains) + (len(chains) - 1).bit_length() * FQ_PER_G1_ADD)
    return total, serial


def msm_needed_rounds(scalar_lists: list) -> int:
    """The chain of product rounds the MSMs need at full formula parallelism
    (csrc/curve_coop.cuh: a doubling CURVE_DBL_ROUNDS, an add
    CURVE_ADD_ROUNDS): per nonzero half scalar of b bits, phi, the window
    table (MSM_TABLE_ROUNDS), b - 1 doublings and an add a further window;
    then the tree over an item's nonzero half-lanes; the longest item."""
    longest = 0
    for scalars in scalar_lists:
        chains = []
        for k in map(int, scalars):
            for h in divmod(k % R_SCALAR, GLV_LAMBDA):
                if h:
                    bits = h.bit_length()
                    chains.append(1 + MSM_TABLE_ROUNDS + (bits - 1) * CURVE_DBL_ROUNDS
                                  + (-(-bits // MSM_WINDOW) - 1) * CURVE_ADD_ROUNDS)
        if chains:
            longest = max(longest, max(chains)
                          + (len(chains) - 1).bit_length() * CURVE_ADD_ROUNDS)
    return longest


def msm_design_rounds(scalar_lists: list, groups: int = 4, fold_groups: int = 16) -> int:
    """The chain of product rounds K17's design runs on the longest item
    (csrc/g1_msm.cu): per half-lane phi, the table as built (a doubling, an
    add, a doubling, an add of 3, a doubling, adds of 4 and of 3 in turn),
    from the top nonzero window a dbl4 and an add a nonzero digit; the
    block's tree; the fold's running sums and tree; the canonical form."""
    longest = 0
    for scalars in scalar_lists:
        chains = []
        for k in map(int, scalars):
            for h in divmod(k % R_SCALAR, GLV_LAMBDA)[::-1]:
                digits = [(h >> (MSM_WINDOW * w)) & 15 for w in range(32)]
                top = max((w for w in range(32) if digits[w]), default=-1)
                chains.append(0 if top < 0 else 1 + 3 * CURVE_DBL_ROUNDS + 4 * CURVE_ADD_ROUNDS
                              + 4 * top * CURVE_DBL_ROUNDS
                              + sum(1 for d in digits[:top] if d) * CURVE_ADD_ROUNDS)
        bpi = -(-len(chains) // groups)
        depth = (groups - 1).bit_length() * CURVE_ADD_ROUNDS
        if bpi > 1:
            depth += (-(-bpi // fold_groups) - 1 + (fold_groups - 1).bit_length()) * CURVE_ADD_ROUNDS
        longest = max(longest, max(chains) + depth + 1)
    return longest


def h2c_finish_rounds() -> int:
    """K14's chain of product rounds at full formula parallelism, the affine
    inverse aside: two [|x|] ladders (63 doublings, 5 adds each), the four
    adds after them (psi(a + P) and psi^2(2P) run beside the second
    ladder), the norm of Z, Z^-1, Z^-2, x and Z^-3, y."""
    ladder = 63 * CURVE_DBL_ROUNDS + 5 * CURVE_ADD_ROUNDS
    return 2 * ladder + 4 * CURVE_ADD_ROUNDS + 5


def gcd_chain_instr(norms: list[int]) -> float:
    """Instructions of the longest binary-GCD inverse of ``norms`` (card
    Montgomery ints): its steps (ops/fq12_coop.py gcd_inverse counts them)
    at GCD_STEP_INSTR each."""
    from eth_consensus_specs_tpu_torch.ops.fq12_coop import gcd_inverse

    return max(gcd_inverse(n)[1] for n in norms) * GCD_STEP_INSTR


def random_fr_words(gen, shape, dev):
    """Uniform words of values below r (every top word below r's), made on
    ``dev`` by ``gen``."""
    import torch

    w = torch.randint(0, 1 << 32, (*shape, 8), generator=gen, device=dev, dtype=torch.int64)
    w[..., 7] %= FR_MAX_TOP
    return (w - ((w >> 31) << 32)).to(torch.int32)


def _sass_tool():
    """``tools/fq_mul_sass.py`` of this checkout."""
    import importlib.util

    from pathlib import Path

    spec = importlib.util.spec_from_file_location(
        "fq_mul_sass", Path(__file__).resolve().parent / "tools" / "fq_mul_sass.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def fr_mul_sass_count() -> float:
    """SASS instructions of one Fr product as this run's toolkit compiles
    ``csrc/fr.cuh`` (``tools/fq_mul_sass.py``'s ``fr_mul_sass``)."""
    return _sass_tool().fr_mul_sass()


def k4_sass_count() -> dict:
    """K4's SASS a validator and its subroutine calls as this run's toolkit
    compiles ``csrc/altair_epoch.cu`` (``tools/fq_mul_sass.py``'s
    ``altair_epoch_sass``)."""
    return _sass_tool().altair_epoch_sass()


def k9_sass_count() -> dict:
    """K9's SASS a validator and its subroutine calls as this run's toolkit
    compiles ``csrc/state_columns.cu`` (``tools/fq_mul_sass.py``'s
    ``phase0_epoch_sass``)."""
    return _sass_tool().phase0_epoch_sass()


def check_kzg_kernels(dev, fr_sass: float):
    """Phase 3, continued: K16 at the flush's [64, 4096] inverse (rows in
    stored order, as the flush runs it), at the das cell's [16, 8192]
    forward and inverse, and at n = 2, 4, 8 and 16, on dense random rows and
    rows of corners (0, 1, r - 1, 2^254), word for word against its plain
    version on the card and against the host ``fft_field`` on sampled rows;
    K17 at a 64-blob flush's [2, 129] (its items A and B: 64 and 129
    lanes), a 32-blob subset's [2, 65], a 3-blob one's [2, 7], a bisection
    leaf's [2, 3], [1, 300] (the fold's groups summing several block
    partials), [3, 2] (one block an item, no fold) and corner items (scalars 0, 1, r - 1, 2^256 - 1, r, r + 2; an
    infinity lane; P and -P; P and P, whose halves' tree doubles; one lane),
    word for word against its plain version and on affine points against
    the host ``msm_g1``. K16's bound counts an Fr product at FR_MUL_INSTR,
    its ``sass_bound_ms`` at ``fr_sass``, the SASS count of this run's build.
    K17's bound is its chain of product rounds at full
    formula parallelism, a round at the 4-lane split's FQ_ROUND_INSTR
    (``round_bound``); beside it the same chain at a one-lane product as
    ``one_lane_bound_ms`` and the one-thread product chain as
    ``serial_bound_ms``."""
    import random

    import torch

    from eth_consensus_specs_tpu_torch import _ext
    from eth_consensus_specs_tpu_torch.crypto import das, kzg
    from eth_consensus_specs_tpu_torch.crypto.curve import g1_infinity
    from eth_consensus_specs_tpu_torch.crypto.fields import R
    from eth_consensus_specs_tpu_torch.crypto.msm import msm_g1
    from eth_consensus_specs_tpu_torch.inputs import g1_keys
    from eth_consensus_specs_tpu_torch.ops import fr_fft, g1_msm
    from eth_consensus_specs_tpu_torch.ops import limb_field as lf

    rows = []
    gen = torch.Generator(device=dev).manual_seed(16)
    corners = torch.from_numpy(lf.ints_to_words([0, 1, R - 1, 1 << 254])).to(dev)

    def fft_case(b, n, inverse, bitrev):
        vals = random_fr_words(gen, (b, n), dev)
        vals[0, : min(n, 4)] = corners[: min(n, 4)]
        if b > 1:
            vals[1] = corners[torch.arange(n, device=dev) % 4]
        roots = kzg.compute_roots_of_unity(n)
        tw = fr_fft._device_twiddles(fr_fft.inverse_roots(roots) if inverse else roots, n, str(dev))
        scale = fr_fft._device_scale(n, str(dev)) if inverse else None
        got = fr_fft.fft_rows(vals, tw, scale, bitrev)
        err = max_abs_err(got, fr_fft.fft_rows_ref(vals, tw, scale, bitrev))
        for i in sorted({0, 1, b - 1} & set(range(b))):
            row = lf.words_to_ints(vals[i])
            if not bitrev:
                row = kzg.bit_reversal_permutation(row)
            if lf.words_to_ints(got[i]) != das.fft_field(row, roots, inv=inverse):
                raise RuntimeError(f"fr_fft [{b}, {n}] row {i} differs from the host fft_field")
        return vals, tw, scale, err

    errs, shapes = [], {}
    for n in (2, 4, 8, 16):
        for inverse in (False, True):
            errs.append(fft_case(3, n, inverse, True)[3])
    flush = fft_case(KZG_BLOBS, kzg.FIELD_ELEMENTS_PER_BLOB, True, False)
    errs.append(flush[3])
    for (b, n), inverse in ((DAS_FFT, False), (DAS_FFT, True)):
        vals, tw, scale, err = fft_case(b, n, inverse, True)
        errs.append(err)
        _ext.reset_launches()
        fr_fft.fft_rows(vals, tw, scale, True)
        launches = sum(_ext.launches.values())
        if launches != 1:
            raise RuntimeError(f"fr_fft [{b}, {n}] took {launches} launches")
        shapes["inverse" if inverse else "forward"] = dict(
            shape=[b, n], ms=cuda_ms(lambda: fr_fft.fft_rows(vals, tw, scale, True), inner=INNER),
            device_ms=device_ms(lambda: fr_fft.fft_rows(vals, tw, scale, True), ("fr_fft_kernel",)),
            bound_ms=fr_fft_bound(b, n, inverse)[0],
            sass_bound_ms=fr_fft_bound(b, n, inverse, fr_sass)[0], max_abs_err=err,
            launches_a_call=launches, passes=list(fr_fft.fft_passes(n.bit_length() - 1)))
    vals, tw, scale, _ = flush
    b_ms, b_by = fr_fft_bound(KZG_BLOBS, kzg.FIELD_ELEMENTS_PER_BLOB, True)
    _ext.reset_launches()
    fr_fft.fft_rows(vals, tw, scale, False)
    launches = sum(_ext.launches.values())
    if launches != 1:
        raise RuntimeError(f"fr_fft at the flush took {launches} launches")
    rows.append(dict(
        name="fr_fft", route="cuda", source="eth_consensus_specs_tpu_torch/csrc/fr_fft.cu",
        replaces="eth_consensus_specs_tpu/ops/fr_fft.py:61", shape=list(vals.shape[:2]),
        max_abs_err=max(errs), ms=cuda_ms(lambda: fr_fft.fft_rows(vals, tw, scale, False),
                                          inner=INNER),
        device_ms=device_ms(lambda: fr_fft.fft_rows(vals, tw, scale, False), ("fr_fft_kernel",)),
        plain_ms=cuda_ms(lambda: fr_fft.fft_rows_ref(vals, tw, scale, False), 2),
        bound_ms=b_ms, bound_by=b_by, library_ms=None, launches_a_call=launches,
        sass_bound_ms=fr_fft_bound(KZG_BLOBS, kzg.FIELD_ELEMENTS_PER_BLOB, True, fr_sass)[0],
        passes=list(fr_fft.fft_passes(kzg.FIELD_ELEMENTS_PER_BLOB.bit_length() - 1)),
        fr_products=fr_fft_products(KZG_BLOBS, kzg.FIELD_ELEMENTS_PER_BLOB, True),
        fr_mul_instr=FR_MUL_INSTR, fr_mul_sass=fr_sass, das=shapes, small_sizes_checked=[2, 4, 8, 16],
    ))

    # K17: random 255-bit scalars on multiples of G, as an RLC fold's lanes
    rnd = random.Random(17)
    keys = g1_keys(700)
    cases, errs = {}, []

    def msm_case(point_lists, scalar_lists, label):
        K, X, Y, Z = (torch.from_numpy(a).to(dev)
                      for a in g1_msm.pack_msm(point_lists, scalar_lists))
        out = g1_msm.msm_many(K, X, Y, Z)
        ref = g1_msm.msm_many_ref(K, X, Y, Z)
        errs.append(max_abs_err(out, ref))
        want = [msm_g1(p, s) for p, s in zip(point_lists, scalar_lists)]
        if g1_msm.sums_to_points(out) != want:
            raise RuntimeError(f"g1_msm_many {label} differs from the host msm_g1")
        cases[label] = (K, X, Y, Z, scalar_lists)

    for items, lanes, label in ((2, 2 * KZG_BLOBS + 1, "flush"), (2, KZG_BLOBS + 1, "half"),
                                (2, 7, "three"), (2, 3, "leaf"), (1, 300, "wide"),
                                (3, 2, "one_block")):
        point_lists = [keys[i * lanes:(i + 1) * lanes] for i in range(items)]
        if items == 2:  # item A has n of item B's 2n + 1 lanes
            point_lists[0] = point_lists[0][: lanes // 2]
        msm_case(point_lists, [[rnd.randrange(R) for _ in p] for p in point_lists], label)
    p, q, inf = keys[3], keys[4], g1_infinity()
    msm_case([keys[10:16], [inf, keys[16]], [p, -p], [q, -q], [keys[17]], keys[18:22], [p, p]],
             [[0, 1, R - 1, (1 << 256) - 1, R, R + 2], [rnd.randrange(R), 5], [7, 7],
              [rnd.randrange(R), 3], [rnd.randrange(R)], [0, 0, 0, 0], [9, 9]], "corners")
    K, X, Y, Z, scalar_lists = cases["flush"]
    products, serial = msm_needed_products(scalar_lists)
    rounds = msm_needed_rounds(scalar_lists)
    b_ms, b_by = round_bound(rounds, products)
    blocks = {k: -(-2 * c[1].shape[1] // g1_msm.MSM_GROUPS) for k, c in cases.items()}
    rows.append(dict(
        name="g1_msm_many", route="cuda", source="eth_consensus_specs_tpu_torch/csrc/g1_msm.cu",
        replaces="eth_consensus_specs_tpu/ops/g1_msm.py:183", shape=list(X.shape[:2]),
        max_abs_err=max(errs), ms=cuda_ms(lambda: g1_msm.msm_many(K, X, Y, Z), repeats=10),
        device_ms=device_ms(lambda: g1_msm.msm_many(K, X, Y, Z), ("g1_msm_", "void g1_msm_")),
        plain_ms=cuda_ms(lambda: g1_msm.msm_many_ref(K, X, Y, Z), 1),
        bound_ms=b_ms, bound_by=b_by, library_ms=None, product_rounds=rounds,
        round_instr=FQ_ROUND_INSTR,
        one_lane_bound_ms=round_bound(rounds, products, FQ_MUL_SASS)[0],
        fq_products=products, serial_fq_products=serial,
        serial_bound_ms=fq_bound(products, serial)[0],
        design_product_rounds=msm_design_rounds(scalar_lists),
        ms_by_shape={k: cuda_ms(lambda c=c: g1_msm.msm_many(*c[:4]), repeats=3)
                     for k, c in cases.items() if k != "flush"},
        shapes_checked={k: list(c[1].shape[:2]) for k, c in cases.items()},
        blocks_per_item=blocks, cross_block=[k for k, b in blocks.items() if b > 1],
    ))
    return rows


def run_kzg_flush(dev) -> tuple[dict, dict]:
    """Phase 13: ``verify_many_blobs`` on a 64-blob serving flush
    (``scripts/das_bench.py``'s defaults: full 4096-element blobs from
    degree-8 polynomials), two of them dense ``sample_blob`` triples so that
    the FFT sees full rows: a warm call, three timed clean flushes with
    their stages (``parts_ms``), then three of the same flush with items 0
    and 32 tampered (the bisection). Verdicts against the host oracle: the
    batch ``verify_blob_kzg_proof_batch`` on the clean flush, the per-item
    ``verify_blob_kzg_proof`` on the tampered items and two clean ones. The
    card's busy time is K16, K17, K11 and K12 timed by CUDA events on one
    flush's own inputs."""
    import torch

    from eth_consensus_specs_tpu_torch import _ext
    from eth_consensus_specs_tpu_torch.crypto import kzg
    from eth_consensus_specs_tpu_torch.crypto.curve import g2_generator
    from eth_consensus_specs_tpu_torch.inputs import blob_flush, dense_blob_triple
    from eth_consensus_specs_tpu_torch.inputs import sparse_blob_triple
    from eth_consensus_specs_tpu_torch.ops import fr_fft, g1_msm, kzg_batch, pairing_device

    t0 = time.perf_counter()
    kzg.get_setup()
    setup_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    dense = {i: dense_blob_triple(b"smoke-dense-%d" % i) for i in KZG_DENSE}
    dense_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    tampered, bad = blob_flush(KZG_BLOBS, KZG_DEGREE, KZG_INVALID, dense)
    clean = [sparse_blob_triple(i, KZG_DEGREE) if i in bad else it
             for i, it in enumerate(tampered)]
    sparse_s = time.perf_counter() - t0
    want_bad = [i not in bad for i in range(KZG_BLOBS)]

    t0 = time.perf_counter()
    if kzg_batch.verify_many_blobs(clean, device=dev) != [True] * KZG_BLOBS:
        raise RuntimeError("the warm flush was not accepted")
    first_s = time.perf_counter() - t0

    _ext.reset_launches()
    runs, parts_runs = [], []
    for _ in range(KZG_TIMED):
        parts = {}
        t0 = time.perf_counter()
        verdicts = kzg_batch.verify_many_blobs(clean, device=dev, parts=parts)
        runs.append((time.perf_counter() - t0) * 1e3)
        parts_runs.append({k: v * 1e3 for k, v in parts.items()})
        if verdicts != [True] * KZG_BLOBS:
            raise RuntimeError("a timed clean flush was not accepted")
    launches = dict(_ext.launches)
    t_runs, t_parts, checks = [], [], 0
    for _ in range(KZG_TIMED):
        parts = {}
        t0 = time.perf_counter()
        got = kzg_batch.verify_many_blobs(tampered, device=dev, parts=parts)
        t_runs.append((time.perf_counter() - t0) * 1e3)
        t_parts.append({k: v * 1e3 for k, v in parts.items()})
        if got != want_bad:
            raise RuntimeError(f"the tampered flush's verdicts are not items {sorted(bad)} alone")
    checks = _ext.launches["final_exp"] - launches.get("final_exp", 0)

    # the host oracle: the clean flush as one batch, then item by item
    t0 = time.perf_counter()
    if not kzg.verify_blob_kzg_proof_batch(*map(list, zip(*clean))):
        raise RuntimeError("the host batch oracle rejects the clean flush")
    oracle_items = sorted(bad) + list(KZG_ORACLE_CLEAN)
    for i in oracle_items:
        if kzg_batch.verify_blob_host(*tampered[i]) != want_bad[i]:
            raise RuntimeError(f"item {i}: the card's verdict differs from the host oracle's")
    oracle_s = time.perf_counter() - t0

    # the card's work of one clean flush, on its own inputs
    parsed = [kzg_batch.parse_item(it) for it in clean]
    roots = kzg.compute_roots_of_unity(kzg.FIELD_ELEMENTS_PER_BLOB)
    vals = torch.from_numpy(kzg_batch.flush_words(parsed)).to(dev)
    tw = fr_fft._device_twiddles(fr_fft.inverse_roots(roots), len(roots), str(dev))
    scale = fr_fft._device_scale(len(roots), str(dev))
    points, scalars = kzg_batch.rlc_lincombs(parsed, kzg_batch.challenge_evaluations(parsed, dev))
    K, X, Y, Z = (torch.from_numpy(a).to(dev) for a in g1_msm.pack_msm(points, scalars))
    a_pt, b_pt = g1_msm.sums_to_points(g1_msm.msm_many(K, X, Y, Z))
    tau_g2 = kzg.get_setup().g2_monomial[1]
    packed = [torch.from_numpy(a).to(dev)
              for a in pairing_device.pack_pairs([(a_pt, -tau_g2), (b_pt, g2_generator())])]
    f = pairing_device.miller_product(*packed)
    kernel_ms = {
        "fr_fft": cuda_ms(lambda: fr_fft.fft_rows(vals, tw, scale, False), repeats=5),
        "g1_msm_many": cuda_ms(lambda: g1_msm.msm_many(K, X, Y, Z), repeats=5),
        "miller_product": cuda_ms(lambda: pairing_device.miller_product(*packed), repeats=5),
        "final_exp_is_one": cuda_ms(lambda: pairing_device.final_exp_is_one(f), repeats=5),
    }
    ms = statistics.median(runs)
    busy = sum(kernel_ms.values())
    med = {k: statistics.median(p.get(k, 0.0) for p in parts_runs) for k in parts_runs[0]}
    summary = dict(
        phase="kzg_flush", blobs=KZG_BLOBS, field_elements=kzg.FIELD_ELEMENTS_PER_BLOB,
        degree=KZG_DEGREE, dense_items=list(KZG_DENSE), tampered=sorted(bad), ms=ms, ms_runs=runs,
        blobs_per_s=KZG_BLOBS / (ms / 1e3), parts_ms=med, parts_ms_runs=parts_runs,
        first_call_s=first_s, setup_load_s=setup_s, dense_build_s=dense_s,
        sparse_build_s=sparse_s, launches=launches,
        launches_per_flush={k: v / KZG_TIMED for k, v in launches.items()},
        tampered_ms=statistics.median(t_runs), tampered_ms_runs=t_runs,
        tampered_parts_ms={k: statistics.median(p.get(k, 0.0) for p in t_parts)
                           for k in t_parts[0]},
        rlc_checks_per_tampered_flush=checks / KZG_TIMED, tampered_verdicts_ok=True,
        device_kernel_ms=kernel_ms, device_busy_ms=busy, device_idle_share=1 - busy / ms,
        oracle_batch_items=KZG_BLOBS, oracle_items=oracle_items, oracle_s=oracle_s,
        equal_host_oracle=True,
    )
    return summary, launches


def run_das_fft(dev) -> tuple[dict, dict]:
    """Phase 14: ``bench.py``'s das cell at its card size: 16 rows of 8192
    points, 8 chained forward FFTs (each on natural-order rows: K16 gathers
    by bit reversal), fresh full-range values each repeat; the last chain
    held against the plain version on the card. As ``bench.py``'s
    ``_das_setup`` does, the twiddle table is made once outside the timing
    and each round is one ``fft_rows`` call."""
    import torch

    from eth_consensus_specs_tpu_torch import _ext
    from eth_consensus_specs_tpu_torch.crypto import kzg
    from eth_consensus_specs_tpu_torch.ops import fr_fft

    b, n = DAS_FFT
    roots = kzg.compute_roots_of_unity(n)
    gen = torch.Generator(device=dev).manual_seed(8192)
    tw = fr_fft._device_twiddles(roots, n, str(dev))

    def chain(v, fn=fr_fft.fft_rows):
        for _ in range(DAS_CHAIN):
            v = fn(v, tw)
        return v

    chain(random_fr_words(gen, (b, n), dev))  # the twiddle upload and the first launch
    torch.cuda.synchronize(dev)
    _ext.reset_launches()
    times = []
    for _ in range(DAS_REPEATS):
        v = random_fr_words(gen, (b, n), dev)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        out = chain(v)
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    launches = dict(_ext.launches)
    err = max_abs_err(out, chain(v, fr_fft.fft_rows_ref))
    round_ms = statistics.median(times) / DAS_CHAIN
    summary = dict(
        phase="das_fft", batch=b, n=n, chain=DAS_CHAIN, repeats=DAS_REPEATS,
        ms_per_round=round_ms, ms_per_round_runs=[t / DAS_CHAIN for t in times],
        ffts_per_s=b / (round_ms / 1e3), bound_ms_per_round=fr_fft_bound(b, n, False)[0],
        launches=launches, max_abs_err=err, equal_plain=True,
    )
    return summary, launches


# --- slice 7: the whole slot (K18 and ops/slot_pipeline, serve/slot) -------------

SLOT_VALIDATORS = 1 << 20
SLOT_SLOTS = 8  # one epoch of the world's preset: minimal's SLOTS_PER_EPOCH
SLOT_COMMITTEES = 64  # mainnet's committees a slot at 2^20
SLOT_COMMITTEE = 512  # 2^20 validators / (32 slots x 64 committees)
SLOT_SYNC = 512  # mainnet's SYNC_COMMITTEE_SIZE, indices drawn with replacement
SLOT_BLOBS = 6  # deneb's MAX_BLOBS_PER_BLOCK
# K, the distinct keys: validator v signs with sk = 1 + (v mod K). bls_block's
# rule sizes it (the one-time host validation of K keys, 16,384 at 2.4-3.6 ms
# a key, fits KEY_BUDGET_S; the run fails if 2K would); a multiple of 512, so
# no key repeats inside a committee, and the keys 1..K that bls_block validates
SLOT_KEYS = BLS_ITEMS * BLS_BLOCK_COMMITTEE
SLOT_SPOIL = (("att", 2, 37), ("sync", 4, 0), ("blob", 5, 3))
SLOT_FOLDED = (2, 7)  # slots held whole against host_slot_fold
SLOT_REPLAY = 5
SLOT_SEED = 7
SLOT_ORACLE_WORKERS = 7


def slot_cell_plan(n: int, seed: int = 0):
    """A plan at the slot cell's lane counts: 64 contiguous committees of
    512 from a random base with 90% of their bits set (about 29,500 flag
    lanes, no duplicates), and 512 reward lanes drawn with replacement."""
    import numpy as np

    from eth_consensus_specs_tpu_torch.inputs import SLOT_PARTICIPATION

    rng = np.random.default_rng(seed)
    base = int(rng.integers(0, n // SLOT_COMMITTEE)) * SLOT_COMMITTEE
    members = (base + np.arange(SLOT_COMMITTEES * SLOT_COMMITTEE)) % n
    flags = members[rng.random(members.shape[0]) < SLOT_PARTICIPATION].astype(np.int32)
    rewards = rng.integers(0, n, SLOT_SYNC).astype(np.int32)
    return flags, rewards, np.full(SLOT_SYNC, 1024, np.uint64)


def slot_apply_bound(n: int, flag_lanes: int, reward_lanes: int) -> tuple[float, str]:
    """K18's least time: the three columns read and written once (2 x (8 +
    1 + 1) B a validator), 4 B a flag lane and 12 B a reward lane."""
    return bound(20 * n + 4 * flag_lanes + 12 * reward_lanes)


def event_ms(events, names=None) -> dict:
    """Milliseconds by counter of ``_ext.timing``'s event pairs (after a
    synchronize), only those named in ``names`` where given."""
    out: dict = {}
    for name, start, end in events:
        if names is None or name in names:
            out[name] = out.get(name, 0.0) + start.elapsed_time(end)
    return out


def check_slot_kernels(dev):
    """Phase 3, continued: K18 (``slot_apply`` and ``slot_apply_scatter``)
    word for word against ``slot_apply_ref`` at 2^20 validators, at the slot
    cell's lane counts and on its corners: duplicate flag and reward
    indices, indices 0 and n - 1, flags already set, balances of 2^64 - 1
    and 2^63 - 1 that a reward wraps or carries across the int64 sign bit,
    and an empty plan (the outputs are copies). ``ms`` times the wrapper
    (its host checks, the plan's copy in and both launches) by CUDA events
    over INNER calls back to back, as the other rows do; ``device_ms`` is
    the two kernels' time in the profiler's trace; the events around each
    single launch (``_ext.timing``, as the slot's busy split takes them)
    include the host's launch gap."""
    import numpy as np
    import torch

    from eth_consensus_specs_tpu_torch import _ext
    from eth_consensus_specs_tpu_torch.inputs import example_altair_inputs
    from eth_consensus_specs_tpu_torch.ops import slot_pipeline as sp

    n = SLOT_VALIDATORS
    cols, _ = example_altair_inputs(n, device=dev)
    cell = slot_cell_plan(n)
    flags_set = cols.prev_flags.clone()
    tgt_set = cols.cur_tgt_att.clone()
    flags_set[torch.from_numpy(cell[0][:4096]).long().to(dev)] = 0b111
    tgt_set[torch.from_numpy(cell[0][:4096]).long().to(dev)] = True
    wrapped = cols.balance.clone()
    wrapped[0], wrapped[n - 1], wrapped[17] = -1, -1, (1 << 63) - 1
    rng = np.random.default_rng(18)

    def plan(f, r, amt=1024):
        return (np.asarray(f, np.int32), np.asarray(r, np.int32),
                np.full(len(r), amt, np.uint64) if np.isscalar(amt) else np.asarray(amt, np.uint64))

    cases = {
        "cell": ((cols.balance, cols.prev_flags, cols.cur_tgt_att), cell),
        "duplicates": ((cols.balance, cols.prev_flags, cols.cur_tgt_att),
                       plan(rng.integers(0, 64, 4096), rng.integers(0, 16, 512))),
        "ends": ((cols.balance, cols.prev_flags, cols.cur_tgt_att),
                 plan([0, n - 1, 0], [n - 1, 0, n - 1])),
        "already_set": ((cols.balance, flags_set, tgt_set), cell),
        "wrap": ((wrapped, cols.prev_flags, cols.cur_tgt_att),
                 plan([0, n - 1, 17], [0, n - 1, 17, 17], [1024, 1 << 40, 1, 1 << 62])),
        "empty": ((cols.balance, cols.prev_flags, cols.cur_tgt_att), plan([], [])),
    }
    err = 0
    for case, (columns, p) in cases.items():
        before = [t.clone() for t in columns]
        got = sp.slot_apply(*columns, *p)
        want = sp.slot_apply_ref(*columns, *p)
        err = max([err] + [max_abs_err(g, w) for g, w in zip(got, want)])
        if not all(torch.equal(b, c) for b, c in zip(before, columns)):
            raise RuntimeError(f"K18 changed a committed column ({case})")
        if case == "empty" and not all(torch.equal(g, c) for g, c in zip(got, columns)):
            raise RuntimeError("K18's outputs of an empty plan are not copies")

    columns = cases["cell"][0]

    def k18():
        return sp.slot_apply(*columns, *cell)

    k18()
    torch.cuda.synchronize()
    samples = []
    for _ in range(REPEATS):
        _ext.timing = []
        k18()
        torch.cuda.synchronize()
        samples.append(event_ms(_ext.timing))
        _ext.timing = None
    f_lanes, r_lanes = len(cell[0]), len(cell[1])
    b_ms, b_by = slot_apply_bound(n, f_lanes, r_lanes)
    return [dict(
        name="slot_apply", route="cuda", source="eth_consensus_specs_tpu_torch/csrc/slot_apply.cu",
        replaces="eth_consensus_specs_tpu/ops/slot_pipeline.py:205", shape=[n, f_lanes, r_lanes],
        max_abs_err=err, ms=cuda_ms(k18, inner=INNER),
        device_ms=device_ms(k18, ("slot_apply",)),
        launch_event_ms_by_kernel={k: statistics.median(s[k] for s in samples)
                                   for k in samples[0]},
        plain_ms=cuda_ms(lambda: sp.slot_apply_ref(*columns, *cell), 5),
        bound_ms=b_ms, bound_by=b_by, library_ms=None, corners_checked=list(cases),
    )]


def _seed_pk_cache(entries) -> None:
    """Pool initializer of run_slot's host oracle: the K validated keys
    (their encodings and the points k * G), so each worker skips the
    one-time decompression the parent already paid; the pairing checks are
    the worker's own."""
    from eth_consensus_specs_tpu_torch.crypto import signature
    from eth_consensus_specs_tpu_torch.crypto.curve import B1, Point
    from eth_consensus_specs_tpu_torch.crypto.fields import Fq

    for data, x, y in entries:
        signature._PK_CACHE[data] = Point(Fq(x), Fq(y), B1)


def _expected_verdicts(req):
    att = [("att", req.slot, i) not in SLOT_SPOIL for i in range(len(req.attestations))]
    blobs = [("blob", req.slot, i) not in SLOT_SPOIL for i in range(len(req.blobs))]
    return att, ("sync", req.slot, 0) not in SLOT_SPOIL, blobs


def run_slot(dev) -> tuple[dict, dict]:
    """Phase 15: the whole slot at 2^20 validators through ``SlotWorld``
    (altair minimal, the example columns, the synthetic static tree, a
    checkpoint directory under a temporary directory, so every slot commits
    durably). One warm slot on a separate world, then one epoch of 8 slots
    (``inputs.slot_schedule``: 64 attestations of 512-member committees,
    90% of bits set, a 512-index sync aggregate drawn with replacement, 6
    degree-8 sparse blobs; attestation 37 of slot 2, the sync aggregate of
    slot 4 and blob 3 of slot 5 spoiled; slot 7 closes the epoch), each
    timed by host clock around ``prep_request`` + ``execute`` (what a caller
    pays a slot) with its phases. The busy split comes from a second world
    that runs the same slots with CUDA events around every launch, so the
    events add nothing to the timed run; its results and launches must
    equal the timed run's. Oracles: every slot's verdicts against the
    construction, its aggregates against ``crypto.signature.aggregate``, its
    root against the full root (K1-K3) of the same plain scatter chain;
    slots 2 and 7 whole, with their post-slot columns, against
    ``host_slot_fold`` (its per-item checks in a process pool). A fresh
    world restores from the directory and replays slot 5 unchanged."""
    import multiprocessing as mp
    import os
    import tempfile
    from concurrent.futures import ProcessPoolExecutor
    from dataclasses import replace

    import torch

    from eth_consensus_specs_tpu_torch import _ext
    from eth_consensus_specs_tpu_torch.config import epoch_params
    from eth_consensus_specs_tpu_torch.crypto.curve import g1_to_bytes
    from eth_consensus_specs_tpu_torch.crypto.signature import _PK_CACHE, _load_pk
    from eth_consensus_specs_tpu_torch.inputs import example_altair_inputs, g1_keys, slot_schedule
    from eth_consensus_specs_tpu_torch.ops import slot_pipeline as sp
    from eth_consensus_specs_tpu_torch.ops import state_root
    from eth_consensus_specs_tpu_torch.ops.altair_epoch import altair_epoch_accounting_ref
    from eth_consensus_specs_tpu_torch.parallel import resident
    from eth_consensus_specs_tpu_torch.serve.slot import SlotWorld

    n = SLOT_VALIDATORS
    t_setup = time.perf_counter()
    # the cut: validate a sample of fresh keys to size the one-time validation
    sample = [g1_to_bytes(k) for k in g1_keys(64, first=(1 << 40) + (1 << 20))]
    t0 = time.perf_counter()
    if any(_load_pk(b) is None for b in sample):
        raise RuntimeError("a valid key was rejected")
    ms_per_key = (time.perf_counter() - t0) * 1e3 / len(sample)
    if 2 * SLOT_KEYS * ms_per_key / 1e3 <= KEY_BUDGET_S:
        raise RuntimeError(f"{ms_per_key:.3f} ms/key no longer justifies {SLOT_KEYS} keys: "
                           f"twice as many would validate within {KEY_BUDGET_S:.0f} s")
    reduced = {"distinct_keys": [n, SLOT_KEYS],
               "why": f"one-time host key validation, {ms_per_key:.3f} ms/key: "
                      f"{n * ms_per_key / 1e3:.1f} s for the registry, "
                      f"{SLOT_KEYS * ms_per_key / 1e3:.1f} s for {SLOT_KEYS} keys, "
                      f"against a {KEY_BUDGET_S:.0f} s budget; validator v signs with "
                      f"sk = 1 + (v mod {SLOT_KEYS})",
               "fits_budget": SLOT_KEYS * ms_per_key / 1e3 <= KEY_BUDGET_S}
    points = g1_keys(SLOT_KEYS)
    pubkeys = [g1_to_bytes(p) for p in points]
    cached_before = sum(b in _PK_CACHE for b in pubkeys)
    t0 = time.perf_counter()
    if any(_load_pk(b) is None for b in pubkeys):
        raise RuntimeError("a registry key was rejected")
    keys_s = time.perf_counter() - t0

    def schedule(slots, seed, spoil=()):
        return slot_schedule(n, slots=slots, committees=SLOT_COMMITTEES, committee=SLOT_COMMITTEE,
                             subnets=SLOT_COMMITTEES, keys=SLOT_KEYS, pubkeys=pubkeys,
                             sync_size=SLOT_SYNC, blobs=SLOT_BLOBS, spoil=spoil, seed=seed)

    t0 = time.perf_counter()
    reqs = schedule(SLOT_SLOTS, SLOT_SEED, SLOT_SPOIL)
    warm_req = schedule(1, SLOT_SEED + 1)[0]
    schedule_s = time.perf_counter() - t0

    tmp = tempfile.TemporaryDirectory(prefix="chip_smoke_slot_")
    ckpt = os.path.join(tmp.name, "world")
    warm = SlotWorld(n, ckpt_dir=os.path.join(tmp.name, "warm"), device=dev)
    t0 = time.perf_counter()
    warm_result, _ = warm.execute(warm_req, prep=sp.prep_request(warm_req))
    warm_s = time.perf_counter() - t0
    if not (all(warm_result.att_verdicts) and warm_result.sync_verdict
            and all(warm_result.blob_verdicts)):
        raise RuntimeError("the warm slot was not accepted whole")
    del warm
    world = SlotWorld(n, ckpt_dir=ckpt, device=dev)
    t0 = time.perf_counter()
    world.boot()
    boot_s = time.perf_counter() - t0
    setup_s = time.perf_counter() - t_setup

    def serve(w, req):
        """One served slot: the request's prep, then execute; the host
        milliseconds of each and the launches it made."""
        before = dict(_ext.launches)
        t0 = time.perf_counter()
        prep = sp.prep_request(req)
        t1 = time.perf_counter()
        result, phases = w.execute(req, prep=prep)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        made = {k: v - before.get(k, 0) for k, v in _ext.launches.items() if v - before.get(k, 0)}
        return result, dict(slot=req.slot, boundary=req.epoch_boundary, ms=(t2 - t0) * 1e3,
                            prep_ms=(t1 - t0) * 1e3, execute_ms=(t2 - t1) * 1e3,
                            phases_ms=phases, launches=made)

    # the timed run: host clock around prep + execute, no events recorded
    torch.cuda.synchronize()
    _ext.reset_launches()
    slots, results = [], []
    for req in reqs:
        result, row = serve(world, req)
        results.append(result)
        slots.append(row)
    launches = dict(_ext.launches)

    # the busy split: the same slots on a second world booted alike, with
    # CUDA events around every launch (they include each launch's host gap).
    # The hash-to-G2 and prepared-G2 caches hold the timed run's messages:
    # emptied, so this run does the timed run's device work.
    from eth_consensus_specs_tpu_torch.ops import bls_batch, pairing_device

    with bls_batch._H2G2_LOCK:
        bls_batch._H2G2_CACHE.clear()
    with pairing_device._PREP_LOCK:
        pairing_device._PREP_CACHE.clear()
    t0 = time.perf_counter()
    twin = SlotWorld(n, ckpt_dir=os.path.join(tmp.name, "busy"), device=dev)
    twin.boot()
    torch.cuda.synchronize()
    _ext.timing = []
    for req, got, s in zip(reqs, results, slots):
        mark = len(_ext.timing)
        result, row = serve(twin, req)
        if result != got or row["launches"] != s["launches"]:
            raise RuntimeError(f"slot {req.slot}: the busy-split run differs from the timed run")
        s["busy_ms_by_kernel"] = event_ms(_ext.timing[mark:])
        s["busy_ms"] = sum(s["busy_ms_by_kernel"].values())
        s["idle_share"] = 1 - s["busy_ms"] / s["ms"]
        s["busy_run_ms"] = row["ms"]
    events, _ext.timing = _ext.timing, None
    del twin
    busy_s = time.perf_counter() - t0

    # the oracles
    t0 = time.perf_counter()
    params = epoch_params("altair", "minimal")
    static = world._static
    arrays, meta = static
    cols, just = example_altair_inputs(n, device=dev)
    epoch, folded, k18 = 0, [], []
    entries = [(b, p.x.n, p.y.n) for b, p in zip(pubkeys, points)]
    with ProcessPoolExecutor(max_workers=SLOT_ORACLE_WORKERS, mp_context=mp.get_context("spawn"),
                             initializer=_seed_pk_cache, initargs=(entries,)) as pool:

        def pool_map(fn, items):
            return pool.map(fn, items, chunksize=2)

        for req, got in zip(reqs, results):
            att, sync, blobs = _expected_verdicts(req)
            if (list(got.att_verdicts), got.sync_verdict, list(got.blob_verdicts)) != (
                    att, sync, blobs):
                raise RuntimeError(f"slot {req.slot}: the verdicts differ from the construction")
            if got.subnet_aggregates != sp.host_aggregate(req, att):
                raise RuntimeError(f"slot {req.slot}: the aggregates differ from the host's")
            if req.slot in SLOT_FOLDED:
                fold, fold_cols, _ = sp.host_slot_fold(params, static, cols, just, req, epoch,
                                                       map_fn=pool_map, device=dev)
                if fold != got:
                    raise RuntimeError(f"slot {req.slot}: the result differs from host_slot_fold")
            plan = sp.plan_updates(req, att, sync, n)
            k18.append(slot_apply_bound(n, len(plan[0]), len(plan[1]))[0])
            balance, flags, tgt = sp.slot_apply_ref(cols.balance, cols.prev_flags,
                                                    cols.cur_tgt_att, *plan)
            cols = cols._replace(balance=balance, prev_flags=flags, cur_tgt_att=tgt)
            if req.epoch_boundary:
                cols, just = resident.advance(altair_epoch_accounting_ref, params, cols, just)
                epoch += 1
            root = sp._root_bytes(state_root.post_epoch_state_root(
                arrays, meta, cols.balance, cols.effective_balance, cols.inactivity_scores, just))
            if root != got.state_root or epoch != got.epoch:
                raise RuntimeError(f"slot {req.slot}: the root differs from the full root of "
                                   "the plain scatter")
            if req.slot in SLOT_FOLDED:
                for name in ("balance", "effective_balance", "inactivity_scores", "prev_flags",
                             "cur_tgt_att"):
                    max_abs_err(getattr(fold_cols, name), getattr(cols, name))
                folded.append(req.slot)
    for name in ("balance", "effective_balance", "inactivity_scores", "prev_flags",
                 "cur_tgt_att"):
        max_abs_err(getattr(world._carry.cols, name), getattr(cols, name))
    oracle_s = time.perf_counter() - t0

    # restore into a fresh world and replay a committed slot
    t0 = time.perf_counter()
    again = SlotWorld(n, ckpt_dir=ckpt, device=dev)
    again.boot()
    restore_s = time.perf_counter() - t0
    if (again.root, again.epoch) != (world.root, world.epoch):
        raise RuntimeError("the restored world's root or epoch differs")
    replayed, replay_phases = again.execute(reqs[SLOT_REPLAY])
    if not replayed.replayed or replace(replayed, replayed=False) != results[SLOT_REPLAY]:
        raise RuntimeError(f"slot {SLOT_REPLAY} did not replay unchanged after the restore")
    if again.root != world.root:
        raise RuntimeError("the replay moved the restored world")
    tmp.cleanup()

    plain = [s for s in slots if not s["boundary"]]
    edge = [s for s in slots if s["boundary"]][0]
    plain_ms = [s["ms"] for s in plain]
    total_busy = {}
    for s in slots:
        for k, v in s["busy_ms_by_kernel"].items():
            total_busy[k] = total_busy.get(k, 0.0) + v
    busy_sum = sum(total_busy.values())
    phase_names = sorted({k for s in slots for k in s["phases_ms"]})
    k18_ms = [s["busy_ms_by_kernel"].get("slot_apply", 0.0)
              + s["busy_ms_by_kernel"].get("slot_apply_scatter", 0.0) for s in slots]
    summary = dict(
        phase="slot", fork="altair", preset="minimal", validators=n, slots=SLOT_SLOTS,
        committees=SLOT_COMMITTEES, committee=SLOT_COMMITTEE, sync=SLOT_SYNC, blobs=SLOT_BLOBS,
        spoiled=[list(s) for s in SLOT_SPOIL], reduced=reduced,
        ms_plain_median=statistics.median(plain_ms), ms_plain_range=[min(plain_ms), max(plain_ms)],
        ms_boundary=edge["ms"], slots_per_s=len(slots) / (sum(s["ms"] for s in slots) / 1e3),
        phases_ms_plain_median={k: statistics.median(s["phases_ms"].get(k, 0.0) for s in plain)
                                for k in phase_names},
        phases_ms_boundary=edge["phases_ms"],
        prep_ms_median=statistics.median(s["prep_ms"] for s in slots),
        execute_ms_plain_median=statistics.median(s["execute_ms"] for s in plain),
        execute_ms_boundary=edge["execute_ms"],
        busy_ms_plain_median=statistics.median(s["busy_ms"] for s in plain),
        busy_ms_boundary=edge["busy_ms"],
        idle_share_plain_median=statistics.median(s["idle_share"] for s in plain),
        idle_share_boundary=edge["idle_share"],
        busy_share_by_kernel={k: v / busy_sum for k, v in sorted(total_busy.items())},
        busy_ms_per_slot_by_kernel={k: v / len(slots) for k, v in sorted(total_busy.items())},
        launches=launches, launches_per_slot={k: v / len(slots) for k, v in launches.items()},
        launches_boundary=edge["launches"],
        k18_event_ms_median=statistics.median(k18_ms), k18_event_ms_runs=k18_ms,
        k18_bound_ms_median=statistics.median(k18), k18_bound_by="bytes",
        per_slot=slots, roots=[r.state_root.hex() for r in results],
        held_whole_against_host_slot_fold=folded, equal_oracles=True,
        restore_s=restore_s, replayed_slot=SLOT_REPLAY, replay_phases=replay_phases,
        ms_per_key=ms_per_key, keys_cached_before=cached_before, keys_validate_s=keys_s,
        schedule_s=schedule_s, warm_slot_s=warm_s, boot_s=boot_s, setup_s=setup_s,
        busy_run_s=busy_s, oracle_s=oracle_s, timing_events=len(events),
    )
    return summary, launches


# --- slice 8: the block-epoch plane (K19) and the GT export (K20) ----------------

BLOCK_VALIDATORS = 1 << 20
BLOCK_ATTS = 128  # bench.py's block_epoch cell on an accelerator: 128 attestations a slot
BLOCK_SEED = 11  # bench.py's _block_epoch_setup
BLOCK_TIMED = 5
BLOCK_PLAIN_SLOTS = 4  # slots held against the plain chain on the card
BLOCK_ORACLE_WORKERS = 7
BLOCK_LIMIT_MS = 1000.0  # BASELINE config #4: an epoch of blocks under 1 s
GT_PAIRS = ((3, 5), (7, 2), (11, 13), (1, 17))  # the pairs (a G1, b G2)


def block_slot_bytes(params, n: int, slot, before, after) -> int:
    """Bytes one K19 launch must move on this slot's data, each input read
    once and each output written once. Reads: the withdrawal window's
    balance, effective balance, withdrawable epoch and credential (25 B a
    position); the rows' indices and bits (5 B a lane) and their flag,
    current and pay bytes; each live lane's participation byte and base
    reward (9 B); the deposit lanes (12 B); the sync positions (5 B), the
    balance of each distinct validator they name and the proposer's (8 B);
    the six scalars. Writes: every balance (8 B) and participation byte
    (1 B) that changed, the three scalars."""
    import numpy as np

    from eth_consensus_specs_tpu_torch.convert import to_numpy

    idx, bits, flags = (to_numpy(t) for t in (slot.att_idx, slot.att_bits, slot.att_flags))
    live = int(((idx < n) & bits & (flags[:, None] != 0)).sum())
    a, c = idx.shape
    sync = to_numpy(slot.sync_idx)
    window = min(n, params.max_validators_per_withdrawals_sweep)
    reads = (25 * window + 5 * a * c + 3 * a + 9 * live + 12 * to_numpy(slot.dep_idx).size
             + 5 * sync.size + 8 * (np.unique(sync).size + 1) + 8 * 6)
    writes = sum(int((x != y).sum()) * w for x, y, w in zip(before, after, (8, 1, 1)))
    return reads + writes + 8 * 3


def block_slot_sync_steps(slot) -> tuple[int, int]:
    """K19's sequential sync steps on one slot: the proposer's own positions
    in the committee, and the longest run of one validator's positions."""
    import numpy as np

    from eth_consensus_specs_tpu_torch.convert import to_numpy

    sync = to_numpy(slot.sync_idx)
    runs = np.unique(sync, return_counts=True)[1]
    return int((sync == int(slot.proposer)).sum()), int(runs.max()) if runs.size else 0


def final_exp_gt_fq_products(sqr: int = FQ_PER_CYC_SQR) -> int:
    """The Fq products of K20's chain, without its input conversion: K12's
    easy part (an inverse, two products, a p^2-Frobenius), the power by
    (x-1)^2/3 (125 squarings, 47 products), three powers by x, a Frobenius
    and a p^2-Frobenius, three products, and the last product by m; with
    ``sqr`` products a squaring, as ``final_exp_fq_products`` counts."""
    from eth_consensus_specs_tpu_torch.ops.pairing_device import _HARD_E

    squarings, products = _HARD_E.bit_length() - 1, bin(_HARD_E).count("1") - 1
    return (_fq12_inv_products() + (2 + products + 3 + 1) * FQ_PER_FQ12_MUL
            + squarings * sqr + 3 * powx_products(sqr) + 18 + 2 * 12)


def final_exp_gt_rounds() -> int:
    """K20's chain at full tower parallelism, as ``final_exp_rounds`` counts
    K12's, without the easy part's Fq inverse (the row bounds it apart): the
    Fq12 inverse's 7 rounds; the easy part's conj product, p^2-Frobenius and
    product; the power by (x-1)^2/3 (125 squarings, 47 products); three
    powers by x (63 squarings and 5 products each); a Frobenius, a
    p^2-Frobenius and three products; the last product by m; the store."""
    from eth_consensus_specs_tpu_torch.ops.pairing_device import _HARD_E

    squarings, products = _HARD_E.bit_length() - 1, bin(_HARD_E).count("1") - 1
    return 7 + 3 + squarings + products + 3 * (63 + 5) + 5 + 1 + 1


def final_exp_gt_norm(f) -> int:
    """The Fq value whose inverse K20 takes by the binary GCD, as card
    Montgomery int: ``inv_a``'s norm on canonical words ``f``, run on host
    ints (``fq12_coop.simulate``) as the kernel runs it."""
    from eth_consensus_specs_tpu_torch.ops import field_limbs as fl
    from eth_consensus_specs_tpu_torch.ops import fq12_coop as coop

    mem = {i: v for i, (_, v) in enumerate(coop.CONSTS)}
    F, W = coop.SLOTS, coop.SLOTS + 12
    mem.update({F + k: v for k, v in enumerate(fl.words_to_ints(f.cpu().numpy().reshape(12, 12)))})
    for op, z in (("load", 0), ("inv_a", W)):
        coop.simulate(coop.PROGRAMS[op], mem, {coop.X: F, coop.Y: 0, coop.Z: z, coop.O: F, coop.S: 0})
    return mem[W + coop.INV_NORM]


def check_block_epoch_kernels(dev):
    """Phase 3, continued: K19 (``block_slot``) word for word against
    ``block_slot_ref`` (balance, both participation columns, the withdrawal
    pointers and the numerator) at 2^20 validators x 128 rows x 512 lanes,
    on every corner of ``inputs.block_slot_corners``: the block_epoch cell's
    first slot, a window that wraps past n, a full and a partial payload,
    rows that repeat validators, unpaid runs, the proposer in the sync
    committee on a balance of 1, repeated sync indices, duplicate deposits,
    balances and a numerator at and above 2^63, an all-pad slot. ``ms``,
    ``device_ms`` (traced) and ``plain_ms`` are a slot's mean over the
    cell's 32 slots applied in order from its first state, which is
    restored outside each timed epoch; the bound counts the bytes of each
    of those slots, averaged.

    K20 (``final_exp_gt``) word for word against
    ``final_exponentiation_ref`` and against the host
    ``crypto.pairing.final_exponentiation`` on the Miller values of 4 pairs
    (a G1, b G2); K12 says true exactly when K20 gives one, on
    e(6P, 5Q) e(-cP, Q) for c = 30 (one) and 31 (not)."""
    import torch

    from eth_consensus_specs_tpu_torch.config import block_epoch_params
    from eth_consensus_specs_tpu_torch.crypto import pairing as oracle
    from eth_consensus_specs_tpu_torch.crypto.curve import g1_generator, g2_generator
    from eth_consensus_specs_tpu_torch.inputs import block_slot_corners
    from eth_consensus_specs_tpu_torch.ops import block_epoch as be
    from eth_consensus_specs_tpu_torch.ops import pairing_device as pd

    params, n = block_epoch_params("deneb", "mainnet"), BLOCK_VALIDATORS
    corners = block_slot_corners(params, n, BLOCK_ATTS, BLOCK_SEED, device=dev)
    scratch = be.SlotScratch(n, dev)  # one for every slot, as a chain keeps one
    kernel = functools.partial(be.block_slot, scratch=scratch)
    checked, err = list(corners), 0
    for st, slot, static in corners.values():
        outs = [fn(params, n, *(t.clone() for t in (st.balance, st.cur_part, st.prev_part)),
                   be._scalars(st), slot, static) for fn in (kernel, be.block_slot_ref)]
        err = max([err] + [max_abs_err(g, w) for g, w in zip(*outs)])
    if not bool((scratch.words[:2 * n] == -1).all()) or bool(scratch.words[2 * n:].any()):
        raise RuntimeError("K19 left its scratch unclean")
    del corners, outs
    cols, st0, static = be.synthetic_block_columns(params, n, BLOCK_SEED, BLOCK_ATTS, device=dev)
    slots = [be.slot_columns(cols, s) for s in range(params.slots_per_epoch)]
    fresh = [st0.balance, st0.cur_part, st0.prev_part, be._scalars(st0)]
    work = [t.clone() for t in fresh]

    def epoch(fn):
        for slot in slots:
            fn(params, n, *work, slot, static)

    def restore():
        for w, f in zip(work, fresh):
            w.copy_(f)
        torch.cuda.synchronize(dev)

    def slot_ms(fn, repeats):
        samples = []
        for _ in range(repeats):
            restore()
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            epoch(fn)
            end.record()
            end.synchronize()
            samples.append(start.elapsed_time(end) / len(slots))
        return statistics.median(samples)

    restore()
    nbytes = []  # the warm-up epoch counts each slot's bytes
    for slot in slots:
        before = [t.clone() for t in work[:3]]
        kernel(params, n, *work, slot, static)
        nbytes.append(block_slot_bytes(params, n, slot, before, work[:3]))
    ms = slot_ms(kernel, REPEATS)
    restore()
    per = per_call_ms(device_profile(lambda: epoch(kernel)), len(slots))
    traced = [t for name, t in per.items() if name.startswith("block_slot")]
    if not traced:
        raise RuntimeError("the trace holds no block_slot kernel")
    b_ms, b_by = bound(statistics.mean(nbytes))
    a, c = slot.att_idx.shape
    sy, d = slot.sync_idx.shape[0], slot.dep_idx.shape[0]
    # the design's chain: two grid barriers, then the proposer's own sync
    # positions and the longest run of one validator's (the worst slot)
    steps = [block_slot_sync_steps(s) for s in slots]
    chain = max(2 + p + longest for p, longest in steps)
    rows = [dict(
        name="block_slot", route="cuda", source="eth_consensus_specs_tpu_torch/csrc/block_epoch.cu",
        replaces="eth_consensus_specs_tpu/ops/block_epoch.py:265", shape=[n, a, c, sy, d],
        max_abs_err=err, ms=ms, device_ms=sum(traced), plain_ms=slot_ms(be.block_slot_ref, 1),
        bound_ms=b_ms, bound_by=b_by, bytes=statistics.mean(nbytes),
        serial_chain_steps=chain, grid_barriers=2,
        sync_steps_proposer=max(p for p, _ in steps),
        sync_steps_longest_run=max(longest for _, longest in steps),
        grid_blocks=scratch.blocks, threads_per_block=1024,
        library_ms=None, corners_checked=checked,
    )]
    del work, fresh, cols

    g, q = g1_generator(), g2_generator()

    def miller(pairs):
        return pd.miller_product(*[torch.from_numpy(x).to(dev) for x in pd.pack_pairs(pairs)])

    err, fs = 0, []
    for a_, b_ in GT_PAIRS:
        f = miller([(g.mul(a_), q.mul(b_))])
        got = pd.final_exponentiation(f)
        err = max(err, max_abs_err(got, pd.final_exponentiation_ref(f)))
        if pd.fq12_from_words(got) != oracle.final_exponentiation(pd.fq12_from_words(f)):
            raise RuntimeError(f"final_exponentiation of e({a_}P, {b_}Q)'s Miller value differs "
                               "from the host oracle")
        fs.append(f)
    verdicts = {}
    for c_ in (30, 31):
        f = miller([(g.mul(6), q.mul(5)), (-g.mul(c_), q)])
        one = pd.fq12_from_words(pd.final_exponentiation(f)).is_one()
        if bool(pd.final_exp_is_one(f)) != one or one != (c_ == 30):
            raise RuntimeError(f"K12's verdict and K20's value disagree on e(6P, 5Q) e(-{c_}P, Q)")
        verdicts["one" if c_ == 30 else "not_one"] = one
    f = fs[0]
    repeats_equal("final_exponentiation", lambda: pd.final_exponentiation(f),
                  pd.final_exponentiation(f))
    products, design = final_exp_gt_fq_products(), final_exp_gt_fq_products(FQ_PER_FQ12_SQR)
    rounds = final_exp_gt_rounds()
    fermat_instr = fq_window_inverse_products() * FQ_ROUND_INSTR
    gcd_instr = gcd_chain_instr([final_exp_gt_norm(f)])
    chain_ms = (rounds * FQ_ROUND_INSTR + min(fermat_instr, gcd_instr)) / CLOCK_HZ * 1e3
    thru_ms = products * FQ_MUL_INSTR / INT_OPS_PER_S * 1e3
    rows.append(dict(
        name="final_exp_gt", route="cuda",
        source="eth_consensus_specs_tpu_torch/csrc/final_exp_gt.cu",
        replaces="eth_consensus_specs_tpu/ops/pairing_device.py:281", shape=[2, 3, 2, 12],
        max_abs_err=err, ms=cuda_ms(lambda: pd.final_exponentiation(f), repeats=5, inner=INNER),
        device_ms=device_ms(lambda: pd.final_exponentiation(f), ("final_exp_gt_kernel",)),
        plain_ms=cuda_ms(lambda: pd.final_exponentiation_ref(f), 1),
        bound_ms=max(chain_ms, thru_ms), bound_by="operations", library_ms=None,
        product_rounds=rounds, round_instr=FQ_ROUND_INSTR,
        inverse_bound_ms={"fermat": fermat_instr / CLOCK_HZ * 1e3,
                          "gcd": gcd_instr / CLOCK_HZ * 1e3},
        gcd_steps=gcd_instr / GCD_STEP_INSTR, gcd_step_instr=GCD_STEP_INSTR,
        one_lane_bound_ms=(rounds * FQ_MUL_SASS + min(fermat_instr * FQ_MUL_SASS / FQ_ROUND_INSTR,
                                                      gcd_instr)) / CLOCK_HZ * 1e3,
        fq_products=products, serial_fq_products=products,
        serial_bound_ms=fq_bound(products, products)[0], design_fq_products=design,
        k12_fq_products=final_exp_fq_products(), oracle_checked=len(GT_PAIRS),
        verdicts_checked=verdicts, repeats_equal=REPEATS,
    ))
    return rows


def _equal_block_state(what: str, got, want) -> None:
    import torch

    for name, g, w in zip(got._fields, got, want):
        if not torch.equal(g.cpu(), torch.as_tensor(w).cpu()):
            raise RuntimeError(f"{what}: {name} differs")


def run_block_epoch(dev) -> tuple[dict, dict]:
    """Phase 16: ``bench.py``'s block_epoch cell at its card size (BASELINE
    config #4): deneb mainnet, 2^20 validators, 32 slots of 128 attestation
    rows x 512 lanes (the committee cap ``synthetic_block_columns`` picks),
    a 512-index sync aggregate, 16 deposits a slot, the withdrawal sweep,
    seed 11, the scores and justification of ``example_altair_inputs(n)``,
    ``synthetic_static(n)``, a state root every slot. The first 4 slots
    against the plain chain on the card (``block_slot_ref`` and
    ``state_root.PLAIN``), word for word; a warm chain, then 5 timed chains,
    each from a fresh column ``balance + salt`` and ending in a sync, by
    host clock; one more chain with CUDA events around every launch (K19's
    ms a slot against the root's) and one under the profiler (the card's
    busy time). The last timed chain's digest sha256(acc || balance) against
    the port's numpy replay with hashlib roots over the whole epoch (the 32
    roots in a process pool). Not cut."""
    import multiprocessing as mp
    from concurrent.futures import ProcessPoolExecutor

    import numpy as np
    import torch

    from eth_consensus_specs_tpu_torch import _ext
    from eth_consensus_specs_tpu_torch.config import block_epoch_params
    from eth_consensus_specs_tpu_torch.convert import to_numpy
    from eth_consensus_specs_tpu_torch.inputs import example_altair_inputs
    from eth_consensus_specs_tpu_torch.ops import block_epoch as be
    from eth_consensus_specs_tpu_torch.ops import block_epoch_host as beh
    from eth_consensus_specs_tpu_torch.ops.state_root import (PLAIN, slot_root_real_hashes,
                                                              synthetic_static)

    n, params = BLOCK_VALIDATORS, block_epoch_params("deneb", "mainnet")
    t0 = time.perf_counter()
    cols, st0, static = be.synthetic_block_columns(params, n, seed=BLOCK_SEED,
                                                   atts_per_slot=BLOCK_ATTS, device=dev)
    ecols, just = example_altair_inputs(n, device=dev)
    scores = ecols.inactivity_scores
    arrays, meta = synthetic_static(n, device=dev)
    _ext.reset_launches()
    ctx = be.make_root_ctx("deneb", arrays, meta, static, scores, just)
    ctx_launches = dict(_ext.launches)  # the epoch's slow-moving top chunks: K3, one K2 launch
    torch.cuda.synchronize(dev)
    setup_s = time.perf_counter() - t0

    def chain(st, blocks=cols):
        return be.block_epoch_chain(params, n, st, blocks, static, root_ctx=ctx, device=dev)

    t0 = time.perf_counter()
    head = be.BlockColumns(*(t[:BLOCK_PLAIN_SLOTS] for t in cols))
    plain_ctx = be.make_root_ctx("deneb", arrays, meta, static, scores, just, PLAIN)
    got, want = chain(st0, head), be.block_epoch_chain_ref(params, n, st0, head, static,
                                                           root_ctx=plain_ctx, device=dev)
    _equal_block_state(f"the first {BLOCK_PLAIN_SLOTS} slots against the plain chain", got[0],
                       want[0])
    if not torch.equal(got[1], want[1]):
        raise RuntimeError("the per-slot roots differ from the plain chain's")
    plain_s = time.perf_counter() - t0

    chain(st0)
    torch.cuda.synchronize(dev)
    _ext.reset_launches()
    times, enqueue = [], []
    for i in range(BLOCK_TIMED):
        fresh = st0._replace(balance=st0.balance + (i + 1))
        torch.cuda.synchronize(dev)
        t = time.perf_counter()
        out = chain(fresh)
        enqueue.append((time.perf_counter() - t) * 1e3)
        torch.cuda.synchronize(dev)
        times.append((time.perf_counter() - t) * 1e3)
    launches = dict(_ext.launches)
    st, acc = out
    digest = hashlib.sha256(to_numpy(acc).tobytes() + to_numpy(st.balance).tobytes()).hexdigest()

    _ext.timing = []
    again = chain(fresh)
    torch.cuda.synchronize(dev)
    events = event_ms(_ext.timing)
    _ext.timing = None
    _equal_block_state("the events run against the timed run", again[0], st)
    prof = device_profile(lambda: chain(fresh))

    t0 = time.perf_counter()
    snaps = []

    def record(bal, cur, prev, slot_no):
        snaps.append((bal.copy(), cur.copy(), prev.copy(), slot_no))
        return np.zeros(8, np.uint32)

    bal, cur, prev, wdi, wdv, _ = beh.replay_block_epoch_np(
        params, n, fresh, cols, static.eff_balance, static.withdrawable_epoch,
        static.has_eth1_cred, int(static.epoch), root_fn=record)
    with ProcessPoolExecutor(max_workers=BLOCK_ORACLE_WORKERS,
                             mp_context=mp.get_context("spawn")) as pool:
        root_fn = beh.slot_root_fn_np("deneb", arrays, meta, static, scores, just)
        roots = list(pool.map(root_fn, *zip(*snaps)))
    acc_h = np.bitwise_xor.reduce(np.stack(roots), axis=0)
    digest_h = hashlib.sha256(acc_h.tobytes() + bal.tobytes()).hexdigest()
    oracle_s = time.perf_counter() - t0
    if digest != digest_h:
        raise RuntimeError(f"block_epoch digest {digest} differs from the numpy replay's {digest_h}")
    _equal_block_state("the chain against the numpy replay", st,
                       (bal.view(np.int64), cur, prev, wdi, wdv))

    epoch_ms = statistics.median(times)
    slots = int(cols.proposer.shape[0])
    hashing = sum(launches.get(k, 0) for k in ("sha256", "merkle", "merkle_lists")) / (
        BLOCK_TIMED * slots)
    if hashing > 2:
        raise RuntimeError(f"a slot root took {hashing} hashing launches, more than 2")
    k19_ms = events.get("block_slot", 0.0)
    summary = dict(
        phase="block_epoch", fork="deneb", preset="mainnet", n=n, slots=slots,
        atts=int(cols.att_idx.shape[1]), committee=int(cols.att_idx.shape[2]),
        sync=int(cols.sync_idx.shape[1]), deposits=int(cols.dep_idx.shape[1]), seed=BLOCK_SEED,
        timed=BLOCK_TIMED, epoch_ms_median=epoch_ms, epoch_ms_range=[min(times), max(times)],
        epoch_ms_runs=times,
        slot_ms=epoch_ms / slots, host_enqueue_ms_median=statistics.median(enqueue),
        k19_event_ms_per_slot=k19_ms / slots,
        root_event_ms_per_slot=(sum(events.values()) - k19_ms) / slots,
        event_ms_by_kernel=events, device_busy_ms=prof["device_busy_ms"],
        idle_share=1 - prof["device_busy_ms"] / epoch_ms, device_top=prof["top"][:6],
        launches_per_epoch={k: v / BLOCK_TIMED for k, v in launches.items()},
        hashing_launches_per_slot=hashing,
        root_hashes_per_slot=slot_root_real_hashes(n, meta.top_depth),
        limit_ms=BLOCK_LIMIT_MS, under_limit=epoch_ms < BLOCK_LIMIT_MS,
        next_wd_index=int(st.next_wd_index), next_wd_validator=int(st.next_wd_validator),
        digest=digest[:32], digest_oracle=digest_h[:32], plain_slots_checked=BLOCK_PLAIN_SLOTS,
        setup_s=setup_s, plain_s=plain_s, oracle_s=oracle_s, reduced=[],
        root_ctx_launches=ctx_launches,
    )
    # the path's counts: the timed epochs' and the epoch's root context
    return summary, {k: launches.get(k, 0) + ctx_launches.get(k, 0)
                     for k in {**launches, **ctx_launches}}


def run_gt_export(dev) -> tuple[dict, dict]:
    """Phase 17: the GT export: ``pairing_device`` of the 4 pairs
    (a G1, b G2) of ``GT_PAIRS`` and one pair at infinity, each held against
    the host ``pairing``, and bilinearity on the host: e(aP, bQ) =
    e(P, Q)^(ab). ``ms`` by host clock around each call, its G2 preparation
    (``prepare_g2``, pure Python, its cache cleared first) included; the
    kernels' time (K11's two launches and K20) by CUDA events."""
    import torch

    from eth_consensus_specs_tpu_torch import _ext
    from eth_consensus_specs_tpu_torch.crypto import pairing as oracle
    from eth_consensus_specs_tpu_torch.crypto.curve import g1_generator, g1_infinity, g2_generator
    from eth_consensus_specs_tpu_torch.ops import pairing_device as pd

    g, q = g1_generator(), g2_generator()
    pairs = [(g.mul(a), q.mul(b)) for a, b in GT_PAIRS] + [(g1_infinity(), q.mul(3))]
    pd.pairing_device(*pairs[0], device=dev)
    torch.cuda.synchronize(dev)
    _ext.reset_launches()
    times, values = [], []
    for p, qq in pairs:
        pd._PREP_CACHE.clear()
        t = time.perf_counter()
        values.append(pd.pairing_device(p, qq, device=dev))
        times.append((time.perf_counter() - t) * 1e3)
    launches = dict(_ext.launches)
    base = oracle.pairing(g, q)
    for (a, b), (p, qq), v in zip(GT_PAIRS, pairs, values):
        if v != oracle.pairing(p, qq) or v != base.pow(a * b):
            raise RuntimeError(f"pairing_device(e({a}P, {b}Q)) differs from the host oracle")
    if not values[-1].is_one():
        raise RuntimeError("pairing_device of a pair at infinity is not one")
    _ext.timing = []
    pd.pairing_device(*pairs[0], device=dev)
    torch.cuda.synchronize(dev)
    events = event_ms(_ext.timing)
    _ext.timing = None
    summary = dict(
        phase="gt_export", pairs=[list(ab) for ab in GT_PAIRS] + ["infinity"],
        ms_per_pairing_median=statistics.median(times[:len(GT_PAIRS)]), ms_runs=times,
        kernel_event_ms=events, kernel_event_ms_total=sum(events.values()), launches=launches,
        oracle_checked=len(pairs), bilinear_checked=len(GT_PAIRS),
    )
    return summary, launches



def _become_subreaper() -> None:
    """Make this process the reaper of its orphaned descendants (Linux
    ``PR_SET_CHILD_SUBREAPER``), so that ``_stop_children`` finds them too."""
    import ctypes

    try:
        ctypes.CDLL(None, use_errno=True).prctl(36, 1, 0, 0, 0)
    except (OSError, AttributeError):
        pass


def _child_pids() -> list[int]:
    """The pids whose parent is this process, zombies included, from /proc."""
    import os
    from pathlib import Path

    me, pids = os.getpid(), []
    for stat in Path("/proc").glob("[0-9]*/stat"):
        try:
            fields = stat.read_text().rsplit(")", 1)[1].split()
        except (OSError, IndexError):
            continue
        if int(fields[1]) == me:
            pids.append(int(stat.parent.name))
    return pids


def _stop_children(grace_s: float = 10.0) -> None:
    """Stop every process the run started that is still there: the process
    pools' workers, multiprocessing's resource tracker (it would otherwise
    outlive the script while it drains) and any orphan of theirs; a process
    that has not ended after ``grace_s`` of SIGTERM is killed. Each is named
    on stderr."""
    import os
    import signal

    if "multiprocessing" in sys.modules:
        import multiprocessing as mp

        for proc in mp.active_children():
            print(f"chip_smoke: stopping leftover worker {proc.pid}", file=sys.stderr, flush=True)
            proc.terminate()
            proc.join(grace_s)
        if "multiprocessing.resource_tracker" in sys.modules:
            from multiprocessing import resource_tracker

            tracker = resource_tracker._resource_tracker
            if getattr(tracker, "_pid", None) is not None and hasattr(tracker, "_stop"):
                print(f"chip_smoke: stopping multiprocessing's resource tracker {tracker._pid}",
                      file=sys.stderr, flush=True)
                tracker._stop()
    deadline = time.monotonic() + grace_s
    sent: set[int] = set()
    while (pids := _child_pids()) and time.monotonic() < deadline + grace_s:
        for pid in pids:
            try:
                if os.waitpid(pid, os.WNOHANG)[0]:
                    continue
                if pid not in sent:
                    cmd = open(f"/proc/{pid}/cmdline", "rb").read().replace(b"\0", b" ")
                    print(f"chip_smoke: stopping leftover process {pid}: "
                          f"{cmd.decode(errors='replace')[:200]}", file=sys.stderr, flush=True)
                    os.kill(pid, signal.SIGTERM)
                    sent.add(pid)
                elif time.monotonic() > deadline:
                    os.kill(pid, signal.SIGKILL)
                    os.waitpid(pid, 0)
            except (ChildProcessError, ProcessLookupError, FileNotFoundError):
                continue
        time.sleep(0.05)


def main() -> int:
    _become_subreaper()
    try:
        return _run()
    finally:
        _stop_children()


def _run() -> int:
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

    from concurrent.futures import ThreadPoolExecutor

    t0 = time.perf_counter()
    _ext.write_generated()  # before the thread below, which reads the headers too
    with ThreadPoolExecutor(1) as pool:  # K16's product, K4 and K9 counted beside the build
        fr_sass = pool.submit(fr_mul_sass_count)
        k4_sass = pool.submit(k4_sass_count)
        k9_sass = pool.submit(k9_sass_count)
        report = _ext.build()
        fr_sass, k4_sass, k9_sass = fr_sass.result(), k4_sass.result(), k9_sass.result()
    emit(dict(phase="build", seconds=time.perf_counter() - t0, kernels=report,
              fr_mul_sass=fr_sass, k4_sass=k4_sass, k9_sass=k9_sass))

    t0 = time.perf_counter()
    rows = (check_kernels(dev, k4_sass) + check_forest_kernels(dev)
            + check_slice3_kernels(dev, k9_sass) + check_bls_kernels(dev) + check_g2_kernels(dev)
            + check_kzg_kernels(dev, fr_sass) + check_slot_kernels(dev)
            + check_block_epoch_kernels(dev))
    emit(dict(phase="kernels_checked", kernels=[r["name"] for r in rows], nvidia_smi=smi,
              phase_s=time.perf_counter() - t0))

    by_path = {}
    for path, phase in (("state", run_main_path), ("state_inc", run_state_inc),
                        ("dirty_registry", run_dirty_registry), ("durability", run_durability),
                        ("shuffle", run_shuffle), ("epoch_phase0", run_epoch_phase0),
                        ("merkle_many", run_merkle_many), ("bls_block", run_bls_block),
                        ("agg_slot", run_agg_slot), ("kzg_flush", run_kzg_flush),
                        ("das_fft", run_das_fft), ("slot", run_slot),
                        ("block_epoch", run_block_epoch), ("gt_export", run_gt_export)):
        t0 = time.perf_counter()
        summary, by_path[path] = phase(dev)
        summary["phase_s"] = time.perf_counter() - t0
        summary["nvidia_smi"] = smi
        emit(summary)
        if path in NO_K1_PATHS and by_path[path].get("sha256"):
            raise RuntimeError(f"{path} launched K1 {by_path[path]['sha256']} times: its small "
                               "roots belong in K2's list launch")

    missing = []
    for r in rows:
        keys = _KERNEL_OF[r["name"]]
        keys = keys if isinstance(keys, tuple) else (keys,)
        paths = _PATH_OF.get(r["name"], "state_inc")
        paths = paths if isinstance(paths, tuple) else (paths,)
        r["launches_by_path"] = {path: sum(counts.get(k, 0) for k in keys)
                                 for path, counts in by_path.items()}
        r["launches"] = sum(r["launches_by_path"][path] for path in paths)
        if r["name"] in _OWN_CHECK_ONLY:
            r["launched_by"] = f"its own check alone: {_OWN_CHECK_ONLY[r['name']]}"
            continue
        # a kernel of a later path must launch on one of its own paths; K1-K6 on any
        own = paths if r["name"] in _PATH_OF else tuple(by_path)
        missing += [f"{r['name']} ({k})" for k in keys
                    if not any(by_path[path].get(k, 0) for path in own)]
    emit({"kernels": rows})
    if missing:
        raise RuntimeError(f"kernels never launched on their paths: {missing}")
    emit({"ok": True, "device": {"platform": "gpu", "kind": name,
                                  "count": torch.cuda.device_count()}})
    return 0


_KERNEL_OF = {"sha256_pairs": "sha256", "merkle_tree_root": ("merkle", "merkle_lists"),
              "validator_leaves": "validator_leaves", "altair_epoch": "altair_epoch",
              "forest_update": "forest_update", "forest_mark": "forest_mark",
              "merkle_inc": "merkle_inc", "validator_leaves_at": "validator_leaves_at",
              "sha256_single_block": "sha256_single_block", "shuffle_rounds": "shuffle",
              "phase0_epoch": "state_columns", "merkle_many_tree_root": "merkle_many",
              "g1_sum_many": "g1_sum", "miller_product": ("miller", "miller_fold"),
              "final_exp_is_one": "final_exp", "h2c_map": "h2c_map",
              "h2c_finish": "h2c_finish", "g2_sum_many": "g2_sum",
              "fr_fft": "fr_fft", "g1_msm_many": ("g1_msm", "g1_msm_fold"),
              "slot_apply": ("slot_apply", "slot_apply_scatter"), "block_slot": "block_slot",
              "final_exp_gt": "final_exp_gt"}
# the paths whose counts a kernel's row reports, where it is not state_inc
_PATH_OF = {"sha256_single_block": "shuffle", "shuffle_rounds": "shuffle",
            "phase0_epoch": "epoch_phase0", "merkle_many_tree_root": "merkle_many",
            "g1_sum_many": "bls_block", "miller_product": "bls_block",
            "final_exp_is_one": "bls_block", "h2c_map": "bls_block", "h2c_finish": "bls_block",
            "g2_sum_many": "agg_slot", "fr_fft": ("kzg_flush", "das_fft"),
            "g1_msm_many": "kzg_flush", "slot_apply": "slot", "block_slot": "block_epoch",
            "final_exp_gt": "gt_export"}
# the paths whose state roots K2 hashes alone: no launch of K1
NO_K1_PATHS = ("state", "state_inc", "dirty_registry", "durability", "slot", "block_epoch")
# kernels no path launches, each held against its plain version by its own
# check in phase 3, and why
_OWN_CHECK_ONLY = {
    "sha256_pairs": "K1, the counterpart of JAX's sha256_pair_words; K2's list launch hashes "
                    "every state root's checkpoints",
    "merkle_inc": "K5's compaction, the counterpart of JAX's dirty_indices behind the public "
                  "dirty_indices and dirty_leaves; the forest update diffs the columns itself",
    "validator_leaves_at": "K3's indexed entry, the counterpart of JAX's _validator_leaf_fn; "
                           "the forest update computes the registry's dirty leaves itself",
    "forest_mark": "path_update's mark pass; no path updates by an explicit index list",
}


if __name__ == "__main__":
    sys.exit(main())
