"""Time the incremental forest's update (``ops/merkle_inc.py``,
``ops/state_root.py`` ``_update_forest``) on every path that runs it, by CUDA
events and traced, and break its sparse update down by dirty leaf groups.

On one checkout of the port (``--root``, by default this one), at 2^20
validators: one ``state_inc`` epoch's update of the registry, balance and
score trees (the example columns against the columns one accounting epoch
makes of them), the same on ``dirty_registry``'s columns (every 256th
balance lowered, 4,096 effective balances crossing), the rebuild of every
level (``merkle_levels``) at 2^18 and 2^20 leaves, the path update of 4,072
paths at depth 20 (chip_smoke's indices: 4,000 leaves, 48 of their siblings,
24 repeats), and 8 chained ``state_inc`` epochs (ms an epoch by the host
clock, its enqueue, device busy). Where the checkout has the forest kernel,
also its sparse update of a 2^20 tree with one dirty leaf in each of 1 to
2,048 evenly spread leaf groups of 512, and in placements that tell the
first round of resident blocks from the second (the leaf rows in place, a
mask, no mark pass), beside the blocks the card holds at once. Each call
is timed by ``chip_smoke.cuda_ms`` (CUDA events around 10 calls, median of
20) and under ``chip_smoke.device_profile`` (the device time a call of every
kernel, ``per_call_ms``); each path's launches are counted by kernel and its
first root words printed, so that two checkouts can be held equal. The
measuring helpers come from this tool's own checkout, whatever ``--root``
is. Run it on an unpacked parent commit and on this tree in turns, in one
call on one card, to compare them.

Needs a card; prints one JSON line (and writes it to ``--out``):

    python3 tools/forest_times.py [--root DIR] [--out FILE]
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import statistics
import sys
import time
from pathlib import Path

N = 1 << 20  # validators
EPOCHS = 8
RUNS = 5
CALLS = 10  # calls a traced window
# one dirty leaf in each of these leaf groups of a 2^20 tree (2,048 groups of 512): evenly
# spread counts, and placements that tell the first round of resident blocks from the second
SPARSE_GROUPS = {
    **{str(g): list(range(0, 2048, 2048 // g)) for g in (1, 16, 128, 512, 1024, 2048)},
    "1_last": [2047], "2_ends": [0, 2047], "4_one_a_climb_group": [0, 512, 1024, 1536],
    "16_first_round": list(range(0, 1024, 64)), "16_adjacent": list(range(16)),
}
BLOCKS_PER_SM = 8  # csrc/forest_update.cu kBlocksPerSm


def _chip_smoke():
    """chip_smoke.py of this tool's checkout, for its measuring helpers."""
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("forest_times_chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


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
    cs = _chip_smoke()

    from eth_consensus_specs_tpu_torch import _ext
    from eth_consensus_specs_tpu_torch.config import epoch_params
    from eth_consensus_specs_tpu_torch.inputs import example_altair_inputs, lower_balances
    from eth_consensus_specs_tpu_torch.ops import altair_epoch, merkle_inc, state_root
    from eth_consensus_specs_tpu_torch.parallel.resident import build_state_forest_device, run_epochs

    if not merkle_inc.__file__.startswith(str(Path(args.root).resolve())):
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

    def words(t):
        return [int(x) & 0xFFFFFFFF for x in t.reshape(-1)[:8].cpu()]

    def row(fn, root):
        busy, by = traced(fn)
        return dict(ms=cs.cuda_ms(fn, inner=CALLS), traced_ms=busy, traced_by_kernel=by,
                    launches=launches(fn), root=words(root()))

    out = {"root": str(Path(args.root).resolve())}
    params = epoch_params("deneb", "mainnet")
    static = state_root.synthetic_static(N, seed=0, device=dev)
    arrays, meta = static
    base, just = example_altair_inputs(N, device=dev)
    for label, cols in (("state_inc_epoch", base), ("dirty_registry_epoch",
                                                    lower_balances(base, every=256))):
        forest, plan = build_state_forest_device(static, cols, device=dev)
        new = altair_epoch.altair_epoch_accounting(params, cols, just)
        old = (cols.balance, cols.effective_balance, cols.inactivity_scores)
        upd = lambda: state_root._update_forest(  # noqa: E731
            state_root.KERNELS, arrays, meta, plan, forest, *old, new.balance,
            new.effective_balance, new.inactivity_scores)
        counts = [int(c) for c in upd()]
        out[label] = dict(row(upd, lambda: torch.stack([forest.val_nodes[0, -1],
                                                        forest.bal_nodes[0, -1],
                                                        forest.inact_nodes[0, -1]])),
                          dirty=counts)
        del forest

    gen = torch.Generator().manual_seed(11)
    for d in (18, 20):
        leaves = torch.randint(-(1 << 31), 1 << 31, (1 << d, 8), generator=gen, dtype=torch.int64)
        nodes = merkle_inc.build_levels(leaves.to(torch.int32).to(dev))
        out[f"merkle_levels_2^{d}"] = row(lambda: merkle_inc.merkle_levels(nodes),  # noqa: B023
                                          lambda: nodes[-1])  # noqa: B023
    depth = 20
    uniq = torch.randperm(1 << depth, generator=gen)[:4000]
    idx = torch.cat([uniq, uniq[:48] ^ 1, uniq[:24], torch.zeros(24, dtype=torch.int64)])
    idx = idx.to(torch.int32).to(dev)
    new_leaves = torch.randint(-(1 << 31), 1 << 31, (1 << depth, 8), generator=gen,
                               dtype=torch.int64).to(torch.int32).to(dev)
    vals = new_leaves[idx.to(torch.int64)]
    count = torch.tensor([4072], dtype=torch.int32, device=dev)
    path = lambda: merkle_inc.path_update(nodes, idx, vals, count, 4096)  # noqa: E731
    out["path_update_4072_depth20"] = row(path, lambda: nodes[-1])

    if hasattr(merkle_inc, "forest_update"):
        # one dirty leaf in each of g evenly spread leaf groups of a 2^20 tree
        sms = torch.cuda.get_device_properties(dev).multi_processor_count
        groups = 1 << (depth - 9)
        sparse = {}
        for name, dirty in SPARSE_GROUPS.items():
            mask = torch.zeros(1 << depth, dtype=torch.uint8, device=dev)
            mask[torch.tensor(dirty, device=dev) * 512 + 7] = 1
            tree = merkle_inc.ForestTree(nodes, "mask", mask=mask)
            upd = lambda: merkle_inc.forest_update([tree])  # noqa: E731, B023
            sparse[name] = dict(row(upd, lambda: nodes[-1]), dirty_groups=len(dirty),
                                blocks=groups, resident_blocks=BLOCKS_PER_SM * sms,
                                past_first_round=sum(g >= BLOCKS_PER_SM * sms for g in dirty))
        out["sparse_by_dirty_groups_2^20"] = sparse

    forest, plan = build_state_forest_device(static, base, device=dev)
    carry = run_epochs(params, base, just, 1, with_root="state_inc", static=static, device=dev,
                       forest=forest)
    torch.cuda.synchronize()
    times, enqueue = [], []
    for _ in range(RUNS):
        t0 = time.perf_counter()
        carry = run_epochs(params, carry.cols, carry.just, EPOCHS, with_root="state_inc",
                           static=static, device=dev, forest=carry.forest)
        enqueue.append((time.perf_counter() - t0) * 1e3 / EPOCHS)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3 / EPOCHS)
    chained = lambda: run_epochs(params, carry.cols, carry.just, EPOCHS,  # noqa: E731
                                 with_root="state_inc", static=static, device=dev,
                                 forest=carry.forest)
    busy, by = traced(chained, calls=1)
    out["state_inc_8_epochs"] = dict(
        ms_per_epoch=statistics.median(times), runs=times,
        host_enqueue_ms_per_epoch=statistics.median(enqueue), busy_ms_per_epoch=busy / EPOCHS,
        busy_by_kernel_per_epoch={k: v / EPOCHS for k, v in by.items()},
        launches_per_epoch={k: v / EPOCHS for k, v in launches(chained).items()},
        root_acc=words(carry.root_acc))
    line = json.dumps(out)
    print(line)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
