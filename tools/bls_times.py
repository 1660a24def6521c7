"""Time the port's BLS kernels on the card at ``chip_smoke.py``'s shapes.

Each kernel is launched on fixed inputs made from seeds (warm-up first),
then ``REPEATS`` launches back to back between two CUDA events; the line
gives milliseconds a launch. Kernels: K10 ``sum_many`` at [128, 512],
[64, 512], [1, 512], [8, 32768], [1, 32] and [128, 32] (the fold alone);
K13 ``h2c_map`` and K14 ``h2c_finish`` at 128 messages (and K13's square
root alone on 256 values, its two powers); K11 ``miller_product`` at 129
pairs; K12 ``final_exp_is_one``; K15 ``g2_sum_many`` at ``agg_slot``'s
tier shapes [1, 512], [64, 1], [2, 32] and at [64, 512]; K17
``msm_many`` at [2, 129]; K20 ``final_exponentiation`` of one Miller
value. ``--root`` imports the port from another checkout (for example an
unpacked parent commit), so that two versions can be timed in one call on
one card, in turns.

Needs a card; prints one JSON line with the card's name:

    python3 tools/bls_times.py [--root DIR]
"""

from __future__ import annotations

import argparse
import json
import random
import sys
from pathlib import Path

REPEATS = 10


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=str(Path(__file__).resolve().parents[1]))
    args = ap.parse_args()
    sys.path.insert(0, args.root)
    import torch

    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 1
    from eth_consensus_specs_tpu_torch.crypto.curve import g2_generator
    from eth_consensus_specs_tpu_torch.crypto.fields import R, Fq2
    from eth_consensus_specs_tpu_torch.inputs import block_message, g1_keys, point_multiples
    from eth_consensus_specs_tpu_torch.ops import field_limbs as fl
    from eth_consensus_specs_tpu_torch.ops import g1_msm
    from eth_consensus_specs_tpu_torch.ops import g2_aggregate as ga
    from eth_consensus_specs_tpu_torch.ops import h2c_device as hd
    from eth_consensus_specs_tpu_torch.ops import pairing_device as pd

    dev = torch.device("cuda")

    def ms(fn) -> float:
        fn()
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(REPEATS):
            fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / REPEATS

    out = {"root": args.root, "device": torch.cuda.get_device_name(0), "repeats": REPEATS}
    keys = g1_keys(4096)
    k10 = {}
    for items, lanes in ((128, 512), (64, 512), (1, 512), (8, 32768), (1, 32), (128, 32)):
        lists = [[keys[(i * lanes + j) % len(keys)] for j in range(lanes)] for i in range(items)]
        X, Y, Z = (torch.from_numpy(a).to(dev) for a in g1_msm.pack_lanes(lists))
        k10[f"{items}x{lanes}"] = ms(lambda: g1_msm.sum_many(X, Y, Z))
    out["k10_sum_many"] = k10
    msgs = [block_message(100, i) for i in range(128)]
    u = torch.from_numpy(fl.ints_to_words(hd.field_elements(msgs))).to(dev)
    out["k13_h2c_map"] = ms(lambda: hd.h2c_map(u))
    # K13's square root alone (its test entry: the norm power, then the h
    # power) on the 256 elements' g(x1) norms' worth of values, 32 a block
    # as K13 runs them: K13's two powers without the rest of the map
    squares = [Fq2.from_ints(7 * i + 3, 11 * i + 5).square() for i in range(256)]
    v = torch.from_numpy(fl.ints_to_words([[c.c0.n, c.c1.n] for c in squares])).to(dev)
    out["k13_fq2_sqrt_256"] = ms(lambda: hd.fq2_sqrt(v))
    jac = hd.h2c_map(u)
    out["k14_h2c_finish"] = ms(lambda: hd.h2c_finish(jac))
    qs = hd.hash_to_g2_device(msgs, device=dev)
    pairs = [(keys[i], qs[i]) for i in range(128)] + [(-keys[0], qs[0])]
    a = [torch.from_numpy(x).to(dev) for x in pd.pack_pairs(pairs)]
    out["k11_miller_product"] = ms(lambda: pd.miller_product(*a))
    f = pd.miller_product(*a)
    out["k12_final_exp_is_one"] = ms(lambda: pd.final_exp_is_one(f))
    out["k20_final_exponentiation"] = ms(lambda: pd.final_exponentiation(f))
    g2 = point_multiples(g2_generator(), 1, 64 * 512)
    for items, lanes in ((1, 512), (64, 1), (2, 32), (64, 512)):
        lists = [g2[i * lanes:(i + 1) * lanes] for i in range(items)]
        X, Y, Z = (torch.from_numpy(x).to(dev) for x in ga._points_to_lanes(lists, items, lanes))
        out[f"k15_g2_sum_many_{items}x{lanes}"] = ms(lambda: ga.g2_sum_many(X, Y, Z))
    rnd = random.Random(7)
    lists = [keys[:129], keys[129:258]]
    K, X, Y, Z = (torch.from_numpy(x).to(dev) for x in g1_msm.pack_msm(
        lists, [[rnd.randrange(R) for _ in p] for p in lists]))
    out["k17_msm_many_2x129"] = ms(lambda: g1_msm.msm_many(K, X, Y, Z))
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
