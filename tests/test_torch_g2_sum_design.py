"""The design of K15 (``csrc/g2_sum.cu``) held on host ints, cheaply.

The JAX butterfly leaves the adjacent-pair tree in lane 0, whose subtrees
are contiguous blocks of lanes; K15 cuts an item's tree into passes
(``g2_aggregate.sum_plan``): one-thread lanes passes over the complete add
of ``ops/g2_jacobian`` (``g2_jac.cuh``'s formulas), then warp passes over
the round engine's G2 complete add (``fq12_coop.simulate_add``: ``add_a``,
the cases read, ``add_b``), each block's partial left canonical
(``g2_canon``). ``_k15`` runs those passes here as the kernels do; at 64
lanes, with the plan's thresholds lowered so that a lanes pass and two warp
passes run, on lanes at infinity and on block sums that meet across a pass
boundary as P + P and P + (-P), its words must equal the plain version's
(``g2_sum_many_ref``, which ``tests/test_torch_g2_aggregate.py`` holds to
the JAX ``g2_sum_many_kernel``'s words) and its points the JAX host fold's.
``sum_plan``'s passes are checked for every L = 1 ... 2^15, and the kernel
takes the plan's depths from the header the build generates.
"""

from pathlib import Path

import pytest
import torch

from eth_consensus_specs_tpu.crypto import curve as jc
from eth_consensus_specs_tpu.crypto import signature as jsig
from eth_consensus_specs_tpu_torch import _ext
from eth_consensus_specs_tpu_torch.crypto import curve as pc
from eth_consensus_specs_tpu_torch.ops import field_limbs as fl
from eth_consensus_specs_tpu_torch.ops import fq12_coop as coop
from eth_consensus_specs_tpu_torch.ops import g2_aggregate as ga
from eth_consensus_specs_tpu_torch.ops import g2_jacobian as gj

CSRC = Path(__file__).resolve().parents[1] / "eth_consensus_specs_tpu_torch" / "csrc"
A0, B0, W0 = 1000, 2000, 3000


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _warp_add(p: list, q: list) -> list:
    """p + q on the round engine as a warp pass runs it: in place over p."""
    mem = {i: v for i, (_, v) in enumerate(coop.G2.consts)}
    mem.update({A0 + k: v for k, v in enumerate(p)})
    mem.update({B0 + k: v for k, v in enumerate(q)})
    coop.simulate_add(coop.G2, 1, mem, {coop.X: A0, coop.Y: B0, coop.Z: W0, coop.O: A0, coop.S: 0})
    coop.simulate(coop.G2.programs["g2_canon"], mem,
                  {coop.X: A0, coop.Y: 0, coop.Z: 0, coop.O: A0, coop.S: 0})
    return [mem[A0 + k] for k in range(6)]


def _k15(X, Y, Z) -> list:
    """K15's passes on int32 [I, L, 2, 12] card words -> per item the sum's
    six card-Montgomery ints (X.c0, X.c1, Y.c0, ...)."""
    items, lanes = X.shape[:2]
    vals = tuple(fl.from_card_words(a) for a in (X, Y, Z))
    pts = None
    for kind, r in ga.sum_plan(items, lanes):
        if kind == "thread":  # one thread an add: pairs (2k, 2k + 1), level by level
            assert pts is None, "lanes passes come first"
            for _ in range(r):
                vals = gj.g2_add(tuple(v[:, 0::2] for v in vals), tuple(v[:, 1::2] for v in vals))
            continue
        if pts is None:
            ints = [fl.words_to_ints(fl.to_card_words(v)) for v in vals]  # [I][n][2] each
            pts = [[[c for coord in ints for c in coord[i][j]] for j in range(len(ints[0][i]))]
                   for i in range(items)]
        for _ in range(r):  # a level: warp 2ks takes warp 2ks + s, within each block
            pts = [[_warp_add(item[2 * k], item[2 * k + 1]) for k in range(len(item) // 2)]
                   for item in pts]
    assert all(len(item) == 1 for item in pts)
    return [item[0] for item in pts]


def _ref_ints(X, Y, Z) -> list:
    ref = ga.g2_sum_many_ref(X, Y, Z)
    return [[c for coord in item for c in coord] for item in fl.words_to_ints(ref)]


def _lists(lanes: int) -> list:
    """Three items of ``lanes`` lanes in blocks of 8: in item 0 blocks 0 and 1
    hold the same points (their sums meet as P + P), block 3 the negatives
    of block 2's (P + (-P)), block 4 only infinity, every other lane of
    block 5 at infinity, lanes 48 and 49 equal; item 1 ragged with infinity
    lanes; item 2 all at infinity."""
    g, inf = pc.g2_generator(), pc.g2_infinity()
    cache = {}

    def pt(k):
        if k not in cache:
            cache[k] = g.mul(k)
        return cache[k]

    first = [pt(k) for k in range(3, 11)]
    item0 = first + first + [pt(k) for k in range(11, 19)]
    item0 += [-p for p in item0[16:24]] + [inf] * 8
    item0 += [pt(k) if k % 2 else inf for k in range(19, 27)]
    item0 += [pt(5), pt(5)] + [pt(k) for k in range(27, 41)]
    item1 = [inf if k % 3 == 0 else pt(k % 40 + 1) for k in range(lanes - 9)]
    return [item0[:lanes], item1, [inf] * lanes]


def test_k15_passes_on_host_ints_equal_the_plain_tree(monkeypatch):
    monkeypatch.setattr(ga, "SUM_THREAD_ADDS", 16)
    monkeypatch.setattr(ga, "SUM_FOLD_LEVELS", 2)
    lanes = 64
    assert ga.sum_plan(3, lanes) == [("thread", 3), ("warp", 1), ("warp", 2)]
    lists = _lists(lanes)
    X, Y, Z = (torch.from_numpy(a) for a in ga._points_to_lanes(lists, 3, lanes))
    got = _k15(X, Y, Z)
    assert got == _ref_ints(X, Y, Z)
    words = torch.from_numpy(fl.ints_to_words([[[p[0], p[1]], [p[2], p[3]], [p[4], p[5]]]
                                               for p in got]))
    host = [jc.g2_to_bytes(jsig._sum_g2([jc.g2_from_bytes(pc.g2_to_bytes(p)) for p in pts]))
            for pts in lists]
    assert [pc.g2_to_bytes(s) for s in ga.sums_to_points(words)] == host
    assert ga.sums_to_points(words)[2].is_infinity()


def test_k15_warp_passes_alone_and_one_lane():
    """The shipped plan at 32 lanes is warp passes alone; one lane a copy."""
    lists = [p[:32] for p in _lists(64)[:2]]
    X, Y, Z = (torch.from_numpy(a) for a in ga._points_to_lanes(lists, 2, 32))
    assert {k for k, _ in ga.sum_plan(2, 32)} == {"warp"}
    assert _k15(X, Y, Z) == _ref_ints(X, Y, Z)
    one = [[pc.g2_generator().mul(3)], [pc.g2_infinity()]]
    X, Y, Z = (torch.from_numpy(a) for a in ga._points_to_lanes(one, 2, 1))
    assert ga.sum_plan(2, 1) == [("warp", 0)]
    assert _k15(X, Y, Z) == _ref_ints(X, Y, Z)


@pytest.mark.parametrize("items", [1, 2, 64, 128])
def test_k15_sum_plan_levels(items):
    for k in range(16):
        plan = ga.sum_plan(items, 1 << k)
        kinds = [kind for kind, _ in plan]
        assert sum(r for _, r in plan) == k
        assert kinds == sorted(kinds, key=lambda x: x != "thread") and kinds[-1] == "warp"
        assert all(1 <= r <= ga.SUM_PASS_LEVELS for kind, r in plan if kind == "thread")
        assert all(r <= ga.SUM_FOLD_LEVELS for kind, r in plan if kind == "warp")
        assert all(r >= 1 for _, r in plan) or plan == [("warp", 0)]
        warps = [r for kind, r in plan if kind == "warp"]
        assert max(warps) - min(warps) <= 1 and warps == sorted(warps)
        for t, (kind, r) in enumerate(plan):  # a lanes pass only where its levels have many adds
            if kind == "thread":
                done = sum(x for _, x in plan[:t])
                assert items * (1 << k) >> (done + r) >= ga.SUM_THREAD_ADDS


def test_k15_plan_at_the_cells_shapes_and_its_header():
    assert ga.sum_plan(1, 1) == ga.sum_plan(64, 1) == [("warp", 0)]
    assert ga.sum_plan(2, 32) == [("warp", 2), ("warp", 3)]
    assert ga.sum_plan(1, 512) == [("warp", 3)] * 3
    assert ga.sum_plan(64, 512) == [("thread", 3), ("warp", 3), ("warp", 3)]
    header = _ext.generated()["g2_sum_plan.cuh"]
    assert header == ga.sum_plan_header()
    assert f"kPassLevels = {ga.SUM_PASS_LEVELS};" in header
    assert f"kFoldLevels = {ga.SUM_FOLD_LEVELS};" in header
    text = (CSRC / "g2_sum.cu").read_text()
    assert '#include "g2_sum_plan.cuh"' in text
    assert "kPassLevels =" not in text and "kFoldLevels =" not in text
