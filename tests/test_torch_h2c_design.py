"""The designs of K13 (``csrc/h2c.cu`` ``h2c_map``) and K10
(``csrc/g1_sum.cu``) held on host ints and the plain versions, cheaply.

K13: ``ops.h2c_device.map_steps`` runs the kernel's step order (the tv2
inverse from the warp's batch inverse of the norms, one binary GCD a warp
(``warp_inverse``), one norm power of g(x1) that also decides
the candidate, g(x2)'s norm root by products with a constant, one h power,
both powers in 4-bit windows) and must give the JAX host
``map_to_curve_sswu_g2``'s (x, y) on seeded u and the corner rows, with
square and non-square g(x1) among them; the kernel's new constants are
recomputed from the field's definition; the GCD and the windowed powers are
held against Python's ``pow``.

K10: the JAX tree pairs lane j with j + n/2, so the lanes of one residue
class mod B form a halving subtree; the classes' sums, then the halving
tree over them, must give the whole tree's Jacobian words
(``sum_many_ref``), for B in {2, 8, 32} and for the kernel's own plan of
passes (``g1_msm.sum_plan``), with lanes at infinity, P + P and P + (-P).
"""

import random
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from eth_consensus_specs_tpu.crypto import hash_to_curve as jh2c
from eth_consensus_specs_tpu.crypto.fields import P, Fq, Fq2
from eth_consensus_specs_tpu_torch import _ext
from eth_consensus_specs_tpu_torch.crypto.curve import g1_generator, g1_infinity
from eth_consensus_specs_tpu_torch.ops import fq12_coop
from eth_consensus_specs_tpu_torch.ops import g1_msm
from eth_consensus_specs_tpu_torch.ops import h2c_device as hd

CSRC = Path(__file__).resolve().parents[1] / "eth_consensus_specs_tpu_torch" / "csrc"
R = 1 << 384


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _g_x1_square(u: Fq2) -> bool:
    A, B, Z = jh2c.A_PRIME, jh2c.B_PRIME, jh2c.Z_SSWU
    tv1 = Z * u.square()
    tv2 = tv1.square() + tv1
    if tv2.is_zero():
        return True
    x1 = (-B) * A.inv() * (Fq2.one() + tv2.inv())
    return ((x1.square() + A) * x1 + B).sqrt() is not None


# u = 0 (tv2 = 0), three u with c1 = 0, then seeded u
_RNG = random.Random(11)
U_ROWS = [[0, 0], [3, 0], [P - 1, 0], [12345, 0]] + [
    [_RNG.randrange(P), _RNG.randrange(P)] for _ in range(24)]


def test_k13_steps_equal_the_jax_host_map():
    """One warp's elements (28 of 32 lanes), their tv2 inverses from the
    warp's one batch inverse, then each element's map."""
    kinds = [_g_x1_square(Fq2(Fq(a), Fq(b))) for a, b in U_ROWS]
    assert any(kinds) and not all(kinds)  # both candidates taken
    inverses, steps = hd.warp_inverse([hd.tv2_norm(u) for u in U_ROWS])
    assert 0 < steps < 3 * 381  # halvings and subtractions, as K14 counts them
    for u, ninv in zip(U_ROWS, inverses):
        x, y, _ = hd.map_steps(u, ninv)
        wx, wy = jh2c.map_to_curve_sswu_g2(Fq2(Fq(u[0]), Fq(u[1])))
        assert (list(x), list(y)) == ([wx.c0.n, wx.c1.n], [wy.c0.n, wy.c1.n]), u


def test_k13_warp_inverse_equals_fermat():
    rng = random.Random(8)
    for count in (1, 7, 32):
        norms = [rng.randrange(1, P) for _ in range(count)]
        norms[0] = 1  # a lane with tv2 = 0 holds 1
        inverses, _ = hd.warp_inverse(norms)
        assert inverses == [pow(n, P - 2, P) for n in norms]


def test_k13_counts_one_power_pair_on_both_candidates():
    counts = {_g_x1_square(Fq2(Fq(a), Fq(b))): hd.map_steps([a, b])[2] for a, b in U_ROWS[4:]}
    # the second candidate adds products, never a power
    assert 0 < counts[False] - counts[True] < 30
    e = (P + 1) // 4
    one_power = 14 + 4 * ((e.bit_length() - 1) // 4)
    assert 2 * one_power < counts[True] < 2 * one_power + 250


def _header_words(name: str) -> list[int]:
    text = (CSRC / "h2c.cu").read_text()
    m = re.search(name + r"\[[^=]*=\s*(\{.*?\});", text, re.S)
    return [int(v, 16) for v in re.findall(r"0x([0-9a-f]+)u", m.group(1))]


def _words(x: int) -> list[int]:
    return [(x >> (32 * i)) & 0xFFFFFFFF for i in range(12)]


def test_k13_constants_from_the_field():
    Z = jh2c.Z_SSWU
    n_z = (Z.c0.n ** 2 + Z.c1.n ** 2) % P
    c = hd.SSWU_NORM_C * pow(n_z, P - 2, P) % P
    assert c * c % P == (-n_z) % P  # c = sqrt(-N(Z))
    assert hd.SSWU_NORM_C == n_z * pow(P - n_z, (P + 1) // 4, P) % P
    assert _header_words("SSWU_NORM_C") == _words(hd.SSWU_NORM_C * R % P)
    assert _header_words("FP_R3") == _words(R ** 3 % P)


def test_k13_gcd_inverse_equals_fermat():
    rng = random.Random(5)
    vals = [1, 2, P - 1, P + 1, R - 1, (1 << 383) + 7] + [rng.randrange(P) for _ in range(20)]
    vals += [rng.randrange(P, R) for _ in range(4)]  # words past p, as the GCD takes them
    for a in vals:
        assert fq12_coop.gcd_inverse(a)[0] == pow(a % P, P - 2, P), a
    assert fq12_coop.gcd_inverse(0)[0] == 0 and fq12_coop.gcd_inverse(P)[0] == 0


@pytest.mark.parametrize("e", [(P + 1) // 4, (P - 3) // 4])
def test_k13_windowed_powers(e):
    rng = random.Random(e & 0xFFFF)
    for x in [0, 1, P - 1] + [rng.randrange(P) for _ in range(6)]:
        st = hd._Steps()
        assert st.pow(x, e) == pow(x, e, P)
        windows = (e.bit_length() - 1) // 4
        nonzero = sum(1 for w in range(windows) if (e >> (4 * w)) & 15)
        assert st.products == 14 + 4 * windows + nonzero


def test_k13_root_of_values_in_fq_and_zero():
    """b = 0: h = (a + sn)/2 may be 0 (sn = -a), and the root function then
    takes (a - sn)/2 = a; a square and a non-square a, both signs of sn."""
    for a in (11 * 11, P - 169, 5, P - 5, 0):
        v = (a, 0)
        n = a * a % P
        s = pow(n, (P + 1) // 4, P)
        for sn in (s, (P - s) % P):
            r = hd._Steps().root_from_norm(v, sn)
            assert ((r[0] * r[0] - r[1] * r[1]) % P, 2 * r[0] * r[1] % P) == v


# ------------------------------------------------------------------ K10 --

def _lanes(items: int, lanes: int):
    """[items, lanes] signed multiples of G (0: infinity) with P + P and
    P + (-P) at the first level and in upper levels, every other lane at
    infinity in one item."""
    rng = random.Random(items * 1000 + lanes)
    sc = [[rng.randrange(1, 50) for _ in range(lanes)] for _ in range(items)]
    sc[0][1] = sc[0][1 + lanes // 2] = 7  # P + P at level 1
    sc[0][2], sc[0][2 + lanes // 2] = 9, -9  # P + (-P) at level 1
    sc[1][::2] = [0] * (lanes // 2)
    sc[1][3] = sc[1][3 + lanes // 4] = 5  # meet at level 2
    sc[1][5], sc[1][5 + lanes // 8] = 6, -6  # meet at level 3
    g = g1_generator()
    cache = {0: g1_infinity()}
    for row in sc:
        for k in row:
            if k not in cache:
                cache[k] = g.mul(k) if k > 0 else -g.mul(-k)
    pts = [[cache[k] for k in row] for row in sc]
    X, Y, Z = (torch.from_numpy(a) for a in g1_msm.pack_lanes(pts, lanes))
    return X, Y, Z, [g.mul(sum(row)) if sum(row) else g1_infinity() for row in sc]


def _class_sums(X, Y, Z, classes: int):
    """Partial c of each item: the halving tree over lanes c, c + classes, ..."""
    parts = [g1_msm.sum_many_ref(X[:, c::classes].contiguous(), Y[:, c::classes].contiguous(),
                                 Z[:, c::classes].contiguous()) for c in range(classes)]
    return tuple(torch.stack([p[:, i] for p in parts], dim=1) for i in range(3))


@pytest.mark.parametrize("classes", [2, 8, 32])
def test_k10_split_identity(classes):
    X, Y, Z, _ = _lanes(2, 64)
    whole = g1_msm.sum_many_ref(X, Y, Z)
    assert torch.equal(g1_msm.sum_many_ref(*_class_sums(X, Y, Z, classes)), whole)


@pytest.mark.parametrize("lanes", [16, 64, 256])
def test_k10_plan_of_passes_gives_the_whole_tree(lanes):
    """The kernel's passes (sum_plan) then its fold, on the plain twin."""
    X, Y, Z, host = _lanes(2, lanes)
    whole = g1_msm.sum_many_ref(X, Y, Z)
    assert g1_msm.sums_to_points(whole) == host
    n = lanes
    for r in g1_msm.sum_plan(lanes):
        X, Y, Z = _class_sums(X, Y, Z, n >> r)
        n >>= r
    assert n <= g1_msm.SUM_FOLD_PARTIALS
    assert torch.equal(g1_msm.sum_many_ref(X, Y, Z), whole)


def test_k10_sum_plan():
    assert [g1_msm.sum_plan(1 << k) for k in (0, 1, 5, 6, 9, 13, 14, 15)] == [
        [], [], [], [1], [4], [8], [8, 1], [8, 2]]
    assert g1_msm.SUM_FOLD_PARTIALS == 32 and g1_msm.SUM_PASS_LEVELS == 8
    # the kernel takes the plan from the header the build generates, and
    # defines neither constant itself
    header = _ext.generated()["g1_sum_plan.cuh"]
    assert "kFoldPartials = 32;" in header and "kPassLevels = 8;" in header
    text = (CSRC / "g1_sum.cu").read_text()
    assert '#include "g1_sum_plan.cuh"' in text
    assert "kFoldPartials =" not in text and "kPassLevels =" not in text
    assert np.all(np.diff([len(g1_msm.sum_plan(1 << k)) for k in range(22)]) >= 0)
