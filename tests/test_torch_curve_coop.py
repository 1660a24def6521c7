"""The curve families of the cooperative round engine (``ops/fq12_coop.py``
G1 and G2, the programs K17 and K14 run through ``csrc/curve_coop.cuh``)
without a card.

Each program runs on host ints exactly as the card runs it
(``fq12_coop.simulate``; a complete add as the kernels drive it, its case
decided between its two programs: ``simulate_add``), from points made from
a seed, and is held word for word against the plain versions (``ops/g1_msm``
``_dbl`` and ``_add``, ``ops/g2_jacobian``) and the JAX package's host
curve: every add case (an infinite operand either side, both, P + P,
P + (-P)), in place and apart, the G1 table's adds side by side, phi, psi,
the G2 affine step with its GCD inverse taken between its two programs as
K14 takes it (``simulate_g2_affine``), at zero and at random values. Then
K17's and K14's whole sequences of programs (the kernels' steps, run here
on the programs) against their plain twins ``msm_many_ref`` and
``h2c_finish_ref``, and the binary-GCD inverse's plain twin against
Fermat's.
"""

import numpy as np
import pytest
import torch

from eth_consensus_specs_tpu.crypto import curve as jc
from eth_consensus_specs_tpu_torch.crypto.curve import g1_generator, g2_generator
from eth_consensus_specs_tpu_torch.crypto.fields import P
from eth_consensus_specs_tpu_torch.inputs import g1_keys
from eth_consensus_specs_tpu_torch.ops import field_limbs as fl
from eth_consensus_specs_tpu_torch.ops import fq12_coop as coop
from eth_consensus_specs_tpu_torch.ops import g1_msm
from eth_consensus_specs_tpu_torch.ops import g2_jacobian as gj
from eth_consensus_specs_tpu_torch.ops import h2c_device as hd

RC = coop.R_CARD
X0, Y0, Z0, O0 = 1000, 2000, 3000, 4000
BASES = {coop.X: X0, coop.Y: Y0, coop.Z: Z0, coop.O: O0, coop.S: 0}


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rand(seed: int, n: int) -> list:
    rng = np.random.default_rng(seed)
    return [int.from_bytes(rng.bytes(48), "little") % P or 1 for _ in range(n)]


def _card(v: int) -> int:
    return v * RC % P


def _g1_jac(pt, z: int) -> list:
    """A G1 point's Jacobian card-Montgomery ints (X, Y, Z) at Z = z."""
    x, y = pt.x.n, pt.y.n
    return [_card(x * z * z), _card(y * z * z * z), _card(z)]


def _g2_jac(pt, z: tuple) -> list:
    """A G2 point's Jacobian card-Montgomery ints (X.c0, X.c1, ...) at Z = z."""
    zz = pt.x.__class__.from_ints(*z)
    x, y = pt.x * zz.square(), pt.y * zz.square() * zz
    return [_card(c) for e in (x, y, zz) for c in (e.c0.n, e.c1.n)]


def _mem(fam, regions: dict) -> dict:
    mem = {i: v for i, (_, v) in enumerate(fam.consts)}
    for base, vals in regions.items():
        for k, v in enumerate(vals):
            mem[base + k] = v
    return mem


def _limbs(vals):
    """Card-Montgomery ints (nested) -> the plain versions' limbs."""
    return fl.from_card_words(torch.from_numpy(fl.ints_to_words(vals)))


def _out(limbs) -> list:
    return fl.words_to_ints(fl.to_card_words(limbs))


def _g1_plain(fn, *pts) -> list:
    return [_out(c)[0] for c in fn(*(_limbs([v]) for pt in pts for v in pt))]


def _g2_plain(fn, *pts) -> list:
    args = [tuple(_limbs([[pt[2 * i], pt[2 * i + 1]]]) for i in range(3)) for pt in pts]
    return [v for c in fn(*args) for v in _out(c)[0]]


def _g1_points():
    keys = g1_keys(8)
    z = _rand(1, 8)
    return [_g1_jac(k, zk) for k, zk in zip(keys, z)]


def _g2_points():
    g = g2_generator()
    z = _rand(2, 8)
    return [_g2_jac(g.mul(3 + 5 * i), (z[i], z[7 - i])) for i in range(4)]


def _neg(fam, pt):
    n = 1 if fam is coop.G1 else 2
    return [(P - v) % P if n <= k < 2 * n else v for k, v in enumerate(pt)]


def _cases(fam, pts):
    """(label, P1, P2) of every add case."""
    inf = [0] * (3 if fam is coop.G1 else 6)
    other_inf = [5] * (2 if fam is coop.G1 else 4) + [0] * (1 if fam is coop.G1 else 2)
    if fam is coop.G1:  # the first point at another Z
        same = _g1_jac(g1_keys(1)[0], _rand(3, 1)[0])
    else:
        same = _g2_jac(g2_generator().mul(3), (_rand(3, 1)[0], 7))
    return [("generic", pts[0], pts[1]), ("generic2", pts[2], pts[3]),
            ("inf_first", inf, pts[1]), ("inf_second", pts[0], inf),
            ("both_inf", other_inf, inf), ("both_inf2", inf, other_inf),
            ("double", pts[0], same), ("opposite", pts[0], _neg(fam, pts[0]))]


FAMILIES = [(coop.G1, g1_msm._add, g1_msm._dbl, _g1_plain, _g1_points),
            (coop.G2, gj.g2_add, gj.g2_dbl, _g2_plain, _g2_points)]


@pytest.mark.parametrize("fam,add,dbl,plain,points", FAMILIES, ids=["g1", "g2"])
def test_doublings_equal_the_plain_formula(fam, add, dbl, plain, points):
    pts = points()
    for pt in pts[:2] + [[0] * len(pts[0])]:
        for in_place in (False, True):
            bases = {**BASES, coop.O: X0 if in_place else O0}
            mem = _mem(fam, {X0: pt})
            coop.simulate(fam.programs[f"{fam.name}_dbl1"], mem, bases)
            want = plain(dbl, pt)
            assert [mem[bases[coop.O] + k] for k in range(len(pt))] == want
            mem = _mem(fam, {X0: pt})
            coop.simulate(fam.programs[f"{fam.name}_dbl4"], mem, bases)
            for _ in range(3):
                want = plain(dbl, want)
            assert [mem[bases[coop.O] + k] for k in range(len(pt))] == want


@pytest.mark.parametrize("in_place", [False, True])
@pytest.mark.parametrize("fam,add,dbl,plain,points", FAMILIES, ids=["g1", "g2"])
def test_every_add_case_equals_the_plain_formula(fam, add, dbl, plain, points, in_place):
    seen = set()
    for label, p1, p2 in _cases(fam, points()):
        bases = {**BASES, coop.O: X0 if in_place else O0}
        mem = _mem(fam, {X0: p1, Y0: p2})
        cases = coop.simulate_add(fam, 1, mem, bases)
        seen.add(cases[0])
        assert [mem[bases[coop.O] + k] for k in range(len(p1))] == plain(add, p1, p2), label
    assert seen == {None, "copy_x", "copy_y", "dbl"}


def test_g1_add_and_dbl_give_the_jax_host_points():
    from eth_consensus_specs_tpu_torch.crypto.curve import g1_to_bytes

    keys = g1_keys(3)
    host = [jc.g1_from_bytes(g1_to_bytes(k)) for k in keys]
    a, b = _g1_jac(keys[1], 5), _g1_jac(keys[2], 9)
    for regions, want in (({X0: a, Y0: b}, host[1] + host[2]), ({X0: a}, host[1].double())):
        mem = _mem(coop.G1, regions)
        if Y0 in regions:
            coop.simulate_add(coop.G1, 1, mem, BASES)
        else:
            coop.simulate(coop.G1.programs["g1_dbl1"], mem, BASES)
        x, y, z = (mem[O0 + k] * pow(RC, -1, P) % P for k in range(3))
        zi = pow(z, -1, P)
        assert (x * zi * zi % P, y * zi * zi * zi % P) == (want.x.n, want.y.n)


@pytest.mark.parametrize("n", [3, 4])
def test_g1_table_adds_side_by_side(n):
    """T8 + T1..Tn as one pair of programs, an infinite and an equal operand
    among them: each sum the plain add's."""
    pts = _g1_points()
    ys = pts[1:1 + n]
    ys[1] = [0, 0, 0]
    ys[-1] = _g1_jac(g1_keys(1)[0], 99)  # equal to the shared point
    mem = _mem(coop.G1, {X0: pts[0], Y0: sum(ys, [])})
    cases = coop.simulate_add(coop.G1, n, mem, BASES)
    assert cases[1] == "copy_x" and cases[-1] == "dbl"
    for j in range(n):
        assert [mem[O0 + 3 * j + k] for k in range(3)] == _g1_plain(g1_msm._add, pts[0], ys[j])


def test_g1_phi_is_lambda_and_canon_is_the_canonical_value():
    for pt in (g1_generator(), *g1_keys(3)):
        jac = _g1_jac(pt, 1)
        mem = _mem(coop.G1, {X0: jac})
        coop.simulate(coop.G1.programs["g1_phi"], mem, {**BASES, coop.O: X0})
        lam = pt.mul(coop.GLV_LAMBDA)
        assert [mem[X0 + k] for k in range(3)] == _g1_jac(lam, 1)
    mem = _mem(coop.G1, {X0: [5, 6, 7]})
    coop.simulate(coop.G1.programs["g1_canon"], mem, BASES)
    assert [mem[O0 + k] for k in range(3)] == [5, 6, 7]


def test_g2_psi_and_neg_equal_the_plain_versions():
    for pt in _g2_points()[:2]:
        for name, fn in (("g2_psi", gj.g2_psi), ("g2_neg", gj.g2_neg)):
            for in_place in (False, True):
                bases = {**BASES, coop.O: X0 if in_place else O0}
                mem = _mem(coop.G2, {X0: pt})
                coop.simulate(coop.G2.programs[name], mem, bases)
                assert [mem[bases[coop.O] + k] for k in range(6)] == _g2_plain(fn, pt)


def _affine_corners() -> list:
    """Z = 0 (infinity), Z = 1 (a norm of 1), Z with c1 = 0, Z with c0 = 0."""
    g = g2_generator()
    z = _rand(8, 2)
    return [[3, 4, 5, 6, 0, 0], _g2_jac(g.mul(7), (1, 0)), _g2_jac(g.mul(9), (z[0], 0)),
            _g2_jac(g.mul(11), (0, z[1]))]


@pytest.mark.parametrize("which", ["points", "corners"])
def test_g2_affine_equals_g2_to_affine(which):
    """x = X / Z^2, y = Y / Z^3 in plain canonical words, as the plain
    ``g2_to_affine`` gives them; Z = 0 gives zeros and zero norm products."""
    pts = _g2_points() if which == "points" else _affine_corners()
    for pt in pts:
        mem = _mem(coop.G2, {X0: pt})
        coop.simulate_g2_affine(mem, BASES)
        limbs = tuple(_limbs([[pt[2 * i], pt[2 * i + 1]]]) for i in range(3))
        x, y, inf = gj.g2_to_affine(limbs)
        want = fl.words_to_ints(fl.to_words(x))[0] + fl.words_to_ints(fl.to_words(y))[0]
        assert [mem[O0 + k] for k in range(4)] == want
        assert (mem[Z0] == 0 and mem[Z0 + 1] == 0) == bool(inf[0])


def test_fq2_inverse_inside_the_affine_step():
    """Z = (z0, z1) with Y = Z^3 and X = Z^2 gives the affine (1, 1): the
    Fq2 inverse of Z, at random values and at u (a norm of 1)."""
    for z in ((_rand(5, 1)[0], _rand(6, 1)[0]), (0, 1), (1, 0)):
        zz = g2_generator().x.__class__.from_ints(*z)
        pt = [_card(c) for e in (zz.square(), zz.square() * zz, zz) for c in (e.c0.n, e.c1.n)]
        mem = _mem(coop.G2, {X0: pt})
        coop.simulate_g2_affine(mem, BASES)
        assert [mem[O0 + k] for k in range(4)] == [1, 0, 1, 0]


def test_gcd_inverse_twin_equals_fermat():
    for x in (1, P - 1, 1 << 383, *_rand(7, 6), P + 5, 2 * P):
        got, steps = coop.gcd_inverse(x)
        assert got == pow(x, P - 2, P) and (steps > 0) == (x % P not in (0, 1))
    assert coop.gcd_inverse(0) == (0, 0) and coop.gcd_inverse(P)[0] == 0


@pytest.mark.parametrize("fam", [coop.G1, coop.G2], ids=["g1", "g2"])
def test_round_wider_than_a_warp_is_refused(fam):
    pg = coop.Program("wide", fam)
    pg.products()
    for i in range(fam.max_width + 1):
        pg.mul(coop.F((coop.X, i)), coop.F((coop.Y, i)), dest=(coop.O, i))
    pg.close()
    with pytest.raises(AssertionError, match="a group runs"):
        pg.finish()
    pg = coop.Program("race", fam)
    pg.adds([coop.F((coop.X, 1)), coop.F((coop.O, 0))], dests=[(coop.O, 0), (coop.O, 1)])
    with pytest.raises(AssertionError, match="read while written"):
        pg.finish()


def test_curve_families_in_the_header():
    st1, st2 = coop.stats(coop.G1), coop.stats(coop.G2)
    assert max(s["widest"] for s in st1.values()) <= coop.G1.max_width == 32
    assert max(s["widest"] for s in st2.values()) <= coop.G2.max_width == 32
    assert st1["g1_dbl1"]["product_rounds"] == 3 and st1["g1_dbl4"]["product_rounds"] == 12
    assert st1["g1_add_a1"]["product_rounds"] == 3 and st1["g1_add_b1"]["product_rounds"] == 1
    assert st2["g2_add_a1"]["product_rounds"] == 3 and st2["g2_add_b1"]["product_rounds"] == 1
    text = coop.header_text()
    for fam in (coop.G1, coop.G2):
        assert f"  static constexpr int kMaxWidth = {fam.max_width};" in text
        assert f"constexpr int k{fam.name.upper()}AddWork = " in text
        assert fam.slots <= coop.MAX_SLOT
    # the tower's programs do not move
    assert coop.FQ12.slots == coop.SLOTS and "kOp_mul = 3," in text


# --- the kernels' whole sequences, on the programs --------------------------


def _k17_on_programs(K, X, Y, Z, groups, fold_groups):
    """csrc/g1_msm.cu's steps on the G1 programs (host ints): per half-lane
    the split, phi, the table, the windows; the block trees; the fold."""
    fam, pt_slots = coop.G1, 3
    items, lanes = X.shape[0], X.shape[1]
    halves = g1_msm.half_scalars(K)
    xs, ys, zs = (fl.words_to_ints(a) for a in (X, Y, Z))
    t0, s = 100, 0

    def tab(j):
        return t0 + (j - 1) * pt_slots

    acc, work = t0 + 15 * pt_slots, t0 + 16 * pt_slots

    def run(name, x, o, mem, y=0, z=0):
        coop.simulate(fam.programs[name], mem, {coop.X: x, coop.Y: y, coop.Z: z, coop.O: o,
                                                coop.S: s})

    def add(mem, n, x, y, o):
        coop.simulate_add(fam, n, mem, {coop.X: x, coop.Y: y, coop.Z: work, coop.O: o,
                                        coop.S: s})

    def half_lane(i, hl):
        h = halves[i][hl] if hl < 2 * lanes else 0
        if h == 0:
            return [0, 0, 0]
        lane = hl >> 1
        mem = _mem(fam, {tab(1): [xs[i][lane], ys[i][lane], zs[i][lane]]})
        if hl & 1:
            run("g1_phi", tab(1), tab(1), mem)
        run("g1_dbl1", tab(1), tab(2), mem)
        add(mem, 1, tab(2), tab(1), tab(3))
        run("g1_dbl1", tab(2), tab(4), mem)
        add(mem, 3, tab(4), tab(1), tab(5))
        run("g1_dbl1", tab(4), tab(8), mem)
        add(mem, 4, tab(8), tab(1), tab(9))
        add(mem, 3, tab(8), tab(5), tab(13))
        digits = [(h >> (4 * w)) & 15 for w in range(32)]
        top = max(w for w in range(32) if digits[w])
        for k in range(3):
            mem[acc + k] = mem[tab(digits[top]) + k]
        for w in range(top - 1, -1, -1):
            run("g1_dbl4", acc, acc, mem)
            if digits[w]:
                add(mem, 1, acc, tab(digits[w]), acc)
        return [mem[acc + k] for k in range(3)]

    def tree(points):
        n = len(points)
        while n > 1:
            n //= 2
            for j in range(n):
                mem = _mem(fam, {acc: points[j], X0: points[j + n]})
                add(mem, 1, acc, X0, acc)
                points[j] = [mem[acc + k] for k in range(3)]
        return points[0]

    out = []
    bpi = -(-2 * lanes // groups)
    for i in range(items):
        parts = [tree([half_lane(i, c * groups + g) for g in range(groups)]) for c in range(bpi)]
        if bpi > 1:
            sums = [parts[g] if g < bpi else [0, 0, 0] for g in range(fold_groups)]
            for g in range(fold_groups):
                for j in range(g + fold_groups, bpi, fold_groups):
                    mem = _mem(fam, {acc: sums[g], X0: parts[j]})
                    add(mem, 1, acc, X0, acc)
                    sums[g] = [mem[acc + k] for k in range(3)]
            parts = [tree(sums)]
        mem = _mem(fam, {acc: parts[0]})
        run("g1_canon", acc, acc, mem)
        out.append([mem[acc + k] for k in range(3)])
    return out


@pytest.mark.parametrize("groups,fold_groups", [(4, 16), (2, 2)])
def test_k17_steps_on_the_programs_equal_msm_many_ref(groups, fold_groups):
    """Items of 3 and 5 lanes (the second's fold runs a partial's running
    sum with (2, 2)) with scalars 0, 1, r - 1, 2^256 - 1, r + 2 and P, -P."""
    from eth_consensus_specs_tpu_torch.crypto.fields import R

    keys = g1_keys(6)
    rng = np.random.default_rng(17)
    points = [keys[:3], [keys[3], -keys[3], keys[4], keys[5], keys[0]]]
    scalars = [[0, 1, (1 << 256) - 1],
               [7, 7, R - 1, R + 2, int.from_bytes(rng.bytes(32), "little")]]
    K, X, Y, Z = (torch.from_numpy(a) for a in g1_msm.pack_msm(points, scalars))
    want = g1_msm.msm_many_ref(K, X, Y, Z, groups=groups, fold_groups=fold_groups)
    assert _k17_on_programs(K, X, Y, Z, groups, fold_groups) == \
        [fl.words_to_ints(w) for w in want]


def _k14_on_programs(jac: torch.Tensor) -> tuple:
    """csrc/h2c.cu h2c_finish_kernel's steps on the G2 programs."""
    fam, s = coop.G2, 0
    p, a, b, t, c, n, w, out = (100 + 6 * i for i in range(8))
    out = w + coop.ADD_GEOMETRY["g2"]["work"]
    pts, flags = [], []

    def run(name, x, o, mem):
        coop.simulate(fam.programs[name], mem, {coop.X: x, coop.Y: 0, coop.Z: 0, coop.O: o,
                                                coop.S: s})

    def add(mem, x, y, o):
        coop.simulate_add(fam, 1, mem, {coop.X: x, coop.Y: y, coop.Z: w, coop.O: o, coop.S: s})

    def mul_z(mem, dst, src):
        for k in range(6):
            mem[dst + k] = mem[src + k]
        for bit in bin(0xD201000000010000)[3:]:
            run("g2_dbl1", dst, dst, mem)
            if bit == "1":
                add(mem, dst, src, dst)

    for row in fl.words_to_ints(jac.reshape(-1, 6, 12)):
        mem = _mem(fam, {p: row})
        mul_z(mem, a, p)
        mul_z(mem, b, a)
        add(mem, a, p, t)
        run("g2_psi", t, t, mem)
        add(mem, b, a, c)
        run("g2_neg", p, n, mem)
        add(mem, c, n, c)
        run("g2_neg", t, n, mem)
        add(mem, c, n, c)
        run("g2_dbl1", p, t, mem)
        run("g2_psi", t, t, mem)
        run("g2_psi", t, t, mem)
        add(mem, c, t, c)
        coop.simulate_g2_affine(mem, {coop.X: c, coop.Y: 0, coop.Z: w, coop.O: out, coop.S: s})
        pts.append([mem[out + k] for k in range(4)])
        flags.append(int(mem[w] == 0 and mem[w + 1] == 0))
    return pts, flags


@pytest.mark.parametrize("rows", [[[[3, 5], [7, 11]], [[13, 0], [0, 17]]],
                                  [[[0, 0], [5, 7]], [[P - 1, 0], [12345, 0]]]],
                         ids=["mapped", "corners"])
def test_k14_steps_on_the_programs_equal_h2c_finish_ref(rows):
    """Two mapped messages' sums (points of E2 outside G2; among the corners
    u = 0 and u with c1 = 0) and the point at infinity through the cofactor
    clearing and the affine step."""
    u = torch.from_numpy(fl.ints_to_words(rows))
    jac = torch.cat([hd.h2c_map_ref(u), torch.zeros((1, 3, 2, 12), dtype=torch.int32)])
    xy, inf = hd.h2c_finish_ref(jac)
    pts, flags = _k14_on_programs(jac)
    assert pts == [sum(r, []) for r in fl.words_to_ints(xy)] and flags == inf.tolist()
    assert flags == [0, 0, 1]
