"""The programs of the cooperative round engine (``csrc/fp12_coop.cuh``):
the Fq12 tower of K11 and K12, and the G1 and G2 curve formulas of K17 and
K14 (``csrc/curve_coop.cuh``).

A kernel runs its field arithmetic on a group of threads that keeps its
values in shared memory, one Fq element a *slot* (12 words, word-major:
word k of slot j at ``k * stride + j``). Every operation is a short
program of *rounds* separated by the group's barrier:

* a product round: each instruction is one Montgomery product L * R, where
  L and R are small signed sums of slots (Karatsuba's operand sums, xi and
  v folded in); one thread (or a few lanes) an instruction;
* an add round: each instruction writes one signed sum of slots (the
  Karatsuba recombinations), one thread an instruction;
* an inverse round: one Fq inverse, a 4-bit-window Fermat chain over a
  table of the 15 small powers that the rounds before it fill.

Programs come in *families*, each with its own constants, slot layout,
widest round and rendered table: ``FQ12`` (the tower: Fq2 = Fq[u]/(u^2+1),
Fq6 = Fq2[v]/(v^3 - xi), Fq12 = Fq6[w]/(w^2 - v), xi = 1 + u, an Fq12 at
[half][v][u]), ``G1`` (Jacobian points over Fq, 3 slots: X, Y, Z) and
``G2`` (Jacobian points over Fq2, 6 slots: X, Y, Z as c0, c1). This module
builds the programs once from the formulas (the host oracle's for the
tower, ``crypto/fields.py``; the plain versions' for the curves,
``ops/g1_msm.py`` and ``ops/g2_jacobian.py``), allots the scratch slots by
liveness, checks that no round reads a slot another thread of the same
round writes and that no round is wider than its family's groups run, and
renders the tables as the header ``fp12_coop_ops.cuh``, which ``_ext``
writes into its build directory before ``nvcc`` runs: this module is the
one copy of the programs. ``simulate`` runs a program on host ints exactly
as the card does, ``simulate_add`` the complete add as the kernels drive
it (its cases decided between two programs) and ``simulate_g2_affine`` K14's
affine step (its inverse taken between two programs), which is how the CPU
tests hold the tables to the plain versions without a card.

Slots are named by region and index: X, Y, Z are an operation's inputs (Z
also the curve adds' work area), O its output (which may be X itself: in
place), S the group's own area: constants, the inverse's power table (where
the family has an inverse), then scratch.
"""

from __future__ import annotations

from ..crypto.curve import PSI_X, PSI_Y
from ..crypto.fields import FROB2_GAMMA, FROB_GAMMA, P, R

R_CARD = 1 << 384  # the card's Montgomery radix (csrc/bls_fp.cuh)
X, Y, Z, O, S = range(5)
ADD, PRODUCT, INVERSE = range(3)
MAX_COEF = 7  # a term's coefficient is a 4-bit signed field; larger ones take several terms
MAX_WEIGHT = 63  # sum of |coef| of one sum: its value stays under 64 p
MAX_SLOT = 511
# G1's endomorphism phi(x, y) = (beta x, y) acts on the r-torsion as [lambda],
# lambda = z^2 - 1 for the BLS parameter z (lambda^2 + lambda + 1 = 0 mod r);
# beta is the cube root of unity in Fq that matches lambda, not lambda^2
GLV_LAMBDA = 0xD201000000010000 ** 2 - 1
GLV_BETA = pow(pow(2, (P - 1) // 3, P), 2, P)
# Z slots of K14's affine step: the norm of Z, which g2_affine_a writes, and
# its inverse, which the kernel writes before g2_affine_b reads it
AFFINE_NORM, AFFINE_INV = 2, 3
# Z slots of K20's easy-part inverse: t's cofactors (3 Fq2), d (Fq2), d's
# norm, which inv_a writes, and the norm's inverse, which the kernel writes
# before inv_b reads it
INV_T, INV_D, INV_NORM, INV_INV = 0, 6, 8, 9
_COMMON = [("mont_one", R_CARD % P), ("raw_one", 1), ("r2", R_CARD * R_CARD % P),
           ("r3", R_CARD ** 3 % P)]


class Family:
    """A family of programs: its S constants (common ones first), whether
    S holds the inverse's table, the widest round its groups run, and the
    programs, filled once at import."""

    def __init__(self, name: str, consts: list, max_width: int, inverse_table: bool):
        self.name = name
        self.consts = _COMMON + consts
        self.const_slot = {n: i for i, (n, _) in enumerate(self.consts)}
        self.table_base = len(self.consts)
        self.scratch_base = self.table_base + (15 if inverse_table else 0)
        self.max_width = max_width
        self.programs: dict = {}

    @property
    def slots(self) -> int:
        """S slots a group needs."""
        return self.scratch_base + max(p.scratch for p in self.programs.values())


# instructions a round: a family's groups run this many products at once
# (threads / lanes) and as many sums (threads); the header states each, and
# each kernel asserts that its group has the room. The tower's groups are 64
# threads (K11: a product a thread) or 256 (K12: four lanes); a curve group
# is one warp, a product a thread.
FQ12 = Family("fq12", [(f"frob1_{i}_{u}", (g.c0.n, g.c1.n)[u] * R_CARD % P)
                       for i, g in enumerate(FROB_GAMMA) for u in range(2)]
              + [(f"frob2_{i}", g.c0.n * R_CARD % P) for i, g in enumerate(FROB2_GAMMA)],
              max_width=64, inverse_table=True)
G1 = Family("g1", [("beta", GLV_BETA * R_CARD % P)], max_width=32, inverse_table=False)
G2 = Family("g2", [("psi_x0", PSI_X[0] * R_CARD % P), ("psi_x1", PSI_X[1] * R_CARD % P),
                   ("psi_y0", PSI_Y[0] * R_CARD % P), ("psi_y1", PSI_Y[1] * R_CARD % P)],
            max_width=32, inverse_table=False)
FAMILIES = (FQ12, G1, G2)

# the tower's names, as K11 and K12 and their tests use them
MAX_WIDTH = FQ12.max_width
CONSTS = FQ12.consts
CONST_SLOT = FQ12.const_slot
TABLE_BASE = FQ12.table_base
SCRATCH_BASE = FQ12.scratch_base


def const(name: str):
    return (S, CONST_SLOT[name])


# ------------------------------------------------------------ linear forms --
# A form is {slot: coefficient}: a signed sum of slots. A slot is (region,
# index) or ("V", n), a value of this program not yet given a slot.


def F(ref) -> dict:
    return {ref: 1}


def lin(*pairs) -> dict:
    """sum of coef * form over (coef, form) pairs."""
    out: dict = {}
    for c, f in pairs:
        for k, v in f.items():
            out[k] = out.get(k, 0) + c * v
    return {k: v for k, v in out.items() if v}


def add(a, b):
    return lin((1, a), (1, b))


def sub(a, b):
    return lin((1, a), (-1, b))


# Fq2 forms are pairs; Fq6 triples of Fq2; Fq12 pairs of Fq6


def add2(a, b):
    return (add(a[0], b[0]), add(a[1], b[1]))


def sub2(a, b):
    return (sub(a[0], b[0]), sub(a[1], b[1]))


def neg2(a):
    return (lin((-1, a[0])), lin((-1, a[1])))


def xi2(a):
    """times xi = 1 + u."""
    return (sub(a[0], a[1]), add(a[0], a[1]))


def conj2(a):
    return (a[0], lin((-1, a[1])))


def add6(a, b):
    return tuple(add2(x, y) for x, y in zip(a, b))


def sub6(a, b):
    return tuple(sub2(x, y) for x, y in zip(a, b))


def neg6(a):
    return tuple(neg2(x) for x in a)


def v6(a):
    """times v: (c0, c1, c2) -> (xi c2, c0, c1)."""
    return (xi2(a[2]), a[0], a[1])


def fq12_of(region: int):
    """The Fq12 at slots 0..11 of ``region`` ([half][v][u])."""
    return tuple(tuple((F((region, 6 * h + 2 * v)), F((region, 6 * h + 2 * v + 1)))
                       for v in range(3)) for h in range(2))


def conj12(a):
    return (a[0], neg6(a[1]))


def flat12(a) -> list:
    return [c for half in a for e in half for c in e]


# ---------------------------------------------------------------- programs --


class Program:
    """Rounds of one operation, built on forms; ``finish`` allots slots."""

    def __init__(self, name: str, family: Family = FQ12):
        self.name = name
        self.family = family
        self.rounds: list = []  # (kind, [(dest, [forms])])
        self._n = 0
        self._open = None

    def _value(self):
        self._n += 1
        return ("V", self._n)

    def products(self):
        """Open a product round; ``mul`` adds to it, ``close`` ends it."""
        assert self._open is None
        self._open = []
        return self

    def mul(self, a: dict, b: dict, dest=None) -> dict:
        ref = dest or self._value()
        self._open.append((ref, [a, b]))
        return F(ref)

    def close(self) -> None:
        self.rounds.append((PRODUCT, self._open))
        self._open = None

    def adds(self, forms, dests=None) -> list:
        refs = list(dests) if dests else [self._value() for _ in forms]
        self.rounds.append((ADD, [(r, [f]) for r, f in zip(refs, forms)]))
        return [F(r) for r in refs]

    def const(self, name: str) -> dict:
        """The form of one of the family's S constants."""
        return F((S, self.family.const_slot[name]))

    def inverse(self, dest=None) -> dict:
        """x^-1 of the table's x (S[table base]), after ``table`` filled it."""
        ref = dest or self._value()
        self.rounds.append((INVERSE, [(ref, [F((S, self.family.table_base))])]))
        return F(ref)

    def table(self, x: dict) -> None:
        """S[table base + i - 1] = x^i for i = 1..15 (x^1 first, an add
        round; then x^2; x^3, x^4; x^5..x^8; x^9..x^15)."""
        base = self.family.table_base
        t = [None] + self.adds([x], [(S, base)])
        for lo, hi in ((2, 2), (3, 4), (5, 8), (9, 15)):
            self.products()
            for i in range(lo, hi + 1):
                t.append(self.mul(t[lo - 1], t[i - lo + 1], (S, base + i - 1)))
            self.close()

    # -- Fq2 / Fq6 / Fq12 products; each returns forms over this round's products

    def fq2_mul(self, a, b):
        p0 = self.mul(a[0], b[0])
        p1 = self.mul(a[1], b[1])
        p2 = self.mul(add(a[0], a[1]), add(b[0], b[1]))
        return (sub(p0, p1), lin((1, p2), (-1, p0), (-1, p1)))

    def fq2_sqr(self, a):
        """(a0 + a1)(a0 - a1) + 2 a0 a1 u."""
        p = self.mul(add(a[0], a[1]), sub(a[0], a[1]))
        q = self.mul(a[0], a[1])
        return (p, lin((2, q)))

    def fq6_products(self, a, b) -> list:
        """Karatsuba's six Fq2 products t0, t1, t2, u12, u01, u02."""
        return [self.fq2_mul(a[0], b[0]), self.fq2_mul(a[1], b[1]), self.fq2_mul(a[2], b[2]),
                self.fq2_mul(add2(a[1], a[2]), add2(b[1], b[2])),
                self.fq2_mul(add2(a[0], a[1]), add2(b[0], b[1])),
                self.fq2_mul(add2(a[0], a[2]), add2(b[0], b[2]))]

    def finish(self) -> "Program":
        """Allot scratch slots to the values by liveness (a slot is reused
        only by a value written after the round of its last read), then check
        the rounds."""
        assert self._open is None
        first, last = {}, {}
        for r, (_, insns) in enumerate(self.rounds):
            for dest, forms in insns:
                for f in forms:
                    for ref in f:
                        if ref[0] == "V":
                            last[ref] = r
                if dest[0] == "V":
                    assert dest not in first, f"{self.name}: {dest} written twice"
                    first[dest] = r
        slots: list = []  # [slot, round of its occupant's last read]
        where = {}
        for ref in sorted(first, key=lambda v: (first[v], v[1])):
            assert ref in last, f"{self.name}: {ref} never read"
            r0 = first[ref]
            for s in slots:
                if s[1] < r0:
                    where[ref] = (S, s[0])
                    s[1] = last[ref]
                    break
            else:
                where[ref] = (S, self.family.scratch_base + len(slots))
                slots.append([self.family.scratch_base + len(slots), last[ref]])

        def place(ref):
            return where.get(ref, ref)

        self.rounds = [(kind, [(place(d), [{place(k): c for k, c in f.items()} for f in fs])
                               for d, fs in insns]) for kind, insns in self.rounds]
        self.scratch = len(slots)
        self.check()
        return self

    def check(self) -> None:
        """No round writes a slot twice, or one another instruction of the
        round reads (O counted as X, for in-place use), or holds more than
        its family's widest round; sums within the interpreter's limits (a
        coefficient above MAX_COEF is rendered as several terms)."""
        width = self.family.max_width
        for r, (kind, insns) in enumerate(self.rounds):
            assert len(insns) <= width, (
                f"{self.name} round {r}: {len(insns)} instructions, a group runs {width}")
            alias = [(X if d[0] == O else d[0], d[1]) for d, _ in insns]
            assert len(set(alias)) == len(alias), f"{self.name} round {r}: a slot written twice"
            for i, (d, forms) in enumerate(insns):
                assert d[0] in (O, S, Y, Z) and d[1] <= MAX_SLOT
                assert kind == PRODUCT or len(forms) == 1
                for f in forms:
                    assert f, f"{self.name} round {r}: an empty sum"
                    assert sum(abs(c) for c in f.values()) <= MAX_WEIGHT
                    for ref, c in f.items():
                        assert ref[1] <= MAX_SLOT
                        rr = (X if ref[0] == O else ref[0], ref[1])
                        for j, w in enumerate(alias):
                            assert j == i or w != rr, (
                                f"{self.name} round {r}: slot {ref} read while written")


def _mul12(pg: Program, a, b, out) -> None:
    """out = a * b: 54 products (Karatsuba over Fq6, Fq2, Fq), then two add
    rounds: the three Fq6 products from the Fq products, then the halves."""
    pg.products()
    prods = [pg.fq6_products(x, y) for x, y in ((a[0], b[0]), (a[1], b[1]),
                                                (add6(a[0], a[1]), add6(b[0], b[1])))]
    pg.close()
    t = _level(pg, [_fq6_combine(ps) for ps in prods])
    c0 = add6(t[0], v6(t[1]))
    c1 = sub6(sub6(t[2], t[0]), t[1])
    pg.adds(flat12((c0, c1)), dests=[(O, k) for k in range(12)])


def _level(pg: Program, groups: list, dests=None) -> list:
    """Materialize lists of Fq2 forms in one add round (into ``dests``
    where given); the same nesting back, each form a slot."""
    refs = iter(pg.adds([c for g in groups for e in g for c in e], dests))
    return [[(next(refs), next(refs)) for _ in g] for g in groups]


def _fq6_combine(t: list):
    """Karatsuba's recombination of the six Fq2 products (csrc/bls_fp.cuh
    fp6_mul)."""
    t0, t1, t2, u12, u01, u02 = t
    c0 = add2(t0, xi2(sub2(sub2(u12, t1), t2)))
    c1 = add2(sub2(sub2(u01, t0), t1), xi2(t2))
    c2 = add2(sub2(sub2(u02, t0), t2), t1)
    return (c0, c1, c2)


def build_mul(conj_b: bool = False) -> Program:
    pg = Program("mulc" if conj_b else "mul")
    b = fq12_of(Y)
    _mul12(pg, fq12_of(X), conj12(b) if conj_b else b, None)
    return pg.finish()


def build_sqr() -> Program:
    """Complex squaring: c0 = (a0 + a1)(a0 + v a1) - ab - v ab, c1 = 2 ab."""
    pg = Program("sqr")
    a0, a1 = fq12_of(X)
    pg.products()
    ab = pg.fq6_products(a0, a1)
    pr = pg.fq6_products(add6(a0, a1), add6(a0, v6(a1)))
    pg.close()
    ab, pr = _level(pg, [_fq6_combine(ab), _fq6_combine(pr)])
    c0 = sub6(sub6(pr, ab), v6(ab))
    c1 = add6(ab, ab)
    pg.adds(flat12((c0, c1)), dests=[(O, k) for k in range(12)])
    return pg.finish()


def build_cyclotomic_sqr() -> Program:
    """Granger-Scott squaring (``fq12_tower.fq12_cyclotomic_sqr``): nine Fq2
    squarings, 18 products, then one add round that also reads the input."""
    pg = Program("cyc")
    (z00, z01, z02), (z10, z11, z12) = fq12_of(X)
    pg.products()
    sq = {}
    for name, (a, b) in (("A", (z00, z11)), ("B", (z10, z02)), ("C", (z01, z12))):
        sq[name] = [pg.fq2_sqr(a), pg.fq2_sqr(b), pg.fq2_sqr(add2(a, b))]
    pg.close()

    def fq4(name):
        t0, t1, s = sq[name]
        return add2(t0, xi2(t1)), sub2(sub2(s, t0), t1)

    def three_plus(t, z, sign):
        return tuple(lin((3, t[u]), (2 * sign, z[u])) for u in range(2))

    a0, a1 = fq4("A")
    b0, b1 = fq4("B")
    c0, c1 = fq4("C")
    out = {(0, 0): three_plus(a0, z00, -1), (1, 1): three_plus(a1, z11, 1),
           (0, 1): three_plus(b0, z01, -1), (1, 2): three_plus(b1, z12, 1),
           (1, 0): three_plus(xi2(c1), z10, 1), (0, 2): three_plus(c0, z02, -1)}
    forms = [out[(h, v)][u] for h in range(2) for v in range(3) for u in range(2)]
    pg.adds(forms, dests=[(O, k) for k in range(12)])
    return pg.finish()


def _line_products(pg: Program, f):
    """f * (py + a3 w^3 + a5 w^5) with py = Z[0], a3 = Y[0..1],
    a5 = Y[2..3] (``csrc/bls_fp.cuh`` fp12_mul_line): twelve sparse Fq2
    products and twelve py scalings, then one add round."""
    f0, f1 = f
    a3 = (F((Y, 0)), F((Y, 1)))
    a5 = (F((Y, 2)), F((Y, 3)))
    py = F((Z, 0))
    sparse = []
    for s in (f0, f1):
        sparse.append([pg.fq2_mul(s[1], a5), pg.fq2_mul(s[2], a3), pg.fq2_mul(s[0], a3),
                       pg.fq2_mul(s[2], a5), pg.fq2_mul(s[0], a5), pg.fq2_mul(s[1], a3)])
    scaled = [[tuple(pg.mul(c, py) for c in e) for e in half] for half in (f0, f1)]
    return sparse, scaled


def _line_finish(pg: Program, sparse, scaled) -> None:
    sums = []
    for x in sparse:
        s1a5, s2a3, s0a3, s2a5, s0a5, s1a3 = x
        sums.append((xi2(add2(s1a5, s2a3)), add2(s0a3, xi2(s2a5)), add2(s0a5, s1a3)))
    c0 = add6(scaled[0], v6(sums[1]))
    c1 = add6(scaled[1], sums[0])
    pg.adds(flat12((c0, c1)), dests=[(O, k) for k in range(12)])


def _line_round(pg: Program, f, convert_next: bool) -> None:
    """The line product of ``f`` (forms) into O; with ``convert_next`` its
    product round also takes the next step's coefficients (Y[4..7],
    canonical) into Montgomery form in place: a3 times R^2, lam * xi^-1
    times -px R^2 (Z[1])."""
    pg.products()
    sparse, scaled = _line_products(pg, f)
    if convert_next:
        for k in range(4):
            pg.mul(F((Y, 4 + k)), F(const("r2")) if k < 2 else F((Z, 1)), dest=(Y, 4 + k))
    pg.close()
    _line_finish(pg, sparse, scaled)


def build_line(convert_next: bool) -> Program:
    """The Miller step's line product: f = X times the step's line."""
    pg = Program("line_conv" if convert_next else "line")
    _line_round(pg, fq12_of(X), convert_next)
    return pg.finish()


def build_sqr_line(convert_next: bool) -> Program:
    """A Miller doubling step: f = X squared (complex squaring), then times
    the step's line, with the square left as sums of the squaring's Fq6
    level that the line's operands read: four rounds, against five for
    ``sqr`` then ``line``."""
    pg = Program("sqr_line_conv" if convert_next else "sqr_line")
    a0, a1 = fq12_of(X)
    pg.products()
    ab = pg.fq6_products(a0, a1)
    pr = pg.fq6_products(add6(a0, a1), add6(a0, v6(a1)))
    pg.close()
    ab, pr = _level(pg, [_fq6_combine(ab), _fq6_combine(pr)])
    _line_round(pg, (sub6(sub6(pr, ab), v6(ab)), add6(ab, ab)), convert_next)
    return pg.finish()


def build_prep() -> Program:
    """Before a pair's loop: py (Z[0]) to Montgomery form, px (Z[1]) to
    -px R^2 (the Montgomery form of -px, times R), both in place; then the
    first step's coefficients (Y[0..3]) as ``line_conv`` takes the next."""
    pg = Program("prep")
    pg.products()
    pg.mul(F((Z, 0)), F(const("r2")), dest=(Z, 0))
    pg.mul(lin((-1, F((Z, 1)))), F(const("r3")), dest=(Z, 1))
    pg.close()
    pg.products()
    for k in range(4):
        pg.mul(F((Y, k)), F(const("r2")) if k < 2 else F((Z, 1)), dest=(Y, k))
    pg.close()
    return pg.finish()


def build_scale(name: str, const_name: str) -> Program:
    """O = X times a constant, coordinate by coordinate: ``load`` (canonical
    words to Montgomery form, times R^2), ``store`` (back, times 1) and
    ``canon`` (a lazy sum's canonical value, times R)."""
    pg = Program(name)
    pg.products()
    for k in range(12):
        pg.mul(F((X, k)), F(const(const_name)), dest=(O, k))
    pg.close()
    return pg.finish()


def build_frobenius() -> Program:
    """f^p: coefficient i (at [i % 2][i // 2]) conjugated, times gamma1_i."""
    pg = Program("frob")
    a = fq12_of(X)
    pg.products()
    out = {}
    for h in range(2):
        for v in range(3):
            i = 2 * v + h
            g = (F(const(f"frob1_{i}_0")), F(const(f"frob1_{i}_1")))
            out[(h, v)] = pg.fq2_mul(conj2(a[h][v]), g)
    pg.close()
    pg.adds([out[(h, v)][u] for h in range(2) for v in range(3) for u in range(2)],
            dests=[(O, k) for k in range(12)])
    return pg.finish()


def build_frobenius2() -> Program:
    """f^(p^2): coefficient i times gamma2_i, in Fq."""
    pg = Program("frob2")
    pg.products()
    for h in range(2):
        for v in range(3):
            for u in range(2):
                pg.mul(F((X, 6 * h + 2 * v + u)), F(const(f"frob2_{2 * v + h}")),
                       dest=(O, 6 * h + 2 * v + u))
    pg.close()
    return pg.finish()


def build_conj() -> Program:
    pg = Program("conj")
    pg.adds([lin((1 if k < 6 else -1, F((X, k)))) for k in range(12)],
            dests=[(O, k) for k in range(12)])
    return pg.finish()


def _inverse_head(pg: Program, t_dests=None, d_dests=None) -> tuple:
    """The rounds of an Fq12 inverse up to one Fq inverse (``csrc/bls_fp.cuh``
    fp12_inv, fp6_inv, fp2_inv): the halves' squares, t = a0^2 - v a1^2,
    t's Fq6 inverse down to d = t0 c0 + xi (t1 c2 + t2 c1) in Fq2, then d's
    norm products. Returns (t's cofactors tt, d, the norm's form)."""
    a0, a1 = fq12_of(X)
    pg.products()
    s0 = pg.fq6_products(a0, a0)
    s1 = pg.fq6_products(a1, a1)
    pg.close()
    s0, s1 = _level(pg, [_fq6_combine(s0), _fq6_combine(s1)])
    t = _level(pg, [sub6(s0, v6(s1))])[0]
    # fp6_inv: t0 = c0^2 - xi c1 c2, t1 = xi c2^2 - c0 c1, t2 = c1^2 - c0 c2
    c0, c1, c2 = t
    pg.products()
    q = [pg.fq2_mul(x, y) for x, y in ((c0, c0), (c1, c2), (c2, c2), (c0, c1), (c1, c1), (c0, c2))]
    pg.close()
    q = _level(pg, [q])[0]
    tt = _level(pg, [[sub2(q[0], xi2(q[1])), sub2(xi2(q[2]), q[3]), sub2(q[4], q[5])]],
                t_dests)[0]
    pg.products()
    dd = [pg.fq2_mul(c0, tt[0]), pg.fq2_mul(c2, tt[1]), pg.fq2_mul(c1, tt[2])]
    pg.close()
    d = _level(pg, [[add2(dd[0], xi2(add2(dd[1], dd[2])))]], d_dests)[0][0]
    pg.products()
    n0, n1 = pg.mul(d[0], d[0]), pg.mul(d[1], d[1])
    pg.close()
    return tt, d, add(n0, n1)


def _inverse_tail(pg: Program, tt, d, ninv) -> None:
    """From the Fq inverse ``ninv`` of d's norm: d^-1, t^-1 = tt d^-1, then
    O = (a0 t^-1, -a1 t^-1)."""
    a0, a1 = fq12_of(X)
    pg.products()
    dinv = (pg.mul(d[0], ninv), pg.mul(lin((-1, d[1])), ninv))
    pg.close()
    pg.products()
    tinv = [pg.fq2_mul(x, dinv) for x in tt]
    pg.close()
    tinv = tuple(_level(pg, [tinv])[0])
    pg.products()
    r = [pg.fq6_products(a0, tinv), pg.fq6_products(neg6(a1), tinv)]
    pg.close()
    r = _level(pg, [_fq6_combine(x) for x in r])
    pg.adds(flat12((r[0], r[1])), dests=[(O, k) for k in range(12)])


def build_inverse() -> Program:
    """O = X^-1, its Fq inverse the engine's Fermat chain (an inverse round
    over the table of the norm's powers)."""
    pg = Program("inv")
    tt, d, norm = _inverse_head(pg)
    pg.table(norm)
    _inverse_tail(pg, tt, d, pg.inverse())
    return pg.finish()


def build_inverse_gcd() -> tuple[Program, Program]:
    """O = X^-1 as two programs around one Fq inverse that the kernel takes
    between them on one thread (K20's binary GCD): ``inv_a`` writes t's
    cofactors to Z[INV_T..], d to Z[INV_D..] and d's norm to Z[INV_NORM];
    ``inv_b`` reads them and the norm's inverse at Z[INV_INV]."""
    pa = Program("inv_a")
    _, _, norm = _inverse_head(pa, [(Z, INV_T + k) for k in range(6)],
                               [(Z, INV_D + k) for k in range(2)])
    pa.adds([norm], dests=[(Z, INV_NORM)])
    pb = Program("inv_b")
    tt = [(F((Z, INV_T + 2 * i)), F((Z, INV_T + 2 * i + 1))) for i in range(3)]
    _inverse_tail(pb, tt, (F((Z, INV_D)), F((Z, INV_D + 1))), F((Z, INV_INV)))
    return pa.finish(), pb.finish()


# ------------------------------------------------------------ curve points --
# A G1 point is 3 slots (X, Y, Z over Fq), a G2 point 6 (X, Y, Z over Fq2,
# each c0 then c1), Jacobian, Z = 0 infinity. The formulas are the plain
# versions' (``ops/g1_msm.py`` _dbl and _add, ``ops/g2_jacobian.py``): the
# same field values come out, so the canonical words do too.


class _Field:
    """Forms of a curve's coordinate field: Fq (``n`` = 1 slot an element)
    or Fq2 (2 slots: c0, c1; Karatsuba products)."""

    def __init__(self, n: int):
        self.n = n

    def elem(self, region: int, i: int):
        if self.n == 1:
            return F((region, i))
        return (F((region, 2 * i)), F((region, 2 * i + 1)))

    def lc(self, *pairs):
        """sum of coef * element over (coef, element) pairs."""
        if self.n == 1:
            return lin(*pairs)
        return tuple(lin(*[(c, e[k]) for c, e in pairs]) for k in range(2))

    def parts(self, e) -> list:
        return [e] if self.n == 1 else list(e)

    def conj(self, e):
        return (e[0], lin((-1, e[1])))

    def mul(self, pg: Program, a, b, dest):
        """a * b in the open product round; ``dest()`` gives each product's
        slot (None: a scratch value)."""
        if self.n == 1:
            return pg.mul(a, b, dest())
        p0 = pg.mul(a[0], b[0], dest())
        p1 = pg.mul(a[1], b[1], dest())
        p2 = pg.mul(add(a[0], a[1]), add(b[0], b[1]), dest())
        return (sub(p0, p1), lin((1, p2), (-1, p0), (-1, p1)))

    def sqr(self, pg: Program, a, b, dest):
        """a * b for b a scalar multiple of a (a squaring, scaled): over Fq2
        two products, (a0 + a1)(b0 - b1) and 2 a0 b1."""
        if self.n == 1:
            return pg.mul(a, b, dest())
        p = pg.mul(add(a[0], a[1]), sub(b[0], b[1]), dest())
        q = pg.mul(a[0], b[1], dest())
        return (p, lin((2, q)))


FQ1, FQ2 = _Field(1), _Field(2)
FIELD = {"g1": FQ1, "g2": FQ2}


def _scratch():
    return None


class _Work:
    """Consecutive slots of the Z region from ``base``: a curve add's work
    values, which its second program and the case tests read."""

    def __init__(self, base: int):
        self.next = base

    def __call__(self):
        self.next += 1
        return (Z, self.next - 1)


def _point(f: _Field, region: int, first: int = 0) -> tuple:
    return tuple(f.elem(region, first + i) for i in range(3))


def _flat(f: _Field, pt) -> list:
    return [c for e in pt for c in f.parts(e)]


def _dbl_forms(pg: Program, f: _Field, pt) -> tuple:
    """dbl-2009-l (a = 0) on the forms of a point, three product rounds:
    {A = X^2, B = Y^2, Z3 = 2YZ}, {8C = 2B 4B, D = 2X 2B, F = 3A 3A},
    {3A (3D - F)}; then X3 = F - 2D, Y3 = 3A (3D - F) - 8C (the plain
    version's D = 2((X + B)^2 - A - C) is 4XB, its E is 3A)."""
    x, y, z = pt
    pg.products()
    a = f.sqr(pg, x, x, _scratch)
    b = f.sqr(pg, y, y, _scratch)
    z3 = f.mul(pg, f.lc((2, y)), z, _scratch)
    pg.close()
    pg.products()
    c8 = f.sqr(pg, f.lc((2, b)), f.lc((4, b)), _scratch)
    d = f.mul(pg, f.lc((2, x)), f.lc((2, b)), _scratch)
    ff = f.sqr(pg, f.lc((3, a)), f.lc((3, a)), _scratch)
    pg.close()
    pg.products()
    p3 = f.mul(pg, f.lc((3, a)), f.lc((3, d), (-1, ff)), _scratch)
    pg.close()
    return f.lc((1, ff), (-2, d)), f.lc((1, p3), (-1, c8)), z3


def build_dbl(fam: Family, count: int) -> Program:
    """O = [2^count] X: ``count`` doublings chained on forms, one add round."""
    f = FIELD[fam.name]
    pg = Program(f"{fam.name}_dbl{count}", fam)
    pt = _point(f, X)
    for _ in range(count):
        pt = _dbl_forms(pg, f, pt)
    pg.adds(_flat(f, pt), dests=[(O, k) for k in range(3 * f.n)])
    return pg.finish()


# where an add's case tests read, in its work slots: the first product of
# Z1^2 (infinite first operand), of Z2^2 (infinite second), of (2H)^2 (equal
# x) and of (2(S2 - S1))^2 (equal y), each f.n products that are all zero
# exactly when the value is
ADD_FLAGS = ("inf1", "inf2", "same_x", "same_y")
ADD_GEOMETRY: dict = {}  # family name -> {"work": slots an add, flag: first slot}


def build_add(fam: Family, n: int) -> tuple[Program, Program]:
    """n complete adds X + Y_j -> O_j (add-2007-bl), X one point that all
    share, Y_j and O_j consecutive points, the work of add j at Z[j W]:
    ``add_a`` runs {Z1^2, Z2^2, Y1 Z2, Y2 Z1}, {U1, U2, S1, S2, (Z1 + Z2)^2},
    {I = (2H)^2, r^2, Z3, r U1, r H, S1 H} (r = 2(S2 - S1)) into the work
    slots; the kernel then reads the case tests; ``add_b`` runs {J = H I,
    V = U1 I, (r U1) I, (r H) I, r^2 r, (S1 H) I} and writes X3 = r^2 - J -
    2V, Y3 = 3 r V + r J - r^3 - 2 S1 J (the plain r (V - X3) - 2 S1 J) and
    Z3. Four product rounds where the plain formula's chain is five."""
    f = FIELD[fam.name]
    pa = Program(f"{fam.name}_add_a{n}", fam)
    pb = Program(f"{fam.name}_add_b{n}", fam)
    work = ADD_GEOMETRY.setdefault(fam.name, {}).get("work")
    x1, y1, z1 = _point(f, X)
    vals, flags = [], []
    w = [_Work(j * (work or 0)) for j in range(n)]
    pa.products()
    for j in range(n):
        x2, y2, z2 = _point(f, Y, 3 * j)
        fl_j = {"inf1": w[j].next}
        z1z1 = f.sqr(pa, z1, z1, w[j])
        fl_j["inf2"] = w[j].next
        z2z2 = f.sqr(pa, z2, z2, w[j])
        yz1 = f.mul(pa, y1, z2, _scratch)
        yz2 = f.mul(pa, y2, z1, _scratch)
        vals.append(dict(x2=x2, z1z1=z1z1, z2z2=z2z2, yz1=yz1, yz2=yz2, z2=z2))
        flags.append(fl_j)
    pa.close()
    pa.products()
    for j, v in enumerate(vals):
        v["u1"] = f.mul(pa, x1, v["z2z2"], w[j])
        v["u2"] = f.mul(pa, v["x2"], v["z1z1"], w[j])
        v["s1"] = f.mul(pa, v["yz1"], v["z2z2"], w[j])
        v["s2"] = f.mul(pa, v["yz2"], v["z1z1"], w[j])
        v["zz"] = f.sqr(pa, f.lc((1, z1), (1, v["z2"])), f.lc((1, z1), (1, v["z2"])), _scratch)
    pa.close()
    pa.products()
    for j, v in enumerate(vals):
        h = f.lc((1, v["u2"]), (-1, v["u1"]))
        r = f.lc((2, v["s2"]), (-2, v["s1"]))
        v["h"], v["r"] = h, r
        flags[j]["same_x"] = w[j].next
        v["i"] = f.sqr(pa, f.lc((2, h)), f.lc((2, h)), w[j])
        flags[j]["same_y"] = w[j].next
        v["rr"] = f.sqr(pa, r, r, w[j])
        v["z3"] = f.mul(pa, f.lc((1, v["zz"]), (-1, v["z1z1"]), (-1, v["z2z2"])), h, w[j])
        v["ru1"] = f.mul(pa, r, v["u1"], w[j])
        v["rh"] = f.mul(pa, r, h, w[j])
        v["s1h"] = f.mul(pa, v["s1"], h, w[j])
    pa.close()
    pb.products()
    for v in vals:
        i = v["i"]
        v["J"] = f.mul(pb, v["h"], i, _scratch)
        v["V"] = f.mul(pb, v["u1"], i, _scratch)
        v["a"] = f.mul(pb, v["ru1"], i, _scratch)
        v["b"] = f.mul(pb, v["rh"], i, _scratch)
        v["c"] = f.mul(pb, v["rr"], v["r"], _scratch)
        v["d"] = f.mul(pb, v["s1h"], i, _scratch)
    pb.close()
    forms = []
    for v in vals:
        x3 = f.lc((1, v["rr"]), (-1, v["J"]), (-2, v["V"]))
        y3 = f.lc((3, v["a"]), (1, v["b"]), (-1, v["c"]), (-2, v["d"]))
        forms += _flat(f, (x3, y3, v["z3"]))
    pb.adds(forms, dests=[(O, k) for k in range(3 * f.n * n)])
    if work is None:  # the first build fixes the geometry; later ones must agree
        ADD_GEOMETRY[fam.name] = {"work": w[0].next, **flags[0]}
    geo = ADD_GEOMETRY[fam.name]
    assert all(w[j].next - j * geo["work"] == geo["work"] for j in range(n))
    assert all(fl_j[k] - j * geo["work"] == geo[k] for j, fl_j in enumerate(flags) for k in fl_j)
    return pa.finish(), pb.finish()


def build_g1_phi() -> Program:
    """G1's endomorphism in place: X = beta X (Y and Z stay)."""
    pg = Program("g1_phi", G1)
    pg.products()
    pg.mul(F((X, 0)), pg.const("beta"), dest=(O, 0))
    pg.close()
    return pg.finish()


def build_curve_scale(fam: Family, name: str, const_name: str, slots: int) -> Program:
    """O = X times a constant, slot by slot (``canon``: a lazy value's
    canonical Montgomery words)."""
    pg = Program(f"{fam.name}_{name}", fam)
    pg.products()
    for k in range(slots):
        pg.mul(F((X, k)), pg.const(const_name), dest=(O, k))
    pg.close()
    return pg.finish()


def build_g2_psi() -> Program:
    """psi on Jacobian coordinates: each conjugated, X and Y times the psi
    constants (``g2_jacobian.g2_psi``)."""
    f, pg = FQ2, Program("g2_psi", G2)
    x, y, z = _point(f, X)
    pg.products()
    px = f.mul(pg, f.conj(x), (pg.const("psi_x0"), pg.const("psi_x1")), _scratch)
    py = f.mul(pg, f.conj(y), (pg.const("psi_y0"), pg.const("psi_y1")), _scratch)
    pg.close()
    pg.adds(_flat(f, (px, py, f.conj(z))), dests=[(O, k) for k in range(6)])
    return pg.finish()


def build_g2_neg() -> Program:
    pg = Program("g2_neg", G2)
    pg.adds([F((X, k)) if k not in (2, 3) else lin((-1, F((X, k)))) for k in range(6)],
            dests=[(O, k) for k in range(6)])
    return pg.finish()


def build_g2_affine() -> tuple[Program, Program]:
    """The affine point of X in plain canonical words, O = (x.c0, x.c1, y.c0,
    y.c1) (``g2_jacobian.g2_to_affine``), as two programs around one Fq
    inverse that the kernel takes between them on one thread (the binary
    GCD: the point is public). ``g2_affine_a``: the norm's two products into
    Z[0] and Z[1] (both zero exactly when the point is infinite), their sum
    into Z[AFFINE_NORM]. ``g2_affine_b``, with N^-1 at Z[AFFINE_INV]: Z^-1 =
    (z0, -z1) / N, then x = X Z^-2 and y = Y Z^-3, each left Montgomery form
    by a product with 1. Z = 0 gives x = y = 0."""
    f, pa = FQ2, Program("g2_affine_a", G2)
    z = _point(f, X)[2]
    pa.products()
    n0 = pa.mul(z[0], z[0], dest=(Z, 0))
    n1 = pa.mul(z[1], z[1], dest=(Z, 1))
    pa.close()
    pa.adds([add(n0, n1)], dests=[(Z, AFFINE_NORM)])
    pg = Program("g2_affine_b", G2)
    x, y, z = _point(f, X)
    ninv = F((Z, AFFINE_INV))
    pg.products()
    zi = (pg.mul(z[0], ninv), pg.mul(lin((-1, z[1])), ninv))
    pg.close()
    pg.products()
    zi2 = f.sqr(pg, zi, zi, _scratch)
    pg.close()
    pg.products()
    zi3 = f.mul(pg, zi2, zi, _scratch)
    ax = f.mul(pg, x, zi2, _scratch)
    pg.close()
    pg.products()
    ay = f.mul(pg, y, zi3, _scratch)
    for k, c in enumerate(f.parts(ax)):
        pg.mul(c, pg.const("raw_one"), dest=(O, k))
    pg.close()
    pg.products()
    for k, c in enumerate(f.parts(ay)):
        pg.mul(c, pg.const("raw_one"), dest=(O, 2 + k))
    pg.close()
    return pa.finish(), pg.finish()


G1_ADDS = (1, 3, 4)  # the widths of G1's add programs: the ladder's and the table's
G2_ADDS = (1,)


def build_all() -> dict:
    progs = [build_scale("load", "r2"), build_scale("store", "raw_one"),
             build_scale("canon", "mont_one"), build_mul(),
             build_mul(conj_b=True), build_sqr(), build_cyclotomic_sqr(), build_line(False),
             build_line(True), build_sqr_line(False), build_sqr_line(True), build_prep(),
             build_frobenius(), build_frobenius2(),
             build_conj(), build_inverse(), *build_inverse_gcd()]
    g1 = [build_dbl(G1, 1), build_dbl(G1, 4), *[p for n in G1_ADDS for p in build_add(G1, n)],
          build_g1_phi(), build_curve_scale(G1, "canon", "mont_one", 3)]
    g2 = [build_dbl(G2, 1), build_dbl(G2, 4), *[p for n in G2_ADDS for p in build_add(G2, n)],
          build_g2_psi(), build_g2_neg(), *build_g2_affine(),
          build_curve_scale(G2, "canon", "mont_one", 6)]
    for fam, ps in ((FQ12, progs), (G1, g1), (G2, g2)):
        fam.programs.update({p.name: p for p in ps})
    return {p.name: p for p in progs}


PROGRAMS = build_all()
SCRATCH = max(p.scratch for p in PROGRAMS.values())
SLOTS = SCRATCH_BASE + SCRATCH  # S slots a group needs
assert SLOTS == FQ12.slots


# ----------------------------------------------------------------- simulate --


def mont(a: int, b: int) -> int:
    return a * b * pow(R_CARD, -1, P) % P


def gcd_inverse(x: int) -> tuple[int, int]:
    """The binary extended GCD inverse of ``x`` (any value below 2^384) mod
    p, as ``fp_inv_gcd`` (``csrc/fp_gcd.cuh``) runs it for K13, K14 and
    K20: (x^-1 mod p, 0 for 0; the steps it took, a halving or a
    subtraction each)."""
    u = x
    while u >= P:
        u -= P
    if u == 0:
        return 0, 0
    v, x1, x2, steps = P, 1, 0, 0
    while u != 1 and v != 1:
        while not u & 1:
            u >>= 1
            x1 = x1 >> 1 if not x1 & 1 else (x1 + P) >> 1
            steps += 1
        while not v & 1:
            v >>= 1
            x2 = x2 >> 1 if not x2 & 1 else (x2 + P) >> 1
            steps += 1
        if u >= v:
            u -= v
            x1 = x1 - x2 if x1 >= x2 else x1 + P - x2
        else:
            v -= u
            x2 = x2 - x1 if x2 >= x1 else x2 + P - x1
        steps += 1
    return (x1 if u == 1 else x2), steps


def simulate(prog: Program, mem: dict, bases: dict) -> None:
    """Run ``prog`` on ``mem`` ({absolute slot: int in [0, p)}) as the card
    does, with region bases ``bases`` ({X: slot, ...}); each round reads
    everything before it writes. The inverse takes the Montgomery form
    x R to x^-1 R (a Fermat power by Montgomery products)."""

    def val(f):
        return sum(c * mem[bases[r] + i] for (r, i), c in f.items()) % P

    for kind, insns in prog.rounds:
        out = []
        for dest, forms in insns:
            if kind == PRODUCT:
                out.append((dest, mont(val(forms[0]), val(forms[1]))))
            elif kind == ADD:
                out.append((dest, val(forms[0])))
            else:
                x = mem[bases[S] + prog.family.table_base]
                out.append((dest, R_CARD * R_CARD * pow(x, -1, P) % P if x else 0))
        for (r, i), v in out:
            mem[bases[r] + i] = v


def add_cases(fam: Family, n: int, mem: dict, work: int) -> list:
    """The case of each of ``n`` adds whose ``add_a`` ran with its work at
    ``work``, as the kernels decide it: "copy_y" (the first operand is
    infinite: the second is the sum), "copy_x" (the second is), "dbl" (P +
    P) or None (the generic formula; P + (-P) gives its Z3 = 0). G1 tests
    the first operand first, G2 the second (the plain versions' order)."""
    f, geo = FIELD[fam.name], ADD_GEOMETRY[fam.name]
    out = []
    for j in range(n):
        base = work + j * geo["work"]
        zero = {k: all(mem[base + geo[k] + i] == 0 for i in range(f.n)) for k in ADD_FLAGS}
        order = (("inf1", "copy_y"), ("inf2", "copy_x"))
        case = None
        for k, c in (order if fam is G1 else order[::-1]):
            if zero[k]:
                case = c
                break
        if case is None and zero["same_x"] and zero["same_y"]:
            case = "dbl"
        out.append(case)
    return out


def simulate_add(fam: Family, n: int, mem: dict, bases: dict) -> list:
    """n complete adds as the kernels run them (``csrc/curve_coop.cuh``
    cc_add): ``add_a``, the case tests, ``add_b`` unless a case holds in
    place (O = X), then each case's fix: a copy or ``dbl1`` of X."""
    simulate(fam.programs[f"{fam.name}_add_a{n}"], mem, bases)
    cases = add_cases(fam, n, mem, bases[Z])
    in_place = bases[O] == bases[X]
    assert n == 1 or not in_place
    if not (in_place and any(cases)):
        simulate(fam.programs[f"{fam.name}_add_b{n}"], mem, bases)
    pt = 3 * FIELD[fam.name].n
    for j, case in enumerate(cases):
        o = bases[O] + j * pt
        if case == "copy_y":
            for k in range(pt):
                mem[o + k] = mem[bases[Y] + j * pt + k]
        elif case == "copy_x":
            for k in range(pt):
                mem[o + k] = mem[bases[X] + k]
        elif case == "dbl":
            simulate(fam.programs[f"{fam.name}_dbl1"], mem, {**bases, O: o})
    return cases


def simulate_g2_affine(mem: dict, bases: dict) -> None:
    """K14's affine step as the kernel runs it (``csrc/h2c.cu``):
    ``g2_affine_a``; on one thread the norm's inverse, the binary GCD of its
    Montgomery words times R^3 (x R -> x^-1 R); ``g2_affine_b``."""
    simulate(G2.programs["g2_affine_a"], mem, bases)
    norm = mem[bases[Z] + AFFINE_NORM]
    mem[bases[Z] + AFFINE_INV] = mont(gcd_inverse(norm)[0], R_CARD ** 3 % P)
    simulate(G2.programs["g2_affine_b"], mem, bases)


def simulate_inverse_gcd(mem: dict, bases: dict) -> None:
    """K20's Fq12 inverse as the kernel runs it (``csrc/final_exp_gt.cu``):
    ``inv_a``; on one thread the binary GCD of the norm's Montgomery words
    times R^3 (x R -> x^-1 R); ``inv_b``."""
    simulate(FQ12.programs["inv_a"], mem, bases)
    norm = mem[bases[Z] + INV_NORM]
    mem[bases[Z] + INV_INV] = mont(gcd_inverse(norm)[0], R_CARD ** 3 % P)
    simulate(FQ12.programs["inv_b"], mem, bases)


def stats(family: Family = FQ12) -> dict:
    """Per program: rounds by kind, products, the widest sum."""
    out = {}
    for name, p in family.programs.items():
        kinds = [k for k, _ in p.rounds]
        out[name] = dict(
            rounds=len(kinds), product_rounds=kinds.count(PRODUCT), add_rounds=kinds.count(ADD),
            inverse_rounds=kinds.count(INVERSE),
            products=sum(len(i) for k, i in p.rounds if k == PRODUCT),
            widest=max(len(i) for _, i in p.rounds), scratch=p.scratch,
            max_terms=max(len(f) for _, i in p.rounds for _, fs in i for f in fs))
    return out


# ------------------------------------------------------------------- header --


def _terms(f: dict) -> list:
    """A sum's terms: slot | region << 9 | coefficient (4-bit signed) << 12,
    a coefficient above MAX_COEF split over several terms of its slot."""
    out = []
    for (region, idx), c in sorted(f.items()):
        while c:
            step = max(-MAX_COEF, min(MAX_COEF, c))
            out.append(idx | (region << 9) | ((step & 0xF) << 12))
            c -= step
    return out


FAMILY_ID = {"fq12": 0, "g1": 1, "g2": 2}
_SUFFIX = {"fq12": "", "g1": "_G1", "g2": "_G2"}


def _rows(vals, per, fmt):
    return ",\n".join("    " + ", ".join(fmt(v) for v in vals[i:i + per])
                      for i in range(0, len(vals), per))


def _family_text(fam: Family) -> list:
    """One family's lines: its geometry, op enum, op table, program table
    and constants. The program table is u16: the rounds (two u16 each:
    first | count << 16 | kind << 24, first the index of the round's first
    instruction offset), the instruction offsets (each the index of its
    code), the code (dest, terms of L, terms of R, the terms); every index
    counts u16 from the table's start."""
    progs = list(fam.programs.values())
    n_rounds = sum(len(p.rounds) for p in progs)
    n_insns = sum(len(i) for p in progs for _, i in p.rounds)
    rounds, insn_off, code, ops = [], [], [], []
    code_at = 2 * n_rounds + n_insns
    for p in progs:
        ops.append((p.name, len(rounds), len(p.rounds)))
        for kind, insns in p.rounds:
            rounds.append((2 * n_rounds + len(insn_off)) | (len(insns) << 16) | (kind << 24))
            for dest, forms in insns:
                insn_off.append(code_at + len(code))
                terms = [_terms(f) for f in forms]
                assert len(terms[0]) < 256 and (len(terms) < 2 or len(terms[1]) < 256)
                code += [_terms({dest: 1})[0] & 0xFFF, len(terms[0]),
                         len(terms[1]) if len(terms) > 1 else 0]
                code += [t for ts in terms for t in ts]
    round_words = [h for r in rounds for h in (r & 0xFFFF, r >> 16)]
    table = round_words + insn_off + code
    assert len(table) < 1 << 16 and 2 * n_rounds + n_insns == len(round_words) + len(insn_off)
    table += [0] * (len(table) % 2)
    sfx, fid = _SUFFIX[fam.name], FAMILY_ID[fam.name]
    const_words = [(v >> (32 * k)) & 0xFFFFFFFF for _, v in fam.consts for k in range(12)]
    enum = "CoopOp" if fam is FQ12 else f"Coop{fam.name.upper()}Op"
    lines = [
        f"// family {fam.name}: {len(progs)} programs, {n_rounds} rounds",
        f"template <> struct CoopFam<{fid}> {{",
        f"  static constexpr int kConsts = {len(fam.consts)};",
        f"  static constexpr int kTable = {fam.table_base};  // S slots of x^1..x^15",
        f"  static constexpr int kSlots = {fam.slots};  // S slots a group needs",
        f"  static constexpr int kMaxWidth = {fam.max_width};  // instructions a round, at most",
        f"  static constexpr int kTableWords = {len(table) // 2};  // u32 words of its table",
        "};",
        f"enum {enum} : int {{",
        *[f"  kOp_{name} = {i}," for i, (name, _, _) in enumerate(ops)],
        "};",
        *[f"constexpr int kC{sfx}_{name} = {i};" for name, i in fam.const_slot.items()],
        f"__constant__ uint16_t COOP_OPS{sfx}[][2] = {{",
        _rows([f"{{{a}, {b}}}" for _, a, b in ops], 6, str),
        "};",
        f"__device__ const uint16_t COOP_TABLE{sfx}[] = {{",
        _rows(table, 10, lambda v: f"0x{v:04x}"),
        "};",
        f"__constant__ uint32_t COOP_CONST_WORDS{sfx}[{len(fam.consts)} * 12] = {{",
        _rows(const_words, 6, lambda v: f"0x{v:08x}u"),
        "};",
    ]
    if fam.name in ADD_GEOMETRY:
        geo = ADD_GEOMETRY[fam.name]
        up = fam.name.upper()
        # each program's widest product round and widest add round: a kernel
        # that runs an op on L lanes a product asserts L * products <= its threads
        lines += [f"constexpr int kProducts_{p.name} = "
                  f"{max([len(i) for k, i in p.rounds if k == PRODUCT], default=0)}, "
                  f"kSums_{p.name} = {max([len(i) for k, i in p.rounds if k == ADD], default=0)};"
                  for p in progs]
        lines += [f"constexpr int k{up}Elem = {FIELD[fam.name].n};  // slots an element",
                  f"constexpr int k{up}AddWork = {geo['work']};  // work slots an add"]
        lines += [f"constexpr int k{up}Flag_{k} = {geo[k]};" for k in ADD_FLAGS]
    if fam is FQ12:
        lines += [f"constexpr int kInvNorm = {INV_NORM}, kInvInv = {INV_INV};"
                  "  // Z slots of K20's inverse, taken between inv_a and inv_b",
                  f"constexpr int kInvWork = {INV_INV + 1};  // Z slots inv_a and inv_b use"]
    if fam is G2:
        assert AFFINE_INV < ADD_GEOMETRY["g2"]["work"]  # K14 runs the affine step on an add's work
        lines += [f"constexpr int kG2AffineNorm = {AFFINE_NORM}, kG2AffineInv = {AFFINE_INV};"
                  "  // Z slots of the affine step's inverse"]
    return lines + [""]


def header_text() -> str:
    lines = [
        "// Generated by eth_consensus_specs_tpu_torch/ops/fq12_coop.py at build time.",
        "// The programs of the cooperative round engine (fp12_coop.cuh): see that",
        "// module for their rounds, and tests/test_torch_fq12_coop.py and",
        "// tests/test_torch_curve_coop.py for the checks.",
        "#pragma once",
        "#include <cstdint>",
        "",
        "constexpr int kFamFq12 = 0, kFamG1 = 1, kFamG2 = 2;",
        "template <int F> struct CoopFam;",
        f"constexpr uint64_t kCoopTopInv = 0x{(1 << 64) // ((P >> 352) + 1):x}ull;"
        "  // floor(2^64 / (p's top word + 1))",
        "// K17's scalar split: lambda (128 bits) and r, little-endian words",
        "__constant__ uint32_t GLV_LAMBDA_WORDS[4] = {"
        + ", ".join(f"0x{(GLV_LAMBDA >> (32 * k)) & 0xFFFFFFFF:08x}u" for k in range(4)) + "};",
        "__constant__ uint32_t FR_R_WORDS[8] = {"
        + ", ".join(f"0x{(R >> (32 * k)) & 0xFFFFFFFF:08x}u" for k in range(8)) + "};",
        "",
    ]
    for fam in FAMILIES:
        lines += _family_text(fam)
    lines += [
        "// the tower's names, as K11 and K12 use them",
        f"constexpr int kCoopConsts = {len(CONSTS)};",
        f"constexpr int kCoopTable = {TABLE_BASE};  // S slots of x^1..x^15",
        f"constexpr int kCoopSlots = {SLOTS};  // S slots a group needs",
        f"constexpr int kCoopMaxWidth = {MAX_WIDTH};  // instructions a round, at most",
        "constexpr int kCoopTableWords = CoopFam<kFamFq12>::kTableWords;",
        "",
    ]
    return "\n".join(lines)
