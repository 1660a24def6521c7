"""The programs of the cooperative Fq12 tower (``csrc/fp12_coop.cuh``).

K11 and K12 run their Fq12 arithmetic on a group of threads that keeps its
values in shared memory, one Fq element a *slot* (12 words, word-major:
word k of slot j at ``k * stride + j``). Every tower operation is a short
program of *rounds* separated by the group's barrier:

* a product round: each instruction is one Montgomery product L * R, where
  L and R are small signed sums of slots (Karatsuba's operand sums, xi and
  v folded in); one thread (or a few lanes) an instruction;
* an add round: each instruction writes one signed sum of slots (the
  Karatsuba recombinations), one thread an instruction;
* an inverse round: one Fq inverse, a 4-bit-window Fermat chain over a
  table of the 15 small powers that the rounds before it fill.

This module builds those programs once, from the tower's formulas (the host
oracle's, ``crypto/fields.py``: Fq2 = Fq[u]/(u^2+1), Fq6 = Fq2[v]/(v^3 -
xi), Fq12 = Fq6[w]/(w^2 - v), xi = 1 + u, an Fq12 at [half][v][u]), allots
the scratch slots by liveness, checks that no round reads a slot another
thread of the same round writes and that no round is wider than a group
runs, and renders the tables as the header ``fp12_coop_ops.cuh``, which
``_ext`` writes into its build directory before ``nvcc`` runs: this module
is the one copy of the programs. ``simulate`` runs a program on host ints
exactly as the card does, which is how the CPU tests hold the tables to the
plain tower without a card.

Slots are named by region and index: X, Y, Z are an operation's inputs, O
its output (which may be X itself: in place), S the group's own area:
constants, the inverse's power table, then scratch.
"""

from __future__ import annotations

from ..crypto.fields import FROB2_GAMMA, FROB_GAMMA, P

R_CARD = 1 << 384  # the card's Montgomery radix (csrc/bls_fp.cuh)
X, Y, Z, O, S = range(5)
ADD, PRODUCT, INVERSE = range(3)
MAX_COEF = 7  # a term's coefficient is a 4-bit signed field
MAX_WEIGHT = 63  # sum of |coef| of one sum: its value stays under 64 p
MAX_SLOT = 511
# instructions a round: every kernel's group runs this many products at once
# (threads / lanes) and as many sums (threads); the header states it, and
# each kernel asserts that its group has the room
MAX_WIDTH = 64

# S: constants, then the inverse's table x^1..x^15, then scratch
CONSTS = ([("mont_one", R_CARD % P), ("raw_one", 1), ("r2", R_CARD * R_CARD % P),
           ("r3", R_CARD ** 3 % P)]
          + [(f"frob1_{i}_{u}", (g.c0.n, g.c1.n)[u] * R_CARD % P)
             for i, g in enumerate(FROB_GAMMA) for u in range(2)]
          + [(f"frob2_{i}", g.c0.n * R_CARD % P) for i, g in enumerate(FROB2_GAMMA)])
CONST_SLOT = {name: i for i, (name, _) in enumerate(CONSTS)}
TABLE_BASE = len(CONSTS)
SCRATCH_BASE = TABLE_BASE + 15


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

    def __init__(self, name: str):
        self.name = name
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

    def inverse(self, dest=None) -> dict:
        """x^-1 of the table's x (S[TABLE_BASE]), after ``table`` filled it."""
        ref = dest or self._value()
        self.rounds.append((INVERSE, [(ref, [F((S, TABLE_BASE))])]))
        return F(ref)

    def table(self, x: dict) -> None:
        """S[TABLE_BASE + i - 1] = x^i for i = 1..15 (x^1 first, an add
        round; then x^2; x^3, x^4; x^5..x^8; x^9..x^15)."""
        t = [None] + self.adds([x], [(S, TABLE_BASE)])
        for lo, hi in ((2, 2), (3, 4), (5, 8), (9, 15)):
            self.products()
            for i in range(lo, hi + 1):
                t.append(self.mul(t[lo - 1], t[i - lo + 1], (S, TABLE_BASE + i - 1)))
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
                where[ref] = (S, SCRATCH_BASE + len(slots))
                slots.append([SCRATCH_BASE + len(slots), last[ref]])

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
        MAX_WIDTH instructions; sums within the interpreter's limits."""
        for r, (kind, insns) in enumerate(self.rounds):
            assert len(insns) <= MAX_WIDTH, (
                f"{self.name} round {r}: {len(insns)} instructions, a group runs {MAX_WIDTH}")
            alias = [(X if d[0] == O else d[0], d[1]) for d, _ in insns]
            assert len(set(alias)) == len(alias), f"{self.name} round {r}: a slot written twice"
            for i, (d, forms) in enumerate(insns):
                assert d[0] in (O, S, Y, Z) and d[1] <= MAX_SLOT
                assert kind == PRODUCT or len(forms) == 1
                for f in forms:
                    assert f, f"{self.name} round {r}: an empty sum"
                    assert sum(abs(c) for c in f.values()) <= MAX_WEIGHT
                    for ref, c in f.items():
                        assert abs(c) <= MAX_COEF and ref[1] <= MAX_SLOT
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


def _level(pg: Program, groups: list) -> list:
    """Materialize lists of Fq2 forms in one add round; the same nesting
    back, each form a slot."""
    refs = iter(pg.adds([c for g in groups for e in g for c in e]))
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


def build_inverse() -> Program:
    """O = X^-1 (``csrc/bls_fp.cuh`` fp12_inv, fp6_inv, fp2_inv): the halves'
    squares, t = a0^2 - v a1^2, t's Fq6 inverse down to one Fq inverse of
    d0^2 + d1^2, then a0 t^-1 and -a1 t^-1."""
    pg = Program("inv")
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
    tt = _level(pg, [[sub2(q[0], xi2(q[1])), sub2(xi2(q[2]), q[3]), sub2(q[4], q[5])]])[0]
    pg.products()
    dd = [pg.fq2_mul(c0, tt[0]), pg.fq2_mul(c2, tt[1]), pg.fq2_mul(c1, tt[2])]
    pg.close()
    d = _level(pg, [[add2(dd[0], xi2(add2(dd[1], dd[2])))]])[0][0]
    pg.products()
    n0, n1 = pg.mul(d[0], d[0]), pg.mul(d[1], d[1])
    pg.close()
    pg.table(add(n0, n1))
    ninv = pg.inverse()
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
    return pg.finish()


def build_all() -> dict:
    progs = [build_scale("load", "r2"), build_scale("store", "raw_one"),
             build_scale("canon", "mont_one"), build_mul(),
             build_mul(conj_b=True), build_sqr(), build_cyclotomic_sqr(), build_line(False),
             build_line(True), build_sqr_line(False), build_sqr_line(True), build_prep(),
             build_frobenius(), build_frobenius2(),
             build_conj(), build_inverse()]
    return {p.name: p for p in progs}


PROGRAMS = build_all()
SCRATCH = max(p.scratch for p in PROGRAMS.values())
SLOTS = SCRATCH_BASE + SCRATCH  # S slots a group needs


# ----------------------------------------------------------------- simulate --


def mont(a: int, b: int) -> int:
    return a * b * pow(R_CARD, -1, P) % P


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
                x = mem[bases[S] + TABLE_BASE]
                out.append((dest, R_CARD * R_CARD * pow(x, -1, P) % P if x else 0))
        for (r, i), v in out:
            mem[bases[r] + i] = v


def stats() -> dict:
    """Per program: rounds by kind, products, the widest sum."""
    out = {}
    for name, p in PROGRAMS.items():
        kinds = [k for k, _ in p.rounds]
        out[name] = dict(
            rounds=len(kinds), product_rounds=kinds.count(PRODUCT), add_rounds=kinds.count(ADD),
            inverse_rounds=kinds.count(INVERSE),
            products=sum(len(i) for k, i in p.rounds if k == PRODUCT),
            widest=max(len(i) for _, i in p.rounds), scratch=p.scratch,
            max_terms=max(len(f) for _, i in p.rounds for _, fs in i for f in fs))
    return out


# ------------------------------------------------------------------- header --


def _term(ref, coef: int = 0) -> int:
    region, idx = ref
    return idx | (region << 9) | ((coef & 0xF) << 12)


def header_text() -> str:
    code, insn_off, rounds, ops = [], [], [], []
    for name, p in PROGRAMS.items():
        ops.append((name, len(rounds), len(p.rounds)))
        for kind, insns in p.rounds:
            rounds.append(len(insn_off) | (len(insns) << 16) | (kind << 24))
            for dest, forms in insns:
                insn_off.append(len(code))
                terms = [[_term(ref, c) for ref, c in sorted(f.items())] for f in forms]
                code += [_term(dest), len(terms[0]), len(terms[1]) if len(terms) > 1 else 0]
                code += [t for ts in terms for t in ts]
    assert len(code) < 1 << 16 and len(insn_off) < 1 << 16

    def rows(vals, per, fmt):
        return ",\n".join("    " + ", ".join(fmt(v) for v in vals[i:i + per])
                          for i in range(0, len(vals), per))

    const_words = [(v >> (32 * k)) & 0xFFFFFFFF for _, v in CONSTS for k in range(12)]
    # one table of u16: the rounds (two u16 each), the instruction offsets,
    # the code; the kernels copy it into shared memory
    round_words = [h for r in rounds for h in (r & 0xFFFF, r >> 16)]
    table = round_words + insn_off + code
    table += [0] * (len(table) % 2)
    insn_at, code_at = len(round_words), len(round_words) + len(insn_off)
    lines = [
        "// Generated by eth_consensus_specs_tpu_torch/ops/fq12_coop.py at build time.",
        "// The programs of the cooperative Fq12 tower (fp12_coop.cuh): see that",
        "// module for their rounds, and tests/test_torch_fq12_coop.py for the checks.",
        "#pragma once",
        "#include <cstdint>",
        "",
        f"constexpr int kCoopConsts = {len(CONSTS)};",
        f"constexpr int kCoopTable = {TABLE_BASE};  // S slots of x^1..x^15",
        f"constexpr int kCoopSlots = {SLOTS};  // S slots a group needs",
        f"constexpr int kCoopMaxWidth = {MAX_WIDTH};  // instructions a round, at most",
        f"constexpr uint64_t kCoopTopInv = 0x{(1 << 64) // ((P >> 352) + 1):x}ull;"
        "  // floor(2^64 / (p's top word + 1))",
        f"constexpr int kCoopInsnAt = {insn_at};  // COOP_TABLE: rounds at 0, then",
        f"constexpr int kCoopCodeAt = {code_at};  // instruction offsets, then code",
        f"constexpr int kCoopTableWords = {len(table) // 2};  // u32 words of COOP_TABLE",
        "",
        "enum CoopOp : int {",
        *[f"  kOp_{name} = {i}," for i, (name, _, _) in enumerate(ops)],
        "};",
        "",
        "enum CoopSlot : int {",
        *[f"  kC_{name} = {i}," for name, i in CONST_SLOT.items()],
        "};",
        "",
        "// [first round, rounds] of each op",
        "__constant__ uint16_t COOP_OPS[][2] = {",
        rows([f"{{{a}, {b}}}" for _, a, b in ops], 6, str),
        "};",
        "// a round: first instruction | count << 16 | kind << 24 (0 add, 1 product,",
        "// 2 inverse), as two u16; an instruction: dest, terms of L, terms of R, the",
        "// terms; a term: slot | region << 9 | coefficient (4-bit signed) << 12",
        "__device__ const uint16_t COOP_TABLE[] = {",
        rows(table, 10, lambda v: f"0x{v:04x}"),
        "};",
        "// the S constants' words, in order (Montgomery form but raw_one, r2, r3)",
        "__constant__ uint32_t COOP_CONST_WORDS[kCoopConsts * 12] = {",
        rows(const_words, 6, lambda v: f"0x{v:08x}u"),
        "};",
        "",
    ]
    return "\n".join(lines)
