"""The cooperative Fq12 tower's programs (``ops/fq12_coop.py``, the tables
of the generated ``fp12_coop_ops.cuh`` that K11 and K12 run) without a card.

Each program is run on host ints exactly as the card runs it
(``fq12_coop.simulate``: Montgomery products, signed sums, the Fermat
inverse), from the Montgomery form of random elements made from a seed with
numpy, and held against the port's host tower and the JAX package's host
oracle; in place (output over the first input) as the kernels use them, and
apart. The build must write the generator's output as the header and
rebuild when it changes, no round may be wider than a group, and the check
entry's plain version (``pairing_device.fq12_coop_check_ref``) must equal
the host tower too.
"""

import numpy as np
import pytest
import torch

from eth_consensus_specs_tpu.crypto import fields as jf
from eth_consensus_specs_tpu_torch.crypto.fields import P, Fq12
from eth_consensus_specs_tpu_torch.ops import field_limbs as fl
from eth_consensus_specs_tpu_torch.ops import fq12_coop as coop
from eth_consensus_specs_tpu_torch.ops import pairing_device as pd

R = coop.R_CARD
RINV = pow(R, -1, P)
X0, Y0, Z0, O0 = 1000, 2000, 3000, 4000


def _ints(seed: int, n: int) -> list:
    rng = np.random.default_rng(seed)
    return [int.from_bytes(rng.bytes(48), "little") % P for _ in range(n)]


def _jax(f: Fq12):
    c = f.ints()
    e = [jf.Fq2.from_ints(c[2 * i], c[2 * i + 1]) for i in range(6)]
    return jf.Fq12(jf.Fq6(*e[:3]), jf.Fq6(*e[3:]))


def _jax_ints(jx) -> list:
    return [c.n for half in (jx.c0, jx.c1) for e in (half.c0, half.c1, half.c2)
            for c in (e.c0, e.c1)]


def _run(name: str, x: list, y: list = (), z: list = (), in_place: bool = False,
         mont: bool = True) -> tuple:
    """Run program ``name`` on X = x, Y = y, Z = z (Montgomery forms of the
    values unless ``mont`` is false); the output's values and the memory."""
    mem = {i: v for i, (_, v) in enumerate(coop.CONSTS)}
    bases = {coop.X: X0, coop.Y: Y0, coop.Z: Z0, coop.O: X0 if in_place else O0, coop.S: 0}
    for base, vals in ((X0, x), (Y0, y), (Z0, z)):
        for k, v in enumerate(vals):
            mem[base + k] = v * R % P if mont else v
    coop.simulate(coop.PROGRAMS[name], mem, bases)
    out = [mem[bases[coop.O] + k] * RINV % P for k in range(12)] if name != "prep" else []
    return out, mem


def _cyclotomic(seed: int) -> Fq12:
    f = Fq12.from_ints(_ints(seed, 12))
    t = f.conjugate() * f.inv()
    return t.frobenius().frobenius() * t


@pytest.mark.parametrize("in_place", [False, True])
@pytest.mark.parametrize("seed", [0, 1])
def test_products_and_squarings(seed, in_place):
    a, b = Fq12.from_ints(_ints(seed, 12)), Fq12.from_ints(_ints(seed + 10, 12))
    assert _run("mul", a.ints(), b.ints(), in_place=in_place)[0] == (a * b).ints()
    assert _run("mulc", a.ints(), b.ints(), in_place=in_place)[0] == (a * b.conjugate()).ints()
    assert _run("sqr", a.ints(), in_place=in_place)[0] == _jax_ints(_jax(a).square())
    m = _cyclotomic(seed)
    assert _run("cyc", m.ints(), in_place=in_place)[0] == _jax_ints(_jax(m).square())


@pytest.mark.parametrize("in_place", [False, True])
def test_frobenius_conjugate_and_inverse(in_place):
    a = Fq12.from_ints(_ints(3, 12))
    assert _run("frob", a.ints(), in_place=in_place)[0] == a.frobenius().ints()
    assert _run("frob2", a.ints(), in_place=in_place)[0] == a.frobenius().frobenius().ints()
    assert _run("conj", a.ints(), in_place=in_place)[0] == a.conjugate().ints()
    assert _run("inv", a.ints(), in_place=in_place)[0] == _jax_ints(_jax(a).inv())
    assert _run("inv", [0] * 12, in_place=in_place)[0] == [0] * 12  # 0 keeps K12's verdict


@pytest.mark.parametrize("convert", [False, True])
def test_line_product(convert):
    f = Fq12.from_ints(_ints(4, 12))
    py, a3, a5, nxt = _ints(5, 1)[0], _ints(6, 2), _ints(7, 2), _ints(8, 4)
    line = Fq12.from_ints([py, 0, 0, 0, 0, 0, 0, 0] + a3 + a5)  # py + a3 w^3 + a5 w^5
    npx = _ints(9, 1)[0]
    name = "line_conv" if convert else "line"
    # this step's a3, a5 in Montgomery form, the next step's words canonical;
    # py in Montgomery form and -px R^2, as the prologue leaves them
    mem = {i: v for i, (_, v) in enumerate(coop.CONSTS)}
    bases = {coop.X: X0, coop.Y: Y0, coop.Z: Z0, coop.O: X0, coop.S: 0}
    for k, v in enumerate(f.ints()):
        mem[X0 + k] = v * R % P
    for k, v in enumerate([v * R % P for v in a3 + a5] + nxt):
        mem[Y0 + k] = v
    mem[Z0], mem[Z0 + 1] = py * R % P, (-npx) * R * R % P
    coop.simulate(coop.PROGRAMS[name], mem, bases)
    assert [mem[X0 + k] * RINV % P for k in range(12)] == (f * line).ints()
    want_next = ([v * R % P for v in nxt[:2]] + [v * (-npx) * R % P for v in nxt[2:]]
                 if convert else nxt)
    assert [mem[Y0 + 4 + k] for k in range(4)] == want_next


@pytest.mark.parametrize("convert", [False, True])
def test_fused_doubling_step(convert):
    """sqr_line(_conv) is sqr then line(_conv) in one program."""
    f = Fq12.from_ints(_ints(15, 12))
    py, a3, a5, nxt = _ints(16, 1)[0], _ints(17, 2), _ints(18, 2), _ints(19, 4)
    line = Fq12.from_ints([py, 0, 0, 0, 0, 0, 0, 0] + a3 + a5)
    npx = _ints(20, 1)[0]
    mem = {i: v for i, (_, v) in enumerate(coop.CONSTS)}
    bases = {coop.X: X0, coop.Y: Y0, coop.Z: Z0, coop.O: X0, coop.S: 0}
    for k, v in enumerate(f.ints()):
        mem[X0 + k] = v * R % P
    for k, v in enumerate([v * R % P for v in a3 + a5] + nxt):
        mem[Y0 + k] = v
    mem[Z0], mem[Z0 + 1] = py * R % P, (-npx) * R * R % P
    coop.simulate(coop.PROGRAMS["sqr_line_conv" if convert else "sqr_line"], mem, bases)
    assert [mem[X0 + k] * RINV % P for k in range(12)] == (f * f * line).ints()
    want_next = ([v * R % P for v in nxt[:2]] + [v * (-npx) * R % P for v in nxt[2:]]
                 if convert else nxt)
    assert [mem[Y0 + 4 + k] for k in range(4)] == want_next


def test_prep_load_and_store():
    px, py, co = _ints(11, 1)[0], _ints(12, 1)[0], _ints(13, 4)
    _, mem = _run("prep", [], co, [py, px], mont=False)
    assert mem[Z0] == py * R % P and mem[Z0 + 1] == (-px) * R * R % P
    assert [mem[Y0 + k] for k in range(4)] == ([v * R % P for v in co[:2]]
                                                + [v * (-px) * R % P for v in co[2:]])
    vals = _ints(14, 12)
    _, mem = _run("load", vals, mont=False)
    assert [mem[O0 + k] for k in range(12)] == [v * R % P for v in vals]
    _, mem = _run("store", vals)
    assert [mem[O0 + k] for k in range(12)] == vals


def test_round_shapes():
    """The products a round and the rounds each operation takes, as the
    kernels' notes and the bounds count them."""
    st = coop.stats()
    products = {name: st[name]["products"] for name in
                ("mul", "sqr", "cyc", "line", "frob", "frob2")}
    assert products == {"mul": 54, "sqr": 36, "cyc": 18, "line": 48, "frob": 18, "frob2": 12}
    assert st["line_conv"]["products"] == 52 and st["inv"]["inverse_rounds"] == 1
    # K20's inverse: the same rounds around an Fq inverse the kernel takes itself
    assert st["inv_a"]["inverse_rounds"] == st["inv_b"]["inverse_rounds"] == 0
    assert all(s["product_rounds"] == 1 for n, s in st.items()
               if n not in ("inv", "inv_a", "inv_b", "prep", "conj", "sqr_line", "sqr_line_conv"))
    assert st["sqr_line"]["rounds"] == 4 and st["line"]["rounds"] == 2  # K11's steps
    assert st["cyc"]["rounds"] == 2
    assert coop.SLOTS <= coop.MAX_SLOT
    assert max(s["widest"] for s in st.values()) <= coop.MAX_WIDTH
    assert f"constexpr int kCoopMaxWidth = {coop.MAX_WIDTH};" in coop.header_text()


def test_round_wider_than_a_group_is_refused():
    pg = coop.Program("wide")
    pg.products()
    for i in range(coop.MAX_WIDTH + 1):
        pg.mul(coop.F((coop.X, i)), coop.F((coop.Y, i)), dest=(coop.O, i))
    pg.close()
    with pytest.raises(AssertionError, match="a group runs"):
        pg.finish()
    pg = coop.Program("wide_sums")
    pg.adds([coop.F((coop.X, i)) for i in range(coop.MAX_WIDTH + 1)],
            dests=[(coop.O, i) for i in range(coop.MAX_WIDTH + 1)])
    with pytest.raises(AssertionError, match="a group runs"):
        pg.finish()


def test_header_is_the_generators_output(tmp_path, monkeypatch):
    """The build writes the generator's header into its include directory,
    and a change of the programs changes every kernel's digest."""
    from eth_consensus_specs_tpu_torch import _ext

    monkeypatch.setattr(_ext, "BUILD_DIR", tmp_path)
    inc = _ext.write_generated()
    assert (inc / "fp12_coop_ops.cuh").read_text() == coop.header_text()
    before = _ext._digest("miller")
    monkeypatch.setattr(_ext, "generated",
                        lambda: {"fp12_coop_ops.cuh": coop.header_text() + "// changed\n"})
    assert _ext._digest("miller") != before


def test_check_entry_plain_version_equals_the_host():
    n = 2
    a = [Fq12.from_ints(_ints(20 + i, 12)) for i in range(n)]
    b = [Fq12.from_ints(_ints(30 + i, 12)) for i in range(n)]
    lines = [_ints(40 + i, 5) for i in range(n)]

    def words(vals):
        return torch.from_numpy(fl.ints_to_words(vals))

    out = pd.fq12_coop_check(words([x.ints() for x in a]).reshape(n, 2, 3, 2, 12),
                             words([x.ints() for x in b]).reshape(n, 2, 3, 2, 12),
                             words(lines), reps=2)
    assert tuple(out.shape) == (n, 4, 2, 3, 2, 12)
    for i in range(n):
        py, *rest = lines[i]
        line = Fq12.from_ints([py, 0, 0, 0, 0, 0, 0, 0] + rest)
        got = [pd.fq12_from_words(out[i, k]) for k in range(4)]
        assert got[0] == a[i] * b[i] * b[i]
        assert got[1] == a[i].square().square()
        assert got[3] == a[i] * line * line
    with pytest.raises(ValueError):
        pd.fq12_coop_check(out[:, 0], out[:, 0], words(lines), lanes=3)

