"""The port's plain Fq, Fq2, Fq6 and Fq12 arithmetic against the JAX package.

Same inputs, made from a seed, go through the port's torch tower
(``ops/field_limbs``, ``ops/fq12_tower``) and through the JAX package's host
oracle (``crypto/fields``) and its lazy-limb device arithmetic
(``ops/lazy_limbs``, ``ops/fq12_tower``, run eagerly on the CPU); results are
compared as canonical ints, exactly. The constants of the CUDA header
``csrc/bls_fp.cuh`` and the Miller schedule of ``csrc/miller.cu`` are
recomputed here from their definitions, and so are those of
``csrc/g2_jac.cuh`` and ``csrc/h2c.cu`` (hash-to-G2, K13 and K14) from the
JAX package's curve and ciphersuite.
"""

import random
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from eth_consensus_specs_tpu.crypto import fields as jf
from eth_consensus_specs_tpu.ops import field_limbs as jfl
from eth_consensus_specs_tpu.ops import fq12_tower as jtw
from eth_consensus_specs_tpu.ops import lazy_limbs as jlz
from eth_consensus_specs_tpu_torch import convert
from eth_consensus_specs_tpu_torch.crypto import fields as pf
from eth_consensus_specs_tpu_torch.ops import field_limbs as fl
from eth_consensus_specs_tpu_torch.ops import fq12_tower as tw
from eth_consensus_specs_tpu_torch.ops import pairing_device as pd

P = jf.P
CSRC = Path(__file__).resolve().parents[1] / "eth_consensus_specs_tpu_torch" / "csrc"
CORNERS = [0, 1, P - 1, (2**381 - 1) % P, 2, P - 2]


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    # the plain versions are many small ops: one intra-op thread is fastest
    # and keeps parallel test workers from oversubscribing the cores
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _values(seed: int, n: int) -> list[int]:
    rng = random.Random(seed)
    return CORNERS + [rng.randrange(P) for _ in range(n)]


def test_fq_ops_match_the_host_field():
    xs = _values(1, 40)
    ys = list(reversed(_values(2, 40)))
    a, b = fl.from_ints(xs), fl.from_ints(ys)
    assert fl.to_ints(fl.mul(a, b)) == [(jf.Fq(x) * jf.Fq(y)).n for x, y in zip(xs, ys)]
    assert fl.to_ints(fl.add(a, b)) == [(jf.Fq(x) + jf.Fq(y)).n for x, y in zip(xs, ys)]
    assert fl.to_ints(fl.sub(a, b)) == [(jf.Fq(x) - jf.Fq(y)).n for x, y in zip(xs, ys)]
    assert fl.to_ints(fl.neg(a)) == [(-jf.Fq(x)).n for x in xs]
    assert fl.to_ints(fl.sqr(a)) == [jf.Fq(x).square().n for x in xs]
    # a long loose chain, brought back by norm, still reduces exactly
    chain = fl.norm(fl.sub(fl.add(fl.add(a, b), fl.dbl(a)), fl.neg(b)))
    assert fl.to_ints(chain) == [(3 * x + 2 * y) % P for x, y in zip(xs, ys)]
    assert fl.eq(fl.add(a, b), fl.add(b, a)).all()
    assert fl.is_zero(fl.sub(a, a)).all()


def test_fq_inv_and_inv_of_zero():
    xs = _values(3, 6)
    got = fl.to_ints(fl.inv(fl.from_ints(xs)))
    assert got == [jf.Fq(x).inv().n if x else 0 for x in xs]
    jax_zero = jtw.fq_inv(jlz.lf(np.stack([jlz.to_mont(0)])))
    assert jlz.from_mont_int(np.asarray(jax_zero.v)[0]) == got[0] == 0


def test_fq_matches_the_jax_lazy_limbs():
    xs, ys = _values(4, 12), _values(5, 12)
    jx = jlz.lf(np.stack([jlz.to_mont(x) for x in xs]), val=P - 1)
    jy = jlz.lf(np.stack([jlz.to_mont(y) for y in ys]), val=P - 1)
    a, b = fl.from_ints(xs), fl.from_ints(ys)
    for port, jax in ((fl.mul(a, b), jlz.mul(jx, jy)), (fl.add(a, b), jlz.add(jx, jy)),
                      (fl.sub(a, b), jlz.sub(jx, jy))):
        assert fl.to_ints(port) == convert.ints_from_jax_limbs(np.asarray(jax.v), "lazy_limbs")


def test_convert_carries_both_jax_limb_layouts():
    xs = _values(6, 8)
    lazy = np.stack([jlz.to_mont(x) for x in xs])
    wide = np.stack([jfl.to_mont(x) for x in xs])
    assert convert.ints_from_jax_limbs(lazy, "lazy_limbs") == xs
    assert convert.ints_from_jax_limbs(wide, "field_limbs") == xs
    words = convert.words_from_jax_limbs(wide, "field_limbs")
    assert fl.to_ints(fl.from_words(torch.from_numpy(words))) == xs
    assert np.array_equal(fl.to_words(fl.from_ints(xs)).numpy(), words)


def _rand12(rng) -> pf.Fq12:
    return pf.Fq12.from_ints([rng.randrange(P) for _ in range(12)])


def _to_jax12(f: pf.Fq12) -> jf.Fq12:
    v = f.ints()
    e = [jf.Fq2.from_ints(v[2 * i], v[2 * i + 1]) for i in range(6)]
    return jf.Fq12(jf.Fq6(*e[:3]), jf.Fq6(*e[3:]))


def _jax12_ints(f: jf.Fq12) -> list[int]:
    return [c.n for half in (f.c0, f.c1) for e in (half.c0, half.c1, half.c2) for c in (e.c0, e.c1)]


def test_fq12_ops_match_the_host_tower():
    rng = random.Random(7)
    xs = [_rand12(rng) for _ in range(3)] + [pf.Fq12.from_ints([P - 1] * 12), pf.Fq12.one()]
    ys = [_rand12(rng) for _ in range(5)]
    a, b = tw.fq12_from_host(xs), tw.fq12_from_host(ys)
    jx, jy = [_to_jax12(x) for x in xs], [_to_jax12(y) for y in ys]
    cases = {
        "mul": (tw.fq12_mul(a, b), [x * y for x, y in zip(jx, jy)]),
        "sqr": (tw.fq12_sqr(a), [x * x for x in jx]),
        "conj": (tw.fq12_conj(a), [x.conjugate() for x in jx]),
        "frobenius": (tw.fq12_frobenius(a), [x.frobenius() for x in jx]),
        "frobenius2": (tw.fq12_frobenius2(a), [x.frobenius().frobenius() for x in jx]),
        "inv": (tw.fq12_inv(a), [x.inv() for x in jx]),
    }
    for name, (got, want) in cases.items():
        assert [g.ints() for g in tw.fq12_to_host(got)] == [_jax12_ints(w) for w in want], name


def test_fq12_matches_the_jax_device_tower():
    rng = random.Random(8)
    xs = [_rand12(rng) for _ in range(2)]
    ys = [_rand12(rng) for _ in range(2)]
    jx = jlz.lf(np.stack([jtw.fq12_to_limbs(_to_jax12(x)) for x in xs]), val=P - 1)
    jy = jlz.lf(np.stack([jtw.fq12_to_limbs(_to_jax12(y)) for y in ys]), val=P - 1)
    a, b = tw.fq12_from_host(xs), tw.fq12_from_host(ys)
    # eager JAX runs each limb op on its own: the product and the
    # conjugate here, the rest against the host tower above
    pairs = {
        "mul": (tw.fq12_mul(a, b), jtw.fq12_mul(jx, jy)),
        "conj": (tw.fq12_conj(a), jtw.fq12_conj(jx)),
    }
    for name, (port, jax) in pairs.items():
        want = convert.ints_from_jax_limbs(np.asarray(jax.v), "lazy_limbs")
        got = fl.to_ints(port)
        assert got == want, name


def test_fq2_and_fq6_ops_match_the_host_tower():
    rng = random.Random(9)
    x2 = [pf.Fq2.from_ints(rng.randrange(P), rng.randrange(P)) for _ in range(4)]
    y2 = [pf.Fq2.from_ints(rng.randrange(P), rng.randrange(P)) for _ in range(4)]
    a = fl.from_ints([[x.c0.n, x.c1.n] for x in x2])
    b = fl.from_ints([[y.c0.n, y.c1.n] for y in y2])

    def host2(vals):
        return [pf.Fq2.from_ints(*v) for v in vals]

    assert host2(fl.to_ints(tw.fq2_mul(a, b))) == [x * y for x, y in zip(x2, y2)]
    assert host2(fl.to_ints(tw.fq2_sqr(a))) == [x.square() for x in x2]
    assert host2(fl.to_ints(tw.fq2_inv(a))) == [x.inv() for x in x2]
    assert host2(fl.to_ints(tw.fq2_mul_xi(a))) == [x * pf.XI for x in x2]
    x6 = [pf.Fq6(*x2[:3]), pf.Fq6(*x2[1:])]
    y6 = [pf.Fq6(*y2[:3]), pf.Fq6(*y2[1:])]
    a6 = torch.stack([tw.fq6_from_host(e) for e in x6])
    b6 = torch.stack([tw.fq6_from_host(e) for e in y6])

    def host6(t):
        return [pf.Fq6(*host2(v)) for v in fl.to_ints(t)]

    assert host6(tw.fq6_mul(a6, b6)) == [x * y for x, y in zip(x6, y6)]
    assert host6(tw.fq6_inv(a6)) == [x.inv() for x in x6]
    assert host6(tw.fq6_mul_v(a6)) == [x.mul_by_xi_shift() for x in x6]


def test_powx_and_is_one():
    rng = random.Random(10)
    xs = [_rand12(rng), pf.Fq12.one()]
    got = tw.fq12_to_host(tw.fq12_powx(tw.fq12_from_host(xs)))
    want = [_to_jax12(x).pow(-jf.BLS_X).conjugate() for x in xs]
    assert [g.ints() for g in got] == [_jax12_ints(w) for w in want]
    flags = tw.fq12_is_one(tw.fq12_from_host(xs + [pf.Fq12.zero()]))
    assert flags.tolist() == [False, True, False]


def _header_array(text: str, name: str) -> list[int]:
    m = re.search(name + r"\[[^=]*=\s*(\{.*?\});", text, re.S)
    return [int(v, 16) for v in re.findall(r"0x([0-9a-f]+)u", m.group(1))]


def _words(x: int) -> list[int]:
    return [(x >> (32 * i)) & 0xFFFFFFFF for i in range(12)]


def test_cuda_header_constants():
    text = (CSRC / "bls_fp.cuh").read_text()
    r = 1 << 384
    assert _header_array(text, "FP_P") == _words(P)
    assert _header_array(text, "FP_R2") == _words(r * r % P)
    assert _header_array(text, "FP_ONE") == _words(r % P)
    assert _header_array(text, "FP_PM2") == _words(P - 2)
    np_ = int(re.search(r"FP_NP = 0x([0-9a-f]+)u", text).group(1), 16)
    assert np_ * P % (1 << 32) == (1 << 32) - 1  # -p^-1 mod 2^32
    g1 = [jf.XI.pow(i * (P - 1) // 6) for i in range(6)]
    g2 = [jf.XI.pow(i * (P * P - 1) // 6) for i in range(6)]
    assert _header_array(text, "FROB1") == [w for g in g1 for c in (g.c0, g.c1)
                                            for w in _words(c.n * r % P)]
    assert all(g.c1.n == 0 for g in g2)
    assert _header_array(text, "FROB2") == [w for g in g2 for w in _words(g.c0.n * r % P)]
    miller = (CSRC / "miller.cu").read_text()
    flags = re.search(r"SQR_FLAGS\[kSteps\] = \{(.*?)\};", miller, re.S).group(1)
    assert [int(v) for v in re.findall(r"\d", flags)] == pd._SQR_FLAGS.tolist()
    assert f"kSteps = {pd.N_STEPS};" in miller


def _mont2(a) -> list[int]:
    r = 1 << 384
    return _words(a.c0.n * r % P) + _words(a.c1.n * r % P)


def test_g2_cuda_constants():
    from eth_consensus_specs_tpu.crypto import hash_to_curve as jh2c
    from eth_consensus_specs_tpu.ops.g2_jacobian import BLS_X_ABS

    g2 = (CSRC / "g2_jac.cuh").read_text()
    psi = [jf.XI.pow((P - 1) // 3).inv(), jf.XI.pow((P - 1) // 2).inv()]
    assert _header_array(g2, "PSI_XY") == [w for c in psi for w in _mont2(c)]
    assert f"kBlsXAbs = 0x{BLS_X_ABS:x}ull" in g2
    h2c = (CSRC / "h2c.cu").read_text()
    A, B, Z = jh2c.A_PRIME, jh2c.B_PRIME, jh2c.Z_SSWU
    sswu = [A, B, Z, -B * A.inv(), B * (Z * A).inv()]
    assert _header_array(h2c, "SSWU_C") == [w for c in sswu for w in _mont2(c)]
    assert _header_array(h2c, "FP_INV2") == _words(pow(2, P - 2, P) * (1 << 384) % P)
    iso = jh2c._K1 + jh2c._K2 + jh2c._K3 + jh2c._K4
    assert _header_array(h2c, "ISO_K") == [w for c in iso for w in _mont2(c)]
    assert _header_array(h2c, "SQRT_EXP") == _words((P + 1) // 4) + _words((P - 3) // 4)
    assert ((P + 1) // 4).bit_length() == ((P - 3) // 4).bit_length() == 379  # bit 378 first
    assert pow(P - 1, (P + 1) // 4, P) == P - 1  # the root of -a is -a^((p+1)/4)
