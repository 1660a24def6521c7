"""The design of K20 (``csrc/final_exp_gt.cu`` ``final_exp_gt_kernel``) held on host
ints, cheaply.

K20 runs the exact final exponentiation as a sequence of the cooperative
tower's programs on one block: the easy part (the Fq12 inverse, its Fq
inverse a binary GCD taken on one thread between ``inv_a`` and ``inv_b``),
the power by e = (x-1)^2/3 in Granger-Scott squarings (``coop_pow_cyc``),
K12's tail from b = m^e (three powers by x, a Frobenius map, a
p^2-Frobenius map, three products), the last product by m, then ``store``.
``_k20`` below runs that sequence through ``fq12_coop.simulate`` exactly as
the kernel calls it; on the Miller value of one pair (and on a random Fq12)
its words must equal the plain twin ``final_exponentiation_ref``'s and the
JAX package's host ``final_exponentiation``'s.
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from eth_consensus_specs_tpu.crypto import fields as jf
from eth_consensus_specs_tpu.crypto import pairing as jp
from eth_consensus_specs_tpu_torch.crypto import pairing as oracle
from eth_consensus_specs_tpu_torch.crypto.curve import g1_generator, g2_generator
from eth_consensus_specs_tpu_torch.crypto.fields import BLS_X, P, Fq12
from eth_consensus_specs_tpu_torch.ops import field_limbs as fl
from eth_consensus_specs_tpu_torch.ops import fq12_coop as coop
from eth_consensus_specs_tpu_torch.ops import pairing_device as pd

CSRC = Path(__file__).resolve().parents[1] / "eth_consensus_specs_tpu_torch" / "csrc"
# the kernel's slots: S, then f, t, m, b, c, d, e, g, then the inverse's Z
F = coop.SLOTS
T, M, B, C, D, E, G, W = (F + 12 * k for k in range(1, 9))
E_BITS = (BLS_X - 1) ** 2 // 3
X_ABS = -BLS_X


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _run(mem, op, x, y=0, z=0, o=None):
    bases = {coop.X: x, coop.Y: y, coop.Z: z, coop.O: x if o is None else o, coop.S: 0}
    coop.simulate(coop.PROGRAMS[op], mem, bases)


def _pow_cyc(mem, dst, src, e):
    """``coop_pow_cyc``: a Granger-Scott squaring a bit below e's top one,
    then a product by src a set bit; dst apart from src."""
    for bit in range(e.bit_length() - 2, -1, -1):
        _run(mem, "cyc", src if bit == e.bit_length() - 2 else dst, o=dst)
        if (e >> bit) & 1:
            _run(mem, "mul", dst, src, o=dst)


def _powx(mem, dst, src):
    _pow_cyc(mem, dst, src, X_ABS)
    _run(mem, "conj", dst, o=dst)


def _k20(f_words: np.ndarray) -> list[int]:
    """K20's sequence of programs on canonical words f [2, 3, 2, 12] -> the
    canonical ints it stores."""
    mem = {i: v for i, (_, v) in enumerate(coop.CONSTS)}
    for k, v in enumerate(fl.words_to_ints(f_words.reshape(12, 12))):
        mem[F + k] = v
    _run(mem, "load", F, o=F)
    coop.simulate_inverse_gcd(mem, {coop.X: F, coop.Y: 0, coop.Z: W, coop.O: T, coop.S: 0})
    _run(mem, "mulc", T, F, o=T)
    _run(mem, "frob2", T, o=M)
    _run(mem, "mul", M, T, o=M)
    _pow_cyc(mem, B, M, E_BITS)
    _powx(mem, C, B)
    _run(mem, "frob", B, o=T)
    _run(mem, "mul", C, T, o=C)
    _powx(mem, D, C)
    _powx(mem, E, D)
    _run(mem, "frob2", C, o=T)
    _run(mem, "mul", E, T, o=G)
    _run(mem, "mulc", G, C, o=G)
    _run(mem, "mul", G, M, o=G)
    _run(mem, "store", G, o=G)
    return [mem[G + k] for k in range(12)]


def _jax(f: Fq12):
    c = f.ints()
    e = [jf.Fq2.from_ints(c[2 * i], c[2 * i + 1]) for i in range(6)]
    return jf.Fq12(jf.Fq6(*e[:3]), jf.Fq6(*e[3:]))


def _jax_ints(x) -> list[int]:
    return [c.n for half in (x.c0, x.c1) for e in (half.c0, half.c1, half.c2)
            for c in (e.c0, e.c1)]


def _random_fq12(seed: int) -> Fq12:
    rng = np.random.default_rng(seed)
    return Fq12.from_ints([int.from_bytes(rng.bytes(48), "little") % P for _ in range(12)])


@pytest.mark.parametrize("which", ["miller_value", "random"])
def test_k20_program_sequence_equals_the_plain_twin_and_the_jax_host(which):
    if which == "miller_value":
        f = oracle.miller_loop(g1_generator().mul(7), oracle.untwist(g2_generator().mul(11)))
    else:
        f = _random_fq12(5)
    words = pd.fq12_to_words(f)
    got = _k20(words)
    want = pd.final_exponentiation_ref(torch.from_numpy(words))
    assert got == fl.words_to_ints(want.reshape(12, 12).numpy())
    assert got == _jax_ints(jp.final_exponentiation(_jax(f)))
    assert Fq12.from_ints(got) != Fq12.one()


def test_k20_exponent_and_its_chain():
    """e = (x-1)^2/3 is the 126-bit constant K20 powers by (125 squarings,
    47 products; ``kEHi``, ``kELo`` in ``final_exp_gt.cu``, |x| its
    ``kXAbs``), and ((x-1)^2/3)(x+p)(x^2+p^2-1) + 1 is the hard exponent
    (p^4 - p^2 + 1)/r."""
    from eth_consensus_specs_tpu_torch.crypto.fields import R

    text = (CSRC / "final_exp_gt.cu").read_text()
    consts = {k: int(v, 16) for k, v in re.findall(r"(kEHi|kELo|kXAbs) = 0x([0-9a-f]+)ull", text)}
    assert (consts["kEHi"] << 64) | consts["kELo"] == E_BITS and consts["kXAbs"] == X_ABS
    assert E_BITS == 0x396C8C005555E1568C00AAAB0000AAAB
    assert (E_BITS.bit_length() - 1, bin(E_BITS).count("1") - 1) == (125, 47)
    x = BLS_X
    assert E_BITS * (x + P) * (x * x + P * P - 1) + 1 == (P ** 4 - P ** 2 + 1) // R
    assert pd._HARD_E == E_BITS


def test_k20_inverse_split_equals_the_fermat_program():
    """``inv_a``, the GCD on one thread, ``inv_b`` give the words of the
    tower's one-program inverse (K12's, the Fermat chain), and zero's
    inverse is zero as the kernel's GCD gives it."""
    rng = np.random.default_rng(3)
    vals = [int.from_bytes(rng.bytes(48), "little") % P for _ in range(12)]
    out = {}
    for split in (True, False):
        mem = {i: v for i, (_, v) in enumerate(coop.CONSTS)}
        for k, v in enumerate(vals):
            mem[F + k] = v * coop.R_CARD % P
        if split:
            coop.simulate_inverse_gcd(mem, {coop.X: F, coop.Y: 0, coop.Z: W, coop.O: T, coop.S: 0})
        else:
            _run(mem, "inv", F, o=T)
        out[split] = [mem[T + k] for k in range(12)]
    assert out[True] == out[False]
    inv = Fq12.from_ints([v * pow(coop.R_CARD, -1, P) % P for v in out[True]])
    assert inv * Fq12.from_ints(vals) == Fq12.one()
    assert coop.gcd_inverse(0) == (0, 0)
