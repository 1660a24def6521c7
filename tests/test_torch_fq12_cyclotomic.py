"""The plain Granger-Scott squaring (``fq12_tower.fq12_cyclotomic_sqr``)
against the complex squaring and the host oracles.

Elements are made from a seed with numpy and put into the cyclotomic
subgroup by the easy part of the final exponentiation
(``pairing_device._easy_part``), where Granger-Scott's formula is a
square; there it must equal ``fq12_sqr`` and the square of the JAX
package's host Fq12, word for word. ``fq12_powx``, which now squares that
way, must still equal the host's power by the BLS parameter.
"""

import numpy as np
import pytest
import torch

from eth_consensus_specs_tpu.crypto import fields as jf
from eth_consensus_specs_tpu_torch.crypto.fields import BLS_X, P, Fq12
from eth_consensus_specs_tpu_torch.ops import field_limbs as fl
from eth_consensus_specs_tpu_torch.ops import fq12_tower as tw
from eth_consensus_specs_tpu_torch.ops import pairing_device as pd

SEEDS = [0, 1, 2, 3]


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _random(seed: int, n: int) -> list:
    rng = np.random.default_rng(seed)
    return [Fq12.from_ints([int.from_bytes(rng.bytes(48), "little") % P for _ in range(12)])
            for _ in range(n)]


def _jax(f: Fq12):
    c = f.ints()
    e = [jf.Fq2.from_ints(c[2 * i], c[2 * i + 1]) for i in range(6)]
    return jf.Fq12(jf.Fq6(*e[:3]), jf.Fq6(*e[3:]))


def _ints(jx) -> list:
    return [c.n for half in (jx.c0, jx.c1) for e in (half.c0, half.c1, half.c2)
            for c in (e.c0, e.c1)]


@pytest.fixture(scope="module")
def cyclotomic():
    """Three elements of each seed after the easy part, as limbs and host."""
    out = {}
    for seed in SEEDS:
        m = pd._easy_part(tw.fq12_from_host(_random(seed, 3)))
        out[seed] = (m, tw.fq12_to_host(m))
    return out


@pytest.mark.parametrize("seed", SEEDS)
def test_cyclotomic_sqr_equals_the_complex_square(cyclotomic, seed):
    m, _ = cyclotomic[seed]
    assert torch.equal(fl.canon(tw.fq12_cyclotomic_sqr(m)), fl.canon(tw.fq12_sqr(m)))


@pytest.mark.parametrize("seed", SEEDS)
def test_cyclotomic_sqr_equals_the_jax_host_square(cyclotomic, seed):
    m, host = cyclotomic[seed]
    got = tw.fq12_to_host(tw.fq12_cyclotomic_sqr(m))
    for g, h in zip(got, host):
        assert g == h * h
        assert g.ints() == _ints(_jax(h).square())


@pytest.mark.parametrize("seed", SEEDS[:2])
def test_chained_cyclotomic_squares_stay_exact(cyclotomic, seed):
    m, host = cyclotomic[seed]
    for _ in range(8):
        m = tw.fq12_cyclotomic_sqr(m)
        host = [h * h for h in host]
    assert tw.fq12_to_host(m) == host


def test_granger_scott_is_not_a_square_off_the_subgroup():
    # the formula needs the cyclotomic subgroup: off it the two squarings part
    f = tw.fq12_from_host(_random(9, 2))
    assert not torch.equal(fl.canon(tw.fq12_cyclotomic_sqr(f)), fl.canon(tw.fq12_sqr(f)))


@pytest.mark.parametrize("seed", SEEDS[:2])
def test_powx_equals_the_host_power(cyclotomic, seed):
    m, host = cyclotomic[seed]
    got = tw.fq12_to_host(tw.fq12_powx(m))
    assert got == [h.pow(-BLS_X).conjugate() for h in host]
    assert [g.ints() for g in got] == [_ints(_jax(h).pow(-BLS_X).conjugate()) for h in host]
