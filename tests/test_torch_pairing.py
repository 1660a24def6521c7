"""The port's pairing pieces (K11 and K12's plain versions, G2 preparation,
hash-to-G2) against the JAX package.

The JAX device programs ``miller_from_coeffs`` and ``final_exp_is_one``
compile for minutes on XLA:CPU; they are bit-exact with the JAX host oracle
(``crypto/pairing``), which is what the port is held against here:
Miller values as canonical Fq12 elements, verdicts as booleans, points as
compressed bytes.
"""

import numpy as np
import pytest
import torch

from eth_consensus_specs_tpu.crypto import curve as jc
from eth_consensus_specs_tpu.crypto import hash_to_curve as jh
from eth_consensus_specs_tpu.crypto import pairing as jp
from eth_consensus_specs_tpu.ops import pairing_device as jpd
from eth_consensus_specs_tpu_torch import convert
from eth_consensus_specs_tpu_torch.crypto import curve as pc
from eth_consensus_specs_tpu_torch.crypto import hash_to_curve as ph
from eth_consensus_specs_tpu_torch.crypto.fields import Fq2
from eth_consensus_specs_tpu_torch.ops import pairing_device as pd

MESSAGES = [b"", b"abc", b"attestation-data-root", bytes(range(200))]


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _tensors(pairs):
    return [torch.from_numpy(a) for a in pd.pack_pairs(pairs)]


def _jax12_ints(f) -> list[int]:
    return [c.n for half in (f.c0, f.c1) for e in (half.c0, half.c1, half.c2) for c in (e.c0, e.c1)]


@pytest.mark.parametrize("msg", MESSAGES)
def test_hash_to_g2_matches_the_jax_package(msg):
    assert pc.g2_to_bytes(ph.hash_to_g2(msg)) == jc.g2_to_bytes(jh.hash_to_g2(msg))


def test_g2_subgroup_check_matches_the_jax_package():
    x = Fq2.from_ints(5, 0)
    while (y := (x.square() * x + pc.B2).sqrt()) is None:
        x = x + Fq2.one()
    off = pc.Point(x, y, pc.B2)  # on the curve, outside the r-torsion
    jx = jc.Point(jc.Fq2.from_ints(x.c0.n, x.c1.n), jc.Fq2.from_ints(y.c0.n, y.c1.n), jc.B2)
    assert pc.in_subgroup(off) is jc.in_subgroup(jx) is False
    assert pc.in_subgroup(ph.hash_to_g2(b"in")) and pc.in_subgroup(pc.g2_generator())
    with pytest.raises(ValueError):
        pc.g2_from_bytes(pc.g2_to_bytes(off))


def test_prepare_g2_matches_the_jax_rows():
    q = ph.hash_to_g2(b"prepare")
    jq = jc.g2_from_bytes(pc.g2_to_bytes(q))
    assert np.array_equal(pd.prepare_g2(q), convert.coeffs_from_jax(jpd.prepare_g2(jq)))
    assert pd.N_STEPS == jpd.N_STEPS and pd._SQR_FLAGS.tolist() == jpd._SQR_FLAGS.tolist()


def test_miller_value_of_one_pair_matches_the_oracle():
    p = pc.g1_generator().mul(12345)
    q = ph.hash_to_g2(b"miller")
    got = pd.miller_loop_device(p, q, device="cpu")
    jpt, jq = jc.g1_from_bytes(pc.g1_to_bytes(p)), jc.g2_from_bytes(pc.g2_to_bytes(q))
    assert got.ints() == _jax12_ints(jp.miller_loop(jpt, jp.untwist(jq)))


def test_inactive_pairs_fold_as_one():
    g, q = pc.g1_generator(), ph.hash_to_g2(b"inactive")
    live = pd.miller_product(*_tensors([(g.mul(3), q)]))
    mixed = pd.miller_product(*_tensors([(pc.g1_infinity(), q), (g.mul(3), q),
                                         (g.mul(5), pc.g2_infinity())]))
    assert torch.equal(live, mixed)
    none = pd.miller_product(*_tensors([(pc.g1_infinity(), q)]))
    assert pd.fq12_from_words(none).is_one()
    assert pd.pairing_check_device([], device="cpu")


@pytest.mark.parametrize("a,b,c,valid", [(6, 5, 30, True), (6, 5, 31, False)])
def test_final_exp_check_matches_the_jax_pairing_check(a, b, c, valid):
    # e(aP, bQ) * e(-cP, Q) == 1 exactly when c == ab
    g, q = pc.g1_generator(), ph.hash_to_g2(b"bilinear")
    pairs = [(g.mul(a), q.mul(b)), (-g.mul(c), q)]
    jpairs = [(jc.g1_from_bytes(pc.g1_to_bytes(x)), jc.g2_from_bytes(pc.g2_to_bytes(y)))
              for x, y in pairs]
    f = pd.miller_product(*_tensors(pairs))
    assert bool(pd.final_exp_is_one(f)) is jp.pairing_check(jpairs) is valid


# --- K20's plain version and the GT export ---------------------------------------


def _jax_fq12(f):
    """The JAX host Fq12 of the port's Fq12, by canonical ints."""
    from eth_consensus_specs_tpu.crypto.fields import Fq2, Fq6, Fq12

    c = f.ints()
    fq2 = [Fq2.from_ints(c[2 * i], c[2 * i + 1]) for i in range(6)]
    return Fq12(Fq6(*fq2[:3]), Fq6(*fq2[3:]))


@pytest.mark.parametrize("seed", [b"gt-0", b"gt-1", b"gt-2"])
def test_final_exponentiation_ref_equals_the_jax_host_final_exponentiation(seed):
    p = pc.g1_generator().mul(int.from_bytes(seed, "big") % 1000 + 2)
    q = ph.hash_to_g2(seed)
    f = pd.miller_product(*_tensors([(p, q)]))
    got = pd.fq12_from_words(pd.final_exponentiation(f))
    want = jp.final_exponentiation(_jax_fq12(pd.fq12_from_words(f)))
    assert got.ints() == _jax12_ints(want)
    assert torch.equal(pd.final_exponentiation_ref(f), pd.final_exponentiation(f))


@pytest.mark.parametrize("a,b", [(5, 9), (1, 1)])
def test_pairing_device_equals_the_jax_pairing(a, b):
    p, q = pc.g1_generator().mul(a), pc.g2_generator().mul(b)
    got = pd.pairing_device(p, q, device="cpu")
    jpt, jq = jc.g1_from_bytes(pc.g1_to_bytes(p)), jc.g2_from_bytes(pc.g2_to_bytes(q))
    assert got.ints() == _jax12_ints(jp.pairing(jpt, jq))
    assert not got.is_one()


def test_pairing_device_of_infinity_is_one():
    assert pd.pairing_device(pc.g1_infinity(), pc.g2_generator(), device="cpu").is_one()
    assert pd.pairing_device(pc.g1_generator(), pc.g2_infinity(), device="cpu").is_one()


@pytest.mark.slow
def test_final_exponentiation_ref_equals_the_jax_device_final_exponentiation():
    """The JAX device program itself (its naive power compiles for minutes)."""
    from eth_consensus_specs_tpu.ops import fq12_tower as jtw

    f = pd.miller_product(*_tensors([(pc.g1_generator().mul(7), pc.g2_generator().mul(11))]))
    want = jtw.limbs_to_fq12(np.asarray(jpd.final_exponentiation(
        jtw.fq12_to_limbs(_jax_fq12(pd.fq12_from_words(f))))))
    assert pd.fq12_from_words(pd.final_exponentiation_ref(f)).ints() == _jax12_ints(want)
