"""The port's full-scalar G1 MSMs on the CPU (the plain version of K17)
against the JAX package's ``msm_g1_many_device`` and the host ``msm_g1``.

Points compare on their compressed encodings: K17 runs each lane as two
half-lanes split by G1's endomorphism and sums them another way than JAX's
tree, so Jacobian words differ between packages while the points do not. The JAX calls share one shape, ``pad_shape=(2,
8)``, compiled once for the file (its first call takes most of a minute on
XLA:CPU). Scalars cover 0, 1, r - 1, 2^256 - 1, r (the ladder meets -P in
its last add), r + 2 (it meets +P: the add doubles), an infinity lane, P
and -P in one item, and a one-lane item.
"""

import random

import numpy as np
import pytest
import torch

from eth_consensus_specs_tpu.crypto import curve as jc
from eth_consensus_specs_tpu.crypto import msm as jmsm
from eth_consensus_specs_tpu.ops import g1_msm as jg
from eth_consensus_specs_tpu_torch import convert
from eth_consensus_specs_tpu_torch.crypto.curve import g1_infinity, g1_to_bytes
from eth_consensus_specs_tpu_torch.crypto.fields import R
from eth_consensus_specs_tpu_torch.crypto.msm import msm_g1
from eth_consensus_specs_tpu_torch.inputs import g1_keys
from eth_consensus_specs_tpu_torch.ops import g1_msm

JAX_SHAPE = (2, 8)


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cases():
    rnd = random.Random(183)
    keys = g1_keys(24)
    p, q = keys[20], keys[21]
    return {
        "random": ([keys[:8], keys[8:15]],
                   [[rnd.randrange(R) for _ in range(8)], [rnd.randrange(R) for _ in range(7)]]),
        "scalar_corners": ([keys[:6], keys[6:8] + [g1_infinity()]],
                           [[0, 1, R - 1, (1 << 256) - 1, R, R + 2], [R + 2, 3, rnd.randrange(R)]]),
        "opposites": ([[p, -p], [q, -q, q]], [[9, 9], [rnd.randrange(R), 4, 5]]),
        "one_lane": ([[keys[22]], [g1_infinity()]], [[rnd.randrange(R)], [7]]),
    }


def _jax_points(points):
    return [jc.g1_from_bytes(g1_to_bytes(p)) for p in points]


@pytest.fixture(scope="module")
def jax_results():
    """Every case through the JAX ``msm_g1_many_device`` at one shape."""
    return {name: [jc.g1_to_bytes(p) for p in jg.msm_g1_many_device(
                [_jax_points(pts) for pts in points], scalars, pad_shape=JAX_SHAPE)]
            for name, (points, scalars) in _cases().items()}


@pytest.mark.parametrize("case", list(_cases()))
def test_msm_many_matches_jax_and_host(case, jax_results):
    points, scalars = _cases()[case]
    got = [g1_to_bytes(p) for p in g1_msm.msm_g1_many_device(points, scalars, device="cpu")]
    assert got == jax_results[case]
    assert got == [g1_to_bytes(msm_g1(p, s)) for p, s in zip(points, scalars)]
    assert got == [jc.g1_to_bytes(jmsm.msm_g1(_jax_points(p), s))
                   for p, s in zip(points, scalars)]


def test_jax_lanes_through_convert():
    """The JAX kernel's inputs (bit rows, 13 x 30-bit Montgomery limbs)
    carried across equal the port's packing, and the plain K17 on them
    gives the JAX package's points."""
    points, scalars = _cases()["scalar_corners"]
    lanes = max(len(p) for p in points)
    bits = np.zeros((2, lanes, jg.SCALAR_BITS), np.uint64)
    limbs = [np.zeros((2, lanes, jg.N_LIMBS), np.uint64) for _ in range(3)]
    for i, (pts, ks) in enumerate(zip(points, scalars)):
        bits[i, : len(ks)] = jg._scalars_to_bits(ks)
        for a, b in zip(limbs, jg._points_to_limbs(_jax_points(pts))):
            a[i, : len(pts)] = b
    K, X, Y, Z = convert.msm_lanes_from_jax(bits, *limbs)
    port = g1_msm.pack_msm(points, scalars)
    assert np.array_equal(K, port[0])
    for a, b in zip((X, Y, Z), port[1:]):
        assert np.array_equal(a, b)
    out = g1_msm.msm_many_ref(*(torch.from_numpy(a) for a in (K, X, Y, Z)))
    assert g1_msm.sums_to_points(out) == [msm_g1(p, s) for p, s in zip(points, scalars)]


def test_running_sums_of_several_lanes_a_thread():
    """K17 sums an item's block partials in a second launch once the item's
    half-lanes span several blocks, each fold group running over several
    partials when they outnumber its groups; the plain version with 2
    half-lanes a block and 2 fold groups walks that branch on 7 and 8 lanes
    (7 and 8 partials), and with one block holding every half-lane the
    other; all give the host's points."""
    points, scalars = _cases()["random"]
    K, X, Y, Z = (torch.from_numpy(a) for a in g1_msm.pack_msm(points, scalars))
    want = [msm_g1(p, s) for p, s in zip(points, scalars)]
    narrow = g1_msm.msm_many_ref(K, X, Y, Z, groups=2, fold_groups=2)
    assert g1_msm.sums_to_points(narrow) == want
    wide = g1_msm.msm_many_ref(K, X, Y, Z, groups=16)
    assert g1_msm.sums_to_points(wide) == want


def test_unit_scalars_take_the_point_sum(monkeypatch):
    keys = g1_keys(5)
    calls = []
    real = g1_msm.sum_many
    monkeypatch.setattr(g1_msm, "sum_many", lambda *a: calls.append(1) or real(*a))
    got = g1_msm.msm_g1_device(keys, [1] * 5, device="cpu")
    assert calls == [1] and got == msm_g1(keys, [1] * 5)
    assert g1_msm.msm_g1_device(keys[:2], [2, 1], device="cpu") == keys[0].mul(2) + keys[1]
    assert calls == [1]
    assert g1_msm.msm_g1_device([], [], device="cpu").is_infinity()
    assert g1_msm.msm_g1_many_device([], [], device="cpu") == []


def test_bad_arguments_raise():
    keys = g1_keys(2)
    with pytest.raises(ValueError):
        g1_msm.pack_msm([keys], [[1 << 256, 1]])
    with pytest.raises(ValueError):
        g1_msm.pack_msm([keys], [[-1, 1]])
    with pytest.raises(ValueError):
        g1_msm.pack_msm([keys], [[1]])
    K, X, Y, Z = (torch.from_numpy(a) for a in g1_msm.pack_msm([keys], [[3, 4]]))
    with pytest.raises(ValueError):
        g1_msm.msm_many(K[..., :7].contiguous(), X, Y, Z)
    with pytest.raises(ValueError):
        g1_msm.msm_many(K, X, Y[:, :1].contiguous(), Z)


@pytest.mark.parametrize("k", [0, 1, g1_msm.GLV_LAMBDA - 1, g1_msm.GLV_LAMBDA,
                               g1_msm.GLV_LAMBDA + 1, R - 1, R, R + 2, (1 << 256) - 1,
                               "random"])
def test_scalar_split_by_the_endomorphism(k):
    rng = np.random.default_rng(23)
    ks = ([int.from_bytes(rng.bytes(32), "little") for _ in range(20)] if k == "random"
          else [k])
    for k in ks:
        k1, k2 = g1_msm.split_scalar(k)
        assert (k1 + k2 * g1_msm.GLV_LAMBDA - k) % R == 0
        assert 0 <= k1 < 1 << 128 and 0 <= k2 < 1 << 128
    K = torch.from_numpy(g1_msm.scalars_to_words([ks], len(ks)))
    assert g1_msm.half_scalars(K) == [[h for k in ks for h in g1_msm.split_scalar(k)]]


def test_phi_is_lambda_on_g1():
    """phi(x, y) = (beta x, y) is [lambda] on G and on the keys: beta is the
    cube root of unity that matches lambda, not lambda^2."""
    from eth_consensus_specs_tpu_torch.crypto.curve import g1_generator
    from eth_consensus_specs_tpu_torch.crypto.fields import P, Fq

    assert (g1_msm.GLV_LAMBDA ** 2 + g1_msm.GLV_LAMBDA + 1) % R == 0
    assert pow(g1_msm.GLV_BETA, 3, P) == 1 != g1_msm.GLV_BETA
    for pt in [g1_generator(), *g1_keys(4)]:
        phi = type(pt)(Fq(pt.x.n * g1_msm.GLV_BETA % P), pt.y, pt.b)
        assert pt.mul(g1_msm.GLV_LAMBDA) == phi
