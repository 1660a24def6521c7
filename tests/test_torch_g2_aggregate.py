"""Per-committee G2 sums (K15's plain version) and the shape model against
the JAX package.

``sum_g2_many_device(..., device="cpu")`` runs the port's plain adjacent-pair
tree; the JAX host fold ``crypto.signature._sum_g2`` is the oracle,
compared by compressed bytes, on ragged committees and the corners (all
infinity, one lane, P + P, P - P, infinity members). ``g2_many_sum_shape``'s lane padding is held against
the JAX shape model and serve keys on a grid (the port launches the exact
item count, where JAX pads it to a power of two for XLA). The JAX
device program ``g2_sum_many_kernel`` compiles for minutes on XLA:CPU, so
the one comparison of Jacobian words against it is marked slow, as the JAX
package's own device aggregation tests are.
"""

import numpy as np
import pytest
import torch

from eth_consensus_specs_tpu.crypto import curve as jc
from eth_consensus_specs_tpu.crypto import signature as jsig
from eth_consensus_specs_tpu.ops import g2_aggregate as jga
from eth_consensus_specs_tpu.serve import buckets as jb
from eth_consensus_specs_tpu_torch import convert
from eth_consensus_specs_tpu_torch.ops import g1_msm
from eth_consensus_specs_tpu_torch.crypto import curve as pc
from eth_consensus_specs_tpu_torch.crypto import signature as psig
from eth_consensus_specs_tpu_torch.ops import g2_aggregate as ga

G2 = pc.g2_generator()


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _lists():
    inf = pc.g2_infinity()
    p = G2.mul(4)
    return [
        [G2.mul(k + 1) for k in range(5)],  # ragged: 5 of 8 lanes
        [G2.mul(7), inf, G2.mul(9)],  # an infinity member
        [inf, inf, inf, inf, inf, inf, inf, inf],  # all infinity, full width
        [G2.mul(3)],  # one lane
        [p, p],  # P + P takes the doubling
        [G2.mul(3), -G2.mul(3)],  # P - P gives infinity
        [p, -p, G2.mul(6)],  # ... and the next level passes it through
        [p, p, G2.mul(8), G2.mul(2)],  # sums that meet again one level up
    ]


def _jax_bytes(points) -> bytes:
    return jc.g2_to_bytes(jsig._sum_g2([jc.g2_from_bytes(pc.g2_to_bytes(p)) for p in points]))


def test_sums_match_the_jax_host_fold():
    lists = _lists()
    got = ga.sum_g2_many_device(lists, device="cpu")
    assert [pc.g2_to_bytes(s) for s in got] == [_jax_bytes(pts) for pts in lists]
    assert [pc.g2_to_bytes(s) for s in got] == [pc.g2_to_bytes(psig._sum_g2(p)) for p in lists]
    assert pc.g2_to_bytes(ga.sum_g2_device(lists[0], device="cpu")) == _jax_bytes(lists[0])
    assert ga.sum_g2_many_device([], device="cpu") == []


def test_padding_to_a_wider_bucket_keeps_every_sum():
    lists = _lists()[:3]
    X, Y, Z = (torch.from_numpy(a) for a in ga._points_to_lanes(lists, 4, 32))
    got = ga.sums_to_points(ga.g2_sum_many(X, Y, Z))
    assert [pc.g2_to_bytes(s) for s in got] == [_jax_bytes(pts) for pts in lists] + [
        pc.g2_to_bytes(pc.g2_infinity())]
    with pytest.raises(ValueError):
        ga._points_to_lanes(lists, 2, 8)
    with pytest.raises(ValueError):
        ga._points_to_lanes(lists, 4, 4)


@pytest.mark.parametrize("items", [3, 5])
def test_sums_launch_at_the_exact_item_count(items):
    lists = _lists()[:items]
    assert ga.g2_many_sum_shape(items, 5) == (items, 8)
    got = ga.sum_g2_many_device(lists, device="cpu")
    assert [pc.g2_to_bytes(s) for s in got] == [_jax_bytes(pts) for pts in lists]


def test_lanes_and_words_carry_from_the_jax_layout():
    lists = _lists()
    jlists = [[jc.g2_from_bytes(pc.g2_to_bytes(p)) for p in pts] for pts in lists]
    port = ga._points_to_lanes(lists, 8, 8)
    carried = convert.g2_lanes_from_jax(*jga._points_to_lanes(jlists, 8, 8))
    for a, b in zip(port, carried):
        assert np.array_equal(a, b)
    out = ga.g2_sum_many(*(torch.from_numpy(a) for a in port))
    assert out.shape == (8, 3, 2, 12) and out.dtype == torch.int32
    assert [pc.g2_to_bytes(s) for s in ga.sums_to_points(out)] == [_jax_bytes(p) for p in lists]


def test_wrapper_rejects_bad_lanes():
    X, Y, Z = (torch.from_numpy(a) for a in ga._points_to_lanes(_lists(), 8, 8))
    with pytest.raises(ValueError):
        ga.g2_sum_many(X[:, :6].contiguous(), Y[:, :6].contiguous(), Z[:, :6].contiguous())
    with pytest.raises(ValueError):
        ga.g2_sum_many(X, Y, Z[:4])
    with pytest.raises(ValueError):
        ga.g2_sum_many(X[..., :11], Y[..., :11], Z[..., :11])


@pytest.mark.parametrize("lanes", [1, 2, 8, 64])
def test_butterfly_partners_match_jax(lanes):
    assert np.array_equal(ga._butterfly_partners(lanes), jga._butterfly_partners(lanes))


def test_shape_model_and_keys_match_the_jax_serve_buckets():
    """The port launches JAX's lane padding at the exact item count."""
    for n in (1, 2, 3, 5, 8, 9, 63, 64, 65, 100, 512, 513):
        for lanes in (1, 2, 5, 33, 64, 512, 513):
            items, lane_pad = ga.g2_many_sum_shape(n, lanes)
            j_items, j_lanes = jga.g2_many_sum_shape(n, lanes)
            assert (items, lane_pad) == (n, j_lanes) and j_items == jb.pow2_bucket(n)
            assert jb.g2_agg_key_from_profile(n, lanes)[1:] == (j_items, lane_pad)
            assert jb.bls_msm_key_from_profile(n, lanes)[2] == g1_msm.lane_pad(lanes) == lane_pad


@pytest.mark.slow  # the JAX butterfly compiles its scan body for about a minute on XLA:CPU
def test_jacobian_words_equal_the_jax_device_program():
    lists = _lists()
    jlists = [[jc.g2_from_bytes(pc.g2_to_bytes(p)) for p in pts] for pts in lists]
    jX, jY, jZ = jga._points_to_lanes(jlists, 8, 8)
    rX, rY, rZ = jga.g2_sum_many_kernel(jX, jY, jZ)
    want = np.stack([convert.card_words_from_jax_limbs(np.asarray(a), "lazy_limbs")
                     for a in (rX, rY, rZ)], axis=1)
    got = ga.g2_sum_many(*(torch.from_numpy(a) for a in ga._points_to_lanes(lists, 8, 8)))
    assert np.array_equal(got.numpy(), want)
