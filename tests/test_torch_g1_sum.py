"""Per-item G1 sums (K10's plain version) and the key cache against the JAX
package.

``sum_g1_many_device(..., device="cpu")`` runs the port's plain torch tree
sum; the JAX package's host curve arithmetic (``crypto/curve``) is the
oracle, compared by compressed bytes. The JAX device program
``sum_many_kernel`` compiles for minutes on XLA:CPU, so the one comparison
of Jacobian limbs against it is marked slow, as the JAX package's own
device-MSM tests are.
"""

import numpy as np
import pytest
import torch

from eth_consensus_specs_tpu.crypto import curve as jc
from eth_consensus_specs_tpu.crypto import signature as jsig
from eth_consensus_specs_tpu.ops import field_limbs as jfl
from eth_consensus_specs_tpu_torch import convert
from eth_consensus_specs_tpu_torch.crypto import curve as pc
from eth_consensus_specs_tpu_torch.crypto import signature as psig
from eth_consensus_specs_tpu_torch.inputs import g1_keys
from eth_consensus_specs_tpu_torch.ops import field_limbs as fl
from eth_consensus_specs_tpu_torch.ops import g1_msm


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax(p) -> "jc.Point":
    data = convert.point_to_bytes(p)
    return jc.g1_from_bytes(data)


def _jax_sum(points) -> bytes:
    acc = jc.g1_infinity()
    for p in points:
        acc = acc + _jax(p)
    return jc.g1_to_bytes(acc)


def _corner_lists():
    keys = g1_keys(40, first=5)
    p, inf = keys[0], pc.g1_infinity()
    return [
        keys[:16],  # full at the widest
        keys[16:21],  # ragged: 5 of 16 lanes, the rest padding
        [p, p],  # P + P doubles
        [p, -p],  # P + (-P) gives Z = 0
        [p, -p, keys[3]],  # ... and the next level passes it through
        [inf, inf, inf],  # every Z = 0
        [inf, keys[7], inf, keys[8]],  # infinity lanes among keys
        [keys[9]],  # one key
        [keys[10], keys[11], keys[10], -keys[11]],  # sums that cancel across levels
    ]


def test_sums_match_the_jax_curve():
    lists = _corner_lists()
    got = g1_msm.sum_g1_many_device(lists, device="cpu")
    assert [pc.g1_to_bytes(s) for s in got] == [_jax_sum(pts) for pts in lists]
    assert pc.g1_to_bytes(g1_msm.sum_g1_device(lists[0], device="cpu")) == _jax_sum(lists[0])


def test_kernel_boundary_shapes_and_padding():
    lists = _corner_lists()
    X, Y, Z = g1_msm.pack_lanes(lists)
    assert X.shape == (len(lists), 16, 12) and X.dtype == np.int32
    one = fl.ints_to_card_words(1)
    assert (Z[1, :5] == one).all() and not Z[1, 5:].any()
    assert Z[5].sum() == 0
    out = g1_msm.sum_many(*(torch.from_numpy(a) for a in (X, Y, Z)))
    assert out.shape == (len(lists), 3, 12) and out.dtype == torch.int32
    with pytest.raises(ValueError):
        g1_msm.sum_many(*(torch.from_numpy(a[:, :12]).contiguous() for a in (X, Y, Z)))


def test_convert_carries_jax_field_limbs_rows_into_the_sum():
    keys = g1_keys(4, first=100)
    rows = [(jfl.to_mont(k.x.n), jfl.to_mont(k.y.n)) for k in keys]
    X = convert.card_words_from_jax_limbs(np.stack([r[0] for r in rows]), "field_limbs")[None]
    Y = convert.card_words_from_jax_limbs(np.stack([r[1] for r in rows]), "field_limbs")[None]
    Z = convert.card_words_from_jax_limbs(np.stack([jfl.to_mont(1)] * 4), "field_limbs")[None]
    out = g1_msm.sum_many(torch.from_numpy(X), torch.from_numpy(Y), torch.from_numpy(Z))
    assert pc.g1_to_bytes(g1_msm.sums_to_points(out)[0]) == _jax_sum(keys)


def test_load_pk_cache_hit_miss_and_bad_keys():
    psig._PK_CACHE.clear()
    key = pc.g1_to_bytes(g1_keys(1, first=77)[0])
    miss = psig._load_pk(key)
    hit = psig._load_pk(key)
    assert hit is miss and pc.g1_to_bytes(hit) == key
    assert hit.row == fl.ints_to_card_words([hit.x.n, hit.y.n]).tobytes()
    bad = [b"\x00" * 48, pc.g1_to_bytes(pc.g1_infinity()), b"\xbf" + b"\xff" * 47]
    for b in bad:
        assert psig._load_pk(b) is None
        assert jsig._load_pk(b) is None
        assert psig._load_pk(b) is None  # a cached rejection stays a rejection


def test_load_pk_cache_clears_at_its_cap_like_the_jax_package(monkeypatch):
    keys = [pc.g1_to_bytes(k) for k in g1_keys(5, first=200)]
    for mod in (psig, jsig):
        monkeypatch.setattr(mod, "_PK_CACHE_MAX", 4)
        mod._PK_CACHE.clear()
    sizes = {"port": [], "jax": []}
    for k in keys:
        psig._load_pk(k)
        jsig._load_pk(k)
        sizes["port"].append(len(psig._PK_CACHE))
        sizes["jax"].append(len(jsig._PK_CACHE))
    assert sizes["port"] == sizes["jax"] == [1, 2, 3, 4, 1]
    assert psig._PK_CACHE_MAX == 4 and jsig._PK_CACHE_MAX == 4
    psig._PK_CACHE.clear()
    jsig._PK_CACHE.clear()


def test_bounds_match_the_jax_package():
    assert psig._PK_CACHE_MAX == jsig._PK_CACHE_MAX == 1 << 16


@pytest.mark.slow
def test_jacobian_limbs_match_the_jax_device_program():
    from eth_consensus_specs_tpu.ops import g1_msm as jg

    lists = _corner_lists()[:4]
    lanes = 16
    X = np.zeros((len(lists), lanes, jfl.N_LIMBS), np.uint64)
    Y, Z = X.copy(), X.copy()
    for i, pts in enumerate(lists):
        for j, p in enumerate(pts):
            if not p.is_infinity():
                X[i, j], Y[i, j], Z[i, j] = jfl.to_mont(p.x.n), jfl.to_mont(p.y.n), jfl.to_mont(1)
    rX, rY, rZ = (np.asarray(a) for a in jg.sum_many_kernel(X, Y, Z))
    want = np.stack([convert.card_words_from_jax_limbs(a, "field_limbs") for a in (rX, rY, rZ)],
                    axis=1)
    got = g1_msm.sum_many(*(torch.from_numpy(a) for a in g1_msm.pack_lanes(lists, lanes)))
    assert np.array_equal(got.numpy(), want)
