"""Hash-to-G2 of the port on the CPU (the plain versions of K13 and K14)
against the JAX package.

The plain square root must make the JAX host ``Fq2.sqrt``'s root choice on
the six cases of ``tests/test_h2c_device.py``; ``hash_to_g2_device`` with
``device="cpu"`` must give the JAX host ``hash_to_g2`` point; the SSWU map
at u = 0 (the tv2 = 0 branch) and at u with c1 = 0 must give the JAX host
``map_to_curve_sswu_g2`` point; ``verify_many`` must give the same verdicts
through either hash. The JAX device program (``_h2c_map``) compiles for
minutes on XLA:CPU, so the one comparison of Jacobian words against it is
marked slow, as the JAX package's own device hash tests are.
"""

import random

import numpy as np
import pytest
import torch

from eth_consensus_specs_tpu.crypto import curve as jc
from eth_consensus_specs_tpu.crypto import hash_to_curve as jh2c
from eth_consensus_specs_tpu.crypto.fields import P, Fq, Fq2
from eth_consensus_specs_tpu_torch.crypto import curve as pc
from eth_consensus_specs_tpu_torch.inputs import attestation_block
from eth_consensus_specs_tpu_torch.ops import bls_batch as bb
from eth_consensus_specs_tpu_torch.ops import field_limbs as fl
from eth_consensus_specs_tpu_torch.ops import h2c_device as hd

@pytest.fixture(autouse=True, scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


SQRT_CASES = [
    Fq2(Fq(5), Fq(7)).square(),  # general residue
    Fq2(Fq(11), Fq(0)).square(),  # b == 0, a residue
    Fq2(Fq(0), Fq(13)).square(),  # = -169: b == 0, a not a residue
    Fq2(Fq(3), Fq(1)),  # a non-residue
    Fq2(Fq(0), Fq(0)),  # zero
    Fq2(Fq(P - 2), Fq(P - 5)).square(),  # general residue, large limbs
]


def _words(vals) -> torch.Tensor:
    return torch.from_numpy(fl.ints_to_words(vals))


def test_plain_sqrt_makes_the_jax_host_root_choice():
    root, ok = hd.fq2_sqrt(_words([[c.c0.n, c.c1.n] for c in SQRT_CASES]))
    for c, r, flag in zip(SQRT_CASES, fl.words_to_ints(root), ok.tolist()):
        host = c.sqrt()
        assert bool(flag) == (host is not None)
        if host is not None:
            assert r == [host.c0.n, host.c1.n]


def test_hash_to_g2_device_on_cpu_equals_the_jax_host_hash():
    msgs = [b"", b"abc", b"device-h2c \xff" * 3, bytes(range(97))]
    got = hd.hash_to_g2_device(msgs, device="cpu")
    assert [pc.g2_to_bytes(p) for p in got] == [jc.g2_to_bytes(jh2c.hash_to_g2(m)) for m in msgs]
    assert hd.hash_to_g2_device([], device="cpu") == []
    other = b"ANOTHER-DST_"
    assert pc.g2_to_bytes(hd.hash_to_g2_device([b"x"], other, device="cpu")[0]) == \
        jc.g2_to_bytes(jh2c.hash_to_g2(b"x", other))


# u = 0 (tv2 = 0: the exceptional x1), and three u with c1 = 0
U_CORNERS = [[0, 0], [3, 0], [P - 1, 0], [12345, 0]]


def test_sswu_map_at_u_zero_and_c1_zero_equals_the_jax_host_map():
    x, y = hd._map_to_curve_sswu(fl.from_ints(U_CORNERS))
    for u, gx, gy in zip(U_CORNERS, fl.to_ints(x), fl.to_ints(y)):
        wx, wy = jh2c.map_to_curve_sswu_g2(Fq2(Fq(u[0]), Fq(u[1])))
        assert (gx, gy) == ([wx.c0.n, wx.c1.n], [wy.c0.n, wy.c1.n])


def test_both_stages_on_corner_rows_equal_the_jax_host_pipeline():
    rows = [[U_CORNERS[0], [5, 7]], [U_CORNERS[1], U_CORNERS[3]], [U_CORNERS[2], U_CORNERS[0]]]
    jac = hd.h2c_map(_words(rows))
    assert jac.shape == (3, 3, 2, 12) and jac.dtype == torch.int32
    xy, inf = hd.h2c_finish(jac)
    assert xy.shape == (3, 2, 2, 12) and inf.tolist() == [0, 0, 0]
    want = [jh2c.clear_cofactor_g2(jh2c.map_to_curve_g2(Fq2(Fq(a[0]), Fq(a[1])))
                                   + jh2c.map_to_curve_g2(Fq2(Fq(b[0]), Fq(b[1]))))
            for a, b in rows]
    assert [pc.g2_to_bytes(p) for p in hd.points_from_words(xy, inf)] == \
        [jc.g2_to_bytes(w) for w in want]


def test_finish_of_infinity_is_flagged():
    jac = torch.zeros((2, 3, 2, 12), dtype=torch.int32)
    jac[0] = hd.h2c_map(_words([[[1, 2], [3, 4]]]))[0]
    xy, inf = hd.h2c_finish(jac)
    assert inf.tolist() == [0, 1] and not xy[1].any()


def test_wrappers_reject_bad_shapes():
    with pytest.raises(ValueError):
        hd.h2c_map(torch.zeros((2, 2, 12), dtype=torch.int32))
    with pytest.raises(ValueError):
        hd.h2c_finish(torch.zeros((0, 3, 2, 12), dtype=torch.int32))
    with pytest.raises(ValueError):
        hd.fq2_sqrt(torch.zeros((2, 3, 12), dtype=torch.int32))


@pytest.mark.parametrize("tamper", [(), (2,)])
def test_verify_many_device_hash_gives_the_host_hash_verdicts(tamper):
    """The cache primed by the plain K13/K14 pipeline (as ``verify_many``
    primes it on the card) gives the verdicts of the host-hashed cache."""
    items, _ = attestation_block(4, 2, distinct=3, call=21, tamper=tamper)
    msgs = list(dict.fromkeys(msg for _, msg, _ in items))
    bb._H2G2_CACHE.clear()
    bb._prime_h2g2_cache(msgs, lambda m, dst: hd.hash_to_g2_device(m, dst, device="cpu"))
    primed = dict(bb._H2G2_CACHE)
    dev = bb.verify_many(items, device="cpu", rng=random.Random(3))
    assert bb.batch_verify_aggregates(items, device="cpu") is (not tamper)
    bb._H2G2_CACHE.clear()
    host = bb.verify_many(items, device="cpu", rng=random.Random(3))
    assert dict(bb._H2G2_CACHE) == primed
    assert dev == host == [i not in tamper for i in range(4)]


@pytest.mark.slow  # the JAX device program compiles for minutes on XLA:CPU
def test_map_stage_words_equal_the_jax_device_program():
    from eth_consensus_specs_tpu.ops import fq12_tower as jtw
    from eth_consensus_specs_tpu.ops.h2c_device import _h2c_map
    from eth_consensus_specs_tpu_torch import convert

    msgs = [b"", b"slow-h2c"]
    ints = hd.field_elements(msgs)
    rows = np.stack([np.stack([jtw.fq2_to_limbs(Fq2(Fq(a), Fq(b))) for a, b in pair])
                     for pair in ints])
    jx, jy, jz = _h2c_map(rows)
    want = np.stack([convert.card_words_from_jax_limbs(np.asarray(a), "lazy_limbs")
                     for a in (jx, jy, jz)], axis=1)
    assert np.array_equal(hd.h2c_map(_words(ints)).numpy(), want)
