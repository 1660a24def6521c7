"""The port's plain G2 Jacobian layer (``ops/g2_jacobian.py``, the twin of
``csrc/g2_jac.cuh``) against the JAX package.

``g2_add`` and ``g2_dbl`` run on the JAX corner lanes of
``tests/test_g2_aggregate.py`` (generic add, P + P, P + (-P), both
infinity passthroughs; a generic point and infinity doubled) and must give
the same Jacobian coordinates as the JAX ``g2_jacobian`` run eagerly, in
canonical ints, and the host curve's points. The ladder, psi and cofactor
clearing are held against the JAX host ``clear_cofactor_g2`` and the JAX
curve's scalar multiplication, by compressed bytes.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eth_consensus_specs_tpu.crypto import curve as jc
from eth_consensus_specs_tpu.crypto import hash_to_curve as jh2c
from eth_consensus_specs_tpu.crypto.fields import Fq2 as JFq2
from eth_consensus_specs_tpu.ops import fq12_tower as jtw
from eth_consensus_specs_tpu.ops import g2_jacobian as jgj
from eth_consensus_specs_tpu.ops.lazy_limbs import lf
from eth_consensus_specs_tpu_torch import convert
from eth_consensus_specs_tpu_torch.crypto import curve as pc
from eth_consensus_specs_tpu_torch.crypto.fields import Fq2
from eth_consensus_specs_tpu_torch.ops import field_limbs as fl
from eth_consensus_specs_tpu_torch.ops import g2_jacobian as gj

G2 = pc.g2_generator()
JG2 = jc.g2_generator()


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _port(points) -> tuple:
    x = [[0, 0] if p.is_infinity() else [p.x.c0.n, p.x.c1.n] for p in points]
    y = [[0, 0] if p.is_infinity() else [p.y.c0.n, p.y.c1.n] for p in points]
    inf = torch.tensor([p.is_infinity() for p in points])
    return gj.g2_from_affine(fl.from_ints(x), fl.from_ints(y), inf)


def _jax(points) -> "jgj.G2J":
    x = np.zeros((len(points), 2, 15), np.uint64)
    y, z = np.zeros_like(x), np.zeros_like(x)
    one = jtw.fq2_to_limbs(JFq2.one())
    for i, p in enumerate(points):
        if not p.is_infinity():
            jp = jc.g2_from_bytes(pc.g2_to_bytes(p))
            x[i], y[i], z[i] = jtw.fq2_to_limbs(jp.x), jtw.fq2_to_limbs(jp.y), one
    return jgj.G2J(lf(jnp.asarray(x)), lf(jnp.asarray(y)), lf(jnp.asarray(z)))


def _jac_ints_port(p: tuple) -> list:
    return [fl.to_ints(c) for c in p]


def _jac_ints_jax(p: "jgj.G2J") -> list:
    return [convert.ints_from_jax_limbs(np.asarray(jgj._canon(c).v), "lazy_limbs")
            for c in (p.x, p.y, p.z)]


def _points(p: tuple) -> list:
    x, y, inf = gj.g2_to_affine(p)
    return [pc.g2_infinity() if i else pc.Point(Fq2.from_ints(*a), Fq2.from_ints(*b), pc.B2)
            for a, b, i in zip(fl.to_ints(x), fl.to_ints(y), inf.tolist())]


def test_g2_add_corner_lanes_match_jax_and_the_curve():
    p7, p11, inf = G2.mul(7), G2.mul(11), pc.g2_infinity()
    a = [p7, p7, p7, inf, p11, inf]
    b = [p11, p7, -p7, p11, inf, inf]
    got = gj.g2_add(_port(a), _port(b))
    assert _jac_ints_port(got) == _jac_ints_jax(jgj.g2_add(_jax(a), _jax(b)))
    assert _points(got) == [x + y for x, y in zip(a, b)]


def test_g2_dbl_corner_lanes_match_jax_and_the_curve():
    pts = [G2.mul(5), pc.g2_infinity(), G2]
    got = gj.g2_dbl(_port(pts))
    assert _jac_ints_port(got) == _jac_ints_jax(jgj.g2_dbl(_jax(pts)))
    assert _points(got) == [p + p for p in pts]


def test_mul_z_psi_and_clear_cofactor_match_the_jax_host():
    ks = [1, 2, 7]
    pts = [G2.mul(k) for k in ks]
    lanes = _port(pts)
    want_z = [jc.g2_to_bytes(JG2.mul(k).mul(jgj.BLS_X_ABS)) for k in ks]
    assert [pc.g2_to_bytes(p) for p in _points(gj.g2_mul_z(lanes))] == want_z
    psi = _points(gj.g2_psi(lanes))
    assert psi == [pc.F2.to_point(pc.psi_jac(pc.F2.from_point(p)), pc.B2) for p in pts]
    # psi acts on G2 as multiplication by the Frobenius eigenvalue p mod r
    from eth_consensus_specs_tpu.crypto.fields import P as JP
    from eth_consensus_specs_tpu.crypto.fields import R as JR

    assert [pc.g2_to_bytes(p) for p in psi] == [jc.g2_to_bytes(JG2.mul(k * JP % JR)) for k in ks]
    # a point off the subgroup: the isogeny image of one SSWU output
    off = jh2c.map_to_curve_g2(jh2c.hash_to_field_fq2(b"cofactor", 1)[0])
    port_off = convert.point_from_jax(off)
    cleared = _points(gj.g2_clear_cofactor(_port(pts + [port_off, pc.g2_infinity()])))
    want = [jc.g2_to_bytes(jh2c.clear_cofactor_g2(jc.g2_from_bytes(pc.g2_to_bytes(p))))
            for p in pts] + [jc.g2_to_bytes(jh2c.clear_cofactor_g2(off)), jc.g2_to_bytes(
                jc.g2_infinity())]
    assert [pc.g2_to_bytes(p) for p in cleared] == want


def test_to_affine_flags_infinity_with_zero_coordinates():
    x, y, inf = gj.g2_to_affine(_port([G2, pc.g2_infinity()]))
    assert inf.tolist() == [False, True]
    assert fl.to_ints(x)[1] == [0, 0] and fl.to_ints(y)[1] == [0, 0]
    assert fl.to_ints(x)[0] == [G2.x.c0.n, G2.x.c1.n]
