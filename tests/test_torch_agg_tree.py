"""The committee aggregation tree of the port on the CPU (K15 and K10 through
their plain versions) against the JAX package.

A 64-validator slot over 8 subnets (committee 4, 2 roots, one invalid
committee, every 17th validator abstaining) from ``inputs.slot_committees``
goes through the port's ``aggregate_slot(device="cpu")`` and
``aggregate_slot_host`` and, carried over point for point, through the JAX
``aggregate_slot_host``: every tier must give the same compressed bytes and
participation bits. ``verify_slot`` and ``isolate_invalid_subnets`` must give
the JAX verdicts and exactly the injected (subnet, root) pair.
"""

import random

import numpy as np
import pytest
import torch

from eth_consensus_specs_tpu.crypto import curve as jc
from eth_consensus_specs_tpu.crypto.fields import Fq as JFq
from eth_consensus_specs_tpu.crypto.fields import Fq2 as JFq2
from eth_consensus_specs_tpu.ops import agg_tree as jat
from eth_consensus_specs_tpu_torch import convert
from eth_consensus_specs_tpu_torch.crypto import curve as pc
from eth_consensus_specs_tpu_torch.inputs import slot_committees
from eth_consensus_specs_tpu_torch.ops import agg_tree as at


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _to_jax_point(p):
    if isinstance(p.x, pc.Fq):
        return jc.Point(JFq(p.x.n), JFq(p.y.n), jc.B1)
    return jc.Point(JFq2.from_ints(p.x.c0.n, p.x.c1.n), JFq2.from_ints(p.y.c0.n, p.y.c1.n), jc.B2)


def _to_jax(att):
    return jat.CommitteeAttestation(att.subnet, att.root, tuple(map(_to_jax_point, att.pubkeys)),
                                    tuple(map(_to_jax_point, att.sigs)), att.bits)


def _tiers(result) -> list:
    slot, subs = result
    return ([(s.root, s.sig_bytes, s.pubkey_bytes, s.bits.tolist()) for s in slot],
            [(s.subnet, s.root, s.sig_bytes, s.pubkey_bytes, s.bits.tolist()) for s in subs])


@pytest.fixture(scope="module")
def slot():
    atts, bad = slot_committees(64, 8, 4, n_roots=2, invalid=1)
    return atts, bad, at.aggregate_slot(atts, device="cpu")


def test_registry_layout(slot):
    atts, bad, _ = slot
    assert len(atts) == 16 and [a.subnet for a in atts] == [c % 8 for c in range(16)]
    assert [a.root[0] for a in atts] == [1] * 8 + [2] * 8
    bits = np.concatenate([a.bits for a in atts])
    assert bits.tolist() == [v % 17 != 16 for v in range(64)]
    assert all(len(a.sigs) == len(a.pubkeys) == sum(a.bits) for a in atts)
    assert bad == [(0, bytes([1]) * 32)]
    good = atts[1]
    first = [v for v in range(4, 8) if v % 17 != 16][0]
    assert good.pubkeys[0] == pc.g1_generator().mul(first + 1)


def test_tiers_equal_the_jax_host_tree(slot):
    atts, _, device = slot
    jax_tiers = _tiers(jat.aggregate_slot_host([_to_jax(a) for a in atts]))
    assert _tiers(device) == jax_tiers
    assert _tiers(at.aggregate_slot_host(atts)) == jax_tiers
    assert at.aggregate_slot([], device="cpu") == ([], []) == at.aggregate_slot_host([])


def test_attestations_carry_from_the_jax_package(slot):
    atts, _, _ = slot
    back = [convert.attestation_from_jax(_to_jax(a)) for a in atts[:3]]
    assert back == atts[:3]
    assert convert.point_from_jax(jc.g2_infinity()).is_infinity()


def test_verdicts_and_isolation_equal_the_jax_ones(slot):
    _, bad, (slot_aggs, subnet_aggs) = slot
    got = at.verify_slot(slot_aggs, device="cpu", rng=random.Random(5))
    assert got == [False, True]  # root 1 holds the invalid committee
    jslot = [jat.SlotAggregate(s.root, _to_jax_point(s.sig), _to_jax_point(s.pubkey), s.bits)
             for s in slot_aggs]
    assert jat.verify_slot(jslot) == got
    isolated = at.isolate_invalid_subnets(subnet_aggs, device="cpu", rng=random.Random(6))
    assert isolated == bad
    jsubs = [jat.SubnetAggregate(s.subnet, s.root, _to_jax_point(s.sig),
                                 _to_jax_point(s.pubkey), s.bits) for s in subnet_aggs]
    assert jat.isolate_invalid_subnets(jsubs) == isolated
    clean = [s for s in subnet_aggs if (s.subnet, s.root) not in bad]
    assert at.isolate_invalid_subnets(clean, device="cpu") == []
