"""Batched BLS verification of the port on the CPU against the JAX package.

``verify_many``, ``batch_verify_aggregates`` and
``fast_aggregate_verify_device`` run with ``device="cpu"`` (the plain
versions of K10-K12); the JAX ``ops.bls_batch`` runs under its default
``pyspec`` backend (host sums and the host pairing). Verdict lists must be
equal on valid, invalid and mixed batches, on every parse rejection and
through the bisection. Blocks come from ``inputs.attestation_block`` (keys
k * G, seeded messages).
"""

import random

import pytest
import torch

from eth_consensus_specs_tpu.crypto import curve as jc
from eth_consensus_specs_tpu.crypto import signature as jsig
from eth_consensus_specs_tpu.ops import bls_batch as jbb
from eth_consensus_specs_tpu.utils import bls as jbls
from eth_consensus_specs_tpu_torch.crypto import curve as pc
from eth_consensus_specs_tpu_torch.inputs import attestation_block, g1_keys
from eth_consensus_specs_tpu_torch.ops import bls_batch as bb


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _port(items, seed=0):
    return bb.verify_many(items, device="cpu", rng=random.Random(seed))


def test_valid_batch_with_shared_messages():
    items, _ = attestation_block(4, 3, distinct=2, call=1)
    assert _port(items) == jbb.verify_many(items) == [True] * 4
    port = bb.batch_verify_aggregates(items, device="cpu")
    assert port is jbb.batch_verify_aggregates(items) is True
    assert bb.verify_many([], device="cpu") == [] and bb.batch_verify_aggregates([], device="cpu")


@pytest.mark.parametrize("tamper", [(2,), (1, 2)])
def test_bad_items_bisect_to_the_same_verdicts(tamper):
    items, _ = attestation_block(4, 2, distinct=4, call=2, tamper=tamper)
    want = [i not in tamper for i in range(4)]
    assert _port(items, seed=len(tamper)) == jbb.verify_many(items) == want


def test_invalid_batch():
    items, _ = attestation_block(3, 2, distinct=3, call=3, tamper=(1,))
    port = bb.batch_verify_aggregates(items, device="cpu")
    assert port is jbb.batch_verify_aggregates(items) is False


def test_parse_rejections():
    items, _ = attestation_block(1, 3, call=4)
    good = items[0]
    pks, msg, sig = good
    cases = [
        good,
        ([pks[0], b"\x00" * 48], msg, sig),  # malformed key
        ([pc.g1_to_bytes(pc.g1_infinity())], msg, sig),  # infinity key
        ([], msg, sig),  # empty committee
        (pks, msg, b"\x00" * 96),  # bad signature bytes
    ]
    assert _port(cases) == jbb.verify_many(cases) == [True, False, False, False, False]
    for bad in cases[1:]:
        assert bb.batch_verify_aggregates([good, bad], device="cpu") is False
        assert jbb.batch_verify_aggregates([good, bad]) is False


def test_fast_aggregate_verify_device():
    items, _ = attestation_block(2, 3, call=5)
    (pks, msg, sig), (_, other, _) = items
    for args in ((pks, msg, sig), (pks, other, sig), ([], msg, sig), ([b"\x00" * 48], msg, sig)):
        port = bb.fast_aggregate_verify_device(*args, device="cpu")
        assert port is jsig.fast_aggregate_verify(*args)
    assert bb.fast_aggregate_verify_device(pks, msg, sig, device="cpu") is True


def test_rlc_pubkey_terms_match_the_jax_package():
    items, _ = attestation_block(3, 5, call=6)
    rng = random.Random(11)
    parsed = [bb._parse_item(it, rng) for it in items]
    jparsed = [([jc.g1_from_bytes(pc.g1_to_bytes(p)) for p in pts], msg,
                jc.g2_from_bytes(pc.g2_to_bytes(sig)), r) for pts, msg, sig, r in parsed]
    got = bb._rlc_pubkey_terms(parsed, torch.device("cpu"))
    want = jbb._rlc_pubkey_terms(jparsed)
    assert [pc.g1_to_bytes(t) for t in got] == [jc.g1_to_bytes(t) for t in want]


def test_g2_rlc_sum_matches_the_jax_multi_exp():
    rng = random.Random(12)
    items, _ = attestation_block(5, 1, call=7)
    sigs = [pc.g2_from_bytes(sig) for _, _, sig in items] + [pc.g2_infinity()]
    scalars = [rng.getrandbits(64) | 1 for _ in sigs]
    got = bb.g2_multi_exp(sigs, scalars)
    want = jbls.multi_exp([jc.g2_from_bytes(pc.g2_to_bytes(s)) for s in sigs], scalars)
    assert pc.g2_to_bytes(got) == jc.g2_to_bytes(want)


def test_h2g2_cache_stays_bounded_and_keeps_the_call():
    marker = pc.g2_generator()
    calls = []

    def batch(msgs, dst):
        calls.append(len(msgs))
        return [marker] * len(msgs)

    bb._H2G2_CACHE.clear()
    first = [b"m%d" % i for i in range(400)]
    bb._prime_h2g2_cache(first, batch)
    second = first[:50] + [b"n%d" % i for i in range(300)]
    bb._prime_h2g2_cache(second, batch)
    assert calls == [400, 300]  # the 50 cached messages were not hashed again
    assert len(bb._H2G2_CACHE) <= bb._H2G2_MAX == 512
    assert all((bb.DST_G2, m) in bb._H2G2_CACHE for m in second)
    assert bb._h2g2(b"n7") is marker
    bb._H2G2_CACHE.clear()


def test_keys_are_k_times_g():
    keys = g1_keys(3, first=9)
    assert [pc.g1_to_bytes(k) for k in keys] == [
        jc.g1_to_bytes(jc.g1_generator().mul(k)) for k in (9, 10, 11)]


def test_signature_verbs_match_the_jax_package():
    from eth_consensus_specs_tpu_torch.crypto import signature as psig

    sks = [3, 1 << 200, jc.R - 1]
    assert [psig.sk_to_pk(k) for k in sks] == [jsig.sk_to_pk(k) for k in sks]
    sigs = [psig.sign(k, b"verbs") for k in sks]
    assert sigs == [jsig.sign(k, b"verbs") for k in sks]
    assert psig.aggregate(sigs) == jsig.aggregate(sigs)
    pks = [psig.sk_to_pk(k) for k in sks]
    assert psig.fast_aggregate_verify(pks, b"verbs", psig.aggregate(sigs))
    assert psig.key_validate(pks[0]) and not psig.key_validate(b"\x00" * 48)
    with pytest.raises(ValueError):
        psig.sk_to_pk(0)
    items, _ = attestation_block(2, 2, seed=1, call=8)
    assert [len(pk) for pk in items[0][0]] == [48, 48]
    assert all(psig.fast_aggregate_verify(*it) for it in items)
