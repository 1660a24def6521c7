"""The port's batched KZG blob verification on the CPU (the plain versions
of K16, K17, K11 and K12) against the JAX package's ``ops/kzg_batch.py``
and the host oracle ``crypto.kzg``.

The JAX side runs under ``ETH_SPECS_KZG_HOST_EVAL=1`` (its challenge
evaluations by the host barycentric form: exact ints, equal to its device
FFT's by construction; the device FFT at 4096 is the one ``slow`` test) and
with its RLC lane bucket held at 16, so its multi-MSM compiles once for the
file at one shape (most of a minute on XLA:CPU). Verdicts compare item by
item, values as ints, points as compressed bytes.
"""

import json

import pytest
import torch

from eth_consensus_specs_tpu.crypto import kzg as jkzg
from eth_consensus_specs_tpu.crypto import kzg_setup as jsetup
from eth_consensus_specs_tpu.ops import kzg_batch as jkb
from eth_consensus_specs_tpu.serve import buckets as jbuckets
from eth_consensus_specs_tpu.test_infra import blob as jblob
from eth_consensus_specs_tpu_torch.crypto import kzg, kzg_setup
from eth_consensus_specs_tpu_torch.crypto.fields import R
from eth_consensus_specs_tpu_torch.inputs import blob_flush, sparse_blob_triple
from eth_consensus_specs_tpu_torch.ops import kzg_batch

JAX_LANES = 16


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def jax_host_eval():
    """The JAX package with host challenge evaluations and one MSM shape."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("ETH_SPECS_KZG_HOST_EVAL", "1")
        mp.setattr(jbuckets, "kzg_msm_key", lambda n, mesh=None: ("kzg", JAX_LANES))
        yield


@pytest.fixture(scope="module")
def triples():
    return [sparse_blob_triple(i) for i in range(3)]


def _tampered():
    return sparse_blob_triple(3, tamper=True)


# ----------------------------------------------------------- the setup --


def test_setup_file_is_the_jax_package_file_byte_for_byte():
    port_path = kzg_setup.setup_path(4096)
    assert "eth_consensus_specs_tpu_torch" in port_path and port_path != jsetup.setup_path(4096)
    with open(port_path, "rb") as a, open(jsetup.setup_path(4096), "rb") as b:
        assert a.read() == b.read()


def test_generated_toy_setup_equals_the_jax_package():
    port = kzg_setup.generate_setup(n=16, g2_length=2)
    assert port == jsetup.generate_setup(n=16, g2_length=2)
    assert kzg_setup.testing_tau() == jsetup.testing_tau()
    with open(kzg_setup.setup_path(4096)) as f:
        shipped = json.load(f)
    assert shipped["provenance"] == port["provenance"]
    assert shipped["g2_monomial"][:2] == port["g2_monomial"]


def test_blob_builders_equal_the_jax_package():
    assert sparse_blob_triple(1, degree=8) == jblob.sparse_blob_triple(1, degree=8)
    assert _tampered() == jblob.sparse_blob_triple(3, tamper=True)
    items, bad = blob_flush(4, degree=5, invalid=2)
    assert bad == {0, 2}
    assert items == [jblob.sparse_blob_triple(i, degree=5, tamper=i in bad) for i in range(4)]


# --------------------------------------------------------------- parsing --


def _parse_cases(triples):
    blob, c, p = triples[0]
    return [
        (blob, c, p),
        (blob[:-1], c, p),  # short blob
        (blob, c[:-1], p),  # short commitment
        (blob, c, p + b"\x00"),  # long proof
        (R.to_bytes(32, "big") + blob[32:], c, p),  # field element >= r
        (blob, b"\x01" * 48, p),  # not a point (compression bit clear)
        (blob, c, b"\x01" * 48),
        (blob, kzg.G1_POINT_AT_INFINITY, kzg.G1_POINT_AT_INFINITY),  # infinity is valid
        (blob, b"\xa0" + b"\x00" * 46 + b"\x05", p),  # x not on the curve
    ]


@pytest.mark.parametrize("case", range(9))
def test_parse_item_surface_equals_the_jax_package(triples, case):
    item = _parse_cases(triples)[case]
    port, ref = kzg_batch.parse_item(item), jkb.parse_item(item)
    assert (port is None) == (ref is None)
    assert kzg_batch.verify_blob_host(*item) is jkb.verify_blob_host(*item)
    if ref is not None:
        assert port[:2] + port[3:6] == ref[:2] + ref[3:6]
        assert [kzg.g1_to_bytes(port[i]) for i in (2, 6)] == [jkzg.g1_to_bytes(ref[i])
                                                               for i in (2, 6)]


# ------------------------------------------------------ evaluations, verdicts --


def test_challenge_evaluations_equal_the_jax_package(triples, jax_host_eval):
    port = [kzg_batch.parse_item(t) for t in triples]
    ref = [jkb.parse_item(t) for t in triples]
    in_domain = list(port[0])
    in_domain[4] = kzg._roots_brp(kzg.FIELD_ELEMENTS_PER_BLOB)[7]  # z on a root of unity
    ys = kzg_batch.challenge_evaluations(port + [tuple(in_domain)], device="cpu")
    ref_in_domain = list(ref[0])
    ref_in_domain[4] = in_domain[4]
    assert ys == jkb.challenge_evaluations(ref + [tuple(ref_in_domain)])
    assert ys[:3] == [kzg.evaluate_polynomial_in_evaluation_form(p[3], p[4]) for p in port]
    assert ys[3] == port[0][3][7]


def test_verify_many_blobs_equals_the_jax_package(triples, jax_host_eval):
    items = triples + [_tampered(), (triples[0][0][:100], triples[0][1], triples[0][2])]
    want = [True, True, True, False, False]
    assert kzg_batch.verify_many_blobs(items, device="cpu") == jkb.verify_many_blobs(items) == want
    assert [kzg_batch.verify_blob_host(*it) for it in items] == want
    assert kzg_batch.verify_many_blobs([], device="cpu") == []
    assert kzg_batch.verify_many_blobs(items[4:], device="cpu") == [False]


def test_batch_device_verdicts_equal_the_jax_package(triples, jax_host_eval):
    cols = [list(c) for c in zip(*triples)]
    assert kzg_batch.verify_blob_kzg_proof_batch_device(*cols, device="cpu") is True
    assert jkb.verify_blob_kzg_proof_batch_device(*cols) is True
    assert kzg.verify_blob_kzg_proof_batch(*cols) is True
    bad = [list(c) for c in zip(*(triples[:2] + [_tampered()]))]
    assert kzg_batch.verify_blob_kzg_proof_batch_device(*bad, device="cpu") is False
    assert jkb.verify_blob_kzg_proof_batch_device(*bad) is False
    assert kzg_batch.verify_blob_kzg_proof_batch_device([], [], [], device="cpu") is True
    malformed = [cols[0][:1], [b"\x01" * 48], cols[2][:1]]
    with pytest.raises(AssertionError):
        kzg_batch.verify_blob_kzg_proof_batch_device(*malformed, device="cpu")
    with pytest.raises(AssertionError):
        jkb.verify_blob_kzg_proof_batch_device(*malformed)


def test_rlc_lincombs_fold_the_spec_batch(triples):
    """The two MSMs of one check are the spec's three lincombs folded by
    linearity: A is the proof lincomb and B is the commitment-minus-y plus
    proof-times-z lincombs (crypto.kzg.verify_kzg_proof_batch)."""
    from eth_consensus_specs_tpu_torch.crypto.curve import g1_generator
    from eth_consensus_specs_tpu_torch.crypto.msm import msm_g1

    parsed = [kzg_batch.parse_item(t) for t in triples]
    ys = kzg_batch.challenge_evaluations(parsed, device="cpu")
    (a_pts, b_pts), (a_k, b_k) = kzg_batch.rlc_lincombs(parsed, ys)
    assert len(a_pts) == 3 and len(b_pts) == 7 and a_k == b_k[:3]
    r = a_k
    c_minus_y = msm_g1([p[2] + g1_generator().mul(-y % R) for p, y in zip(parsed, ys)], r)
    proof_z = msm_g1([p[6] for p in parsed], [p[4] * k % R for p, k in zip(parsed, r)])
    assert msm_g1(b_pts, b_k) == c_minus_y + proof_z


def test_the_entry_points_need_a_device_or_a_card(triples):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is the card")
    with pytest.raises(RuntimeError):
        kzg_batch.verify_many_blobs(triples)


@pytest.mark.slow
def test_challenge_evaluations_equal_the_jax_device_fft(triples, monkeypatch):
    """The JAX package's own device FFT at 4096 points (XLA:CPU) against
    the port's K16 plain version, on the same parsed items."""
    monkeypatch.delenv("ETH_SPECS_KZG_HOST_EVAL", raising=False)
    port = [kzg_batch.parse_item(t) for t in triples]
    ref = [jkb.parse_item(t) for t in triples]
    assert kzg_batch.challenge_evaluations(port, device="cpu") == jkb.challenge_evaluations(ref)
