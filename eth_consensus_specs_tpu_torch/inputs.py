"""Deterministic example inputs, made without the JAX package.

The port's own copy of ``__graft_entry__._example_inputs`` (phase0) and
``_example_altair_inputs``: the same numpy generators (seeds 1234 and
4321) drawn in the same order, so the columns are identical to the JAX
package's at every size. ``chip_smoke.py`` builds its states from these and
``ops.state_root.synthetic_static``.
"""

from __future__ import annotations

import hashlib

import numpy as np
import torch

from .device import default_device
from .ops.altair_epoch import AltairEpochColumns
from .ops.state_columns import EpochColumns, JustificationState

U64_MAX = np.iinfo(np.uint64).max
HALF_SLASHINGS_VECTOR = 4096  # EPOCHS_PER_SLASHINGS_VECTOR // 2, mainnet
ALTAIR_CORNERS = ("epoch0", "epoch1", "epoch2", "leak", "all_slashed", "far_future_wide")
PHASE0_CORNERS = ALTAIR_CORNERS


def _t(a: np.ndarray, dev) -> torch.Tensor:
    a = np.ascontiguousarray(a)
    if a.dtype == np.uint64:
        a = a.view(np.int64)
    return torch.from_numpy(a).to(dev)


def _phase0_numpy(n: int, epoch: int, half_vector: int) -> dict:
    """The phase0 columns of ``_example_inputs`` as numpy arrays, drawn from
    ``default_rng(1234)`` in its order."""
    rng = np.random.default_rng(1234)
    max_eff = np.uint64(32_000_000_000)
    incr = np.uint64(1_000_000_000)
    eff = (rng.integers(17, 33, n).astype(np.uint64)) * incr
    bal = eff + rng.integers(0, 10**9, n).astype(np.uint64)
    slashed = rng.random(n) < 0.01
    act = np.zeros(n, np.uint64)
    exitep = np.full(n, U64_MAX, np.uint64)
    exited = rng.random(n) < 0.02
    exitep[exited] = epoch - 1
    wd = np.full(n, U64_MAX, np.uint64)
    in_window = slashed & (rng.random(n) < 0.5)
    wd[slashed] = epoch + 4  # slashed but outside the penalty window
    wd[in_window] = epoch + half_vector  # penalty applies
    src = rng.random(n) < 0.9
    tgt = src & (rng.random(n) < 0.95)
    head = tgt & (rng.random(n) < 0.9)
    cur_tgt = rng.random(n) < 0.8
    delay = rng.integers(1, 9, n).astype(np.uint64)
    proposer = rng.integers(0, n, n)
    return dict(
        effective_balance=np.minimum(eff, max_eff), balance=bal, slashed=slashed,
        activation_epoch=act, exit_epoch=exitep, withdrawable_epoch=wd, src_att=src,
        tgt_att=tgt, head_att=head, cur_tgt_att=cur_tgt, incl_delay=delay,
        incl_proposer=proposer,
    )


def _example_just(epoch: int, dev) -> JustificationState:
    def root(b: int) -> torch.Tensor:
        return torch.full((32,), b, dtype=torch.uint8, device=dev)

    def u64(v: int) -> torch.Tensor:
        return torch.tensor(v, dtype=torch.int64, device=dev)

    return JustificationState(
        current_epoch=u64(epoch),
        justification_bits=torch.tensor([True, True, False, False], device=dev),
        prev_justified_epoch=u64(epoch - 2),
        prev_justified_root=root(1),
        cur_justified_epoch=u64(epoch - 1),
        cur_justified_root=root(2),
        finalized_epoch=u64(epoch - 3),
        finalized_root=root(3),
        block_root_prev=root(4),
        block_root_cur=root(5),
        slashings_sum=u64(64_000_000_000),
    )


def example_inputs(n_validators: int, epoch: int = 10,
                   slashings_half_vector: int = HALF_SLASHINGS_VECTOR, device=None):
    """(EpochColumns, JustificationState) of ``n_validators`` on ``device``:
    the phase0 columns of ``__graft_entry__._example_inputs``, with
    FAR_FUTURE_EPOCH exits, ~1% slashed (half of them inside the
    correlated-slashing window of ``slashings_half_vector`` epochs),
    attestation masks, inclusion delays 1-8 and random includers."""
    dev = default_device(device)
    cols = _phase0_numpy(n_validators, epoch, slashings_half_vector)
    return EpochColumns(**{k: _t(v, dev) for k, v in cols.items()}), _example_just(epoch, dev)


def example_altair_inputs(n_validators: int, epoch: int = 10, electra: bool = False, device=None):
    """(AltairEpochColumns, JustificationState) of ``n_validators`` on
    ``device``: the phase0 example's registry with random participation
    flags and scores in place of the attestation masks; with ``electra``,
    ~10% of validators carry the 2048 ETH ceiling."""
    dev = default_device(device)
    n = n_validators
    base = _phase0_numpy(n, epoch, HALF_SLASHINGS_VECTOR)
    rng = np.random.default_rng(4321)
    prev_flags = (
        rng.integers(0, 2, n) * 1 + rng.integers(0, 2, n) * 2 + rng.integers(0, 2, n) * 4
    ).astype(np.uint8)
    max_eb = None
    if electra:
        compounding = rng.random(n) < 0.1
        max_eb = np.where(
            compounding, np.uint64(2_048_000_000_000), np.uint64(32_000_000_000)
        ).astype(np.uint64)
    scores = rng.integers(0, 50, n).astype(np.uint64)

    cols = AltairEpochColumns(
        **{k: _t(base[k], dev) for k in AltairEpochColumns._fields if k in base},
        prev_flags=_t(prev_flags, dev),
        inactivity_scores=_t(scores, dev),
        max_effective_balance=None if max_eb is None else _t(max_eb, dev),
    )
    return cols, _example_just(epoch, dev)


def _corner(case: str, n: int, make, half_vector: int, dev):
    """The corner ``case`` of the columns ``make(epoch)`` builds; the
    caller widens its own fork-specific columns for ``far_future_wide``."""
    def u64(v: int) -> torch.Tensor:
        return torch.tensor(v, dtype=torch.int64, device=dev)

    if case in ("epoch0", "epoch1", "epoch2"):
        cols, just = make(3)
        return cols, just._replace(current_epoch=u64(int(case[5:])), prev_justified_epoch=u64(0),
                                   cur_justified_epoch=u64(0), finalized_epoch=u64(0))
    if case == "leak":
        cols, just = make(100)
        return cols, just._replace(justification_bits=torch.zeros_like(just.justification_bits),
                                   prev_justified_epoch=u64(3), cur_justified_epoch=u64(3),
                                   finalized_epoch=u64(3))
    epoch = 10
    cols, just = make(epoch)
    even = torch.arange(n, device=dev) % 2 == 0
    if case == "all_slashed":
        return cols._replace(
            slashed=torch.ones_like(cols.slashed),
            withdrawable_epoch=torch.where(even, u64(epoch + half_vector), u64(epoch + 4)),
        ), just
    if case == "far_future_wide":
        far = u64(-1)  # FAR_FUTURE_EPOCH = 2**64 - 1 in an int64 lane
        idx = torch.arange(n, device=dev)
        in_window = cols.slashed & even
        return cols._replace(
            activation_epoch=torch.where(idx % 5 == 0, far, cols.activation_epoch),
            exit_epoch=far.expand(n).clone(),
            withdrawable_epoch=torch.where(in_window, u64(epoch + half_vector), far),
        ), just._replace(slashings_sum=u64(1 << 62))
    raise ValueError(f"unknown corner {case!r}; expected one of {ALTAIR_CORNERS}")


def altair_corner_inputs(case: str, n_validators: int, electra: bool = False, device=None):
    """``example_altair_inputs`` bent to one corner of the accounting epoch
    (a name of ``ALTAIR_CORNERS``):

    - ``epoch0``..``epoch2``: the genesis epochs, nothing justified yet;
    - ``leak``: epoch 100, nothing justified or finalized since epoch 3, so
      this epoch cannot finalize and the chain is in an inactivity leak;
    - ``all_slashed``: every validator slashed, half inside the penalty window;
    - ``far_future_wide``: FAR_FUTURE_EPOCH in every exit and withdrawable
      lane outside the penalty window and in a fifth of the activations;
      scores of 2^40 and a slashings sum of 2^62, so the u64 products wrap
      and the dividends pass 2^63.
    """
    dev = default_device(device)
    cols, just = _corner(case, n_validators, lambda e: example_altair_inputs(
        n_validators, epoch=e, electra=electra, device=dev), HALF_SLASHINGS_VECTOR, dev)
    if case == "far_future_wide":
        idx = torch.arange(n_validators, device=dev)
        cols = cols._replace(inactivity_scores=torch.where(
            idx % 3 == 0, torch.tensor(1 << 40, device=dev), cols.inactivity_scores))
    return cols, just


def phase0_corner_inputs(case: str, n_validators: int,
                         slashings_half_vector: int = HALF_SLASHINGS_VECTOR, device=None):
    """``example_inputs`` bent to one corner of the phase0 accounting epoch
    (a name of ``PHASE0_CORNERS``), as ``altair_corner_inputs`` bends the
    altair columns; ``far_future_wide`` also gives every third attester an
    inclusion delay of 2^40 and a seventh of the includers indices below 0
    and past the registry, which the proposer scatter clips."""
    dev = default_device(device)
    n = n_validators
    cols, just = _corner(case, n, lambda e: example_inputs(
        n, epoch=e, slashings_half_vector=slashings_half_vector, device=dev),
        slashings_half_vector, dev)
    if case == "far_future_wide":
        idx = torch.arange(n, device=dev)
        prop = torch.where(idx % 7 == 0, -1 - idx, cols.incl_proposer)
        cols = cols._replace(
            incl_delay=torch.where(idx % 3 == 0, torch.tensor(1 << 40, device=dev), cols.incl_delay),
            incl_proposer=torch.where(idx % 7 == 1, n + idx, prop),
        )
    return cols, just


def lower_balances(cols: AltairEpochColumns, every: int = 256, gwei: int = 2_000_000_000):
    """``cols`` with the balance of every ``every``-th validator lowered by
    ``gwei``: 2 ETH takes each of them below its effective balance by more
    than the downward hysteresis threshold, so the next epoch's effective
    balance update crosses at all of them (a registry after mass slashings
    or leak ejections)."""
    idx = torch.arange(cols.balance.shape[0], device=cols.balance.device)
    return cols._replace(balance=torch.where(idx % every == 0, cols.balance - gwei, cols.balance))


# --- a block of attestation aggregates ------------------------------------------


def g1_keys(count: int, first: int = 1) -> list:
    """The G1 points k * G for k = first, ..., first + count - 1."""
    from .crypto.curve import g1_generator

    return point_multiples(g1_generator(), first, count)


def block_message(call: int, i: int) -> bytes:
    """The signed message of aggregate ``i`` in block ``call``."""
    return hashlib.sha256(b"block-att-%d-%d" % (call, i)).digest()


def attestation_block(items: int, committee: int, distinct: int | None = None, seed: int = 0,
                      call: int = 0, tamper=(), keys: list | None = None) -> tuple[list, list]:
    """A block of attestation aggregates in the JAX form: a list of
    (pubkeys: list[bytes], message: bytes, signature: bytes), and the
    secret-key sum of each item.

    Item i's committee is the keys k * G, k = first + i * committee + j
    (first = 1 + seed * 2^24), so its aggregate secret is the sum of its k
    and its aggregate signature (sum k) * H(m) is one G2 multiplication.
    Item i signs ``block_message(call, i % distinct)``; an item in
    ``tamper`` carries another message under the same signature, so it does
    not verify. ``keys`` (from ``g1_keys`` with the same first key) skips
    making the points again."""
    from .crypto.curve import g1_to_bytes, g2_to_bytes
    from .crypto.hash_to_curve import hash_to_g2

    distinct = distinct or items
    first = 1 + seed * (1 << 24)
    keys = keys if keys is not None else g1_keys(items * committee, first)
    if len(keys) < items * committee:
        raise ValueError(f"need {items * committee} keys, got {len(keys)}")
    pk_bytes = [g1_to_bytes(p) for p in keys[: items * committee]]
    h = {}
    out, secrets = [], []
    for i in range(items):
        msg = block_message(call, i % distinct)
        if msg not in h:
            h[msg] = hash_to_g2(msg)
        ks = range(first + i * committee, first + (i + 1) * committee)
        sk = sum(ks)
        sig = g2_to_bytes(h[msg].mul(sk))
        signed = msg if i not in tamper else hashlib.sha256(b"tampered-%d-%d" % (call, i)).digest()
        out.append((pk_bytes[i * committee:(i + 1) * committee], signed, sig))
        secrets.append(sk)
    return out, secrets


# --- one slot's committee contributions -----------------------------------------


def point_multiples(base, first: int, count: int) -> list:
    """The points k * base for k = first, ..., first + count - 1 (G1 or G2),
    made by successive Jacobian additions of base and one batch inversion."""
    from .crypto.curve import Point, _field_of, jac_add

    F = _field_of(base)
    g = F.from_point(base)
    j = F.from_point(base.mul(first))
    jac = []
    for _ in range(count):
        jac.append(j)
        j = jac_add(F, j, g)
    prefix = [F.one]
    for _, _, z in jac:
        prefix.append(F.mul(prefix[-1], z))
    inv = F.inv(prefix[-1])
    out = [None] * count
    for i in range(count - 1, -1, -1):
        x, y, z = jac[i]
        zi = F.mul(inv, prefix[i])
        inv = F.mul(inv, z)
        zi2 = F.sqr(zi)
        out[i] = F.to_point((F.mul(x, zi2), F.mul(F.mul(y, zi2), zi), F.one), base.b)
    return out


def slot_committees(n_validators: int, subnets: int, committee: int, n_roots: int = 2,
                    invalid: int = 0, drop: int = 17) -> tuple[list, list]:
    """One slot's committee contributions, the port's copy of
    ``scripts/agg_bench.py:81`` ``build_registry``: validator i holds
    sk = i + 1 (key (i + 1) * G1, signature (i + 1) * H(root)); committees
    are contiguous index ranges, committee c on subnet c % subnets;
    attestation data roots (``bytes([r + 1]) * 32``) go to contiguous
    blocks of committees; every ``drop``-th validator abstains (its bit is
    clear, it contributes nothing); the first participant of each of
    ``invalid`` evenly spread committees signs garbage (its signature plus
    G2's generator, still in the subgroup). Keys and signatures are made by
    incremental additions, no scalar multiplication per validator. Returns
    (attestations, the sorted (subnet, root) pairs that must not verify)."""
    from .crypto.curve import g2_generator
    from .crypto.hash_to_curve import hash_to_g2
    from .ops.agg_tree import CommitteeAttestation

    n_committees = max(n_validators // committee, 1)
    roots = [bytes([r + 1]) * 32 for r in range(n_roots)]
    bad_committees = {(i * n_committees) // invalid for i in range(invalid)} if invalid else set()
    root_of = [roots[(c * n_roots) // n_committees] for c in range(n_committees)]
    pks = g1_keys(n_committees * committee)
    sigs = []
    c = 0
    while c < n_committees:  # one run of signatures per block of committees sharing a root
        end = c
        while end < n_committees and root_of[end] == root_of[c]:
            end += 1
        sigs += point_multiples(hash_to_g2(root_of[c]), c * committee + 1, (end - c) * committee)
        c = end
    g2 = g2_generator()
    atts, expected_bad = [], set()
    for c in range(n_committees):
        members, bits = [], []
        for v in range(c * committee, (c + 1) * committee):
            absent = drop > 0 and v % drop == drop - 1
            bits.append(not absent)
            if not absent:
                members.append(v)
        csigs = [sigs[v] for v in members]
        if c in bad_committees and csigs:
            csigs[0] = csigs[0] + g2
            expected_bad.add((c % subnets, root_of[c]))
        atts.append(CommitteeAttestation(subnet=c % subnets, root=root_of[c],
                                         pubkeys=tuple(pks[v] for v in members),
                                         sigs=tuple(csigs), bits=tuple(bits)))
    return atts, sorted(expected_bad)


# --- KZG blobs ------------------------------------------------------------------
# The port's copy of ``eth_consensus_specs_tpu/test_infra/blob.py``. A sparse
# blob is a full 4096-element blob whose polynomial has only ``degree``
# monomial coefficients: its commitment and proof are ``degree``-lane MSMs
# over the monomial setup points, cheap to make, while a verifier still does
# the full 4096-point work on it.


def sample_blob(tag: bytes) -> bytes:
    """Deterministic pseudo-random blob: one canonical field element per
    position, seeded by ``tag``."""
    from .crypto import kzg

    out = []
    for i in range(kzg.FIELD_ELEMENTS_PER_BLOB):
        h = hashlib.sha256(tag + i.to_bytes(4, "big")).digest()
        out.append((int.from_bytes(h, "big") % kzg.BLS_MODULUS).to_bytes(32, "big"))
    return b"".join(out)


def sparse_poly_blob(coeffs: list[int]) -> bytes:
    """The blob (brp evaluation form) of a low-degree monomial polynomial:
    its evaluations at the brp-ordered roots of unity, each a Horner walk."""
    from .crypto import kzg

    out = []
    for w in kzg._roots_brp(kzg.FIELD_ELEMENTS_PER_BLOB):
        acc = 0
        for c in reversed(coeffs):
            acc = (acc * w + c) % kzg.BLS_MODULUS
        out.append(kzg.bls_field_to_bytes(acc))
    return b"".join(out)


def sparse_commit(coeffs: list[int]) -> bytes:
    from .crypto import kzg

    return kzg.g1_lincomb(kzg.get_setup().g1_monomial[: len(coeffs)], coeffs)


def sparse_proof(coeffs: list[int], blob: bytes, commitment: bytes) -> bytes:
    """The KZG proof at the Fiat-Shamir challenge by synthetic division of
    the coefficients: q(X) = (f(X) - f(z)) / (X - z)."""
    from .crypto import kzg

    z = kzg.compute_challenge(blob, commitment)
    q = [0] * (len(coeffs) - 1)
    acc = 0
    for j in range(len(coeffs) - 1, 0, -1):
        acc = (coeffs[j] + acc * z) % kzg.BLS_MODULUS
        q[j - 1] = acc
    if not q:
        return kzg.G1_POINT_AT_INFINITY
    return kzg.g1_lincomb(kzg.get_setup().g1_monomial[: len(q)], q)


def sparse_blob_triple(seed: int, degree: int = 6, tamper: bool = False) -> tuple:
    """One (blob, commitment, proof) triple from a seeded sparse polynomial;
    ``tamper`` shifts the proof by the generator (still on the curve and in
    the subgroup: a False verdict, not a parse reject)."""
    from .crypto import kzg
    from .crypto.curve import g1_from_bytes, g1_generator, g1_to_bytes

    coeffs = [(seed * 1009 + j * 31 + 1) % kzg.BLS_MODULUS for j in range(degree)]
    blob = sparse_poly_blob(coeffs)
    commitment = sparse_commit(coeffs)
    proof = sparse_proof(coeffs, blob, commitment)
    if tamper:
        proof = g1_to_bytes(g1_from_bytes(proof) + g1_generator())
    return blob, commitment, proof


def dense_blob_triple(tag: bytes) -> tuple:
    """A (blob, commitment, proof) triple of a ``sample_blob``: every
    coefficient non-zero, commitment and proof by the host's 4096-lane
    MSMs (a few seconds each in pure Python)."""
    from .crypto import kzg

    blob = sample_blob(tag)
    commitment = kzg.blob_to_kzg_commitment(blob)
    return blob, commitment, kzg.compute_blob_kzg_proof(blob, commitment)


def blob_flush(n: int, degree: int = 8, invalid: int = 0, dense: dict | None = None) -> tuple:
    """A flush of ``n`` sparse triples as ``scripts/das_bench.py``'s
    ``build_blobs`` makes them (item i from seed i, ``invalid`` evenly spread
    items tampered, at i * n / invalid), with the items named in ``dense``
    (index -> triple) put in their place. Returns (items, the tampered
    indices)."""
    bad = {(i * n) // invalid for i in range(invalid)} if invalid else set()
    dense = dense or {}
    if bad & set(dense):
        raise ValueError(f"dense items {sorted(dense)} overlap the tampered {sorted(bad)}")
    items = [dense[i] if i in dense else sparse_blob_triple(i, degree=degree, tamper=i in bad)
             for i in range(n)]
    return items, bad


# --- a schedule of whole slots --------------------------------------------------


SLOT_PARTICIPATION = 0.9  # scripts/slot_bench.py's share of set committee bits
SLOT_BLOB_DEGREE = 8  # scripts/das_bench.py's sparse blobs


def slot_schedule(n_validators: int, slots: int = 8, committees: int = 64, committee=512,
                  subnets: int = 64, keys: int | None = None, pubkeys: list | None = None,
                  sync_size: int = 512, blobs: int = 6, slots_per_epoch: int = 8, spoil=(),
                  seed: int = 0) -> list:
    """Slot requests (``ops.slot_pipeline.SlotRequest``) in the request shape
    of ``scripts/slot_bench.py`` ``build_schedule``, from ``seed``:

    - ``committees`` attestations a slot, committee c on subnet c % subnets,
      its own random data root; members are contiguous registry ranges (the
      next committee starts where the last ended, wrapping at the registry's
      end) of ``committee`` validators, or of a size drawn from [lo, hi] for a
      pair; each member's bit is set with probability ``SLOT_PARTICIPATION``;
    - a sync aggregate of ``sync_size`` registry indices drawn with
      replacement, so that duplicates occur, over one random message;
    - ``blobs`` sparse triples (``sparse_blob_triple``, degree
      ``SLOT_BLOB_DEGREE``);
    - ``epoch_boundary`` on every ``slots_per_epoch``-th slot.

    Validator v signs with sk = 1 + (v mod ``keys``) (the request carries
    its own pubkeys, so any fixed mapping works; ``keys`` defaults to the
    registry size): an aggregate signature is (sum of sk) * H(root), one G2
    multiplication. ``pubkeys`` (the compressed keys of sk = 1 .. keys)
    skips making them again. ``spoil`` holds (kind, slot, index) triples:
    ``("att", s, i)`` signs attestation i of slot s with the wrong key,
    ``("sync", s, 0)`` the sync aggregate of slot s, ``("blob", s, i)``
    shifts blob i's proof by the generator. A committee whose members would
    share a key raises ``ValueError``."""
    from .crypto.curve import g1_to_bytes, g2_to_bytes
    from .crypto.hash_to_curve import hash_to_g2
    from .ops.slot_pipeline import SlotAttestation, SlotRequest

    n = n_validators
    k = int(keys or n)
    if pubkeys is None:
        pubkeys = [g1_to_bytes(p) for p in g1_keys(k)]
    if len(pubkeys) < k:
        raise ValueError(f"need {k} pubkeys, got {len(pubkeys)}")
    spoil = {tuple(s) for s in spoil}
    rng = np.random.default_rng(seed)
    lo, hi = (committee, committee) if isinstance(committee, int) else committee

    def sign(message: bytes, secrets: list, bad: bool) -> bytes:
        return g2_to_bytes(hash_to_g2(message).mul(sum(secrets) + int(bad)))

    reqs, start = [], 0
    for s in range(slots):
        atts = []
        for c in range(committees):
            size = int(rng.integers(lo, hi + 1))
            members = [(start + j) % n for j in range(size)]
            start = (start + size) % n
            if len({v % k for v in members}) != size:
                raise ValueError(f"committee {c} of slot {s} repeats a key (keys={k})")
            bits = rng.random(size) < SLOT_PARTICIPATION
            if not bits.any():
                bits[0] = True
            root = rng.integers(0, 256, 32, dtype=np.uint8).tobytes()
            signers = [v for v, b in zip(members, bits) if b]
            atts.append(SlotAttestation(
                subnet=c % subnets, root=root, committee=tuple(members),
                bits=tuple(bool(b) for b in bits),
                pubkeys=tuple(pubkeys[v % k] for v in signers),
                sig=sign(root, [1 + v % k for v in signers], ("att", s, c) in spoil)))
        sync_idx = [int(v) for v in rng.integers(0, n, sync_size)]
        sync_msg = rng.integers(0, 256, 32, dtype=np.uint8).tobytes()
        reqs.append(SlotRequest(
            slot=s, attestations=tuple(atts),
            sync_pubkeys=tuple(pubkeys[v % k] for v in sync_idx), sync_message=sync_msg,
            sync_sig=sign(sync_msg, [1 + v % k for v in sync_idx], ("sync", s, 0) in spoil),
            sync_indices=tuple(sync_idx),
            blobs=tuple(sparse_blob_triple((seed << 20) + s * blobs + b + 1,
                                           degree=SLOT_BLOB_DEGREE, tamper=("blob", s, b) in spoil)
                        for b in range(blobs)),
            epoch_boundary=(s + 1) % slots_per_epoch == 0))
    return reqs


# --- the block-epoch plane: K19's corners ------------------------------------------

BLOCK_SLOT_CORNERS = ("cell", "wrap", "full_payload", "partial_payload", "repeat_rows",
                      "pay_runs", "sync_proposer", "sync_repeats", "dup_deposits",
                      "high_balances", "all_pad")


def block_slot_corners(params, n_validators: int, atts_per_slot: int = 128, seed: int = 11,
                       device=None) -> dict:
    """K19's corners on ``device``, each (BlockState, one slot's
    BlockColumns, BlockEpochStatic), all of one shape: the first slot of
    ``ops.block_epoch.synthetic_block_columns(params, n, seed,
    atts_per_slot)`` (``"cell"``), bent to

    - ``wrap``: the withdrawal window starts 8 validators before the end of
      the registry, the last 8 not eligible but one fully withdrawable, so
      the payload straddles the wrap;
    - ``full_payload``: withdrawable epochs at the epoch (paid) and one past
      it (not) among the partial withdrawals of a full payload;
    - ``partial_payload``: no balance above the maximum but at five
      validators (three partial, two full withdrawals), so the pointer skips
      the whole sweep;
    - ``repeat_rows``: rows 1, 2 and the last repeat row 0's committee, with
      other flags and the other participation column;
    - ``pay_runs``: one pay row in the middle, the rest unpaid, so the
      numerator carries across runs and is left over after the last row;
    - ``sync_proposer``: the proposer sits in the sync committee (four
      positions, set and unset bits) on a balance of 1;
    - ``sync_repeats``: the sync committee drawn from 4 validators on
      balances near the participant reward, half the bits unset;
    - ``dup_deposits``: deposits onto 3 validators, repeated, and pad lanes;
    - ``high_balances``: a numerator at and above 2^63 (one live lane with a
      base reward of 2^63 / 54 + 1000, then a pay row), balances at and
      above 2^63 in the withdrawal window, under a sync decrease and a
      deposit of 2^64 - 1 that wraps, and a proposer at 2^64 - 2;
    - ``all_pad``: every row and deposit lane the pad index n, no flags, no
      sync bit set."""
    from .convert import to_numpy
    from .ops.block_epoch import slot_columns, synthetic_block_columns

    cols, st0, static = synthetic_block_columns(params, n_validators, seed, atts_per_slot,
                                                device="cpu")
    base = (to_numpy(st0)._asdict(), to_numpy(slot_columns(cols, 0))._asdict(),
            to_numpy(static)._asdict())
    dev = default_device(device)
    return {case: _block_slot_corner(case, params, n_validators, base, seed, dev)
            for case in BLOCK_SLOT_CORNERS}


def _block_slot_corner(case: str, params, n: int, base, seed: int, dev) -> tuple:
    from .convert import tensor_from_numpy
    from .ops.block_epoch import BlockColumns, BlockEpochStatic, BlockState

    st, s, sc = ({k: np.array(v) for k, v in d.items()} for d in base)
    rng = np.random.default_rng(seed + 1)
    max_eb = np.uint64(params.max_effective_balance)
    a_rows, sync = s["att_idx"].shape[0], s["sync_idx"].shape[0]
    part_r = int(sc["part_reward"])

    def window(start: int, k: int) -> np.ndarray:
        st["next_wd_validator"] = np.uint64(start)
        return (start + np.arange(k)) % n

    if case == "wrap":
        tail = window(n - 8, 8)
        st["balance"][tail] = np.minimum(st["balance"][tail], max_eb)
        sc["withdrawable_epoch"][tail[5]] = 5
        st["balance"][tail[5]] |= np.uint64(1)
    elif case == "full_payload":
        w = window(n // 3, 8)
        sc["withdrawable_epoch"][w[[1, 4]]] = sc["epoch"]
        sc["withdrawable_epoch"][w[6]] = sc["epoch"] + np.uint64(1)
        st["balance"][w[1]] = 5
    elif case == "partial_payload":
        st["balance"] = np.minimum(st["balance"], max_eb)
        sc["withdrawable_epoch"][:] = U64_MAX
        w = window(n - 3, min(n, params.max_validators_per_withdrawals_sweep))
        pick = w[np.linspace(0, w.shape[0] - 1, 5).astype(np.int64)]
        sc["eff_balance"][pick[:3]] = max_eb
        st["balance"][pick[:3]] = max_eb + np.uint64(1000)
        sc["withdrawable_epoch"][pick[3:]] = 1
        st["balance"][pick[3:]] |= np.uint64(1)
        st["next_wd_index"] = np.uint64(1000)
    elif case == "repeat_rows":
        for r, flags, other in ((1, 0b111, False), (2, 0b110, True), (a_rows - 1, 0b011, False)):
            s["att_idx"][r] = s["att_idx"][0]
            s["att_flags"][r] = flags
            s["att_is_current"][r] = s["att_is_current"][0] ^ other
        s["att_flags"][0] = 0b001
    elif case == "pay_runs":
        s["att_pay"][:] = False
        s["att_pay"][a_rows // 2] = True
    elif case == "sync_proposer":
        prop = s["sync_idx"][5]
        s["proposer"] = np.uint32(prop)
        s["sync_idx"][[9, 20, sync - 1]] = prop
        s["sync_bits"][[5, 9]] = False
        s["sync_bits"][[20, sync - 1]] = True
        st["balance"][prop] = 1
    elif case == "sync_repeats":
        few = s["sync_idx"][:4].copy()
        s["sync_idx"] = few[rng.integers(0, 4, sync)]
        s["sync_bits"] = rng.random(sync) < 0.5
        st["balance"][few] = np.array([0, 1, max(part_r - 1, 0), 3 * part_r + 7], np.uint64)
    elif case == "dup_deposits":
        d = s["dep_idx"].shape[0]
        s["dep_idx"] = s["dep_idx"][:3][np.arange(d) % 3]
        s["dep_idx"][-2:] = n
    elif case == "high_balances":
        lane = int(np.flatnonzero(s["att_idx"][0] < n)[0])
        m = s["att_idx"][0, lane]
        s["att_bits"][0] = False
        s["att_bits"][0, lane] = True
        s["att_flags"][0], s["att_pay"][0] = 0b111, True
        st["cur_part"][m] = st["prev_part"][m] = 0
        sc["base_reward"][m] = np.uint64((1 << 63) // 54 + 1000)
        st["balance"][s["proposer"]] = np.uint64(U64_MAX - 1)
        st["balance"][s["dep_idx"][0]] = U64_MAX
        w = window(7, 4)
        sc["eff_balance"][w] = max_eb
        sc["withdrawable_epoch"][w] = U64_MAX
        st["balance"][w] = np.uint64(1 << 63) + np.arange(4, dtype=np.uint64)
        s["sync_bits"][0] = False
        st["balance"][s["sync_idx"][0]] = np.uint64((1 << 63) + 5)
    elif case == "all_pad":
        s["att_idx"][:] = n
        s["att_bits"][:] = False
        s["att_flags"][:] = 0
        s["att_pay"][:] = True
        s["dep_idx"][:] = n
        s["sync_bits"][:] = False

    def put(cls, fields):
        return cls(**{k: tensor_from_numpy(v, dev) for k, v in fields.items()})

    return put(BlockState, st), put(BlockColumns, s), put(BlockEpochStatic, sc)
