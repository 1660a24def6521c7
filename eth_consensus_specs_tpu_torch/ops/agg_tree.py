"""Hierarchical committee-tree aggregation of one slot's attestations, on
the card.

Counterpart of ``eth_consensus_specs_tpu/ops/agg_tree.py``. A slot's
attestations arrive as per-committee gossip contributions over the
attestation subnets (64 on mainnet); an aggregator builds the block's
aggregates bottom-up:

* tier 0, per subnet: each committee's partial, one batched dispatch a
  subnet (the gossip fan-in unit);
* tier 1: the (subnet, root) partials across all subnets, one dispatch;
* tier 2: the global aggregate of each attestation data root, one dispatch.

Every tier is one K15 launch for the signatures
(``g2_aggregate.sum_g2_many_device``) and one K10 launch for the matching
public keys (``g1_msm.sum_g1_many_device``), each committee's lanes padded
to the power of two of the widest. Participation bits concatenate in (subnet,
committee) order within a root. :func:`aggregate_slot_host` builds the same
tiers with the host folds of ``crypto/signature``: equal points at every
tier. A corrupt member signature does not stop aggregation; it shows in
:func:`verify_slot`, and :func:`isolate_invalid_subnets` finds the bad
(subnet, root) partials through ``verify_many``'s bisection.

Not ported yet: ``subnet_count`` (``ETH_SPECS_AGG_SUBNETS``, read by the
serving layer), the ``obs`` spans and ``agg.*`` counters, the
``buckets.first_dispatch`` compile accounting and the ``mesh`` paths.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..crypto.curve import Point, g1_to_bytes, g2_to_bytes


@dataclass(frozen=True)
class CommitteeAttestation:
    """One committee's gossip contribution: the participating members'
    public keys and signatures (G1 and G2 Points) and the participation
    bits over the full committee (len(sigs) == len(pubkeys) ==
    popcount(bits))."""

    subnet: int
    root: bytes  # attestation data root, the signed message
    pubkeys: tuple
    sigs: tuple
    bits: tuple


@dataclass
class SubnetAggregate:
    subnet: int
    root: bytes
    sig: Point
    pubkey: Point
    bits: np.ndarray  # committee bits concatenated in arrival order

    @property
    def sig_bytes(self) -> bytes:
        return g2_to_bytes(self.sig)

    @property
    def pubkey_bytes(self) -> bytes:
        return g1_to_bytes(self.pubkey)


@dataclass
class SlotAggregate:
    root: bytes
    sig: Point
    pubkey: Point
    bits: np.ndarray  # subnet bits concatenated in subnet order

    @property
    def sig_bytes(self) -> bytes:
        return g2_to_bytes(self.sig)

    @property
    def pubkey_bytes(self) -> bytes:
        return g1_to_bytes(self.pubkey)


def _sum_tier_device(g2_lists: list[list], g1_lists: list[list], device):
    """One tier's two launches: the ragged G2 committee sums (K15) and the
    G1 key sums (K10)."""
    from .g1_msm import sum_g1_many_device
    from .g2_aggregate import sum_g2_many_device

    return (sum_g2_many_device(g2_lists, device=device),
            sum_g1_many_device(g1_lists, device=device))


def _sum_tier_host(g2_lists: list[list], g1_lists: list[list]):
    """The host oracle of one tier: ``crypto/signature``'s point folds."""
    from ..crypto.signature import _sum_g1, _sum_g2

    return [_sum_g2(pts) for pts in g2_lists], [_sum_g1(pts) for pts in g1_lists]


def _aggregate_slot(atts: list[CommitteeAttestation], tier_fn):
    """The committee tree over ``tier_fn`` (device or host oracle: the same
    structure, so tier outputs compare one for one)."""
    by_subnet: dict[int, list[int]] = {}
    for i, a in enumerate(atts):
        by_subnet.setdefault(int(a.subnet), []).append(i)
    csig: dict[int, Point] = {}
    cpk: dict[int, Point] = {}
    for subnet in sorted(by_subnet):
        idxs = by_subnet[subnet]
        sigs, pks = tier_fn([list(atts[i].sigs) for i in idxs],
                            [list(atts[i].pubkeys) for i in idxs])
        for i, s, p in zip(idxs, sigs, pks):
            csig[i], cpk[i] = s, p

    groups: dict[tuple[int, bytes], list[int]] = {}
    for i, a in enumerate(atts):
        groups.setdefault((int(a.subnet), bytes(a.root)), []).append(i)
    gkeys = sorted(groups)
    sigs, pks = tier_fn([[csig[i] for i in groups[k]] for k in gkeys],
                        [[cpk[i] for i in groups[k]] for k in gkeys])
    subnet_aggs = [
        SubnetAggregate(subnet=k[0], root=k[1], sig=s, pubkey=p,
                        bits=np.concatenate([np.asarray(atts[i].bits, bool) for i in groups[k]]))
        for k, s, p in zip(gkeys, sigs, pks)
    ]

    by_root: dict[bytes, list[SubnetAggregate]] = {}
    for sa in subnet_aggs:
        by_root.setdefault(sa.root, []).append(sa)
    roots = sorted(by_root)
    sigs, pks = tier_fn([[sa.sig for sa in by_root[r]] for r in roots],
                        [[sa.pubkey for sa in by_root[r]] for r in roots])
    slot_aggs = [
        SlotAggregate(root=r, sig=s, pubkey=p,
                      bits=np.concatenate([sa.bits for sa in by_root[r]]))
        for r, s, p in zip(roots, sigs, pks)
    ]
    return slot_aggs, subnet_aggs


def aggregate_slot(atts: list[CommitteeAttestation], device=None
                   ) -> tuple[list[SlotAggregate], list[SubnetAggregate]]:
    """Aggregate one slot's committee contributions through the three-tier
    tree on ``device`` (the card by default). Returns (per-root global
    aggregates, per-(subnet, root) partials: the bisection's inputs)."""
    if not atts:
        return [], []
    from ..device import default_device

    dev = default_device(device)
    return _aggregate_slot(atts, lambda g2, g1: _sum_tier_device(g2, g1, dev))


def aggregate_slot_host(atts: list[CommitteeAttestation]
                        ) -> tuple[list[SlotAggregate], list[SubnetAggregate]]:
    """The whole-tree host oracle: the same structure and order, the host
    folds at every tier."""
    if not atts:
        return [], []
    return _aggregate_slot(atts, _sum_tier_host)


def _verdicts(aggs: list, device, rng) -> list[bool]:
    from .bls_batch import verify_many

    items = [([a.pubkey_bytes], a.root, a.sig_bytes) for a in aggs]
    return verify_many(items, device=device, rng=rng)


def verify_slot(slot_aggs: list[SlotAggregate], device=None, rng=None) -> list[bool]:
    """FastAggregateVerify of each root's global aggregate against its
    aggregate key, through the batched RLC check (one pairing check for an
    all-valid slot). ``rng`` goes to ``verify_many``."""
    if not slot_aggs:
        return []
    return _verdicts(slot_aggs, device, rng)


def isolate_invalid_subnets(subnet_aggs: list[SubnetAggregate], device=None,
                            rng=None) -> list[tuple[int, bytes]]:
    """The invalid (subnet, root) partials: the per-subnet partials through
    ``verify_many``'s bisection (one pairing check for an all-valid fan-in,
    about 2 log2(n) more for each bad subnet)."""
    if not subnet_aggs:
        return []
    verdicts = _verdicts(subnet_aggs, device, rng)
    return [(sa.subnet, sa.root) for sa, ok in zip(subnet_aggs, verdicts) if not ok]
