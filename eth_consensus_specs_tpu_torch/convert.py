"""Carry inputs across from the JAX package's layout, and results back.

The JAX package's columns, justification state, static state-root
content and incremental forest are NamedTuples of arrays; these functions
read them by attribute name as numpy arrays (no JAX import) and make the
port's tensors on an explicit device. Curve points, G2 lane arrays,
committee attestations and the slot pipeline's requests and results come
across the same way, read by attribute. ``to_numpy`` turns the port's results
back into numpy with the unsigned dtypes the JAX package uses, for
comparing the two and for writing checkpoints in the JAX package's format.
"""

from __future__ import annotations

import numpy as np
import torch

from .ops.altair_epoch import AltairEpochColumns
from .ops.state_columns import EpochColumns, JustificationState
from .ops.state_root import ForestPlan, StateForest, StateRootMeta, arrays_from_host

_SIGNED = {np.dtype(np.uint64): np.int64, np.dtype(np.uint32): np.int32}
_UNSIGNED = {torch.int64: np.uint64, torch.int32: np.uint32}


def tensor_from_numpy(a, device) -> torch.Tensor:
    """A numpy-convertible array -> tensor on ``device``; u64/u32 become the
    int64/int32 carriers with the same bits."""
    a = np.array(a, order="C")  # a copy that keeps 0-d scalars 0-d
    if a.dtype in _SIGNED:
        a = a.view(_SIGNED[a.dtype])
    return torch.from_numpy(a).to(torch.device(device))


def _convert(cls, src, device):
    return cls(**{
        name: None if getattr(src, name, None) is None else tensor_from_numpy(getattr(src, name), device)
        for name in cls._fields
    })


def columns_from_numpy(cols, just, device):
    """(AltairEpochColumns, JustificationState) of the port from the JAX
    package's columns and justification state."""
    return _convert(AltairEpochColumns, cols, device), _convert(JustificationState, just, device)


def phase0_columns_from_numpy(cols, just, device):
    """(EpochColumns, JustificationState) of the port from the JAX
    package's phase0 columns and justification state."""
    return _convert(EpochColumns, cols, device), _convert(JustificationState, just, device)


def static_from_numpy(arrays, meta, device):
    """(StateRootArrays, StateRootMeta) of the port from the JAX package's
    ``StateRootArrays``/``StateRootMeta`` (e.g. its ``synthetic_static``)."""
    n = int(meta.n_validators)

    def words(a):
        return np.asarray(a).astype(np.uint32).view(np.int32)

    port_arrays = arrays_from_host(
        words(arrays.val_node_a), words(arrays.val_node_f), words(arrays.slashed_chunk),
        np.asarray(arrays.prev_part_flags).astype(np.uint8), words(arrays.top_chunks),
        n, device,
    )
    port_meta = StateRootMeta(
        dynamic_slots=tuple((int(i), str(name)) for i, name in meta.dynamic_slots),
        n_validators=n,
        top_depth=int(meta.top_depth),
    )
    return port_arrays, port_meta


def forest_from_numpy(forest, device) -> StateForest:
    """The port's StateForest from the JAX package's (u32 node buffers
    become int32 carriers with the same bits)."""
    return _convert(StateForest, forest, device)


def plan_from_numpy(plan) -> ForestPlan:
    """The port's ForestPlan from the JAX package's (or from a manifest's
    list), as plain Python ints and a bool."""
    return ForestPlan(*(bool(v) if isinstance(v, (bool, np.bool_)) else int(v) for v in plan))


def to_numpy(x):
    """Tensor (or tuple / NamedTuple of them, recursively) -> numpy, int64
    and int32 carriers viewed back as uint64 and uint32; other leaves (None,
    Python numbers) as they are."""
    if isinstance(x, torch.Tensor):
        a = x.detach().cpu().numpy()
        return a.view(_UNSIGNED[x.dtype]) if x.dtype in _UNSIGNED else a
    if not isinstance(x, (tuple, list)):
        return x
    items = (to_numpy(t) for t in x)
    return type(x)(*items) if hasattr(x, "_fields") else type(x)(items)


# --- BLS12-381: limb rows, prepared coefficients and points ---------------------

# The JAX package's two limb layouts of Fq, both Montgomery with R = 2^390:
# ``field_limbs`` 13 x 30-bit and ``lazy_limbs``/``fq12_tower`` 15 x 26-bit,
# values possibly redundant (below 2p, or limbs not carried).
_JAX_LIMB_BITS = {"field_limbs": 30, "lazy_limbs": 26}
_R390 = 1 << 390


def ints_from_jax_limbs(arr, layout: str = "lazy_limbs"):
    """JAX Montgomery limb rows ``[..., n]`` -> canonical ints, nested like
    the leading dims."""
    from .crypto.fields import P

    bits = _JAX_LIMB_BITS[layout]
    a = np.asarray(arr).astype(np.uint64)
    rinv = pow(_R390, -1, P)
    flat = [sum(int(v) << (bits * i) for i, v in enumerate(row)) * rinv % P
            for row in a.reshape(-1, a.shape[-1])]
    return np.array(flat, dtype=object).reshape(a.shape[:-1]).tolist()


def words_from_jax_limbs(arr, layout: str = "lazy_limbs") -> np.ndarray:
    """JAX Montgomery limb rows -> the port's canonical u32 words
    ``int32[..., 12]``, what K11, K12 and their plain versions take."""
    from .ops.field_limbs import ints_to_words

    return ints_to_words(ints_from_jax_limbs(arr, layout))


def card_words_from_jax_limbs(arr, layout: str = "field_limbs") -> np.ndarray:
    """JAX Montgomery limb rows -> ``int32[..., 12]`` words of the card's
    Montgomery form (x * 2^384 mod p), what K10 and its plain version take."""
    from .ops.field_limbs import ints_to_card_words

    return ints_to_card_words(ints_from_jax_limbs(arr, layout))


def coeffs_from_jax(rows) -> np.ndarray:
    """JAX ``pairing_device.prepare_g2`` rows ``[N_STEPS, 2, 2, 15]`` -> the
    port's coefficients ``int32[N_STEPS, 2, 2, 12]``."""
    return words_from_jax_limbs(rows, "lazy_limbs")


def point_from_bytes(data: bytes):
    """A port Point from a compressed G1 (48-byte) or G2 (96-byte) encoding,
    e.g. the JAX package's ``g1_to_bytes``/``g2_to_bytes`` of its Point."""
    from .crypto.curve import g1_from_bytes, g2_from_bytes

    return g1_from_bytes(bytes(data)) if len(data) == 48 else g2_from_bytes(bytes(data))


def point_to_bytes(p) -> bytes:
    """The compressed encoding of a port Point (G1 or G2), which the JAX
    package's ``g1_from_bytes``/``g2_from_bytes`` read back."""
    from .crypto.curve import Fq, g1_to_bytes, g2_to_bytes

    if p.is_infinity():
        return g1_to_bytes(p) if p.b == Fq(4) else g2_to_bytes(p)
    return g1_to_bytes(p) if isinstance(p.x, Fq) else g2_to_bytes(p)


def point_from_jax(p):
    """A port Point from a JAX ``crypto.curve.Point`` (G1 or G2), read by
    attribute: its coordinates are taken as they are, not re-validated."""
    from .crypto.curve import B1, B2, Point
    from .crypto.fields import Fq, Fq2

    g2 = hasattr(p.b, "c0")
    if p.x is None:
        return Point.infinity(B2 if g2 else B1)
    if g2:
        return Point(Fq2.from_ints(p.x.c0.n, p.x.c1.n), Fq2.from_ints(p.y.c0.n, p.y.c1.n), B2)
    return Point(Fq(p.x.n), Fq(p.y.n), B1)


def g2_lanes_from_jax(X, Y, Z) -> tuple:
    """JAX G2 lane arrays (``uint64[..., 2, 15]`` lazy Montgomery limbs,
    R = 2^390, as ``g2_aggregate._points_to_lanes`` makes them) -> the
    card's Montgomery words ``int32[..., 2, 12]`` each, what K15 and its
    plain version take."""
    return tuple(card_words_from_jax_limbs(a, "lazy_limbs") for a in (X, Y, Z))


def attestation_from_jax(att):
    """The port's ``ops.agg_tree.CommitteeAttestation`` from the JAX
    package's (subnet, root, pubkeys, sigs, bits)."""
    from .ops.agg_tree import CommitteeAttestation

    return CommitteeAttestation(
        subnet=int(att.subnet), root=bytes(att.root),
        pubkeys=tuple(point_from_jax(p) for p in att.pubkeys),
        sigs=tuple(point_from_jax(p) for p in att.sigs),
        bits=tuple(bool(b) for b in att.bits))


# --- the scalar field Fr and the MSM lanes --------------------------------------

# The JAX package's Fr (``ops/limb_field.LimbField`` at r): 9 x 30-bit limbs,
# Montgomery with R = 2^270, values possibly in [0, 2r).
_FR_LIMB_BITS = 30
_R270 = 1 << 270


def fr_ints_from_jax_limbs(arr) -> list:
    """JAX Fr Montgomery limb rows ``[..., 9]`` (``FR.ints_to_mont_batch``,
    ``fr_fft._stage_twiddles``) -> canonical ints, nested like the leading
    dims."""
    from .ops.limb_field import R_MOD

    a = np.asarray(arr).astype(np.uint64)
    rinv = pow(_R270, -1, R_MOD)
    flat = [sum(int(v) << (_FR_LIMB_BITS * i) for i, v in enumerate(row)) * rinv % R_MOD
            for row in a.reshape(-1, a.shape[-1])]
    return np.array(flat, dtype=object).reshape(a.shape[:-1]).tolist()


def fr_words_from_jax_limbs(arr) -> np.ndarray:
    """JAX Fr Montgomery limb rows -> the port's canonical words
    ``int32[..., 8]``, what K16 and its plain version take as values."""
    from .ops.limb_field import ints_to_words

    return ints_to_words(fr_ints_from_jax_limbs(arr))


def twiddles_from_jax(tables) -> np.ndarray:
    """JAX ``fr_fft._stage_twiddles`` tables (one ``[m, 9]`` array a stage)
    -> the port's K16 twiddle table ``int32[n - 1, 8]`` (the card's
    Montgomery form, stage m at rows m - 1 .. 2m - 2)."""
    from .ops.limb_field import N_WORDS, ints_to_card_words

    flat = [x for t in tables for x in fr_ints_from_jax_limbs(t)]
    return ints_to_card_words(flat) if flat else np.zeros((0, N_WORDS), np.int32)


def scalars_from_jax_bits(bits) -> np.ndarray:
    """JAX ``g1_msm._scalars_to_bits`` rows ``[..., 256]`` (u64 bits, most
    significant first) -> the port's K17 scalars ``int32[..., 8]``."""
    from .ops.limb_field import ints_to_words

    a = np.asarray(bits).astype(np.uint64)
    flat = [int("".join("1" if v else "0" for v in row), 2) for row in a.reshape(-1, a.shape[-1])]
    return ints_to_words(np.array(flat, dtype=object).reshape(a.shape[:-1]).tolist())


def msm_lanes_from_jax(bits, X, Y, Z) -> tuple:
    """JAX ``msm_many_kernel`` inputs (bits ``[I, L, 256]``, X/Y/Z ``[I, L,
    13]`` 30-bit Montgomery limbs, R = 2^390) -> the port's K17 inputs
    (K ``int32[I, L, 8]``, X/Y/Z ``int32[I, L, 12]`` card Montgomery words)."""
    return (scalars_from_jax_bits(bits),
            *(card_words_from_jax_limbs(a, "field_limbs") for a in (X, Y, Z)))


# --- the whole slot -------------------------------------------------------------


def slot_request_from_jax(req):
    """The port's ``ops.slot_pipeline.SlotRequest`` from the JAX package's,
    field by field (its attestations as the port's ``SlotAttestation``)."""
    from .ops.slot_pipeline import SlotAttestation, SlotRequest

    atts = tuple(
        SlotAttestation(subnet=int(a.subnet), root=bytes(a.root),
                        committee=tuple(int(v) for v in a.committee),
                        bits=tuple(bool(b) for b in a.bits),
                        pubkeys=tuple(bytes(pk) for pk in a.pubkeys), sig=bytes(a.sig))
        for a in req.attestations)
    return SlotRequest(
        slot=int(req.slot), attestations=atts,
        sync_pubkeys=tuple(bytes(pk) for pk in req.sync_pubkeys),
        sync_message=bytes(req.sync_message), sync_sig=bytes(req.sync_sig),
        sync_indices=tuple(int(v) for v in req.sync_indices),
        blobs=tuple(tuple(bytes(x) for x in b) for b in req.blobs),
        epoch_boundary=bool(req.epoch_boundary))


def slot_result_from_jax(res):
    """The port's ``ops.slot_pipeline.SlotResult`` from the JAX package's,
    field by field."""
    from .ops.slot_pipeline import SlotResult

    return SlotResult(
        slot=int(res.slot), att_verdicts=tuple(bool(v) for v in res.att_verdicts),
        sync_verdict=bool(res.sync_verdict),
        blob_verdicts=tuple(bool(v) for v in res.blob_verdicts),
        subnet_aggregates=tuple((int(s), bytes(sig)) for s, sig in res.subnet_aggregates),
        state_root=bytes(res.state_root), epoch=int(res.epoch), replayed=bool(res.replayed))
