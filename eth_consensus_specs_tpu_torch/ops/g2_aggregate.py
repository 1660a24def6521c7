"""Per-item G2 point sums: every committee's aggregate signature in one
launch (kernel K15).

Counterpart of ``eth_consensus_specs_tpu/ops/g2_aggregate.py``. The JAX
``g2_sum_many_kernel`` (:103) folds the lane axis as a butterfly
(``_lane_fold`` :69 over ``_butterfly_partners`` :56): at step s every lane
adds its ``lane XOR 2^s`` partner, and lane 0 ends with the sum. Lane 0's
operands at step s are itself and lane 2^s, both sums of adjacent blocks,
so the plain version here folds only the lanes that feed lane 0 (every
2^(s+1)-th lane with its partner): the adjacent-pair tree, lower half
first, the same Jacobian coordinates as JAX's lane 0, at L - 1 adds
instead of L log2(L). K15 (``csrc/g2_sum.cu``) computes that tree too, so
its words equal the plain version's.

Lanes cross to the card in the kernels' Montgomery words (x * 2^384 mod
p), ``int32[I, L, 2, 12]`` for each of X, Y, Z, with Z = 0 for infinity
and padding, as K10 takes its G1 lanes; a point's row is cached with it
(``crypto.curve.Point.row``). The sums come back ``int32[I, 3, 2, 12]`` in
that form, and the one Fq2 inversion a committee that makes them affine
stays on the host (``_jacobian_to_point``), as in the JAX package. No
``mesh`` argument: the lane-sharded variant waits for the multi-card
slice.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import _ext
from ..config import pow2_bucket
from ..crypto.curve import B2, F2, Point, g2_infinity
from ..device import default_device
from . import field_limbs as fl
from . import g2_jacobian as gj

N_WORDS = fl.N_WORDS


def _butterfly_partners(lanes: int) -> np.ndarray:
    """``partners[s, j] = j XOR 2^s`` for the log2(lanes) steps."""
    steps = max(lanes - 1, 0).bit_length()
    if steps == 0:
        return np.zeros((0, lanes), np.int64)
    idx = np.arange(lanes, dtype=np.int64)
    return np.stack([idx ^ (1 << s) for s in range(steps)])


def _lane_fold(X, Y, Z, axis: int = 1) -> tuple:
    """Sum the ``axis`` lanes (a power of two) of Jacobian limb tensors
    ``[.., L, .., 2, 15]``: at step s the lanes j that feed lane 0 (j a
    multiple of 2^(s+1)) add their butterfly partner. Returns the sums with
    the lane axis gone."""
    X, Y, Z = (a.movedim(axis, 0) for a in (X, Y, Z))
    lanes = X.shape[0]
    if lanes & (lanes - 1):
        raise ValueError(f"the lane fold needs a power of two, got {lanes}")
    for s, partners in enumerate(_butterfly_partners(lanes)):
        keep = torch.arange(0, lanes, 2 << s, device=X.device)
        other = torch.from_numpy(partners).to(X.device)[keep]
        p = tuple(a.index_select(0, keep) for a in (X, Y, Z))
        q = tuple(a.index_select(0, other) for a in (X, Y, Z))
        X, Y, Z = (a.index_put((keep,), b) for a, b in zip((X, Y, Z), gj.g2_add(p, q)))
    return X[0], Y[0], Z[0]


def g2_sum_many_ref(X: torch.Tensor, Y: torch.Tensor, Z: torch.Tensor) -> torch.Tensor:
    """Plain version of K15: int32[I, L, 2, 12] X, Y, Z -> int32[I, 3, 2, 12]
    Jacobian sums, both in the card's Montgomery words."""
    sums = _lane_fold(*(fl.from_card_words(a) for a in (X, Y, Z)))
    return torch.stack([fl.to_card_words(a) for a in sums], dim=1)


def g2_sum_many(X: torch.Tensor, Y: torch.Tensor, Z: torch.Tensor) -> torch.Tensor:
    """Per-item Jacobian sums of ``[I, L, 2, 12]`` lanes (L a power of two)
    -> ``int32[I, 3, 2, 12]``, card Montgomery words in and out.

    CUDA tensors go through kernel K15 (``csrc/g2_sum.cu``, one block per
    item, one launch); CPU tensors through the plain version."""
    if X.dim() != 4 or tuple(X.shape[2:]) != (2, N_WORDS) or X.shape[0] < 1 or X.shape[1] < 1:
        raise ValueError(f"expected int32[I, L, 2, {N_WORDS}] lanes, got {tuple(X.shape)}")
    lanes = X.shape[1]
    if lanes & (lanes - 1):
        raise ValueError(f"the lane count must be a power of two, got {lanes}")
    if Y.shape != X.shape or Z.shape != X.shape:
        raise ValueError("X, Y and Z must have one shape")
    if X.device.type == "cpu":
        return g2_sum_many_ref(X, Y, Z)
    for t in (X, Y, Z):
        _ext.check_cuda(t, torch.int32)
    out = torch.empty((X.shape[0], 3, 2, N_WORDS), dtype=torch.int32, device=X.device)
    _ext.launch("g2_sum", "g2_sum_many_launch", X.device, _ext.ptr(X), _ext.ptr(Y), _ext.ptr(Z),
                _ext.ptr(out), X.shape[0], lanes)
    return out


def g2_many_sum_shape(n_items: int, max_lanes: int) -> tuple[int, int]:
    """(items, lane_pad) of one launch: the exact item count, lanes to the
    power of two of the widest committee. The JAX shape model (:166) also
    pads the items to a power of two, only so that XLA retraces less; a
    prebuilt kernel takes any count."""
    return max(n_items, 1), pow2_bucket(max(max_lanes, 1))


# --- host boundary ------------------------------------------------------------

_ONE = fl.ints_to_card_words([1, 0])  # Z of an affine point


def _points_to_lanes(point_lists: list[list[Point]], item_pad: int, lane_pad: int) -> tuple:
    """numpy int32 X, Y, Z ``[item_pad, lane_pad, 2, 12]`` of affine G2
    points in the card's Montgomery words, from each point's cached row;
    infinity, padding lanes and padding items have Z = 0."""
    widest = max((len(p) for p in point_lists), default=0)
    if widest > lane_pad or len(point_lists) > item_pad:
        raise ValueError(f"{len(point_lists)} lists of up to {widest} points do not fit "
                         f"[{item_pad}, {lane_pad}]")
    zero = bytes(192)
    rows = [b"".join(p.row for p in pts) + zero * (lane_pad - len(pts)) for pts in point_lists]
    rows += [zero * lane_pad] * (item_pad - len(point_lists))
    xy = np.frombuffer(b"".join(rows), dtype="<u4").astype(np.uint32).view(np.int32)
    xy = xy.reshape(item_pad, lane_pad, 2, 2, N_WORDS)
    Z = np.zeros((item_pad, lane_pad, 2, N_WORDS), np.int32)
    for i, pts in enumerate(point_lists):
        for j, p in enumerate(pts):
            if not p.is_infinity():
                Z[i, j] = _ONE
    return np.ascontiguousarray(xy[:, :, 0]), np.ascontiguousarray(xy[:, :, 1]), Z


def _jacobian_to_point(x, y, z) -> Point:
    """Affine G2 point of canonical Jacobian Fq2 int pairs: one inverse."""
    return F2.to_point((tuple(x), tuple(y), tuple(z)), B2)


def sums_to_points(out: torch.Tensor) -> list[Point]:
    """``int32[I, 3, 2, 12]`` Jacobian sums (card Montgomery words) ->
    affine Points."""
    return [_jacobian_to_point(*xyz) for xyz in fl.card_words_to_ints(out)]


def sum_g2_many_device(point_lists: list[list[Point]], device=None) -> list[Point]:
    """Per-committee G2 sums for many committees in one launch:
    ``[sum(points) for points in point_lists]`` on ``device`` (the card by
    default), at :func:`g2_many_sum_shape`; each result equals the host
    fold ``crypto.signature._sum_g2(points)``."""
    n = len(point_lists)
    if n == 0:
        return []
    dev = default_device(device)
    shape = g2_many_sum_shape(n, max((len(p) for p in point_lists), default=1))
    X, Y, Z = (torch.from_numpy(a).to(dev) for a in _points_to_lanes(point_lists, *shape))
    return sums_to_points(g2_sum_many(X, Y, Z))


def sum_g2_device(points: list[Point], device=None) -> Point:
    """Device G2 sum of one committee."""
    return sum_g2_many_device([points], device=device)[0] if points else g2_infinity()
