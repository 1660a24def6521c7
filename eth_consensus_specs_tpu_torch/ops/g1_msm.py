"""G1 on the card: per-item point sums (kernel K10) and per-item
full-scalar multi-scalar multiplications (kernel K17).

Counterpart of ``eth_consensus_specs_tpu/ops/g1_msm.py``. ``sum_many``
replaces ``sum_many_kernel`` (:168), the vmapped pairwise ``_tree_sum``
(:140) over the complete Jacobian ``_add`` (:80, add-2007-bl with every case
selected by mask) and ``_dbl`` (:55, dbl-2009-l). The tree is the JAX one:
at each level lane j takes lane j + n/2 as its second operand, so the plain
version, the kernel and the JAX program produce the same Jacobian
coordinates, not only the same point.

``msm_many`` replaces ``msm_many_kernel`` (:183): per lane the 256-step
MSB-first double-and-add of ``_scalar_mul_lane`` (:119), then a sum over
the item's lanes (``_msm_lanes`` :175; ``msm_kernel`` :153 is one item).
K17 takes another road to the same point (csrc/g1_msm.cu): each scalar,
reduced mod r, splits by G1's endomorphism phi(x, y) = (beta x, y) = [lambda]
into two half scalars below 2^128, k = k1 + k2 lambda, so a lane is two
half-lanes (k1, P) and (k2, phi(P)); each runs 4-bit windows over a table
of 15 multiples; the half-lanes are summed by a tree in a block and, past
one block, a second launch. The split holds for points in the r-torsion
only, which every caller passes (KZG commitments and proofs are
subgroup-checked; the setup's points and G are multiples of G). K17
launches at the exact lane count, so its Jacobian words differ from the
JAX program's while the point is the same: parity with the JAX package
holds on affine encodings, and the plain version ``msm_many_ref`` runs the
kernel's own steps, word for word. Scalars cross as ``int32[..., 8]``
little-endian u32 words (32 bytes a lane, where JAX takes 256 u64 bits).

Points cross to the card in the kernels' Montgomery form x * 2^384 mod p,
as ``int32[..., 12]`` u32 words (``field_limbs.from_card_words``), as the
JAX kernels take Montgomery rows: X, Y, Z of every lane, Z = 0 for
infinity and padding, Z = one (2^384 mod p) for an affine point. The sums
come back in that form too. A point carries its 96-byte row in that form
(``crypto.curve.Point.row``), so a batch packs with one ``bytes.join``
and no Python ints. The one inversion per item that brings a sum back to
affine stays on the host, as in the JAX package.

Not ported yet: the ``mesh=`` paths (``_sharded_fn`` :228) and
``pad_shape`` (the serve layer's compile buckets).
"""

from __future__ import annotations

import numpy as np
import torch

from .. import _ext
from ..crypto.curve import B1, Point, g1_infinity
from ..crypto.fields import P as P_INT
from ..crypto.fields import R as R_INT
from ..crypto.fields import Fq
from ..device import default_device
from . import field_limbs as fl
from .fq12_coop import GLV_BETA, GLV_LAMBDA

N_WORDS = fl.N_WORDS
SCALAR_BITS = 256
SCALAR_WORDS = 8
MSM_GROUPS = 4  # half-lanes of a K17 block (csrc/g1_msm.cu kGroups)
MSM_FOLD_GROUPS = 16  # groups of the fold's block (kFoldGroups)
MSM_WINDOW = 4  # bits of a window
MSM_WINDOWS = 32  # windows of a 128-bit half scalar


def _dbl(X, Y, Z):
    """dbl-2009-l (a = 0). Infinity (Z = 0) and Y = 0 both give Z3 = 0."""
    A, B, YZ = fl.mul(torch.stack([X, Y, Y]), torch.stack([X, Y, Z]))
    C, t = fl.sqr(torch.stack([B, fl.add(X, B)]))
    D = fl.dbl(fl.sub(fl.sub(t, A), C))
    E = fl.add(fl.dbl(A), A)
    X3 = fl.norm(fl.sub(fl.sqr(E), fl.dbl(D)))
    C8 = fl.dbl(fl.dbl(fl.dbl(C)))
    Y3 = fl.norm(fl.sub(fl.mul(E, fl.sub(D, X3)), C8))
    return X3, Y3, fl.norm(fl.dbl(YZ))


def _add(X1, Y1, Z1, X2, Y2, Z2):
    """Complete Jacobian add (add-2007-bl core), every case by mask: P + P
    doubles, P + (-P) gives Z = 0, a Z = 0 operand passes the other one
    through."""
    Z1Z1, Z2Z2 = fl.sqr(torch.stack([Z1, Z2]))
    U1, U2, YZ1, YZ2 = fl.mul(torch.stack([X1, X2, Y1, Y2]), torch.stack([Z2Z2, Z1Z1, Z2, Z1]))
    S1, S2 = fl.mul(torch.stack([YZ1, YZ2]), torch.stack([Z2Z2, Z1Z1]))
    H = fl.sub(U2, U1)
    rr = fl.sub(S2, S1)
    r2 = fl.dbl(rr)
    I = fl.sqr(fl.dbl(H))
    J, V = fl.mul(torch.stack([H, U1]), I)
    X3 = fl.norm(fl.sub(fl.sub(fl.sqr(r2), J), fl.dbl(V)))
    SJ = fl.mul(S1, J)
    Y3 = fl.norm(fl.sub(fl.mul(r2, fl.sub(V, X3)), fl.dbl(SJ)))
    ZZ = fl.sub(fl.sub(fl.sqr(fl.add(Z1, Z2)), Z1Z1), Z2Z2)
    Z3 = fl.mul(ZZ, H)

    p1_inf, p2_inf = fl.is_zero(Z1), fl.is_zero(Z2)
    same_x, same_y = fl.is_zero(H), fl.is_zero(rr)
    dX, dY, dZ = _dbl(X1, Y1, Z1)
    same = same_x & same_y
    outX = fl.select(same, dX, X3)
    outY = fl.select(same, dY, Y3)
    outZ = fl.select(same, dZ, fl.select(same_x, torch.zeros_like(Z3), Z3))
    outX = fl.select(p1_inf, X2, fl.select(p2_inf, X1, outX))
    outY = fl.select(p1_inf, Y2, fl.select(p2_inf, Y1, outY))
    outZ = fl.select(p1_inf, Z2, fl.select(p2_inf, Z1, outZ))
    return outX, outY, outZ


def _tree_sum(X, Y, Z):
    """Pairwise sum over the lane axis (-2, a power of two): lane j takes
    lane j + n/2 at every level."""
    n = X.shape[-2]
    while n > 1:
        h = n // 2
        X, Y, Z = _add(X[..., :h, :], Y[..., :h, :], Z[..., :h, :],
                       X[..., h:n, :], Y[..., h:n, :], Z[..., h:n, :])
        n = h
    return X[..., 0, :], Y[..., 0, :], Z[..., 0, :]


def sum_many_ref(X: torch.Tensor, Y: torch.Tensor, Z: torch.Tensor) -> torch.Tensor:
    """Plain torch version of K10: int32[I, L, 12] X, Y, Z -> int32[I, 3, 12]
    Jacobian sums, both in the card's Montgomery words."""
    rX, rY, rZ = _tree_sum(*(fl.from_card_words(a) for a in (X, Y, Z)))
    return torch.stack([fl.to_card_words(a) for a in (rX, rY, rZ)], dim=-2)


def _check_sum_args(X, Y, Z) -> None:
    if X.dim() != 3 or X.shape[-1] != N_WORDS or X.shape[1] < 1:
        raise ValueError(f"expected int32[I, L, {N_WORDS}] lanes, got {tuple(X.shape)}")
    lanes = X.shape[1]
    if lanes & (lanes - 1):
        raise ValueError(f"the lane count must be a power of two, got {lanes}")
    if Y.shape != X.shape or Z.shape != X.shape:
        raise ValueError("X, Y and Z must have one shape")


# K10's plan, here alone: the build renders it into csrc/g1_sum.cu's
# generated header (``sum_plan_header``)
SUM_FOLD_PARTIALS = 32  # partials an item K10's fold takes
SUM_PASS_LEVELS = 8  # levels a K10 lanes pass takes at most


def sum_plan_header() -> str:
    """The text of ``g1_sum_plan.cuh``, which ``_ext`` writes before the
    build: K10's fold width and pass depth as ``csrc/g1_sum.cu`` takes them."""
    return "\n".join([
        "// Generated by eth_consensus_specs_tpu_torch/ops/g1_msm.py at build time:",
        "// K10's plan (sum_plan), for csrc/g1_sum.cu.",
        "#pragma once",
        f"constexpr int kFoldPartials = {SUM_FOLD_PARTIALS};  // partials an item the fold takes",
        f"constexpr int kPassLevels = {SUM_PASS_LEVELS};  // levels a lanes pass takes at most",
        "",
    ])


def sum_plan(lanes: int) -> list[int]:
    """The levels of each of K10's lanes passes for an item of ``lanes``
    lanes, before its fold takes the last log2(SUM_FOLD_PARTIALS) levels or
    fewer; a call launches ``len(sum_plan(lanes)) + 1`` kernels."""
    rest = max(0, lanes.bit_length() - SUM_FOLD_PARTIALS.bit_length())
    plan = []
    while rest:
        plan.append(min(SUM_PASS_LEVELS, rest))
        rest -= plan[-1]
    return plan


def sum_many(X: torch.Tensor, Y: torch.Tensor, Z: torch.Tensor) -> torch.Tensor:
    """Per-item Jacobian sums of ``[I, L, 12]`` lanes (L a power of two)
    -> ``int32[I, 3, 12]``, both in the card's Montgomery words.

    CUDA tensors go through kernel K10 (``csrc/g1_sum.cu``: a lanes pass a
    launch, one thread an add, while more than SUM_FOLD_PARTIALS partials
    an item remain, then the fold, a warp an add on the round engine; each
    launch counts under ``g1_sum``); CPU tensors through the plain
    version."""
    _check_sum_args(X, Y, Z)
    if X.device.type == "cpu":
        return sum_many_ref(X, Y, Z)
    for t in (X, Y, Z):
        _ext.check_cuda(t, torch.int32)
    items, n = X.shape[0], X.shape[1]
    for r in sum_plan(n):
        part = torch.empty((3, items, n >> r, N_WORDS), dtype=torch.int32, device=X.device)
        _ext.launch("g1_sum", "g1_sum_lanes_launch", X.device, _ext.ptr(X), _ext.ptr(Y),
                    _ext.ptr(Z), _ext.ptr(part[0]), _ext.ptr(part[1]), _ext.ptr(part[2]), items,
                    n, r)
        X, Y, Z = part
        n >>= r
    out = torch.empty((items, 3, N_WORDS), dtype=torch.int32, device=X.device)
    _ext.launch("g1_sum", "g1_sum_fold_launch", X.device, _ext.ptr(X), _ext.ptr(Y), _ext.ptr(Z),
                _ext.ptr(out), items, n)
    return out


# --- K17: full-scalar MSMs ----------------------------------------------------


def split_scalar(k: int) -> tuple[int, int]:
    """(k1, k2), both below 2^128, with k1 + k2 lambda = k mod r: k1 = k mod
    lambda, k2 = k div lambda of k mod r (r = lambda^2 + lambda + 1)."""
    k2, k1 = divmod(int(k) % R_INT, GLV_LAMBDA)
    return k1, k2


def half_scalars(K: torch.Tensor) -> list[list[int]]:
    """int32[I, L, 8] scalar words -> per item its 2L half scalars, lane j's
    k1 at 2j and k2 at 2j + 1 (K17's half-lane order)."""
    rows = (K.to(torch.int64) & 0xFFFFFFFF).tolist()
    return [[h for words in item for h in split_scalar(
        sum(w << (32 * i) for i, w in enumerate(words)))] for item in rows]


def _digits(halves: list[int], device) -> tuple[torch.Tensor, torch.Tensor]:
    """int64 [N, 32] 4-bit windows (window w at column w) and each half's top
    nonzero window (-1 for 0), on ``device``."""
    d = torch.tensor([[(h >> (MSM_WINDOW * w)) & 15 for w in range(MSM_WINDOWS)]
                      for h in halves], dtype=torch.int64, device=device)
    d = d.reshape(len(halves), MSM_WINDOWS)
    cols = torch.arange(MSM_WINDOWS, device=device).expand_as(d)
    top = torch.where(d != 0, cols, torch.full_like(cols, -1)).max(dim=1).values
    return d, top


def _sel_point(mask, p, q):
    return tuple(fl.select(mask, a, b) for a, b in zip(p, q))


def _window_table(pt) -> list:
    """[T0 = 0, T1 = P, ..., T15 = 15 P] as K17 builds it: T2 = 2 T1, T3 =
    T2 + T1, T4 = 2 T2, T5..T7 = T4 + T1..T3, T8 = 2 T4, T9..T12 = T8 +
    T1..T4, T13..T15 = T8 + T5..T7 (complete adds, the first operand
    first)."""
    t = [tuple(torch.zeros_like(c) for c in pt), pt]
    t.append(_dbl(*t[1]))
    t.append(_add(*t[2], *t[1]))
    t.append(_dbl(*t[2]))

    def adds(base, first, count):
        ys = [torch.stack([t[first + j][c] for j in range(count)]) for c in range(3)]
        xs = [t[base][c].expand_as(ys[c]) for c in range(3)]
        s = _add(*xs, *ys)
        return [tuple(c[j] for c in s) for j in range(count)]

    t += adds(4, 1, 3)
    t.append(_dbl(*t[4]))
    t += adds(8, 1, 4) + adds(8, 5, 3)
    return t


def _half_lane_ladders(halves: list[int], X, Y, Z):
    """Each half-lane's [h] Q by K17's windows: from the top nonzero window
    T[d], then per lower window four doublings and, for d != 0, an add of
    T[d]; a zero half gives all-zero words. X, Y, Z: limbs [N, 15]."""
    d, top = _digits(halves, X.device)
    t = _window_table((X, Y, Z))
    tab = [torch.stack([e[c] for e in t]) for c in range(3)]  # [16, N, 15]
    rows = torch.arange(len(halves), device=X.device)

    def pick(col):
        return tuple(c[col, rows] for c in tab)

    acc = tuple(torch.zeros_like(c) for c in (X, Y, Z))
    for w in range(int(top.max()), -1, -1):
        dw = d[:, w]
        begun = top > w
        dbl = acc
        for _ in range(4):
            dbl = _dbl(*dbl)
        added = _add(*dbl, *pick(dw))
        step = _sel_point(begun & (dw != 0), added, _sel_point(begun, dbl, acc))
        acc = _sel_point(top == w, pick(dw), step)
    return acc


def msm_many_ref(K: torch.Tensor, X: torch.Tensor, Y: torch.Tensor, Z: torch.Tensor,
                 groups: int = MSM_GROUPS, fold_groups: int = MSM_FOLD_GROUPS) -> torch.Tensor:
    """Plain torch version of K17, the kernel's steps with ``groups``
    half-lanes a block and ``fold_groups`` groups in the fold (powers of
    two): int32[I, L, 8] scalars and int32[I, L, 12] X, Y, Z -> int32[I, 3,
    12] Jacobian sums, points in the card's Montgomery words."""
    items, lanes = X.shape[0], X.shape[1]
    halves = half_scalars(K)
    X, Y, Z = (fl.from_card_words(a) for a in (X, Y, Z))
    beta = fl.from_ints(GLV_BETA, X.device)
    X = torch.stack([X, fl.mul(X, beta.expand_as(X))], dim=2)  # odd half-lanes: phi(P)
    Y, Z = (torch.stack([a, a], dim=2) for a in (Y, Z))
    n = 2 * lanes
    flat = [a.reshape(items * n, -1) for a in (X, Y, Z)]
    acc = _half_lane_ladders([h for item in halves for h in item], *flat)
    bpi = -(-n // groups)
    acc = [torch.nn.functional.pad(a.reshape(items, n, -1), (0, 0, 0, bpi * groups - n))
           .reshape(items, bpi, groups, -1) for a in acc]
    part = _tree_sum(*acc)  # [I, bpi, 15]: each block's halving tree
    if bpi > 1:  # the fold: group g sums partials g, g + G, ... in turn, then halves
        rounds = -(-bpi // fold_groups)
        part = [torch.nn.functional.pad(a, (0, 0, 0, rounds * fold_groups - bpi))
                .reshape(items, rounds, fold_groups, -1) for a in part]
        sums = [a[:, 0] for a in part]
        for r in range(1, rounds):
            live = (torch.arange(fold_groups, device=X.device) + r * fold_groups
                    < bpi).expand(items, -1)
            added = _add(*sums, *(a[:, r] for a in part))
            sums = list(_sel_point(live, added, sums))
        part = _tree_sum(*sums)
    else:
        part = [a[:, 0] for a in part]
    return torch.stack([fl.to_card_words(a) for a in part], dim=-2)


def _check_msm_args(K, X, Y, Z) -> None:
    if X.dim() != 3 or X.shape[-1] != N_WORDS or X.shape[0] < 1 or X.shape[1] < 1:
        raise ValueError(f"expected int32[I, L, {N_WORDS}] lanes, got {tuple(X.shape)}")
    if Y.shape != X.shape or Z.shape != X.shape:
        raise ValueError("X, Y and Z must have one shape")
    if tuple(K.shape) != (*X.shape[:2], SCALAR_WORDS):
        raise ValueError(f"expected int32[{X.shape[0]}, {X.shape[1]}, {SCALAR_WORDS}] scalars, "
                         f"got {tuple(K.shape)}")


def msm_many(K: torch.Tensor, X: torch.Tensor, Y: torch.Tensor, Z: torch.Tensor) -> torch.Tensor:
    """Per-item sum_j k_ij * P_ij of ``[I, L]`` lanes (any L) -> ``int32[I,
    3, 12]`` Jacobian sums in the card's Montgomery words; scalars
    ``int32[I, L, 8]``, any 256-bit values (reduced mod r). The points must
    lie in G1's r-torsion (the endomorphism split assumes it).

    CUDA tensors go through kernel K17 (``csrc/g1_msm.cu``: a warp a
    half-lane, MSM_GROUPS half-lanes a block, the ladder on four lanes a
    product; where an item spans several blocks, a second launch, counted
    as ``g1_msm_fold``, sums their partials); CPU tensors through the plain
    version."""
    _check_msm_args(K, X, Y, Z)
    if X.device.type == "cpu":
        return msm_many_ref(K, X, Y, Z)
    for t in (K, X, Y, Z):
        _ext.check_cuda(t, torch.int32)
    items, n = X.shape[0], X.shape[1]
    bpi = -(-2 * n // MSM_GROUPS)
    out = torch.empty((items, 3, N_WORDS), dtype=torch.int32, device=X.device)
    part = (torch.empty((items, bpi, 3, N_WORDS), dtype=torch.int32, device=X.device)
            if bpi > 1 else None)
    _ext.launch("g1_msm", "g1_msm_many_launch", X.device, _ext.ptr(K), _ext.ptr(X),
                _ext.ptr(Y), _ext.ptr(Z), _ext.ptr(out), _ext.ptr(part), items, n)
    if part is not None:
        _ext.launch("g1_msm", "g1_msm_fold_launch", X.device, _ext.ptr(part), _ext.ptr(out),
                    items, bpi, counter="g1_msm_fold")
    return out


# --- host boundary ------------------------------------------------------------

_ZERO_ROW = bytes(96)
_ONE = fl.ints_to_card_words(1)  # Z of an affine point


def lane_pad(n: int) -> int:
    """The power of two at or above ``n`` (at least 1)."""
    return 1 << max(n - 1, 0).bit_length()


def pack_lanes(point_lists: list[list[Point]], lanes: int | None = None) -> tuple:
    """numpy int32 X, Y, Z ``[I, L, 12]`` of affine G1 points in the card's
    Montgomery words (L the power of two of the largest list, or
    ``lanes``), from each point's cached row; infinity and padding lanes
    have Z = 0."""
    n = len(point_lists)
    widest = max(len(p) for p in point_lists)
    lanes = lanes or lane_pad(widest)
    if widest > lanes:
        raise ValueError(f"a list of {widest} points does not fit {lanes} lanes")
    buf = b"".join(b"".join(p.row for p in pts) + _ZERO_ROW * (lanes - len(pts))
                   for pts in point_lists)
    xy = np.frombuffer(buf, dtype="<u4").astype(np.uint32).view(np.int32)
    xy = xy.reshape(n, lanes, 2, N_WORDS)
    Z = np.zeros((n, lanes, N_WORDS), np.int32)
    for i, pts in enumerate(point_lists):
        Z[i, : len(pts)] = _ONE
        for j, p in enumerate(pts):
            if p.is_infinity():
                Z[i, j] = 0
    return np.ascontiguousarray(xy[:, :, 0]), np.ascontiguousarray(xy[:, :, 1]), Z


def jacobian_to_point(x: int, y: int, z: int) -> Point:
    """Affine G1 point of canonical Jacobian ints: one inverse."""
    if z == 0:
        return g1_infinity()
    zinv = pow(z, -1, P_INT)
    zinv2 = zinv * zinv % P_INT
    return Point(Fq(x * zinv2 % P_INT), Fq(y * zinv2 % P_INT * zinv % P_INT), B1)


def sums_to_points(out: torch.Tensor) -> list[Point]:
    """``int32[I, 3, 12]`` Jacobian sums (card Montgomery words) -> affine
    Points."""
    return [jacobian_to_point(*xyz) for xyz in fl.card_words_to_ints(out)]


def sum_g1_many_device(point_lists: list[list[Point]], device=None) -> list[Point]:
    """Per-item point sums for many committees in one launch:
    ``[sum(points) for points in point_lists]`` on ``device`` (the card by
    default). Lanes pad to the power of two of the largest committee."""
    if not point_lists:
        return []
    dev = default_device(device)
    if not any(point_lists):
        return [g1_infinity() for _ in point_lists]
    X, Y, Z = (torch.from_numpy(a).to(dev) for a in pack_lanes(point_lists))
    return sums_to_points(sum_many(X, Y, Z))


def sum_g1_device(points: list[Point], device=None) -> Point:
    """Device point sum of one list."""
    return sum_g1_many_device([points], device=device)[0] if points else g1_infinity()


def scalars_to_words(scalar_lists: list[list[int]], lanes: int) -> np.ndarray:
    """numpy int32[I, lanes, 8] little-endian words of each item's scalars
    (0 <= k < 2^256), zero past an item's list."""
    buf = bytearray(len(scalar_lists) * lanes * 32)
    for i, scalars in enumerate(scalar_lists):
        for j, k in enumerate(scalars):
            k = int(k)
            if not 0 <= k < 1 << SCALAR_BITS:
                raise ValueError(f"scalar {k} is outside [0, 2^256)")
            off = (i * lanes + j) * 32
            buf[off:off + 32] = k.to_bytes(32, "little")
    words = np.frombuffer(bytes(buf), dtype="<u4").astype(np.uint32).view(np.int32)
    return words.reshape(len(scalar_lists), lanes, SCALAR_WORDS)


def pack_msm(point_lists: list[list[Point]], scalar_lists: list[list[int]]) -> tuple:
    """numpy (K, X, Y, Z) of per-item MSMs at exactly the widest item's
    lane count; shorter items pad with infinity lanes and zero scalars."""
    if len(point_lists) != len(scalar_lists) or any(
            len(p) != len(s) for p, s in zip(point_lists, scalar_lists)):
        raise ValueError("every item needs one scalar per point")
    lanes = max(max(len(p) for p in point_lists), 1)
    return (scalars_to_words(scalar_lists, lanes), *pack_lanes(point_lists, lanes))


def msm_g1_many_device(point_lists: list[list[Point]], scalar_lists: list[list[int]],
                       device=None) -> list[Point]:
    """Independent full-scalar MSMs for many items in one launch on
    ``device`` (the card by default): ``[msm_g1(points, scalars) for
    ...]``, the KZG RLC fold's two lincombs. The points must lie in G1:
    K17 splits each scalar by G1's endomorphism, which gives k P only in
    the r-torsion (the JAX double-and-add takes any point of E1; on one
    outside G1 the two agree only after cofactor clearing). Callers pass
    subgroup-checked points; nothing here checks them."""
    if not point_lists:
        return []
    dev = default_device(device)
    K, X, Y, Z = (torch.from_numpy(a).to(dev) for a in pack_msm(point_lists, scalar_lists))
    return sums_to_points(msm_many(K, X, Y, Z))


def msm_g1_device(points: list[Point], scalars: list[int], device=None) -> Point:
    """sum_i scalars[i] * points[i] on ``device``: unit scalars take the
    point sum (K10), as JAX ``msm_g1_device`` routes them to ``sum_kernel``;
    any other scalars one item of K17, whose points must lie in G1 (see
    ``msm_g1_many_device``)."""
    if len(points) != len(scalars):
        raise ValueError("one scalar per point")
    if not points:
        return g1_infinity()
    if all(int(k) == 1 for k in scalars):
        return sum_g1_device(points, device=device)
    return msm_g1_many_device([points], [scalars], device=device)[0]
