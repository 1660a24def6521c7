"""Batched optimal-ate pairing check on the card (kernels K11 and K12).

Counterpart of ``eth_consensus_specs_tpu/ops/pairing_device.py``, with its
split of the pairing:

* **Host preparation** (``prepare_g2``): the Miller loop's G2 side depends
  only on Q and the fixed BLS parameter, so the 68 affine steps (63
  doublings, 5 additions) run once per distinct G2 point on the host and
  give per-step line coefficients (a3, lam * xi^-1), with
  a3 = (lam * tx - ty) * xi^-1.
* **K11** ``miller_product`` (JAX ``miller_from_coeffs`` :170 and
  ``_miller_chunk_fold`` :301): every pair's 68 steps (square on doubling
  rows, then the sparse line product ``fq12_mul_line``), conjugated for the
  negative x, inactive pairs set to 1, and the product of all pairs.
* **K12** ``final_exp_is_one`` (JAX :259): the membership check
  m^(3 * hard) = 1 with 3H = (x-1)^2 (x+p)(x^2+p^2-1) + 3, after the easy
  part; the verdict of the whole pairing check.
* **K20** ``final_exponentiation`` (JAX :281): the GT value itself,
  m^H with H = (p^4 - p^2 + 1)/r = ((x-1)^2/3)(x+p)(x^2+p^2-1) + 1, one
  power by the 126-bit (x-1)^2/3, then K12's tail; JAX's naive power by
  the 1,268-bit H gives the same element. ``pairing_device`` (JAX :500)
  is K11 on one pair, then K20.

Line model (the host oracle's, so Miller values equal
``crypto.pairing.miller_loop`` bit for bit): the untwisted line through T
and Q at P = (px, py) is the sparse Fq12 element

    l = py + a3 w^3 - (lam * xi^-1) * px w^5.

Preconditions: G2 inputs are in the prime-order subgroup (checked at
deserialization), so T never meets +-Q and no vertical line occurs.
Infinity on either side is handled by the active mask.

Values cross to the card canonical, as ``int32[..., 12]`` u32 words:
coefficients ``[B, 68, 2, 2, 12]``, px and py ``[B, 12]``, an Fq12 as
``[2, 3, 2, 12]``.
"""

from __future__ import annotations

import threading

import numpy as np
import torch

from .. import _ext
from ..crypto.curve import F2, Point
from ..crypto.fields import BLS_X, XI, Fq12
from ..device import default_device
from . import field_limbs as fl
from . import fq12_tower as tw

N_WORDS = fl.N_WORDS
_XI_INV = XI.inv()
_XI_INV_RAW = (_XI_INV.c0.n, _XI_INV.c1.n)
BLS_X_ABS = -BLS_X

# One row per Miller step; True rows square f first (doubling steps), False
# rows are the addition steps after set bits.
_SCHEDULE: list[bool] = []
for _bit in range(62, -1, -1):
    _SCHEDULE.append(True)
    if (BLS_X_ABS >> _bit) & 1:
        _SCHEDULE.append(False)
N_STEPS = len(_SCHEDULE)
_SQR_FLAGS = np.array(_SCHEDULE, np.uint8)


# ----------------------------------------------------------- host prepare --


def prepare_g2(q: Point) -> np.ndarray:
    """Per-step line coefficients of a subgroup, non-infinity G2 point:
    int32[N_STEPS, 2, 2, 12] canonical words of (a3, lam * xi^-1)."""
    if q.is_infinity():
        raise ValueError("prepare_g2: an infinity Q is handled by the active mask")
    qx, qy = (q.x.c0.n, q.x.c1.n), (q.y.c0.n, q.y.c1.n)
    tx, ty = qx, qy
    vals = []

    def emit(lam):
        vals.append([F2.mul(F2.sub(F2.mul(lam, tx), ty), _XI_INV_RAW), F2.mul(lam, _XI_INV_RAW)])

    for bit in range(62, -1, -1):
        x_sq = F2.sqr(tx)
        lam = F2.mul(F2.add(F2.add(x_sq, x_sq), x_sq), F2.inv(F2.add(ty, ty)))
        emit(lam)
        x3 = F2.sub(F2.sub(F2.sqr(lam), tx), tx)
        ty, tx = F2.sub(F2.mul(lam, F2.sub(tx, x3)), ty), x3
        if (BLS_X_ABS >> bit) & 1:
            if tx == qx:
                raise ValueError("vertical line in the ate loop: Q is not in the subgroup")
            lam = F2.mul(F2.sub(qy, ty), F2.inv(F2.sub(qx, tx)))
            emit(lam)
            x3 = F2.sub(F2.sub(F2.sqr(lam), tx), qx)
            ty, tx = F2.sub(F2.mul(lam, F2.sub(tx, x3)), ty), x3
    return fl.ints_to_words(vals)


# per-Q coefficients: every distinct message is a fresh point, but a
# bisection re-checks the same ones; bounded like the JAX package's cache
_PREP_CACHE: dict = {}
_PREP_LOCK = threading.Lock()
_PREP_MAX = 256


def prepared(q: Point) -> np.ndarray:
    key = (q.x, q.y)
    with _PREP_LOCK:
        hit = _PREP_CACHE.get(key)
    if hit is None:
        hit = prepare_g2(q)
        with _PREP_LOCK:
            if len(_PREP_CACHE) >= _PREP_MAX:
                _PREP_CACHE.clear()
            _PREP_CACHE[key] = hit
    return hit


# ------------------------------------------------------------- K11: Miller --


def _check_miller_args(coeffs, px, py, active) -> int:
    b = px.shape[0] if px.dim() == 2 else -1
    if (b < 1 or tuple(coeffs.shape) != (b, N_STEPS, 2, 2, N_WORDS)
            or tuple(px.shape) != (b, N_WORDS) or tuple(py.shape) != (b, N_WORDS)
            or tuple(active.shape) != (b,)):
        raise ValueError(
            f"expected coeffs [B, {N_STEPS}, 2, 2, {N_WORDS}], px and py [B, {N_WORDS}] and "
            f"active [B], got {tuple(coeffs.shape)}, {tuple(px.shape)}, {tuple(py.shape)}, "
            f"{tuple(active.shape)}")
    return b


def miller_values_ref(coeffs, px, py, active) -> torch.Tensor:
    """Plain torch Miller loop of every pair: loose Fq12 limbs
    [B, 2, 3, 2, 15], conjugated, inactive pairs 1."""
    b = px.shape[0]
    co = fl.from_words(coeffs)  # [B, 68, 2, 2, 15]
    neg_px = fl.neg(fl.from_words(px))
    py_l = fl.from_words(py)
    f = tw.fq12_one((b,), px.device)
    for step, square in enumerate(_SCHEDULE):
        if square:
            f = tw.fq12_sqr(f)
        a5 = tw.fq2_mul_fp(co[:, step, 1], neg_px)
        f = tw.fq12_mul_line(f, py_l, co[:, step, 0], a5)
    f = tw.fq12_conj(f)
    one = tw.fq12_one((b,), px.device)
    return torch.where(active.reshape(b, 1, 1, 1, 1).bool(), f, one)


def _fold(fs: torch.Tensor) -> torch.Tensor:
    """Product of a batch of Fq12 [B, 2, 3, 2, 15], pairwise."""
    while fs.shape[0] > 1:
        h = fs.shape[0] // 2
        head = tw.fq12_mul(fs[:h], fs[h:2 * h])
        fs = torch.cat([head, fs[2 * h:]]) if fs.shape[0] % 2 else head
    return fs[0]


def miller_product_ref(coeffs, px, py, active) -> torch.Tensor:
    """Plain torch version of K11 -> int32[2, 3, 2, 12] canonical Fq12."""
    _check_miller_args(coeffs, px, py, active)
    return fl.to_words(_fold(miller_values_ref(coeffs, px, py, active)))


def miller_product(coeffs: torch.Tensor, px: torch.Tensor, py: torch.Tensor,
                   active: torch.Tensor) -> torch.Tensor:
    """Product over pairs of the conjugated Miller values (inactive pairs
    count as 1) -> int32[2, 3, 2, 12] canonical Fq12.

    CUDA tensors go through kernel K11 (``csrc/miller.cu``: one thread a
    pair runs all 68 steps, then one block folds the values; two launches);
    CPU tensors through the plain version."""
    b = _check_miller_args(coeffs, px, py, active)
    if coeffs.device.type == "cpu":
        return miller_product_ref(coeffs, px, py, active)
    for t in (coeffs, px, py, active):
        _ext.check_cuda(t, torch.int32)
    dev = coeffs.device
    scratch = torch.empty((b, 2, 3, 2, N_WORDS), dtype=torch.int32, device=dev)
    out = torch.empty((2, 3, 2, N_WORDS), dtype=torch.int32, device=dev)
    _ext.launch("miller", "miller_loop_launch", dev, _ext.ptr(coeffs), _ext.ptr(px),
                _ext.ptr(py), _ext.ptr(active), _ext.ptr(scratch), b)
    _ext.launch("miller", "miller_fold_launch", dev, _ext.ptr(scratch), _ext.ptr(out), b,
                counter="miller_fold")
    return out


# ----------------------------------------------------- K12: final-exp check --


def _easy_part(f):
    t = tw.fq12_mul(tw.fq12_conj(f), tw.fq12_inv(f))
    return tw.fq12_mul(tw.fq12_frobenius2(t), t)  # f^((p^6-1)(p^2+1))


def _hard_tail(b):
    """b^((x+p)(x^2+p^2-1)) for a cyclotomic b."""
    c = tw.fq12_mul(tw.fq12_powx(b), tw.fq12_frobenius(b))  # b^(x+p)
    d = tw.fq12_powx(tw.fq12_powx(c))  # c^(x^2)
    return tw.fq12_mul(tw.fq12_mul(d, tw.fq12_frobenius2(c)), tw.fq12_conj(c))


def final_exp_is_one_ref(f: torch.Tensor) -> torch.Tensor:
    """Plain torch version of K12: int32[2, 3, 2, 12] -> bool tensor."""
    m = _easy_part(fl.from_words(f))

    def mul_conj(a, b):
        return tw.fq12_mul(a, tw.fq12_conj(b))

    a = mul_conj(tw.fq12_powx(m), m)  # m^(x-1)
    b = mul_conj(tw.fq12_powx(a), a)  # m^((x-1)^2)
    return tw.fq12_is_one(tw.fq12_mul(_hard_tail(b), tw.fq12_mul(tw.fq12_sqr(m), m)))


def final_exp_is_one(f: torch.Tensor) -> torch.Tensor:
    """True iff final_exponentiation(f) == 1, for a canonical
    int32[2, 3, 2, 12] Fq12; a 0-dim bool tensor on f's device.

    CUDA tensors go through kernel K12 (``csrc/final_exp.cu``, one thread
    runs the whole chain); CPU tensors through the plain version."""
    if tuple(f.shape) != (2, 3, 2, N_WORDS):
        raise ValueError(f"expected an int32[2, 3, 2, {N_WORDS}] Fq12, got {tuple(f.shape)}")
    if f.device.type == "cpu":
        return final_exp_is_one_ref(f)
    _ext.check_cuda(f, torch.int32)
    out = torch.empty((), dtype=torch.int32, device=f.device)
    _ext.launch("final_exp", "final_exp_is_one_launch", f.device, _ext.ptr(f), _ext.ptr(out))
    return out != 0


# ------------------------------------------------ K20: the exact GT value --

# (x - 1)^2 / 3, the 126-bit factor of the hard exponent
_HARD_E = (BLS_X - 1) ** 2 // 3
_HARD_E_BITS = bin(_HARD_E)[3:]  # after the leading 1


def final_exponentiation_ref(f: torch.Tensor) -> torch.Tensor:
    """Plain torch version of K20: int32[2, 3, 2, 12] canonical Fq12 ->
    f^((p^12 - 1)/r), the same words."""
    m = _easy_part(fl.from_words(f))
    b = m
    for bit in _HARD_E_BITS:
        b = tw.fq12_sqr(b)
        if bit == "1":
            b = tw.fq12_mul(b, m)
    return fl.to_words(tw.fq12_mul(_hard_tail(b), m))


def final_exponentiation(f: torch.Tensor) -> torch.Tensor:
    """The exact final exponentiation f^((p^12 - 1)/r) of a canonical
    int32[2, 3, 2, 12] Fq12, the same words out: the GT value of a pairing.

    CUDA tensors go through kernel K20 (``csrc/final_exp.cu``, one thread
    runs the whole chain); CPU tensors through the plain version."""
    if tuple(f.shape) != (2, 3, 2, N_WORDS):
        raise ValueError(f"expected an int32[2, 3, 2, {N_WORDS}] Fq12, got {tuple(f.shape)}")
    if f.device.type == "cpu":
        return final_exponentiation_ref(f)
    _ext.check_cuda(f, torch.int32)
    out = torch.empty_like(f)
    _ext.launch("final_exp", "final_exp_launch", f.device, _ext.ptr(f), _ext.ptr(out),
                counter="final_exp_gt")
    return out


# ------------------------------------------------------------- public API --


def pack_pairs(pairs: list) -> tuple:
    """numpy (coeffs, px, py, active) of (G1, G2) pairs; a pair with an
    infinity side is inactive (its Miller value folds as 1)."""
    b = len(pairs)
    coeffs = np.zeros((b, N_STEPS, 2, 2, N_WORDS), np.int32)
    pxy = np.zeros((b, 2, N_WORDS), np.int32)
    active = np.zeros(b, np.int32)
    for i, (p, q) in enumerate(pairs):
        if p.is_infinity() or q.is_infinity():
            continue
        coeffs[i] = prepared(q)
        pxy[i] = fl.ints_to_words([p.x.n, p.y.n])
        active[i] = 1
    return coeffs, np.ascontiguousarray(pxy[:, 0]), np.ascontiguousarray(pxy[:, 1]), active


def pairing_check_device(pairs: list, device=None) -> bool:
    """prod e(P_i, Q_i) == 1 with the Miller loops, their product and the
    final-exponentiation check on ``device`` (the card by default). Pairs
    are (G1 Point, G2 Point), subgroup-checked at deserialization."""
    if not pairs:
        return True
    dev = default_device(device)
    args = [torch.from_numpy(a).to(dev) for a in pack_pairs(pairs)]
    return bool(final_exp_is_one(miller_product(*args)))


def pairing_device(p: Point, q: Point, device=None) -> Fq12:
    """e(P, Q) on ``device`` (the card by default): the Miller value of the
    one pair (K11), then the exact final exponentiation (K20). Equal to
    ``crypto.pairing.pairing``; an infinity side gives one."""
    if p.is_infinity() or q.is_infinity():
        return Fq12.one()
    dev = default_device(device)
    args = [torch.from_numpy(a).to(dev) for a in pack_pairs([(p, q)])]
    return fq12_from_words(final_exponentiation(miller_product(*args)))


def miller_loop_device(p: Point, q: Point, device=None) -> Fq12:
    """Miller value f_{|x|,Q}(P), conjugated, from the same path as the
    pairing check: bit-equal to ``crypto.pairing.miller_loop``."""
    if p.is_infinity() or q.is_infinity():
        return Fq12.one()
    dev = default_device(device)
    args = [torch.from_numpy(a).to(dev) for a in pack_pairs([(p, q)])]
    return fq12_from_words(miller_product(*args))


def fq12_from_words(w) -> Fq12:
    return Fq12.from_ints(np.asarray(fl.words_to_ints(w)).reshape(-1).tolist())


def fq12_to_words(f: Fq12) -> np.ndarray:
    return fl.ints_to_words(f.ints()).reshape(2, 3, 2, N_WORDS)
