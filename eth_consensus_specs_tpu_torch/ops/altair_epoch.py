"""The altair+ fused accounting epoch (kernel K4, ``csrc/altair_epoch.cu``).

Counterpart of ``eth_consensus_specs_tpu/ops/altair_epoch.py``
``altair_epoch_accounting_impl``: justification and finalization,
inactivity-score updates, flag rewards and penalties in the spec's
sequential clamped order, inactivity penalties, the slashings sweep and
effective-balance hysteresis, over u64 columns carried in int64 lanes.
Covers electra's per-increment slashing quantum and the optional
per-validator ``max_effective_balance`` column.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from .. import _ext
from ..config import AltairEpochParams
from ..lanes import udiv64, ule64, ult64, umin64, umod64
from .state_columns import (
    JUST_DTYPES, U64, Divisor, JustificationState, divisor_magic, empty_justification, isqrt_u64,
    justification_update, stream_scratch, total_balance)


class AltairEpochColumns(NamedTuple):
    """Columnar registry, participation flags and inactivity scores."""

    effective_balance: torch.Tensor  # int64[N] (u64)
    balance: torch.Tensor  # int64[N] (u64)
    slashed: torch.Tensor  # bool[N]
    activation_epoch: torch.Tensor  # int64[N] (u64)
    exit_epoch: torch.Tensor  # int64[N] (u64)
    withdrawable_epoch: torch.Tensor  # int64[N] (u64)
    prev_flags: torch.Tensor  # uint8[N] previous_epoch_participation
    cur_tgt_att: torch.Tensor  # bool[N] current-epoch TIMELY_TARGET flag
    inactivity_scores: torch.Tensor  # int64[N] (u64)
    # [Electra:EIP7251] per-validator ceiling; None -> the scalar param
    max_effective_balance: torch.Tensor | None = None  # int64[N] (u64)


class AltairEpochResult(NamedTuple):
    balance: torch.Tensor
    effective_balance: torch.Tensor
    inactivity_scores: torch.Tensor
    justification_bits: torch.Tensor
    prev_justified_epoch: torch.Tensor
    prev_justified_root: torch.Tensor
    cur_justified_epoch: torch.Tensor
    cur_justified_root: torch.Tensor
    finalized_epoch: torch.Tensor
    finalized_root: torch.Tensor


def altair_epoch_accounting_ref(
    params: AltairEpochParams, cols: AltairEpochColumns, just: JustificationState
) -> AltairEpochResult:
    """Plain torch version of K4, step for step the JAX kernel's."""
    p = params
    incr = p.effective_balance_increment
    dev = cols.balance.device

    def c(v: int) -> torch.Tensor:
        return torch.tensor(v, dtype=torch.int64, device=dev)

    cur_epoch = just.current_epoch
    prev_epoch = torch.where(cur_epoch != 0, cur_epoch - 1, c(0))

    eff = cols.effective_balance
    not_slashed = ~cols.slashed
    active_cur = ule64(cols.activation_epoch, cur_epoch) & ult64(cur_epoch, cols.exit_epoch)
    active_prev = ule64(cols.activation_epoch, prev_epoch) & ult64(prev_epoch, cols.exit_epoch)
    eligible = active_prev | (cols.slashed & ult64(prev_epoch + 1, cols.withdrawable_epoch))

    total_active = total_balance(active_cur, eff, incr)
    flags = cols.prev_flags.to(torch.int64)
    part = [active_prev & (((flags >> k) & 1) == 1) & not_slashed for k in range(len(p.weights))]

    prev_tgt_bal = total_balance(part[1], eff, incr)
    cur_tgt_bal = total_balance(active_cur & cols.cur_tgt_att & not_slashed, eff, incr)
    bits, prev_je, prev_jr, cur_je, cur_jr, fin_e, fin_r = justification_update(
        just, prev_tgt_bal, cur_tgt_bal, total_active
    )

    in_leak = ult64(c(p.min_epochs_to_inactivity_penalty), prev_epoch - fin_e)

    # inactivity scores, with the post-justification leak state
    score = cols.inactivity_scores
    score = torch.where(
        eligible,
        torch.where(part[1], score - umin64(c(1), score), score + p.inactivity_score_bias),
        score,
    )
    score = torch.where(
        eligible & ~in_leak,
        score - umin64(c(p.inactivity_score_recovery_rate), score),
        score,
    )
    do_acc = cur_epoch != 0
    score_out = torch.where(do_acc, score, cols.inactivity_scores)

    # flag rewards and penalties, applied in order with clamping
    brpi = udiv64(c(incr * p.base_reward_factor), isqrt_u64(total_active))
    base_reward = udiv64(eff, incr) * brpi
    active_increments = udiv64(total_active, incr)
    zero = torch.zeros_like(eff)
    bal = cols.balance
    for k, weight in enumerate(p.weights):
        part_increments = udiv64(total_balance(part[k], eff, incr), incr)
        reward = udiv64(
            base_reward * weight * part_increments, active_increments * p.weight_denominator
        )
        r_k = torch.where(do_acc & eligible & part[k] & ~in_leak, reward, zero)
        if k != p.timely_head_flag_index:
            pen_k = torch.where(
                do_acc & eligible & ~part[k], udiv64(base_reward * weight, p.weight_denominator), zero
            )
        else:
            pen_k = zero
        bal = bal + r_k
        bal = bal - umin64(bal, pen_k)

    pen_inact = udiv64(eff * score_out, p.inactivity_score_bias * p.inactivity_penalty_quotient)
    bal = bal - umin64(bal, torch.where(do_acc & eligible & ~part[1], pen_inact, zero))

    # slashings sweep
    adj_slash = umin64(just.slashings_sum * p.proportional_slashing_multiplier, total_active)
    slash_now = cols.slashed & (cur_epoch + p.epochs_per_slashings_vector // 2 == cols.withdrawable_epoch)
    if p.electra_slashing:
        slash_penalty = udiv64(adj_slash, udiv64(total_active, incr)) * udiv64(eff, incr)
    else:
        slash_penalty = udiv64(udiv64(eff, incr) * adj_slash, total_active) * incr
    bal = bal - umin64(bal, torch.where(slash_now, slash_penalty, zero))

    # effective-balance hysteresis
    hyst = incr // p.hysteresis_quotient
    down = hyst * p.hysteresis_downward_multiplier
    up = hyst * p.hysteresis_upward_multiplier
    crossed = ult64(bal + down, eff) | ult64(eff + up, bal)
    ceiling = (
        cols.max_effective_balance
        if cols.max_effective_balance is not None
        else c(p.max_effective_balance)
    )
    new_eff = torch.where(crossed, umin64(bal - umod64(bal, incr), ceiling), eff)

    return AltairEpochResult(
        balance=bal,
        effective_balance=new_eff,
        inactivity_scores=score_out,
        justification_bits=bits,
        prev_justified_epoch=prev_je,
        prev_justified_root=prev_jr,
        cur_justified_epoch=cur_je,
        cur_justified_root=cur_jr,
        finalized_epoch=fin_e,
        finalized_root=fin_r,
    )


class _EpochArgs(ctypes.Structure):
    """Mirror of ``struct EpochArgs`` in ``csrc/altair_epoch.cu``: every
    field is 8 bytes or a 16-byte ``Divisor``, so the two layouts agree
    without padding."""

    _fields_ = [
        (name, ctypes.c_uint64)
        for name in (
            "incr", "base_reward_factor", "w0", "w1", "w2", "head_flag_index",
            "min_epochs_to_inactivity_penalty", "inactivity_score_bias",
            "inactivity_score_recovery_rate", "proportional_slashing_multiplier",
            "half_slashings_vector", "hysteresis_down", "hysteresis_up", "max_effective_balance",
            "electra_slashing", "weight_denominator",
        )
    ] + [(name, Divisor) for name in ("d_incr", "d_wden", "d_inactivity")] + [
        ("n", ctypes.c_int64)
    ] + [
        (name, ctypes.c_void_p)
        for name in (
            "eff", "bal", "slashed", "act", "exit", "wd", "prev_flags", "cur_tgt", "scores",
            "max_eb", "cur_epoch", "bits", "prev_je", "prev_jr", "cur_je", "cur_jr", "fin_e",
            "fin_r", "block_root_prev", "block_root_cur", "slashings_sum", "scratch",
            "out_bal", "out_eff", "out_scores", "out_bits", "out_prev_je", "out_prev_jr",
            "out_cur_je", "out_cur_jr", "out_fin_e", "out_fin_r",
        )
    ]


@functools.cache
def _constants(p: AltairEpochParams) -> tuple:
    """The kernel's epoch-independent fields of ``p``, in struct order."""
    incr = p.effective_balance_increment
    hyst = incr // p.hysteresis_quotient
    w0, w1, w2 = p.weights
    return (
        incr, p.base_reward_factor, w0, w1, w2, p.timely_head_flag_index,
        p.min_epochs_to_inactivity_penalty, p.inactivity_score_bias,
        p.inactivity_score_recovery_rate, p.proportional_slashing_multiplier,
        p.epochs_per_slashings_vector // 2, hyst * p.hysteresis_downward_multiplier & U64,
        hyst * p.hysteresis_upward_multiplier & U64, p.max_effective_balance,
        int(p.electra_slashing), p.weight_denominator,
        Divisor(*divisor_magic(incr)), Divisor(*divisor_magic(p.weight_denominator)),
        Divisor(*divisor_magic(p.inactivity_score_bias * p.inactivity_penalty_quotient & U64)),
    )


_COLUMN_DTYPES = {
    "effective_balance": torch.int64, "balance": torch.int64, "slashed": torch.bool,
    "activation_epoch": torch.int64, "exit_epoch": torch.int64,
    "withdrawable_epoch": torch.int64, "prev_flags": torch.uint8,
    "cur_tgt_att": torch.bool, "inactivity_scores": torch.int64,
    "max_effective_balance": torch.int64,
}


def altair_epoch_accounting(
    params: AltairEpochParams, cols: AltairEpochColumns, just: JustificationState
) -> AltairEpochResult:
    """One accounting epoch. CUDA columns go through kernel K4 (one
    cooperative launch); CPU columns through the plain version."""
    if cols.balance.device.type == "cpu":
        return altair_epoch_accounting_ref(params, cols, just)
    p = params
    n = cols.balance.shape[0]
    if n < 1 or len(p.weights) != 3:
        raise ValueError("K4 takes at least one validator and three participation flags")
    for name, dtype in _COLUMN_DTYPES.items():
        t = getattr(cols, name)
        if t is not None:
            _ext.check_cuda(t, dtype, (n,))
    for name, (dtype, shape) in JUST_DTYPES.items():
        _ext.check_cuda(getattr(just, name), dtype, shape)
    dev = cols.balance.device
    out = AltairEpochResult(
        torch.empty_like(cols.balance), torch.empty_like(cols.effective_balance),
        torch.empty_like(cols.inactivity_scores), *empty_justification(dev),
    )
    columns = [getattr(cols, name) for name in _COLUMN_DTYPES]

    def addr(t):
        return None if t is None else t.data_ptr()

    args = _EpochArgs(
        *_constants(p), n, *(addr(t) for t in columns),
        *(addr(getattr(just, name)) for name in JUST_DTYPES),
        addr(stream_scratch(dev)), *(addr(t) for t in out),
    )
    _ext.launch("altair_epoch", "altair_epoch_launch", dev, ctypes.byref(args))
    return out
