"""The phase0 accounting epoch (kernel K9, ``csrc/state_columns.cu``), and
the scalar justification machine and u64 helpers every accounting epoch
shares.

Counterpart of ``eth_consensus_specs_tpu/ops/state_columns.py``:
``EpochColumns``, ``JustificationState`` (:102), ``EpochResult``,
``isqrt_u64`` (:132), ``_total_balance``, ``justification_update`` (:172)
and ``epoch_accounting_impl`` (:232), over u64 columns carried in int64
lanes. Kernels K4 (``csrc/altair_epoch.cu``) and K9 carry the same scalar
machine in device code (``csrc/epoch_common.cuh``); the torch functions
here are what the plain paths call. Both kernels also share the host side
of their division by invariant divisors (``divisor_magic``) and the
per-stream scratch of their sums (``stream_scratch``).
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from .. import _ext
from ..config import EpochParams
from ..lanes import MASK32, mask32, udiv64, ule64, ult64, umax64, umin64, umod64


class JustificationState(NamedTuple):
    """Scalar fork-accounting state threaded through the epoch. Epochs and
    sums are 0-d int64 tensors (u64 bits), roots uint8[32], bits bool[4]."""

    current_epoch: torch.Tensor
    justification_bits: torch.Tensor
    prev_justified_epoch: torch.Tensor
    prev_justified_root: torch.Tensor
    cur_justified_epoch: torch.Tensor
    cur_justified_root: torch.Tensor
    finalized_epoch: torch.Tensor
    finalized_root: torch.Tensor
    block_root_prev: torch.Tensor  # get_block_root(state, prev_epoch)
    block_root_cur: torch.Tensor  # get_block_root(state, cur_epoch)
    slashings_sum: torch.Tensor  # sum(state.slashings)


class EpochColumns(NamedTuple):
    """Columnar phase0 registry and previous-epoch participation. The
    attestation masks are raw "attested for component X" bits; the epoch
    applies the unslashed filter itself. ``incl_delay``/``incl_proposer``
    describe each attester's earliest included source attestation (ignored
    where ``src_att`` is False)."""

    effective_balance: torch.Tensor  # int64[N] (u64)
    balance: torch.Tensor  # int64[N] (u64)
    slashed: torch.Tensor  # bool[N]
    activation_epoch: torch.Tensor  # int64[N] (u64)
    exit_epoch: torch.Tensor  # int64[N] (u64)
    withdrawable_epoch: torch.Tensor  # int64[N] (u64)
    src_att: torch.Tensor  # bool[N] previous-epoch matching-source attester
    tgt_att: torch.Tensor  # bool[N] previous-epoch matching-target attester
    head_att: torch.Tensor  # bool[N] previous-epoch matching-head attester
    cur_tgt_att: torch.Tensor  # bool[N] current-epoch matching-target attester
    incl_delay: torch.Tensor  # int64[N] (u64)
    incl_proposer: torch.Tensor  # int64[N], clipped to [0, N-1] where used


class EpochResult(NamedTuple):
    balance: torch.Tensor
    effective_balance: torch.Tensor
    justification_bits: torch.Tensor
    prev_justified_epoch: torch.Tensor
    prev_justified_root: torch.Tensor
    cur_justified_epoch: torch.Tensor
    cur_justified_root: torch.Tensor
    finalized_epoch: torch.Tensor
    finalized_root: torch.Tensor
    rewards: torch.Tensor  # attestation-delta rewards
    penalties: torch.Tensor  # attestation-delta penalties


def isqrt_u64(x: torch.Tensor) -> torch.Tensor:
    """Largest r with r*r <= x for u64 bits in int64 lanes (spec
    integer_squareroot). A float64 seed lies within one of the root for
    every x < 2**64; two corrections each way make it exact."""
    hi = mask32(x >> 32)
    lo = mask32(x)
    seed = torch.sqrt(hi.to(torch.float64) * 4294967296.0 + lo.to(torch.float64))
    r = torch.clamp(seed, max=float(MASK32)).to(torch.int64)
    for _ in range(2):
        r = torch.where((r > 0) & ult64(x, r * r), r - 1, r)
    for _ in range(2):
        rp = r + 1
        r = torch.where((rp <= MASK32) & ule64(rp * rp, x), rp, r)
    return r


def total_balance(mask: torch.Tensor, eff: torch.Tensor, increment: int) -> torch.Tensor:
    """max(EFFECTIVE_BALANCE_INCREMENT, sum of effective balances in mask);
    the int64 sum wraps as the u64 sum does."""
    s = torch.where(mask, eff, torch.zeros_like(eff)).sum()
    return umax64(s, torch.tensor(increment, dtype=torch.int64, device=eff.device))


def justification_update(just: JustificationState, prev_tgt_bal, cur_tgt_bal, total_active):
    """Branch-free weigh_justification_and_finalization with the genesis
    guard (epoch <= 1 leaves everything unchanged).

    Returns (bits, prev_je, prev_jr, cur_je, cur_jr, fin_e, fin_r)."""
    cur_epoch = just.current_epoch
    prev_epoch = torch.where(cur_epoch != 0, cur_epoch - 1, torch.zeros_like(cur_epoch))
    do_justif = ult64(1, cur_epoch)

    old_bits = just.justification_bits
    old_prev_je, old_prev_jr = just.prev_justified_epoch, just.prev_justified_root
    old_cur_je, old_cur_jr = just.cur_justified_epoch, just.cur_justified_root

    just_prev = ule64(total_active * 2, prev_tgt_bal * 3)
    just_cur = ule64(total_active * 2, cur_tgt_bal * 3)

    b0 = just_cur
    b1 = old_bits[0] | just_prev
    b2, b3 = old_bits[1], old_bits[2]
    new_bits = torch.stack([b0, b1, b2, b3])

    new_cur_je = torch.where(just_cur, cur_epoch, torch.where(just_prev, prev_epoch, old_cur_je))
    new_cur_jr = torch.where(
        just_cur, just.block_root_cur, torch.where(just_prev, just.block_root_prev, old_cur_jr)
    )

    # finalization ladder: later (shorter-span) rules override earlier ones
    fin_e, fin_r = just.finalized_epoch, just.finalized_root
    for cond, src_e, src_r in (
        (b1 & b2 & b3 & (old_prev_je + 3 == cur_epoch), old_prev_je, old_prev_jr),
        (b1 & b2 & (old_prev_je + 2 == cur_epoch), old_prev_je, old_prev_jr),
        (b0 & b1 & b2 & (old_cur_je + 2 == cur_epoch), old_cur_je, old_cur_jr),
        (b0 & b1 & (old_cur_je + 1 == cur_epoch), old_cur_je, old_cur_jr),
    ):
        fin_e = torch.where(cond, src_e, fin_e)
        fin_r = torch.where(cond, src_r, fin_r)

    return (
        torch.where(do_justif, new_bits, old_bits),
        torch.where(do_justif, old_cur_je, old_prev_je),
        torch.where(do_justif, old_cur_jr, old_prev_jr),
        torch.where(do_justif, new_cur_je, old_cur_je),
        torch.where(do_justif, new_cur_jr, old_cur_jr),
        torch.where(do_justif, fin_e, just.finalized_epoch),
        torch.where(do_justif, fin_r, just.finalized_root),
    )


def _udiv_any(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Unsigned ``a // b`` for a u64 tensor divisor ``b >= 1`` that may
    reach 2**63 (then the quotient is 0 or 1)."""
    big = b < 0
    q = udiv64(a, torch.where(big, torch.ones_like(b), b))
    return torch.where(big, ule64(b, a).to(torch.int64), q)


def epoch_accounting_ref(params: EpochParams, cols: EpochColumns,
                         just: JustificationState) -> EpochResult:
    """Plain torch version of K9, line for line the JAX kernel's."""
    p = params
    n = cols.balance.shape[0]
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

    # -- justification and finalization (skipped for epochs 0 and 1)
    prev_tgt_bal = total_balance(cols.tgt_att & not_slashed, eff, incr)
    cur_tgt_bal = total_balance(cols.cur_tgt_att & not_slashed, eff, incr)
    bits, prev_je, prev_jr, cur_je, cur_jr, fin_e, fin_r = justification_update(
        just, prev_tgt_bal, cur_tgt_bal, total_active
    )

    # -- rewards and penalties (with the post-justification finalized epoch)
    sqrt_total = isqrt_u64(total_active)
    base_reward = udiv64(udiv64(eff * p.base_reward_factor, sqrt_total), p.base_rewards_per_epoch)
    proposer_reward = udiv64(base_reward, p.proposer_reward_quotient)

    finality_delay = prev_epoch - fin_e
    in_leak = ult64(c(p.min_epochs_to_inactivity_penalty), finality_delay)

    zero = torch.zeros_like(eff)
    rewards = zero
    penalties = zero
    total_units = udiv64(total_active, incr)
    for mask in (cols.src_att, cols.tgt_att, cols.head_att):
        att = mask & not_slashed
        att_bal = total_balance(att, eff, incr)
        # during leaks attesters are credited as if participation were optimal
        full = torch.where(in_leak, base_reward,
                           udiv64(base_reward * udiv64(att_bal, incr), total_units))
        rewards = rewards + torch.where(eligible & att, full, zero)
        penalties = penalties + torch.where(eligible & ~att, base_reward, zero)

    # inclusion-delay micro-rewards: the attester's share decays with the
    # delay, the proposer's share is scatter-added at the earliest includer
    src_unslashed = cols.src_att & not_slashed
    att_share = torch.where(
        src_unslashed, _udiv_any(base_reward - proposer_reward, umax64(cols.incl_delay, c(1))), zero)
    rewards = rewards + att_share
    prop_amount = torch.where(src_unslashed, proposer_reward, zero)
    rewards = rewards + zero.clone().index_add_(0, cols.incl_proposer.clamp(0, n - 1), prop_amount)

    # inactivity leak: quadratic drain on non-target-attesting eligibles
    leak_base = torch.where(eligible & in_leak, p.base_rewards_per_epoch * base_reward - proposer_reward,
                            zero)
    tgt_unslashed = cols.tgt_att & not_slashed
    leak_extra = torch.where(eligible & in_leak & ~tgt_unslashed,
                             udiv64(eff * finality_delay, p.inactivity_penalty_quotient), zero)
    penalties = penalties + leak_base + leak_extra

    do_rewards = cur_epoch != 0
    rewards = torch.where(do_rewards, rewards, zero)
    penalties = torch.where(do_rewards, penalties, zero)

    bal = cols.balance + rewards
    bal = bal - umin64(bal, penalties)

    # -- slashings sweep (every epoch, no genesis guard)
    adj_slash = umin64(just.slashings_sum * p.proportional_slashing_multiplier, total_active)
    slash_now = cols.slashed & (cur_epoch + p.epochs_per_slashings_vector // 2 == cols.withdrawable_epoch)
    slash_penalty = udiv64(udiv64(eff, incr) * adj_slash, total_active) * incr
    bal = bal - umin64(bal, torch.where(slash_now, slash_penalty, zero))

    # -- effective-balance hysteresis
    hyst = incr // p.hysteresis_quotient
    down = hyst * p.hysteresis_downward_multiplier
    up = hyst * p.hysteresis_upward_multiplier
    crossed = ult64(bal + down, eff) | ult64(eff + up, bal)
    new_eff = torch.where(crossed, umin64(bal - umod64(bal, incr), c(p.max_effective_balance)), eff)

    return EpochResult(
        balance=bal, effective_balance=new_eff, justification_bits=bits,
        prev_justified_epoch=prev_je, prev_justified_root=prev_jr,
        cur_justified_epoch=cur_je, cur_justified_root=cur_jr,
        finalized_epoch=fin_e, finalized_root=fin_r, rewards=rewards, penalties=penalties,
    )


U64 = (1 << 64) - 1


def divisor_magic(d: int) -> tuple[int, int, int]:
    """The reciprocal by which kernels K4 and K9 divide by the invariant
    divisor ``d`` >= 1 (``csrc/epoch_common.cuh`` ``Divisor``): ``(magic,
    sh1, sh2)`` with l = ceil(log2 d), magic = floor(2^64 (2^l - d) / d) + 1
    (the low 64 bits of a 65-bit reciprocal), sh1 = min(l, 1), sh2 = max(l -
    1, 0): for a u64 n, n // d = (t + ((n - t) >> sh1)) >> sh2 with t =
    (magic * n) >> 64."""
    if not 1 <= d <= U64:
        raise ValueError(f"divisor {d} outside [1, 2^64)")
    l = (d - 1).bit_length()
    return (((1 << l) - d) << 64) // d + 1, min(l, 1), max(l - 1, 0)


class Divisor(ctypes.Structure):
    """Mirror of ``struct Divisor`` in ``csrc/epoch_common.cuh``."""

    _fields_ = [("magic", ctypes.c_uint64), ("sh1", ctypes.c_uint32), ("sh2", ctypes.c_uint32)]


_scratch: dict[tuple, torch.Tensor] = {}  # by (device, stream)


def stream_scratch(dev: torch.device) -> torch.Tensor:
    """The accounting epochs' scratch on one stream of one card: K4's and
    K9's five sums and K4's arrival counter, zero between launches (each
    launch resets what it used), so both kernels share it."""
    key = (_ext.device_index(dev), _ext.stream(dev))
    if key not in _scratch:
        _scratch[key] = torch.zeros(8, dtype=torch.int64, device=dev)
    return _scratch[key]


_COLUMN_DTYPES = {
    "effective_balance": torch.int64, "balance": torch.int64, "slashed": torch.bool,
    "activation_epoch": torch.int64, "exit_epoch": torch.int64,
    "withdrawable_epoch": torch.int64, "src_att": torch.bool, "tgt_att": torch.bool,
    "head_att": torch.bool, "cur_tgt_att": torch.bool, "incl_delay": torch.int64,
    "incl_proposer": torch.int64,
}
JUST_DTYPES = {
    "current_epoch": (torch.int64, ()), "justification_bits": (torch.bool, (4,)),
    "prev_justified_epoch": (torch.int64, ()), "prev_justified_root": (torch.uint8, (32,)),
    "cur_justified_epoch": (torch.int64, ()), "cur_justified_root": (torch.uint8, (32,)),
    "finalized_epoch": (torch.int64, ()), "finalized_root": (torch.uint8, (32,)),
    "block_root_prev": (torch.uint8, (32,)), "block_root_cur": (torch.uint8, (32,)),
    "slashings_sum": (torch.int64, ()),
}
_CONSTANTS = ("incr", "base_reward_factor", "base_rewards_per_epoch",
              "min_epochs_to_inactivity_penalty", "proportional_slashing_multiplier",
              "half_slashings_vector", "hysteresis_down", "hysteresis_up", "max_effective_balance")
_DIVISORS = ("d_incr", "d_prq", "d_ipq")


class _Phase0Args(ctypes.Structure):
    """Mirror of ``struct Phase0Args`` in ``csrc/state_columns.cu``: every
    field is 8 bytes or a 16-byte ``Divisor``, so the two layouts agree
    without padding. Names are unique (ctypes fills positional arguments by
    name)."""

    _fields_ = (
        [(name, ctypes.c_uint64) for name in _CONSTANTS]
        + [(name, Divisor) for name in _DIVISORS]
        + [("n", ctypes.c_int64)]
        + [(name, ctypes.c_void_p) for name in (
            *_COLUMN_DTYPES, *JUST_DTYPES, "scratch", *(f"out_{f}" for f in EpochResult._fields))]
    )


@functools.cache
def _constants(p: EpochParams) -> tuple:
    """K9's epoch-independent fields of ``p``, in struct order: the
    constants, then the reciprocals of EFFECTIVE_BALANCE_INCREMENT,
    PROPOSER_REWARD_QUOTIENT and INACTIVITY_PENALTY_QUOTIENT. The kernel
    divides by isqrt(total) x BASE_REWARDS_PER_EPOCH in one step, which
    fits 64 bits for a BASE_REWARDS_PER_EPOCH below 2^32 (the spec's is
    4)."""
    if not 1 <= p.base_rewards_per_epoch < 1 << 32:
        raise ValueError("K9 takes a BASE_REWARDS_PER_EPOCH in [1, 2^32)")
    incr = p.effective_balance_increment
    hyst = incr // p.hysteresis_quotient
    return (
        incr, p.base_reward_factor, p.base_rewards_per_epoch, p.min_epochs_to_inactivity_penalty,
        p.proportional_slashing_multiplier, p.epochs_per_slashings_vector // 2,
        hyst * p.hysteresis_downward_multiplier & U64, hyst * p.hysteresis_upward_multiplier & U64,
        p.max_effective_balance,
        *(Divisor(*divisor_magic(d)) for d in (incr, p.proposer_reward_quotient,
                                               p.inactivity_penalty_quotient)),
    )


def kernel_args(params: EpochParams, cols: EpochColumns, just: JustificationState,
                scratch: torch.Tensor, out: EpochResult) -> _Phase0Args:
    """K9's argument block: the constants and their reciprocals, the row
    count, then the device addresses of the columns, the justification
    state, the sums' scratch and the outputs, in the kernel's order."""
    return _Phase0Args(
        *_constants(params), cols.balance.shape[0], *(t.data_ptr() for t in cols),
        *(t.data_ptr() for t in just), scratch.data_ptr(), *(t.data_ptr() for t in out),
    )


def empty_justification(dev) -> tuple:
    """Uninitialised justification outputs on ``dev``, in result order:
    (bits, prev_je, prev_jr, cur_je, cur_jr, fin_e, fin_r), views of two
    allocations (the epochs', the bits' and roots')."""
    prev_je, cur_je, fin_e = torch.empty(3, dtype=torch.int64, device=dev).unbind()
    bits, prev_jr, cur_jr, fin_r = torch.empty(100, dtype=torch.uint8, device=dev).split(
        (4, 32, 32, 32))
    return bits.view(torch.bool), prev_je, prev_jr, cur_je, cur_jr, fin_e, fin_r


def epoch_accounting(params: EpochParams, cols: EpochColumns,
                     just: JustificationState) -> EpochResult:
    """One phase0 accounting epoch. CUDA columns go through kernel K9 (one
    cooperative launch; the four result columns are rows of one
    allocation); CPU columns through the plain version."""
    if cols.balance.device.type == "cpu":
        return epoch_accounting_ref(params, cols, just)
    n = cols.balance.shape[0]
    if n < 1:
        raise ValueError("K9 takes at least one validator")
    for t, dtype in zip(cols, _COLUMN_DTYPES.values()):
        _ext.check_cuda(t, dtype, (n,))
    for t, (dtype, shape) in zip(just, JUST_DTYPES.values()):
        _ext.check_cuda(t, dtype, shape)
    dev = cols.balance.device
    bal, eff, rewards, penalties = torch.empty((4, n), dtype=torch.int64, device=dev).unbind()
    out = EpochResult(bal, eff, *empty_justification(dev), rewards, penalties)
    args = kernel_args(params, cols, just, stream_scratch(dev), out)
    _ext.launch("state_columns", "phase0_epoch_launch", dev, ctypes.byref(args))
    return out
