"""Scalar justification machine and u64 helpers of the accounting epoch.

Counterpart of ``eth_consensus_specs_tpu/ops/state_columns.py``
(``JustificationState`` :102, ``isqrt_u64`` :132, ``_total_balance``,
``justification_update`` :172), as plain torch over int64 lanes. Kernel K4
(``csrc/altair_epoch.cu``) carries the same machine in device code; these
are what the plain path (``altair_epoch_accounting_ref``) calls.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..lanes import MASK32, mask32, ule64, ult64, umax64


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
