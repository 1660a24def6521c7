"""Deterministic example inputs, made without the JAX package.

The port's own copy of ``__graft_entry__._example_inputs`` and
``_example_altair_inputs``: the same numpy generators (seeds 1234 and
4321) drawn in the same order, so the columns are identical to the JAX
package's at every size. ``chip_smoke.py`` builds its 2^20-validator state
from these and ``ops.state_root.synthetic_static``.
"""

from __future__ import annotations

import numpy as np
import torch

from .device import default_device
from .ops.altair_epoch import AltairEpochColumns
from .ops.state_columns import JustificationState

U64_MAX = np.iinfo(np.uint64).max
HALF_SLASHINGS_VECTOR = 4096  # EPOCHS_PER_SLASHINGS_VECTOR // 2, mainnet
ALTAIR_CORNERS = ("epoch0", "epoch1", "epoch2", "leak", "all_slashed", "far_future_wide")


def _t(a: np.ndarray, dev) -> torch.Tensor:
    a = np.ascontiguousarray(a)
    if a.dtype == np.uint64:
        a = a.view(np.int64)
    return torch.from_numpy(a).to(dev)


def example_altair_inputs(n_validators: int, epoch: int = 10, electra: bool = False, device=None):
    """(AltairEpochColumns, JustificationState) of ``n_validators`` on
    ``device``: spec-plausible columns with FAR_FUTURE_EPOCH exits, ~1%
    slashed (half of them inside the correlated-slashing window), random
    participation flags and scores; with ``electra``, ~10% of validators
    carry the 2048 ETH ceiling."""
    dev = default_device(device)
    rng = np.random.default_rng(1234)
    n = n_validators
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
    wd[in_window] = epoch + HALF_SLASHINGS_VECTOR  # penalty applies
    src = rng.random(n) < 0.9
    tgt = src & (rng.random(n) < 0.95)
    _head = tgt & (rng.random(n) < 0.9)  # drawn to keep the generator in step
    cur_tgt = rng.random(n) < 0.8

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
        effective_balance=_t(np.minimum(eff, max_eff), dev),
        balance=_t(bal, dev),
        slashed=_t(slashed, dev),
        activation_epoch=_t(act, dev),
        exit_epoch=_t(exitep, dev),
        withdrawable_epoch=_t(wd, dev),
        prev_flags=_t(prev_flags, dev),
        cur_tgt_att=_t(cur_tgt, dev),
        inactivity_scores=_t(scores, dev),
        max_effective_balance=None if max_eb is None else _t(max_eb, dev),
    )

    def root(b: int) -> torch.Tensor:
        return torch.full((32,), b, dtype=torch.uint8, device=dev)

    def u64(v: int) -> torch.Tensor:
        return torch.tensor(v, dtype=torch.int64, device=dev)

    just = JustificationState(
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
    return cols, just


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
    if case.startswith("epoch"):
        cols, just = example_altair_inputs(n_validators, epoch=3, electra=electra, device=dev)
        zero = torch.tensor(0, dtype=torch.int64, device=dev)
        return cols, just._replace(current_epoch=torch.tensor(int(case[5:]), dtype=torch.int64, device=dev),
                                   prev_justified_epoch=zero, cur_justified_epoch=zero, finalized_epoch=zero)
    if case == "leak":
        cols, just = example_altair_inputs(n_validators, epoch=100, electra=electra, device=dev)
        three = torch.tensor(3, dtype=torch.int64, device=dev)
        return cols, just._replace(justification_bits=torch.zeros_like(just.justification_bits),
                                   prev_justified_epoch=three, cur_justified_epoch=three,
                                   finalized_epoch=three)
    epoch = 10
    cols, just = example_altair_inputs(n_validators, epoch=epoch, electra=electra, device=dev)
    even = torch.arange(n_validators, device=dev) % 2 == 0

    def u64(v: int) -> torch.Tensor:
        return torch.tensor(v, dtype=torch.int64, device=dev)

    if case == "all_slashed":
        return cols._replace(
            slashed=torch.ones_like(cols.slashed),
            withdrawable_epoch=torch.where(even, u64(epoch + HALF_SLASHINGS_VECTOR), u64(epoch + 4)),
        ), just
    if case == "far_future_wide":
        far = u64(-1)  # FAR_FUTURE_EPOCH = 2**64 - 1 in an int64 lane
        idx = torch.arange(n_validators, device=dev)
        in_window = cols.slashed & even
        return cols._replace(
            activation_epoch=torch.where(idx % 5 == 0, far, cols.activation_epoch),
            exit_epoch=far.expand(n_validators).clone(),
            withdrawable_epoch=torch.where(in_window, u64(epoch + HALF_SLASHINGS_VECTOR), far),
            inactivity_scores=torch.where(idx % 3 == 0, u64(1 << 40), cols.inactivity_scores),
        ), just._replace(slashings_sum=u64(1 << 62))
    raise ValueError(f"unknown corner {case!r}; expected one of {ALTAIR_CORNERS}")


def lower_balances(cols: AltairEpochColumns, every: int = 256, gwei: int = 2_000_000_000):
    """``cols`` with the balance of every ``every``-th validator lowered by
    ``gwei``: 2 ETH takes each of them below its effective balance by more
    than the downward hysteresis threshold, so the next epoch's effective
    balance update crosses at all of them (a registry after mass slashings
    or leak ejections)."""
    idx = torch.arange(cols.balance.shape[0], device=cols.balance.device)
    return cols._replace(balance=torch.where(idx % every == 0, cols.balance - gwei, cols.balance))
