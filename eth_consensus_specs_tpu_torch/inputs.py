"""Deterministic example inputs, made without the JAX package.

The port's own copy of ``__graft_entry__._example_inputs`` (phase0) and
``_example_altair_inputs``: the same numpy generators (seeds 1234 and
4321) drawn in the same order, so the columns are identical to the JAX
package's at every size. ``chip_smoke.py`` builds its states from these and
``ops.state_root.synthetic_static``.
"""

from __future__ import annotations

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
