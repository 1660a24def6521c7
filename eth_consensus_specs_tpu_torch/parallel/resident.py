"""Device-resident multi-epoch state advance.

Counterpart of ``eth_consensus_specs_tpu/parallel/resident.py``
(``ResidentCarry`` :48, ``forest_plan_for`` :101,
``build_state_forest_device`` :110, ``run_epochs`` :147,
``_compiled_runner`` :282, ``run_epochs_checkpointed`` :416): N accounting
epochs chained on the device, each consuming the previous epoch's
balances, scores and justification state, with an optional per-epoch root
xor-folded into ``root_acc``. The loop is Python over asynchronous
launches: nothing copies to or from the host between epochs, and in the
incremental mode no kernel's branch waits for the host.

``writeback`` (:390) needs the fork spec objects, which the port does not
have yet.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..config import AltairEpochParams
from ..device import default_device
from ..ops.altair_epoch import (
    AltairEpochColumns,
    altair_epoch_accounting,
    altair_epoch_accounting_ref,
)
from ..ops.merkle import packed_u64_leaves
from ..ops.state_columns import JustificationState
from ..ops.state_root import (
    KERNELS,
    PLAIN,
    Hashers,
    _post_epoch_state_root,
    _update_forest,
    build_state_forest,
    forest_plan,
    state_root_from_forest,
)


class ResidentCarry(NamedTuple):
    cols: AltairEpochColumns
    just: JustificationState
    root_acc: torch.Tensor  # int32[8] xor of the per-epoch roots
    # incremental mode only: the forest, updated in place by the run (the
    # same tensors that went in); thread it into the next run_epochs call
    forest: object = None
    # incremental mode only: int32[n_epochs, 3] live dirty counts of the
    # validator, balance and score trees per epoch (-1: no score tree),
    # left on the device
    dirty: torch.Tensor | None = None


def _to(x, dev: torch.device):
    return type(x)(*(None if t is None else t.to(dev) for t in x))


def _mode(with_root) -> str:
    if with_root is True or with_root == "balance":
        return "balance"
    if with_root is False or with_root is None or with_root == "none":
        return "none"
    if with_root in ("state", "state_inc"):
        return with_root
    raise ValueError(
        f"with_root must be bool, 'balance', 'state' or 'state_inc', got {with_root!r}")


def advance(accounting, params, cols: AltairEpochColumns, just: JustificationState):
    """One accounting epoch through ``accounting`` (K4's wrapper or its plain
    version): balances, effective balances, scores and the justification
    state advance, the epoch counter increments. The loop body of
    ``run_epochs`` and the slot's boundary epoch (``ops/slot_pipeline``)."""
    res = accounting(params, cols, just)
    cols = cols._replace(
        balance=res.balance,
        effective_balance=res.effective_balance,
        inactivity_scores=res.inactivity_scores,
    )
    just = just._replace(
        current_epoch=just.current_epoch + 1,
        justification_bits=res.justification_bits,
        prev_justified_epoch=res.prev_justified_epoch,
        prev_justified_root=res.prev_justified_root,
        cur_justified_epoch=res.cur_justified_epoch,
        cur_justified_root=res.cur_justified_root,
        finalized_epoch=res.finalized_epoch,
        finalized_root=res.finalized_root,
    )
    return cols, just


def forest_plan_for(static):
    """The incremental plan ``run_epochs`` and ``build_state_forest_device``
    share for one registry shape."""
    return forest_plan(static[1])


def _build_forest(h: Hashers, static, cols, plan, dev):
    arrays, meta = static
    cols = _to(cols, dev)
    return build_state_forest(_to(arrays, dev), meta, plan, cols.balance, cols.effective_balance,
                              cols.inactivity_scores, h)


def build_state_forest_device(static, cols: AltairEpochColumns, device=None):
    """One-time forest ingest for ``with_root="state_inc"`` on ``device``
    (the CUDA card unless the caller names another), from the current
    columns, which the first epoch diffs against. Returns (forest, plan);
    ``run_epochs`` updates the forest in place."""
    plan = forest_plan_for(static)
    return _build_forest(KERNELS, static, cols, plan, default_device(device)), plan


def _run(accounting, h: Hashers, params, cols, just, n_epochs, with_root, static, forest, device):
    mode = _mode(with_root)
    dev = default_device(device)
    cols, just = _to(cols, dev), _to(just, dev)
    n = int(cols.balance.shape[0])
    if mode == "balance" and (n % 4 or (n // 4) & (n // 4 - 1)):
        raise ValueError("with_root='balance' requires 4 * 2**k validators")
    if mode in ("state", "state_inc"):
        if static is None:
            raise ValueError(f"with_root={mode!r} requires static (arrays, meta)")
        arrays, meta = static
        arrays = _to(arrays, dev)
    if mode == "state_inc":
        plan = forest_plan_for(static)
        forest = _build_forest(h, static, cols, plan, dev) if forest is None else _to(forest, dev)
        dirty = []
    depth = (max(n // 4, 1) - 1).bit_length()
    acc = torch.zeros(8, dtype=torch.int32, device=dev)
    for _ in range(int(n_epochs)):
        old = (cols.balance, cols.effective_balance, cols.inactivity_scores)
        cols, just = advance(accounting, params, cols, just)
        if mode == "balance":
            acc = acc ^ h.tree_root(packed_u64_leaves(cols.balance, n), depth)
        elif mode == "state":
            acc = acc ^ _post_epoch_state_root(h, arrays, meta, cols.balance,
                                               cols.effective_balance, cols.inactivity_scores,
                                               just)
        elif mode == "state_inc":
            counts = _update_forest(h, arrays, meta, plan, forest, *old, cols.balance,
                                    cols.effective_balance, cols.inactivity_scores)
            dirty.extend(counts if len(counts) == 3 else counts + [torch.full_like(counts[0], -1)])
            acc = acc ^ state_root_from_forest(arrays, meta, plan, forest, just, h)
    if mode != "state_inc":
        return ResidentCarry(cols=cols, just=just, root_acc=acc)
    dirty = torch.cat(dirty).reshape(-1, 3) if dirty else torch.zeros((0, 3), dtype=torch.int32, device=dev)
    return ResidentCarry(cols=cols, just=just, root_acc=acc, forest=forest, dirty=dirty)


def run_epochs(
    params: AltairEpochParams,
    cols: AltairEpochColumns,
    just: JustificationState,
    n_epochs: int,
    with_root=True,
    static=None,
    device=None,
    forest=None,
) -> ResidentCarry:
    """Advance ``n_epochs`` accounting epochs on ``device`` (the CUDA card
    unless the caller names another; inputs are moved there).

    Rooting modes, xor-folded into ``root_acc``:

    * ``with_root=False`` - no root;
    * ``with_root=True`` / ``"balance"`` - the balance column's SSZ
      subtree root (needs 4 * 2**k validators);
    * ``with_root="state"`` - the full post-epoch BeaconState root
      (``ops/state_root.py``); needs ``static = (arrays, meta)``;
    * ``with_root="state_inc"`` - the same root, bit for bit, through the
      incremental forest: each epoch diffs the columns against the
      previous epoch's and re-hashes only the dirty paths of each tree, or
      rebuilds a tree past the crossover. Needs ``static``; ``forest`` from
      ``build_state_forest_device`` (built here when omitted), which the
      run updates in place and returns in ``carry.forest`` (JAX donates
      it; here the same tensors come back): chain from ``carry.forest``.

    On a CUDA device every epoch runs kernels K2-K4 (the forest update in place
    of K3 in the incremental mode); on the CPU their plain versions."""
    return _run(altair_epoch_accounting, KERNELS, params, cols, just, n_epochs, with_root,
                static, forest, device)


def run_epochs_ref(
    params: AltairEpochParams,
    cols: AltairEpochColumns,
    just: JustificationState,
    n_epochs: int,
    with_root=True,
    static=None,
    device=None,
    forest=None,
) -> ResidentCarry:
    """``run_epochs`` through the plain torch version of every kernel, on
    any device: the reference the kernel path is held against."""
    return _run(altair_epoch_accounting_ref, PLAIN, params, cols, just, n_epochs, with_root,
                static, forest, device)


def run_epochs_checkpointed(
    params: AltairEpochParams,
    cols: AltairEpochColumns,
    just: JustificationState,
    n_epochs: int,
    *,
    static,
    forest=None,
    ckpt_dir: str | None = None,
    ckpt_interval: int = 0,
    epoch0: int = 0,
    device=None,
):
    """``run_epochs(with_root="state_inc")`` in chunks of ``ckpt_interval``
    epochs with a durable checkpoint (``ops/snapshot.py``) after each, taken
    outside the epoch loop. Returns ``(carry, root_bytes, epoch)``:
    ``root_bytes`` is the state root of the final forest (what a restore
    verifies against), ``epoch`` is ``epoch0 + n_epochs``, and
    ``carry.root_acc`` is the last chunk's. ``ckpt_interval <= 0`` or no
    ``ckpt_dir``: one run, no checkpoint."""
    from ..ops import snapshot

    dev = default_device(device)
    if forest is None:
        forest, _ = build_state_forest_device(static, cols, device=dev)
    plan = forest_plan_for(static)
    carry = ResidentCarry(cols=cols, just=just, root_acc=None, forest=forest)
    epoch, remaining = int(epoch0), int(n_epochs)
    step = int(ckpt_interval) if (ckpt_dir and ckpt_interval > 0) else remaining
    while remaining > 0:
        chunk = min(step, remaining)
        carry = run_epochs(params, carry.cols, carry.just, chunk, with_root="state_inc",
                           static=static, device=dev, forest=carry.forest)
        epoch += chunk
        remaining -= chunk
        if ckpt_dir:
            snapshot.checkpoint(ckpt_dir, carry.forest, carry.cols, carry.just, epoch=epoch,
                                plan=plan, static=static, epoch0=int(epoch0))
    return carry, snapshot.state_root_bytes(static, plan, carry.forest, carry.just), epoch
