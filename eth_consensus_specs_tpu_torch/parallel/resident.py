"""Device-resident multi-epoch state advance.

Counterpart of ``eth_consensus_specs_tpu/parallel/resident.py``
(``ResidentCarry`` :48, ``run_epochs`` :147, ``_compiled_runner`` :282):
N accounting epochs chained on the device, each consuming the previous
epoch's balances, scores and justification state, with an optional
per-epoch root xor-folded into ``root_acc``. The loop is Python over
asynchronous launches: nothing copies to or from the host between epochs.
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
from ..ops.merkle import tree_root, tree_root_ref
from ..ops.state_columns import JustificationState
from ..ops.state_root import packed_u64_leaves, post_epoch_state_root, post_epoch_state_root_ref


class ResidentCarry(NamedTuple):
    cols: AltairEpochColumns
    just: JustificationState
    root_acc: torch.Tensor  # int32[8] xor of the per-epoch roots


def _to(x, dev: torch.device):
    return type(x)(*(None if t is None else t.to(dev) for t in x))


def _mode(with_root) -> str:
    if with_root is True or with_root == "balance":
        return "balance"
    if with_root is False or with_root is None or with_root == "none":
        return "none"
    if with_root == "state":
        return "state"
    if with_root == "state_inc":
        raise NotImplementedError(
            'with_root="state_inc" (the incremental merkle_inc forest) is the next '
            "slice of the port"
        )
    raise ValueError(f"with_root must be bool, 'balance' or 'state', got {with_root!r}")


def _run(accounting, state_root, tree, params, cols, just, n_epochs, with_root, static, device):
    mode = _mode(with_root)
    dev = default_device(device)
    cols, just = _to(cols, dev), _to(just, dev)
    n = int(cols.balance.shape[0])
    if mode == "balance" and (n % 4 or (n // 4) & (n // 4 - 1)):
        raise ValueError("with_root='balance' requires 4 * 2**k validators")
    if mode == "state":
        if static is None:
            raise ValueError("with_root='state' requires static (arrays, meta)")
        arrays, meta = static
        arrays = _to(arrays, dev)
    depth = (max(n // 4, 1) - 1).bit_length()
    acc = torch.zeros(8, dtype=torch.int32, device=dev)
    for _ in range(int(n_epochs)):
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
        if mode == "balance":
            acc = acc ^ tree(packed_u64_leaves(cols.balance, n), depth)
        elif mode == "state":
            acc = acc ^ state_root(arrays, meta, cols.balance, cols.effective_balance,
                                   cols.inactivity_scores, just)
    return ResidentCarry(cols=cols, just=just, root_acc=acc)


def run_epochs(
    params: AltairEpochParams,
    cols: AltairEpochColumns,
    just: JustificationState,
    n_epochs: int,
    with_root=True,
    static=None,
    device=None,
) -> ResidentCarry:
    """Advance ``n_epochs`` accounting epochs on ``device`` (the CUDA card
    unless the caller names another; inputs are moved there).

    Rooting modes, xor-folded into ``root_acc``:

    * ``with_root=False`` - no root;
    * ``with_root=True`` / ``"balance"`` - the balance column's SSZ
      subtree root (needs 4 * 2**k validators);
    * ``with_root="state"`` - the full post-epoch BeaconState root
      (``ops/state_root.py``); needs ``static = (arrays, meta)``.

    On a CUDA device every epoch runs kernels K1-K4; on the CPU their
    plain versions."""
    return _run(altair_epoch_accounting, post_epoch_state_root, tree_root, params, cols, just,
                n_epochs, with_root, static, device)


def run_epochs_ref(
    params: AltairEpochParams,
    cols: AltairEpochColumns,
    just: JustificationState,
    n_epochs: int,
    with_root=True,
    static=None,
    device=None,
) -> ResidentCarry:
    """``run_epochs`` through the plain torch version of every kernel, on
    any device: the reference the kernel path is held against."""
    return _run(altair_epoch_accounting_ref, post_epoch_state_root_ref, tree_root_ref, params,
                cols, just, n_epochs, with_root, static, device)
