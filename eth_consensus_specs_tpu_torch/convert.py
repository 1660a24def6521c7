"""Carry inputs across from the JAX package's layout, and results back.

The JAX package's columns, justification state, static state-root
content and incremental forest are NamedTuples of arrays; these functions
read them by attribute name as numpy arrays (no JAX import) and make the
port's tensors on an explicit device. ``to_numpy`` turns the port's results
back into numpy with the unsigned dtypes the JAX package uses, for
comparing the two and for writing checkpoints in the JAX package's format.
"""

from __future__ import annotations

import numpy as np
import torch

from .ops.altair_epoch import AltairEpochColumns
from .ops.state_columns import EpochColumns, JustificationState
from .ops.state_root import ForestPlan, StateForest, StateRootMeta, arrays_from_host

_SIGNED = {np.dtype(np.uint64): np.int64, np.dtype(np.uint32): np.int32}
_UNSIGNED = {torch.int64: np.uint64, torch.int32: np.uint32}


def tensor_from_numpy(a, device) -> torch.Tensor:
    """A numpy-convertible array -> tensor on ``device``; u64/u32 become the
    int64/int32 carriers with the same bits."""
    a = np.array(a, order="C")  # a copy that keeps 0-d scalars 0-d
    if a.dtype in _SIGNED:
        a = a.view(_SIGNED[a.dtype])
    return torch.from_numpy(a).to(torch.device(device))


def _convert(cls, src, device):
    return cls(**{
        name: None if getattr(src, name, None) is None else tensor_from_numpy(getattr(src, name), device)
        for name in cls._fields
    })


def columns_from_numpy(cols, just, device):
    """(AltairEpochColumns, JustificationState) of the port from the JAX
    package's columns and justification state."""
    return _convert(AltairEpochColumns, cols, device), _convert(JustificationState, just, device)


def phase0_columns_from_numpy(cols, just, device):
    """(EpochColumns, JustificationState) of the port from the JAX
    package's phase0 columns and justification state."""
    return _convert(EpochColumns, cols, device), _convert(JustificationState, just, device)


def static_from_numpy(arrays, meta, device):
    """(StateRootArrays, StateRootMeta) of the port from the JAX package's
    ``StateRootArrays``/``StateRootMeta`` (e.g. its ``synthetic_static``)."""
    n = int(meta.n_validators)

    def words(a):
        return np.asarray(a).astype(np.uint32).view(np.int32)

    port_arrays = arrays_from_host(
        words(arrays.val_node_a), words(arrays.val_node_f), words(arrays.slashed_chunk),
        np.asarray(arrays.prev_part_flags).astype(np.uint8), words(arrays.top_chunks),
        n, device,
    )
    port_meta = StateRootMeta(
        dynamic_slots=tuple((int(i), str(name)) for i, name in meta.dynamic_slots),
        n_validators=n,
        top_depth=int(meta.top_depth),
    )
    return port_arrays, port_meta


def forest_from_numpy(forest, device) -> StateForest:
    """The port's StateForest from the JAX package's (u32 node buffers
    become int32 carriers with the same bits)."""
    return _convert(StateForest, forest, device)


def plan_from_numpy(plan) -> ForestPlan:
    """The port's ForestPlan from the JAX package's (or from a manifest's
    list), as plain Python ints and a bool."""
    return ForestPlan(*(bool(v) if isinstance(v, (bool, np.bool_)) else int(v) for v in plan))


def to_numpy(x):
    """Tensor (or tuple / NamedTuple of them, recursively) -> numpy, int64
    and int32 carriers viewed back as uint64 and uint32; other leaves (None,
    Python numbers) as they are."""
    if isinstance(x, torch.Tensor):
        a = x.detach().cpu().numpy()
        return a.view(_UNSIGNED[x.dtype]) if x.dtype in _UNSIGNED else a
    if not isinstance(x, (tuple, list)):
        return x
    items = (to_numpy(t) for t in x)
    return type(x)(*items) if hasattr(x, "_fields") else type(x)(items)
