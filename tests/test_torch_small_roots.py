"""The state root's small top chunks as entries of K2's list launch
(``ops/state_root.py``): the three checkpoints as one entry of three
depth-1 trees over their packed bytes, the justification bits and the
participation roots as depth-0 entries. Held on the CPU, through the
plain version of K2 (``list_roots_ref``), against the JAX package's
``checkpoint_root``, ``bitvector4_chunk`` and ``run_epochs``."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import __graft_entry__ as graft
from eth_consensus_specs_tpu.forks import get_spec
from eth_consensus_specs_tpu.ops import state_root as jsr
from eth_consensus_specs_tpu.parallel import resident as jres
from eth_consensus_specs_tpu_torch import convert
from eth_consensus_specs_tpu_torch.config import _FIELDS, epoch_params, state_fields
from eth_consensus_specs_tpu_torch.convert import to_numpy
from eth_consensus_specs_tpu_torch.ops import merkle
from eth_consensus_specs_tpu_torch.ops import state_root as tsr
from eth_consensus_specs_tpu_torch.parallel import resident as tres

EPOCHS = [0, 1, 1 << 63, (1 << 64) - 1]  # FAR_FUTURE_EPOCH last
ROOTS = {"zero": np.zeros(32, np.uint8), "ones": np.full(32, 0xFF, np.uint8),
         "random": np.random.default_rng(18).integers(0, 256, 32, dtype=np.uint8)}


def _epoch(e: int) -> torch.Tensor:
    return torch.tensor(int(np.uint64(e).astype(np.int64)), dtype=torch.int64)


def _jax_checkpoint(e: int, root: np.ndarray) -> np.ndarray:
    return np.asarray(jsr.checkpoint_root(jnp.asarray(np.uint64(e)), jnp.asarray(root)))


@pytest.mark.parametrize("root", list(ROOTS))
@pytest.mark.parametrize("epoch", EPOCHS)
def test_checkpoint_entry_equals_jax(epoch, root):
    """One entry of three like trees: each row packs to chunk(epoch) and the
    root, and its depth-1 root is JAX's checkpoint_root."""
    others = [k for k in ROOTS if k != root]
    cps = [(epoch, ROOTS[root]), ((epoch + 1) % (1 << 64), ROOTS[others[0]]),
           (epoch ^ 0xFF, ROOTS[others[1]])]
    entry = tsr.checkpoint_list([(_epoch(e), torch.from_numpy(r)) for e, r in cps])
    assert entry.trees == 3 and tuple(entry.src.shape) == (3, 64) and entry.src.dtype == torch.uint8
    got = merkle.list_roots_ref([entry])
    assert tuple(got.shape) == (3, 8)
    for row, (e, r) in zip(got, cps):
        assert np.array_equal(to_numpy(row), _jax_checkpoint(e, r))
    # checkpoint_roots is the same entry through one list-root call
    assert torch.equal(tsr.checkpoint_roots([(_epoch(e), torch.from_numpy(r)) for e, r in cps],
                                            tsr.PLAIN), got)


def test_checkpoint_rows_land_in_consecutive_rows():
    """A batched entry writes its roots into rows[i], rows[i] + 1, ...; other
    rows keep what they held."""
    cps = [(_epoch(e), torch.from_numpy(ROOTS["random"])) for e in (3, 4, 5)]
    out = torch.arange(16 * 8, dtype=torch.int32).reshape(16, 8)
    got = merkle.list_roots_ref([tsr.chunk_list(out[0].clone() + 1), tsr.checkpoint_list(cps)],
                                out.clone(), [0, 9])
    want = out.clone()
    want[0] += 1
    want[9:12] = tsr.checkpoint_roots(cps, tsr.PLAIN)
    assert torch.equal(got, want)
    with pytest.raises(ValueError):
        merkle.list_roots_ref([tsr.checkpoint_list(cps)], out.clone(), [14])  # 14..16 past 15


@pytest.mark.parametrize("pattern", range(16))
def test_bits_chunk_equals_jax(pattern):
    bits = np.array([(pattern >> i) & 1 for i in range(4)], bool)
    want = np.asarray(jsr.bitvector4_chunk(jnp.asarray(bits)))
    entry = tsr.bits_list(torch.from_numpy(bits))
    assert merkle.tree_depth(entry) == 0 and entry.limit == 0
    assert np.array_equal(to_numpy(merkle.list_roots_ref([entry])[0]), want)
    assert np.array_equal(to_numpy(tsr.bitvector4_chunk(torch.from_numpy(bits))), want)


def test_chunk_entry_is_its_chunk():
    chunk = torch.from_numpy(np.random.default_rng(3).integers(
        -(1 << 31), 1 << 31, 8).astype(np.int32))
    assert torch.equal(merkle.list_roots_ref([tsr.chunk_list(chunk)])[0], chunk)


@pytest.mark.parametrize("fork", sorted(_FIELDS))
def test_checkpoints_are_consecutive_in_every_fork(fork):
    slots = tsr.dynamic_slots(state_fields(fork))
    slot_of = {name: i for i, name in slots}
    first = tsr.checkpoint_slot(slot_of)
    assert [slot_of[f] for f in tsr.CHECKPOINT_FIELDS] == [first, first + 1, first + 2]
    assert state_fields(fork)[first:first + 3] == tsr.CHECKPOINT_FIELDS


def test_checkpoint_slot_raises_when_not_consecutive():
    slot_of = {name: i for i, name in tsr.dynamic_slots(state_fields("deneb"))}
    slot_of["finalized_checkpoint"] += 1
    with pytest.raises(ValueError, match="not consecutive"):
        tsr.checkpoint_slot(slot_of)


@pytest.fixture(scope="module")
def case():
    n = 64
    spec = get_spec("deneb", "mainnet")
    cols, just = graft._example_altair_inputs(n)
    static = jsr.synthetic_static(spec, n, seed=18)
    pc, pj = convert.columns_from_numpy(cols, just, "cpu")
    return spec, (cols, just, static), (pc, pj, convert.static_from_numpy(*static, "cpu"))


@pytest.mark.parametrize("with_root", ["state", "state_inc"])
def test_run_epochs_root_for_root_equals_jax(case, with_root):
    """Two chained one-epoch runs, each epoch's root against JAX's."""
    spec, (cols, just, static), (pc, pj, ps) = case
    want = got = None
    roots = []
    for _ in range(2):
        extra = {} if want is None else {"forest": want.forest}
        want = jres.run_epochs(spec, *((cols, just) if want is None else (want.cols, want.just)), 1,
                               with_root=with_root, static=static, **extra)
        extra = {} if got is None else {"forest": got.forest}
        got = tres.run_epochs(epoch_params("deneb", "mainnet"),
                              *((pc, pj) if got is None else (got.cols, got.just)), 1,
                              with_root=with_root, static=ps, device="cpu", **extra)
        assert np.array_equal(np.asarray(want.root_acc), to_numpy(got.root_acc))
        roots.append(to_numpy(got.root_acc))
    assert not np.array_equal(roots[0], roots[1])  # two different roots
