"""The port's CUDA kernels against their plain torch versions on the card.

Every test here needs an NVIDIA GPU and skips without one. The file imports
neither JAX nor the JAX package, so it also runs where only the port is
installed, e.g. on the H100:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q
"""

import functools
import hashlib

import numpy as np
import pytest
import torch

from eth_consensus_specs_tpu_torch import _ext
from eth_consensus_specs_tpu_torch.config import epoch_params, phase0_epoch_params
from eth_consensus_specs_tpu_torch.inputs import (
    ALTAIR_CORNERS, PHASE0_CORNERS, altair_corner_inputs, example_altair_inputs, example_inputs,
    lower_balances, phase0_corner_inputs)
from eth_consensus_specs_tpu_torch.ops import altair_epoch as tae
from eth_consensus_specs_tpu_torch.ops import merkle, snapshot
from eth_consensus_specs_tpu_torch.ops import merkle_inc as tmi
from eth_consensus_specs_tpu_torch.ops import shuffle as tsh
from eth_consensus_specs_tpu_torch.ops import state_columns as tsc
from eth_consensus_specs_tpu_torch.ops import state_root as tsr
from eth_consensus_specs_tpu_torch.ops.sha256 import (
    sha256_pairs, sha256_pairs_ref, sha256_single_block, sha256_single_block_ref)
from eth_consensus_specs_tpu_torch.parallel import resident

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _words(rows: int, cols: int, seed: int) -> torch.Tensor:
    rng = np.random.default_rng(seed)
    return torch.from_numpy(
        rng.integers(0, 2**32, size=(rows, cols), dtype=np.uint64).astype(np.uint32).view(np.int32)
    )


@pytest.mark.parametrize("n", [1, 4, 257, 4096])
def test_sha256_pairs_kernel(cuda, n):
    msgs = _words(n, 16, n)
    got = sha256_pairs(msgs.to(cuda)).cpu()
    assert torch.equal(got, sha256_pairs_ref(msgs))
    m = msgs[0].numpy().view(np.uint32).astype(">u4").tobytes()
    assert got[0].numpy().view(np.uint32).astype(">u4").tobytes() == hashlib.sha256(m).digest()


def test_sha256_pairs_rejects_bad_input(cuda):
    with pytest.raises(ValueError):
        sha256_pairs(torch.zeros((4, 16), dtype=torch.int64, device=cuda))
    with pytest.raises(ValueError):
        sha256_pairs(torch.zeros((4, 8), dtype=torch.int32, device=cuda))


@pytest.mark.parametrize("depth", [0, 1, 5, 9, 10, 14])
def test_tree_root_kernel(cuda, depth):
    leaves = _words(1 << depth, 8, depth)
    assert torch.equal(merkle.tree_root(leaves.to(cuda), depth).cpu(),
                       merkle.tree_root_ref(leaves, depth))


@pytest.mark.parametrize("n", [1, 1000, 1024])
def test_validator_leaves_kernel(cuda, n):
    arrays, _ = tsr.synthetic_static(n, seed=n, device="cpu")
    cols, _ = example_altair_inputs(n, device="cpu")
    depth = max(n - 1, 0).bit_length()
    slashed = _words(n, 8, 99)  # any chunk content: the kernel hashes what it is given
    args = (cols.effective_balance, slashed, arrays.val_node_a, arrays.val_node_f, depth)
    got = tsr.validator_leaves(*(a.to(cuda) if torch.is_tensor(a) else a for a in args))
    assert torch.equal(got.cpu(), tsr.validator_leaves_ref(*args))


@pytest.mark.parametrize("fork", ["deneb", "electra"])
@pytest.mark.parametrize("epoch", [0, 1, 10])
def test_altair_epoch_kernel(cuda, fork, epoch):
    params = epoch_params(fork, "mainnet")
    cols, just = example_altair_inputs(1000, epoch=max(epoch, 3), electra=fork == "electra",
                                       device=cuda)
    just = just._replace(current_epoch=torch.tensor(epoch, dtype=torch.int64, device=cuda))
    got = tae.altair_epoch_accounting(params, cols, just)
    want = tae.altair_epoch_accounting_ref(params, cols, just)
    for name in want._fields:
        assert torch.equal(getattr(got, name), getattr(want, name)), name


@pytest.mark.parametrize("fork", ["deneb", "electra"])
@pytest.mark.parametrize("case", ALTAIR_CORNERS)
def test_altair_epoch_kernel_corners(cuda, fork, case):
    """The kernel's branches that the example columns never take: genesis
    epochs, the inactivity leak, every validator slashed, FAR_FUTURE_EPOCH
    lanes with u64 products that wrap and dividends past 2^63."""
    params = epoch_params(fork, "mainnet")
    cols, just = altair_corner_inputs(case, 1000, electra=fork == "electra", device=cuda)
    got = tae.altair_epoch_accounting(params, cols, just)
    want = tae.altair_epoch_accounting_ref(params, cols, just)
    for name in want._fields:
        assert torch.equal(getattr(got, name), getattr(want, name)), name


def _assert_epoch_equal(params, cols, just):
    _ext.reset_launches()
    got = tae.altair_epoch_accounting(params, cols, just)
    assert dict(_ext.launches) == {"altair_epoch": 1}
    want = tae.altair_epoch_accounting_ref(params, cols, just)
    for name in want._fields:
        assert torch.equal(getattr(got, name), getattr(want, name)), name


@pytest.mark.parametrize("fork", ["deneb", "electra"])
def test_altair_epoch_kernel_past_the_grid(cuda, fork):
    """More validators than the cooperative grid keeps in registers (8 a
    thread): the excess is swept and applied one a thread, re-read."""
    params = epoch_params(fork, "mainnet")
    _assert_epoch_equal(params, *altair_corner_inputs("far_future_wide", 3 << 20,
                                                      electra=fork == "electra", device=cuda))


@pytest.mark.parametrize("fork", ["deneb", "electra"])
def test_altair_epoch_kernel_unaligned_columns(cuda, fork):
    """Columns that start 8 bytes (one validator) into their storage."""
    params = epoch_params(fork, "mainnet")
    cols, just = example_altair_inputs(4097, electra=fork == "electra", device=cuda)
    cols = cols._replace(**{k: v[1:] for k, v in cols._asdict().items() if v is not None})
    assert cols.balance.data_ptr() % 16 == 8
    _assert_epoch_equal(params, cols, just)


def test_altair_epoch_repeated_launches_leave_scratch_clean(cuda):
    """60 launches alternating forks, corners and sizes (one block, many, a
    ragged last run): each equal to the plain version in one launch, and the
    sums and the arrival counter read zero after each."""
    cases = [(fork, case) for case in ("example",) + ALTAIR_CORNERS
             for fork in ("deneb", "electra")]
    for i in range(60):
        fork, case = cases[i % len(cases)]
        n = (1000, (1 << 16) + 3, 64)[i % 3]
        electra = fork == "electra"
        cols, just = (example_altair_inputs(n, electra=electra, device=cuda) if case == "example"
                      else altair_corner_inputs(case, n, electra=electra, device=cuda))
        _assert_epoch_equal(epoch_params(fork, "mainnet"), cols, just)
        scratch = tsc.stream_scratch(cols.balance.device)
        assert not scratch.any(), f"launch {i} left its scratch set"


def test_state_root_kernel_path(cuda):
    arrays, meta = tsr.synthetic_static(1000, seed=4, device=cuda)
    cols, just = example_altair_inputs(1000, device=cuda)
    args = (arrays, meta, cols.balance, cols.effective_balance, cols.inactivity_scores, just)
    assert torch.equal(tsr.post_epoch_state_root(*args), tsr.post_epoch_state_root_ref(*args))


def test_run_epochs_card_matches_cpu_and_counts_launches(cuda):
    params = epoch_params("deneb", "mainnet")
    cols, just = example_altair_inputs(1024, device="cpu")
    static = tsr.synthetic_static(1024, seed=2, device="cpu")
    _ext.reset_launches()
    got = resident.run_epochs(params, cols, just, 2, with_root="state", static=static, device=cuda)
    counts = dict(_ext.launches)
    want = resident.run_epochs(params, cols, just, 2, with_root="state", static=static, device="cpu")
    assert torch.equal(got.root_acc.cpu(), want.root_acc)
    assert torch.equal(got.cols.balance.cpu(), want.cols.balance)
    # no K1: the checkpoints and the small top chunks ride in K2's list launch
    assert set(counts) == {"merkle", "merkle_lists", "validator_leaves", "altair_epoch"}
    assert counts["altair_epoch"] == 2 and counts["validator_leaves"] == 2  # one launch an epoch
    assert counts["merkle_lists"] == 2 and counts["merkle"] == 2  # an epoch: the lists, the top


# ------------------------------ incremental forest (the forest update, K5's compaction) --

def _plain_levels(leaves):
    nodes = leaves.new_zeros((*leaves.shape[:-2], 2 * leaves.shape[-2] - 1, 8))
    nodes[..., :leaves.shape[-2], :] = leaves
    return tmi.merkle_levels_ref(nodes)


@pytest.mark.parametrize("depth", [0, 1, 5, 9, 10, 14, 18, 20])
def test_merkle_levels_kernel(cuda, depth):
    leaves = _words(1 << depth, 8, depth)
    _ext.reset_launches()
    got = tmi.build_levels(leaves.to(cuda)).cpu()
    assert dict(_ext.launches) == {"forest_update": 1}  # one launch at any depth
    assert torch.equal(got, _plain_levels(leaves))
    if depth:
        assert torch.equal(got[-1], merkle.tree_root_ref(leaves, depth))


def test_merkle_levels_kernel_batched_and_gated(cuda):
    batch = _words(8 * 32, 8, 1).reshape(8, 32, 8)
    assert torch.equal(tmi.build_levels(batch.to(cuda)).cpu(), _plain_levels(batch))
    full = tmi.build_levels(_words(64, 8, 2).to(cuda))
    stale = full.clone()
    stale[64:] = 0
    count = torch.tensor([5], dtype=torch.int32, device=cuda)
    _ext.reset_launches()
    assert torch.equal(tmi.merkle_levels(stale.clone(), count, 5), stale)
    assert torch.equal(tmi.merkle_levels(stale.clone(), count, 4), full)
    assert dict(_ext.launches) == {"forest_update": 2}


@pytest.mark.parametrize("n,cap,case", [
    (1000, 64, "empty"), (1000, 64, "full"), (1000, 64, "random"), (1 << 16, 4096, "random"),
    (1 << 16, 4096, "over_capacity"), (1 << 20, 4096, "random"),
])
def test_dirty_indices_kernel(cuda, n, cap, case):
    rng = np.random.default_rng(n + cap)
    mask = {"empty": np.zeros(n, bool), "full": np.ones(n, bool),
            "random": rng.random(n) < min(0.5, cap / n / 2),
            "over_capacity": rng.random(n) < 2 * cap / n}[case]
    got = tmi.dirty_indices(torch.from_numpy(mask).to(cuda), cap)
    want = tmi.dirty_indices_ref(torch.from_numpy(mask), cap)
    for g, w in zip(got, want):
        assert torch.equal(g.cpu(), w)


@pytest.mark.parametrize("n,per", [(1000, 1), (1 << 16, 1), (1000, 4), (1 << 18, 4)])
def test_dirty_leaves_kernel(cuda, n, per):
    rng = np.random.default_rng(n * per)
    old = rng.integers(0, 2**64, size=n, dtype=np.uint64)
    new = old.copy()
    new[rng.choice(n, min(n // 8, 3000), replace=False)] ^= np.uint64(1 << 63)
    old_t, new_t = (torch.from_numpy(a.view(np.int64)) for a in (old, new))
    n_leaves = 1 << max(-(-n // per) - 1, 0).bit_length()
    rows = _words(n_leaves, 8, 5) if per == 4 else None
    got_rows = None if rows is None else rows.to(cuda)
    got = tmi.dirty_leaves(old_t.to(cuda), new_t.to(cuda), per, n_leaves, 1024, got_rows)
    want = tmi.dirty_leaves_ref(old_t, new_t, per, n_leaves, 1024, rows)
    for g, w in zip(got, want):
        assert torch.equal(g.cpu(), w)
    if rows is not None:
        assert torch.equal(got_rows.cpu(), rows)


def _status_words(dev, n_leaves, per, mask):
    """The compaction's ticket counter and the status words of its last
    call's tiles, as unsigned ints, with the generation of that call."""
    scr = tmi._stream_scratch(dev)
    tiles = -(-n_leaves // tmi.compact_tile_leaves(per, mask))
    words = [int(w) & ((1 << 64) - 1) for w in scr.status[:1 + tiles].cpu()]
    return words[0], words[1:], scr.gen


def test_compaction_repeated_launches_keep_status_tagged(cuda, monkeypatch):
    """60 compactions of masks and diffs (per 1 and per 4 with leaf rows) of
    varying sizes on one status array, never reset, across a wrap of the
    generations: each equal to the plain version, the ticket counter zero
    after each, and each tile's word tagged with the call's generation and
    its inclusive prefix of dirty leaves."""
    rng = np.random.default_rng(16)
    for i in range(60):
        if i == 30:  # the generations wrap two calls on: the array is zeroed once
            scr = tmi._stream_scratch(torch.device("cuda", torch.cuda.current_device()))
            monkeypatch.setattr(tmi, "COMPACT_GENERATIONS", scr.gen + 3)
        form = i % 3
        n = int(rng.choice([1000, 4096, (1 << 16) + 5, (1 << 18) + 77]))
        cap = int(rng.choice([64, 1024, 4096]))
        rate = float(rng.choice([0.0, 0.001, 0.05, 1.0]))
        if form == 0:
            mask = torch.from_numpy(rng.random(n) < rate)
            got = tmi.dirty_indices(mask.to(cuda), cap)
            want = tmi.dirty_indices_ref(mask, cap)
            per, n_leaves, leaf_dirty = 1, n, mask
        else:
            per = 1 if form == 1 else 4
            old = torch.from_numpy(rng.integers(-(1 << 63), 1 << 63, n, dtype=np.int64))
            new = torch.where(torch.from_numpy(rng.random(n) < rate), old ^ (1 << 40), old)
            n_leaves = 1 << max(-(-n // per) - 1, 0).bit_length()
            rows = _words(n_leaves, 8, i) if per == 4 else None
            got_rows = None if rows is None else rows.to(cuda)
            got = tmi.dirty_leaves(old.to(cuda), new.to(cuda), per, n_leaves, cap, got_rows)
            want = tmi.dirty_leaves_ref(old, new, per, n_leaves, cap, rows)
            if rows is not None:
                assert torch.equal(got_rows.cpu(), rows), i
            diff = torch.cat([old != new, torch.zeros(n_leaves * per - n, dtype=torch.bool)])
            leaf_dirty = diff.reshape(n_leaves, per).any(dim=1)
        for g, w in zip(got, want):
            assert torch.equal(g.cpu(), w), i
        ticket, words, gen = _status_words(got[0].device, n_leaves, per, form == 0)
        assert ticket == 0, f"call {i} left the ticket counter at {ticket}"
        tile = tmi.compact_tile_leaves(per, form == 0)
        counts = torch.nn.functional.pad(leaf_dirty.to(torch.int64),
                                         (0, len(words) * tile - n_leaves))
        prefix = torch.cumsum(counts.reshape(len(words), tile).sum(dim=1), 0).tolist()
        assert [w >> 34 for w in words] == [gen] * len(words), i
        assert [(w >> 32) & 3 for w in words] == [2] * len(words), i
        assert [w & 0xFFFFFFFF for w in words] == prefix, i
    assert gen == 28  # the wrap zeroed the array at call 32 and began again at 1


@pytest.mark.parametrize("depth", [1, 10, 16])
def test_path_update_kernel(cuda, depth):
    nodes = _plain_levels(_words(1 << depth, 8, depth))
    new = _words(1 << depth, 8, depth + 1)
    rng = np.random.default_rng(depth)
    uniq = rng.choice(1 << depth, min(40, 1 << depth), replace=False)
    idx = np.concatenate([uniq, uniq[:4] ^ 1, uniq[:3], np.zeros(9, np.int64)]).astype(np.int32)
    idx_t = torch.from_numpy(idx)
    vals = new[idx_t.to(torch.int64)]
    live = len(idx) - 9
    for count, dense in ((None, -1), (live, live), (live, live - 1)):
        c = None if count is None else torch.tensor([count], dtype=torch.int32)
        want = tmi.path_update_ref(nodes.clone(), idx_t, vals, c, dense)
        _ext.reset_launches()
        got = tmi.path_update(nodes.clone().to(cuda), idx_t.to(cuda), vals.to(cuda),
                              None if c is None else c.to(cuda), dense)
        assert torch.equal(got.cpu(), want), (count, dense)
        assert dict(_ext.launches) == {"forest_mark": 1, "forest_update": 1}
        assert not tmi._stream_scratch(got.device).mask.any(), "the scratch mask was left set"


@pytest.mark.parametrize("extra", [0, 1], ids=["sparse_at_dense_count", "dense_past_it"])
def test_apply_dirty_on_card(cuda, extra):
    """Both of the plain version's branches, and the forest kernel's one
    launch, equal to a rebuild."""
    depth, cap, dense_count = 12, 256, 200
    leaves = _words(1 << depth, 8, 20)
    new = leaves.clone()
    dirty = torch.from_numpy(np.random.default_rng(21).choice(1 << depth, dense_count + extra,
                                                               replace=False))
    new[dirty] ^= 0x5A5A5A5A
    mask = torch.zeros(1 << depth, dtype=torch.bool)
    mask[dirty] = True
    new_c = new.to(cuda)
    got = tmi.apply_dirty(_plain_levels(leaves).to(cuda), mask.to(cuda),
                          lambda i: new_c[i.to(torch.int64)], cap, dense_count)
    want = tmi.apply_dirty(_plain_levels(leaves), mask, lambda i: new[i.to(torch.int64)], cap,
                           dense_count)
    assert torch.equal(got.cpu(), want)
    assert torch.equal(want, _plain_levels(new))


# the dirty validators of each case on a 2^14 registry (leaf groups of 512)
FOREST_CASES = {
    "empty": [], "one_leaf": [5], "two_siblings": [4, 5], "left_only": [8], "right_only": [13],
    "every_4th": list(range(0, 1 << 14, 4)), "every_leaf": list(range(1 << 14)),
    "clean_group_between": [1, 1025],  # leaf group 1 (512-1023) clean
}


def _forest_world(cuda, n=1 << 14):
    """A 2^14 registry's forest on the card (K3 and the rebuild), its static
    tree and columns, and the plan's capacities."""
    static = tsr.synthetic_static(n, seed=12, device=cuda)
    cols, _ = example_altair_inputs(n, device=cuda)
    forest, plan = resident.build_state_forest_device(static, cols, device=cuda)
    return static[0], cols, forest, plan


def _forest_trees(arrays, forest, plan, old, new, extra=()):
    p = tmi.ForestTree
    return [p(forest.val_nodes[0], "registry", old[1], new[1],
              static=(arrays.slashed_chunk, arrays.val_node_a, arrays.val_node_f),
              cap=plan.cap_val, dense=plan.dense_val),
            p(forest.bal_nodes[0], "u64", old[0], new[0], cap=plan.cap_bal, dense=plan.dense_bal),
            p(forest.inact_nodes[0], "u64", old[2], new[2], cap=plan.cap_bal, dense=plan.dense_bal),
            *extra]


def _moved(cols, ids, step):
    bal, eff, scores = (t.clone() for t in (cols.balance, cols.effective_balance,
                                            cols.inactivity_scores))
    if ids:
        i = torch.tensor(ids, device=bal.device)
        eff[i] -= 10**9 * step
        bal[i] += 17 * step
        scores[i[::3]] += step
    return bal, eff, scores


@pytest.mark.parametrize("case", list(FOREST_CASES))
def test_forest_update_kernel(cuda, case):
    """The forest kernel against its plain twin on a 2^14 registry: the
    registry, balance and score trees of an epoch, a mask tree and a batch
    of two all-dirty trees in one table, then a second launch in a row over
    new columns; every buffer and count equal, the counters clean."""
    arrays, cols, forest, plan = _forest_world(cuda)
    old = (cols.balance, cols.effective_balance, cols.inactivity_scores)
    ids = FOREST_CASES[case]
    leaves = _words(1 << 12, 8, 31).to(cuda)
    mask_nodes = tmi.build_levels(leaves)
    new_rows = leaves.clone()
    mask = torch.zeros(1 << 12, dtype=torch.bool, device=cuda)
    mask[[i for i in ids if i < 1 << 12]] = True
    new_rows[mask] ^= 0x1234567
    batch = tmi.build_levels(_words(3 * 1024, 8, 32).reshape(3, 1024, 8).to(cuda))
    batch[:, 1024:] = 0
    got_f, want_f = (type(forest)(*(None if t is None else t.clone() for t in forest))
                     for _ in range(2))
    got_x = [mask_nodes.clone(), batch.clone()]
    want_x = [mask_nodes.clone(), batch.clone()]

    def extra(x):
        return (tmi.ForestTree(x[0], "mask", mask=mask, rows=new_rows, cap=plan.cap_val,
                               dense=plan.dense_val), tmi.ForestTree(x[1], "all"))

    for step in (1, 2):
        new = _moved(cols, ids, step)
        prev = old if step == 1 else _moved(cols, ids, 1)
        _ext.reset_launches()
        got = tmi.forest_update(_forest_trees(arrays, got_f, plan, prev, new, extra(got_x)))
        assert dict(_ext.launches) == {"forest_update": 1}
        want = tmi.forest_update_ref(_forest_trees(arrays, want_f, plan, prev, new, extra(want_x)))
        for g, w in zip(got, want):
            assert (g is None) == (w is None) and (g is None or torch.equal(g, w))
        for name in ("val_nodes", "bal_nodes", "inact_nodes"):
            assert torch.equal(getattr(got_f, name), getattr(want_f, name)), (name, step)
        for g, w in zip(got_x, want_x):
            assert torch.equal(g, w), step
    assert int(got[0]) == len(ids)
    for scratch in tmi._scratch.values():
        assert not scratch.counters.any(), "a counter or an accumulator was left set"


def test_forest_update_repeated_launches_leave_scratch_clean(cuda):
    """60 launches in a row on one stream, each a table of a u64 diff, a
    mask, a batch of every leaf and a ragged u64 tree, at random dirty sets
    from none to all, with a path update between them: every buffer and
    count equal to the plain twin after each launch, and the counters,
    accumulators and the scratch mask zero after each."""
    rng = np.random.default_rng(15)
    n_bal, n_ragged = 4 << 12, 4 * 700 + 3
    bal = torch.from_numpy(rng.integers(0, 2**40, n_bal)).to(cuda)
    ragged = torch.from_numpy(rng.integers(0, 2**40, n_ragged)).to(cuda)
    u64_nodes = tmi.build_levels(tmi._u64_chunks(bal, 4, 1 << 12))
    ragged_nodes = tmi.build_levels(tmi._u64_chunks(ragged, 4, 1 << 10))
    mask_nodes = tmi.build_levels(_words(1 << 11, 8, 40).to(cuda))
    path_nodes = tmi.build_levels(_words(1 << 13, 8, 41).to(cuda))
    batch = tmi.build_levels(_words(2 * 512, 8, 42).reshape(2, 512, 8).to(cuda))
    got = [u64_nodes, ragged_nodes, mask_nodes, batch, path_nodes]
    want = [t.clone() for t in got]

    def dirty(n, k):
        return torch.from_numpy(rng.choice(n, k, replace=False)).to(cuda)

    for step in range(60):
        k = int(rng.choice([0, 1, 2, 7, 64, 300, 1 << 12]))
        new_bal, new_ragged = bal.clone(), ragged.clone()
        new_bal[dirty(n_bal, min(k, n_bal))] += step + 1
        new_ragged[dirty(n_ragged, min(k, n_ragged))] ^= step + 1
        mask = torch.zeros(1 << 11, dtype=torch.bool, device=cuda)
        mask[dirty(1 << 11, min(k, 1 << 11))] = True
        rows = _words(1 << 11, 8, 100 + step).to(cuda)
        batch_leaves = _words(2 * 512, 8, 200 + step).reshape(2, 512, 8).to(cuda)

        def table(x):
            x[3][:, :512] = batch_leaves
            return [tmi.ForestTree(x[0], "u64", bal, new_bal, cap=1024, dense=1024),
                    tmi.ForestTree(x[1], "u64", ragged, new_ragged, cap=256, dense=256),
                    tmi.ForestTree(x[2], "mask", mask=mask, rows=rows, cap=512, dense=512),
                    tmi.ForestTree(x[3], "all")]

        counts = tmi.forest_update(table(got))
        want_counts = tmi.forest_update_ref(table(want))
        for g, w in zip(counts, want_counts):
            assert (g is None) == (w is None) and (g is None or torch.equal(g, w)), step
        idx = dirty(1 << 13, min(k, 1 << 13)).to(torch.int32)
        if k:
            vals = _words(idx.shape[0], 8, 300 + step).to(cuda)
            tmi.path_update(got[4], idx, vals)
            tmi.path_update_ref(want[4], idx, vals)
        torch.cuda.synchronize()
        for i, (g, w) in enumerate(zip(got, want)):
            assert torch.equal(g, w), (step, k, i)
        for scratch in tmi._scratch.values():
            assert not scratch.counters.any(), (step, k, "a counter or an accumulator left set")
            assert scratch.mask is None or not scratch.mask.any(), (step, k, "a mask byte left")
        bal, ragged = new_bal, new_ragged


@pytest.mark.parametrize("n", [1, 1000, 1 << 16])
def test_validator_leaves_at_kernel(cuda, n):
    arrays, _ = tsr.synthetic_static(n, seed=n, device="cpu")
    cols, _ = example_altair_inputs(n, device="cpu")
    args = (cols.effective_balance, _words(n, 8, 7), arrays.val_node_a, arrays.val_node_f)
    rng = np.random.default_rng(n)
    idx = torch.from_numpy(np.concatenate([rng.integers(0, n, 200), rng.integers(n, n + 50, 20),
                                           -rng.integers(1, 9, 4)]).astype(np.int32))
    on_card = tuple(a.to(cuda) for a in args)
    assert torch.equal(tsr.validator_leaves_at(*on_card, idx.to(cuda)).cpu(),
                       tsr.validator_leaves_at_ref(*args, idx))
    for dense in (-1, 150, 149):
        c = torch.tensor([150], dtype=torch.int32)
        got = tsr.validator_leaves_at(*on_card, idx.to(cuda), c.to(cuda), dense)
        assert torch.equal(got.cpu(), tsr.validator_leaves_at_ref(*args, idx, c, dense)), dense
    rows = torch.zeros((1 << max(n - 1, 0).bit_length(), 8), dtype=torch.int32)
    for dense in (0, 1):  # the dense side runs iff the count (1) exceeds dense
        one = torch.tensor([1], dtype=torch.int32)
        got = tsr.validator_leaves_into(rows.clone().to(cuda), *on_card, one.to(cuda), dense)
        assert torch.equal(got.cpu(), tsr.validator_leaves_into_ref(rows.clone(), *args, one, dense))


def _b_row_bytes(k: int, s: int) -> bytes:
    """B = H(chunk(k increments) || the chunk of slashed s), by hashlib."""
    eb = (k * tsr.EFFECTIVE_BALANCE_INCREMENT).to_bytes(8, "little") + bytes(24)
    return hashlib.sha256(eb + bytes([s]) + bytes(31)).digest()


def _row_bytes(words: torch.Tensor) -> bytes:
    return words.cpu().numpy().view(np.uint32).astype(">u4").tobytes()


def test_b_table_kernel_built_once_equals_hashlib(cuda):
    tsr.b_table.cache_clear()
    arrays, _ = tsr.synthetic_static(64, seed=1, device=cuda)
    cols, _ = example_altair_inputs(64, device=cuda)
    args = (cols.effective_balance, arrays.slashed_chunk, arrays.val_node_a, arrays.val_node_f,
            torch.arange(64, dtype=torch.int32, device=cuda))
    _ext.reset_launches()
    tsr.validator_leaves_at(*args)
    tsr.validator_leaves_at(*args)
    assert dict(_ext.launches) == {"validator_b_table": 1, "validator_leaves_at": 2}
    table = tsr.b_table(cols.effective_balance.device)
    assert table.shape == (tsr.B_TABLE_ROWS, 8)
    assert torch.equal(table.cpu(), tsr.b_table_ref())
    for k in (0, 1, 16, 32, 2047, 2048):
        for s in (0, 1):
            assert _row_bytes(table[2 * k + s]) == _b_row_bytes(k, s), (k, s)


def _leaf_corner_inputs(n: int, seed: int):
    """K3's indexed entry's corners: effective balances off the table (not a
    multiple of the increment, 2049 increments, 2^63, 2^64 - 1), slashed
    chunks off it (another word set, another first word), and rows on it."""
    rng = np.random.default_rng(seed)
    inc = tsr.EFFECTIVE_BALANCE_INCREMENT
    eff = rng.integers(0, 2049, n, dtype=np.int64).astype(np.uint64) * np.uint64(inc)
    eff[:8] = [inc + 1, 2049 * inc, 1 << 63, (1 << 64) - 1, 2048 * inc, 0, 32 * inc, 7]
    slashed = np.zeros((n, 8), np.uint32)
    slashed[rng.random(n) < 0.25, 0] = tsr.SLASHED_WORD
    slashed[8:11] = 0
    slashed[8, 3] = 1  # false's word, another word set
    slashed[9, 0] = tsr.SLASHED_WORD
    slashed[9, 7] = 0xFFFFFFFF  # true's word, another word set
    slashed[10, 0] = 2  # not a bool's chunk
    arrays, _ = tsr.synthetic_static(n, seed=seed, device="cpu")
    return (torch.from_numpy(eff.view(np.int64)), torch.from_numpy(slashed.view(np.int32)),
            arrays.val_node_a, arrays.val_node_f)


def test_validator_leaves_at_corners_one_launch_no_fill(cuda):
    n, cap = 1000, 4096
    args = _leaf_corner_inputs(n, 3)
    rng = np.random.default_rng(4)
    idx = np.concatenate([np.arange(16), rng.integers(0, n, cap - 24), [-1, n, n + 5, -7],
                          rng.integers(0, n, 4)]).astype(np.int32)
    idx = torch.from_numpy(idx)
    on_card = tuple(a.to(cuda) for a in args)
    tsr.validator_leaves_at(*on_card, idx.to(cuda))  # the table, once
    for count, dense in ((None, -1), (3000, -1), (3000, 3000), (3000, 2999), (0, -1), (5000, -1)):
        c = None if count is None else torch.tensor([count], dtype=torch.int32)
        want = tsr.validator_leaves_at_ref(*args, idx, c, dense)
        # the allocator hands the freed 0xFF block back: every row must be written
        stale = torch.full((cap, 8), -1, dtype=torch.int32, device=cuda)
        del stale
        _ext.reset_launches()
        got = tsr.validator_leaves_at(*on_card, idx.to(cuda), None if c is None else c.to(cuda),
                                      dense)
        assert dict(_ext.launches) == {"validator_leaves_at": 1}, (count, dense)
        assert torch.equal(got.cpu(), want), (count, dense)
    # rows on and off the table both hashed right: the first 16 rows by hashlib
    got = tsr.validator_leaves_at(*on_card, idx.to(cuda)).cpu()
    eff, slashed, a, f = (t.numpy() for t in args)
    for j in range(16):
        e = int(eff[j]) & ((1 << 64) - 1)
        b = hashlib.sha256(e.to_bytes(8, "little") + bytes(24)
                           + slashed[j].view(np.uint32).astype(">u4").tobytes()).digest()
        node_e = hashlib.sha256(a[j].view(np.uint32).astype(">u4").tobytes() + b).digest()
        root = hashlib.sha256(node_e + f[j].view(np.uint32).astype(">u4").tobytes()).digest()
        assert _row_bytes(got[j]) == root, j


def test_validator_leaves_at_repeated_calls_leave_the_table(cuda):
    n = 1 << 12
    args = tuple(a.to(cuda) for a in _leaf_corner_inputs(n, 5))
    first = tsr.validator_leaves_at(*args, torch.arange(64, dtype=torch.int32, device=cuda))
    table = tsr.b_table(args[0].device)
    before = table.clone()
    rng = np.random.default_rng(6)
    for i in range(40):
        cap = int(rng.choice([1, 7, 128, 4096]))
        idx = torch.from_numpy(rng.integers(-3, n + 3, cap).astype(np.int32)).to(cuda)
        count = torch.tensor([int(rng.integers(0, cap + 2))], dtype=torch.int32, device=cuda)
        dense = int(rng.choice([-1, cap // 2, cap]))
        got = tsr.validator_leaves_at(*args, idx, count, dense)
        want = tsr.validator_leaves_at_ref(*(a.cpu() for a in args), idx.cpu(), count.cpu(),
                                           dense)
        assert torch.equal(got.cpu(), want), i
    assert torch.equal(table, before) and torch.equal(before.cpu(), tsr.b_table_ref())
    assert torch.equal(tsr.validator_leaves_at(*args, torch.arange(64, dtype=torch.int32,
                                                                  device=cuda)), first)


@pytest.mark.parametrize("epoch", [0, 1, 1 << 63, (1 << 64) - 1])
def test_checkpoint_entry_kernel_equals_hashlib(cuda, epoch):
    rng = np.random.default_rng(epoch % 1000)
    roots = [np.zeros(32, np.uint8), np.full(32, 0xFF, np.uint8),
             rng.integers(0, 256, 32, dtype=np.uint8)]
    epochs = [epoch, (epoch + 1) % (1 << 64), epoch ^ 0x5555]
    cps = [(torch.tensor(np.uint64(e).astype(np.int64), device=cuda), torch.from_numpy(r).to(cuda))
           for e, r in zip(epochs, roots)]
    _ext.reset_launches()
    got = tsr.checkpoint_roots(cps)
    assert dict(_ext.launches) == {"merkle_lists": 1}
    assert torch.equal(got.cpu(), tsr.checkpoint_roots([(e.cpu(), r.cpu()) for e, r in cps]))
    for row, e, r in zip(got, epochs, roots):
        want = hashlib.sha256(e.to_bytes(8, "little") + bytes(24) + r.tobytes()).digest()
        assert _row_bytes(row) == want
    # the whole small-roots table of an epoch: three checkpoints, the bits,
    # two chunks, into their top rows of one launch
    just = example_altair_inputs(64, device=cuda)[1]
    slot_of = {name: i for i, name in tsr.dynamic_slots(tsr.state_fields("deneb"))}
    entries = tsr.small_lists(slot_of, just)
    chunk = torch.from_numpy(rng.integers(-(1 << 31), 1 << 31, 8).astype(np.int32)).to(cuda)
    entries[slot_of["current_epoch_participation"]] = tsr.chunk_list(chunk)
    top = _words(32, 8, 3)
    got = top.clone().to(cuda)
    _ext.reset_launches()
    tsr.KERNELS.list_roots(list(entries.values()), got, list(entries))
    assert dict(_ext.launches) == {"merkle_lists": 1}
    want = tsr.PLAIN.list_roots([type(t)(*(x.cpu() if torch.is_tensor(x) else x for x in t))
                                 for t in entries.values()], top.clone(), list(entries))
    assert torch.equal(got.cpu(), want)
    assert torch.equal(got[slot_of["current_epoch_participation"]], chunk)


@pytest.mark.parametrize("n", [1000, 1024])
@pytest.mark.parametrize("every", [0, 4], ids=["example", "every_4th_crosses"])
def test_state_inc_card_matches_plain_and_cpu(cuda, n, every):
    params = epoch_params("deneb", "mainnet")
    cols, just = example_altair_inputs(n, device="cpu")
    if every:
        cols = lower_balances(cols, every=every)
    static = tsr.synthetic_static(n, seed=6, device="cpu")
    on_card = [type(x)(*(None if t is None else t.to(cuda) for t in x)) for x in (cols, just)]
    arrays_card = type(static[0])(*(t.to(cuda) for t in static[0]))
    forest, _ = resident.build_state_forest_device(static, cols, device=cuda)
    _ext.reset_launches()
    torch.cuda.set_sync_debug_mode("error")  # the epoch loop never waits for the card
    try:
        got = resident.run_epochs(params, *on_card, 2, with_root="state_inc",
                                  static=(arrays_card, static[1]), device=cuda, forest=forest)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    counts = dict(_ext.launches)
    ref = resident.run_epochs_ref(params, cols, just, 2, with_root="state_inc", static=static,
                                  device=cuda)
    cpu = resident.run_epochs(params, cols, just, 2, with_root="state_inc", static=static,
                              device="cpu")
    full = resident.run_epochs(params, cols, just, 2, with_root="state", static=static, device=cuda)
    for want in (ref, cpu, full):
        assert torch.equal(got.root_acc.cpu(), want.root_acc.cpu())
        assert torch.equal(got.cols.balance.cpu(), want.cols.balance.cpu())
    for name in ("val_nodes", "bal_nodes", "inact_nodes", "part_root"):
        assert torch.equal(getattr(got.forest, name).cpu(), getattr(cpu.forest, name)), name
    assert torch.equal(got.dirty.cpu(), cpu.dirty)
    # the three trees of an epoch in one launch of the forest kernel
    assert counts["forest_update"] == 2
    assert not {"merkle_inc", "validator_leaves_at", "forest_mark"} & set(counts)
    # 4 launches an epoch: K4, the forest update, K2's lists (every dynamic
    # top chunk, the checkpoints among them) and K2's top; no K1
    assert counts == {"altair_epoch": 2, "forest_update": 2, "merkle_lists": 2, "merkle": 2}


def test_checkpoint_restore_and_scrub_on_card(cuda, tmp_path):
    params = epoch_params("deneb", "mainnet")
    cols, just = example_altair_inputs(1024, device=cuda)
    static = tsr.synthetic_static(1024, seed=8, device=cuda)
    carry, root, epoch = resident.run_epochs_checkpointed(
        params, cols, just, 2, static=static, ckpt_dir=str(tmp_path), ckpt_interval=1, device=cuda)
    rs = snapshot.restore(str(tmp_path), static=static, verify="device", device=cuda)
    assert rs.epoch == epoch == 2
    for name in ("val_nodes", "bal_nodes", "inact_nodes", "part_root"):
        assert torch.equal(getattr(rs.forest, name), getattr(carry.forest, name)), name
    assert not snapshot.scrub_forest(rs.forest, k=8).mismatches
    dmg = snapshot.flip_resident_word(rs.forest, "val_nodes", 2040)
    assert snapshot.scrub_forest(dmg, k=8).mismatches
    healed = snapshot.quarantine_rebuild(dmg, "val_nodes")
    assert snapshot.state_root_bytes(static, rs.plan, healed, rs.just) == root


# ------------------------- shuffle, phase0 epoch, batched roots (K7-K9, K2) --

@pytest.mark.parametrize("n", [1, 257, 4096])
def test_sha256_single_block_kernel(cuda, n):
    seed = hashlib.sha256(b"k7").digest()
    blocks = tsh.single_block_words(seed, 3, n, "cpu")
    got = sha256_single_block(blocks.to(cuda)).cpu()
    assert torch.equal(got, sha256_single_block_ref(blocks))
    msg = seed + bytes([2]) + (n - 1).to_bytes(4, "little")
    assert got[-1].numpy().view(np.uint32).astype(">u4").tobytes() == hashlib.sha256(msg).digest()


@pytest.mark.parametrize("rounds", [90, 10])
@pytest.mark.parametrize("n", [1, 2, 255, 256, 257, 1000, 4096, 100_003])
def test_shuffle_kernel(cuda, n, rounds):
    """K8 against its plain twin on the card and the host form: one lane,
    short last chunks, pivots below the index (the wrap of a negative flip)."""
    seed = hashlib.sha256(n.to_bytes(4, "little")).digest()
    _ext.reset_launches()
    got = tsh.shuffle_permutation_device(n, seed, rounds, device=cuda)
    assert _ext.launches["shuffle"] == 1 and _ext.launches["sha256_single_block"] == 1
    chunks = (n + 255) // 256
    digests = sha256_single_block(tsh.single_block_words(seed, rounds, chunks, cuda))
    pivots = torch.tensor(tsh.pivots(n, seed, rounds), dtype=torch.int32, device=cuda)
    assert torch.equal(got, tsh.shuffle_rounds_ref(digests, pivots, n))
    assert np.array_equal(got.cpu().numpy(), tsh.shuffle_permutation(n, seed, rounds))


@pytest.mark.parametrize("preset", ["mainnet", "minimal"])
@pytest.mark.parametrize("case", ("example",) + PHASE0_CORNERS)
def test_phase0_epoch_kernel(cuda, preset, case):
    half = {"mainnet": 4096, "minimal": 32}[preset]
    params = phase0_epoch_params(preset)
    if case == "example":
        cols, just = example_inputs(1000, slashings_half_vector=half, device=cuda)
    else:
        cols, just = phase0_corner_inputs(case, 1000, slashings_half_vector=half, device=cuda)
    got = tsc.epoch_accounting(params, cols, just)
    want = tsc.epoch_accounting_ref(params, cols, just)
    for name in want._fields:
        assert torch.equal(getattr(got, name), getattr(want, name)), name
    cpu = tsc.epoch_accounting(params, *(type(x)(*(t.cpu() for t in x)) for x in (cols, just)))
    assert torch.equal(got.balance.cpu(), cpu.balance)


def _assert_phase0_equal(params, cols, just):
    _ext.reset_launches()
    got = tsc.epoch_accounting(params, cols, just)
    assert dict(_ext.launches) == {"state_columns": 1}  # one cooperative launch a call
    want = tsc.epoch_accounting_ref(params, cols, just)
    for name in want._fields:
        assert torch.equal(getattr(got, name), getattr(want, name)), name


@pytest.mark.parametrize("case", ["example", "far_future_wide"])
def test_phase0_epoch_kernel_past_the_grid(cuda, case):
    """More validators than the cooperative grid keeps in registers (8 a
    thread): the excess is swept, scattered and applied one a thread,
    re-read, and the includers of far_future_wide point past the grid's
    runs and outside the registry."""
    n = (1 << 21) + 3
    params = phase0_epoch_params("mainnet")
    if case == "example":
        _assert_phase0_equal(params, *example_inputs(n, device=cuda))
    else:
        _assert_phase0_equal(params, *phase0_corner_inputs(case, n, device=cuda))


def test_phase0_epoch_kernel_unaligned_columns(cuda):
    """Columns that start one validator into their storage."""
    cols, just = example_inputs(4097, device=cuda)
    cols = cols._replace(**{k: v[1:] for k, v in cols._asdict().items()})
    assert cols.balance.data_ptr() % 16 == 8
    _assert_phase0_equal(phase0_epoch_params("mainnet"), cols, just)


def test_phase0_epoch_repeated_launches_leave_scratch_clean(cuda):
    """60 launches alternating presets, corners and sizes (one block, many,
    a ragged last run): each equal to the plain version in one launch, and
    the sums read zero after each."""
    cases = [(preset, case) for case in ("example",) + PHASE0_CORNERS
             for preset in ("mainnet", "minimal")]
    for i in range(60):
        preset, case = cases[i % len(cases)]
        params = phase0_epoch_params(preset)
        half = params.epochs_per_slashings_vector // 2
        n = (1000, (1 << 16) + 3, 64)[i % 3]
        cols, just = (example_inputs(n, slashings_half_vector=half, device=cuda)
                      if case == "example" else
                      phase0_corner_inputs(case, n, slashings_half_vector=half, device=cuda))
        _assert_phase0_equal(params, cols, just)
        scratch = tsc.stream_scratch(cols.balance.device)
        assert not scratch.any(), f"launch {i} left its scratch set"


@pytest.mark.parametrize("trees,depth", [(1, 0), (3, 0), (1, 1), (3, 5), (64, 5), (3, 9), (3, 10),
                                         (64, 12), (1, 16), (8, 16)])
def test_many_tree_root_kernel(cuda, trees, depth):
    leaves = _words(trees << depth, 8, depth).reshape(trees, 1 << depth, 8)
    _ext.reset_launches()
    got = merkle.many_tree_root(leaves.to(cuda), depth).cpu()
    assert dict(_ext.launches) == {"merkle_many": 1}
    assert torch.equal(got, merkle.many_tree_root_ref(leaves, depth))
    for b in {0, trees - 1}:
        assert torch.equal(got[b], merkle.tree_root(leaves[b].to(cuda), depth).cpu())


def test_tree_roots_climb_in_waves(cuda):
    """Grids of more leaf blocks than the card holds at once (2,048 of 256
    threads): one 2^20 tree and four 2^18 trees, against the plain reduction
    on the card; their counters left clean."""
    leaves = _words(1 << 20, 8, 20).to(cuda)
    _ext.reset_launches()
    got = merkle.tree_root(leaves, 20)
    many = merkle.many_tree_root(leaves.reshape(4, 1 << 18, 8), 18)
    assert dict(_ext.launches) == {"merkle": 1, "merkle_many": 1}
    assert torch.equal(got, merkle.tree_root_ref(leaves, 20))
    assert torch.equal(many, merkle.many_tree_root_ref(leaves.reshape(4, 1 << 18, 8), 18))
    scratch = merkle._scratch[(str(leaves.device), torch.cuda.current_stream(cuda).cuda_stream)]
    assert not scratch.counters.any()


def _ragged_lists(dev):
    """Lists of every kind in one table: u64 and u8 columns whose counts
    leave the last chunk part full and fill no tree, one item, an empty
    list, chunk words reduced to their own depth, a root folded from level
    20 to 63, a tree of several rounds (2^20 u64 chunks' worth)."""
    rng = np.random.default_rng(14)
    u64 = torch.from_numpy(rng.integers(0, 2**63, 100_003, dtype=np.int64)).to(dev)
    u8 = torch.from_numpy(rng.integers(0, 256, 70_001, dtype=np.uint8)).to(dev)
    words = _words(5000, 8, 3).to(dev)
    return [merkle.ListTree(u64, 100_003, 38, 100_003), merkle.ListTree(u8, 70_001, 35, 70_001),
            merkle.ListTree(u64, 1, 38, 1), merkle.ListTree(u8, 0, 35, 0),
            merkle.ListTree(words, 4096, 12), merkle.ListTree(words, 5000, 40, 2**40),
            merkle.ListTree(words[7:8], 1, 63, 2**64 - 1, depth=0, base=20),
            merkle.ListTree(u8, 32 * 1000, 12)]


def test_list_roots_kernel(cuda):
    lists = _ragged_lists(cuda)
    _ext.reset_launches()
    got = merkle.list_roots(lists)
    assert dict(_ext.launches) == {"merkle_lists": 1}
    cpu = [merkle.ListTree(t.src.cpu(), *t[1:]) for t in lists]
    assert torch.equal(got.cpu(), merkle.list_roots_ref(cpu))
    scratch = merkle._scratch[(str(got.device), torch.cuda.current_stream(cuda).cuda_stream)]
    assert not scratch.counters.any()  # left clean for the next launch
    # the same roots into rows of a buffer; every one again after a second launch
    out = torch.zeros((20, 8), dtype=torch.int32, device=cuda)
    rows = [19, 3, 5, 7, 0, 11, 13, 2]
    merkle.list_roots(lists, out, rows)
    assert torch.equal(out[rows], got) and not out[[1, 4, 6]].any()
    # one list against hashlib: the u8 column, packed, folded and mixed
    zh = merkle.zerohashes()
    raw = lists[1].src.cpu().numpy().tobytes()
    level = [raw[i:i + 32].ljust(32, b"\0") for i in range(0, len(raw), 32)]
    depth = (len(level) - 1).bit_length()
    level += [zh[0]] * ((1 << depth) - len(level))
    while len(level) > 1:
        level = [hashlib.sha256(level[i] + level[i + 1]).digest() for i in range(0, len(level), 2)]
    root = level[0]
    for d in range(depth, 35):
        root = hashlib.sha256(root + zh[d]).digest()
    root = hashlib.sha256(root + (70_001).to_bytes(8, "little") + bytes(24)).digest()
    assert got[1].cpu().numpy().view(np.uint32).astype(">u4").tobytes() == root


def test_list_roots_rejects_what_the_kernel_does_not_take(cuda):
    vals = torch.zeros(64, dtype=torch.int64, device=cuda)
    with pytest.raises(ValueError):
        merkle.list_roots([merkle.ListTree(vals[1:], 63, 38)])  # not 16-byte aligned
    with pytest.raises(ValueError):
        merkle.list_roots([merkle.ListTree(vals, 64, 38)] * (merkle.MAX_TREES + 1))
    with pytest.raises(ValueError):
        merkle.list_roots([merkle.ListTree(vals, 64, 38)], torch.zeros((2, 8), dtype=torch.int32,
                                                                    device=cuda), [2])


def test_merkleize_many_device_on_card(cuda):
    rng = np.random.default_rng(5)
    trees = [rng.integers(0, 256, ((4096 - 37 * i) % 4097, 32), dtype=np.uint8) for i in range(64)]
    got = merkle.merkleize_many_device(trees, 12, pad_batch=64, device=cuda)
    assert got == merkle.merkleize_many_device(trees, 12, pad_batch=64, device="cpu")
    assert merkle.merkleize_subtree_device(trees[5], 12, device=cuda) == got[5]


# --- K10-K12: the BLS kernels against their plain versions on corners ----------


def _g1_corner_lists(lanes: int):
    from eth_consensus_specs_tpu_torch.crypto.curve import g1_infinity
    from eth_consensus_specs_tpu_torch.inputs import g1_keys

    keys = g1_keys(max(lanes, 4), first=11)
    p = keys[0]
    return [
        keys[:lanes],  # full
        keys[: max(1, lanes // 2 - 1)],  # ragged, padded lanes
        [p, p] + keys[1: lanes - 1] if lanes >= 2 else [p],  # P + P at the first level
        [p, -p] + keys[2:lanes] if lanes >= 2 else [p],  # P + (-P)
        [g1_infinity()] * lanes,  # every Z = 0
        [g1_infinity(), p] + [g1_infinity()] * (lanes - 2) if lanes >= 2 else [g1_infinity()],
    ]


@pytest.mark.parametrize("lanes", [1, 2, 8, 256, 1024])
def test_g1_sum_kernel(cuda, lanes):
    from eth_consensus_specs_tpu_torch.crypto.curve import g1_infinity
    from eth_consensus_specs_tpu_torch.ops import g1_msm

    lists = _g1_corner_lists(lanes)
    X, Y, Z = (torch.from_numpy(a) for a in g1_msm.pack_lanes(lists, lanes))
    _ext.reset_launches()
    got = g1_msm.sum_many(X.to(cuda), Y.to(cuda), Z.to(cuda))
    assert _ext.launches["g1_sum"] == len(g1_msm.sum_plan(lanes)) + 1
    assert torch.equal(got, g1_msm.sum_many_ref(X.to(cuda), Y.to(cuda), Z.to(cuda)))
    want = []
    for pts in lists:
        acc = g1_infinity()
        for p in pts:
            acc = acc + p
        want.append(acc)
    assert g1_msm.sums_to_points(got) == want


# K10's split: lanes passes of one thread an add, then the fold a warp an
# add; the shapes of a block, agg_slot's tiers and the slot, an electra block
@pytest.mark.parametrize("items, lanes", [(1, 512), (64, 512), (128, 512), (8, 32768), (3, 1),
                                          (3, 2)])
def test_g1_sum_kernel_split_shapes(cuda, items, lanes):
    from eth_consensus_specs_tpu_torch.crypto.curve import g1_generator, g1_infinity
    from eth_consensus_specs_tpu_torch.crypto.fields import R
    from eth_consensus_specs_tpu_torch.ops import g1_msm

    # lanes as signed multiples s of G (0: infinity), so the host sum is one
    # scalar multiple
    g = g1_generator()
    lists = [[(i + j) % 64 + 11 for j in range(lanes)] for i in range(items)]
    # corners on different levels of the split (B = min(lanes, 32) partials
    # meet in the fold): P + P and P + (-P) at the first level; both in a
    # lanes pass's last level (lanes 0 and B of an item of infinity); both
    # in the fold's first two levels (lanes 1 and 1 + B/2, 2 and 2 + B/4);
    # every other lane at infinity; an item all at infinity; a ragged item
    B = min(lanes, g1_msm.SUM_FOLD_PARTIALS)
    p, q = 14, 15
    for i, sc in enumerate(lists):
        c = (i + 3) % 6
        if c == 0 and lanes >= 2:
            sc[1] = sc[1 + lanes // 2] = p
        elif c == 1 and lanes >= 2:
            sc[0], sc[lanes // 2] = p, -p
        elif c == 2 and lanes > B:
            sc[:] = [0] * lanes
            sc[0] = sc[B] = p
            sc[3], sc[3 + B] = q, -q
        elif c == 3 and lanes >= 8:
            sc[:] = [0] * lanes
            sc[1], sc[1 + B // 2] = p, -p
            sc[2] = sc[2 + B // 4] = q
        elif c == 4:
            sc[::2] = [0] * len(sc[::2])
        elif c == 5:
            sc[:] = [0] * lanes
    if items > 1:
        lists[-1] = lists[-1][: max(1, lanes // 3)]
    cache = {0: g1_infinity()}
    for sc in lists:
        for k in sc:
            if k not in cache:
                cache[k] = g.mul(abs(k)) if k > 0 else -g.mul(-k)
    pts = [[cache[k] for k in sc] for sc in lists]
    X, Y, Z = (torch.from_numpy(a).to(cuda) for a in g1_msm.pack_lanes(pts, lanes))
    _ext.reset_launches()
    got = g1_msm.sum_many(X, Y, Z)
    assert _ext.launches["g1_sum"] == len(g1_msm.sum_plan(lanes)) + 1
    assert torch.equal(got, g1_msm.sum_many_ref(X, Y, Z))
    want = [g.mul(sum(sc) % R) if sum(sc) % R else g1_infinity() for sc in lists]
    assert g1_msm.sums_to_points(got) == want


def _pairs(n: int, inactive=()):
    from eth_consensus_specs_tpu_torch.crypto.curve import g1_infinity, g1_generator
    from eth_consensus_specs_tpu_torch.crypto.hash_to_curve import hash_to_g2

    g = g1_generator()
    return [(g1_infinity() if i in inactive else g.mul(3 + 7 * i), hash_to_g2(b"pair-%d" % i))
            for i in range(n)]


# pair counts against K11's group (a pair) and block (two pairs) sizes
@pytest.mark.parametrize("n,inactive", [(1, ()), (2, (1,)), (9, (0, 4)), (31, (3,)), (32, ()),
                                        (33, ()), (33, (0, 32)), (129, (5, 64))])
def test_miller_product_kernel(cuda, n, inactive):
    from eth_consensus_specs_tpu_torch.crypto import pairing as oracle
    from eth_consensus_specs_tpu_torch.ops import pairing_device as pd

    args = [torch.from_numpy(a).to(cuda) for a in pd.pack_pairs(_pairs(n, inactive))]
    _ext.reset_launches()
    got = pd.miller_product(*args)
    assert _ext.launches["miller"] == 1 and _ext.launches["miller_fold"] == 1
    assert torch.equal(got, pd.miller_product_ref(*args))
    for _ in range(20):  # shared memory races would show as other words
        assert torch.equal(pd.miller_product(*args), got)
    if n <= 2:
        want = oracle.Fq12.one()
        for i, (p, q) in enumerate(_pairs(n)):
            if i not in inactive:
                want = want * oracle.miller_loop(p, oracle.untwist(q))
        assert pd.fq12_from_words(got) == want


def test_final_exp_kernel(cuda):
    from eth_consensus_specs_tpu_torch.crypto.curve import g1_generator
    from eth_consensus_specs_tpu_torch.crypto.fields import Fq12
    from eth_consensus_specs_tpu_torch.crypto.hash_to_curve import hash_to_g2
    from eth_consensus_specs_tpu_torch.ops import pairing_device as pd

    g, q = g1_generator(), hash_to_g2(b"bilinear")
    cases = {
        "true": [(g.mul(6), q.mul(5)), (-g.mul(30), q)],
        "false": [(g.mul(6), q.mul(5)), (-g.mul(31), q)],
    }
    for name, pairs in cases.items():
        f = pd.miller_product(*[torch.from_numpy(a).to(cuda) for a in pd.pack_pairs(pairs)])
        _ext.reset_launches()
        got = pd.final_exp_is_one(f)
        assert _ext.launches["final_exp"] == 1
        assert bool(got) == (name == "true") == bool(pd.final_exp_is_one_ref(f))
        assert all(torch.equal(pd.final_exp_is_one(f), got) for _ in range(20))
    one = torch.from_numpy(pd.fq12_to_words(Fq12.one())).to(cuda)
    assert bool(pd.final_exp_is_one(one))
    zero = torch.zeros_like(one)
    assert not bool(pd.final_exp_is_one(zero)) and not bool(pd.final_exp_is_one_ref(zero))
    wide = pd.miller_product(*[torch.from_numpy(a).to(cuda) for a in pd.pack_pairs(_pairs(33))])
    assert bool(pd.final_exp_is_one(wide)) == bool(pd.final_exp_is_one_ref(wide)) is False
    with pytest.raises(ValueError):
        pd.final_exp_is_one(one.to(torch.int64))


@pytest.mark.parametrize("lanes", [1, 4])
def test_fq12_coop_check_kernel(cuda, lanes):
    from eth_consensus_specs_tpu_torch.crypto.fields import P
    from eth_consensus_specs_tpu_torch.ops import field_limbs as fl
    from eth_consensus_specs_tpu_torch.ops import pairing_device as pd

    rng = np.random.default_rng(lanes)

    def words(*shape):
        vals = [int.from_bytes(rng.bytes(48), "little") % P for _ in range(int(np.prod(shape)))]
        return torch.from_numpy(fl.ints_to_words(vals).reshape(*shape, 12)).to(cuda)

    a, b, line = words(5, 2, 3, 2), words(5, 2, 3, 2), words(5, 5)
    a = fl.to_words(pd._easy_part(fl.from_words(a)))  # cyclotomic: both squarings agree
    for reps in (1, 3):
        _ext.reset_launches()
        got = pd.fq12_coop_check(a, b, line, reps, lanes)
        assert _ext.launches["fq12_coop"] == 1
        want = pd.fq12_coop_check_ref(a, b, line, reps)
        assert torch.equal(got, want) and torch.equal(got[:, 1], got[:, 2])
        assert all(torch.equal(pd.fq12_coop_check(a, b, line, reps, lanes), got)
                   for _ in range(20))


def test_verify_many_on_card(cuda):
    import random

    from eth_consensus_specs_tpu_torch.inputs import attestation_block
    from eth_consensus_specs_tpu_torch.ops import bls_batch

    items, _ = attestation_block(6, 4, distinct=4, tamper=(3,))
    assert bls_batch.verify_many(items, device=cuda, rng=random.Random(2)) == [
        True, True, True, False, True, True]
    assert bls_batch.verify_many(items, device="cpu", rng=random.Random(2)) == [
        True, True, True, False, True, True]


@pytest.mark.parametrize("n", [1, 17, 128])
def test_h2c_kernels(cuda, n):
    from eth_consensus_specs_tpu_torch.crypto.hash_to_curve import hash_to_g2
    from eth_consensus_specs_tpu_torch.ops import field_limbs as fl
    from eth_consensus_specs_tpu_torch.ops import h2c_device as hd

    msgs = [b"card-h2c-%d" % i for i in range(n)]
    rows = hd.field_elements(msgs)
    if n > 1:  # u = 0 (tv2 = 0) and u with c1 = 0 among them
        rows[0] = [[0, 0], [5, 7]]
        rows[1] = [[3, 0], [12345, 0]]
    u = torch.from_numpy(fl.ints_to_words(rows)).to(cuda)
    _ext.reset_launches()
    jac = hd.h2c_map(u)
    xy, inf = hd.h2c_finish(jac)
    assert _ext.launches["h2c_map"] == 1 and _ext.launches["h2c_finish"] == 1
    assert torch.equal(jac, hd.h2c_map_ref(u))
    rxy, rinf = hd.h2c_finish_ref(jac)
    assert torch.equal(xy, rxy) and torch.equal(inf, rinf)
    got = hd.points_from_words(xy, inf)
    assert got[2:] == [hash_to_g2(m) for m in msgs[2:]]
    assert hd.hash_to_g2_device(msgs[:3], device=cuda) == [hash_to_g2(m) for m in msgs[:3]]


def test_h2c_map_square_and_non_square_in_one_warp(cuda):
    """K13's one warp (16 messages, 32 elements) holds elements whose g(x1)
    is a square and elements whose g(x1) is not, alternating, and u = 0 and
    u with c1 = 0 among them: the words equal the plain version's and the
    points the host map's."""
    import random

    from eth_consensus_specs_tpu_torch.crypto import hash_to_curve as h2c
    from eth_consensus_specs_tpu_torch.crypto.fields import P, Fq, Fq2
    from eth_consensus_specs_tpu_torch.ops import field_limbs as fl
    from eth_consensus_specs_tpu_torch.ops import h2c_device as hd

    def g_x1_square(u):
        tv1 = h2c.Z_SSWU * u.square()
        tv2 = tv1.square() + tv1
        if tv2.is_zero():
            return True
        x1 = (-h2c.B_PRIME) * h2c.A_PRIME.inv() * (Fq2.one() + tv2.inv())
        return ((x1.square() + h2c.A_PRIME) * x1 + h2c.B_PRIME).sqrt() is not None

    rnd = random.Random(13)
    pools = {True: [], False: []}
    while min(len(v) for v in pools.values()) < 15:
        u = [rnd.randrange(P), rnd.randrange(P)]
        pools[g_x1_square(Fq2.from_ints(*u))].append(u)
    elems = [[0, 0], [12345, 0]] + [pools[k % 2 == 0][k // 2] for k in range(30)]
    kinds = [g_x1_square(Fq2.from_ints(*e)) for e in elems]
    assert any(kinds) and not all(kinds)
    rows = [elems[2 * m: 2 * m + 2] for m in range(16)]
    u = torch.from_numpy(fl.ints_to_words(rows)).to(cuda)
    _ext.reset_launches()
    jac = hd.h2c_map(u)
    assert _ext.launches["h2c_map"] == 1
    assert torch.equal(jac, hd.h2c_map_ref(u))
    xy, inf = hd.h2c_finish(jac)
    want = [h2c.clear_cofactor_g2(h2c.map_to_curve_g2(Fq2(Fq(a[0]), Fq(a[1])))
                                  + h2c.map_to_curve_g2(Fq2(Fq(b[0]), Fq(b[1]))))
            for a, b in rows]
    assert hd.points_from_words(xy, inf) == want


def test_fq2_sqrt_kernel(cuda):
    from eth_consensus_specs_tpu_torch.crypto.fields import P, Fq, Fq2
    from eth_consensus_specs_tpu_torch.ops import field_limbs as fl
    from eth_consensus_specs_tpu_torch.ops import h2c_device as hd

    cases = [Fq2(Fq(5), Fq(7)).square(), Fq2(Fq(11), Fq(0)).square(), Fq2(Fq(0), Fq(13)).square(),
             Fq2(Fq(3), Fq(1)), Fq2(Fq(0), Fq(0)), Fq2(Fq(P - 2), Fq(P - 5)).square(),
             Fq2(Fq(5), Fq(0)), Fq2(Fq(P - 5), Fq(0))]
    v = torch.from_numpy(fl.ints_to_words([[c.c0.n, c.c1.n] for c in cases]))
    root, ok = hd.fq2_sqrt(v.to(cuda))
    _, ok_ref = hd.fq2_sqrt(v)
    assert torch.equal(ok.cpu(), ok_ref)
    for c, r, flag in zip(cases, fl.words_to_ints(root), ok.tolist()):
        if flag:
            assert Fq2.from_ints(*r).square() == c


@pytest.mark.parametrize("lanes", [1, 2, 8, 512])
def test_g2_sum_kernel(cuda, lanes):
    from eth_consensus_specs_tpu_torch.crypto.curve import g2_generator, g2_infinity
    from eth_consensus_specs_tpu_torch.crypto.signature import _sum_g2
    from eth_consensus_specs_tpu_torch.ops import g2_aggregate as ga

    g, inf = g2_generator(), g2_infinity()
    p = g.mul(4)
    lists = [[g.mul(k + 1) for k in range(lanes)], [g.mul(3)], [inf] * lanes,
             [p, p] if lanes >= 2 else [p], [p, -p] if lanes >= 2 else [inf],
             [inf, p, inf, g.mul(9)][:lanes], [g.mul(k + 2) for k in range(max(1, lanes // 2 - 1))]]
    X, Y, Z = (torch.from_numpy(a).to(cuda) for a in ga._points_to_lanes(lists, 8, lanes))
    _ext.reset_launches()
    got = ga.g2_sum_many(X, Y, Z)
    assert _ext.launches["g2_sum"] == len(ga.sum_plan(8, lanes))
    assert torch.equal(got, ga.g2_sum_many_ref(X, Y, Z))
    assert ga.sums_to_points(got[: len(lists)]) == [_sum_g2(pts) for pts in lists]


# K15's plan: lanes passes of one thread an add while a level has many adds,
# then warp passes on the round engine; agg_slot's tier shapes and the slot's
@pytest.mark.parametrize("items, lanes", [(1, 512), (64, 1), (2, 32), (64, 512)])
def test_g2_sum_kernel_plan_shapes(cuda, items, lanes):
    from eth_consensus_specs_tpu_torch.crypto.curve import g2_generator
    from eth_consensus_specs_tpu_torch.inputs import point_multiples
    from eth_consensus_specs_tpu_torch.ops import g2_aggregate as ga

    g = g2_generator()
    pts = point_multiples(g, 1, items * lanes)
    lists = [pts[i * lanes:(i + 1) * lanes] for i in range(items)]
    X, Y, Z = (torch.from_numpy(a).to(cuda) for a in ga._points_to_lanes(lists, items, lanes))
    _ext.reset_launches()
    got = ga.g2_sum_many(X, Y, Z)
    assert _ext.launches["g2_sum"] == len(ga.sum_plan(items, lanes))
    assert torch.equal(got, ga.g2_sum_many_ref(X, Y, Z))
    assert ga.sums_to_points(got) == [g.mul(sum(range(i * lanes + 1, (i + 1) * lanes + 1)))
                                      for i in range(items)]


def test_g2_sum_kernel_corners_across_passes(cuda):
    """Sums that meet as P + P and P + (-P) within a pass, across the lanes
    pass's boundary and across the warp passes', lanes at infinity, at a
    shape whose plan starts with a lanes pass."""
    from eth_consensus_specs_tpu_torch.crypto.curve import g2_generator, g2_infinity
    from eth_consensus_specs_tpu_torch.crypto.signature import _sum_g2
    from eth_consensus_specs_tpu_torch.inputs import point_multiples
    from eth_consensus_specs_tpu_torch.ops import g2_aggregate as ga

    pts = point_multiples(g2_generator(), 1, 64)
    p, q, inf = pts[5], pts[6], g2_infinity()
    lists = [[inf] * 512, [p], [p, p] + pts[10:20], [p, -p] + pts[20:30], pts[:37],
             [inf, p, inf, pts[9]], [p, q, p, q], [p, q, -p, -q], pts[:8] + pts[:8],
             pts[16:24] + [-x for x in pts[16:24]], [inf, inf, p, inf] * 8]
    lists += [[] for _ in range(16 - len(lists))]
    assert ga.sum_plan(16, 512)[0][0] == "thread"
    X, Y, Z = (torch.from_numpy(a).to(cuda) for a in ga._points_to_lanes(lists, 16, 512))
    got = ga.g2_sum_many(X, Y, Z)
    assert torch.equal(got, ga.g2_sum_many_ref(X, Y, Z))
    assert ga.sums_to_points(got) == [_sum_g2(pts) for pts in lists]


def test_g2_sum_plan_header_is_the_generators_output(cuda):
    """The build wrote K15's plan header as the generator renders it."""
    from eth_consensus_specs_tpu_torch.ops import g2_aggregate as ga

    _ext.lib("g2_sum")
    assert (_ext.BUILD_DIR / "include" / "g2_sum_plan.cuh").read_text() == ga.sum_plan_header()


def test_aggregate_slot_on_card(cuda):
    import random

    from eth_consensus_specs_tpu_torch.inputs import slot_committees
    from eth_consensus_specs_tpu_torch.ops import agg_tree, bls_batch

    from eth_consensus_specs_tpu_torch.ops import g1_msm

    from eth_consensus_specs_tpu_torch.ops import g2_aggregate as ga

    atts, bad = slot_committees(256, 8, 16, n_roots=2, invalid=2)
    lanes, shapes, sum_many, g2_sum_many = [], [], g1_msm.sum_many, ga.g2_sum_many

    def recorded(X, Y, Z):
        lanes.append(X.shape[1])
        return sum_many(X, Y, Z)

    def recorded_g2(X, Y, Z):
        shapes.append(tuple(X.shape[:2]))
        return g2_sum_many(X, Y, Z)

    _ext.reset_launches()
    g1_msm.sum_many, ga.g2_sum_many = recorded, recorded_g2
    try:
        slot, subs = agg_tree.aggregate_slot(atts, device=cuda)
    finally:
        g1_msm.sum_many, ga.g2_sum_many = sum_many, g2_sum_many
    # 8 + 2 tiers, each K10 call len(sum_plan(L)) + 1 launches, each K15
    # call len(sum_plan(I, L))
    assert len(shapes) == 8 + 2 and len(lanes) == 8 + 2
    assert _ext.launches["g2_sum"] == sum(len(ga.sum_plan(*sh)) for sh in shapes)
    assert _ext.launches["g1_sum"] == sum(len(g1_msm.sum_plan(n)) + 1 for n in lanes)
    hslot, hsubs = agg_tree.aggregate_slot_host(atts)
    assert [(s.sig, s.pubkey, s.bits.tolist()) for s in slot] == \
        [(s.sig, s.pubkey, s.bits.tolist()) for s in hslot]
    assert [(s.subnet, s.root, s.sig, s.pubkey) for s in subs] == \
        [(s.subnet, s.root, s.sig, s.pubkey) for s in hsubs]
    assert agg_tree.verify_slot(slot, device=cuda, rng=random.Random(1)) == [False, False]
    bls_batch._H2G2_CACHE.clear()
    _ext.reset_launches()
    assert agg_tree.isolate_invalid_subnets(subs, device=cuda, rng=random.Random(2)) == bad
    assert _ext.launches["h2c_map"] >= 1


def test_verify_many_hashes_on_card(cuda):
    import random

    from eth_consensus_specs_tpu_torch.inputs import attestation_block
    from eth_consensus_specs_tpu_torch.ops import bls_batch

    items, _ = attestation_block(6, 4, distinct=5, call=9, tamper=(4,))
    want = [True, True, True, True, False, True]
    bls_batch._H2G2_CACHE.clear()
    _ext.reset_launches()
    assert bls_batch.verify_many(items, device=cuda, rng=random.Random(3)) == want
    assert _ext.launches["h2c_map"] == 1 and _ext.launches["h2c_finish"] == 1
    bls_batch._H2G2_CACHE.clear()
    bls_batch._prime_h2g2_cache(list(dict.fromkeys(msg for _, msg, _ in items)))
    _ext.reset_launches()
    assert bls_batch.verify_many(items, device=cuda, rng=random.Random(3)) == want
    assert _ext.launches["h2c_map"] == 0


def _fr_rows(b: int, n: int, seed: int) -> torch.Tensor:
    """int32[b, n, 8] words of values below r (top word below r's), with
    the corners 0, 1, r - 1 and 2^254 at the head of row 0."""
    from eth_consensus_specs_tpu_torch.ops import limb_field as lf

    rng = np.random.default_rng(seed)
    w = rng.integers(0, 2**32, size=(b, n, 8), dtype=np.uint64)
    w[..., 7] %= lf.R_MOD >> 224
    vals = w.astype(np.uint32).view(np.int32)
    corners = lf.ints_to_words([0, 1, lf.R_MOD - 1, 1 << 254])
    vals[0, : min(n, 4)] = corners[: min(n, 4)]
    return torch.from_numpy(vals)


@pytest.mark.parametrize("b,n", [(1, 1), (3, 2), (3, 4), (3, 8), (3, 16), (2, 512), (5, 1024),
                                 (4, 4096), (2, 8192), (1, 1 << 15)])
@pytest.mark.parametrize("inverse", [False, True])
@pytest.mark.parametrize("bitrev", [True, False])
def test_fr_fft_kernel(cuda, b, n, inverse, bitrev):
    from eth_consensus_specs_tpu_torch.crypto import das, kzg
    from eth_consensus_specs_tpu_torch.ops import fr_fft
    from eth_consensus_specs_tpu_torch.ops import limb_field as lf

    vals = _fr_rows(b, n, n + b).to(cuda)
    roots = kzg.compute_roots_of_unity(n) if n > 1 else (1,)
    tw = fr_fft._device_twiddles(fr_fft.inverse_roots(roots) if inverse else roots, n, "cuda")
    scale = fr_fft._device_scale(n, "cuda") if inverse else None
    _ext.reset_launches()
    got = fr_fft.fft_rows(vals, tw, scale, bitrev)
    assert dict(_ext.launches) == {"fr_fft": 1}
    assert torch.equal(got, fr_fft.fft_rows_ref(vals, tw, scale, bitrev))
    row = lf.words_to_ints(vals[0])
    want = das.fft_field(row if bitrev else kzg.bit_reversal_permutation(row), roots, inv=inverse)
    assert lf.words_to_ints(got[0]) == want


@pytest.mark.parametrize("items,lanes", [(1, 1), (2, 7), (2, 129), (1, 300), (3, 40)])
def test_g1_msm_kernel(cuda, items, lanes):
    import random

    from eth_consensus_specs_tpu_torch.crypto.fields import R
    from eth_consensus_specs_tpu_torch.crypto.msm import msm_g1
    from eth_consensus_specs_tpu_torch.inputs import g1_keys
    from eth_consensus_specs_tpu_torch.ops import g1_msm

    rnd = random.Random(lanes)
    keys = g1_keys(items * lanes)
    points = [keys[i * lanes:(i + 1) * lanes] for i in range(items)]
    scalars = [[rnd.randrange(R) for _ in range(lanes)] for _ in range(items)]
    K, X, Y, Z = (torch.from_numpy(a).to(cuda) for a in g1_msm.pack_msm(points, scalars))
    _ext.reset_launches()
    got = g1_msm.msm_many(K, X, Y, Z)
    blocks = -(-2 * lanes // g1_msm.MSM_GROUPS)  # past one block, the fold sums the partials
    assert _ext.launches["g1_msm"] == 1 and _ext.launches["g1_msm_fold"] == int(blocks > 1)
    assert torch.equal(got, g1_msm.msm_many_ref(K, X, Y, Z))
    assert g1_msm.sums_to_points(got) == [msm_g1(p, s) for p, s in zip(points, scalars)]


def test_g1_msm_kernel_corners(cuda):
    from eth_consensus_specs_tpu_torch.crypto.curve import g1_infinity
    from eth_consensus_specs_tpu_torch.crypto.fields import R
    from eth_consensus_specs_tpu_torch.crypto.msm import msm_g1
    from eth_consensus_specs_tpu_torch.inputs import g1_keys
    from eth_consensus_specs_tpu_torch.ops import g1_msm

    keys = g1_keys(12)
    p = keys[0]
    points = [keys[1:7], [g1_infinity(), keys[7]], [p, -p], [keys[8]], keys[9:12], [p, p]]
    scalars = [[0, 1, R - 1, (1 << 256) - 1, R, R + 2], [11, 5], [7, 7], [R - 3], [0, 0, 0],
               [9, 9]]
    K, X, Y, Z = (torch.from_numpy(a).to(cuda) for a in g1_msm.pack_msm(points, scalars))
    got = g1_msm.msm_many(K, X, Y, Z)
    assert torch.equal(got, g1_msm.msm_many_ref(K, X, Y, Z))
    assert g1_msm.sums_to_points(got) == [msm_g1(p, s) for p, s in zip(points, scalars)]


def test_verify_many_blobs_on_card(cuda):
    from eth_consensus_specs_tpu_torch.inputs import blob_flush
    from eth_consensus_specs_tpu_torch.ops import kzg_batch

    items, bad = blob_flush(5, degree=8, invalid=1)
    want = [i not in bad for i in range(5)]
    _ext.reset_launches()
    assert kzg_batch.verify_many_blobs(items, device=cuda) == want == [False] + [True] * 4
    assert _ext.launches["fr_fft"] == 1 and _ext.launches["g1_msm"] >= 3
    assert kzg_batch.verify_many_blobs(items, device="cpu") == want
    assert kzg_batch.verify_blob_kzg_proof_batch_device(*map(list, zip(*items[1:])), device=cuda)


# --- K18: the slot-apply scatter -------------------------------------------------

SLOT_PLANS = {
    "plain": ([1, 2, 3, 5, 8], [5, 9], [1024, 1024]),
    "duplicates": ([3, 3, 7, 7, 7, 3], [4, 4, 4, 10], [1024, 1024, 7, 1]),
    "ends": ([0, 999], [0, 999, 0], [1024, 1 << 40, 3]),
    "wrap": ([5], [5, 6, 6], [1024, 1, 1 << 62]),
    "flags_only": ([10, 11, 11], [], []),
    "empty": ([], [], []),
}


@pytest.mark.parametrize("case", list(SLOT_PLANS))
def test_slot_apply_kernel(cuda, case):
    from eth_consensus_specs_tpu_torch.ops import slot_pipeline as sp

    n = 1000
    cols, _ = example_altair_inputs(n, device=cuda)
    balance = cols.balance.clone()
    balance[5], balance[6] = -1, (1 << 63) - 1  # 2^64 - 1 wraps, 2^63 - 1 carries
    flags = cols.prev_flags.clone()
    flags[7] = 0b111  # already set
    plan = tuple(np.asarray(a, dt) for a, dt in zip(SLOT_PLANS[case], (np.int32, np.int32,
                                                                      np.uint64)))
    args = (balance, flags, cols.cur_tgt_att, *plan)
    _ext.reset_launches()
    got = sp.slot_apply(*args)
    assert _ext.launches["slot_apply"] == 1
    assert _ext.launches["slot_apply_scatter"] == int(len(plan[0]) + len(plan[1]) > 0)
    for g, w in zip(got, sp.slot_apply_ref(*args)):
        assert g.dtype == w.dtype and torch.equal(g, w)
    assert torch.equal(balance, args[0])  # the committed column is not touched


def test_slot_apply_rejects_a_bad_plan(cuda):
    from eth_consensus_specs_tpu_torch.ops import slot_pipeline as sp

    cols, _ = example_altair_inputs(64, device=cuda)
    base = (cols.balance, cols.prev_flags, cols.cur_tgt_att)
    none = np.zeros(0, np.int32)
    with pytest.raises(ValueError):
        sp.slot_apply(*base, np.asarray([64]), none, np.zeros(0, np.uint64))
    with pytest.raises(ValueError):
        sp.slot_apply(*base, none, np.asarray([-1]), np.ones(1, np.uint64))
    with pytest.raises(ValueError):
        sp.slot_apply(cols.balance.cpu().to(cuda).to(torch.int32), *base[1:], none, none,
                      np.zeros(0, np.uint64))


def test_slot_world_on_card_equals_the_cpu_world(cuda):
    from eth_consensus_specs_tpu_torch.inputs import slot_schedule
    from eth_consensus_specs_tpu_torch.serve.slot import SlotWorld

    reqs = slot_schedule(64, slots=2, committees=3, committee=(4, 8), subnets=2, sync_size=4,
                         blobs=1, slots_per_epoch=2, spoil=(("att", 0, 1),), seed=5)
    card, host = SlotWorld(64, device=cuda), SlotWorld(64, device="cpu")
    _ext.reset_launches()
    for req in reqs:
        assert card.execute(req)[0] == host.execute(req)[0]
    assert _ext.launches["slot_apply"] == 2 and _ext.launches["slot_apply_scatter"] == 2
    assert _ext.launches["altair_epoch"] >= 1 and _ext.launches["g2_sum"] == 2


# --- K19: the block slot; K20: the exact final exponentiation ----------------------


@pytest.mark.parametrize("case", ["cell", "wrap", "full_payload", "partial_payload", "repeat_rows",
                                  "pay_runs", "sync_proposer", "sync_repeats", "dup_deposits",
                                  "high_balances", "all_pad", "first_setter"])
def test_block_slot_kernel(cuda, case):
    from eth_consensus_specs_tpu_torch.config import block_epoch_params
    from eth_consensus_specs_tpu_torch.inputs import block_slot_corners
    from eth_consensus_specs_tpu_torch.ops import block_epoch as be

    params = block_epoch_params("deneb", "mainnet")
    st, slot, static = block_slot_corners(params, 4096, atts_per_slot=16, device=cuda)[case]
    scratch = be.SlotScratch(4096, cuda)
    outs = []
    for fn in (functools.partial(be.block_slot, scratch=scratch), be.block_slot_ref):
        state = [t.clone() for t in (st.balance, st.cur_part, st.prev_part)] + [be._scalars(st)]
        _ext.reset_launches()
        outs.append(fn(params, 4096, *state, slot, static))
        assert _ext.launches["block_slot"] == (fn is not be.block_slot_ref)
    for got, want in zip(*outs):
        assert torch.equal(got, want)
    assert scratch.blocks > 1  # the sweep's block and the lanes' blocks
    words = scratch.words  # left clean for the next slot
    assert bool((words[:2 * 4096] == -1).all()) and not bool(words[2 * 4096:].any())


def test_block_epoch_chain_on_card_equals_the_cpu_chain_and_the_oracle(cuda):
    from eth_consensus_specs_tpu_torch import convert
    from eth_consensus_specs_tpu_torch.config import block_epoch_params
    from eth_consensus_specs_tpu_torch.ops import block_epoch as be
    from eth_consensus_specs_tpu_torch.ops import block_epoch_host as beh
    from eth_consensus_specs_tpu_torch.ops.state_root import synthetic_static

    params, n = block_epoch_params("deneb", "mainnet"), 1 << 12
    cols, st0, static = be.synthetic_block_columns(params, n, seed=5, atts_per_slot=16, device=cuda)
    arrays, meta = synthetic_static(n, device=cuda)
    ecols, just = example_altair_inputs(n, device=cuda)
    _ext.reset_launches()
    ctx = be.make_root_ctx("deneb", arrays, meta, static, ecols.inactivity_scores, just)
    # the epoch's registry root and small top chunks: K3, one K2 list launch, no K1
    assert dict(_ext.launches) == {"validator_leaves": 1, "merkle_lists": 1}
    _ext.reset_launches()
    st, acc = be.block_epoch_chain(params, n, st0, cols, static, root_ctx=ctx)
    assert _ext.launches["block_slot"] == 32
    assert _ext.launches["merkle_lists"] == 32 and _ext.launches["merkle"] == 32  # 2 roots a slot
    assert _ext.launches["sha256"] == 0
    root_fn = beh.slot_root_fn_np("deneb", arrays, meta, static, ecols.inactivity_scores, just)
    bal, cur, prev, wdi, wdv, want_acc = beh.replay_block_epoch_np(
        params, n, st0, cols, static.eff_balance, static.withdrawable_epoch,
        static.has_eth1_cred, 10, root_fn=root_fn)
    assert np.array_equal(convert.to_numpy(st.balance), bal)
    assert np.array_equal(convert.to_numpy(st.cur_part), cur)
    assert np.array_equal(convert.to_numpy(st.prev_part), prev)
    assert (int(st.next_wd_index), int(st.next_wd_validator)) == (wdi, wdv)
    assert np.array_equal(convert.to_numpy(acc), want_acc)
    # the first two slots against the CPU path, root for root
    two = be.BlockColumns(*(t[:2] for t in cols))
    got = be.block_epoch_chain(params, n, st0, two, static, root_ctx=ctx)
    cpu_ctx = be.SlotRootCtx(*(t.cpu() if isinstance(t, torch.Tensor) else t for t in ctx))
    want = be.block_epoch_chain(params, n, st0, two, static, root_ctx=cpu_ctx, device="cpu")
    assert torch.equal(got[1].cpu(), want[1])
    for g, w in zip(got[0], want[0]):
        assert torch.equal(g.cpu(), w)


def test_final_exp_gt_kernel(cuda):
    from eth_consensus_specs_tpu_torch.crypto import pairing as oracle
    from eth_consensus_specs_tpu_torch.crypto.curve import g1_generator, g2_generator
    from eth_consensus_specs_tpu_torch.ops import pairing_device as pd

    g, q = g1_generator(), g2_generator()
    for pairs in ([(g.mul(6), q.mul(5)), (-g.mul(30), q)], [(g.mul(6), q.mul(5))]):
        f = pd.miller_product(*[torch.from_numpy(a).to(cuda) for a in pd.pack_pairs(pairs)])
        _ext.reset_launches()
        got = pd.final_exponentiation(f)
        assert _ext.launches["final_exp_gt"] == 1
        assert torch.equal(got, pd.final_exponentiation_ref(f))
        assert pd.fq12_from_words(got) == oracle.final_exponentiation(pd.fq12_from_words(f))
        assert bool(pd.final_exp_is_one(f)) == pd.fq12_from_words(got).is_one()
    assert pd.pairing_device(g.mul(5), q.mul(9), device=cuda) == oracle.pairing(g.mul(5), q.mul(9))


def test_final_exp_gt_kernel_on_miller_values(cuda):
    """K20 on the Miller values of 4 pairs one by one and of their product,
    word for word against its plain twin and the host oracle, repeated."""
    from eth_consensus_specs_tpu_torch.crypto import pairing as oracle
    from eth_consensus_specs_tpu_torch.crypto.curve import g1_generator, g2_generator
    from eth_consensus_specs_tpu_torch.ops import pairing_device as pd

    g, q = g1_generator(), g2_generator()
    pairs = [(g.mul(a), q.mul(b)) for a, b in ((3, 5), (7, 2), (11, 13), (1, 17))]
    for chosen in [[p] for p in pairs] + [pairs]:
        f = pd.miller_product(*[torch.from_numpy(a).to(cuda) for a in pd.pack_pairs(chosen)])
        got = pd.final_exponentiation(f)
        assert torch.equal(got, pd.final_exponentiation_ref(f))
        assert pd.fq12_from_words(got) == oracle.final_exponentiation(pd.fq12_from_words(f))
        assert all(torch.equal(pd.final_exponentiation(f), got) for _ in range(5))
