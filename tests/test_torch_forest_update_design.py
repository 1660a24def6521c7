"""The forest update (eth_consensus_specs_tpu_torch/ops/merkle_inc.py ``forest_update``,
``csrc/forest_update.cu``) on the CPU: a host model of the kernel's schedule held
against its plain twin ``forest_update_ref``, and the plain twin and the incremental
state root against the JAX package, bit for bit."""

import hashlib
import random
from functools import lru_cache

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import __graft_entry__ as graft
from eth_consensus_specs_tpu.forks import get_spec
from eth_consensus_specs_tpu.ops import state_root as jsr
from eth_consensus_specs_tpu_torch import convert
from eth_consensus_specs_tpu_torch.ops import merkle_inc as tmi
from eth_consensus_specs_tpu_torch.ops import state_root as tsr
from eth_consensus_specs_tpu_torch.parallel import resident as tres
from eth_consensus_specs_tpu_torch.ops.merkle import live_nodes

GWEI = 10**9


# ------------------------------------------------- the kernel's schedule --


def _h(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    d = hashlib.sha256(a.astype(">u4").tobytes() + b.astype(">u4").tobytes()).digest()
    return np.frombuffer(d, ">u4").astype(np.uint32)


def _words(t: torch.Tensor) -> np.ndarray:
    return t.numpy().view(np.uint32)


def _leaf_sources(t: tmi.ForestTree):
    """The dirty bit and the new row of each live leaf of one tree, as the
    kernel's leaf pass finds them (plain torch for the rows; None where the
    rows are in place)."""
    live = tmi.live_leaves(t)
    if t.kind == "u64":
        diff = torch.cat([t.old != t.new, torch.zeros(live * t.per - t.old.shape[0], dtype=torch.bool)])
        return diff.reshape(live, t.per).any(1).tolist(), _words(tmi._u64_chunks(t.new, t.per, live))
    if t.kind == "registry":
        return (t.old != t.new).tolist(), _words(tmi.validator_chain_ref(t.new, *t.static))
    if t.kind == "mask":
        return t.mask.tolist(), None if t.rows is None else _words(t.rows[:live].contiguous())
    return [True] * live, None


def schedule_forest(trees, group_log: int, seed: int, skip_clean: bool = False,
                    stale: bool = False):
    """The forest kernel's schedule on the host, step for step, on copies of
    the trees' buffers: ``forest_table``'s grid, offsets and strides; each
    leaf block finds its dirty leaves, writes their rows and hashes only the
    parents with a dirty child (a clean child from its stored row); the
    blocks finish in a shuffled order, each stores its top node's flag and
    adds one to its group's counter (the flag in the high half), and the
    block that completes a group loads its dirty children's rows and climbs,
    resetting the counter; the root's finisher publishes the tree's count.
    ``skip_clean``: a clean group does not arrive; ``stale``: the climb loads
    its dirty children from the rows as they were before the launch. Returns
    the buffers, the counts and the counters left set."""
    table, blocks, _, _ = tmi.forest_table(trees, group_log)
    bufs = [_words(tmi._trees(t.nodes)).copy() for t in trees]
    before = [b.copy() for b in bufs]
    sources = [_leaf_sources(t) for t in trees]
    cnt, flags, acc, counts = {}, {}, {}, {}

    order = list(range(blocks))
    random.Random(seed).shuffle(order)
    for b in order:
        k = max(i for i in range(len(trees)) if table[i]["block0"] <= b)
        e = table[k]
        depth, live = int(e["depth"]), int(e["live"])
        tree_i, blk = divmod(b - int(e["block0"]), int(e["blocks"]))
        buf, cap2 = bufs[k][tree_i], 2 << depth
        dirty_src, rows = sources[k]

        def row(level, i):
            return cap2 - (cap2 >> level) + i

        def hash_dirty(sm, dirty, level, lv, first):
            for l in range(lv):
                nxt_sm, nxt_dirty = {}, []
                for t in range(1 << (lv - l - 1)):
                    dl, dr = dirty[2 * t], dirty[2 * t + 1]
                    if dl or dr:
                        child = row(level + l, (first >> l) + 2 * t)
                        h = _h(sm[2 * t] if dl else buf[child], sm[2 * t + 1] if dr else buf[child + 1])
                        nxt_sm[t] = buf[row(level + l + 1, (first >> (l + 1)) + t)] = h
                    nxt_dirty.append(dl or dr)
                sm, dirty = nxt_sm, nxt_dirty
            return sm, dirty

        lv = min(group_log, depth)
        sm, dirty = {}, []
        for j in range(1 << lv):
            leaf = (blk << lv) + j
            d = leaf < live and bool(dirty_src[leaf])
            if d:
                sm[j] = buf[row(0, leaf)] = buf[row(0, leaf)] if rows is None else rows[leaf]
            dirty.append(d)
        acc[k, tree_i] = acc.get((k, tree_i), 0) + sum(dirty)
        level, flag_off, cnt_off, finished = 0, 0, 0, True
        while True:
            sm, dirty = hash_dirty(sm, dirty, level, lv, blk << lv)
            level += lv
            if level >= depth:
                break
            n_in = live_nodes(live, level)
            lv = min(group_log, depth - level)
            group, first = blk >> lv, (blk >> lv) << lv
            children = min(n_in - first, 1 << lv)
            d = dirty[0]
            if skip_clean and not d:
                finished = False
                break
            flags[k, tree_i, flag_off + blk] = d
            key = (k, tree_i, cnt_off + group)
            cnt[key] = cnt.get(key, 0) + 1 + (d << 16)
            if cnt[key] & 0xFFFF != children:
                finished = False
                break
            some = cnt[key] >> 16 > 0
            cnt[key] = 0
            src = before[k][tree_i] if stale else buf
            sm, dirty = {}, []
            for q in range(1 << lv):
                dq = some and q < children and flags[k, tree_i, flag_off + first + q]
                if dq:
                    sm[q] = src[row(level, first + q)]
                dirty.append(bool(dq))
            flag_off += n_in
            cnt_off += live_nodes(live, level + lv)
            blk = group
        if finished:
            counts[k, tree_i] = acc.pop((k, tree_i))
    left = {key: v for key, v in cnt.items() if v}
    return bufs, [counts.get((k, 0)) for k in range(len(trees))], left


def _rand(rng, *shape):
    return torch.from_numpy(rng.integers(0, 2**32, shape, dtype=np.uint64).astype(np.uint32)
                            .view(np.int32))


def _built(leaves: torch.Tensor) -> torch.Tensor:
    """Every level of a tree over ``leaves`` by hashlib (the setup; the
    plain SHA is the twin under test)."""
    levels = [_words(leaves)]
    while len(levels[-1]) > 1:
        lv = levels[-1]
        levels.append(np.stack([_h(lv[i], lv[i + 1]) for i in range(0, len(lv), 2)]))
    return torch.from_numpy(np.concatenate(levels).view(np.int32))


DEPTH = 6
CASES = {
    "empty": [],
    "one_leaf": [5],
    "two_siblings": [4, 5],
    "left_only": [8],
    "right_only": [13],
    "every_4th": list(range(0, 1 << DEPTH, 4)),
    "every_leaf": list(range(1 << DEPTH)),
    "clean_group_between": [1, 9],  # groups of 4: group 1 (leaves 4-7) clean
}


def _mask_tree(case: str, seed: int = 1):
    """A depth-6 tree, new rows for every leaf and a mask of ``case``'s
    leaves; the rows outside the mask are the stored ones."""
    rng = np.random.default_rng(seed)
    leaves = _rand(rng, 1 << DEPTH, 8)
    new = leaves.clone()
    mask = torch.zeros(1 << DEPTH, dtype=torch.bool)
    mask[CASES[case]] = True
    new[mask] = _rand(rng, int(mask.sum()), 8)
    return tmi.ForestTree(_built(leaves), "mask", mask=mask, rows=new, cap=8, dense=5)


def _clone(t: tmi.ForestTree) -> tmi.ForestTree:
    return t._replace(nodes=t.nodes.clone())


def _mixed_table(case: str):
    """The three leaf-source kinds of an epoch in one table (a registry of 50
    validators, 100 u64 values in 25 chunks, a mask) plus a batch of two
    like trees with every leaf dirty."""
    rng = np.random.default_rng(2)
    n = 50
    eff = torch.from_numpy(rng.integers(16, 32, n).astype(np.int64) * GWEI)
    static = tuple(_rand(rng, n, 8) for _ in range(3))
    leaves = torch.cat([tmi.validator_chain_ref(eff, *static), torch.zeros((14, 8), dtype=torch.int32)])
    vals = torch.from_numpy(rng.integers(0, 2**63, 100, dtype=np.int64))
    chunks = tmi._u64_chunks(vals, 4, 32)
    dirty = [i for i in CASES[case] if i < n]
    new_eff, new_vals = eff.clone(), vals.clone()
    new_eff[dirty] -= GWEI
    new_vals[[i for i in CASES[case] if i < 100]] += 7
    return [tmi.ForestTree(_built(leaves), "registry", eff, new_eff, static=static, cap=4,
                           dense=3),
            tmi.ForestTree(_built(chunks), "u64", vals, new_vals, cap=4, dense=3),
            _mask_tree(case, seed=3),
            tmi.ForestTree(torch.stack([_built(_rand(rng, 8, 8)) for _ in range(2)])
                           .index_fill_(1, torch.arange(8, 15), 0), "all")]


def _assert_model_is_ref(trees, group_log, seed):
    want = [_clone(t) for t in trees]
    want_counts = tmi.forest_update_ref(want)
    bufs, counts, left = schedule_forest(trees, group_log, seed)
    assert not left, "a counter was left set"
    for t, w, got, c, wc in zip(trees, want, bufs, counts, want_counts):
        assert np.array_equal(got, _words(tmi._trees(w.nodes))), t.kind
        if wc is not None:
            assert c == int(wc), t.kind


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("group_log", [2, 3])
def test_schedule_gives_the_plain_update(case, group_log):
    """Blocks finishing in any order under the counter rule, hashing only
    the dirty parents from the stored rows of their clean children, give the
    plain twin's buffer and count; groups of 4 and 8 leaves make a depth-6
    tree climb two and three rounds."""
    _assert_model_is_ref([_mask_tree(case)], group_log, seed=group_log)


@pytest.mark.parametrize("case", ["empty", "one_leaf", "clean_group_between", "every_leaf"])
def test_schedule_updates_every_kind_in_one_table(case):
    """The registry diff (K3's chain in the leaf pass), a chunk diff, a mask
    and a batch of two all-dirty trees in one table, at the kernel's own
    groups of 512 and at groups of 4."""
    for group_log, seed in ((tmi.GROUP_LOG, 0), (2, 1)):
        _assert_model_is_ref(_mixed_table(case), group_log, seed)


def test_schedule_faults_fail_their_corner():
    """The corners that tell the rule apart: a model whose clean group does
    not arrive never completes the parent of a clean and a dirty group, and
    one that loads a dirty child from its row as it was before the launch
    hashes a stale parent; both agree where their fault cannot show."""
    want = _clone(_mask_tree("clean_group_between"))
    tmi.forest_update_ref([want])
    bufs, counts, _ = schedule_forest([_mask_tree("clean_group_between")], 2, 0, skip_clean=True)
    assert not np.array_equal(bufs[0], _words(tmi._trees(want.nodes))) and counts == [None]
    bufs, _, _ = schedule_forest([_mask_tree("clean_group_between")], 2, 0, stale=True)
    assert not np.array_equal(bufs[0], _words(tmi._trees(want.nodes)))
    full = _clone(_mask_tree("every_leaf"))
    tmi.forest_update_ref([full])
    bufs, counts, left = schedule_forest([_mask_tree("every_leaf")], 2, 0, skip_clean=True)
    assert np.array_equal(bufs[0], _words(tmi._trees(full.nodes))) and not left
    bufs, _, _ = schedule_forest([_mask_tree("empty")], 2, 0, stale=True)
    assert np.array_equal(bufs[0], _words(tmi._trees(_mask_tree("empty").nodes)))


def test_table_is_the_kernels_struct():
    trees = _mixed_table("one_leaf")
    table, blocks, counters, flags = tmi.forest_table(trees)
    assert tmi.FOREST_TREE_DTYPE.itemsize == 176
    assert list(table["kind"]) == [1, 0, 2, 3] and list(table["trees"]) == [1, 1, 1, 2]
    assert list(table["live"]) == [50, 25, 64, 8] and list(table["block0"]) == [0, 1, 2, 3]
    assert blocks == 5 and list(table["cnt_stride"]) == [1, 1, 1, 1] and flags == 0
    with pytest.raises(ValueError):
        tmi.forest_table(trees * 3)
    with pytest.raises(ValueError):
        tmi.forest_update_ref([trees[0]._replace(static=None)])


# ------------------------------------------------------ against the JAX package --


@lru_cache(maxsize=None)
def _jax_inc_root(meta, plan):
    return jax.jit(lambda a, f, ob, oe, os, b, e, s, j: jsr.post_epoch_state_root_inc(
        a, meta, plan, f, ob, oe, os, b, e, s, j))


@lru_cache(maxsize=None)
def _world(n: int):
    """The JAX package's columns and static tree, and the forest the port
    builds from them (equal to the JAX package's: test_torch_state_forest),
    handed to both packages."""
    spec = get_spec("deneb", "mainnet")
    cols, just = graft._example_altair_inputs(n)
    static = jsr.synthetic_static(spec, n, seed=5)
    pc, _ = convert.columns_from_numpy(cols, just, "cpu")
    built, _ = tres.build_state_forest_device(convert.static_from_numpy(*static, "cpu"), pc,
                                              device="cpu")
    forest = jsr.StateForest(*(None if a is None else jnp.asarray(a)
                               for a in convert.to_numpy(built)))
    return cols, just, static, forest, jsr.forest_plan(static[1])


def _next(cols, n: int, case: str):
    """Post-epoch columns: none changed; two crossings and a few balances and
    scores ("few", the sparse branch); or a third of the registry crossing
    and every balance and score moving ("many", the dense branch)."""
    bal = np.asarray(cols.balance).copy()
    eff = np.asarray(cols.effective_balance).copy()
    scores = np.asarray(cols.inactivity_scores).copy()
    if case == "few":
        eff[[1, n // 2]] -= np.uint64(GWEI)
        bal[[0, 7, n - 1]] += np.uint64(3)
        scores[n // 3] += np.uint64(1)
    elif case == "many":
        eff[::3] -= np.uint64(GWEI)
        bal += np.random.default_rng(n).integers(1, 5000, n).astype(np.uint64)
        scores += np.uint64(2)
    return bal, eff, scores


def _chunk_dirty(old, new, n: int, depth: int) -> int:
    a, b = (np.asarray(jsr._u64_chunk_leaves(jnp.asarray(x), n, depth)) for x in (old, new))
    return int((a != b).any(-1).sum())


@pytest.mark.parametrize("n", [64, 1000])
@pytest.mark.parametrize("case", ["none", "few", "many"])
def test_forest_update_and_inc_root_match_jax(n, case):
    """``forest_update_ref`` over the epoch's three trees and
    ``post_epoch_state_root_inc`` against the JAX package's incremental root
    on the same forest and columns: every node buffer, the root, the three
    dirty counts; and the kernel's schedule at its groups of 512 gives the
    same buffers and counts."""
    cols, just, static, forest, plan = _world(n)
    bal, eff, scores = _next(cols, n, case)
    want_forest, want_root = _jax_inc_root(static[1], plan)(
        static[0], forest, cols.balance, cols.effective_balance, cols.inactivity_scores, bal, eff,
        scores, just)
    want_dirty = [int((eff != np.asarray(cols.effective_balance)).sum()),
                  _chunk_dirty(cols.balance, bal, n, plan.depth_bal),
                  _chunk_dirty(cols.inactivity_scores, scores, n, plan.depth_bal)]

    pc, pj = convert.columns_from_numpy(cols, just, "cpu")
    pa, pm = convert.static_from_numpy(*static, "cpu")
    tplan = convert.plan_from_numpy(plan)
    t = lambda a: convert.tensor_from_numpy(a, "cpu")  # noqa: E731
    new = (t(bal), t(eff), t(scores))

    def trees(f):
        return [tmi.ForestTree(f.val_nodes[0], "registry", pc.effective_balance, new[1],
                               static=(pa.slashed_chunk, pa.val_node_a, pa.val_node_f),
                               cap=tplan.cap_val, dense=tplan.dense_val),
                tmi.ForestTree(f.bal_nodes[0], "u64", pc.balance, new[0], cap=tplan.cap_bal,
                               dense=tplan.dense_bal),
                tmi.ForestTree(f.inact_nodes[0], "u64", pc.inactivity_scores, new[2],
                               cap=tplan.cap_bal, dense=tplan.dense_bal)]

    names = ("val_nodes", "bal_nodes", "inact_nodes")
    plain = convert.forest_from_numpy(forest, "cpu")
    counts = tmi.forest_update_ref(trees(plain))
    assert [int(c) for c in counts] == want_dirty
    model = convert.forest_from_numpy(forest, "cpu")
    bufs, model_counts, left = schedule_forest(trees(model), tmi.GROUP_LOG, seed=n)
    assert model_counts == want_dirty and not left
    for name, buf in zip(names, bufs):
        want = np.asarray(getattr(want_forest, name))
        assert np.array_equal(convert.to_numpy(getattr(plain, name)), want), name
        assert np.array_equal(buf.view(np.int32), want.view(np.int32)), name

    got_forest, got_root = tsr.post_epoch_state_root_inc(
        pa, pm, tplan, convert.forest_from_numpy(forest, "cpu"), pc.balance,
        pc.effective_balance, pc.inactivity_scores, *new, pj)
    for name in names:
        assert np.array_equal(convert.to_numpy(getattr(got_forest, name)),
                              np.asarray(getattr(want_forest, name))), name
    assert np.array_equal(convert.to_numpy(got_root), np.asarray(want_root))
