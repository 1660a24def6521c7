"""K2's list-root entry (eth_consensus_specs_tpu_torch/ops/merkle.py ``list_roots``) on
the CPU: its plain twin against the JAX package's list roots, bit for bit, and a
host model of the kernel's schedule (``csrc/merkle.cu``) against hashlib."""

import hashlib
import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eth_consensus_specs_tpu.forks import get_spec
from eth_consensus_specs_tpu.ops import state_root as jsr
from eth_consensus_specs_tpu.ops.merkle import many_tree_root_words, tree_root_words
from eth_consensus_specs_tpu_torch import convert
from eth_consensus_specs_tpu_torch.convert import tensor_from_numpy, to_numpy
from eth_consensus_specs_tpu_torch.ops import block_epoch_host as beh
from eth_consensus_specs_tpu_torch.ops import merkle
from eth_consensus_specs_tpu_torch.ops import state_root as tsr
from eth_consensus_specs_tpu_torch.ops.merkle import ListTree

ZH = jnp.asarray(jsr.zerohash_words(41))
_u64_root = jax.jit(jsr.u64_list_root, static_argnums=(1, 2))
_u8_root = jax.jit(jsr.u8_list_root, static_argnums=(1, 2))
_registry_root = jax.jit(jsr.validator_registry_root, static_argnums=(1,))
_folded_root = jax.jit(lambda r: jsr.mix_length(jsr.fold_to_limit(r, 4, 10, ZH), 9))


def _t(a):
    return tensor_from_numpy(a, "cpu")


@pytest.fixture(scope="module")
def registry():
    """The JAX package's and the port's static tree of 7 validators, and
    their effective balances."""
    arrays, meta = jsr.synthetic_static(get_spec("deneb", "mainnet"), 7, seed=3)
    eff = np.arange(7, dtype=np.uint64) * 1_000_000_000 + 31_000_000_000
    return arrays, convert.static_from_numpy(arrays, meta, "cpu")[0], eff


def test_ragged_batch_matches_jax(registry):
    """One table of eight lists of every kind: u64 and u8 lists of one item
    and of counts that leave a chunk part full, the validator registry,
    chunk words reduced to their own depth (limit equal to depth, no mix)
    and a root folded from a level above the leaves."""
    rng = np.random.default_rng(14)
    u64 = rng.integers(0, 2**64, 1000, dtype=np.uint64)
    u64[0] = np.iinfo(np.uint64).max
    u8 = rng.integers(0, 256, 100, dtype=np.uint8)
    words = rng.integers(0, 2**32, (8, 8), dtype=np.uint64).astype(np.uint32)
    j_arrays, p_arrays, eff = registry
    rows = tsr.validator_leaves_ref(_t(eff), p_arrays.slashed_chunk, p_arrays.val_node_a,
                                    p_arrays.val_node_f, 3)
    lists = [ListTree(_t(u64), 5, 38, 5), ListTree(_t(u64), 1, 38, 1),
             ListTree(_t(u64), 1000, 38, 1000), ListTree(_t(u8), 33, 35, 33),
             ListTree(_t(u8), 1, 35, 1), ListTree(rows, 7, 40, 7),
             ListTree(_t(words), 8, 3), ListTree(_t(words[2:3]), 1, 10, mix=9, depth=0, base=4)]
    got = to_numpy(merkle.list_roots(lists))
    want = [_u64_root(jnp.asarray(u64[:5]), 5, 38, ZH), _u64_root(jnp.asarray(u64[:1]), 1, 38, ZH),
            _u64_root(jnp.asarray(u64), 1000, 38, ZH), _u8_root(jnp.asarray(u8[:33]), 33, 35, ZH),
            _u8_root(jnp.asarray(u8[:1]), 1, 35, ZH),
            _registry_root(j_arrays, 7, jnp.asarray(eff)),
            jax.jit(tree_root_words, static_argnums=(1,))(jnp.asarray(words), 3),
            _folded_root(jnp.asarray(words[2]))]
    assert np.array_equal(got, np.stack([np.asarray(w) for w in want]))
    # the same roots written into rows of a larger buffer, and by the plain path
    rows = list(range(9, 1, -1))
    out = merkle.list_roots_ref(lists, torch.zeros((10, 8), dtype=torch.int32), rows)
    assert np.array_equal(to_numpy(out[rows]), got) and not out[:2].any()


def test_many_tree_roots_match_jax():
    leaves = np.random.default_rng(5).integers(0, 2**32, (3, 16, 8), dtype=np.uint64)
    leaves = leaves.astype(np.uint32)
    want = np.asarray(many_tree_root_words(jnp.asarray(leaves), 4))
    assert np.array_equal(to_numpy(merkle.many_tree_root(_t(leaves), 4)), want)


def test_slot_root_matches_hashlib():
    """The port's per-slot root at a registry that fills no tree (100
    validators: 25 balance chunks, 4 participation chunks, the last part
    full) against the numpy replay's hashlib root."""
    from eth_consensus_specs_tpu_torch.config import block_epoch_params
    from eth_consensus_specs_tpu_torch.inputs import example_altair_inputs
    from eth_consensus_specs_tpu_torch.ops import block_epoch as be

    n = 100
    params = block_epoch_params("deneb", "mainnet")
    _, st, static = be.synthetic_block_columns(params, n, seed=2, atts_per_slot=2, device="cpu")
    arrays, meta = tsr.synthetic_static(n, device="cpu")
    cols, just = example_altair_inputs(n, device="cpu")
    cur = torch.arange(n, dtype=torch.uint8) % 7
    want = beh.slot_root_fn_np("deneb", arrays, meta, static, cols.inactivity_scores, just)(
        to_numpy(st.balance), to_numpy(cur), to_numpy(st.prev_part), 12345)
    for h in (tsr.KERNELS, tsr.PLAIN):
        ctx = be.make_root_ctx("deneb", arrays, meta, static, cols.inactivity_scores, just, h)
        got = be.slot_root(ctx, st.balance, cur, st.prev_part, 12345, h)
        assert np.array_equal(to_numpy(got), want)


def test_bad_lists_raise():
    vals = torch.zeros(10, dtype=torch.int64)
    for bad in (ListTree(vals, 11, 38), ListTree(vals, 10, 1), ListTree(vals, 10, 64),
                ListTree(vals, 10, 38, depth=1), ListTree(vals.float(), 10, 38),
                ListTree(vals, 4, 38, base=2), ListTree(vals, 4, 38, mix=-1)):
        with pytest.raises(ValueError):
            merkle.list_roots([bad])
    with pytest.raises(ValueError):
        merkle.launch_table([(0, 8, 4, 0, 0, 0, None, 1, 0, 0, 0)] * (merkle.MAX_TREES + 1))


# ------------------------------------------------- the kernel's schedule --


def _h(a: bytes, b: bytes) -> bytes:
    return hashlib.sha256(a + b).digest()


def _chunks(t: ListTree) -> list:
    """A list's live chunks as bytes, packed as the kernel packs them."""
    words = to_numpy(merkle.leaf_level(t))[:merkle.chunk_count(t)]
    return [w.astype(">u4").tobytes() for w in words]


def schedule_roots(trees, group_log: int, seed: int, hashed=merkle.live_nodes) -> list:
    """K2's schedule on the host, step for step: ``launch_table``'s grid,
    offsets and strides; each leaf block loads its group, hashing only the
    pairs whose parent holds a live chunk (``hashed``, the count of such
    nodes of a level) and taking zerohashes for the rest; the blocks finish
    in a shuffled order, each writes its node to the scratch and adds one to
    its group's counter, and the block that completes a group carries it up
    the next levels, resetting the counter; the finisher of a root folds and
    mixes it. Checks that every counter is back at zero."""
    zh, live = merkle.zerohashes(), merkle.live_nodes
    table, blocks, nodes, counters = merkle.launch_table(
        [(0, merkle.ITEM_BYTES[t.src.dtype], t.n, merkle.tree_depth(t), t.base, t.limit, t.mix,
          1, 0, 0, 0) for t in trees], group_log)
    scratch, cnt = [None] * nodes, [0] * counters
    chunks = [_chunks(t) for t in trees]
    roots = [None] * len(trees)

    def reduce(group: list, lv: int, level: int, blk: int, c: int, base: int) -> list:
        for l in range(lv):
            keep = hashed(c, level + l + 1) - (blk << (lv - l - 1))
            group = [_h(group[2 * t], group[2 * t + 1]) if t < keep else zh[base + level + l + 1]
                     for t in range(len(group) // 2)]
        return group

    order = list(range(blocks))
    random.Random(seed).shuffle(order)
    for b in order:
        k = max(i for i in range(len(trees)) if table[i]["block0"] <= b)
        e, c = table[k], len(chunks[k])
        depth, base = int(e["depth"]), int(e["base"])
        blk = b - int(e["block0"])
        lv = min(group_log, depth)
        group = [chunks[k][j] if j < c else zh[base] for j in range(blk << lv, (blk + 1) << lv)]
        group = reduce(group, lv, 0, blk, c, base)
        level, nodes_off, cnt_off = lv, int(e["nodes0"]), int(e["cnt0"])
        finished = True
        while level < depth:
            n_in = live(c, level)
            lv = min(group_log, depth - level)
            g, first = blk >> lv, (blk >> lv) << lv
            children = min(n_in - first, 1 << lv)
            scratch[nodes_off + blk] = group[0]
            cnt[cnt_off + g] += 1
            if cnt[cnt_off + g] != children:
                finished = False
                break
            cnt[cnt_off + g] = 0
            group = [scratch[nodes_off + first + i] if i < children else zh[base + level]
                     for i in range(1 << lv)]
            group = reduce(group, lv, level, g, c, base)
            nodes_off += n_in
            cnt_off += live(c, level + lv)
            blk, level = g, level + lv
        if finished:
            r = group[0]
            for level in range(base + depth, int(e["limit"])):
                r = _h(r, zh[level])
            if e["mix"]:
                r = _h(r, int(e["mix_len"]).to_bytes(8, "little") + bytes(24))
            roots[k] = r
    assert not any(cnt), "a counter was left set"
    return roots


def _oracle(t: ListTree) -> bytes:
    """hashlib: the padded tree at its depth, the fold, the mix."""
    zh = merkle.zerohashes()
    level = _chunks(t) + [zh[t.base]] * ((1 << merkle.tree_depth(t)) - merkle.chunk_count(t))
    for d in range(merkle.tree_depth(t)):
        level = [_h(level[i], level[i + 1]) for i in range(0, len(level), 2)]
    r = level[0]
    for d in range(t.base + merkle.tree_depth(t), t.limit):
        r = _h(r, zh[d])
    return r if t.mix is None else _h(r, t.mix.to_bytes(8, "little") + bytes(24))


def _schedule_lists():
    rng = np.random.default_rng(7)
    u64 = _t(rng.integers(0, 2**64, 200, dtype=np.uint64))
    u8 = _t(rng.integers(0, 256, 700, dtype=np.uint8))
    words = _t(rng.integers(0, 2**32, (64, 8), dtype=np.uint64).astype(np.uint32))
    return [ListTree(u64, 200, 12, 200), ListTree(u8, 700, 9, 700), ListTree(u8, 1, 3, 1),
            ListTree(words, 37, 7, 37), ListTree(words, 64, 6), ListTree(words, 5, 8, 5),
            ListTree(words[:1], 1, 9, 3, depth=0, base=6), ListTree(u64, 0, 2, 0)]


@pytest.mark.parametrize("group_log", [1, 2, 3])
@pytest.mark.parametrize("seed", [0, 1])
def test_schedule_gives_the_plain_roots(group_log, seed):
    """Blocks finishing in any order under the counter rule, zero subtrees
    skipped, give the plain roots and hashlib's; groups of 2, 4 and 8 nodes
    make every tree climb several rounds."""
    lists = _schedule_lists()
    got = schedule_roots(lists, group_log, seed)
    plain = to_numpy(merkle.list_roots_ref(lists))
    assert got == [_oracle(t) for t in lists]
    assert got == [w.astype(">u4").tobytes() for w in plain]


def test_schedule_that_skips_a_live_subtree_fails():
    """The corner that tells the live count apart: a model that counts the
    live nodes of a level by floor (so a node holding the list's last,
    partial chunks is taken for a zero subtree) agrees on full trees and
    fails on a ragged one."""
    floor = lambda c, level: max(c >> level, 1)  # noqa: E731
    words = _t(np.arange(64 * 8, dtype=np.uint32).reshape(64, 8))
    full, ragged = ListTree(words, 64, 6), ListTree(words, 37, 7, 37)
    assert schedule_roots([full], 2, 0, hashed=floor) == [_oracle(full)]
    assert schedule_roots([ragged], 2, 0, hashed=floor) != [_oracle(ragged)]
    assert schedule_roots([ragged], 2, 0) == [_oracle(ragged)]


def test_table_is_the_kernels_struct():
    assert merkle.LIST_TREE_DTYPE.itemsize == 128
    table, blocks, nodes, counters = merkle.launch_table(
        [(0, 8, 1 << 20, 18, 0, 38, 1 << 20, 1, 0, 0, 0), (0, 0, 1 << 20, 20, 0, 40, None, 1, 0,
                                                           0, 0)])
    assert blocks == 512 + 2048 and list(table["block0"]) == [0, 512]
    assert (nodes, counters) == (512 + 2052, 1 + 5) and list(table["cnt0"]) == [0, 1]
