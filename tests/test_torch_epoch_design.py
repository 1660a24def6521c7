"""Design models of two kernels of the port, run on the CPU in plain Python
ints: K4's (``csrc/altair_epoch.cu``) division by the epoch's invariant
divisors and its one-launch schedule, and K5's compaction's
(``csrc/merkle_inc.cu``) single pass with decoupled look-back. Each model
is held against the port's plain version and the JAX package."""

import math
import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eth_consensus_specs_tpu.forks import get_spec
from eth_consensus_specs_tpu.ops import merkle_inc as jmi
from eth_consensus_specs_tpu.ops.altair_epoch import AltairEpochParams, altair_epoch_accounting
from eth_consensus_specs_tpu_torch.config import epoch_params
from eth_consensus_specs_tpu_torch.convert import to_numpy
from eth_consensus_specs_tpu_torch.inputs import (
    ALTAIR_CORNERS, altair_corner_inputs, example_altair_inputs)
from eth_consensus_specs_tpu_torch.ops import altair_epoch as tae
from eth_consensus_specs_tpu_torch.ops import merkle_inc as tmi
from eth_consensus_specs_tpu_torch.ops.state_columns import justification_update

M64 = (1 << 64) - 1


# ------------------------------------------- (a) division by invariants --


def div128_64(u1: int, u0: int, v: int) -> int:
    """The kernel's ``div128_64`` (Hacker's Delight divlu) on 64-bit words:
    floor((u1 * 2^64 + u0) / v) for u1 < v, every product wrapping as
    ``uint64_t`` does."""
    b = 1 << 32
    s = 64 - v.bit_length()
    v = (v << s) & M64
    vn1, vn0 = v >> 32, v & 0xFFFFFFFF
    un32 = ((u1 << s) | (u0 >> (64 - s) if s else 0)) & M64
    un10 = (u0 << s) & M64
    un1, un0 = un10 >> 32, un10 & 0xFFFFFFFF
    q1 = un32 // vn1
    rhat = (un32 - q1 * vn1) & M64
    while q1 >= b or (q1 * vn0) & M64 > (b * rhat + un1) & M64:
        q1, rhat = q1 - 1, rhat + vn1
        if rhat >= b:
            break
    un21 = (un32 * b + un1 - q1 * v) & M64
    q0 = un21 // vn1
    rhat = (un21 - q0 * vn1) & M64
    while q0 >= b or (q0 * vn0) & M64 > (b * rhat + un0) & M64:
        q0, rhat = q0 - 1, rhat + vn1
        if rhat >= b:
            break
    return (q1 * b + q0) & M64


def divide(n: int, div: tuple[int, int, int]) -> int:
    """The kernel's ``divq``: ``n // d`` for a u64 ``n`` by ``d``'s
    reciprocal, a multiply-high, an add and two shifts."""
    magic, sh1, sh2 = div
    t = (magic * n) >> 64
    return (t + ((n - t) >> sh1)) >> sh2


def device_divisor(d: int) -> tuple[int, int, int]:
    """The kernel's ``make_divisor``: the reciprocal derived on the card
    from 64-bit steps alone."""
    clz = 64 - (d - 1).bit_length()  # __clzll(d - 1)
    l = 0 if d == 1 else 64 - clz
    r = ((1 << l if l < 64 else 0) - d) & M64
    return div128_64(r, 0, d) + 1, min(l, 1), max(l - 1, 0)


_MAINNET_TOTAL = (1 << 20) * 32 * 10**9
DIVISORS = sorted({1, 2, 3, 7, 10**9, (1 << 63) - 1, 1 << 63, M64,
                   *(1 << k for k in range(64)), *((1 << k) + 1 for k in range(1, 64)),
                   *((1 << k) - 1 for k in range(2, 65)),
                   _MAINNET_TOTAL // 10**9 * 64,  # active_increments x WEIGHT_DENOMINATOR
                   (_MAINNET_TOTAL - 12345 * 10**9) // 10**9 * 64,
                   4 * (1 << 24), 3 * (1 << 24) * 4,  # bias x the quotients (bellatrix, altair)
                   math.isqrt(_MAINNET_TOTAL), math.isqrt(_MAINNET_TOTAL - 12345 * 10**9),
                   _MAINNET_TOTAL,
                   *(random.Random(16).randrange(1, 1 << 64) for _ in range(150)),
                   *(random.Random(17).randrange(1, 1 << 40) for _ in range(50))})


def _dividends(d: int, rng: random.Random) -> list[int]:
    near = [d - 1, d, d + 1, 2 * d - 1, 2 * d, d * (M64 // d), d * (M64 // d) - 1]
    return [n for n in [0, 1, (1 << 63) - 1, 1 << 63, M64, *near,
                        *(rng.randrange(1 << 64) for _ in range(40))] if 0 <= n <= M64]


def test_device_derivation_equals_the_host_reciprocal():
    """make_divisor's 64-bit long division gives the exact reciprocal the
    host passes for the constants."""
    for d in DIVISORS:
        assert device_divisor(d) == tae.divisor_magic(d), d


def test_reciprocal_division_is_exact():
    """The multiply-high formula against // and % for every test divisor
    over the dividends that break a wrong rounding: 0, 1, around d and its
    multiples, 2^63 - 1, 2^63, 2^64 - 1 and seeded random u64."""
    rng = random.Random(18)
    for d in DIVISORS:
        div = tae.divisor_magic(d)
        assert 0 < div[0] <= M64 and div[1] in (0, 1) and div[2] <= 63
        for n in _dividends(d, rng):
            q = divide(n, div)
            assert q == n // d, (n, d)
            assert n - q * d == n % d, (n, d)


def test_reciprocal_rejects_zero_and_wide_divisors():
    for d in (0, 1 << 64):
        with pytest.raises(ValueError):
            tae.divisor_magic(d)


# --------------------------------------------- (b) K4 in one launch --

RUN = 8  # csrc/altair_epoch.cu K4_RUN


def _u(t) -> list[int]:
    return [int(x) & M64 for x in t.reshape(-1).tolist()]


def k4_model(p, cols, just, threads: int):
    """The one-launch K4 on Python ints: ``threads`` lanes (whole warps)
    sweep their warp-strided runs of RUN validators, keeping each one's
    effective balance and mask bits, and the excess one at a time; the five
    sums wrap; after the barrier the epoch's scalars are computed once and
    every validator is applied with the modelled divisions."""
    assert threads % 32 == 0
    n = cols.balance.shape[0]
    eff, bal, act, ex, wd, scores = (_u(getattr(cols, k)) for k in (
        "effective_balance", "balance", "activation_epoch", "exit_epoch", "withdrawable_epoch",
        "inactivity_scores"))
    slashed, flags, cur_tgt = (t.to(torch.int64).tolist() for t in (
        cols.slashed, cols.prev_flags, cols.cur_tgt_att))
    ceiling = (_u(cols.max_effective_balance) if cols.max_effective_balance is not None
               else [p.max_effective_balance] * n)
    cur = int(just.current_epoch) & M64
    prev = cur - 1 if cur > 0 else 0
    sums = [0] * 5

    def classify(i, add=True):
        active_cur = act[i] <= cur < ex[i]
        active_prev = act[i] <= prev < ex[i]
        part = [active_prev and (flags[i] >> k) & 1 == 1 and not slashed[i] for k in range(3)]
        if add:
            sums[0] += eff[i] if active_cur else 0
            for k in range(3):
                sums[1 + k] += eff[i] if part[k] else 0
            sums[4] += eff[i] if active_cur and cur_tgt[i] and not slashed[i] else 0
        return active_prev, bool(slashed[i]), part

    kept, seen = {}, []
    for g in range(threads):
        lane = g % 32
        for j in range(RUN):
            i = (g - lane) * RUN + lane + 32 * j
            if i < n:
                kept[i] = classify(i)
                seen.append(i)
    excess = [i for g in range(threads) for i in range(threads * RUN + g, n, threads)]
    for i in excess:
        classify(i)
    assert sorted(seen + excess) == list(range(n))  # every validator swept once
    sums = [s & M64 for s in sums]

    # the epoch's scalars, once
    incr = p.effective_balance_increment
    total = max(sums[0], incr)
    t = lambda v: torch.tensor(v - (1 << 64) if v >= 1 << 63 else v)  # noqa: E731
    jout = justification_update(just, t(max(sums[2], incr)), t(max(sums[4], incr)), t(total))
    fin_e = int(jout[5]) & M64
    in_leak = (prev - fin_e) & M64 > p.min_epochs_to_inactivity_penalty
    do_acc = cur > 0
    brpi = incr * p.base_reward_factor // math.isqrt(total)
    d_incr = tae.divisor_magic(incr)
    active_increments = divide(total, d_incr)
    reward_mul = [w * divide(max(sums[1 + k], incr), d_incr) & M64
                  for k, w in enumerate(p.weights)]
    d_reward = device_divisor(active_increments * p.weight_denominator & M64)
    d_total = device_divisor(total)
    d_wden = tae.divisor_magic(p.weight_denominator)
    d_inact = tae.divisor_magic(p.inactivity_score_bias * p.inactivity_penalty_quotient & M64)
    adj = min(int(just.slashings_sum) * p.proportional_slashing_multiplier & M64, total)
    slash_q = adj // active_increments if p.electra_slashing else adj
    hyst = incr // p.hysteresis_quotient
    down, up = hyst * p.hysteresis_downward_multiplier, hyst * p.hysteresis_upward_multiplier

    out_bal, out_eff, out_scores = [0] * n, [0] * n, [0] * n
    for i in range(n):
        active_prev, sl, part = kept[i] if i in kept else classify(i, add=False)
        e, b = eff[i], bal[i]
        eligible = active_prev or (sl and prev + 1 < wd[i])
        score = scores[i]
        if eligible:
            score = score - min(1, score) if part[1] else score + p.inactivity_score_bias & M64
        if eligible and not in_leak:
            score -= min(p.inactivity_score_recovery_rate, score)
        score_out = score if do_acc else scores[i]
        eff_incr = divide(e, d_incr)
        base_reward = eff_incr * brpi & M64
        for k, w in enumerate(p.weights):
            r_k = (divide(base_reward * reward_mul[k] & M64, d_reward)
                   if do_acc and eligible and part[k] and not in_leak else 0)
            pen_k = (divide(base_reward * w & M64, d_wden)
                     if k != p.timely_head_flag_index and do_acc and eligible and not part[k]
                     else 0)
            b = b + r_k & M64
            b -= min(b, pen_k)
        if do_acc and eligible and not part[1]:
            b -= min(b, divide(e * score_out & M64, d_inact))
        if sl and (cur + p.epochs_per_slashings_vector // 2) & M64 == wd[i]:
            pen = (eff_incr * slash_q & M64 if p.electra_slashing
                   else divide(eff_incr * slash_q & M64, d_total) * incr & M64)
            b -= min(b, pen)
        crossed = (b + down & M64) < e or (e + up & M64) < b
        out_bal[i], out_scores[i] = b, score_out
        out_eff[i] = min(divide(b, d_incr) * incr & M64, ceiling[i]) if crossed else e
    return out_bal, out_eff, out_scores, jout


@pytest.fixture(scope="module")
def jax_params():
    return {fork: AltairEpochParams.from_spec(get_spec(fork, "mainnet"))
            for fork in ("deneb", "electra")}


def _inputs(case: str, n: int, fork: str):
    electra = fork == "electra"
    if case == "example":
        return example_altair_inputs(n, electra=electra, device="cpu")
    return altair_corner_inputs(case, n, electra=electra, device="cpu")


def _assert_model(fork, cols, just, threads, jax_params=None):
    params = epoch_params(fork, "mainnet")
    bal, eff, scores, jout = k4_model(params, cols, just, threads)
    want = tae.altair_epoch_accounting_ref(params, cols, just)
    assert bal == _u(want.balance)
    assert eff == _u(want.effective_balance)
    assert scores == _u(want.inactivity_scores)
    for got, w in zip(jout, want[3:]):
        assert torch.equal(got, w)
    if jax_params is not None:
        jw = altair_epoch_accounting(jax_params[fork], *to_numpy((cols, just)))
        assert np.array_equal(np.asarray(jw.balance), np.array(bal, np.uint64))
        assert np.array_equal(np.asarray(jw.effective_balance), np.array(eff, np.uint64))
        assert np.array_equal(np.asarray(jw.inactivity_scores), np.array(scores, np.uint64))
        assert np.array_equal(np.asarray(jw.finalized_epoch), to_numpy(jout[5]))


@pytest.mark.parametrize("fork", ["deneb", "electra"])
@pytest.mark.parametrize("case", ("example",) + ALTAIR_CORNERS)
def test_one_launch_model_matches_plain_and_jax(jax_params, fork, case):
    """64 validators in one block's runs: the model equals the plain version
    and the JAX package on the example columns and every corner."""
    _assert_model(fork, *_inputs(case, 64, fork), threads=256, jax_params=jax_params)


@pytest.mark.parametrize("fork", ["deneb", "electra"])
@pytest.mark.parametrize("case", ["example", "far_future_wide"])
def test_one_launch_model_past_the_grid(fork, case):
    """1,000 validators on one warp: 256 in its runs, the rest swept and
    applied one at a time, re-read."""
    _assert_model(fork, *_inputs(case, 1000, fork), threads=32)


# ------------------------------------- (c) compaction in a single pass --

AGGREGATE, PREFIX = 1, 2


def compact_model(dirty: list[bool], cap: int, tile: int, scratch, rng: random.Random,
                  rows_of=None):
    """K5's compaction as the kernel runs it, on one status array that no
    call resets. Blocks draw tiles from the ticket counter as they arrive;
    every step runs one arrived block to its next wait, picked at random.
    A block publishes its tile's count, then looks back 32 tiles a window,
    each lane waiting until its word carries this call's generation, adds
    the counts up to the nearest inclusive prefix, publishes its own, and
    writes its leaves in order; the last tile writes the count and the
    padding. Returns (idx, count, rows written)."""
    n = len(dirty)
    tiles = -(-n // tile)
    status, gen = scratch.compact_status(1 + tiles, torch.device("cpu"))
    words = status.numpy().view(np.uint64)  # the scratch, in place: word 0 the ticket counter
    assert words[0] == 0
    idx, count, rows = [None] * cap, [None], {}

    def publish(t, state, value):
        words[1 + t] = np.uint64(gen << 34 | state << 32 | value)

    def word(t):
        w = int(words[1 + t])
        return (w >> 32) & 3 if w >> 34 == gen else 0, w & 0xFFFFFFFF

    def block():
        t = int(words[0])
        words[0] = np.uint64(0 if t == tiles - 1 else t + 1)  # the last ticket resets it
        yield
        mine = [i for i in range(t * tile, min(n, (t + 1) * tile)) if dirty[i]]
        excl = 0
        if t == 0:
            publish(t, PREFIX, len(mine))
        else:
            publish(t, AGGREGATE, len(mine))
            end = t - 1
            while True:
                seen = []
                for u in (end - lane for lane in range(32)):
                    if u < 0:
                        seen.append((PREFIX, 0))
                        continue
                    while word(u)[0] == 0:
                        yield  # spin
                    seen.append(word(u))
                stop = next((k for k, (state, _) in enumerate(seen) if state == PREFIX), None)
                excl += sum(v for _, v in seen[:32 if stop is None else stop + 1])
                if stop is not None:
                    break
                end -= 32
            publish(t, PREFIX, excl + len(mine))
        yield
        for k, i in enumerate(mine):
            if excl + k < cap:
                idx[excl + k] = i
            if rows_of is not None:
                rows[i] = rows_of(i)
        if t == tiles - 1:
            total = excl + len(mine)
            count[0] = total
            for k in range(total, cap):
                idx[k] = 0

    waiting, running = tiles, []
    while waiting or running:
        if waiting and (not running or rng.random() < 0.3):
            running.append(block())
            waiting -= 1
        b = rng.choice(running)
        if next(b, "done") == "done":
            running.remove(b)
    assert int(words[0]) == 0 and None not in idx
    return idx, count[0], rows


_jax_dirty_indices = jax.jit(jmi.dirty_indices, static_argnums=1)
MASKS = {
    "empty": lambda n, rng: np.zeros(n, bool),
    "full": lambda n, rng: np.ones(n, bool),
    "random": lambda n, rng: rng.random(n) < 0.05,
    "over_capacity": lambda n, rng: rng.random(n) < 0.5,
}


@pytest.mark.parametrize("case", list(MASKS))
def test_single_pass_model_matches_plain_and_jax(monkeypatch, case):
    """Masks of 1,000 leaves in tiles of 8 (125 tiles: windows of 32 and
    more) and of the kernel's 4,096: the model equals dirty_indices_ref and
    the JAX dirty_indices, call after call on one status array, across
    wraps of the generations."""
    monkeypatch.setattr(tmi, "COMPACT_GENERATIONS", 4)
    scratch, rng = tmi._Scratch(), random.Random(case)
    nrng = np.random.default_rng(len(case))
    for call in range(6):
        n, cap = 1000, (64, 256)[call % 2]
        mask = MASKS[case](n, nrng)
        tile = 8 if call < 5 else tmi.compact_tile_leaves(1, True)
        idx, count, _ = compact_model(mask.tolist(), cap, tile, scratch, rng)
        want_idx, want_count = tmi.dirty_indices_ref(torch.from_numpy(mask), cap)
        assert idx == want_idx.tolist() and count == int(want_count), call
        assert idx == np.asarray(_jax_dirty_indices(jnp.asarray(mask), cap)).tolist(), call
    assert scratch.gen == 6 - 4 + 1  # the wrap at the fourth call zeroed the array once


@pytest.mark.parametrize("per", [1, 4])
def test_single_pass_model_matches_dirty_leaves(per):
    """A u64 column's diff, ``per`` values a leaf, with the dirty leaves'
    rows written: the model equals dirty_leaves_ref."""
    rng = np.random.default_rng(per)
    n = 999
    old = rng.integers(-(1 << 63), 1 << 63, n, dtype=np.int64)
    new = np.where(rng.random(n) < 0.03, old ^ (1 << 62), old)
    n_leaves = 1 << max(-(-n // per) - 1, 0).bit_length()
    diff = np.concatenate([old != new, np.zeros(n_leaves * per - n, bool)])
    dirty = diff.reshape(n_leaves, per).any(axis=1)
    chunks = tmi._u64_chunks(torch.from_numpy(new), per, n_leaves)
    scratch = tmi._Scratch()
    for call in range(3):
        rows = torch.from_numpy(rng.integers(-(1 << 31), 1 << 31, (n_leaves, 8), dtype=np.int32))
        want = rows.clone()
        want_idx, want_count = tmi.dirty_leaves_ref(torch.from_numpy(old), torch.from_numpy(new),
                                                    per, n_leaves, 128, want)
        idx, count, written = compact_model(dirty.tolist(), 128, 4 * (call + 1), scratch,
                                            random.Random(call), rows_of=lambda i: chunks[i])
        for i, row in written.items():
            rows[i] = row
        assert idx == want_idx.tolist() and count == int(want_count)
        assert torch.equal(rows, want)
