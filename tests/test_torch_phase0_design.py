"""Design model of kernel K9 (``csrc/state_columns.cu``), the phase0
accounting epoch in one cooperative launch, run on the CPU in plain Python
ints: the sweep of warp-strided runs with the excess swept one at a time,
a grid barrier, the scalars once, the credit pass (each validator's own
rewards and penalties, the proposer scatter's atomics landing in any
order), a second barrier, the settle pass; and the division by the
inclusion delay, through the block's table of reciprocals or the exact u64
division past it. Each is held against the port's plain version and the
JAX package."""

import math
import random
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from eth_consensus_specs_tpu.forks import get_spec
from eth_consensus_specs_tpu.ops import state_columns as jsc
from eth_consensus_specs_tpu_torch.config import phase0_epoch_params
from eth_consensus_specs_tpu_torch.convert import to_numpy
from eth_consensus_specs_tpu_torch.inputs import (
    PHASE0_CORNERS, example_inputs, phase0_corner_inputs)
from eth_consensus_specs_tpu_torch.ops import state_columns as tsc
from tests.test_torch_epoch_design import device_divisor, divide

M64 = (1 << 64) - 1
HALF = {"mainnet": 4096, "minimal": 32}  # EPOCHS_PER_SLASHINGS_VECTOR // 2
_SOURCE = (Path(tsc.__file__).parents[1] / "csrc" / "state_columns.cu").read_text()
RUN = int(re.search(r"#define K9_RUN (\d+)", _SOURCE).group(1))
DELAYS = int(re.search(r"constexpr int kDelays = (\d+);", _SOURCE).group(1))
TABLE = [device_divisor(d) for d in range(1, DELAYS + 1)]  # the block's table, as the card fills it


def div_delay(x: int, delay: int) -> int:
    """The kernel's ``div_delay``: x // max(delay, 1) by the table up to
    DELAYS, by the u64 division past it."""
    d = max(delay, 1)
    return divide(x, TABLE[d - 1]) if d <= DELAYS else x // d


def _u(t) -> list[int]:
    return [int(x) & M64 for x in t.reshape(-1).tolist()]


def k9_model(p, cols, just, threads: int, rng: random.Random, zero_excess: bool = True):
    """The one-launch K9 on Python ints over ``threads`` lanes (whole warps).
    Returns (balance, effective balance, rewards, penalties) as u64 lists
    and the justification outputs. ``zero_excess=False`` leaves the excess
    validators' reward slots as the allocation left them (a wrong kernel)."""
    assert threads % 32 == 0
    n = cols.balance.shape[0]
    eff, bal, act, ex, wd, delay = (_u(getattr(cols, k)) for k in (
        "effective_balance", "balance", "activation_epoch", "exit_epoch", "withdrawable_epoch",
        "incl_delay"))
    slashed, src, tgt, head, cur_tgt = (getattr(cols, k).tolist() for k in (
        "slashed", "src_att", "tgt_att", "head_att", "cur_tgt_att"))
    proposer = cols.incl_proposer.tolist()
    cur = int(just.current_epoch) & M64
    prev = cur - 1 if cur > 0 else 0
    sums = [0] * 5
    slots = [0xDEADBEEF] * n  # the reward column as torch.empty leaves it

    def classify(i, add=True):
        sl = bool(slashed[i])
        att = [bool(m[i]) and not sl for m in (src, tgt, head)]
        if add:
            sums[0] += eff[i] if act[i] <= cur < ex[i] else 0
            for k in range(3):
                sums[1 + k] += eff[i] if att[k] else 0
            sums[4] += eff[i] if cur_tgt[i] and not sl else 0
        return act[i] <= prev < ex[i], sl, att

    # (a) the sweep: each lane's warp-strided run kept, the excess one at a time
    kept, excess = {}, []
    for g in range(threads):
        lane = g % 32
        for j in range(RUN):
            i = (g - lane) * RUN + lane + 32 * j
            if i < n:
                kept[i] = classify(i)
                slots[i] = 0
    for g in range(threads):
        for i in range(threads * RUN + g, n, threads):
            classify(i)
            excess.append(i)
            if zero_excess:
                slots[i] = 0
    assert sorted([*kept, *excess]) == list(range(n))  # every validator swept once
    sums = [s & M64 for s in sums]

    # grid barrier; the scalars, once
    incr = p.effective_balance_increment
    total = max(sums[0], incr)
    t = lambda v: torch.tensor(v - (1 << 64) if v >= 1 << 63 else v)  # noqa: E731
    jout = tsc.justification_update(just, t(max(sums[2], incr)), t(max(sums[4], incr)), t(total))
    finality_delay = (prev - (int(jout[5]) & M64)) & M64
    in_leak = finality_delay > p.min_epochs_to_inactivity_penalty
    do_acc = cur > 0
    d_incr, d_prq, d_ipq = (tsc.divisor_magic(d) for d in (
        incr, p.proposer_reward_quotient, p.inactivity_penalty_quotient))
    factor = [divide(max(sums[1 + k], incr), d_incr) for k in range(3)]
    d_br = device_divisor(math.isqrt(total) * p.base_rewards_per_epoch)
    d_units = device_divisor(divide(total, d_incr))
    d_total = device_divisor(total)
    adj = min(int(just.slashings_sum) * p.proportional_slashing_multiplier & M64, total)
    slash_epoch = (cur + p.epochs_per_slashings_vector // 2) & M64
    hyst = incr // p.hysteresis_quotient
    down, up = hyst * p.hysteresis_downward_multiplier, hyst * p.hysteresis_upward_multiplier

    def base_reward(e):
        return divide(e * p.base_reward_factor & M64, d_br)

    # the credit pass: each validator's own rewards and penalties, the kept
    # from registers, the excess re-read with its own rewards parked in its
    # balance slot; the proposer scatter's atomics land in any order
    own, pens, slash_now, adds = {}, {}, {}, []
    for i in [*kept, *excess]:
        active_prev, sl, att = kept[i] if i in kept else classify(i, add=False)
        e = eff[i]
        eligible = active_prev or (sl and (prev + 1) & M64 < wd[i])
        slash_now[i] = sl and slash_epoch == wd[i]
        rewards = penalties = 0
        if do_acc:
            br = base_reward(e)
            pr = divide(br, d_prq)
            if att[0]:
                adds.append((min(max(proposer[i], 0), n - 1), pr))
                rewards = div_delay(br - pr, delay[i])
            for k in range(3):
                if eligible and att[k]:
                    rewards += br if in_leak else divide(br * factor[k] & M64, d_units)
                if eligible and not att[k]:
                    penalties += br
            if eligible and in_leak:
                penalties += p.base_rewards_per_epoch * br - pr & M64
                if not att[1]:
                    penalties += divide(e * finality_delay & M64, d_ipq)
        own[i], pens[i] = rewards & M64, penalties & M64
    rng.shuffle(adds)
    for target, amount in adds:
        slots[target] = (slots[target] + amount) & M64

    # second barrier; the settle pass: each slot joins its own rewards
    out = [[0] * n for _ in range(4)]
    for i in [*kept, *excess]:
        e = eff[i]
        rewards = (own[i] + slots[i]) & M64
        b = (bal[i] + rewards) & M64
        b -= min(b, pens[i])
        if slash_now[i]:
            b -= min(b, divide(divide(e, d_incr) * adj & M64, d_total) * incr & M64)
        crossed = (b + down & M64) < e or (e + up & M64) < b
        new_eff = min(divide(b, d_incr) * incr & M64, p.max_effective_balance) if crossed else e
        out[0][i], out[1][i], out[2][i], out[3][i] = b, new_eff, rewards, pens[i]
    return out, jout


@pytest.fixture(scope="module")
def jax_params():
    return {p: jsc.EpochParams.from_spec(get_spec("phase0", p)) for p in HALF}


def _inputs(case: str, n: int, preset: str):
    if case == "example":
        return example_inputs(n, slashings_half_vector=HALF[preset], device="cpu")
    return phase0_corner_inputs(case, n, slashings_half_vector=HALF[preset], device="cpu")


def _model_equals(preset, cols, just, threads, jax_params=None, **kw) -> bool:
    """Whether the model equals the plain version (and, with
    ``jax_params``, the JAX package) on every output."""
    params = phase0_epoch_params(preset)
    (bal, eff, rewards, penalties), jout = k9_model(params, cols, just, threads,
                                                    random.Random(threads), **kw)
    want = tsc.epoch_accounting_ref(params, cols, just)
    got = {"balance": bal, "effective_balance": eff, "rewards": rewards, "penalties": penalties}
    same = all(v == _u(getattr(want, k)) for k, v in got.items())
    same = same and all(torch.equal(g, w) for g, w in zip(jout, want[2:9]))
    if jax_params is not None:
        ncols, njust = to_numpy(cols), to_numpy(just)
        ncols = ncols._replace(incl_proposer=ncols.incl_proposer.view(np.int64))
        jw = jsc.epoch_accounting(jax_params[preset], ncols, njust)
        same = same and all(np.array_equal(np.asarray(getattr(jw, k)), np.array(v, np.uint64))
                            for k, v in got.items())
        same = same and np.array_equal(np.asarray(jw.finalized_epoch), to_numpy(jout[5]))
    return same


# ------------------------------------------------ the delay's division --

DELAY_CASES = sorted({0, 1, *range(1, DELAYS + 1), DELAYS + 1, 1 << 40, 1 << 63, M64})


def test_delay_division_is_exact():
    """Delays 0, 1, every table entry, the first past the table, 2^40, 2^63
    and 2^64 - 1, over dividends that break a wrong rounding: the model's
    division equals // by max(delay, 1) and the plain version's
    ``_udiv_any``."""
    rng = random.Random(9)
    dividends = sorted({0, 1, 2, 63, 64, 65, (1 << 32) - 1, 1 << 32, (1 << 63) - 1, 1 << 63, M64,
                        *(d * q + r for d in range(1, DELAYS + 2) for q in (1, 12345, M64 // d)
                          for r in (-1, 0, 1) if 0 <= d * q + r <= M64),
                        *(rng.randrange(1 << 64) for _ in range(200))})
    x = torch.tensor([v - (1 << 64) if v >= 1 << 63 else v for v in dividends])
    one = torch.ones((), dtype=torch.int64)
    for delay in DELAY_CASES:
        want = [v // max(delay, 1) for v in dividends]
        assert [div_delay(v, delay) for v in dividends] == want, delay
        d = torch.full_like(x, delay - (1 << 64) if delay >= 1 << 63 else delay)
        assert _u(tsc._udiv_any(x, tsc.umax64(d, one))) == want, delay


def test_delay_table_is_the_host_reciprocal():
    """The table the card fills (make_divisor of 1..DELAYS) holds the
    reciprocals the host would pass."""
    assert TABLE == [tsc.divisor_magic(d) for d in range(1, DELAYS + 1)]


# -------------------------------------------------- K9 in one launch --


@pytest.mark.parametrize("threads", [32, 256])
@pytest.mark.parametrize("case", ("example",) + PHASE0_CORNERS)
@pytest.mark.parametrize("preset", ["mainnet", "minimal"])
def test_one_launch_model_matches_plain_and_jax(jax_params, preset, case, threads):
    """1,000 validators on one warp (256 in its runs, 744 swept, scattered
    and applied one at a time, re-read) and on one block (all in its runs):
    the model equals the plain version and the JAX package on the example
    columns and every corner."""
    assert _model_equals(preset, *_inputs(case, 1000, preset), threads, jax_params)


def _includers(n: int, kept: int) -> torch.Tensor:
    """Includer indices that collide on a few validators, point at the
    excess (past the first ``kept``), below 0 and past the registry."""
    idx = torch.arange(n)
    which = idx % 6
    return torch.where(which == 0, torch.full_like(idx, 5),
           torch.where(which == 1, kept + idx % 17,
           torch.where(which == 2, -1 - idx,
           torch.where(which == 3, n + idx, torch.where(which == 4, n - 1, idx // 7)))))


@pytest.mark.parametrize("preset", ["mainnet", "minimal"])
def test_scatter_collisions_excess_and_clipped(jax_params, preset):
    """Includers that collide, that point at validators of the excess, and
    that lie outside [0, n) (clipped to 0 and n - 1), on one warp."""
    n, threads = 1000, 32
    cols, just = _inputs("example", n, preset)
    cols = cols._replace(incl_proposer=_includers(n, threads * RUN))
    assert _model_equals(preset, cols, just, threads, jax_params)
    rewards = tsc.epoch_accounting_ref(phase0_epoch_params(preset), cols, just).rewards
    base = tsc.epoch_accounting_ref(phase0_epoch_params(preset), cols._replace(
        incl_proposer=torch.arange(n)), just).rewards
    assert rewards[5] > base[5] and rewards[0] > base[0] and rewards[n - 1] > base[n - 1]


def test_model_that_skips_the_excess_zeroing_fails():
    """A kernel that zeroed only its runs' reward slots would add the
    scatter to whatever the allocation left in the excess slots: the model
    with that fault must disagree with the plain version."""
    cols, just = _inputs("example", 1000, "mainnet")
    assert _model_equals("mainnet", cols, just, 32)
    assert not _model_equals("mainnet", cols, just, 32, zero_excess=False)
