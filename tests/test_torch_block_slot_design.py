"""The design of K19 (``csrc/block_epoch.cu``) held on the host, cheaply.

K19 runs a slot in three phases over the whole card instead of the spec's
walk in order. ``block_slot_twin`` runs the same phases here on numpy and
Python ints, as the kernel runs them:

A. the withdrawal sweep ranked by a scan; each live lane records its row as
   a minimum, per bit of flags & ~pre, in a u64 a (column, validator) of
   three 16-bit fields (0xFFFF: none);
B. a lane's new bits are those whose minimum is its own row; its reward goes
   to its row's u64 sum; the column ORs the flags; the deposits add;
C. the pay rows from the inclusive scan S of the row sums, a pay row's
   quotient (S[p] - S[previous pay row]) / denominator and the numerator
   left S[last] - S[last pay row]; the sync positions sorted by
   (validator << 10 | position), each validator's run walked in order, the
   proposer's run adding prop_r times the set bits between its own
   positions; the live lanes reset the scratch.

On every corner of ``inputs.block_slot_corners`` at 2^10 validators and 8
rows the twin must equal ``block_slot_ref`` (which
``tests/test_torch_block_epoch.py`` holds to the JAX
``process_slot_columnar``) word for word, and leave its scratch clean. With
``setter="last"`` the twin credits each bit to the last row that carries it
instead, the attribution the ``first_setter`` corner must tell apart.
"""

import numpy as np
import pytest
import torch

from eth_consensus_specs_tpu_torch import config
from eth_consensus_specs_tpu_torch.convert import to_numpy
from eth_consensus_specs_tpu_torch.inputs import BLOCK_SLOT_CORNERS, block_slot_corners
from eth_consensus_specs_tpu_torch.ops import block_epoch as tbe

N = 1 << 10
ATTS = 8
MASK = (1 << 64) - 1
NONE = MASK  # a clean first-setter word
POS_BITS = 10  # a sync position in the sort key


def _withdrawals(params, n, balance, scal, static):
    bound = min(n, params.max_validators_per_withdrawals_sweep)
    max_w, max_eb = params.max_withdrawals_per_payload, params.max_effective_balance
    start, epoch = int(scal[1]), int(static.epoch)
    window = (start + np.arange(bound, dtype=np.uint64)) % np.uint64(n)
    bal = balance[window]
    cred = static.has_eth1_cred[window]
    full = cred & (static.withdrawable_epoch[window] <= np.uint64(epoch)) & (bal > 0)
    partial = cred & (static.eff_balance[window] == np.uint64(max_eb)) & (bal > np.uint64(max_eb))
    elig = full | partial
    rank = np.cumsum(elig)  # the block scan
    take = elig & (rank <= max_w)
    balance[window[take]] = np.where(full[take], np.uint64(0), np.uint64(max_eb))
    taken = min(int(rank[-1]), max_w)
    last_pos = int(np.flatnonzero(take).max()) if take.any() else 0
    scal[0] = (int(scal[0]) + taken) & MASK
    sweep = params.max_validators_per_withdrawals_sweep
    scal[1] = (start + last_pos + 1) % n if taken == max_w else (start + sweep) % n


def _field_min(x: int, y: int) -> int:
    """__vminu2 on both halves of a u64: the minimum of each 16-bit field."""
    return sum(min((x >> s) & 0xFFFF, (y >> s) & 0xFFFF) << s for s in (0, 16, 32, 48))


def block_slot_twin(params, n, st, slot, static, with_withdrawals=True, setter="first"):
    """K19's phases on the host: returns (balance, cur, prev, scal, scratch),
    the first-setter scratch as the launch leaves it."""
    balance, cur, prev = (to_numpy(t).copy() for t in (st.balance, st.cur_part, st.prev_part))
    scal = [int(to_numpy(st.next_wd_index)), int(to_numpy(st.next_wd_validator)), 0]
    s, sc = to_numpy(slot), to_numpy(static)
    parts = (cur, prev)
    rows, lanes = s.att_idx.shape
    first = {}  # the scratch: (column, validator) -> word, NONE where absent
    row_sum = [0] * rows  # the row sums, u64
    # the row a lane records: its own, or its place from the end for "last"
    key = list(range(rows)) if setter == "first" else list(range(rows - 1, -1, -1))

    def live_lanes():
        for r in range(rows):
            flags = int(s.att_flags[r])
            for c in range(lanes):
                idx = int(s.att_idx[r, c])
                if flags and idx < n and s.att_bits[r, c]:
                    yield r, 0 if s.att_is_current[r] else 1, idx, flags

    # A: the sweep; each live lane's candidate bits take its row as a minimum
    if with_withdrawals:
        _withdrawals(params, n, balance, scal, sc)
    for r, col, idx, flags in live_lanes():
        cand = flags & 7 & ~int(parts[col][idx])
        want = NONE
        for b in range(3):
            if (cand >> b) & 1:
                want = (want & ~(0xFFFF << (16 * b))) | (key[r] << (16 * b))
        if cand:
            first[col, idx] = _field_min(first.get((col, idx), NONE), want)
    # B: credit the bits a lane set first; OR the flags; the deposits
    for r, col, idx, flags in live_lanes():
        mins = first.get((col, idx), NONE)
        new = sum(1 << b for b in range(3)
                  if (flags >> b) & 1 and (mins >> (16 * b)) & 0xFFFF == key[r])
        weight = sum(w for b, w in enumerate(params.weights) if (new >> b) & 1)
        row_sum[r] = (row_sum[r] + weight * int(sc.base_reward[idx])) & MASK
        parts[col][idx] |= flags
    for idx, amt in zip(s.dep_idx.tolist(), s.dep_amt.tolist()):
        if idx < n:
            balance[idx] = np.uint64((int(balance[idx]) + amt) & MASK)
    # C: the live lanes clean the scratch
    for r, col, idx, flags in live_lanes():
        first[col, idx] = NONE
    # C: the pay rows by the scan of the row sums
    inc = []
    for x in row_sum:
        inc.append(((inc[-1] if inc else 0) + x) & MASK)
    pay_at = [inc[r] for r in range(rows) if s.att_pay[r]]
    denom = tbe.proposer_denominator(params)
    pay_total = sum(((p - q) & MASK) // denom for p, q in zip(pay_at, [0] + pay_at[:-1])) & MASK
    scal[2] = ((inc[-1] if inc else 0) - (pay_at[-1] if pay_at else 0)) & MASK
    # C: the sync aggregate, one validator's run of positions at a time
    prop = int(s.proposer)
    pr, qr = int(sc.part_reward), int(sc.prop_reward)
    bits = [bool(b) for b in s.sync_bits]
    before = [0]  # set bits at the positions before each, and in all
    for b in bits:
        before.append(before[-1] + b)
    keys = sorted((int(v) << POS_BITS) | k for k, v in enumerate(s.sync_idx))
    runs = {}
    for k in keys:
        runs.setdefault(k >> POS_BITS, []).append(k & ((1 << POS_BITS) - 1))
    for v, positions in runs.items():
        bal, seen = int(balance[v]), 0
        if v == prop:
            bal = (bal + pay_total) & MASK
        for k in positions:
            if v == prop:
                bal = (bal + qr * (before[k] - seen)) & MASK
                seen = before[k]
            bal = (bal + pr) & MASK if bits[k] else max(bal - pr, 0)
        if v == prop:
            bal = (bal + qr * (before[-1] - seen)) & MASK
        balance[v] = np.uint64(bal)
    if prop not in runs:
        balance[prop] = np.uint64((int(balance[prop]) + pay_total + qr * before[-1]) & MASK)
    return balance, cur, prev, np.asarray(scal, np.uint64), first


@pytest.fixture(scope="module")
def params():
    return config.block_epoch_params("deneb", "mainnet")


@pytest.fixture(scope="module")
def corners(params):
    return block_slot_corners(params, N, atts_per_slot=ATTS, device="cpu")


def _ref(params, st, slot, static, with_withdrawals=True):
    state = [t.clone() for t in (st.balance, st.cur_part, st.prev_part)] + [tbe._scalars(st)]
    return [to_numpy(t) for t in tbe.block_slot_ref(params, N, *state, slot, static,
                                                    with_withdrawals)]


@pytest.mark.parametrize("case", BLOCK_SLOT_CORNERS)
def test_twin_equals_the_plain_slot(case, params, corners):
    st, slot, static = corners[case]
    *got, first = block_slot_twin(params, N, st, slot, static)
    for name, g, w in zip(("balance", "cur", "prev", "scal"), got, _ref(params, st, slot, static)):
        assert np.array_equal(g, w), name
    assert all(w == NONE for w in first.values())


def test_twin_without_withdrawals(params, corners):
    st, slot, static = corners["cell"]
    got = block_slot_twin(params, N, st, slot, static, with_withdrawals=False)[:4]
    for g, w in zip(got, _ref(params, st, slot, static, with_withdrawals=False)):
        assert np.array_equal(g, w)


def test_first_setter_minima_pack_three_rows():
    """Three fields of one word keep their own minima; the fourth stays none."""
    word = NONE
    for r, cand in ((9, 0b011), (4, 0b110), (7, 0b101), (12, 0b111)):
        want = NONE
        for b in range(3):
            if (cand >> b) & 1:
                want = (want & ~(0xFFFF << (16 * b))) | (r << (16 * b))
        word = _field_min(word, want)
    assert [(word >> (16 * b)) & 0xFFFF for b in range(4)] == [7, 4, 4, 0xFFFF]


def test_scratch_limits_match_the_kernel():
    """Rows fit a 16-bit minimum below 0xFFFF, and sync positions their key
    field, at the wrapper's limits."""
    assert tbe.MAX_ROWS < 0xFFFF and tbe.MAX_SYNC <= 1 << POS_BITS
    scratch = tbe.SlotScratch(8, "cpu")
    assert scratch.words.shape == (16 + tbe.MAX_ROWS,) and scratch.blocks == 0
    assert torch.equal(scratch.words[:16], torch.full((16,), -1)) and not scratch.words[16:].any()
