"""Columnar per-slot block processing on the card: an epoch of blocks over
the dense plane (kernel K19), with a dirty state root every slot.

Counterpart of ``eth_consensus_specs_tpu/ops/block_epoch.py`` (BASELINE
config #4: 128 attestations a slot x 32 slots at 2^20 validators, under
1 s): ``BlockColumns`` (:97), ``BlockState`` (:118),
``base_reward_per_validator`` (:128), ``sync_rewards`` (:139),
``process_slot_columnar`` (:265, kernel K19 ``csrc/block_epoch.cu`` here,
its plain version ``block_slot_ref``), ``BlockEpochStatic`` (:323),
``make_epoch_static`` (:335), ``block_epoch_chain`` (:352, the scan of
:406), ``SlotRootCtx`` (:487), ``make_root_ctx`` (:501), ``_slot_root``
(:554) and ``synthetic_block_columns`` (:738). A slot, in spec order:

* the capella withdrawal sweep over a window of min(n, 16,384) validators
  from the circular pointer, paying the first MAX_WITHDRAWALS_PER_PAYLOAD;
* the attestation rows in block order: newly earned participation flags
  into the current or previous column, and the proposer-reward numerator,
  divided once at each on-chain attestation's pay row (an electra aggregate
  expands into one row per committee);
* existing-key deposits;
* the sync aggregate, position by position (a decrease clamps at 0 per
  operation).

The chain clones the caller's state once and K19 updates the clone in
place, slot after slot, with no read back to the host between slots: the
withdrawal pointers, the epoch and the sync rewards are 0-dim device
tensors. Each slot's root re-reduces the three dirty columns (K2 over the
packed chunks, K1 for the folds to the SSZ limits, the length mix-ins and
the top container) over top chunks whose slow-moving roots (the validator
registry, the inactivity scores, the checkpoints) ``make_root_ctx`` fills
once an epoch (K3 and K2); the port, as the JAX package, keeps no
incremental forest in this plane.

Lane types: u64 in int64 lanes (compares and divisions through
``lanes``), validator indices in int32 lanes, flags in uint8, bits in
bool. Pad lanes of rows and deposits carry the index n.

Deliberate differences: ``block_epoch_chain`` takes a ``device`` (the card
unless the caller names another) and checks every index on the host once
before its first slot; a with-withdrawals call on pre-capella constants
(no sweep) raises; a slot is ``block_slot``, in place on the chain's
state (JAX's ``process_slot_columnar`` returns a new one), and
``synthetic_block_columns`` always takes JAX's default committee cap. Not
ported: ``extract_block_columns`` (:581, needs the
fork spec objects), the ``obs`` spans and counters and the
``fault.degrade`` route to the host replay (:367-403); the numpy replay
(``ops/block_epoch_host.py``) is the tests' and the smoke run's oracle,
never a route.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import numpy as np
import torch

from .. import _ext
from ..config import BlockEpochParams, state_fields
from ..device import default_device
from ..lanes import ule64, ult64, umax64, udiv64, umod64
from .state_columns import isqrt_u64
from .state_root import (
    BALANCE_LIMIT_CHUNKS_LOG2,
    KERNELS,
    PARTICIPATION_LIMIT_CHUNKS_LOG2,
    PLAIN,
    VALIDATOR_REGISTRY_LIMIT_LOG2,
    Hashers,
    fold_many,
    list_roots,
    mix_length,
    small_dynamic_roots,
    u8_subtree,
    u64_chunk_words,
    u64_subtree,
    validator_subtree,
)

MAX_WINDOW = 16384  # K19's sweep window: 16 positions for each of 1,024 threads
MAX_SYNC = 1024  # K19 stages a slot's sync indices in shared memory


class BlockColumns(NamedTuple):
    """One epoch of block bodies as fixed-shape tensors; indexed by slot
    (``slot_columns``), the same fields without the leading axis. Pad lanes
    carry the index n; absent rows and deposits have flags and amount 0."""

    att_idx: torch.Tensor  # int32[S, A, C] committee member indices
    att_bits: torch.Tensor  # bool[S, A, C] aggregation bits
    att_flags: torch.Tensor  # uint8[S, A] participation flag bits conferred
    att_is_current: torch.Tensor  # bool[S, A] target epoch == current epoch
    # True on the last row of an on-chain attestation: the numerator of an
    # electra aggregate's per-committee rows divides once, at this row
    att_pay: torch.Tensor  # bool[S, A]
    proposer: torch.Tensor  # int32[S]
    sync_idx: torch.Tensor  # int32[S, SYNC] sync-committee validator indices
    sync_bits: torch.Tensor  # bool[S, SYNC]
    dep_idx: torch.Tensor  # int32[S, D] deposit target (existing validator)
    dep_amt: torch.Tensor  # int64[S, D] (u64)


class BlockState(NamedTuple):
    """The dense mutable plane."""

    balance: torch.Tensor  # int64[N] (u64)
    cur_part: torch.Tensor  # uint8[N] current_epoch_participation
    prev_part: torch.Tensor  # uint8[N] previous_epoch_participation
    next_wd_index: torch.Tensor  # int64 0-dim (u64)
    next_wd_validator: torch.Tensor  # int64 0-dim (u64)


class BlockEpochStatic(NamedTuple):
    """Per-epoch constants of the slots; the scalars are 0-dim int64 (u64)."""

    base_reward: torch.Tensor  # int64[N]
    eff_balance: torch.Tensor  # int64[N]
    withdrawable_epoch: torch.Tensor  # int64[N], FAR_FUTURE_EPOCH as -1
    has_eth1_cred: torch.Tensor  # bool[N]
    epoch: torch.Tensor
    part_reward: torch.Tensor
    prop_reward: torch.Tensor


class SlotRootCtx(NamedTuple):
    """Static tree content for the per-slot roots: every top chunk but the
    slot, the balances and the two participation lists, filled once an
    epoch."""

    top_chunks: torch.Tensor  # int32[2^top_depth, 8]
    zerohashes: torch.Tensor  # int32[42, 8]
    len_chunk: torch.Tensor  # int32[8], the u64 chunk of n
    top_depth: int
    n: int
    slot_field_index: int
    balances_slot: int
    cur_part_slot: int
    prev_part_slot: int


def _to(x, dev: torch.device):
    return type(x)(*(t.to(dev) if isinstance(t, torch.Tensor) else t for t in x))


def slot_columns(blocks: BlockColumns, s: int) -> BlockColumns:
    """Slot ``s`` of an epoch's columns (views, no copies)."""
    return BlockColumns(*(t[s] for t in blocks))


def proposer_denominator(params: BlockEpochParams) -> int:
    """The divisor of the proposer-reward numerator, once per attestation."""
    return ((params.weight_denominator - params.proposer_weight) * params.weight_denominator
            // params.proposer_weight)


def _per_increment(params: BlockEpochParams, total: torch.Tensor) -> torch.Tensor:
    return udiv64(torch.full_like(total, params.effective_balance_increment
                                  * params.base_reward_factor), isqrt_u64(total))


def base_reward_per_validator(params: BlockEpochParams, effective_balance, total_active):
    """get_base_reward as a column: increments * (increment * factor //
    isqrt(total_active_balance))."""
    return (udiv64(effective_balance, params.effective_balance_increment)
            * _per_increment(params, total_active))


def sync_rewards(params: BlockEpochParams, total_active):
    """(participant_reward, proposer_reward) of the epoch, 0-dim int64."""
    total_increments = udiv64(total_active, params.effective_balance_increment)
    total_base = _per_increment(params, total_active) * total_increments
    max_participant = udiv64(udiv64(total_base * params.sync_reward_weight,
                                    params.weight_denominator), params.slots_per_epoch)
    participant = udiv64(max_participant, params.sync_committee_size)
    proposer = udiv64(participant * params.proposer_weight,
                      params.weight_denominator - params.proposer_weight)
    return participant, proposer


def make_epoch_static(params: BlockEpochParams, eff_balance, withdrawable_epoch, has_eth1_cred,
                      epoch) -> BlockEpochStatic:
    """The epoch's constants on the columns' device; every validator counts
    as active (the JAX package's bench model)."""
    dev = eff_balance.device
    total = umax64(eff_balance.sum(),
                   torch.tensor(params.effective_balance_increment, dtype=torch.int64,
                                device=dev))
    part_r, prop_r = sync_rewards(params, total)
    return BlockEpochStatic(
        base_reward=base_reward_per_validator(params, eff_balance, total),
        eff_balance=eff_balance,
        withdrawable_epoch=withdrawable_epoch,
        has_eth1_cred=has_eth1_cred,
        epoch=torch.as_tensor(epoch, dtype=torch.int64, device=dev).reshape(()),
        part_reward=part_r,
        prop_reward=prop_r,
    )


def check_indices(blocks: BlockColumns, n: int) -> None:
    """Raise ``ValueError`` unless every row and deposit index lies in
    [0, n] (n is the pad) and every sync index and proposer in [0, n). One
    read back to the host for the whole epoch."""
    cols = (blocks.att_idx, blocks.dep_idx, blocks.sync_idx, blocks.proposer)
    if any(t.numel() == 0 for t in cols):
        raise ValueError("empty block columns")
    lo, hi = torch.stack([torch.stack([t.min().long(), t.max().long()]) for t in cols]).cpu().T
    lo, hi = lo.tolist(), hi.tolist()
    if min(lo) < 0 or max(hi[:2]) > n or max(hi[2:]) >= n:
        raise ValueError(f"a block index lies outside the registry of {n} validators "
                         f"(min {min(lo)}, max rows/deposits {max(hi[:2])}, "
                         f"max sync/proposer {max(hi[2:])})")


def _sweep_bound(params: BlockEpochParams, n: int) -> int:
    bound = min(n, params.max_validators_per_withdrawals_sweep)
    if bound < 1:
        raise ValueError("these constants have no withdrawal sweep (pre-capella): "
                         "pass with_withdrawals=False")
    return bound


# ----------------------------------------------------------------- K19 --


def _withdrawals_ref(params, n, balance, scal, static):
    bound = _sweep_bound(params, n)
    max_w, max_eb = params.max_withdrawals_per_payload, params.max_effective_balance
    start = scal[1]
    pos = torch.arange(bound, dtype=torch.int64, device=balance.device)
    window = umod64(start + pos, n)
    bal = balance[window]
    cred = static.has_eth1_cred[window]
    full = cred & ule64(static.withdrawable_epoch[window], static.epoch) & (bal != 0)
    partial = cred & (static.eff_balance[window] == max_eb) & ult64(max_eb, bal)
    rank = torch.cumsum((full | partial).to(torch.int64), 0)
    take = (full | partial) & (rank <= max_w)
    amount = torch.where(full, bal, bal - max_eb)
    balance[window] = torch.where(take, bal - amount, bal)
    taken = torch.clamp(rank[-1], max=max_w)
    last_pos = torch.where(take, pos, torch.zeros_like(pos)).max()
    scal[1] = torch.where(taken == max_w, umod64(start + last_pos + 1, n),
                          umod64(start + params.max_validators_per_withdrawals_sweep, n))
    scal[0] += taken


def _sync_ref(balance, slot: BlockColumns, static, prop):
    """The sync aggregate in spec order, one committee position at a time."""
    pr, qr = static.part_reward, static.prop_reward
    zero = torch.zeros_like(pr)
    idx = slot.sync_idx.long()
    for k in range(idx.shape[0]):
        i, bit = idx[k:k + 1], slot.sync_bits[k:k + 1]
        cur = balance.index_select(0, i)
        dec = torch.where(ule64(pr, cur), cur - pr, zero)
        balance.index_copy_(0, i, torch.where(bit, cur + pr, dec))
        balance.index_add_(0, prop, torch.where(bit, qr, zero))


def block_slot_ref(params: BlockEpochParams, n: int, balance, cur_part, prev_part, scal,
                   slot: BlockColumns, static: BlockEpochStatic, with_withdrawals: bool = True):
    """Plain torch version of K19 (``process_slot_columnar``), in place on
    (balance, cur_part, prev_part, scal), which it returns. ``scal`` is
    int64[3]: the next withdrawal index and validator, and the proposer
    numerator left after the slot's last row (0 after a pay row)."""
    if with_withdrawals:
        _withdrawals_ref(params, n, balance, scal, static)
    denom = proposer_denominator(params)
    prop = slot.proposer.reshape(1).long()
    idx = slot.att_idx.long()
    safe = torch.clamp(idx, max=n - 1)
    live = (idx < n) & slot.att_bits
    num = torch.zeros((), dtype=torch.int64, device=balance.device)
    flags, is_cur, pay = (t.tolist() for t in (slot.att_flags, slot.att_is_current, slot.att_pay))
    for r in range(idx.shape[0]):
        if flags[r]:
            part = cur_part if is_cur[r] else prev_part
            pre = part[safe[r]]
            new = torch.where(live[r], flags[r] & ~pre, torch.zeros_like(pre))
            # add, as JAX scatters: pad lanes alias n - 1 and add 0, and new
            # is disjoint from pre, so the add is an or
            part.index_add_(0, safe[r], new)
            weight = sum(((new >> b) & 1).long() * w for b, w in enumerate(params.weights))
            num = num + (weight * static.base_reward[safe[r]]).sum()
        if pay[r]:
            balance.index_add_(0, prop, udiv64(num, denom).reshape(1))
            num = torch.zeros_like(num)
    scal[2] = num
    dep = slot.dep_idx.long()
    balance.index_add_(0, torch.clamp(dep, max=n - 1),
                       torch.where(dep < n, slot.dep_amt, torch.zeros_like(slot.dep_amt)))
    _sync_ref(balance, slot, static, prop)
    return balance, cur_part, prev_part, scal


def _check_slot(n, balance, cur_part, prev_part, scal, slot: BlockColumns,
                static: BlockEpochStatic):
    _ext.check_cuda(balance, torch.int64, (n,))
    _ext.check_cuda(cur_part, torch.uint8, (n,))
    _ext.check_cuda(prev_part, torch.uint8, (n,))
    _ext.check_cuda(scal, torch.int64, (3,))
    for t in (static.base_reward, static.eff_balance, static.withdrawable_epoch):
        _ext.check_cuda(t, torch.int64, (n,))
    _ext.check_cuda(static.has_eth1_cred, torch.bool, (n,))
    for t in (static.epoch, static.part_reward, static.prop_reward):
        _ext.check_cuda(t, torch.int64, ())
    if slot.att_idx.dim() != 2:
        raise ValueError(f"expected one slot's rows [A, C], got {tuple(slot.att_idx.shape)}")
    a, c = slot.att_idx.shape
    sy, d = slot.sync_idx.shape[0], slot.dep_idx.shape[0]
    for t, dtype, shape in ((slot.att_idx, torch.int32, (a, c)), (slot.att_bits, torch.bool, (a, c)),
                            (slot.att_flags, torch.uint8, (a,)),
                            (slot.att_is_current, torch.bool, (a,)), (slot.att_pay, torch.bool, (a,)),
                            (slot.proposer, torch.int32, ()), (slot.sync_idx, torch.int32, (sy,)),
                            (slot.sync_bits, torch.bool, (sy,)), (slot.dep_idx, torch.int32, (d,)),
                            (slot.dep_amt, torch.int64, (d,))):
        _ext.check_cuda(t, dtype, shape)
    if sy > MAX_SYNC:
        raise ValueError(f"K19 takes at most {MAX_SYNC} sync positions, got {sy}")
    return a, c, sy, d


def block_slot(params: BlockEpochParams, n: int, balance, cur_part, prev_part, scal,
               slot: BlockColumns, static: BlockEpochStatic, with_withdrawals: bool = True):
    """One slot's block against the plane, in place on (balance, cur_part,
    prev_part, scal), which it returns (``block_slot_ref`` says what
    ``scal`` holds). The slot's indices must have passed ``check_indices``.

    CUDA tensors go through kernel K19 (``csrc/block_epoch.cu``, one launch:
    one block of 1,024 threads runs the withdrawals, the rows in order, the
    deposits and the sync walk); CPU tensors through the plain version."""
    if balance.device.type == "cpu":
        return block_slot_ref(params, n, balance, cur_part, prev_part, scal, slot, static,
                              with_withdrawals)
    a, c, sy, d = _check_slot(n, balance, cur_part, prev_part, scal, slot, static)
    if with_withdrawals and _sweep_bound(params, n) > MAX_WINDOW:
        raise ValueError(f"K19's sweep window holds at most {MAX_WINDOW} validators")
    consts = (ctypes.c_int64 * 8)(*params.weights, proposer_denominator(params),
                                  params.max_withdrawals_per_payload,
                                  params.max_validators_per_withdrawals_sweep,
                                  params.max_effective_balance, int(bool(with_withdrawals)))
    p = _ext.ptr
    _ext.launch("block_epoch", "block_slot_launch", balance.device, p(balance), p(cur_part),
                p(prev_part), p(scal), p(static.base_reward), p(static.eff_balance),
                p(static.withdrawable_epoch), p(static.has_eth1_cred), p(static.epoch),
                p(static.part_reward), p(static.prop_reward), p(slot.att_idx), p(slot.att_bits),
                p(slot.att_flags), p(slot.att_is_current), p(slot.att_pay), p(slot.proposer),
                p(slot.sync_idx), p(slot.sync_bits), p(slot.dep_idx), p(slot.dep_amt), n, a, c,
                sy, d, ctypes.cast(consts, ctypes.c_void_p), counter="block_slot")
    return balance, cur_part, prev_part, scal


def _scalars(st: BlockState) -> torch.Tensor:
    dev = st.balance.device
    return torch.stack([torch.as_tensor(v, dtype=torch.int64, device=dev).reshape(())
                        for v in (st.next_wd_index, st.next_wd_validator, 0)])


# ------------------------------------------------------------ the chain --


def _chain(slot_fn, h: Hashers, params, n, st, blocks, static, root_ctx, with_withdrawals,
           device):
    dev = default_device(device)
    st, blocks, static = _to(st, dev), _to(blocks, dev), _to(static, dev)
    if int(st.balance.shape[0]) != n:
        raise ValueError(f"the state holds {st.balance.shape[0]} validators, not {n}")
    check_indices(blocks, n)
    root_ctx = None if root_ctx is None else _to(root_ctx, dev)
    balance, cur, prev = (t.clone() for t in (st.balance, st.cur_part, st.prev_part))
    scal = _scalars(st)
    acc = torch.zeros(8, dtype=torch.int32, device=dev)
    slot0 = static.epoch * params.slots_per_epoch + 1
    for s in range(int(blocks.proposer.shape[0])):
        slot_fn(params, n, balance, cur, prev, scal, slot_columns(blocks, s), static,
                with_withdrawals)
        if root_ctx is not None:
            acc = acc ^ slot_root(root_ctx, balance, cur, prev, slot0 + s, h)
    return BlockState(balance, cur, prev, scal[0].clone(), scal[1].clone()), acc


def block_epoch_chain(params: BlockEpochParams, n: int, st: BlockState, blocks: BlockColumns,
                      static: BlockEpochStatic, root_ctx: SlotRootCtx | None = None,
                      with_withdrawals: bool = True, device=None):
    """An epoch of blocks over the plane on ``device`` (the card unless the
    caller names another; inputs are moved there): one K19 launch a slot,
    the slots numbered from ``epoch * SLOTS_PER_EPOCH + 1``. With
    ``root_ctx`` (``make_root_ctx``) each slot's state root is xor-chained
    into the accumulator. Returns ``(BlockState, acc)``, ``acc`` the
    int32[8] root words (zero without ``root_ctx``). ``st`` is left as it
    is; nothing reads back to the host between slots.

    On a CUDA device every slot runs K19 and its root K1 and K2; on the CPU
    their plain versions."""
    return _chain(block_slot, KERNELS, params, n, st, blocks, static, root_ctx,
                  with_withdrawals, device)


def block_epoch_chain_ref(params: BlockEpochParams, n: int, st: BlockState, blocks: BlockColumns,
                          static: BlockEpochStatic, root_ctx: SlotRootCtx | None = None,
                          with_withdrawals: bool = True, device=None):
    """``block_epoch_chain`` through the plain torch version of every
    kernel, on any device: the reference the kernel path is held against."""
    return _chain(block_slot_ref, PLAIN, params, n, st, blocks, static, root_ctx,
                  with_withdrawals, device)


# ------------------------------------------------------- per-slot rooting --


def make_root_ctx(fork: str, arrays, meta, static: BlockEpochStatic, scores, just,
                  h: Hashers = KERNELS) -> SlotRootCtx:
    """Fill every slow-moving top chunk once an epoch: the validator
    registry root (the effective balances are constant in an epoch), the
    inactivity scores, the justification bits and the checkpoints."""
    n = meta.n_validators
    slot_of = {name: i for i, name in meta.dynamic_slots}
    lists = [(*validator_subtree(arrays, n, static.eff_balance, h), VALIDATOR_REGISTRY_LIMIT_LOG2)]
    if "inactivity_scores" in slot_of:
        lists.append((*u64_subtree(scores, n, h), BALANCE_LIMIT_CHUNKS_LOG2))
    roots = list_roots(lists, arrays, h)
    chunks = arrays.top_chunks.clone()
    chunks[slot_of["validators"]] = roots[0]
    if "inactivity_scores" in slot_of:
        chunks[slot_of["inactivity_scores"]] = roots[1]
    for slot, root in small_dynamic_roots(slot_of, just, h).items():
        chunks[slot] = root
    return SlotRootCtx(
        top_chunks=chunks, zerohashes=arrays.zerohashes, len_chunk=arrays.len_chunk,
        top_depth=meta.top_depth, n=n, slot_field_index=state_fields(fork).index("slot"),
        balances_slot=slot_of["balances"],
        cur_part_slot=slot_of["current_epoch_participation"],
        prev_part_slot=slot_of["previous_epoch_participation"],
    )


def slot_root(ctx: SlotRootCtx, balance, cur_part, prev_part, slot_no,
              h: Hashers = KERNELS) -> torch.Tensor:
    """The state root after a slot, int32[8]: the balance and both
    participation list roots (each folded to its limit, one hash launch a
    level for the three, then the length mixed in) and the slot number
    written over the epoch's top chunks, then the top container."""
    n = ctx.n
    roots, depths = zip(u64_subtree(balance, n, h), u8_subtree(cur_part, n, h),
                        u8_subtree(prev_part, n, h))
    limits = (BALANCE_LIMIT_CHUNKS_LOG2, PARTICIPATION_LIMIT_CHUNKS_LOG2,
              PARTICIPATION_LIMIT_CHUNKS_LOG2)
    lists = mix_length(torch.stack(fold_many(roots, depths, limits, ctx.zerohashes, h)),
                       ctx.len_chunk, h)
    chunks = ctx.top_chunks.clone()
    chunks[ctx.slot_field_index] = u64_chunk_words(torch.as_tensor(slot_no).reshape(1))[0]
    chunks[ctx.balances_slot] = lists[0]
    chunks[ctx.cur_part_slot] = lists[1]
    chunks[ctx.prev_part_slot] = lists[2]
    return h.tree_root(chunks, ctx.top_depth)


# ------------------------------------------------------------- ingest -----


def synthetic_block_columns(params: BlockEpochParams, n: int, seed: int = 0,
                            atts_per_slot: int = 128, device=None):
    """Bench-scale inputs without an object state, on ``device``: every slot
    carries ``atts_per_slot`` full attestations over disjoint committees,
    ~1/4 of rows continuing into the next row's aggregate, a full sync
    aggregate (indices drawn with replacement), 16 deposits; a stripe of
    near-zero balances; FAR_FUTURE withdrawable epochs but for ~0.1%
    withdrawable at epoch 10. The arrays are the JAX package's
    ``synthetic_block_columns(spec, n, seed, ...)`` word for word: the same
    numpy generator, drawn in its order. Returns (BlockColumns, BlockState,
    BlockEpochStatic)."""
    dev = default_device(device)
    S = params.slots_per_epoch
    rng = np.random.default_rng(seed)
    cap = max(8, int(np.ceil(n / (S * max(atts_per_slot // 2, 1)))))
    A, C = atts_per_slot, 1 << (cap - 1).bit_length()

    att_idx = np.full((S, A, C), n, np.uint32)
    att_bits = np.zeros((S, A, C), bool)
    for s in range(S):
        perm = rng.permutation(n).astype(np.uint32)
        rows = max(min(A, n // C), 1)
        flat = perm[: rows * C]
        committees = np.full((rows, C), n, np.uint32)
        committees.ravel()[: flat.shape[0]] = flat
        reps = -(-A // rows)  # re-vote committees until A attestations exist
        att_idx[s] = np.tile(committees, (reps, 1))[:A]
        att_bits[s] = rng.random((A, C)) < 0.9
    att_flags = np.full((S, A), 0b111, np.uint8)
    att_is_current = rng.random((S, A)) < 0.7
    att_pay = rng.random((S, A)) < 0.75
    att_pay[:, -1] = True
    for a in range(1, A):
        cont = ~att_pay[:, a - 1]
        att_is_current[cont, a] = att_is_current[cont, a - 1]

    SY = params.sync_committee_size
    proposer = rng.integers(0, n, S, dtype=np.int64)
    sync_idx = rng.integers(0, n, (S, SY), dtype=np.int64)
    sync_bits = rng.random((S, SY)) < 0.95
    dep_idx = rng.integers(0, n, (S, 16), dtype=np.int64)
    dep_amt = rng.integers(1, 32_000_000_000, (S, 16), dtype=np.int64)
    balance = rng.integers(31_000_000_000, 33_000_000_000, n, dtype=np.int64)
    stripe = balance[:: max(n // 17, 1)]
    balance[:: max(n // 17, 1)] = rng.integers(0, 3, stripe.shape[0], dtype=np.int64)
    prev_part = rng.integers(0, 8, n, dtype=np.int64).astype(np.uint8)
    eff = np.minimum(balance // 1_000_000_000 * 1_000_000_000, params.max_effective_balance)
    wd_epoch = np.full(n, -1, np.int64)  # FAR_FUTURE_EPOCH, 2^64 - 1
    wd_epoch[rng.random(n) < 0.001] = 1

    def t(a, dtype):
        return torch.from_numpy(np.ascontiguousarray(a).astype(dtype)).to(dev)

    cols = BlockColumns(
        att_idx=t(att_idx, np.int32), att_bits=t(att_bits, bool), att_flags=t(att_flags, np.uint8),
        att_is_current=t(att_is_current, bool), att_pay=t(att_pay, bool),
        proposer=t(proposer, np.int32), sync_idx=t(sync_idx, np.int32),
        sync_bits=t(sync_bits, bool), dep_idx=t(dep_idx, np.int32), dep_amt=t(dep_amt, np.int64),
    )
    zero = torch.zeros((), dtype=torch.int64, device=dev)
    st0 = BlockState(balance=t(balance, np.int64), cur_part=t(np.zeros(n, np.uint8), np.uint8),
                     prev_part=t(prev_part, np.uint8), next_wd_index=zero,
                     next_wd_validator=zero.clone())
    static = make_epoch_static(params, t(eff, np.int64), t(wd_epoch, np.int64),
                               t(np.ones(n, bool), bool), 10)
    return cols, st0, static
