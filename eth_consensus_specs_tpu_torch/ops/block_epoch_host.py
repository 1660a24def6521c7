"""Numpy and hashlib oracle of the block-epoch plane (``ops/block_epoch.py``).

The port's own copy of ``eth_consensus_specs_tpu/ops/block_epoch_host.py``
(``base_reward_column_np`` :20, ``sync_rewards_np`` :27,
``replay_block_epoch_np`` :46, ``slot_root_fn_np`` :215): a sequential
replay of the slots in numpy uint64, and per-slot state roots whose trees
hash with ``hashlib`` (the JAX copy hashes through the JAX package's native
SHA and ``state_root_host``, which the port does not import). It is the
oracle of the tests and of ``chip_smoke.py``; the device path never falls
back to it.

Inputs are the port's tensors or numpy arrays; int64 and int32 carriers
are read back as the uint64 and uint32 they carry.
"""

from __future__ import annotations

import hashlib
import math

import numpy as np

from ..config import BlockEpochParams, state_fields
from ..convert import to_numpy
from .merkle import zerohashes
from .state_root import (
    BALANCE_LIMIT_CHUNKS_LOG2,
    PARTICIPATION_LIMIT_CHUNKS_LOG2,
    VALIDATOR_REGISTRY_LIMIT_LOG2,
)


def _u(x) -> np.ndarray:
    a = to_numpy(x) if not isinstance(x, np.ndarray) else x
    a = np.asarray(a)
    return a.view({np.dtype(np.int64): np.uint64, np.dtype(np.int32): np.uint32}.get(a.dtype,
                                                                                        a.dtype))


def base_reward_column_np(params: BlockEpochParams, eff: np.ndarray, total: int):
    per_inc = (params.effective_balance_increment * params.base_reward_factor) // math.isqrt(total)
    return (eff // np.uint64(params.effective_balance_increment)) * np.uint64(per_inc)


def sync_rewards_np(params: BlockEpochParams, total: int):
    per_inc = (params.effective_balance_increment * params.base_reward_factor) // math.isqrt(total)
    total_base = per_inc * (total // params.effective_balance_increment)
    max_part = (total_base * params.sync_reward_weight // params.weight_denominator
                // params.slots_per_epoch)
    part = max_part // params.sync_committee_size
    prop = part * params.proposer_weight // (params.weight_denominator - params.proposer_weight)
    return int(part), int(prop)


def replay_block_epoch_np(params: BlockEpochParams, n: int, st0, blocks, eff, withdrawable_epoch,
                          has_eth1_cred, epoch: int, with_withdrawals: bool = True, root_fn=None):
    """Sequential numpy replay of ``block_epoch_chain``. With
    ``root_fn(balance, cur_part, prev_part, slot_no) -> uint32[8]`` the
    per-slot root xor-chain is accumulated too. Returns (balance, cur_part,
    prev_part, next_wd_index, next_wd_validator, root_acc), numpy uint64 /
    uint8 / ints / uint32[8]."""
    bal = np.array(_u(st0.balance), np.uint64, copy=True)
    cur = np.array(_u(st0.cur_part), np.uint8, copy=True)
    prev = np.array(_u(st0.prev_part), np.uint8, copy=True)
    wd_index = int(_u(st0.next_wd_index))
    wd_validator = int(_u(st0.next_wd_validator))
    eff, withdrawable_epoch = _u(eff), _u(withdrawable_epoch)
    has_eth1_cred = np.asarray(_u(has_eth1_cred), bool)
    total = max(int(eff.sum(dtype=np.uint64)), params.effective_balance_increment)
    base_reward = base_reward_column_np(params, eff, total)
    part_r, prop_r = sync_rewards_np(params, total)
    denom = ((params.weight_denominator - params.proposer_weight) * params.weight_denominator
             // params.proposer_weight)
    acc = np.zeros(8, np.uint32)
    b = [_u(t) for t in (blocks.att_idx, blocks.att_bits, blocks.att_flags, blocks.att_is_current,
                         blocks.att_pay, blocks.proposer, blocks.sync_idx, blocks.sync_bits,
                         blocks.dep_idx, blocks.dep_amt)]
    att_idx, att_bits, att_flags, att_cur, att_pay, proposers, sync_idx, sync_bits, dep_idx, \
        dep_amt = b
    max_eb = np.uint64(params.max_effective_balance)
    slot_no = epoch * params.slots_per_epoch + 1
    for s in range(proposers.shape[0]):
        # withdrawals sweep (forks/capella.py:223-281)
        if with_withdrawals:
            bound = min(n, params.max_validators_per_withdrawals_sweep)
            window = (wd_validator + np.arange(bound)) % n
            wbal = bal[window]
            full = (has_eth1_cred[window] & (withdrawable_epoch[window] <= np.uint64(epoch))
                    & (wbal > 0))
            partial = has_eth1_cred[window] & (eff[window] == max_eb) & (wbal > max_eb)
            rank = np.cumsum(full | partial)
            take = (full | partial) & (rank <= params.max_withdrawals_per_payload)
            bal[window[take]] = np.where(full[take], np.uint64(0), max_eb)
            n_taken = int(min(rank[-1], params.max_withdrawals_per_payload))
            if n_taken == params.max_withdrawals_per_payload:
                last_pos = int(np.max(np.nonzero(take)[0], initial=0))
                wd_validator = (wd_validator + last_pos + 1) % n
            else:
                wd_validator = (wd_validator + params.max_validators_per_withdrawals_sweep) % n
            wd_index += n_taken

        # attestations in block order; the numerator carries across an
        # aggregate's per-committee rows and divides once at its pay row
        proposer = int(proposers[s])
        carry_num = 0
        for a in range(att_idx.shape[1]):
            flags = int(att_flags[s, a])
            if flags:
                idx = att_idx[s, a]
                li = idx[(idx < n) & att_bits[s, a]].astype(np.int64)
                part = cur if att_cur[s, a] else prev
                pre = part[li]
                new_bits = np.uint8(flags) & ~pre
                part[li] = pre | new_bits
                weight = np.zeros(li.shape[0], np.uint64)
                for bit, w in enumerate(params.weights):
                    weight += np.where((new_bits >> bit) & 1, np.uint64(w), np.uint64(0))
                carry_num += int((weight * base_reward[li]).sum(dtype=np.uint64))
            if att_pay[s, a]:
                bal[proposer] += np.uint64((carry_num % (1 << 64)) // denom)
                carry_num = 0

        # deposits (existing-key top-ups)
        for j in range(dep_idx.shape[1]):
            if dep_idx[s, j] < n:
                bal[int(dep_idx[s, j])] += dep_amt[s, j]

        # sync aggregate, one operation per committee position
        for pos in range(sync_idx.shape[1]):
            i = int(sync_idx[s, pos])
            if sync_bits[s, pos]:
                bal[i] += np.uint64(part_r)
                bal[proposer] += np.uint64(prop_r)
            else:
                bal[i] = bal[i] - np.uint64(part_r) if bal[i] >= part_r else np.uint64(0)

        if root_fn is not None:
            acc = acc ^ root_fn(bal, cur, prev, slot_no)
        slot_no += 1
    return bal, cur, prev, wd_index, wd_validator, acc


# ------------------------------------------------------- hashlib trees --


def _h(a: bytes, b: bytes) -> bytes:
    return hashlib.sha256(a + b).digest()


def tree_root_bytes(chunks: list, depth: int) -> bytes:
    """Merkle root of 32-byte chunks padded with zero chunks to 2^depth."""
    z = zerohashes()
    level = list(chunks)
    for d in range(depth):
        if len(level) % 2:
            level.append(z[d])
        level = [_h(level[i], level[i + 1]) for i in range(0, len(level), 2)]
    return level[0] if level else z[depth]


def _chunks(raw: bytes) -> list:
    raw += b"\x00" * (-len(raw) % 32)
    return [raw[i:i + 32] for i in range(0, len(raw), 32)]


def list_root_bytes(chunks: list, n: int, limit_log2: int) -> bytes:
    """A list's root: the chunk tree at its own depth, folded to the limit
    with zero-hash siblings, the length mixed in."""
    z = zerohashes()
    depth = max(len(chunks) - 1, 0).bit_length()
    root = tree_root_bytes(chunks, depth)
    for d in range(depth, limit_log2):
        root = _h(root, z[d])
    return _h(root, int(n).to_bytes(8, "little") + b"\x00" * 24)


def u64_chunk(v: int) -> bytes:
    return int(v).to_bytes(8, "little") + b"\x00" * 24


def words(root: bytes) -> np.ndarray:
    return np.frombuffer(root, dtype=">u4").astype(np.uint32)


def _word_bytes(w) -> bytes:
    return np.asarray(_u(w), np.uint32).astype(">u4").tobytes()


def validator_registry_root_bytes(val_node_a, val_node_f, slashed_chunk, eff) -> bytes:
    """List[Validator] root from the static nodes A, F and the slashed
    chunk (int32 words) and the effective balances: H(H(A, H(eb, slashed)),
    F) per validator, then the list root."""
    a, f, sl = (_word_bytes(x) for x in (val_node_a, val_node_f, slashed_chunk))
    eff = _u(eff)
    leaves = [_h(_h(a[32 * i:32 * i + 32], _h(u64_chunk(int(e)), sl[32 * i:32 * i + 32])),
                 f[32 * i:32 * i + 32]) for i, e in enumerate(eff.tolist())]
    return list_root_bytes(leaves, len(leaves), VALIDATOR_REGISTRY_LIMIT_LOG2)


def checkpoint_root_bytes(epoch: int, root: np.ndarray) -> bytes:
    return _h(u64_chunk(epoch), np.asarray(root, np.uint8).tobytes())


class SlotRootFn:
    """``root_fn(balance, cur_part, prev_part, slot_no) -> uint32[8]``: the
    state root after a slot, the epoch's top chunks filled, the three dirty
    columns rooted with hashlib. Picklable, so a pool can root slots in
    parallel."""

    def __init__(self, chunks: list, n: int, top_depth: int, slot_field: int, slot_of: dict):
        self.chunks, self.n, self.top_depth = chunks, n, top_depth
        self.slot_field, self.slot_of = slot_field, slot_of

    def __call__(self, bal, cur, prev, slot_no) -> np.ndarray:
        c = list(self.chunks)
        c[self.slot_field] = u64_chunk(int(slot_no))
        c[self.slot_of["balances"]] = list_root_bytes(
            _chunks(np.asarray(bal, np.uint64).astype("<u8").tobytes()), self.n,
            BALANCE_LIMIT_CHUNKS_LOG2)
        for field, col in (("current_epoch_participation", cur),
                           ("previous_epoch_participation", prev)):
            c[self.slot_of[field]] = list_root_bytes(
                _chunks(np.asarray(col, np.uint8).tobytes()), self.n,
                PARTICIPATION_LIMIT_CHUNKS_LOG2)
        return words(tree_root_bytes(c, self.top_depth))


def slot_root_fn_np(fork: str, arrays, meta, static, scores, just) -> SlotRootFn:
    """Host mirror of ``make_root_ctx`` + ``slot_root``: the epoch's top
    chunks (the validator registry, the inactivity scores, the justification
    bits and the checkpoints) filled once with hashlib."""
    n = meta.n_validators
    slot_of = {name: i for i, name in meta.dynamic_slots}
    top = np.asarray(_u(arrays.top_chunks), np.uint32).astype(">u4")
    chunks = [top[i].tobytes() for i in range(1 << meta.top_depth)]
    chunks[slot_of["validators"]] = validator_registry_root_bytes(
        arrays.val_node_a, arrays.val_node_f, arrays.slashed_chunk, static.eff_balance)
    if "inactivity_scores" in slot_of:
        chunks[slot_of["inactivity_scores"]] = list_root_bytes(
            _chunks(_u(scores).astype("<u8").tobytes()), n, BALANCE_LIMIT_CHUNKS_LOG2)
    bits = np.asarray(_u(just.justification_bits), bool)
    chunks[slot_of["justification_bits"]] = bytes([sum(int(b) << i for i, b in
                                                        enumerate(bits[:4]))]) + b"\x00" * 31
    for field, epoch, root in (
            ("previous_justified_checkpoint", just.prev_justified_epoch, just.prev_justified_root),
            ("current_justified_checkpoint", just.cur_justified_epoch, just.cur_justified_root),
            ("finalized_checkpoint", just.finalized_epoch, just.finalized_root)):
        chunks[slot_of[field]] = checkpoint_root_bytes(int(_u(epoch)), _u(root))
    return SlotRootFn(chunks, n, meta.top_depth, state_fields(fork).index("slot"), slot_of)
