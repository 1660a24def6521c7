"""The port's own copy of the constants the slice needs.

Values are those of the consensus-spec presets and configs
(``presets/{mainnet,minimal}/*.yaml``, ``configs/*.yaml``) as the JAX
package's ``AltairEpochParams.from_spec(get_spec(fork, preset))`` reads
them, and the ``BeaconState`` field order of each fork. The tests hold
every entry here against the JAX package's spec objects.

It also keeps the phase0 accounting-epoch constants
(``EpochParams.from_spec(get_spec("phase0", preset))``), the shuffle's
round count, the incremental forest's dirty-capacity buckets and the
sparse/dense crossover model of ``serve/buckets.py`` (:118-169), with the
same environment reads, so the port plans the same forest as the JAX
package, the serving layer's flush buckets that the batched subtree
roots are padded to (``serve/config.py`` :149, :154; ``serve/buckets.py``
:47), and the block-epoch plane's constants
(``BlockEpochParams.from_spec(get_spec(fork, preset))`` of
``ops/block_epoch.py`` :59).
"""

from __future__ import annotations

import os
from dataclasses import dataclass

FAR_FUTURE_EPOCH = (1 << 64) - 1


@dataclass(frozen=True)
class AltairEpochParams:
    """Constants of the altair+ accounting epoch. Weights in flag order
    (source, target, head) per PARTICIPATION_FLAG_WEIGHTS."""

    effective_balance_increment: int
    base_reward_factor: int
    weights: tuple
    weight_denominator: int
    timely_head_flag_index: int
    min_epochs_to_inactivity_penalty: int
    inactivity_score_bias: int
    inactivity_score_recovery_rate: int
    inactivity_penalty_quotient: int
    proportional_slashing_multiplier: int
    epochs_per_slashings_vector: int
    hysteresis_quotient: int
    hysteresis_downward_multiplier: int
    hysteresis_upward_multiplier: int
    max_effective_balance: int
    # [Electra:EIP7251] per-increment slashing quantum
    electra_slashing: bool = False


# Shared by every (fork, preset) of the slice; the forks differ in the slashing
# rounding and, for altair, in two quotients (``_FORK``), the presets only in
# the slashings-vector length.
_COMMON = dict(
    effective_balance_increment=1_000_000_000,
    base_reward_factor=64,
    weights=(14, 26, 14),
    weight_denominator=64,
    timely_head_flag_index=2,
    min_epochs_to_inactivity_penalty=4,
    inactivity_score_bias=4,
    inactivity_score_recovery_rate=16,
    inactivity_penalty_quotient=16_777_216,  # INACTIVITY_PENALTY_QUOTIENT_BELLATRIX
    proportional_slashing_multiplier=3,  # PROPORTIONAL_SLASHING_MULTIPLIER_BELLATRIX
    hysteresis_quotient=4,
    hysteresis_downward_multiplier=1,
    hysteresis_upward_multiplier=5,
    max_effective_balance=32_000_000_000,
)
_SLASHINGS_VECTOR = {"mainnet": 8192, "minimal": 64}
_FORK = {
    "altair": dict(
        inactivity_penalty_quotient=3 * (1 << 24),  # INACTIVITY_PENALTY_QUOTIENT_ALTAIR
        proportional_slashing_multiplier=2,  # PROPORTIONAL_SLASHING_MULTIPLIER_ALTAIR
        electra_slashing=False,
    ),
    "deneb": dict(electra_slashing=False),
    "electra": dict(electra_slashing=True),
}


@dataclass(frozen=True)
class EpochParams:
    """Constants of the phase0 accounting epoch, under the JAX package's
    field names (``ops/state_columns.py`` ``EpochParams``)."""

    effective_balance_increment: int
    base_reward_factor: int
    base_rewards_per_epoch: int
    proposer_reward_quotient: int
    min_epochs_to_inactivity_penalty: int
    inactivity_penalty_quotient: int
    proportional_slashing_multiplier: int
    epochs_per_slashings_vector: int
    hysteresis_quotient: int
    hysteresis_downward_multiplier: int
    hysteresis_upward_multiplier: int
    max_effective_balance: int


_PHASE0_COMMON = dict(
    effective_balance_increment=1_000_000_000,
    base_reward_factor=64,
    base_rewards_per_epoch=4,
    proposer_reward_quotient=8,
    min_epochs_to_inactivity_penalty=4,
    hysteresis_quotient=4,
    hysteresis_downward_multiplier=1,
    hysteresis_upward_multiplier=5,
    max_effective_balance=32_000_000_000,
)
# the phase0 presets differ in these three only
_PHASE0_PRESET = {
    "mainnet": dict(inactivity_penalty_quotient=1 << 26, proportional_slashing_multiplier=1,
                    epochs_per_slashings_vector=8192),
    "minimal": dict(inactivity_penalty_quotient=1 << 25, proportional_slashing_multiplier=2,
                    epochs_per_slashings_vector=64),
}
@dataclass(frozen=True)
class BlockEpochParams:
    """Constants of the columnar block plane, under the JAX package's field
    names (``ops/block_epoch.py`` ``BlockEpochParams``). Weights in flag
    order (source, target, head)."""

    slots_per_epoch: int
    effective_balance_increment: int
    base_reward_factor: int
    weights: tuple
    weight_denominator: int
    proposer_weight: int
    sync_reward_weight: int
    sync_committee_size: int
    max_effective_balance: int
    max_withdrawals_per_payload: int
    max_validators_per_withdrawals_sweep: int


# the presets differ in the epoch's length, the sync committee and the sweep;
# pre-capella forks have no withdrawal sweep
_BLOCK_PRESET = {
    "mainnet": dict(slots_per_epoch=32, sync_committee_size=512, max_withdrawals_per_payload=16,
                    max_validators_per_withdrawals_sweep=16384),
    "minimal": dict(slots_per_epoch=8, sync_committee_size=32, max_withdrawals_per_payload=4,
                    max_validators_per_withdrawals_sweep=16),
}
_BLOCK_PRE_CAPELLA = ("altair",)

# SHUFFLE_ROUND_COUNT of each preset
SHUFFLE_ROUND_COUNT = {"mainnet": 90, "minimal": 10}

_ALTAIR_FIELDS = (
    "genesis_time", "genesis_validators_root", "slot", "fork",
    "latest_block_header", "block_roots", "state_roots", "historical_roots",
    "eth1_data", "eth1_data_votes", "eth1_deposit_index", "validators",
    "balances", "randao_mixes", "slashings", "previous_epoch_participation",
    "current_epoch_participation", "justification_bits",
    "previous_justified_checkpoint", "current_justified_checkpoint",
    "finalized_checkpoint", "inactivity_scores", "current_sync_committee",
    "next_sync_committee",
)
_DENEB_FIELDS = _ALTAIR_FIELDS + (
    "latest_execution_payload_header", "next_withdrawal_index",
    "next_withdrawal_validator_index", "historical_summaries",
)
_ELECTRA_FIELDS = _DENEB_FIELDS + (
    "deposit_requests_start_index", "deposit_balance_to_consume",
    "exit_balance_to_consume", "earliest_exit_epoch",
    "consolidation_balance_to_consume", "earliest_consolidation_epoch",
    "pending_deposits", "pending_partial_withdrawals", "pending_consolidations",
)
_FIELDS = {"altair": _ALTAIR_FIELDS, "deneb": _DENEB_FIELDS, "electra": _ELECTRA_FIELDS}

FORKS = tuple(_FIELDS)
PRESETS = tuple(_SLASHINGS_VECTOR)


def epoch_params(fork: str, preset: str) -> AltairEpochParams:
    """The accounting-epoch constants of ``fork`` under ``preset``."""
    if fork not in _FORK or preset not in _SLASHINGS_VECTOR:
        raise ValueError(f"unsupported fork/preset {fork!r}/{preset!r}")
    return AltairEpochParams(
        **{**_COMMON, **_FORK[fork]},
        epochs_per_slashings_vector=_SLASHINGS_VECTOR[preset],
    )


def phase0_epoch_params(preset: str) -> EpochParams:
    """The phase0 accounting-epoch constants under ``preset``."""
    if preset not in _PHASE0_PRESET:
        raise ValueError(f"unsupported preset {preset!r}")
    return EpochParams(**_PHASE0_COMMON, **_PHASE0_PRESET[preset])


def block_epoch_params(fork: str, preset: str) -> BlockEpochParams:
    """The block-plane constants of ``fork`` under ``preset``."""
    if fork not in _FORK or preset not in _BLOCK_PRESET:
        raise ValueError(f"unsupported fork/preset {fork!r}/{preset!r}")
    by_preset = dict(_BLOCK_PRESET[preset])
    if fork in _BLOCK_PRE_CAPELLA:
        by_preset.update(max_withdrawals_per_payload=0, max_validators_per_withdrawals_sweep=0)
    return BlockEpochParams(
        effective_balance_increment=1_000_000_000, base_reward_factor=64, weights=(14, 26, 14),
        weight_denominator=64, proposer_weight=8, sync_reward_weight=2,
        max_effective_balance=32_000_000_000, **by_preset)


def shuffle_round_count(preset: str) -> int:
    """SHUFFLE_ROUND_COUNT of ``preset``."""
    if preset not in SHUFFLE_ROUND_COUNT:
        raise ValueError(f"unsupported preset {preset!r}")
    return SHUFFLE_ROUND_COUNT[preset]


def state_fields(fork: str) -> tuple:
    """``BeaconState`` field names of ``fork``, in container order."""
    if fork not in _FIELDS:
        raise ValueError(f"unsupported fork {fork!r}")
    return _FIELDS[fork]


def top_depth(fork: str) -> int:
    """Depth of the ``BeaconState`` container tree (24 or 28 fields -> 5, 37 -> 6)."""
    return max(len(state_fields(fork)) - 1, 0).bit_length()


# ------------------------------------------------ serving flush buckets --
#
# The serving layer flushes hash requests in batches padded up to one of
# these sizes, so the batched subtree root (ops/merkle.py
# merkleize_many_device) sees few shapes; a subtree goes to the card once a
# flush holds at least DEVICE_SUBTREE_THRESHOLD leaf chunks.

DEVICE_SUBTREE_THRESHOLD = 4096
FLUSH_BUCKETS = (1, 2, 4, 8, 16, 32, 64)
MAX_BATCH = 64


# ------------------------------------------- incremental dirty buckets --
#
# The incremental forest (ops/merkle_inc.py) plans one dirty capacity per
# tree from a small pow2 set; the live dirty count is data, and past the
# crossover below an update rebuilds the tree densely instead of re-hashing
# dirty paths.

_INC_DIRTY_BUCKETS = (8, 64, 256, 1024, 4096, 16384, 65536)
# Work-ratio factor of the sparse/dense crossover: a sparse update costs
# about (depth + leaf_hashes + 1) compressions per dirty leaf, a dense
# rebuild 2^(depth+1); the path update keeps its advantage to about a
# quarter of break-even.
INC_CROSSOVER = 0.25


def pow2_bucket(n: int) -> int:
    """Smallest power of two >= n (n >= 1)."""
    return 1 << max(n - 1, 0).bit_length()


def batch_bucket(n: int, buckets: tuple[int, ...]) -> int:
    """Smallest bucket that holds n items; the largest caps it."""
    for b in buckets:
        if b >= n:
            return b
    return buckets[-1]


def inc_dirty_buckets() -> tuple[int, ...]:
    """The pow2 dirty-capacity buckets, ``ETH_SPECS_INC_DIRTY_BUCKETS``
    (comma-separated) when set and valid."""
    raw = os.environ.get("ETH_SPECS_INC_DIRTY_BUCKETS", "")
    if not raw:
        return _INC_DIRTY_BUCKETS
    try:
        vals = sorted({pow2_bucket(int(x)) for x in raw.split(",") if x.strip()})
    except ValueError:
        return _INC_DIRTY_BUCKETS
    return tuple(v for v in vals if v > 0) or _INC_DIRTY_BUCKETS


def inc_dirty_bucket(n_dirty: int) -> int:
    """Smallest dirty-capacity bucket holding ``n_dirty`` (the largest
    bucket caps it: past that the dense rebuild is the plan)."""
    return batch_bucket(max(int(n_dirty), 1), inc_dirty_buckets())


def inc_crossover() -> float:
    """Sparse/dense crossover factor, ``ETH_SPECS_INC_CROSSOVER`` when set
    and valid."""
    raw = os.environ.get("ETH_SPECS_INC_CROSSOVER", "")
    try:
        return float(raw) if raw else INC_CROSSOVER
    except ValueError:
        return INC_CROSSOVER


def inc_dense_count(depth: int, cap: int, leaf_hashes: int = 0) -> int:
    """Dirty count above which one dense rebuild of a depth-``depth`` tree
    beats the path update: break-even of 2^(depth+1) dense compressions
    against (depth + leaf_hashes + 1) per dirty leaf, scaled by
    ``inc_crossover()`` and capped at the capacity ``cap``."""
    dense_hashes = 2 << depth
    per_dirty = depth + leaf_hashes + 1
    return min(int(cap), max(1, int(inc_crossover() * dense_hashes / per_dirty)))
