"""The port's own copy of the constants the slice needs.

Values are those of the consensus-spec presets and configs
(``presets/{mainnet,minimal}/*.yaml``, ``configs/*.yaml``) as the JAX
package's ``AltairEpochParams.from_spec(get_spec(fork, preset))`` reads
them, and the ``BeaconState`` field order of each fork. The tests hold
every entry here against the JAX package's spec objects.
"""

from __future__ import annotations

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


# Shared by every (fork, preset) of the slice; the forks differ only in the
# slashing rounding, the presets only in the slashings-vector length.
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
_ELECTRA = {"deneb": False, "electra": True}

_DENEB_FIELDS = (
    "genesis_time", "genesis_validators_root", "slot", "fork",
    "latest_block_header", "block_roots", "state_roots", "historical_roots",
    "eth1_data", "eth1_data_votes", "eth1_deposit_index", "validators",
    "balances", "randao_mixes", "slashings", "previous_epoch_participation",
    "current_epoch_participation", "justification_bits",
    "previous_justified_checkpoint", "current_justified_checkpoint",
    "finalized_checkpoint", "inactivity_scores", "current_sync_committee",
    "next_sync_committee", "latest_execution_payload_header",
    "next_withdrawal_index", "next_withdrawal_validator_index",
    "historical_summaries",
)
_ELECTRA_FIELDS = _DENEB_FIELDS + (
    "deposit_requests_start_index", "deposit_balance_to_consume",
    "exit_balance_to_consume", "earliest_exit_epoch",
    "consolidation_balance_to_consume", "earliest_consolidation_epoch",
    "pending_deposits", "pending_partial_withdrawals", "pending_consolidations",
)
_FIELDS = {"deneb": _DENEB_FIELDS, "electra": _ELECTRA_FIELDS}

FORKS = tuple(_FIELDS)
PRESETS = tuple(_SLASHINGS_VECTOR)


def epoch_params(fork: str, preset: str) -> AltairEpochParams:
    """The accounting-epoch constants of ``fork`` under ``preset``."""
    if fork not in _ELECTRA or preset not in _SLASHINGS_VECTOR:
        raise ValueError(f"unsupported fork/preset {fork!r}/{preset!r}")
    return AltairEpochParams(
        **_COMMON,
        epochs_per_slashings_vector=_SLASHINGS_VECTOR[preset],
        electra_slashing=_ELECTRA[fork],
    )


def state_fields(fork: str) -> tuple:
    """``BeaconState`` field names of ``fork``, in container order."""
    if fork not in _FIELDS:
        raise ValueError(f"unsupported fork {fork!r}")
    return _FIELDS[fork]


def top_depth(fork: str) -> int:
    """Depth of the ``BeaconState`` container tree (28 fields -> 5, 37 -> 6)."""
    return max(len(state_fields(fork)) - 1, 0).bit_length()
