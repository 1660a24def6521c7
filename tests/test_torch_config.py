"""The port's own copy of the slice's constants (eth_consensus_specs_tpu_torch/config.py)
equals what the JAX package reads from its presets and spec classes."""

import dataclasses

import pytest

from eth_consensus_specs_tpu.forks import get_spec
from eth_consensus_specs_tpu.ops.altair_epoch import AltairEpochParams
from eth_consensus_specs_tpu.ops.block_epoch import BlockEpochParams
from eth_consensus_specs_tpu.ops.state_columns import EpochParams
from eth_consensus_specs_tpu_torch import config


@pytest.mark.parametrize("preset", ["mainnet", "minimal"])
@pytest.mark.parametrize("fork", ["altair", "deneb", "electra"])
def test_epoch_params_match_spec(fork, preset):
    want = dataclasses.asdict(AltairEpochParams.from_spec(get_spec(fork, preset)))
    assert dataclasses.asdict(config.epoch_params(fork, preset)) == want


@pytest.mark.parametrize("preset", ["mainnet", "minimal"])
@pytest.mark.parametrize("fork", ["altair", "deneb", "electra"])
def test_block_epoch_params_match_spec(fork, preset):
    want = dataclasses.asdict(BlockEpochParams.from_spec(get_spec(fork, preset)))
    assert dataclasses.asdict(config.block_epoch_params(fork, preset)) == want


@pytest.mark.parametrize("preset", ["mainnet", "minimal"])
def test_phase0_params_and_round_count_match_spec(preset):
    spec = get_spec("phase0", preset)
    want = dataclasses.asdict(EpochParams.from_spec(spec))
    assert dataclasses.asdict(config.phase0_epoch_params(preset)) == want
    assert config.shuffle_round_count(preset) == spec.SHUFFLE_ROUND_COUNT


@pytest.mark.parametrize("fork", ["altair", "deneb", "electra"])
def test_state_fields_match_spec(fork):
    fields = list(get_spec(fork, "mainnet").BeaconState.fields())
    assert list(config.state_fields(fork)) == fields
    assert config.top_depth(fork) == max(len(fields) - 1, 0).bit_length()


def test_field_counts():
    assert len(config.state_fields("altair")) == 24 and config.top_depth("altair") == 5
    assert len(config.state_fields("deneb")) == 28 and config.top_depth("deneb") == 5
    assert len(config.state_fields("electra")) == 37 and config.top_depth("electra") == 6


def test_unknown_fork_or_preset_raises():
    with pytest.raises(ValueError):
        config.epoch_params("phase0", "mainnet")
    with pytest.raises(ValueError):
        config.epoch_params("deneb", "gnosis")
    with pytest.raises(ValueError):
        config.state_fields("capella")
    with pytest.raises(ValueError):
        config.phase0_epoch_params("gnosis")
    with pytest.raises(ValueError):
        config.shuffle_round_count("gnosis")
    with pytest.raises(ValueError):
        config.block_epoch_params("phase0", "mainnet")


@pytest.mark.parametrize("env", [
    {},
    {"ETH_SPECS_INC_DIRTY_BUCKETS": "3,100,5000", "ETH_SPECS_INC_CROSSOVER": "0.5"},
    {"ETH_SPECS_INC_DIRTY_BUCKETS": "x", "ETH_SPECS_INC_CROSSOVER": "y"},
], ids=["default", "overridden", "malformed"])
def test_incremental_buckets_match_jax(monkeypatch, env):
    """The dirty-capacity buckets and the crossover model, and their
    environment reads, equal serve/buckets.py's, so both packages plan the
    same forest."""
    from eth_consensus_specs_tpu.serve import buckets

    for name, value in env.items():
        monkeypatch.setenv(name, value)
    assert config.inc_dirty_buckets() == buckets.inc_dirty_buckets()
    assert config.inc_crossover() == buckets.inc_crossover()
    for n in (0, 1, 8, 9, 700, 4096, 70000, 10**6):
        assert config.inc_dirty_bucket(n) == buckets.inc_dirty_bucket(n)
        assert config.pow2_bucket(max(n, 1)) == buckets.pow2_bucket(max(n, 1))
    for depth, cap, leaf in ((4, 8, 0), (6, 8, 3), (18, 1024, 0), (20, 4096, 3), (20, 65536, 3)):
        assert config.inc_dense_count(depth, cap, leaf) == buckets.inc_dense_count(depth, cap, leaf)
