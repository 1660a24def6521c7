"""Design model of K3's indexed entry (``csrc/validator_leaves.cu``
``validator_leaves_at_kernel``), run on the CPU in Python ints and hashlib:
every row written (zero past the count, for an index outside [0, N) and
under a closed gate), the first pair hash B = H(chunk(eff), slashed_chunk)
read from the table where the effective balance is a whole number of
increments up to 2048 and the slashed chunk is that of false or true, and
hashed otherwise. Held against the port's plain version, its plain table
and the JAX package's ``_validator_leaf_fn``; a model that reads every row
from the table must fail the corners."""

import hashlib
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eth_consensus_specs_tpu.ops import state_root as jsr
from eth_consensus_specs_tpu_torch.ops import state_root as tsr

M64 = (1 << 64) - 1
_SOURCE = (Path(tsr.__file__).parents[1] / "csrc" / "validator_leaves.cu").read_text()


def _const(name: str) -> int:
    return int(re.search(rf"constexpr \w+ {name} = (\w+?)(?:ull|u)?;", _SOURCE).group(1), 0)


INC, INCREMENTS, SLASHED_WORD = (_const(k) for k in ("kIncrement", "kTableIncrements",
                                                     "kSlashedWord"))
N = 64


def _be(words) -> bytes:
    return b"".join((int(w) & 0xFFFFFFFF).to_bytes(4, "big") for w in words)


def _h(a: bytes, b: bytes) -> bytes:
    return hashlib.sha256(a + b).digest()


def table_row_model(r: int) -> bytes:
    """The kernel's validator_b_table_kernel row r: its message words as the
    kernel sets them, hashed."""
    e = (r >> 1) * INC
    w = [0] * 16
    w[0] = int.from_bytes((e & 0xFFFFFFFF).to_bytes(4, "little"), "big")  # bswap32
    w[1] = int.from_bytes((e >> 32).to_bytes(4, "little"), "big")
    w[8] = SLASHED_WORD if r & 1 else 0
    return hashlib.sha256(_be(w)).digest()


TABLE = [table_row_model(r) for r in range(2 * (INCREMENTS + 1))]


def kernel_model(eff, slashed, node_a, node_f, idx, count=None, dense=-1,
                 every_row_from_table=False) -> list[bytes]:
    """validator_leaves_at_kernel on host ints: one row a thread, every row
    written. ``every_row_from_table`` reads B from the table for every row
    (the increment count clamped to the table), a wrong kernel."""
    cap = len(idx)
    live = cap if count is None else count
    gate = count is None or dense < 0 or count <= dense
    out = []
    for j in range(cap):
        i = idx[j]
        if not (gate and j < live and 0 <= i < len(eff)):
            out.append(bytes(32))
            continue
        e, s = eff[i] & M64, [int(x) & 0xFFFFFFFF for x in slashed[i]]
        k = e // INC
        canonical = not any(s[1:]) and s[0] in (0, SLASHED_WORD)
        if every_row_from_table:
            b = TABLE[2 * min(k, INCREMENTS) + (s[0] != 0)]
        elif canonical and k <= INCREMENTS and k * INC == e:
            b = TABLE[2 * k + (s[0] != 0)]
        else:
            b = _h(e.to_bytes(8, "little") + bytes(24), _be(s))
        out.append(_h(_h(_be(node_a[i]), b), _be(node_f[i])))
    return out


def _rows(t: torch.Tensor) -> list[bytes]:
    return [_be(r) for r in t.numpy().view(np.uint32)]


def test_constants_match_the_port():
    assert (INC, INCREMENTS, SLASHED_WORD) == (tsr.EFFECTIVE_BALANCE_INCREMENT,
                                               tsr.B_TABLE_INCREMENTS, tsr.SLASHED_WORD)
    assert len(TABLE) == tsr.B_TABLE_ROWS == 4098


@pytest.mark.parametrize("k", [0, 1, 16, 32, 2047, 2048])
@pytest.mark.parametrize("s", [0, 1])
def test_table_row_equals_the_pair_hash(k, s):
    """Row 2k + s, as the kernel builds it, is H(chunk(k * 10^9) || chunk(s)),
    SSZ's chunks by bytes, and the port's plain table's row."""
    want = _h((k * 10**9).to_bytes(8, "little") + bytes(24), bytes([s]) + bytes(31))
    assert TABLE[2 * k + s] == want
    assert _be(tsr.b_table_ref()[2 * k + s].numpy().view(np.uint32)) == want


def test_plain_table_is_every_row():
    assert _rows(tsr.b_table_ref()) == TABLE


def _corners(seed: int = 18):
    """N validators: rows on the table, then the corners off it."""
    rng = np.random.default_rng(seed)
    eff = [int(x) * INC for x in rng.integers(0, INCREMENTS + 1, N)]
    eff[:6] = [INC + 1, (INCREMENTS + 1) * INC, 1 << 63, M64, INCREMENTS * INC, 0]
    slashed = np.zeros((N, 8), np.uint32)
    slashed[rng.random(N) < 0.3, 0] = SLASHED_WORD
    slashed[:6] = 0
    slashed[6:9] = 0
    slashed[6, 5] = 1  # false's first word, another word set
    slashed[7, 0], slashed[7, 7] = SLASHED_WORD, 0x80000000  # true's, another word set
    slashed[8, 0] = SLASHED_WORD + 1  # not a bool's chunk
    node_a = rng.integers(0, 1 << 32, (N, 8), dtype=np.uint64).astype(np.uint32)
    node_f = rng.integers(0, 1 << 32, (N, 8), dtype=np.uint64).astype(np.uint32)
    return eff, slashed, node_a, node_f


CORNER_ROWS = {"not a multiple": 0, "2049 increments": 1, "2^63": 2, "2^64 - 1": 3,
               "false with a word set": 6, "true with a word set": 7, "not a bool": 8}


def _port(eff, slashed, node_a, node_f):
    e = torch.from_numpy(np.array(eff, np.uint64).view(np.int64))
    return e, *(torch.from_numpy(a.view(np.int32)) for a in (slashed, node_a, node_f))


GATES = [(None, -1), (40, -1), (40, 40), (40, 39), (0, -1), (200, -1)]


@pytest.mark.parametrize("count,dense", GATES)
def test_kernel_model_equals_plain_version(count, dense):
    eff, slashed, node_a, node_f = _corners()
    idx = list(range(N)) + [-1, N, N + 3, -(1 << 31), 5, 6, 7, 8]
    c = None if count is None else torch.tensor([count], dtype=torch.int32)
    want = tsr.validator_leaves_at_ref(*_port(eff, slashed, node_a, node_f),
                                       torch.tensor(idx, dtype=torch.int32), c, dense)
    assert kernel_model(eff, slashed, node_a, node_f, idx, count, dense) == _rows(want)


def test_kernel_model_equals_jax_leaf_fn():
    """JAX's _validator_leaf_fn over the leaf level (64 live rows, padded to
    128: an index past the registry reads a dead padding row)."""
    eff, slashed, node_a, node_f = _corners()
    lv = 2 * N
    pad = lambda a: np.concatenate([a, np.zeros((lv - N, *a.shape[1:]), a.dtype)])  # noqa: E731
    inputs = (jnp.asarray(pad(np.array(eff, np.uint64))), jnp.asarray(pad(slashed)),
              jnp.asarray(pad(node_a)), jnp.asarray(pad(node_f)), jnp.arange(lv) < N)
    idx = list(range(N)) + [N, N + 1, lv - 1, 3]
    want = np.asarray(jsr._validator_leaf_fn(inputs, jnp.asarray(idx, jnp.int32)))
    assert kernel_model(eff, slashed, node_a, node_f, idx) == [_be(r) for r in want]


def test_table_row_rule_of_the_port():
    """``b_table_row`` names the rows the kernel reads from the table, and
    -1 for each corner that it hashes."""
    eff, slashed, node_a, node_f = _corners()
    e, s, _, _ = _port(eff, slashed, node_a, node_f)
    rows = tsr.b_table_row(e, s).tolist()
    for i in range(N):
        sw = [int(x) for x in slashed[i]]
        k = eff[i] // INC
        hit = (not any(sw[1:]) and sw[0] in (0, SLASHED_WORD) and k <= INCREMENTS
               and k * INC == eff[i])
        assert rows[i] == (2 * k + (sw[0] != 0) if hit else -1), i
    assert all(rows[i] == -1 for i in CORNER_ROWS.values())
    assert rows[4] == 2 * INCREMENTS and rows[5] == 0


@pytest.mark.parametrize("corner", list(CORNER_ROWS))
def test_every_row_from_the_table_fails_the_corners(corner):
    eff, slashed, node_a, node_f = _corners()
    idx = [CORNER_ROWS[corner], 9, 10]
    right = kernel_model(eff, slashed, node_a, node_f, idx)
    wrong = kernel_model(eff, slashed, node_a, node_f, idx, every_row_from_table=True)
    assert wrong[0] != right[0] and wrong[1:] == right[1:]
