"""The port's CUDA kernels against their plain torch versions on the card.

Every test here needs an NVIDIA GPU and skips without one. The file imports
neither JAX nor the JAX package, so it also runs where only the port is
installed, e.g. on the H100:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q
"""

import hashlib

import numpy as np
import pytest
import torch

from eth_consensus_specs_tpu_torch import _ext
from eth_consensus_specs_tpu_torch.config import epoch_params
from eth_consensus_specs_tpu_torch.inputs import ALTAIR_CORNERS, altair_corner_inputs, example_altair_inputs
from eth_consensus_specs_tpu_torch.ops import altair_epoch as tae
from eth_consensus_specs_tpu_torch.ops import merkle
from eth_consensus_specs_tpu_torch.ops import state_root as tsr
from eth_consensus_specs_tpu_torch.ops.sha256 import sha256_pairs, sha256_pairs_ref
from eth_consensus_specs_tpu_torch.parallel import resident

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _words(rows: int, cols: int, seed: int) -> torch.Tensor:
    rng = np.random.default_rng(seed)
    return torch.from_numpy(
        rng.integers(0, 2**32, size=(rows, cols), dtype=np.uint64).astype(np.uint32).view(np.int32)
    )


@pytest.mark.parametrize("n", [1, 4, 257, 4096])
def test_sha256_pairs_kernel(cuda, n):
    msgs = _words(n, 16, n)
    got = sha256_pairs(msgs.to(cuda)).cpu()
    assert torch.equal(got, sha256_pairs_ref(msgs))
    m = msgs[0].numpy().view(np.uint32).astype(">u4").tobytes()
    assert got[0].numpy().view(np.uint32).astype(">u4").tobytes() == hashlib.sha256(m).digest()


def test_sha256_pairs_rejects_bad_input(cuda):
    with pytest.raises(ValueError):
        sha256_pairs(torch.zeros((4, 16), dtype=torch.int64, device=cuda))
    with pytest.raises(ValueError):
        sha256_pairs(torch.zeros((4, 8), dtype=torch.int32, device=cuda))


@pytest.mark.parametrize("depth", [0, 1, 5, 9, 10, 14])
def test_tree_root_kernel(cuda, depth):
    leaves = _words(1 << depth, 8, depth)
    assert torch.equal(merkle.tree_root(leaves.to(cuda), depth).cpu(),
                       merkle.tree_root_ref(leaves, depth))


@pytest.mark.parametrize("n", [1, 1000, 1024])
def test_validator_leaves_kernel(cuda, n):
    arrays, _ = tsr.synthetic_static(n, seed=n, device="cpu")
    cols, _ = example_altair_inputs(n, device="cpu")
    depth = max(n - 1, 0).bit_length()
    slashed = _words(n, 8, 99)  # any chunk content: the kernel hashes what it is given
    args = (cols.effective_balance, slashed, arrays.val_node_a, arrays.val_node_f, depth)
    got = tsr.validator_leaves(*(a.to(cuda) if torch.is_tensor(a) else a for a in args))
    assert torch.equal(got.cpu(), tsr.validator_leaves_ref(*args))


@pytest.mark.parametrize("fork", ["deneb", "electra"])
@pytest.mark.parametrize("epoch", [0, 1, 10])
def test_altair_epoch_kernel(cuda, fork, epoch):
    params = epoch_params(fork, "mainnet")
    cols, just = example_altair_inputs(1000, epoch=max(epoch, 3), electra=fork == "electra",
                                       device=cuda)
    just = just._replace(current_epoch=torch.tensor(epoch, dtype=torch.int64, device=cuda))
    got = tae.altair_epoch_accounting(params, cols, just)
    want = tae.altair_epoch_accounting_ref(params, cols, just)
    for name in want._fields:
        assert torch.equal(getattr(got, name), getattr(want, name)), name


@pytest.mark.parametrize("fork", ["deneb", "electra"])
@pytest.mark.parametrize("case", ALTAIR_CORNERS)
def test_altair_epoch_kernel_corners(cuda, fork, case):
    """The kernel's branches that the example columns never take: genesis
    epochs, the inactivity leak, every validator slashed, FAR_FUTURE_EPOCH
    lanes with u64 products that wrap and dividends past 2^63."""
    params = epoch_params(fork, "mainnet")
    cols, just = altair_corner_inputs(case, 1000, electra=fork == "electra", device=cuda)
    got = tae.altair_epoch_accounting(params, cols, just)
    want = tae.altair_epoch_accounting_ref(params, cols, just)
    for name in want._fields:
        assert torch.equal(getattr(got, name), getattr(want, name)), name


def test_state_root_kernel_path(cuda):
    arrays, meta = tsr.synthetic_static(1000, seed=4, device=cuda)
    cols, just = example_altair_inputs(1000, device=cuda)
    args = (arrays, meta, cols.balance, cols.effective_balance, cols.inactivity_scores, just)
    assert torch.equal(tsr.post_epoch_state_root(*args), tsr.post_epoch_state_root_ref(*args))


def test_run_epochs_card_matches_cpu_and_counts_launches(cuda):
    params = epoch_params("deneb", "mainnet")
    cols, just = example_altair_inputs(1024, device="cpu")
    static = tsr.synthetic_static(1024, seed=2, device="cpu")
    _ext.reset_launches()
    got = resident.run_epochs(params, cols, just, 2, with_root="state", static=static, device=cuda)
    counts = dict(_ext.launches)
    want = resident.run_epochs(params, cols, just, 2, with_root="state", static=static, device="cpu")
    assert torch.equal(got.root_acc.cpu(), want.root_acc)
    assert torch.equal(got.cols.balance.cpu(), want.cols.balance)
    assert set(counts) == {"sha256", "merkle", "validator_leaves", "altair_epoch"}
    assert counts["altair_epoch"] == 4 and counts["validator_leaves"] == 2
