"""The port stands alone: none of its modules, nor chip_smoke.py, loads JAX or the JAX
package; its entry points refuse to fall back to the CPU; chip_smoke.py fails without a
card and outside the repository."""

import os
import shutil
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]

_IMPORT_ALL = r"""
import importlib, pkgutil, sys
import eth_consensus_specs_tpu_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for name in names:
    importlib.import_module(name)
import chip_smoke  # noqa: F401
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith("jax.") or m == "jaxlib" or m.startswith("jaxlib.")
             or m == "eth_consensus_specs_tpu" or m.startswith("eth_consensus_specs_tpu."))
print(",".join(names))
print(len(names))
print(",".join(bad))
"""


def _env(**extra):
    env = dict(os.environ, PYTHONPATH=str(REPO), CUDA_VISIBLE_DEVICES="", **extra)
    env.pop("JAX_PLATFORMS", None)
    return env


def _run(args, cwd=REPO, **kw):
    return subprocess.run(args, cwd=cwd, env=_env(), capture_output=True, text=True,
                          timeout=120, **kw)


def test_port_imports_neither_jax_nor_the_jax_package():
    out = _run([sys.executable, "-c", _IMPORT_ALL])
    assert out.returncode == 0, out.stderr
    names, count, bad = out.stdout.splitlines()[-3:]
    assert int(count) >= 16  # incl. ops.merkle_inc and ops.snapshot
    assert {"eth_consensus_specs_tpu_torch.ops.slot_pipeline",
            "eth_consensus_specs_tpu_torch.serve.slot"} <= set(names.split(","))
    assert bad == "", f"port pulled in: {bad}"


def test_run_epochs_without_device_raises_when_cuda_is_absent():
    code = (
        "from eth_consensus_specs_tpu_torch.parallel.resident import run_epochs\n"
        "from eth_consensus_specs_tpu_torch.inputs import example_altair_inputs\n"
        "from eth_consensus_specs_tpu_torch.config import epoch_params\n"
        "cols, just = example_altair_inputs(64, device='cpu')\n"
        "try:\n"
        "    run_epochs(epoch_params('deneb', 'mainnet'), cols, just, 1, with_root=False)\n"
        "except RuntimeError as e:\n"
        "    print('raised:', e)\n"
    )
    out = _run([sys.executable, "-c", code])
    assert out.returncode == 0, out.stderr
    assert "raised: CUDA is not available" in out.stdout


def test_slot_world_without_device_raises_when_cuda_is_absent():
    code = (
        "from eth_consensus_specs_tpu_torch.serve.slot import SlotWorld\n"
        "try:\n"
        "    SlotWorld(64)\n"
        "except RuntimeError as e:\n"
        "    print('raised:', e)\n"
    )
    out = _run([sys.executable, "-c", code])
    assert out.returncode == 0, out.stderr
    assert "raised: CUDA is not available" in out.stdout


def test_chip_smoke_fails_without_a_card():
    out = _run([sys.executable, "chip_smoke.py"])
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout


def test_chip_smoke_fails_outside_the_repository(tmp_path):
    shutil.copy(REPO / "chip_smoke.py", tmp_path / "chip_smoke.py")
    env = _env()
    env.pop("PYTHONPATH")
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout
