"""Build, load and launch the hand-written CUDA kernels under ``csrc/``.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for ``sm_90a`` into its own
shared library with a plain C interface and loaded with ``ctypes``. The
libraries are built on first use on a CUDA tensor, all sources at once in
parallel, into ``_build/`` beside this file (git-ignored), under a name
that carries a digest of the sources, so an edited kernel is never served
by a stale library. Headers generated from Python (``GENERATED``: the
cooperative round engine's programs, K10's and K15's plans) are written into ``_build/include``
before ``nvcc`` runs and count in the digest. A failed build or launch
raises; nothing falls back to the plain torch versions.

Every C entry point takes its device pointers, sizes and the CUDA stream,
launches on that stream without synchronising, and returns
``cudaGetLastError()``; ``launch`` raises on a non-zero code. ``launch``
also counts launches per kernel, so a run can show which kernels it went
through, and, while ``timing`` is a list, appends to it a pair of CUDA
events recorded on the stream around each launch, so a run can sum each
kernel's time on the card (the events add a few microseconds of host time
a launch).
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import subprocess
import time
from collections import Counter
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
# headers generated at build time: file name -> "module:function" returning its text
GENERATED = {"fp12_coop_ops.cuh": "eth_consensus_specs_tpu_torch.ops.fq12_coop:header_text",
             "g1_sum_plan.cuh": "eth_consensus_specs_tpu_torch.ops.g1_msm:sum_plan_header",
             "g2_sum_plan.cuh": "eth_consensus_specs_tpu_torch.ops.g2_aggregate:sum_plan_header"}
KERNELS = ("sha256", "merkle", "validator_leaves", "altair_epoch", "forest_update", "merkle_inc",
           "shuffle", "state_columns", "g1_sum", "miller", "final_exp", "final_exp_gt", "h2c",
           "g2_sum", "fr_fft", "g1_msm", "slot_apply", "block_epoch", "fq12_coop")
NVCC_FLAGS = (
    "-O3", "-gencode=arch=compute_90a,code=sm_90a", "-std=c++17",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v", "-lineinfo",
)

_P, _I64, _I32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
# C entry points: argument types before the trailing stream pointer
SIGNATURES = {
    "sha256": {"sha256_pairs_launch": [_P, _P, _I64], "sha256_single_block_launch": [_P, _P, _I64]},
    "merkle": {"merkle_lists_launch": [_P, _I32, _P, _P, _P, _I64]},
    "validator_leaves": {
        "validator_leaves_launch": [_P, _P, _P, _P, _P, _I64, _P, _I32],
        "validator_leaves_at_launch": [_P, _P, _P, _P, _P, _P, _I32, _I64, _I32, _P, _P],
        "validator_b_table_launch": [_P],
    },
    "altair_epoch": {"altair_epoch_launch": [_P]},
    "forest_update": {"forest_update_launch": [_P, _I32, _P, _P, _I64],
                      "forest_mark_launch": [_P, _I64, _P, _I32, _P, _P, _I32, _P]},
    "merkle_inc": {"merkle_dirty_launch": [_P, _P, _P, _I64, _I32, _P, _I64, _I32, _P, _P, _P, _I64,
                                           _I64]},
    "shuffle": {"shuffle_rounds_launch": [_P, _P, _P, _I64, _I32, _I64]},
    "state_columns": {"phase0_epoch_launch": [_P]},
    "g1_sum": {"g1_sum_lanes_launch": [_P, _P, _P, _P, _P, _P, _I64, _I64, _I32],
               "g1_sum_fold_launch": [_P, _P, _P, _P, _I64, _I64]},
    "miller": {"miller_loop_launch": [_P, _P, _P, _P, _P, _I64],
               "miller_fold_launch": [_P, _P, _I64]},
    "final_exp": {"final_exp_is_one_launch": [_P, _P]},
    "final_exp_gt": {"final_exp_gt_launch": [_P, _P]},
    "h2c": {"h2c_map_launch": [_P, _P, _I64], "h2c_finish_launch": [_P, _P, _P, _I64],
            "fq2_sqrt_launch": [_P, _P, _P, _I64]},
    "g2_sum": {"g2_sum_lanes_launch": [_P, _P, _P, _I64, _P, _I64, _I64, _I32],
               "g2_sum_fold_launch": [_P, _P, _P, _I64, _P, _I64, _I64, _I32]},
    "fr_fft": {"fr_fft_launch": [_P, _P, _P, _P, _I64, _I32, _I32, _P, _I32]},
    "g1_msm": {"g1_msm_many_launch": [_P, _P, _P, _P, _P, _P, _I64, _I64],
               "g1_msm_fold_launch": [_P, _P, _I64, _I64]},
    "slot_apply": {"slot_apply_launch": [_P, _P, _P, _P, _P, _P, _I64],
                   "slot_apply_scatter_launch": [_P, _P, _P, _P, _P, _I64, _P, _P, _I64]},
    "block_epoch": {"block_slot_launch": [_P] * 22 + [_I64] * 5 + [_P]},
    "fq12_coop": {"fq12_coop_check_launch": [_P, _P, _P, _P, _I64, _I32, _I32]},
}

_libs: dict[str, ctypes.CDLL] = {}
build_report: dict[str, dict] = {}
launches: Counter = Counter()
# (counter, start event, end event) of each launch while set to a list
timing: list | None = None


def reset_launches() -> None:
    launches.clear()


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    return str(Path(home) / "bin" / "nvcc")


@functools.cache
def generated() -> dict[str, str]:
    """The text of each ``GENERATED`` header."""
    import importlib

    out = {}
    for fname, target in GENERATED.items():
        module, fn = target.split(":")
        out[fname] = getattr(importlib.import_module(module), fn)()
    return out


def write_generated() -> Path:
    """Write the ``GENERATED`` headers into ``_build/include`` (a file is
    rewritten only when its text changed); returns that directory."""
    inc = BUILD_DIR / "include"
    inc.mkdir(parents=True, exist_ok=True)
    for fname, text in generated().items():
        path = inc / fname
        if not path.exists() or path.read_text() != text:
            tmp = path.with_suffix(f".{os.getpid()}.tmp")
            tmp.write_text(text)
            os.replace(tmp, path)
    return inc


def _digest(name: str) -> str:
    h = hashlib.sha256()
    for p in sorted(CSRC.glob("*.cuh")) + [CSRC / f"{name}.cu"]:
        h.update(p.name.encode())
        h.update(p.read_bytes())
    for fname, text in sorted(generated().items()):
        h.update(fname.encode())
        h.update(text.encode())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def _lib_path(name: str) -> Path:
    return BUILD_DIR / f"lib{name}-{_digest(name)}.so"


def build() -> dict:
    """Compile every kernel source not yet built, one ``nvcc`` each, all
    started together. Returns ``build_report``: per kernel the seconds its
    compile took and ``nvcc``'s register, shared-memory and spill report. Raises
    ``RuntimeError`` with the compiler's output if any compile fails."""
    inc = write_generated()
    procs = {}
    t0 = time.perf_counter()
    for name in KERNELS:
        out = _lib_path(name)
        if out.exists():
            build_report.setdefault(name, {"seconds": 0.0, "cached": True, "ptxas": ""})
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-I", str(CSRC), "-I", str(inc), "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                        text=True), tmp, out)
    failed = []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"--- {name}.cu (nvcc exit {proc.returncode}) ---\n{log}")
            continue
        os.replace(tmp, out)
        build_report[name] = {
            "seconds": time.perf_counter() - t0, "cached": False,
            "ptxas": "\n".join(l for l in log.splitlines() if "ptxas" in l or "spill" in l),
        }
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
    return build_report


def lib(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, building every kernel first
    if this one is not built yet."""
    if name not in _libs:
        path = _lib_path(name)
        if not path.exists():
            build()
        so = ctypes.CDLL(str(path))
        so.kernel_error_string.argtypes = [ctypes.c_int]
        so.kernel_error_string.restype = ctypes.c_char_p
        for fn, argtypes in SIGNATURES[name].items():
            getattr(so, fn).argtypes = [*argtypes, _P]
            getattr(so, fn).restype = ctypes.c_int
        _libs[name] = so
    return _libs[name]


def ptr(t: torch.Tensor | None) -> int | None:
    """The device address of ``t``; ``None``, a null pointer, for ``None``
    (an entry point's ``c_void_p`` argument takes either as it is, with
    less host time than a ``c_void_p`` made for it)."""
    return None if t is None else t.data_ptr()


def device_index(device: torch.device) -> int:
    return torch._C._cuda_getDevice() if device.index is None else device.index


def stream(device: torch.device) -> int:
    """The address of ``device``'s current CUDA stream, looked up raw: a
    ``torch.cuda.Stream`` object costs more host time than a launch."""
    return torch._C._cuda_getCurrentRawStream(device_index(device))


def launch(kernel: str, fn: str, device: torch.device, *args, counter: str | None = None) -> None:
    """Call C entry point ``fn`` of library ``kernel`` on ``device``'s
    current stream (the stream is appended to ``args``) and count one
    launch of ``kernel`` (or of ``counter``, for a second kernel that shares
    a library). Raises ``RuntimeError`` if the launch failed."""
    so = _libs.get(kernel) or lib(kernel)
    current = torch._C._cuda_getDevice()
    idx = current if device.index is None else device.index
    if idx == current and timing is None:  # the common case, at the least host time
        code = getattr(so, fn)(*args, torch._C._cuda_getCurrentRawStream(idx))
    else:
        with torch.cuda.device(idx):
            events = timing
            if events is not None:
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
            code = getattr(so, fn)(*args, torch._C._cuda_getCurrentRawStream(idx))
            if events is not None:
                end.record()
                events.append((counter or kernel, start, end))
    if code != 0:
        raise RuntimeError(
            f"{kernel}.{fn} launch failed: {so.kernel_error_string(code).decode()}"
        )
    launches[counter or kernel] += 1


def check_cuda(t: torch.Tensor, dtype: torch.dtype, shape: tuple | None = None) -> None:
    """Raise ``ValueError`` unless ``t`` is a contiguous CUDA tensor of
    ``dtype`` (and ``shape``, where given)."""
    if not t.is_cuda or t.dtype != dtype or not t.is_contiguous():
        raise ValueError(
            f"expected a contiguous CUDA {dtype} tensor, got {t.dtype} on {t.device}"
            f"{'' if t.is_contiguous() else ' (not contiguous)'}"
        )
    if shape is not None and t.shape != tuple(shape):
        raise ValueError(f"expected shape {tuple(shape)}, got {tuple(t.shape)}")
