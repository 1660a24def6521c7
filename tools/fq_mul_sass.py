"""Count the SASS instructions of one Fq product on 1, 2 and 4 lanes, of
one Fq squaring, of one Fr product, and of K4's and K9's kernels a
validator.

Compiles, for ``sm_90a`` at the kernels' optimisation level, small kernels
that each run K chained Montgomery products ``a = a * b`` through
``csrc/fp12_coop.cuh``'s ``coop_mul<L>`` (``fp_mul`` of ``bls_fp.cuh`` on
one lane), and K chained squarings ``a = a^2`` through ``fp_sqr``,
disassembles them with ``cuobjdump -sass`` and prints one JSON line: per L,
the instructions one lane issues for one product, (count at K = 3 - count
at K = 1) / 2, so that the kernels' loads, stores and set-up cancel, and
the L lanes' sum; the same for the squaring under ``"sqr"`` and for K16's
Fr product (``csrc/fr.cuh``'s ``fr_mul``, chained ``a = a * b``) under
``"fr_mul"``. NOPs are not counted. ``chip_smoke.py``'s one-lane bounds take
the one-lane product's count (``FQ_MUL_SASS``); ``chip_smoke.py`` calls
``fr_mul_sass()`` in its run for K16's ``fr_mul_sass`` and
``sass_bound_ms``. ``altair_epoch_sass()`` and ``phase0_epoch_sass()``
count K4's and K9's kernels (``csrc/altair_epoch.cu``,
``csrc/state_columns.cu``) a validator and their subroutine calls;
``chip_smoke.py`` reports them as the K4 and K9 rows'
``sass_per_validator``.

Needs the CUDA toolkit (``nvcc``, ``cuobjdump``) and no card:

    python3 tools/fq_mul_sass.py
"""

from __future__ import annotations

import json
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from eth_consensus_specs_tpu_torch import _ext  # noqa: E402

LANES = (1, 2, 4)
CHAINS = (1, 3)

SOURCE = """#include "fp12_coop.cuh"
#include "fr.cuh"
template <int L, int K>
__device__ __forceinline__ void chain(const uint32_t* in, uint32_t* out) {
  fp a, b;
#pragma unroll
  for (int k = 0; k < 12; ++k) {
    a.v[k] = in[k];
    b.v[k] = in[12 + k];
  }
  const int lane = threadIdx.x % L;
  const unsigned mask = L == 1 ? 1u : ((1u << L) - 1u) << ((threadIdx.x & 31) & ~(L - 1));
#pragma unroll
  for (int i = 0; i < K; ++i) coop_mul<L>(a, a, b, lane, mask);
#pragma unroll
  for (int k = 0; k < 12; ++k) out[threadIdx.x * 12 + k] = a.v[k];
}
template <int K>
__device__ __forceinline__ void sqr_chain(const uint32_t* in, uint32_t* out) {
  fp a;
#pragma unroll
  for (int k = 0; k < 12; ++k) a.v[k] = in[k];
#pragma unroll
  for (int i = 0; i < K; ++i) fp_sqr(a, a);
#pragma unroll
  for (int k = 0; k < 12; ++k) out[threadIdx.x * 12 + k] = a.v[k];
}
"""
FR_SOURCE = """template <int K>
__device__ __forceinline__ void fr_chain(const uint32_t* in, uint32_t* out) {
  fr a, b;
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    a.v[k] = in[k];
    b.v[k] = in[8 + k];
  }
#pragma unroll
  for (int i = 0; i < K; ++i) fr_mul(a, a, b);
#pragma unroll
  for (int k = 0; k < 8; ++k) out[threadIdx.x * 8 + k] = a.v[k];
}
"""
FR_KERNEL = ('extern "C" __global__ void fr_k{K}(const uint32_t* in, uint32_t* out) '
             "{{ fr_chain<{K}>(in, out); }}\n")
KERNEL = ('extern "C" __global__ void chain_l{L}_k{K}(const uint32_t* in, uint32_t* out) '
          "{{ chain<{L}, {K}>(in, out); }}\n")
SQR_KERNEL = ('extern "C" __global__ void sqr_k{K}(const uint32_t* in, uint32_t* out) '
              "{{ sqr_chain<{K}>(in, out); }}\n")
INSN = re.compile(r"/\*[0-9a-f]{4,}\*/\s+([^;]+);")


def count(sass: str, opcode: str = "") -> dict[str, int]:
    """Instructions (NOPs aside) of each function in ``cuobjdump -sass``
    output; with ``opcode``, only those whose opcode starts with it."""
    out: dict[str, int] = {}
    name = None
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            name = m.group(1)
            out[name] = 0
            continue
        m = INSN.search(line)
        if name and m and m.group(1).split()[0] != "NOP":
            words = m.group(1).split()
            op = words[1] if words[0].startswith("@") else words[0]  # past a predicate guard
            if op.startswith(opcode):
                out[name] += 1
    return out


def sass_counts(name: str, source: str) -> dict[str, int]:
    """Compile ``source`` to a cubin for ``sm_90a`` (in ``_build/sass``, as
    ``name``) and count each function's SASS instructions."""
    return count(sass_listing(name, source))


def sass_listing(name: str, source: str) -> str:
    """``cuobjdump -sass`` of ``source`` compiled for ``sm_90a`` (in
    ``_build/sass``, as ``name``)."""
    inc = _ext.write_generated()
    work = _ext.BUILD_DIR / "sass"
    work.mkdir(parents=True, exist_ok=True)
    src, cubin = work / f"{name}.cu", work / f"{name}.cubin"
    src.write_text(source)
    nvcc = _ext._nvcc()
    subprocess.run([nvcc, "-O3", "-arch=sm_90a", "-std=c++17", "-cubin", "-I", str(_ext.CSRC),
                    "-I", str(inc), "-o", str(cubin), str(src)], check=True)
    return subprocess.run([str(Path(nvcc).parent / "cuobjdump"), "-sass", str(cubin)], check=True,
                          capture_output=True, text=True).stdout


def fr_mul_sass() -> float:
    """SASS instructions of one Fr product (``csrc/fr.cuh``'s ``fr_mul``):
    the chain of three products less the chain of one, over two."""
    n = sass_counts("fr_mul_sass", '#include <cstdint>\n#include "fr.cuh"\n' + FR_SOURCE
                    + "".join(FR_KERNEL.format(K=K) for K in CHAINS))
    return (n["fr_k3"] - n["fr_k1"]) / 2


def epoch_sass(name: str, source: str, macro: str, kernel: str, runs: tuple = (8, 16)) -> dict:
    """SASS of an accounting-epoch kernel as compiled for ``sm_90a``:
    ``source`` built with a run of each of ``runs`` validators a thread
    (``<macro>_RUN``), each with the registers of two blocks an SM. Per
    function of the file: its instructions and its subroutine calls
    (``CALL``: a u64 division by the compiler's routine) at the last run;
    ``per_validator``, the instructions one more validator of a run adds to
    the function named ``kernel`` (the kernel at the last run less at the
    first, over their difference). A file without that kernel has kernels
    of one validator a thread, which count whole: ``per_validator`` is then
    the sum of its kernels' instructions."""
    # both runs at one register budget (two blocks an SM), so that neither spills
    listings = {r: sass_listing(f"{name}_sass_{r}",
                                f"#define {macro}_RUN {r}\n#define {macro}_MIN_BLOCKS 2\n{source}")
                for r in runs}
    last = listings[runs[-1]]
    calls = count(last, "CALL")
    out = {"functions": {k: {"instructions": v, "calls": calls[k]}
                         for k, v in count(last).items()}}
    match = [k for k in out["functions"] if kernel in k]
    if match:
        first = count(listings[runs[0]])[match[0]]
        out["per_validator"] = (out["functions"][match[0]]["instructions"] - first) / (
            runs[-1] - runs[0])
        out["run"] = runs[-1]
    else:
        out["per_validator"] = sum(f["instructions"] for k, f in out["functions"].items()
                                   if "_kernel" in k)
        out["run"] = 1
    return out


def altair_epoch_sass(source: str | None = None) -> dict:
    """``epoch_sass`` of K4's kernel (``csrc/altair_epoch.cu``, or ``source``)."""
    text = source if source is not None else '#include "altair_epoch.cu"\n'
    return epoch_sass("altair_epoch", text, "K4", "altair_epoch_kernel")


def phase0_epoch_sass(path: str | None = None) -> dict:
    """``epoch_sass`` of K9's kernel: ``csrc/state_columns.cu``, or the
    file at ``path`` (another checkout's, compiled against its own
    headers), whose three one-validator-a-thread kernels count whole. Runs
    of 4 and 8: a run of 16 would keep more in shared memory than a block
    declares statically."""
    text = f'#include "{path or _ext.CSRC / "state_columns.cu"}"\n'
    return epoch_sass("phase0_epoch", text, "K9", "phase0_epoch_kernel", runs=(4, 8))


def main() -> int:
    nvcc = _ext._nvcc()
    n = sass_counts("fq_mul_sass", SOURCE
                    + "".join(KERNEL.format(L=L, K=K) for L in LANES for K in CHAINS)
                    + "".join(SQR_KERNEL.format(K=K) for K in CHAINS) + FR_SOURCE
                    + "".join(FR_KERNEL.format(K=K) for K in CHAINS))
    lanes = {}
    for L in LANES:
        one, three = n[f"chain_l{L}_k1"], n[f"chain_l{L}_k3"]
        per_lane = (three - one) / 2
        lanes[L] = {"per_lane": per_lane, "all_lanes": per_lane * L, "k1": one, "k3": three}
    one, three = n["sqr_k1"], n["sqr_k3"]
    sqr = {"per_lane": (three - one) / 2, "k1": one, "k3": three}
    one, three = n["fr_k1"], n["fr_k3"]
    fr = {"per_product": (three - one) / 2, "k1": one, "k3": three}
    version = subprocess.run([nvcc, "--version"], capture_output=True, text=True).stdout
    print(json.dumps({"nvcc": version.strip().splitlines()[-1], "lanes": lanes, "sqr": sqr,
                      "fr_mul": fr, "altair_epoch": altair_epoch_sass(),
                      "phase0_epoch": phase0_epoch_sass()}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
