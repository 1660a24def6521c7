"""Time one Fq product and one Fq squaring on one thread of the card.

Builds (``nvcc``, ``sm_90a``, the kernels' flags) a small kernel that runs
chains of dependent Fq products ``a = a * b`` (or squarings ``a = a^2``)
through ``csrc/bls_fp.cuh``'s ``fp_mul`` and ``fp_sqr`` on one thread: a
chain of n products, and three such chains interleaved in one loop (what an
Fq2 product offers the scheduler), timed by ``clock64`` in SM cycles a
product. Each chain's last words are held against the same chain on host
ints (the run fails otherwise). ``--root`` takes ``bls_fp.cuh`` and the
build helpers from another checkout (for example an unpacked parent
commit), so that two products can be timed in one call on one card.
``tools/fq_mul_sass.py`` counts the same product's SASS.

Needs a card; prints one JSON line:

    python3 tools/fq_mul_latency.py [--root DIR]
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

CHAIN = 4096  # products a chain
OPS = ("mul", "sqr")

SOURCE = r"""#include "bls_fp.cuh"

template <int V, int C>
__global__ void lat(const uint32_t* in, uint32_t* out, long long* cyc, int n) {
  fp x[C], b;
#pragma unroll
  for (int c = 0; c < C; ++c)
#pragma unroll
    for (int k = 0; k < 12; ++k) x[c].v[k] = in[12 * c + k];
#pragma unroll
  for (int k = 0; k < 12; ++k) b.v[k] = in[36 + k];
  const long long t0 = clock64();
#pragma unroll 1
  for (int i = 0; i < n; ++i) {
#pragma unroll
    for (int c = 0; c < C; ++c) {
      if constexpr (V == 0) fp_mul(x[c], x[c], b);
      else fp_sqr(x[c], x[c]);
    }
  }
  const long long t1 = clock64();
#pragma unroll
  for (int c = 0; c < C; ++c)
#pragma unroll
    for (int k = 0; k < 12; ++k) out[12 * c + k] = x[c].v[k];
  cyc[0] = t1 - t0;
}

template <int V>
int run_v(int chains, const uint32_t* in, uint32_t* out, long long* cyc, int n) {
  if (chains == 1) lat<V, 1><<<1, 1>>>(in, out, cyc, n);
  else lat<V, 3><<<1, 1>>>(in, out, cyc, n);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int run(int v, int chains, const void* in, void* out, void* cyc, int n) {
  const uint32_t* i = static_cast<const uint32_t*>(in);
  uint32_t* o = static_cast<uint32_t*>(out);
  long long* c = static_cast<long long*>(cyc);
  return v == 0 ? run_v<0>(chains, i, o, c, n) : run_v<1>(chains, i, o, c, n);
}
"""


def expected(op: str, start: int, b: int, n: int, p: int) -> int:
    """The chain's last value on host ints: each step a Montgomery product
    (x y 2^-384 mod p)."""
    rinv = pow(1 << 384, -1, p)
    if op == "mul":
        return start * pow(b * rinv, n, p) % p
    return pow(start, 1 << n, p) * pow(rinv, (1 << n) - 1, p) % p


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=str(Path(__file__).resolve().parents[1]))
    args = ap.parse_args()
    sys.path.insert(0, args.root)
    import torch

    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 1
    from eth_consensus_specs_tpu_torch import _ext
    from eth_consensus_specs_tpu_torch.crypto.fields import P

    inc = _ext.write_generated()
    work = _ext.BUILD_DIR / "latency"
    work.mkdir(parents=True, exist_ok=True)
    src = work / "fq_mul_latency.cu"
    src.write_text(SOURCE)
    so = work / "libfq_mul_latency.so"
    subprocess.run([_ext._nvcc(), "-O3", "-gencode=arch=compute_90a,code=sm_90a", "-std=c++17",
                    "-I", str(_ext.CSRC), "-I", str(inc), "-shared", "-Xcompiler", "-fPIC",
                    "-o", str(so), str(src)], check=True)
    lib = ctypes.CDLL(str(so))
    lib.run.argtypes = [ctypes.c_int, ctypes.c_int] + [ctypes.c_void_p] * 3 + [ctypes.c_int]
    lib.run.restype = ctypes.c_int

    values = [pow(x, 200, P) for x in (3, 5, 7, 11)]  # three chain starts and b, canonical
    words = [(v >> (32 * i)) & 0xFFFFFFFF for v in values for i in range(12)]
    dev = torch.device("cuda")
    inp = torch.tensor(words, dtype=torch.int64).to(torch.int32).to(dev)
    out = {"root": args.root, "device": torch.cuda.get_device_name(0), "chain": CHAIN}
    for v, op in enumerate(OPS):
        row = {}
        for chains in (1, 3):
            o = torch.zeros(36, dtype=torch.int32, device=dev)
            cyc = torch.zeros(1, dtype=torch.int64, device=dev)
            for n in (16, CHAIN):  # warm-up, then the timed chain
                code = lib.run(v, chains, inp.data_ptr(), o.data_ptr(), cyc.data_ptr(), n)
                if code:
                    raise RuntimeError(f"launch of the {op} chain failed: {code}")
                torch.cuda.synchronize()
            row[f"cycles_{chains}_chain"] = int(cyc.item()) / (CHAIN * chains)
            got = o.cpu().tolist()
            for c in range(chains):
                last = sum((w & 0xFFFFFFFF) << (32 * i) for i, w in enumerate(got[12 * c:12 * c + 12]))
                if last != expected(op, values[c], values[3], CHAIN, P):
                    raise RuntimeError(f"the {op} chain {c} of {chains} ends on wrong words")
        out[op] = row
    out["words_equal_host"] = True
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
