// K1: SHA-256 of N independent 64-byte messages.
//
// Replaces eth_consensus_specs_tpu/ops/sha256.py sha256_pair_words (:153)
// with its _compress (:64), the XLA-fused round chain behind sha256_tiled.
// One thread per message: the 16 input words are read once (64 B), both
// compressions run in registers, the 8-word digest is written once (32 B).
// Integer-ALU bound (see sha256.cuh); memory traffic is 96 B per at least
// 2,288 32-bit instructions, 1,664 of them logic and shifts.
#include "common.cuh"
#include "sha256.cuh"

__global__ void sha256_pairs_kernel(const uint32_t* __restrict__ in,
                                    uint32_t* __restrict__ out, int64_t n) {
  const int64_t i = blockIdx.x * (int64_t)blockDim.x + threadIdx.x;
  if (i >= n) return;
  const uint4* src = reinterpret_cast<const uint4*>(in + i * 16);
  uint32_t w[16];
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const uint4 v = src[q];
    w[4 * q] = v.x; w[4 * q + 1] = v.y; w[4 * q + 2] = v.z; w[4 * q + 3] = v.w;
  }
  uint32_t h[8];
  sha256_pair(w, h);
  uint4* dst = reinterpret_cast<uint4*>(out + i * 8);
  dst[0] = make_uint4(h[0], h[1], h[2], h[3]);
  dst[1] = make_uint4(h[4], h[5], h[6], h[7]);
}

extern "C" int sha256_pairs_launch(const void* in, void* out, int64_t n,
                                   cudaStream_t stream) {
  if (n > 0) {
    const int threads = 128;
    const int64_t blocks = (n + threads - 1) / threads;
    sha256_pairs_kernel<<<(unsigned)blocks, threads, 0, stream>>>(
        static_cast<const uint32_t*>(in), static_cast<uint32_t*>(out), n);
  }
  return static_cast<int>(cudaGetLastError());
}
