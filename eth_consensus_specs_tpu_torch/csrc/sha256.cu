// K1: SHA-256 of N independent 64-byte messages.
//
// Replaces eth_consensus_specs_tpu/ops/sha256.py sha256_pair_words (:153)
// with its _compress (:64), the XLA-fused round chain behind sha256_tiled.
// One thread per message: the 16 input words are read once (64 B), both
// compressions run in registers, the 8-word digest is written once (32 B).
// Integer-ALU bound (see sha256.cuh); memory traffic is 96 B per at least
// 2,288 32-bit instructions, 1,664 of them logic and shifts.
//
// K7: one compression of N blocks that the caller has already padded.
//
// Replaces eth_consensus_specs_tpu/ops/sha256.py sha256_single_block
// (:137), the shuffle's decision hashes (37-byte messages: seed, round,
// chunk). The same core, one thread per block, with the data compression
// alone: 96 B of traffic per at least 1,384 instructions, 1,024 of them
// logic and shifts, so about 0.6 of K1's work per message.
#include "common.cuh"
#include "sha256.cuh"

__device__ __forceinline__ void load_block(const uint32_t* __restrict__ src, uint32_t w[16]) {
  const uint4* s = reinterpret_cast<const uint4*>(src);
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const uint4 v = s[q];
    w[4 * q] = v.x; w[4 * q + 1] = v.y; w[4 * q + 2] = v.z; w[4 * q + 3] = v.w;
  }
}

__device__ __forceinline__ void store_digest(uint32_t* __restrict__ dst, const uint32_t h[8]) {
  uint4* d = reinterpret_cast<uint4*>(dst);
  d[0] = make_uint4(h[0], h[1], h[2], h[3]);
  d[1] = make_uint4(h[4], h[5], h[6], h[7]);
}

__global__ void sha256_pairs_kernel(const uint32_t* __restrict__ in,
                                    uint32_t* __restrict__ out, int64_t n) {
  const int64_t i = blockIdx.x * (int64_t)blockDim.x + threadIdx.x;
  if (i >= n) return;
  uint32_t w[16], h[8];
  load_block(in + i * 16, w);
  sha256_pair(w, h);
  store_digest(out + i * 8, h);
}

__global__ void sha256_single_block_kernel(const uint32_t* __restrict__ in,
                                           uint32_t* __restrict__ out, int64_t n) {
  const int64_t i = blockIdx.x * (int64_t)blockDim.x + threadIdx.x;
  if (i >= n) return;
  uint32_t w[16], h[8];
  load_block(in + i * 16, w);
  sha256_init(h);
  sha256_compress(h, w);
  store_digest(out + i * 8, h);
}

static int launch_rows(void (*kernel)(const uint32_t*, uint32_t*, int64_t), const void* in,
                       void* out, int64_t n, cudaStream_t stream) {
  if (n > 0) {
    const int threads = 128;
    const int64_t blocks = (n + threads - 1) / threads;
    kernel<<<(unsigned)blocks, threads, 0, stream>>>(
        static_cast<const uint32_t*>(in), static_cast<uint32_t*>(out), n);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int sha256_pairs_launch(const void* in, void* out, int64_t n,
                                   cudaStream_t stream) {
  return launch_rows(sha256_pairs_kernel, in, out, n, stream);
}

extern "C" int sha256_single_block_launch(const void* in, void* out, int64_t n,
                                          cudaStream_t stream) {
  return launch_rows(sha256_single_block_kernel, in, out, n, stream);
}
