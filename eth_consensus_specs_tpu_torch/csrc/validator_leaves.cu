// K3: the per-validator root chain of the registry tree.
//
// Replaces eth_consensus_specs_tpu/ops/state_root.py _validator_leaf_rows
// (:143), the part of validator_registry_root (:161) that recomputes each
// Validator container root from its static nodes and the one field the
// accounting epoch changes:
//   eb_chunk = SSZ chunk of effective_balance (u64 little-endian in bytes 0..7)
//   B = H(eb_chunk, slashed_chunk);  E = H(node_a, B);  root = H(E, node_f)
// One thread per validator, three pair hashes (six compressions) with
// every intermediate in registers; reads 104 B and writes the 32-byte leaf
// that K2 then reduces. Integer-ALU bound.
#include "common.cuh"
#include "sha256.cuh"

__device__ __forceinline__ uint32_t bswap32(uint32_t x) { return __byte_perm(x, 0, 0x0123); }

__device__ __forceinline__ void load8(const uint32_t* p, uint32_t v[8]) {
  const uint4* q = reinterpret_cast<const uint4*>(p);
  const uint4 x = q[0], y = q[1];
  v[0] = x.x; v[1] = x.y; v[2] = x.z; v[3] = x.w;
  v[4] = y.x; v[5] = y.y; v[6] = y.z; v[7] = y.w;
}

__global__ void validator_leaves_kernel(const uint64_t* __restrict__ eff,
                                        const uint32_t* __restrict__ slashed,
                                        const uint32_t* __restrict__ node_a,
                                        const uint32_t* __restrict__ node_f,
                                        uint32_t* __restrict__ out, int64_t n) {
  const int64_t i = blockIdx.x * (int64_t)blockDim.x + threadIdx.x;
  if (i >= n) return;
  const uint64_t e = eff[i];
  uint32_t w[16], node[8], other[8];
  w[0] = bswap32(static_cast<uint32_t>(e));
  w[1] = bswap32(static_cast<uint32_t>(e >> 32));
#pragma unroll
  for (int k = 2; k < 8; ++k) w[k] = 0u;
  load8(slashed + i * 8, w + 8);
  sha256_pair(w, node);  // B
  load8(node_a + i * 8, other);
  sha256_hash_pair(other, node, node);  // E = H(A, B)
  load8(node_f + i * 8, other);
  sha256_hash_pair(node, other, node);  // root = H(E, F)
  uint4* dst = reinterpret_cast<uint4*>(out + i * 8);
  dst[0] = make_uint4(node[0], node[1], node[2], node[3]);
  dst[1] = make_uint4(node[4], node[5], node[6], node[7]);
}

extern "C" int validator_leaves_launch(const void* eff, const void* slashed, const void* node_a,
                                       const void* node_f, void* out, int64_t n,
                                       cudaStream_t stream) {
  if (n > 0) {
    const int threads = 128;
    const int64_t blocks = (n + threads - 1) / threads;
    validator_leaves_kernel<<<(unsigned)blocks, threads, 0, stream>>>(
        static_cast<const uint64_t*>(eff), static_cast<const uint32_t*>(slashed),
        static_cast<const uint32_t*>(node_a), static_cast<const uint32_t*>(node_f),
        static_cast<uint32_t*>(out), n);
  }
  return static_cast<int>(cudaGetLastError());
}
