// The per-validator root chain of the registry tree, shared by K3
// (validator_leaves.cu) and the forest update (forest_update.cu).
//
// Replaces the chain of eth_consensus_specs_tpu/ops/state_root.py
// _validator_leaf_rows (:143): of each Validator container only the
// effective-balance path changes in the accounting epoch, so with the
// static nodes A = H(pubkey_root, withdrawal_credentials) and
// F = H(H(aee, ae), H(exit, withdrawable)):
//   eb_chunk = SSZ chunk of effective_balance (u64 little-endian in bytes 0..7)
//   B = H(eb_chunk, slashed_chunk);  E = H(A, B);  root = H(E, F)
// Three pair hashes (six compressions), every intermediate in registers.
#pragma once
#include <cstdint>

#include "sha256.cuh"

__device__ __forceinline__ uint32_t bswap32(uint32_t x) { return __byte_perm(x, 0, 0x0123); }

__device__ __forceinline__ void load8(const uint32_t* p, uint32_t v[8]) {
  const uint4* q = reinterpret_cast<const uint4*>(p);
  const uint4 x = q[0], y = q[1];
  v[0] = x.x; v[1] = x.y; v[2] = x.z; v[3] = x.w;
  v[4] = y.x; v[5] = y.y; v[6] = y.z; v[7] = y.w;
}

__device__ __forceinline__ void store8(uint32_t* p, const uint32_t v[8]) {
  uint4* dst = reinterpret_cast<uint4*>(p);
  dst[0] = make_uint4(v[0], v[1], v[2], v[3]);
  dst[1] = make_uint4(v[4], v[5], v[6], v[7]);
}

// node = H(H(A_i, H(eb_chunk(eff_i), slashed_i)), F_i)
__device__ __forceinline__ void validator_root(const uint64_t* __restrict__ eff,
                                               const uint32_t* __restrict__ slashed,
                                               const uint32_t* __restrict__ node_a,
                                               const uint32_t* __restrict__ node_f, int64_t i,
                                               uint32_t node[8]) {
  const uint64_t e = eff[i];
  uint32_t w[16], other[8];
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
}
