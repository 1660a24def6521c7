// K3: the per-validator root chain of the registry tree.
//
// Replaces eth_consensus_specs_tpu/ops/state_root.py _validator_leaf_rows
// (:143), the part of validator_registry_root (:161) that recomputes each
// Validator container root from its static nodes and the one field the
// accounting epoch changes:
//   eb_chunk = SSZ chunk of effective_balance (u64 little-endian in bytes 0..7)
//   B = H(eb_chunk, slashed_chunk);  E = H(node_a, B);  root = H(E, node_f)
// One thread per validator, three pair hashes (six compressions) with
// every intermediate in registers (the chain in validator_root.cuh, which
// the forest update shares); reads 104 B and writes the 32-byte leaf that
// K2 then reduces. Integer-ALU bound.
//
// Two entries:
// - validator_leaves_launch: every validator, rows 0..n-1 of `out` (the
//   full registry, or the leaf rows of the incremental forest's validator
//   tree when it is built). With gate_count set it returns at once unless
//   *gate_count > gate_dense: JAX's dense branch of the incremental update.
// - validator_leaves_at_launch: the chain at a gathered index list, as the
//   incremental path's _validator_leaf_fn (state_root.py:721) runs it on the
//   dirty rows; an index outside [0, n) gives the SSZ zero chunk (the
//   padding of the leaf level). With count set, only rows j < *count are
//   written, and with dense >= 0 nothing when *count > dense: JAX's sparse
//   branch of the incremental update.
// Since the forest update (forest_update.cu) computes the registry's dirty
// leaves itself, no path gates the first entry or calls the second.
#include "common.cuh"
#include "validator_root.cuh"

__global__ void validator_leaves_kernel(const uint64_t* __restrict__ eff,
                                        const uint32_t* __restrict__ slashed,
                                        const uint32_t* __restrict__ node_a,
                                        const uint32_t* __restrict__ node_f,
                                        uint32_t* __restrict__ out, int64_t n,
                                        const int* __restrict__ gate_count, int gate_dense) {
  if (gate_count != nullptr && *gate_count <= gate_dense) return;
  const int64_t i = blockIdx.x * (int64_t)blockDim.x + threadIdx.x;
  if (i >= n) return;
  uint32_t node[8];
  validator_root(eff, slashed, node_a, node_f, i, node);
  store8(out + i * 8, node);
}

__global__ void validator_leaves_at_kernel(const uint64_t* __restrict__ eff,
                                           const uint32_t* __restrict__ slashed,
                                           const uint32_t* __restrict__ node_a,
                                           const uint32_t* __restrict__ node_f,
                                           const int* __restrict__ idx,
                                           const int* __restrict__ count, int dense, int64_t n,
                                           int cap, uint32_t* __restrict__ out) {
  int live = cap;
  if (count != nullptr) {
    live = *count;
    if (dense >= 0 && live > dense) return;  // the dense branch's turn
    live = live < cap ? live : cap;
  }
  const int64_t j = blockIdx.x * (int64_t)blockDim.x + threadIdx.x;
  if (j >= live) return;
  const int64_t i = idx[j];
  uint32_t node[8] = {0, 0, 0, 0, 0, 0, 0, 0};
  if (i >= 0 && i < n) validator_root(eff, slashed, node_a, node_f, i, node);
  store8(out + j * 8, node);
}

extern "C" int validator_leaves_launch(const void* eff, const void* slashed, const void* node_a,
                                       const void* node_f, void* out, int64_t n,
                                       const void* gate_count, int gate_dense,
                                       cudaStream_t stream) {
  if (n > 0) {
    const int threads = 128;
    const int64_t blocks = (n + threads - 1) / threads;
    validator_leaves_kernel<<<(unsigned)blocks, threads, 0, stream>>>(
        static_cast<const uint64_t*>(eff), static_cast<const uint32_t*>(slashed),
        static_cast<const uint32_t*>(node_a), static_cast<const uint32_t*>(node_f),
        static_cast<uint32_t*>(out), n, static_cast<const int*>(gate_count), gate_dense);
  }
  return static_cast<int>(cudaGetLastError());
}

// out: cap x 8 words; rows j >= min(*count, cap) are left as they are.
extern "C" int validator_leaves_at_launch(const void* eff, const void* slashed,
                                          const void* node_a, const void* node_f,
                                          const void* idx, const void* count, int dense,
                                          int64_t n, int cap, void* out, cudaStream_t stream) {
  if (cap < 1) return static_cast<int>(cudaErrorInvalidValue);
  const int threads = 128;
  const int blocks = (cap + threads - 1) / threads;
  validator_leaves_at_kernel<<<blocks, threads, 0, stream>>>(
      static_cast<const uint64_t*>(eff), static_cast<const uint32_t*>(slashed),
      static_cast<const uint32_t*>(node_a), static_cast<const uint32_t*>(node_f),
      static_cast<const int*>(idx), static_cast<const int*>(count), dense, n, cap,
      static_cast<uint32_t*>(out));
  return static_cast<int>(cudaGetLastError());
}
