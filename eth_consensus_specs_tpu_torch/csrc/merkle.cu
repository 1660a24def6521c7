// K2: reduce a level of 2^d merkle nodes by up to 2^levels per block.
//
// Replaces eth_consensus_specs_tpu/ops/merkle.py tree_root_words (:68),
// which on the TPU runs the wide levels unrolled and the tail as a
// fixed-width fori_loop in one XLA program. Here each block loads
// 2^levels consecutive 32-byte nodes (at most 512 = 16 KB) into shared
// memory with coalesced 16-byte loads, hashes them pairwise level by level
// in place (one thread per pair, __syncthreads() between levels) and
// writes its one surviving node. The host (ops/merkle.py) launches again
// on the block outputs until one node is left: depth 20 takes 3 launches
// (9 + 9 + 2 levels). Integer-ALU bound like K1: 2^d - 1 pair hashes,
// the leaves read once.
//
// K2's batched entry replaces eth_consensus_specs_tpu/ops/merkle.py
// many_tree_root_words (:97), the vmap of the same reduction over B trees
// of one depth (the serving layer's flush of up to 64 subtrees). The grid
// gains a tree axis (blockIdx.y); a block still reduces 2^levels
// consecutive nodes of one tree, so the launches per depth stay K2's and
// each root is bit-equal to tree_root of its tree: B (2^d - 1) pair hashes.
#include "common.cuh"
#include "sha256.cuh"

constexpr int kMaxLevels = 9;  // 512 nodes, 16 KB of shared memory

__global__ void merkle_reduce_kernel(const uint32_t* __restrict__ in,
                                     uint32_t* __restrict__ out, int levels) {
  __shared__ uint4 nodes[(1 << kMaxLevels) * 2];  // 2 x uint4 per node
  const int width = 1 << levels;
  // blocks of one tree are consecutive: tree blockIdx.y, block blockIdx.x of it
  const int64_t block = (int64_t)blockIdx.y * gridDim.x + blockIdx.x;
  const uint4* src = reinterpret_cast<const uint4*>(in) + block * width * 2;
  for (int q = threadIdx.x; q < width * 2; q += blockDim.x) nodes[q] = src[q];
  __syncthreads();
  for (int live = width >> 1; live >= 1; live >>= 1) {
    uint32_t h[8];
    const int t = threadIdx.x;
    if (t < live) {
      uint32_t w[16];
      const uint4* pair = nodes + 4 * t;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const uint4 v = pair[q];
        w[4 * q] = v.x; w[4 * q + 1] = v.y; w[4 * q + 2] = v.z; w[4 * q + 3] = v.w;
      }
      sha256_pair(w, h);
    }
    __syncthreads();  // every pair of this level is read before any is overwritten
    if (t < live) {
      nodes[2 * t] = make_uint4(h[0], h[1], h[2], h[3]);
      nodes[2 * t + 1] = make_uint4(h[4], h[5], h[6], h[7]);
    }
    __syncthreads();
  }
  if (threadIdx.x < 2) reinterpret_cast<uint4*>(out)[2 * block + threadIdx.x] = nodes[threadIdx.x];
}

// in: n_trees x n_nodes x 8 words, n_nodes a multiple of 2^levels;
// out: n_trees x (n_nodes >> levels) nodes.
extern "C" int merkle_reduce_launch(const void* in, void* out, int64_t n_trees,
                                    int64_t n_nodes, int levels, cudaStream_t stream) {
  if (levels < 1 || levels > kMaxLevels || n_nodes % (1LL << levels) != 0 || n_trees < 1 ||
      n_trees > 65535 || (n_nodes >> levels) > 0x7FFFFFFFLL)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((unsigned)(n_nodes >> levels), (unsigned)n_trees);
  const int threads = (1 << levels) / 2 < 32 ? 32 : (1 << levels) / 2;
  merkle_reduce_kernel<<<grid, threads, 0, stream>>>(
      static_cast<const uint32_t*>(in), static_cast<uint32_t*>(out), levels);
  return static_cast<int>(cudaGetLastError());
}
