// K6: every internal level of a batch of flat merkle trees, in place.
//
// Replaces eth_consensus_specs_tpu/ops/merkle_inc.py build_levels (:109),
// which XLA runs level by level at exact shrinking widths, and with it the
// dense branch of apply_dirty (:170), build_forest (:219) and the rebuilds of
// ops/snapshot.py (_rebuild_check_kernel :403, _rebuild_kernel :422,
// _scrub_kernel :617). The flat layout is the JAX package's: a tree of depth
// d is 2^(d+1) - 1 rows of 8 words, leaves first, root last, level k at row
// 2^(d+1) - 2^(d-k+1). The leaf rows are the input and the internal rows the
// output, so the rebuild runs in place with no overlap.
//
// Like K2 (merkle.cu), each block loads 2^levels consecutive nodes of level
// k0 (at most 512 = 16 KB) into shared memory with coalesced 16-byte loads
// and hashes them pairwise level by level, one thread per pair; unlike K2 it
// writes every level it produces to its rows, not only the last. The host
// (ops/merkle_inc.py) launches again from level k0 + levels until the root:
// depth 20 takes 3 launches (9 + 9 + 2 levels), depth 18 two. blockIdx.y
// walks a batch of trees of one depth (the scrub's sampled subtrees).
// Exactly 2^d - 1 pair hashes per tree; integer-ALU bound like K1.
//
// Gate: with gate_count set, the kernel returns at once unless
// *gate_count > gate_dense: the dense branch of an incremental update is
// launched every epoch and runs only when the live dirty count, which K5
// wrote on the device, says so. No host round trip decides the branch.
#include "common.cuh"
#include "sha256.cuh"

constexpr int kMaxLevels = 9;  // 512 nodes, 16 KB of shared memory

__global__ void merkle_levels_kernel(uint32_t* __restrict__ nodes, int64_t rows, int depth,
                                     int k0, int levels, const int* __restrict__ gate_count,
                                     int gate_dense) {
  if (gate_count != nullptr && *gate_count <= gate_dense) return;
  __shared__ uint4 sm[(1 << kMaxLevels) * 2];  // 2 x uint4 per node
  const int width = 1 << levels;
  const int64_t cap2 = 1LL << (depth + 1);
  uint4* tree = reinterpret_cast<uint4*>(nodes + (int64_t)blockIdx.y * rows * 8);
  const uint4* src = tree + 2 * (cap2 - (cap2 >> k0) + (int64_t)blockIdx.x * width);
  for (int q = threadIdx.x; q < width * 2; q += blockDim.x) sm[q] = src[q];
  __syncthreads();
  const int t = threadIdx.x;
  int live = width >> 1;
  for (int j = 1; j <= levels; ++j, live >>= 1) {
    uint32_t h[8];
    if (t < live) {
      uint32_t w[16];
      const uint4* pair = sm + 4 * t;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const uint4 v = pair[q];
        w[4 * q] = v.x; w[4 * q + 1] = v.y; w[4 * q + 2] = v.z; w[4 * q + 3] = v.w;
      }
      sha256_pair(w, h);
    }
    __syncthreads();  // every pair of this level is read before any is overwritten
    if (t < live) {
      const uint4 a = make_uint4(h[0], h[1], h[2], h[3]);
      const uint4 b = make_uint4(h[4], h[5], h[6], h[7]);
      sm[2 * t] = a;
      sm[2 * t + 1] = b;
      const int64_t row = cap2 - (cap2 >> (k0 + j)) + (int64_t)blockIdx.x * live + t;
      tree[2 * row] = a;
      tree[2 * row + 1] = b;
    }
    __syncthreads();
  }
}

// nodes: n_trees x (2^(depth+1) - 1) x 8 words. Hashes levels k0+1 ..
// k0+levels of every tree from level k0. gate_count may be null.
extern "C" int merkle_levels_launch(void* nodes, int64_t n_trees, int depth, int k0, int levels,
                                    const void* gate_count, int gate_dense, cudaStream_t stream) {
  if (levels < 1 || levels > kMaxLevels || k0 < 0 || k0 + levels > depth || n_trees < 1 ||
      n_trees > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const int64_t blocks = (1LL << (depth - k0)) >> levels;
  const int threads = (1 << levels) / 2 < 32 ? 32 : (1 << levels) / 2;
  const dim3 grid(static_cast<unsigned>(blocks), static_cast<unsigned>(n_trees));
  merkle_levels_kernel<<<grid, threads, 0, stream>>>(
      static_cast<uint32_t*>(nodes), (1LL << (depth + 1)) - 1, depth, k0, levels,
      static_cast<const int*>(gate_count), gate_dense);
  return static_cast<int>(cudaGetLastError());
}
