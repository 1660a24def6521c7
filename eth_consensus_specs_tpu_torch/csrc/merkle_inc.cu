// K5: the dirty-leaf compaction of a flat merkle tree's update.
//
// Replaces eth_consensus_specs_tpu/ops/merkle_inc.py dirty_indices (:125):
// the compacted dirty set JAX's sparse branch (apply_dirty :170) feeds its
// path update. Since the forest update (forest_update.cu) hashes every tree
// of the forest in one launch from the column diffs themselves, no path of
// the port compacts; this entry stays behind the public dirty_indices and
// dirty_leaves, their counterparts.
//
// Compaction (merkle_dirty_launch). A leaf is dirty where a bool mask says
// so, or where its u64 values differ between the old and the new column
// (`per` values per leaf: 1 for the validator registry's effective
// balances, 4 for a packed balance or score chunk). The dirty leaf indices
// are written in ascending order into idx[cap], padded with 0, and the live
// count into *count; entries past cap are dropped, as JAX drops them. For a
// chunk tree the kernel also writes each dirty leaf's new chunk into its
// leaf row. The order needs a prefix sum over the whole leaf level, so the
// kernel is one cooperative launch: pass 1 counts the dirty leaves of each
// block's segment, grid.sync(), then every block sums the counts before its
// own and pass 2 writes its indices in order, a warp ballot and a block scan
// per round of 256 leaves. Bound by bytes: each value is read twice (once
// per pass).
#include <cooperative_groups.h>

#include "common.cuh"

namespace cg = cooperative_groups;

constexpr int kCompactThreads = 256;
constexpr int kCompactWarps = kCompactThreads / 32;

__device__ __forceinline__ uint32_t bswap32(uint32_t x) { return __byte_perm(x, 0, 0x0123); }

struct LeafSource {
  const uint8_t* mask;    // bool[n_items], or null to diff old vs new
  const uint64_t* old_v;  // u64[n_items]
  const uint64_t* new_v;  // u64[n_items]
  int64_t n_items;
  int per;                // values per leaf: 1 or 4
  uint32_t* leaf_rows;    // non-null: write the new chunk of each dirty leaf
};

// Is leaf `leaf` dirty? With `write`, also store its new packed chunk
// (the value little-endian in 8 bytes each, as big-endian u32 words).
__device__ __forceinline__ bool leaf_dirty(const LeafSource& s, int64_t leaf, bool write) {
  if (s.mask != nullptr) return leaf < s.n_items && s.mask[leaf] != 0;
  bool dirty = false;
  uint64_t v[4] = {0, 0, 0, 0};
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const int64_t i = leaf * s.per + q;
    if (q < s.per && i < s.n_items) {
      v[q] = s.new_v[i];
      dirty |= s.old_v[i] != v[q];
    }
  }
  if (dirty && write && s.leaf_rows != nullptr) {
    uint4* row = reinterpret_cast<uint4*>(s.leaf_rows + leaf * 8);
    row[0] = make_uint4(bswap32((uint32_t)v[0]), bswap32((uint32_t)(v[0] >> 32)),
                        bswap32((uint32_t)v[1]), bswap32((uint32_t)(v[1] >> 32)));
    row[1] = make_uint4(bswap32((uint32_t)v[2]), bswap32((uint32_t)(v[2] >> 32)),
                        bswap32((uint32_t)v[3]), bswap32((uint32_t)(v[3] >> 32)));
  }
  return dirty;
}

// Sum of v over the block; every thread gets the total.
__device__ __forceinline__ int block_sum(int v, int* scratch) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  if ((threadIdx.x & 31) == 0) scratch[threadIdx.x >> 5] = v;
  __syncthreads();
  int total = 0;
#pragma unroll
  for (int w = 0; w < kCompactWarps; ++w) total += scratch[w];
  __syncthreads();
  return total;
}

__global__ void __launch_bounds__(kCompactThreads)
dirty_compact_kernel(LeafSource s, int64_t n_leaves, int cap, int* __restrict__ idx,
                     int* __restrict__ count, int* __restrict__ block_counts) {
  cg::grid_group grid = cg::this_grid();
  __shared__ int scratch[kCompactWarps];
  const int64_t per_block = (n_leaves + gridDim.x - 1) / gridDim.x;
  const int64_t seg = (per_block + kCompactThreads - 1) / kCompactThreads * kCompactThreads;
  const int64_t lo = (int64_t)blockIdx.x * seg;
  const int64_t hi = lo + seg < n_leaves ? lo + seg : n_leaves;

  int mine = 0;
  for (int64_t leaf = lo + threadIdx.x; leaf < hi; leaf += kCompactThreads)
    mine += leaf_dirty(s, leaf, false);
  const int block_total = block_sum(mine, scratch);
  if (threadIdx.x == 0) block_counts[blockIdx.x] = block_total;
  grid.sync();

  int before = 0, all = 0;
  for (int b = threadIdx.x; b < (int)gridDim.x; b += kCompactThreads) {
    const int c = __ldcg(block_counts + b);
    all += c;
    if (b < (int)blockIdx.x) before += c;
  }
  before = block_sum(before, scratch);
  all = block_sum(all, scratch);

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int running = before;
  for (int64_t start = lo; start < hi; start += kCompactThreads) {
    const int64_t leaf = start + threadIdx.x;
    const bool dirty = leaf < hi && leaf_dirty(s, leaf, true);
    const unsigned ballot = __ballot_sync(0xffffffffu, dirty);
    if (lane == 0) scratch[warp] = __popc(ballot);
    __syncthreads();
    int offset = 0, round = 0;
#pragma unroll
    for (int w = 0; w < kCompactWarps; ++w) {
      const int c = scratch[w];
      offset += w < warp ? c : 0;
      round += c;
    }
    if (dirty) {
      const int pos = running + offset + __popc(ballot & ((1u << lane) - 1u));
      if (pos < cap) idx[pos] = static_cast<int>(leaf);
    }
    running += round;
    __syncthreads();
  }
  if (blockIdx.x == 0 && threadIdx.x == 0) *count = all;
  const int64_t stride = (int64_t)gridDim.x * kCompactThreads;
  for (int64_t p = all + (int64_t)blockIdx.x * kCompactThreads + threadIdx.x; p < cap; p += stride)
    idx[p] = 0;
}

// Most blocks of `kernel` that fit on the card at once: the bound of a
// cooperative launch. Queried once per device.
static int coresident_blocks(const void* kernel, int threads) {
  static int cache[64];
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev >= 64) return 0;
  if (cache[dev] == 0) {
    int sms = 0, per_sm = 0;
    if (cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess) return 0;
    if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, 0) != cudaSuccess)
      return 0;
    cache[dev] = sms * per_sm;
  }
  return cache[dev];
}

static int no_fit() {
  const cudaError_t err = cudaGetLastError();
  return static_cast<int>(err != cudaSuccess ? err : cudaErrorInvalidConfiguration);
}

// Dirty-leaf compaction of n_leaves leaves into idx[cap] (ascending, padded
// with 0) and *count. Either mask (bool[n_items]) is set, or old and new
// (u64[n_items], `per` values a leaf); leaf_rows (n_leaves x 8 words), when
// set with old/new, receives the new chunk of every dirty leaf.
// block_counts: scratch of scratch_len ints, at least one per block.
extern "C" int merkle_dirty_launch(const void* mask, const void* old_v, const void* new_v,
                                   int64_t n_items, int per, void* leaf_rows, int64_t n_leaves,
                                   int cap, void* idx, void* count, void* block_counts,
                                   int scratch_len, cudaStream_t stream) {
  if (n_leaves < 1 || n_leaves > (1LL << 31) - 1 || cap < 1 || per < 1 || per > 4 ||
      (mask == nullptr && (old_v == nullptr || new_v == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  const int fit = coresident_blocks((const void*)dirty_compact_kernel, kCompactThreads);
  if (fit <= 0) return no_fit();
  int64_t blocks = (n_leaves + kCompactThreads - 1) / kCompactThreads;
  blocks = blocks < fit ? blocks : fit;
  blocks = blocks < scratch_len ? blocks : scratch_len;
  LeafSource s{static_cast<const uint8_t*>(mask), static_cast<const uint64_t*>(old_v),
               static_cast<const uint64_t*>(new_v), n_items, per,
               static_cast<uint32_t*>(leaf_rows)};
  int* idx_p = static_cast<int*>(idx);
  int* count_p = static_cast<int*>(count);
  int* counts_p = static_cast<int*>(block_counts);
  void* args[] = {&s, &n_leaves, &cap, &idx_p, &count_p, &counts_p};
  const cudaError_t err = cudaLaunchCooperativeKernel((const void*)dirty_compact_kernel,
                                                      dim3((unsigned)blocks), dim3(kCompactThreads),
                                                      args, 0, stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}
