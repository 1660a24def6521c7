// K8: every swap-or-not round of the whole-permutation shuffle, one launch.
//
// Replaces eth_consensus_specs_tpu/ops/shuffle.py _device_shuffle_kernel
// (:78), whose body is a fori_loop of `rounds` whole-array passes: flip,
// max, a gather from the digest table and a select over all n lanes each
// round. Per lane the permutation is perm[i] = g_{R-1}(... g_0(i)), with
//
//   g_r(j) = bit_r(max(j, flip_r(j))) ? flip_r(j) : j,
//   flip_r(j) = (pivot_r - j) mod n.
//
// Run lane by lane, each round reads one table word at a scattered
// position, a whole 32-byte L2 sector for 4 bytes. Here the rounds run as
// whole-array steps in reverse instead: X starts as the identity and step
// r = R-1 ... 0 sets X'[j] = X[g_r(j)], which leaves X = perm. g_r is an
// involution: it pairs j with f = flip_r(j) and swaps the pair where the
// decision bit at max(j, f) is set. So a step is a set of disjoint swaps,
// done in place on the output: a thread takes a pair (j, f), j < f, reads
// the bit at f, and where it is set reads X[j] and X[f] and writes them
// back crossed (the first step writes the identity's values; the one or two
// fixed points j == f keep theirs). The pairs are j in [0, ceil(p/2)) with
// f = p - j, and j in [p + 1, (p + n + 1) / 2) with f = p + n - j, so for
// consecutive pairs both j and f are runs of consecutive addresses (f
// descending) and a warp's reads of X and of the decision bits each touch a
// few contiguous sectors. A step moves each word of X at most once in and
// once out through L2 (4 MB at 2^20 lanes, which stays in the 50 MB L2)
// plus half the round's table (chunks x 32 B, 128 KB at 2^20).
//
// One persistent cooperative launch: at most two blocks of 512 threads an
// SM (all resident), each thread a grid-stride set of pairs, four at a time
// so their loads overlap, and a grid.sync() between steps (R - 1 of them);
// a thread reads its first batch's decision bits for the next step before
// the barrier. The pivots sit in shared memory; X written by other blocks
// before a barrier is read past L1 (__ldcg), the table through the
// read-only path.
//
// Bound on the H100: about 16 integer instructions per lane and round (the
// operations bound), and the 8n bytes a step moves through L2; the R - 1
// barriers add about 1.1 us each.
//
// Hazards handled: C's % of a negative number is negative, so the pairs
// are enumerated from the pivot instead of taking a mod (JAX's jnp.mod
// floors); the decision byte is taken from a big-endian digest word; the
// last chunk may be short (n not a multiple of 256), which only means no
// position reads past it.
#include <cooperative_groups.h>

#include "common.cuh"

namespace cg = cooperative_groups;

constexpr int kMaxRounds = 256;  // the round is one byte of the hashed message
constexpr int kThreads = 512;
constexpr int kBlocksPerSm = 2;
constexpr int kBatch = 4;  // pairs a thread holds in flight a step

// The decision bit of position pos in one round's table.
__device__ __forceinline__ bool decision(const uint32_t* __restrict__ table, int32_t pos) {
  const uint32_t in_chunk = static_cast<uint32_t>(pos & 255);
  const uint32_t word = __ldg(table + (pos >> 8) * 8 + (in_chunk >> 5));
  const uint32_t byte_idx = in_chunk >> 3;
  const uint32_t byte = (word >> (8 * (3 - (byte_idx & 3)))) & 0xFFu;
  return (byte >> (in_chunk & 7)) & 1u;
}

// A thread's batch of pairs m0 + k * stride in round r: their ends and
// whether they swap. Depends on the pivots and the table alone, so the next
// step's first batch is read before the barrier.
struct Batch {
  int32_t j[kBatch], f[kBatch];
  bool swap[kBatch];
};

__device__ __forceinline__ void plan(Batch& b, const uint32_t* __restrict__ digests,
                                     int64_t num_chunks, int64_t p, int32_t n, int64_t m0,
                                     int64_t stride, int r) {
  const uint32_t* table = digests + int64_t(r) * num_chunks * 8;
  const int64_t low = (p + 1) / 2;                  // pairs (j, p - j), j < low
  const int64_t pairs = low + (p + n - 1) / 2 - p;  // then (j, p + n - j), j > p
#pragma unroll
  for (int k = 0; k < kBatch; ++k) {
    const int64_t m = m0 + k * stride;
    b.j[k] = int32_t(m < low ? m : p + 1 + (m - low));
    b.f[k] = int32_t(m < low ? p - m : p + n - b.j[k]);
    b.swap[k] = m < pairs && decision(table, b.f[k]);
  }
}

__global__ void __launch_bounds__(kThreads, kBlocksPerSm)
    shuffle_rounds_kernel(const uint32_t* __restrict__ digests, const int32_t* __restrict__ pivots,
                          int32_t* out, int32_t n, int rounds, int64_t num_chunks) {
  cg::grid_group grid = cg::this_grid();
  __shared__ int32_t piv[kMaxRounds];
  for (int r = threadIdx.x; r < rounds; r += blockDim.x) piv[r] = pivots[r];
  __syncthreads();
  const int64_t stride = int64_t(gridDim.x) * kThreads;
  const int64_t tid = int64_t(blockIdx.x) * kThreads + threadIdx.x;
  if (rounds == 0) {
    for (int64_t j = tid; j < n; j += stride) out[j] = int32_t(j);
    return;
  }
  Batch next;
  plan(next, digests, num_chunks, piv[rounds - 1], n, tid, stride, rounds - 1);
  for (int r = rounds - 1; r >= 0; --r) {
    const int64_t p = piv[r];
    const int64_t pairs = (p + 1) / 2 + (p + n - 1) / 2 - p;
    const bool first = r == rounds - 1;  // X is the identity
    if (first && tid == 0) {             // the fixed points
      if (p % 2 == 0) out[p / 2] = int32_t(p / 2);
      if ((p + n) % 2 == 0) out[(p + n) / 2] = int32_t((p + n) / 2);
    }
    for (int64_t m0 = tid; m0 < pairs; m0 += kBatch * stride) {
      Batch b = next;
      if (m0 != tid) plan(b, digests, num_chunks, p, n, m0, stride, r);
      int32_t xj[kBatch], xf[kBatch];
#pragma unroll
      for (int k = 0; k < kBatch; ++k) {
        xj[k] = b.j[k];
        xf[k] = b.f[k];
        if (b.swap[k] && !first) {
          xj[k] = __ldcg(out + b.j[k]);
          xf[k] = __ldcg(out + b.f[k]);
        }
      }
#pragma unroll
      for (int k = 0; k < kBatch; ++k) {
        if (m0 + k * stride >= pairs || !(b.swap[k] || first)) continue;
        out[b.j[k]] = b.swap[k] ? xf[k] : xj[k];
        out[b.f[k]] = b.swap[k] ? xj[k] : xf[k];
      }
    }
    if (r > 0) {
      plan(next, digests, num_chunks, piv[r - 1], n, tid, stride, r - 1);
      grid.sync();
    }
  }
}

// Most blocks of the kernel that fit on the card at once, kBlocksPerSm an
// SM at most, queried once per device.
static int resident_blocks() {
  static int cache[64];
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev >= 64) return 0;
  if (cache[dev] == 0) {
    int sms = 0, per_sm = 0;
    if (cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess) return 0;
    if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, shuffle_rounds_kernel, kThreads, 0) !=
        cudaSuccess)
      return 0;
    cache[dev] = sms * (per_sm < kBlocksPerSm ? per_sm : kBlocksPerSm);
  }
  return cache[dev];
}

// digests: rounds x num_chunks x 8 big-endian words; pivots: int32[rounds]
// in [0, n); out: int32[n].
extern "C" int shuffle_rounds_launch(const void* digests, const void* pivots, void* out,
                                     int64_t n, int rounds, int64_t num_chunks,
                                     cudaStream_t stream) {
  if (n < 1 || n > 0x7FFFFFFFLL || rounds < 0 || rounds > kMaxRounds ||
      num_chunks != (n + 255) / 256)
    return static_cast<int>(cudaErrorInvalidValue);
  const int fit = resident_blocks();
  if (fit <= 0) {
    const cudaError_t err = cudaGetLastError();
    return static_cast<int>(err != cudaSuccess ? err : cudaErrorInvalidConfiguration);
  }
  const int64_t want = (n / 2 + kThreads) / kThreads;  // the pairs, or one lane
  const int blocks = int(want < fit ? want : fit);
  const uint32_t* digests_p = static_cast<const uint32_t*>(digests);
  const int32_t* pivots_p = static_cast<const int32_t*>(pivots);
  int32_t* out_p = static_cast<int32_t*>(out);
  int32_t n32 = static_cast<int32_t>(n);
  void* args[] = {&digests_p, &pivots_p, &out_p, &n32, &rounds, &num_chunks};
  const cudaError_t err = cudaLaunchCooperativeKernel((const void*)shuffle_rounds_kernel,
                                                      dim3(blocks), dim3(kThreads), args, 0, stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}
