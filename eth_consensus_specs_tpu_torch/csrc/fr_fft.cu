// K16: a batch of radix-2 DIT FFTs over Fr, every row at once, spread over
// the whole card in one cooperative launch.
//
// Replaces eth_consensus_specs_tpu/ops/fr_fft.py fft_stages (:61), run by
// _compiled_fft (:101) under batch_fft_mont (:160), with the inverse's n^-1
// scaling (batch_fft_field :205-207): all log2(n) stages of the DIT over
// each row, stage l (half-size m = 2^l) pairing positions (g*2m + k,
// g*2m + k + m) with the twiddle w_m[k] = roots[k * n / (2m)].
//
// Layout. The stages are cut into passes of at most kMaxPass consecutive
// stages (the four-step split n = n1 * n2 of the DIT: 4,096 = 64 x 64 is
// two passes of 6, 8,192 two of 7 and 6; the host's fft_passes picks them).
// A pass over stages [a, a + s) falls apart into independent tiles of 2^s
// elements: the positions that share every bit outside [a, a + s), 2^a
// apart. A team of 2^(s-2) threads takes a tile, four elements a thread in
// registers, and runs the pass's stages two at a time (radix 4: the thread
// holds the four positions that differ in the two bits of those stages,
// and does both stages' four butterflies there), passing the tile through
// shared memory between those register phases, only within its warp. The
// first phase reads device memory (gathered by bit reversal when the rows
// are in natural order), the last writes it; the passes are separated by a
// grid barrier, so the intermediate rows stay in L2 (8 MB for 64 x 4,096)
// and no stage runs from device memory alone. A batch of rows becomes
// rows * n / 2^s tiles, some 16,000 at the KZG flush: every SM takes
// blocks, several at a time.
//
// Values are canonical words in and out, and stay canonical: each twiddle
// and the scale n^-1 arrive in Montgomery form (x * 2^256 mod r, uploaded
// once per root table by the wrapper), and fr_mul of a canonical value and
// a Montgomery constant is the canonical product (fr.cuh), so there is no
// conversion pass on either side. Input values must be below r. The
// twiddles are read through the read-only cache: a pass's tiles share them.
//
// Bound on the H100: the Fr products (n/2 log2(n) a row, and n more for an
// inverse's scaling, each tools/fq_mul_sass.py's count of SASS
// instructions) on both integer pipes, against the bytes (each row read
// once and written once).
#include <cooperative_groups.h>

#include "fr.cuh"

namespace cg = cooperative_groups;

constexpr int kThreads = 256;
constexpr int kMaxPass = 7;    // stages a pass: a tile of 128 elements, a team of one warp
constexpr int kMaxPasses = 4;  // up to 2^26 points
constexpr int kBlocksPerSm = 2;
constexpr int kSmem = kThreads * 4 * 32;  // every team's tile: four elements a thread

struct FftPasses {
  int count;
  int stages[kMaxPasses];
};

__device__ __forceinline__ void fr_ldg(fr& a, const uint32_t* p) {
  const uint4 lo = __ldg(reinterpret_cast<const uint4*>(p));
  const uint4 hi = __ldg(reinterpret_cast<const uint4*>(p) + 1);
  a.v[0] = lo.x; a.v[1] = lo.y; a.v[2] = lo.z; a.v[3] = lo.w;
  a.v[4] = hi.x; a.v[5] = hi.y; a.v[6] = hi.z; a.v[7] = hi.w;
}

// A value another block wrote before the last grid barrier: read past L1.
__device__ __forceinline__ void fr_ldcg(fr& a, const uint32_t* p) {
  const uint4 lo = __ldcg(reinterpret_cast<const uint4*>(p));
  const uint4 hi = __ldcg(reinterpret_cast<const uint4*>(p) + 1);
  a.v[0] = lo.x; a.v[1] = lo.y; a.v[2] = lo.z; a.v[3] = lo.w;
  a.v[4] = hi.x; a.v[5] = hi.y; a.v[6] = hi.z; a.v[7] = hi.w;
}

__device__ __forceinline__ void fr_st(uint4* p, const fr& a) {
  p[0] = make_uint4(a.v[0], a.v[1], a.v[2], a.v[3]);
  p[1] = make_uint4(a.v[4], a.v[5], a.v[6], a.v[7]);
}

__device__ __forceinline__ void fr_lds(fr& a, const uint4* p) {
  const uint4 lo = p[0], hi = p[1];
  a.v[0] = lo.x; a.v[1] = lo.y; a.v[2] = lo.z; a.v[3] = lo.w;
  a.v[4] = hi.x; a.v[5] = hi.y; a.v[6] = hi.z; a.v[7] = hi.w;
}

__device__ __forceinline__ int64_t bit_reverse(int64_t p, int log_n) {
  return log_n ? (int64_t)(__brevll((unsigned long long)p) >> (64 - log_n)) : 0;
}

// (x, y) <- (x + y w, x - y w), w the twiddle of stage ls at the lower
// position i: w_m[i mod m], m = 2^ls, row m - 1 + (i mod m) of the table.
__device__ __forceinline__ void butterfly(fr& x, fr& y, const uint32_t* tw, int ls, int64_t i) {
  const int64_t m = int64_t(1) << ls;
  fr w, t;
  fr_ldg(w, tw + (m - 1 + (i & (m - 1))) * 8);
  fr_mul(t, y, w);
  fr_sub(y, x, t);
  fr_add(x, x, t);
}

__global__ __launch_bounds__(kThreads, kBlocksPerSm) void fr_fft_kernel(
    const uint32_t* __restrict__ in, uint32_t* __restrict__ out, const uint32_t* __restrict__ tw,
    const uint32_t* __restrict__ scale, int64_t rows, int log_n, int bitrev, FftPasses plan) {
  extern __shared__ uint4 sm[];
  const int64_t n = int64_t(1) << log_n;
  fr sc;
  if (scale) fr_ldg(sc, scale);
  if (plan.count == 0) {  // n <= 2: a thread a row
    for (int64_t row = int64_t(blockIdx.x) * kThreads + threadIdx.x; row < rows;
         row += int64_t(gridDim.x) * kThreads) {
      fr x[2];
      for (int u = 0; u < n; ++u) fr_ldg(x[u], in + (row * n + (bitrev ? bit_reverse(u, log_n) : u)) * 8);
      if (n == 2) butterfly(x[0], x[1], tw, 0, 0);
      for (int u = 0; u < n; ++u) {
        if (scale) fr_mul(x[u], x[u], sc);
        fr_st(reinterpret_cast<uint4*>(out + (row * n + u) * 8), x[u]);
      }
    }
    return;
  }
  cg::grid_group grid = cg::this_grid();
  int a = 0;  // the pass's first stage
  for (int p = 0; p < plan.count; ++p) {
    const int s = plan.stages[p];
    const int team_threads = 1 << (s - 2), teams = kThreads >> (s - 2);
    const int team = threadIdx.x >> (s - 2), j = threadIdx.x & (team_threads - 1);
    const unsigned mask = team_threads == 32
                              ? 0xffffffffu
                              : ((1u << team_threads) - 1u) << ((threadIdx.x & 31) & ~(team_threads - 1));
    uint4* tile_sm = sm + (team << s) * 2;
    const int per_row_log = log_n - s;
    const int64_t tiles = rows << per_row_log;
    const bool first = p == 0, last = p == plan.count - 1;
    for (int64_t tile = int64_t(blockIdx.x) * teams + team; tile < tiles;
         tile += int64_t(gridDim.x) * teams) {
      const int64_t row = tile >> per_row_log;
      const int64_t tl = tile & ((int64_t(1) << per_row_log) - 1);
      const int64_t base = (tl & ((int64_t(1) << a) - 1)) | ((tl >> a) << (a + s));
      const uint32_t* src = (first ? in : out) + row * n * 8;
      uint32_t* dst = out + row * n * 8;
      fr x[4];
      const int phases = (s + 1) >> 1;
      for (int k = 0; k < phases; ++k) {
        // this phase's thread holds the four positions that differ in tile
        // bits q and q + 1 (the odd pass's last phase holds bits s-2, s-1)
        const int q = 2 * k < s - 2 ? 2 * k : s - 2;
        int loc[4];
        int64_t g[4];
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          loc[u] = (j & ((1 << q) - 1)) | (u << q) | ((j >> q) << (q + 2));
          g[u] = base + (int64_t(loc[u]) << a);
        }
        if (k == 0) {
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            if (first) fr_ldg(x[u], src + (bitrev ? bit_reverse(g[u], log_n) : g[u]) * 8);
            else fr_ldcg(x[u], src + g[u] * 8);
          }
        } else {
          __syncwarp(mask);  // the team's last phase is in shared memory
#pragma unroll
          for (int u = 0; u < 4; ++u) fr_lds(x[u], tile_sm + 2 * loc[u]);
        }
        if (q == 2 * k) {  // tile bit q: pairs (0, 1), (2, 3)
          butterfly(x[0], x[1], tw, a + q, g[0]);
          butterfly(x[2], x[3], tw, a + q, g[2]);
        }
        // tile bit q + 1 (q + 1 < s always): pairs (0, 2), (1, 3)
        butterfly(x[0], x[2], tw, a + q + 1, g[0]);
        butterfly(x[1], x[3], tw, a + q + 1, g[1]);
        if (k + 1 < phases) {
          // a thread writes back only the slots it read, so no barrier here
#pragma unroll
          for (int u = 0; u < 4; ++u) fr_st(tile_sm + 2 * loc[u], x[u]);
        } else {
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            if (last && scale) fr_mul(x[u], x[u], sc);
            fr_st(reinterpret_cast<uint4*>(dst + g[u] * 8), x[u]);
          }
        }
      }
      __syncwarp(mask);  // every slot of this tile is read before the next tile's
    }
    a += s;
    if (!last) grid.sync();
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
    if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fr_fft_kernel, kThreads, kSmem) !=
        cudaSuccess)
      return 0;
    cache[dev] = sms * (per_sm < kBlocksPerSm ? per_sm : kBlocksPerSm);
  }
  return cache[dev];
}

// in: u32[rows, 2^log_n, 8] canonical values (read only); out: the same
// shape, written; tw: u32[2^log_n - 1, 8] Montgomery twiddles, stage m at
// rows m - 1 .. 2m - 2; scale: null or u32[8] Montgomery, applied after the
// last stage; bitrev: 1 when the rows are in natural order (gathered by bit
// reversal on load), 0 when they are already in the DIT's input order;
// stages: `passes` host ints, each pass's stage count (2..kMaxPass, summing
// to log_n; no pass for log_n < 2).
extern "C" int fr_fft_launch(const void* in, void* out, const void* tw, const void* scale,
                             int64_t rows, int log_n, int bitrev, const int* stages, int passes,
                             cudaStream_t stream) {
  if (rows < 1 || log_n < 0 || log_n > 26 || passes < 0 || passes > kMaxPasses ||
      (passes == 0) != (log_n < 2))
    return static_cast<int>(cudaErrorInvalidValue);
  FftPasses plan = {};
  plan.count = passes;
  int total = 0;
  for (int p = 0; p < passes; ++p) {
    if (stages[p] < 2 || stages[p] > kMaxPass) return static_cast<int>(cudaErrorInvalidValue);
    plan.stages[p] = stages[p];
    total += stages[p];
  }
  if (passes && total != log_n) return static_cast<int>(cudaErrorInvalidValue);
  const int fit = resident_blocks();
  if (fit <= 0) {
    const cudaError_t err = cudaGetLastError();
    return static_cast<int>(err != cudaSuccess ? err : cudaErrorInvalidConfiguration);
  }
  const int64_t threads = passes ? (rows << log_n) / 4 : rows;
  const int64_t want = (threads + kThreads - 1) / kThreads;
  const int blocks = int(want < fit ? want : fit);
  const uint32_t* in_p = static_cast<const uint32_t*>(in);
  uint32_t* out_p = static_cast<uint32_t*>(out);
  const uint32_t* tw_p = static_cast<const uint32_t*>(tw);
  const uint32_t* scale_p = static_cast<const uint32_t*>(scale);
  void* args[] = {&in_p, &out_p, &tw_p, &scale_p, &rows, &log_n, &bitrev, &plan};
  const cudaError_t err = cudaLaunchCooperativeKernel((const void*)fr_fft_kernel, dim3(blocks),
                                                      dim3(kThreads), args, kSmem, stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}
