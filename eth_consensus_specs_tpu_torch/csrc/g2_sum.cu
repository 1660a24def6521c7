// K15: every item's G2 committee sum (the aggregate signature of each ragged
// committee), spread over the card.
//
// Replaces eth_consensus_specs_tpu/ops/g2_aggregate.py g2_sum_many_kernel
// (:103): the log-depth butterfly fold _lane_fold (:69), which at each step s
// adds every lane to its lane XOR 2^s partner, over the complete
// g2_jacobian.g2_add (:95). Lane 0 of that butterfly is the adjacent-pair
// tree: ((L0 + L1) + (L2 + L3)) + ..., the lower half always first. The
// kernels compute that tree and nothing else, so their Jacobian words equal
// the plain version's (ops/g2_aggregate.py _lane_fold), not only its points.
//
// The tree's subtrees are contiguous blocks of lanes, so an item's tree cuts
// into passes, each taking r levels off contiguous blocks of 2^r values and
// leaving a partial a block, one launch a pass, as ops/g2_aggregate.py
// sum_plan lays them out (its depths rendered into the generated
// g2_sum_plan.cuh):
// - lanes passes (g2_sum_lanes_kernel), while a level has many adds over
//   the items: one thread an add, on g2_jac.cuh's one-thread complete add
//   (43 Fq products in a row); a block of kLaneThreads threads holds
//   kLaneThreads / 2^(r-1) blocks of values, reads each pair of its first
//   level from device memory and takes the next levels in shared memory;
// - warp passes (g2_sum_fold_kernel), the last levels: a block of 2^(r-1)
//   warps a block of values, a warp an add on the cooperative round engine's
//   G2 complete add (curve_coop.cuh: 4 product rounds of up to 18 products,
//   one thread a product, the cases read between add_a and add_b), then the
//   canonical words. The last warp pass leaves one partial an item: the sum.
// Every add's operands are (lower block, upper block), through a complete
// add that gives the plain formula's words in every case: a Z = 0 operand
// passes the other through (the second operand tested first), P + P
// doubles, P + (-P) keeps the generic formula's X3 and Y3 with Z3 = 0.
//
// Bound on the H100: the chain of log2(L) adds (a warp add is 4 product
// rounds), or the throughput of L - 1 adds an item of 43 products each. A
// one-thread add is 43 dependent products; a warp add 4 rounds. So the plan
// takes one-thread adds while a level's adds fill the card many times over,
// and warp adds where few remain.
//
// Inputs: X, Y, Z [I, L, 2, 12] u32 words in bls_fp.cuh's Montgomery form
// (x * 2^384 mod p, as the JAX kernel takes Montgomery rows), Z = 0 for
// infinity and padding lanes, L a power of two; partials between passes and
// the output [I, n, 3, 2, 12] in the same form, canonical (the output n = 1).
#include "g2_jac.cuh"
#include "curve_coop.cuh"
#include "g2_sum_plan.cuh"

constexpr int kLaneThreads = 1 << (kPassLevels - 1);  // threads of a lanes block: 2^kPassLevels values
constexpr int kFoldWarps = 1 << (kFoldLevels - 1);    // warps of the widest warp pass
constexpr int kPt = CurveFam<kFamG2>::kPoint;
// a warp's group: S, its accumulator, the second operand, one add's work
constexpr int kFoldSlots = CoopFam<kFamG2>::kSlots + 2 * kPt + kG2AddWork;
static_assert(coop_op_fits(kProducts_g2_add_a1, kSums_g2_add_a1, 32, 1) &&
              coop_op_fits(kProducts_g2_add_b1, kSums_g2_add_b1, 32, 1) &&
              coop_op_fits(kProducts_g2_dbl1, kSums_g2_dbl1, 32, 1) &&
              coop_op_fits(kProducts_g2_canon, kSums_g2_canon, 32, 1),
              "a G2 op wider than a warp");
static_assert(kFoldLevels >= 1 && kFoldLevels <= 4 && kPassLevels >= 1 && kPassLevels <= 8,
              "a pass's block: at most 8 warps (static shared memory), at most 128 threads");

// value v of the source: X, Y, Z words at v * ps
__device__ __forceinline__ void g2_load_at(g2j& p, const uint32_t* X, const uint32_t* Y,
                                           const uint32_t* Z, int64_t ps, int64_t v) {
  fp2_read(p.X, X + v * ps);
  fp2_read(p.Y, Y + v * ps);
  fp2_read(p.Z, Z + v * ps);
}

// n values an item -> n >> r partials, one thread an add; value pairs (2k,
// 2k + 1) of block c are the item's values c 2^r + 2k and c 2^r + 2k + 1
__global__ __launch_bounds__(kLaneThreads) void g2_sum_lanes_kernel(
    const uint32_t* __restrict__ X, const uint32_t* __restrict__ Y, const uint32_t* __restrict__ Z,
    int64_t ps, uint32_t* __restrict__ out, int64_t n, int r, int64_t bpi) {
  __shared__ g2j part[kLaneThreads];
  const int64_t item = blockIdx.x / bpi, chunk = blockIdx.x % bpi;
  const int64_t n_out = n >> r;
  const int half = 1 << (r - 1);  // a block of values' adds at its first level
  const int q = threadIdx.x / half, k = threadIdx.x % half;
  const int64_t c = chunk * (kLaneThreads / half) + q;
  const bool live = c < n_out;
  g2j* mine = part + q * half;
  if (live) {
    const int64_t v = item * n + (c << r) + 2 * k;
    g2j a, b;
    g2_load_at(a, X, Y, Z, ps, v);
    g2_load_at(b, X, Y, Z, ps, v + 1);
    g2_add(mine[k], a, b);
  }
  __syncthreads();
  for (int s = 1; s < half; s <<= 1) {  // partial 2ks takes 2ks + s
    if (live && k < half / (2 * s)) g2_add(mine[2 * k * s], mine[2 * k * s], mine[2 * k * s + s]);
    __syncthreads();
  }
  if (live && k == 0) {
    uint32_t* o = out + (item * n_out + c) * 72;
    fp2_write(o, mine[0].X);
    fp2_write(o + 24, mine[0].Y);
    fp2_write(o + 48, mine[0].Z);
  }
}

// n values an item -> n >> r partials, a block a partial, a warp an add on
// the round engine; r = 0 copies each value
__global__ __launch_bounds__(kFoldWarps * 32) void g2_sum_fold_kernel(
    const uint32_t* __restrict__ X, const uint32_t* __restrict__ Y, const uint32_t* __restrict__ Z,
    int64_t ps, uint32_t* __restrict__ out, int64_t n, int r) {
  __shared__ uint32_t mem[12 * kFoldSlots * kFoldWarps];
  __shared__ uint32_t tab[CoopFam<kFamG2>::kTableWords];
  const int64_t bpi = n >> r, item = blockIdx.x / bpi, c = blockIdx.x % bpi;
  const int64_t first = item * n + (c << r);
  uint32_t* o = out + (item * bpi + c) * 72;
  if (r == 0) {  // nothing to add: the value as it is
    for (int i = threadIdx.x; i < 24; i += blockDim.x) {
      o[i] = X[first * ps + i];
      o[24 + i] = Y[first * ps + i];
      o[48 + i] = Z[first * ps + i];
    }
    return;
  }
  coop_stage_table<kFamG2>(tab);
  const int warps = 1 << (r - 1), grp = threadIdx.x / 32;
  const Coop g{mem, kFoldSlots * warps, grp * kFoldSlots, static_cast<int>(threadIdx.x % 32),
               1 + grp, 32, reinterpret_cast<const uint16_t*>(tab)};
  const int A = g.s + CoopFam<kFamG2>::kSlots, B = A + kPt, W = B + kPt;
  coop_init<kFamG2>(g);
  const int64_t v = first + 2 * grp;
  cc_load(g, A, X + v * ps, 2);
  cc_load(g, A + 2, Y + v * ps, 2);
  cc_load(g, A + 4, Z + v * ps, 2);
  cc_load(g, B, X + (v + 1) * ps, 2);
  cc_load(g, B + 2, Y + (v + 1) * ps, 2);
  cc_load(g, B + 4, Z + (v + 1) * ps, 2);
  cc_add<kFamG2>(g, 1, A, B, W, A);
  __syncthreads();
  for (int s = 1; s < warps; s <<= 1) {  // warp 2ks takes warp 2ks + s's partial
    if (grp % (2 * s) == 0) cc_add<kFamG2>(g, 1, A, A + s * kFoldSlots, W, A);
    __syncthreads();
  }
  if (grp == 0) {
    coop_run<1, kFamG2>(g, kOp_g2_canon, A, 0, 0, A);
    cc_store(g, o, A, kPt);
  }
}

// X, Y, Z: the values' words at v * ps (ps = 24: the lanes' planes; 72: the
// last pass's partials [I, n, 3, 2, 12]); out: u32[items, n >> r, 3, 2, 12]
extern "C" int g2_sum_lanes_launch(const void* X, const void* Y, const void* Z, int64_t ps,
                                   void* out, int64_t items, int64_t n, int r,
                                   cudaStream_t stream) {
  if (items < 1 || n < 2 || (n & (n - 1)) != 0 || r < 1 || r > kPassLevels || (n >> r) < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const int64_t per = kLaneThreads >> (r - 1);  // blocks of values a thread block takes
  const int64_t bpi = ((n >> r) + per - 1) / per;
  if (items * bpi > 0x7FFFFFFFLL) return static_cast<int>(cudaErrorInvalidValue);
  g2_sum_lanes_kernel<<<static_cast<unsigned>(items * bpi), kLaneThreads, 0, stream>>>(
      static_cast<const uint32_t*>(X), static_cast<const uint32_t*>(Y),
      static_cast<const uint32_t*>(Z), ps, static_cast<uint32_t*>(out), n, r, bpi);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int g2_sum_fold_launch(const void* X, const void* Y, const void* Z, int64_t ps,
                                  void* out, int64_t items, int64_t n, int r,
                                  cudaStream_t stream) {
  if (items < 1 || n < 1 || (n & (n - 1)) != 0 || r < 0 || r > kFoldLevels || (n >> r) < 1 ||
      items * (n >> r) > 0x7FFFFFFFLL)
    return static_cast<int>(cudaErrorInvalidValue);
  const int warps = r == 0 ? 1 : 1 << (r - 1);
  g2_sum_fold_kernel<<<static_cast<unsigned>(items * (n >> r)), warps * 32, 0, stream>>>(
      static_cast<const uint32_t*>(X), static_cast<const uint32_t*>(Y),
      static_cast<const uint32_t*>(Z), ps, static_cast<uint32_t*>(out), n, r);
  return static_cast<int>(cudaGetLastError());
}
