// K10: every item's G1 committee sum, spread over the card.
//
// Replaces eth_consensus_specs_tpu/ops/g1_msm.py sum_many_kernel (:168): the
// vmapped pairwise _tree_sum (:140) over the complete Jacobian _add (:80,
// add-2007-bl, every case chosen by mask) and _dbl (:55, dbl-2009-l), with
// the field from ops/field_limbs.py:75-196.
//
// The JAX tree pairs lane j with lane j + n/2 at every level. So the lanes
// j = c (mod C) of an item, for C a power of two, form a halving subtree of
// their own whose root lands on lane c, and the top log2(C) levels are the
// halving tree over those C roots. The kernel cuts an item's tree there and
// gives the same Jacobian words as the JAX program, not only the same point:
// - lanes passes (g1_sum_lanes_kernel), one launch each, while more than
//   kFoldPartials partials remain: each takes r <= kPassLevels levels off n
//   values, one thread an add at full occupancy. A block of kLaneThreads
//   threads holds kLaneThreads / 2^(r-1) residue classes of 2^r values; a
//   class's first level reads its value pairs from device memory, the next
//   levels halve it in shared memory, and the class root goes out as the
//   partial c of n / 2^r;
// - the fold (g1_sum_fold_kernel), one launch: a block an item over its at
//   most kFoldPartials partials, a warp an add on the cooperative round
//   engine's G1 complete add (curve_coop.cuh: 4 product rounds, the cases
//   read between add_a and add_b, four lanes a product), the halving tree
//   across the block's warps, then the canonical words.
// An item of L lanes takes ceil((log2 L - 5) / 8) lanes passes and the fold:
// one launch to L = 32, two to 2^13, three to 2^21 (ops/g1_msm.py
// sum_plan, which also renders kFoldPartials and kPassLevels into the
// generated g1_sum_plan.cuh). The add is branch-complete on both roads: a Z = 0 operand
// passes the other one through (the first operand tested first), P + P
// doubles, P + (-P) gives Z = 0 with the generic formula's X and Y, as the
// JAX select keeps them.
//
// Bound on the H100: integer throughput at the low levels (16 Fq products an
// add, L - 1 adds an item), the chain of log2(L) adds at the top. A one-
// thread add is 16 products in a row; the round engine's is 4 product
// rounds, so the levels where few adds remain take the warp.
//
// Inputs: X, Y, Z [I, L, 12] u32 words in Montgomery form (x * 2^384 mod p,
// bls_fp.cuh's own form, as the JAX kernel takes Montgomery rows), Z = 0 for
// infinity and padding lanes, L a power of two; output the Jacobian sums
// [I, 3, 12] in the same form, canonical. Partials between launches are
// [3, I, n, 12] (X, Y, Z planes), canonical. No conversion on the card.
#include "g1_jac.cuh"
#include "curve_coop.cuh"
#include "g1_sum_plan.cuh"

constexpr int kLaneThreads = 1 << (kPassLevels - 1);  // threads of a lanes block: 2^kPassLevels values
constexpr int kFoldGroups = kFoldPartials / 2;  // warps of the fold's block
constexpr int kFoldLanes = 4;      // lanes a product of the fold's adds
constexpr int kPt = CurveFam<kFamG1>::kPoint;
// a fold group: S, the accumulator, the second operand, one add's work
constexpr int kFoldSlots = CoopFam<kFamG1>::kSlots + 2 * kPt + kG1AddWork;
constexpr int kFoldStride = kFoldSlots * kFoldGroups;
static_assert(coop_op_fits(kProducts_g1_add_a1, kSums_g1_add_a1, 32, kFoldLanes) &&
              coop_op_fits(kProducts_g1_add_b1, kSums_g1_add_b1, 32, kFoldLanes) &&
              coop_op_fits(kProducts_g1_dbl1, kSums_g1_dbl1, 32, kFoldLanes) &&
              coop_op_fits(kProducts_g1_canon, kSums_g1_canon, 32, kFoldLanes),
              "a G1 op wider than a warp at its lanes");
static_assert(kFoldPartials >= 2 && kFoldPartials <= 64 && (kFoldPartials & (kFoldPartials - 1)) == 0,
              "the fold's block is a warp a pair of partials");

__device__ __forceinline__ void g1_store(uint32_t* X, uint32_t* Y, uint32_t* Z, int64_t at,
                                         const g1j& p) {
#pragma unroll
  for (int k = 0; k < 12; ++k) {
    X[at + k] = p.X.v[k];
    Y[at + k] = p.Y.v[k];
    Z[at + k] = p.Z.v[k];
  }
}

// n values an item -> n >> r partials; value pairs (k, k + 2^(r-1)) of class c
// are the item's j = c + k (n >> r) and j + n/2
__global__ __launch_bounds__(kLaneThreads) void g1_sum_lanes_kernel(
    const uint32_t* __restrict__ X, const uint32_t* __restrict__ Y, const uint32_t* __restrict__ Z,
    uint32_t* __restrict__ Xo, uint32_t* __restrict__ Yo, uint32_t* __restrict__ Zo, int64_t n,
    int r, int64_t bpi) {
  __shared__ g1j part[kLaneThreads];
  const int64_t item = blockIdx.x / bpi, chunk = blockIdx.x % bpi;
  const int64_t n_out = n >> r;
  const int half = 1 << (r - 1);  // the class's adds at its first level
  const int q = threadIdx.x / half, k = threadIdx.x % half;
  const int64_t c = chunk * (kLaneThreads / half) + q;
  const bool live = c < n_out;
  if (live) {
    const int64_t base = item * n * 12;
    g1j a, b;
    g1_load(a, X + base, Y + base, Z + base, c + k * n_out);
    g1_load(b, X + base, Y + base, Z + base, c + (k + half) * n_out);
    g1_add(part[threadIdx.x], a, b);
  }
  __syncthreads();
  for (int h = half >> 1; h >= 1; h >>= 1) {
    if (live && k < h) g1_add(part[threadIdx.x], part[threadIdx.x], part[threadIdx.x + h]);
    __syncthreads();
  }
  if (live && k == 0) g1_store(Xo, Yo, Zo, (item * n_out + c) * 12, part[threadIdx.x]);
}

// the halving tree over an item's n <= kFoldPartials partials, a warp an add
__global__ __launch_bounds__(kFoldGroups * 32) void g1_sum_fold_kernel(
    const uint32_t* __restrict__ X, const uint32_t* __restrict__ Y, const uint32_t* __restrict__ Z,
    uint32_t* __restrict__ out, int64_t n) {
  __shared__ uint32_t mem[12 * kFoldStride];
  __shared__ uint32_t tab[CoopFam<kFamG1>::kTableWords];
  const int64_t item = blockIdx.x;
  const int64_t base = item * n * 12;
  if (n == 1) {  // nothing to add: the lane as it is
    if (threadIdx.x < 12) {
      out[item * 36 + threadIdx.x] = X[base + threadIdx.x];
      out[item * 36 + 12 + threadIdx.x] = Y[base + threadIdx.x];
      out[item * 36 + 24 + threadIdx.x] = Z[base + threadIdx.x];
    }
    return;
  }
  coop_stage_table<kFamG1>(tab);
  const int grp = threadIdx.x / 32;
  const Coop g{mem, kFoldStride, grp * kFoldSlots, static_cast<int>(threadIdx.x % 32), 1 + grp,
               32, reinterpret_cast<const uint16_t*>(tab)};
  const int A = g.s + CoopFam<kFamG1>::kSlots, B = A + kPt, W = B + kPt;
  coop_init<kFamG1>(g);
  const int64_t half = n >> 1;  // the block has half warps
  const int64_t first = base + grp * 12, second = base + (grp + half) * 12;
  cc_load(g, A, X + first, 1);
  cc_load(g, A + 1, Y + first, 1);
  cc_load(g, A + 2, Z + first, 1);
  cc_load(g, B, X + second, 1);
  cc_load(g, B + 1, Y + second, 1);
  cc_load(g, B + 2, Z + second, 1);
  cc_add<kFamG1, kFoldLanes>(g, 1, A, B, W, A);
  __syncthreads();
  for (int h = static_cast<int>(half >> 1); h >= 1; h >>= 1) {
    if (grp < h) cc_add<kFamG1, kFoldLanes>(g, 1, A, A + h * kFoldSlots, W, A);
    __syncthreads();
  }
  if (grp == 0) {
    coop_run<kFoldLanes, kFamG1>(g, kOp_g1_canon, A, 0, 0, A);
    cc_store(g, out + item * 36, A, kPt);
  }
}

// X, Y, Z: u32[items, n, 12] Montgomery values (the lanes, or the last
// pass's planes); Xo, Yo, Zo: u32[items, n >> r, 12], 1 <= r <= kPassLevels
extern "C" int g1_sum_lanes_launch(const void* X, const void* Y, const void* Z, void* Xo,
                                   void* Yo, void* Zo, int64_t items, int64_t n, int r,
                                   cudaStream_t stream) {
  if (items < 1 || n < 2 || (n & (n - 1)) != 0 || r < 1 || r > kPassLevels || (n >> r) < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const int64_t bpi = (n + 2 * kLaneThreads - 1) / (2 * kLaneThreads);
  if (items * bpi > 0x7FFFFFFFLL) return static_cast<int>(cudaErrorInvalidValue);
  g1_sum_lanes_kernel<<<static_cast<unsigned>(items * bpi), kLaneThreads, 0, stream>>>(
      static_cast<const uint32_t*>(X), static_cast<const uint32_t*>(Y),
      static_cast<const uint32_t*>(Z), static_cast<uint32_t*>(Xo), static_cast<uint32_t*>(Yo),
      static_cast<uint32_t*>(Zo), n, r, bpi);
  return static_cast<int>(cudaGetLastError());
}

// X, Y, Z: u32[items, n, 12], n <= kFoldPartials a power of two; out:
// u32[items, 3, 12] Montgomery, canonical
extern "C" int g1_sum_fold_launch(const void* X, const void* Y, const void* Z, void* out,
                                  int64_t items, int64_t n, cudaStream_t stream) {
  if (items < 1 || items > 0x7FFFFFFFLL || n < 1 || n > kFoldPartials || (n & (n - 1)) != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int threads = n == 1 ? 32 : static_cast<int>(n / 2) * 32;
  g1_sum_fold_kernel<<<static_cast<unsigned>(items), threads, 0, stream>>>(
      static_cast<const uint32_t*>(X), static_cast<const uint32_t*>(Y),
      static_cast<const uint32_t*>(Z), static_cast<uint32_t*>(out), n);
  return static_cast<int>(cudaGetLastError());
}
