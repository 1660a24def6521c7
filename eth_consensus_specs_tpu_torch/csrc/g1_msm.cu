// K17: every item's full-scalar G1 multi-scalar multiplication, on the
// cooperative round engine (curve_coop.cuh).
//
// Replaces eth_consensus_specs_tpu/ops/g1_msm.py msm_many_kernel (:183),
// which vmaps _msm_lanes (:175) over items: _scalar_mul_lane (:119), a
// 256-step MSB-first double-and-add per lane, then the pairwise _tree_sum
// (:140) over the lanes. msm_kernel (:153) is this kernel with one item. The
// point formulas are K10's (dbl-2009-l and the complete add-2007-bl).
//
// What bounds it on the H100: a chain of dependent Fq products, not the
// card's throughput (a 64-blob flush is [2, 129]: 386 lanes of work). So the
// design shortens the chain and spreads the lanes over the SMs:
// - The endomorphism's half scalars. phi(x, y) = (beta x, y) acts on the
//   r-torsion as [lambda], lambda = z^2 - 1 (128 bits), and r = lambda^2 +
//   lambda + 1, so k mod r = k1 + k2 lambda with k1 = k mod lambda and k2 =
//   k div lambda both below 2^128: a lane (k, P) is the two half-lanes (k1,
//   P) and (k2, phi(P)), phi one product. This holds only for points in the
//   r-torsion, which every caller gives (kzg_batch subgroup-checks
//   commitments and proofs; the setup's points and G are multiples of G).
// - 4-bit windows: each half-lane builds its table T1..T15 (a doubling, an
//   add, a doubling, three adds at once, a doubling, four and three adds at
//   once), then from its top nonzero window runs four doublings (one dbl4
//   program, 12 product rounds) and an add of T[d] for a nonzero digit d a
//   window: about 127 doublings and 31 adds.
// - A warp a half-lane, kGroups half-lanes a block, blocks over the SMs.
//   The ladder's ops (dbl4, a single add, at most 6 products a round) run on
//   kLanes = 4 lanes a product (on the card 1.5x faster than one lane,
//   PERF.md), the table's wider adds a product a thread. A block's sums by
//   the halving tree in shared memory (group j takes j + n/2), then, where
//   an item spans several blocks, a second launch (g1_msm_fold) in which
//   kFoldGroups groups each sum the block partials j, j + kFoldGroups, ... in
//   turn and then halve. Nothing is atomic, so the words never change from
//   run to run; the plain twin (ops/g1_msm.py msm_many_ref) runs these same
//   steps and gives these same words. A half-lane past the item's lanes or
//   with a zero half scalar is infinity as all-zero words.
//
// Inputs: K u32[I, L, 8] scalars (little-endian words, any 256-bit value: the
// split reduces mod r first); X, Y, Z u32[I, L, 12] affine or Jacobian points
// in bls_fp.cuh's Montgomery form (x * 2^384 mod p), Z = 0 for infinity and
// padding lanes. Output: the Jacobian sums u32[I, 3, 12] in the same form,
// canonical.
#include "curve_coop.cuh"

constexpr int kGroups = 4;       // half-lanes a block, a warp each
constexpr int kFoldGroups = 16;  // groups of the fold's block
constexpr int kLanes = 4;        // lanes a product of the ladder's ops and the sums
constexpr int kPt = CurveFam<kFamG1>::kPoint;
// a lane group: S, the table T1..T15, the accumulator, the table's widest add's work
constexpr int kLaneSlots = CoopFam<kFamG1>::kSlots + 15 * kPt + kPt + 4 * kG1AddWork;
constexpr int kLaneStride = kLaneSlots * kGroups;
// a fold group: S, the accumulator, a partial, one add's work
constexpr int kFoldSlots = CoopFam<kFamG1>::kSlots + 2 * kPt + kG1AddWork;
constexpr int kFoldStride = kFoldSlots * kFoldGroups;
// the ops on kLanes lanes, the table's adds on one
static_assert(coop_op_fits(kProducts_g1_dbl4, kSums_g1_dbl4, 32, kLanes) &&
              coop_op_fits(kProducts_g1_dbl1, kSums_g1_dbl1, 32, kLanes) &&
              coop_op_fits(kProducts_g1_add_a1, kSums_g1_add_a1, 32, kLanes) &&
              coop_op_fits(kProducts_g1_add_b1, kSums_g1_add_b1, 32, kLanes) &&
              coop_op_fits(kProducts_g1_phi, kSums_g1_phi, 32, kLanes) &&
              coop_op_fits(kProducts_g1_canon, kSums_g1_canon, 32, kLanes) &&
              coop_op_fits(kProducts_g1_add_a4, kSums_g1_add_a4, 32, 1) &&
              coop_op_fits(kProducts_g1_add_b4, kSums_g1_add_b4, 32, 1) &&
              coop_op_fits(kProducts_g1_add_a3, kSums_g1_add_a3, 32, 1) &&
              coop_op_fits(kProducts_g1_add_b3, kSums_g1_add_b3, 32, 1),
              "a G1 op wider than a warp at its lanes");

__device__ __forceinline__ bool words_lt(const uint32_t* a, const uint32_t* b, int n) {
  for (int k = n - 1; k >= 0; --k)
    if (a[k] != b[k]) return a[k] < b[k];
  return false;
}

__device__ __forceinline__ void words_sub(uint32_t* a, const uint32_t* b, int n) {
  int64_t c = 0;
  for (int k = 0; k < n; ++k) {
    c += static_cast<int64_t>(a[k]) - b[k];
    a[k] = static_cast<uint32_t>(c);
    c >>= 32;
  }
}

// h = k mod lambda (half 0) or k div lambda (half 1) of k mod r, 4 words;
// k < 2^256 < 3r, so k mod r takes at most two subtractions
__device__ __noinline__ void glv_half(uint32_t* h, const uint32_t* k_in, int half) {
  uint32_t k[8], rr[8], lam[5], rem[5] = {0, 0, 0, 0, 0}, q[8] = {0, 0, 0, 0, 0, 0, 0, 0};
  for (int i = 0; i < 8; ++i) {
    k[i] = k_in[i];
    rr[i] = FR_R_WORDS[i];
  }
  for (int i = 0; i < 4; ++i) lam[i] = GLV_LAMBDA_WORDS[i];
  lam[4] = 0;
  for (int t = 0; t < 2; ++t)
    if (!words_lt(k, rr, 8)) words_sub(k, rr, 8);
  for (int bit = 254; bit >= 0; --bit) {  // k < r < 2^255
    for (int i = 4; i > 0; --i) rem[i] = (rem[i] << 1) | (rem[i - 1] >> 31);
    rem[0] = (rem[0] << 1) | ((k[bit >> 5] >> (bit & 31)) & 1u);
    if (!words_lt(rem, lam, 5)) {
      words_sub(rem, lam, 5);
      q[bit >> 5] |= 1u << (bit & 31);
    }
  }
  for (int i = 0; i < 4; ++i) h[i] = half ? q[i] : rem[i];
}

__global__ __launch_bounds__(kGroups * 32) void g1_msm_lanes_kernel(
    const uint32_t* __restrict__ K, const uint32_t* __restrict__ X, const uint32_t* __restrict__ Y,
    const uint32_t* __restrict__ Z, uint32_t* __restrict__ out, uint32_t* __restrict__ partials,
    int64_t lanes, int64_t bpi) {
  __shared__ uint32_t mem[12 * kLaneStride];
  __shared__ uint32_t tab[CoopFam<kFamG1>::kTableWords];
  __shared__ uint32_t halves[kGroups][4];
  coop_stage_table<kFamG1>(tab);
  const int grp = threadIdx.x / 32;
  const Coop g{mem, kLaneStride, grp * kLaneSlots, static_cast<int>(threadIdx.x % 32), 1 + grp,
               32, reinterpret_cast<const uint16_t*>(tab)};
  const int64_t item = blockIdx.x / bpi, chunk = blockIdx.x % bpi;
  const int64_t hl = chunk * kGroups + grp, lane = hl >> 1;
  const int T = g.s + CoopFam<kFamG1>::kSlots, A = T + 15 * kPt, W = A + kPt;
  coop_init<kFamG1>(g);
  if (g.tid == 0) {
    if (lane < lanes) {
      glv_half(halves[grp], K + (item * lanes + lane) * 8, static_cast<int>(hl & 1));
    } else {
      for (int i = 0; i < 4; ++i) halves[grp][i] = 0;
    }
  }
  __syncwarp();
  uint32_t h[4];
  for (int i = 0; i < 4; ++i) h[i] = halves[grp][i];
  int top = 31;
  while (top >= 0 && ((h[top >> 3] >> ((top & 7) * 4)) & 15u) == 0) --top;
  if (top < 0) {
    cc_clear(g, A, kPt);
  } else {
    const int64_t at = (item * lanes + lane) * 12;
    cc_load(g, T, X + at, 1);
    cc_load(g, T + 1, Y + at, 1);
    cc_load(g, T + 2, Z + at, 1);
    if (hl & 1) coop_run<kLanes, kFamG1>(g, kOp_g1_phi, T, 0, 0, T);
    auto t = [&](int j) { return T + (j - 1) * kPt; };
    coop_run<kLanes, kFamG1>(g, kOp_g1_dbl1, t(1), 0, 0, t(2));
    cc_add<kFamG1, kLanes>(g, 1, t(2), t(1), W, t(3));
    coop_run<kLanes, kFamG1>(g, kOp_g1_dbl1, t(2), 0, 0, t(4));
    cc_add<kFamG1>(g, 3, t(4), t(1), W, t(5));  // T5..T7 = T4 + T1..T3
    coop_run<kLanes, kFamG1>(g, kOp_g1_dbl1, t(4), 0, 0, t(8));
    cc_add<kFamG1>(g, 4, t(8), t(1), W, t(9));   // T9..T12 = T8 + T1..T4
    cc_add<kFamG1>(g, 3, t(8), t(5), W, t(13));  // T13..T15 = T8 + T5..T7
    cc_copy(g, A, t((h[top >> 3] >> ((top & 7) * 4)) & 15u), kPt);
    for (int w = top - 1; w >= 0; --w) {
      coop_run<kLanes, kFamG1>(g, kOp_g1_dbl4, A, 0, 0, A);
      const int d = (h[w >> 3] >> ((w & 7) * 4)) & 15u;
      if (d) cc_add<kFamG1, kLanes>(g, 1, A, t(d), W, A);
    }
  }
  __syncthreads();
  for (int half = kGroups / 2; half >= 1; half >>= 1) {
    if (grp < half) cc_add<kFamG1, kLanes>(g, 1, A, A + half * kLaneSlots, W, A);
    __syncthreads();
  }
  if (grp == 0) {
    if (bpi == 1) {
      coop_run<kLanes, kFamG1>(g, kOp_g1_canon, A, 0, 0, A);
      cc_store(g, out + item * 36, A, kPt);
    } else {
      cc_store(g, partials + (item * bpi + chunk) * 36, A, kPt);
    }
  }
}

__global__ __launch_bounds__(kFoldGroups * 32) void g1_msm_fold_kernel(
    const uint32_t* __restrict__ partials, uint32_t* __restrict__ out, int64_t bpi) {
  __shared__ uint32_t mem[12 * kFoldStride];
  __shared__ uint32_t tab[CoopFam<kFamG1>::kTableWords];
  coop_stage_table<kFamG1>(tab);
  const int grp = threadIdx.x / 32;
  const Coop g{mem, kFoldStride, grp * kFoldSlots, static_cast<int>(threadIdx.x % 32), 1 + grp,
               32, reinterpret_cast<const uint16_t*>(tab)};
  const int64_t item = blockIdx.x;
  const int A = g.s + CoopFam<kFamG1>::kSlots, B = A + kPt, W = B + kPt;
  const uint32_t* part = partials + item * bpi * 36;
  coop_init<kFamG1>(g);
  if (grp < bpi) {
    cc_load(g, A, part + grp * 36, kPt);
  } else {
    cc_clear(g, A, kPt);
  }
  for (int64_t j = grp + kFoldGroups; j < bpi; j += kFoldGroups) {
    cc_load(g, B, part + j * 36, kPt);
    cc_add<kFamG1, kLanes>(g, 1, A, B, W, A);
  }
  __syncthreads();
  for (int half = kFoldGroups / 2; half >= 1; half >>= 1) {
    if (grp < half) cc_add<kFamG1, kLanes>(g, 1, A, A + half * kFoldSlots, W, A);
    __syncthreads();
  }
  if (grp == 0) {
    coop_run<kLanes, kFamG1>(g, kOp_g1_canon, A, 0, 0, A);
    cc_store(g, out + item * 36, A, kPt);
  }
}

// K: u32[items, lanes, 8]; X, Y, Z: u32[items, lanes, 12] Montgomery; out:
// u32[items, 3, 12] Montgomery, written here when an item's 2 lanes half-lanes
// fit one block (bpi = 1), else by g1_msm_fold_launch from ``partials``,
// u32[items, bpi, 3, 12] (null when bpi = 1)
extern "C" int g1_msm_many_launch(const void* K, const void* X, const void* Y, const void* Z,
                                  void* out, void* partials, int64_t items, int64_t lanes,
                                  cudaStream_t stream) {
  if (items < 1 || lanes < 1) return static_cast<int>(cudaErrorInvalidValue);
  const int64_t bpi = (2 * lanes + kGroups - 1) / kGroups;
  if (items * bpi > 0x7FFFFFFFLL || (bpi > 1 && partials == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  g1_msm_lanes_kernel<<<static_cast<unsigned>(items * bpi), kGroups * 32, 0, stream>>>(
      static_cast<const uint32_t*>(K), static_cast<const uint32_t*>(X),
      static_cast<const uint32_t*>(Y), static_cast<const uint32_t*>(Z),
      static_cast<uint32_t*>(out), static_cast<uint32_t*>(partials), lanes, bpi);
  return static_cast<int>(cudaGetLastError());
}

// partials: u32[items, bpi, 3, 12] -> out: u32[items, 3, 12] Montgomery, canonical
extern "C" int g1_msm_fold_launch(const void* partials, void* out, int64_t items, int64_t bpi,
                                  cudaStream_t stream) {
  if (items < 1 || items > 0x7FFFFFFFLL || bpi < 2) return static_cast<int>(cudaErrorInvalidValue);
  g1_msm_fold_kernel<<<static_cast<unsigned>(items), kFoldGroups * 32, 0, stream>>>(
      static_cast<const uint32_t*>(partials), static_cast<uint32_t*>(out), bpi);
  return static_cast<int>(cudaGetLastError());
}
