// Curve points on the cooperative round engine (fp12_coop.cuh): K17
// (g1_msm.cu) and K10's fold (g1_sum.cu) run G1's formulas on it, K14
// (h2c.cu) and K15's warp passes (g2_sum.cu) G2's. A point is 3
// slots (G1: X, Y, Z) or 6 (G2: each coordinate c0 then c1), Jacobian, Z = 0
// infinity. A group is one warp, its barrier __syncwarp. The families'
// rounds hold at most 32 instructions (a G1 add 6 products, a G2 add 18), so
// the warp runs every op a product a thread; an op whose widest product
// round is at most 8 products (a doubling of either family, a single G1
// add) it may run on four lanes a product instead, which shortens a round
// (the 4-lane split of fp12_coop.cuh: the lanes' halves sum the two
// operands side by side). coop_op_fits states the room an op needs, and the
// kernels assert it for the lanes they run each op on.
//
// The programs (ops/fq12_coop.py) are the plain versions' formulas
// (ops/g1_msm.py _dbl and _add, ops/g2_jacobian.py): a doubling is three
// product rounds (dbl4 chains four on forms, one add round at the end); a
// complete add is two programs, add_a (three product rounds into the work
// slots) and add_b (one product round, one add round into O). Between them
// the group reads the cases, every thread the same shared words: a product
// of the first operand's Z^2, of the second's, of (2H)^2 and of (2(S2 -
// S1))^2 that is zero says infinite operand, infinite operand, equal x,
// equal y. An infinite operand passes the other through (G1 tests the first
// operand first, G2 the second, as the plain versions select), P + P takes
// dbl1 of the first operand, P + (-P) is add_b's own Z3 = Z H = 0. So the
// words equal the plain version's in every case (ops/fq12_coop.py
// simulate_add runs the same steps on host ints).
#pragma once
#include "fp12_coop.cuh"

template <int F>
struct CurveFam;

template <>
struct CurveFam<kFamG1> {
  static constexpr int kElem = kG1Elem, kPoint = 3 * kG1Elem, kWork = kG1AddWork;
  static constexpr int kInf1 = kG1Flag_inf1, kInf2 = kG1Flag_inf2;
  static constexpr int kSameX = kG1Flag_same_x, kSameY = kG1Flag_same_y;
  static constexpr bool kFirstOperandFirst = true;
  static constexpr int kDbl1 = kOp_g1_dbl1, kDbl4 = kOp_g1_dbl4;
  __device__ static int add_a(int n) {
    return n == 1 ? kOp_g1_add_a1 : n == 3 ? kOp_g1_add_a3 : kOp_g1_add_a4;
  }
  __device__ static int add_b(int n) {
    return n == 1 ? kOp_g1_add_b1 : n == 3 ? kOp_g1_add_b3 : kOp_g1_add_b4;
  }
};

template <>
struct CurveFam<kFamG2> {
  static constexpr int kElem = kG2Elem, kPoint = 3 * kG2Elem, kWork = kG2AddWork;
  static constexpr int kInf1 = kG2Flag_inf1, kInf2 = kG2Flag_inf2;
  static constexpr int kSameX = kG2Flag_same_x, kSameY = kG2Flag_same_y;
  static constexpr bool kFirstOperandFirst = false;
  static constexpr int kDbl1 = kOp_g2_dbl1, kDbl4 = kOp_g2_dbl4;
  __device__ static int add_a(int) { return kOp_g2_add_a1; }
  __device__ static int add_b(int) { return kOp_g2_add_b1; }
};

static_assert(coop_group_fits<kFamG1>(32, 1) && coop_group_fits<kFamG2>(32, 1),
              "a curve round wider than a warp");

// an op whose widest product round holds ``products`` products and widest
// add round ``sums`` sums runs whole on ``threads`` threads, ``lanes`` a product
__host__ __device__ constexpr bool coop_op_fits(int products, int sums, int threads, int lanes) {
  return products * lanes <= threads && sums <= threads;
}

// true on every thread of the group when the element at ``slot`` is all
// zero words (a product's canonical zero)
template <int F>
__device__ __forceinline__ bool cc_zero(const Coop g, int slot) {
  constexpr int kWords = 12 * CurveFam<F>::kElem;
  bool z = true;
  if (g.tid < kWords) z = g.mem[(g.tid % 12) * g.stride + slot + g.tid / 12] == 0u;
  return __all_sync(0xffffffffu, z);
}

// ``slots`` slots from ``src`` to ``dst`` (apart), then the barrier
__device__ __forceinline__ void cc_copy(const Coop g, int dst, int src, int slots) {
  for (int i = g.tid; i < 12 * slots; i += g.nthreads)
    g.mem[(i % 12) * g.stride + dst + i / 12] = g.mem[(i % 12) * g.stride + src + i / 12];
  coop_sync(g);
}

// ``slots`` slots set to zero words, then the barrier
__device__ __forceinline__ void cc_clear(const Coop g, int dst, int slots) {
  for (int i = g.tid; i < 12 * slots; i += g.nthreads)
    g.mem[(i % 12) * g.stride + dst + i / 12] = 0u;
  coop_sync(g);
}

// ``slots`` slots from row-major words w[slot][12], then the barrier
__device__ __forceinline__ void cc_load(const Coop g, int dst, const uint32_t* w, int slots) {
  for (int i = g.tid; i < 12 * slots; i += g.nthreads)
    g.mem[(i % 12) * g.stride + dst + i / 12] = w[i];
  coop_sync(g);
}

__device__ __forceinline__ void cc_store(const Coop g, uint32_t* w, int src, int slots) {
  for (int i = g.tid; i < 12 * slots; i += g.nthreads)
    w[i] = g.mem[(i % 12) * g.stride + src + i / 12];
}

// n complete adds X + Y_j -> O_j, j < n (n = 1, or the G1 table's 3 and 4):
// X one point all share, Y_j and O_j consecutive points, add j's work at
// w + j kWork. O may be X only for n = 1 (in place); O never overlaps Y. L
// lanes a product (the caller asserts the ops fit).
template <int F, int L = 1>
__device__ __noinline__ void cc_add(const Coop g, int n, int x, int y, int w, int o) {
  using C = CurveFam<F>;
  coop_run<L, F>(g, C::add_a(n), x, y, w, o);
  int cases = 0;  // 2 bits an add: 0 generic, 1 the sum is Y_j, 2 it is X, 3 2X
  for (int j = 0; j < n; ++j) {
    const int base = w + j * C::kWork;
    const bool inf1 = cc_zero<F>(g, base + C::kInf1), inf2 = cc_zero<F>(g, base + C::kInf2);
    int c = C::kFirstOperandFirst ? (inf1 ? 1 : inf2 ? 2 : 0) : (inf2 ? 2 : inf1 ? 1 : 0);
    if (c == 0 && cc_zero<F>(g, base + C::kSameX) && cc_zero<F>(g, base + C::kSameY)) c = 3;
    cases |= c << (2 * j);
  }
  if (!(o == x && cases)) coop_run<L, F>(g, C::add_b(n), x, y, w, o);
  for (int j = 0; j < n && cases; ++j) {
    const int c = (cases >> (2 * j)) & 3, oj = o + j * C::kPoint;
    if (c == 1) cc_copy(g, oj, y + j * C::kPoint, C::kPoint);
    if (c == 2 && oj != x) cc_copy(g, oj, x, C::kPoint);
    if (c == 3) coop_run<L, F>(g, C::kDbl1, x, 0, 0, oj);
  }
}

// the point at ``p`` doubled ``k`` times in place, L lanes a product
template <int F, int L>
__device__ __forceinline__ void cc_dbl(const Coop g, int p, int k) {
  for (; k >= 4; k -= 4) coop_run<L, F>(g, CurveFam<F>::kDbl4, p, 0, 0, p);
  for (; k > 0; --k) coop_run<L, F>(g, CurveFam<F>::kDbl1, p, 0, 0, p);
}
