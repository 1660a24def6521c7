// The cooperative Fq12 tower's check entry (fp12_coop.cuh); no path runs it.
// Per element, one group of threads runs chains of ``reps`` Fq12 products by
// b, complex squarings, Granger-Scott squarings and sparse line products,
// with 1 or 4 lanes an Fq product, so the product's two splits can be held
// against the plain tower and timed; K11 takes one lane, K12 four.
#include "fp12_coop.cuh"

constexpr int kCheckGroups = 2;
// S, then a, b, the line (py, a3, a5 and padding: 12 slots), the work value
constexpr int kCheckGroupSlots = kCoopSlots + 4 * 12;

template <int L>
__global__ __launch_bounds__(64 * L * kCheckGroups) void fq12_coop_check_kernel(
    const uint32_t* __restrict__ a, const uint32_t* __restrict__ b,
    const uint32_t* __restrict__ line, uint32_t* __restrict__ out, int64_t n, int reps) {
  static_assert(coop_group_fits<kFamFq12>(64 * L, L), "a round wider than the group");
  constexpr int kStride = kCheckGroupSlots * kCheckGroups;
  __shared__ uint32_t mem[12 * kStride];
  __shared__ uint32_t tab[kCoopTableWords];
  coop_stage_table(tab);
  const int grp = threadIdx.x / (64 * L);
  const Coop g{mem, kStride, grp * kCheckGroupSlots, static_cast<int>(threadIdx.x % (64 * L)),
               1 + grp, 64 * L, reinterpret_cast<const uint16_t*>(tab)};
  const int64_t e = static_cast<int64_t>(blockIdx.x) * kCheckGroups + grp;
  if (e >= n) return;  // a whole group leaves; the others sync on their own barriers
  const int A = g.s + kCoopSlots, B = A + 12, Ln = B + 12, W = Ln + 12;
  coop_load_words(g, A, a + e * 144);
  coop_load_words(g, B, b + e * 144);
  for (int i = g.tid; i < 144; i += g.nthreads)
    mem[(i % 12) * kStride + Ln + i / 12] = i < 60 ? line[e * 60 + i] : 0u;
  coop_init(g);
  coop_run<L>(g, kOp_load, A, 0, 0, A);
  coop_run<L>(g, kOp_load, B, 0, 0, B);
  coop_run<L>(g, kOp_load, Ln, 0, 0, Ln);
  for (int op = 0; op < 4; ++op) {
    for (int r = 0; r < reps; ++r) {
      const int x = r ? W : A;
      if (op == 0) coop_run<L>(g, kOp_mul, x, B, 0, W);
      if (op == 1) coop_run<L>(g, kOp_sqr, x, 0, 0, W);
      if (op == 2) coop_run<L>(g, kOp_cyc, x, 0, 0, W);
      if (op == 3) coop_run<L>(g, kOp_line, x, Ln + 1, Ln, W);
    }
    coop_run<L>(g, kOp_store, W, 0, 0, W);
    coop_store_words(g, W, out + (e * 4 + op) * 144);
    coop_sync(g);
  }
}

// a, b: u32[n, 2, 3, 2, 12], line u32[n, 5, 12] (py, a3, a5) canonical ->
// out u32[n, 4, 2, 3, 2, 12] canonical: a b^reps, a^(2^reps) by complex and
// by Granger-Scott squarings, a l^reps; lanes 1 or 4 a product.
extern "C" int fq12_coop_check_launch(const void* a, const void* b, const void* line, void* out,
                                      int64_t n, int lanes, int reps, cudaStream_t stream) {
  if (n < 1 || n > (int64_t(1) << 30) || reps < 1) return static_cast<int>(cudaErrorInvalidValue);
  const unsigned blocks = static_cast<unsigned>((n + kCheckGroups - 1) / kCheckGroups);
  auto A = static_cast<const uint32_t*>(a);
  auto B = static_cast<const uint32_t*>(b);
  auto Ln = static_cast<const uint32_t*>(line);
  auto O = static_cast<uint32_t*>(out);
  if (lanes == 1) {
    fq12_coop_check_kernel<1><<<blocks, 64 * kCheckGroups, 0, stream>>>(A, B, Ln, O, n, reps);
  } else if (lanes == 4) {
    fq12_coop_check_kernel<4><<<blocks, 256 * kCheckGroups, 0, stream>>>(A, B, Ln, O, n, reps);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
