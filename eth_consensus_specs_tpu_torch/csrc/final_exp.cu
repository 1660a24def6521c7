// K12: the final-exponentiation membership check of a pairing product.
//
// Replaces eth_consensus_specs_tpu/ops/pairing_device.py final_exp_is_one
// (:259) and the small jits it chains (_easy_j :231, _powx_j :215,
// _mul_conj_j :225, _frob1_j / _frob2_j, _cube_j :249, _is_one_j :255):
// the easy part m = f^((p^6-1)(p^2+1)), then m^(3H) with
// 3H = (x-1)^2 (x+p)(x^2+p^2-1) + 3, which is 1 exactly when m^H is
// (gcd(3, r) = 1). K20, the exact value m^H, is final_exp_gt.cu.
//
// K12 runs on one block, one group of the cooperative tower
// (fp12_coop.cuh): every Fq12 operation is a few rounds of independent Fq
// products and sums over 64 x 4 threads (four lanes an Fq product), the
// values in shared memory. Every squaring after the easy part is a
// Granger-Scott squaring (18 products, against a complex squaring's 36);
// the easy part's Fq inverse is a 4-bit-window Fermat chain on four lanes. Bound on the
// H100: the chain of product rounds, about 760 of them and the inverse's
// 470 products, each a dependent Fq product.
//
// Input: canonical u32 words f [2, 3, 2, 12]; output: an i32 1 or 0.
#include "fp12_coop.cuh"

constexpr int kFeLanes = 4;  // lanes an Fq product
constexpr int kFeThreads = 64 * kFeLanes;
static_assert(coop_group_fits<kFamFq12>(kFeThreads, kFeLanes), "a round wider than the group");
// S, then the chain's values f, t, m, a, b, c, d, e, g
constexpr int kFeSlots = kCoopSlots + 9 * 12;

__global__ __launch_bounds__(kFeThreads) void final_exp_is_one_kernel(
    const uint32_t* __restrict__ f_words, int32_t* __restrict__ out) {
  constexpr int L = kFeLanes;
  __shared__ uint32_t mem[12 * kFeSlots];
  __shared__ uint32_t tab[kCoopTableWords];
  coop_stage_table(tab);
  const Coop g{mem, kFeSlots, 0, static_cast<int>(threadIdx.x), 1, kFeThreads,
               reinterpret_cast<const uint16_t*>(tab)};
  const int F = kCoopSlots, T = F + 12, M = T + 12, A = M + 12, B = A + 12, C = B + 12,
            D = C + 12, E = D + 12, G = E + 12;
  coop_load_words(g, F, f_words);
  coop_init(g);
  coop_run<L>(g, kOp_load, F, 0, 0, F);
  // easy part: m = f^((p^6 - 1)(p^2 + 1))
  coop_run<L>(g, kOp_inv, F, 0, 0, T);
  coop_run<L>(g, kOp_mulc, T, F, 0, T);  // f^-1 conj(f) = f^(p^6 - 1)
  coop_run<L>(g, kOp_frob2, T, 0, 0, M);
  coop_run<L>(g, kOp_mul, M, T, 0, M);
  // hard part, times 3
  coop_powx<L>(g, A, M);
  coop_run<L>(g, kOp_mulc, A, M, 0, A);  // a = m^(x-1)
  coop_powx<L>(g, B, A);
  coop_run<L>(g, kOp_mulc, B, A, 0, B);  // b = m^((x-1)^2)
  coop_powx<L>(g, C, B);
  coop_run<L>(g, kOp_frob, B, 0, 0, T);
  coop_run<L>(g, kOp_mul, C, T, 0, C);  // c = b^(x+p)
  coop_powx<L>(g, D, C);
  coop_powx<L>(g, E, D);  // c^(x^2)
  coop_run<L>(g, kOp_frob2, C, 0, 0, T);
  coop_run<L>(g, kOp_mul, E, T, 0, G);
  coop_run<L>(g, kOp_mulc, G, C, 0, G);  // b^((x+p)(x^2+p^2-1))
  coop_run<L>(g, kOp_cyc, M, 0, 0, T);
  coop_run<L>(g, kOp_mul, T, M, 0, T);  // m^3
  coop_run<L>(g, kOp_mul, G, T, 0, G);
  coop_run<L>(g, kOp_canon, G, 0, 0, G);  // sums are lazy: compare the canonical value
  bool differs = false;
  if (threadIdx.x < 12) {
    for (int k = 0; k < 12; ++k)
      differs |= mem[k * kFeSlots + G + threadIdx.x] != (threadIdx.x == 0 ? FP_ONE[k] : 0u);
  }
  differs = __syncthreads_or(differs);
  if (threadIdx.x == 0) *out = differs ? 0 : 1;
}

// f: u32[2, 3, 2, 12] canonical; out: i32[1].
extern "C" int final_exp_is_one_launch(const void* f, void* out, cudaStream_t stream) {
  final_exp_is_one_kernel<<<1, kFeThreads, 0, stream>>>(static_cast<const uint32_t*>(f),
                                                 static_cast<int32_t*>(out));
  return static_cast<int>(cudaGetLastError());
}
