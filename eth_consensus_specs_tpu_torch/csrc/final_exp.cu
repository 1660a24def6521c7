// K12: the final-exponentiation membership check of a pairing product, and
// K20: the exact final exponentiation (the GT export).
//
// K12 replaces eth_consensus_specs_tpu/ops/pairing_device.py final_exp_is_one
// (:259) and the small jits it chains (_easy_j :231, _powx_j :215,
// _mul_conj_j :225, _frob1_j / _frob2_j, _cube_j :249, _is_one_j :255):
// the easy part m = f^((p^6-1)(p^2+1)), then m^(3H) with
// 3H = (x-1)^2 (x+p)(x^2+p^2-1) + 3, which is 1 exactly when m^H is
// (gcd(3, r) = 1).
//
// K20 replaces final_exponentiation (:281: _easy_j, then _hard_exp_j :277,
// a naive power by H = (p^4 - p^2 + 1)/r, 1,268 bits with 633 ones) and
// gives m^H itself, by H = ((x-1)^2/3)(x+p)(x^2+p^2-1) + 1: one power by
// the 126-bit e = (x-1)^2/3 (125 squarings, 47 products), then K12's tail
// from b = m^e (three powers by x, Frobenius maps, a few products) and a
// last product by m. The same value as the naive power, in about a fifth of
// its products.
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
// K20 still runs in one thread (about 17,000 Fq products in a row through
// bls_fp.cuh's tower); its move onto the cooperative tower is queued.
//
// Input: canonical u32 words f [2, 3, 2, 12]; output: K12 an i32 1 or 0,
// K20 the canonical words of f^((p^12-1)/r) [2, 3, 2, 12].
#include "fp12_coop.cuh"

__device__ __noinline__ void mul_conj(fp12& r, const fp12& a, const fp12& b) {
  fp12 c;
  fp12_conj(c, b);
  fp12_mul(r, a, c);
}

// m = f^((p^6 - 1)(p^2 + 1)), in the cyclotomic subgroup
__device__ __noinline__ void easy_part(fp12& m, const fp12& f) {
  fp12 t, c;
  fp12_inv(t, f);
  fp12_conj(c, f);
  fp12_mul(t, c, t);  // f^(p^6 - 1)
  fp12_frobenius2(m, t);
  fp12_mul(m, m, t);  // ^(p^2 + 1)
}

// g = b^((x+p)(x^2+p^2-1)): c = b^(x+p), then c^(x^2) c^(p^2) c^-1 (the
// inverse of a cyclotomic element is its conjugate)
__device__ __noinline__ void hard_tail(fp12& g, const fp12& b) {
  fp12 c, d, t;
  fp12_powx(c, b);
  fp12_frobenius(t, b);
  fp12_mul(c, c, t);  // b^(x+p)
  fp12_powx(d, c);
  fp12_powx(d, d);  // c^(x^2)
  fp12_frobenius2(t, c);
  fp12_mul(g, d, t);
  mul_conj(g, g, c);
}

// a^e, e = (x-1)^2 / 3 = 0x396c8c005555e156_8c00aaab0000aaab (126 bits)
__device__ __noinline__ void fp12_pow_e(fp12& r, const fp12& a) {
  constexpr uint64_t kHi = 0x396c8c005555e156ull, kLo = 0x8c00aaab0000aaabull;
  fp12 acc = a;
  for (int bit = 124; bit >= 0; --bit) {
    fp12_sqr(acc, acc);
    if (((bit >= 64 ? kHi : kLo) >> (bit & 63)) & 1ull) fp12_mul(acc, acc, a);
  }
  r = acc;
}

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

__global__ void final_exp_kernel(const uint32_t* __restrict__ f_words,
                                 uint32_t* __restrict__ out) {
  if (threadIdx.x != 0 || blockIdx.x != 0) return;
  fp12 f, m, b, g;
  fp12_load(f, f_words);
  easy_part(m, f);
  fp12_pow_e(b, m);  // m^((x-1)^2 / 3)
  hard_tail(g, b);
  fp12_mul(g, g, m);  // m^H
  fp12_store(out, g);
}

// f: u32[2, 3, 2, 12] canonical; out: i32[1].
extern "C" int final_exp_is_one_launch(const void* f, void* out, cudaStream_t stream) {
  final_exp_is_one_kernel<<<1, kFeThreads, 0, stream>>>(static_cast<const uint32_t*>(f),
                                                 static_cast<int32_t*>(out));
  return static_cast<int>(cudaGetLastError());
}

// f, out: u32[2, 3, 2, 12] canonical; out may not alias f.
extern "C" int final_exp_launch(const void* f, void* out, cudaStream_t stream) {
  final_exp_kernel<<<1, 32, 0, stream>>>(static_cast<const uint32_t*>(f),
                                         static_cast<uint32_t*>(out));
  return static_cast<int>(cudaGetLastError());
}
