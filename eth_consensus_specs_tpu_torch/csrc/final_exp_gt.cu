// K20: the exact final exponentiation of a pairing's Miller value (the GT
// export).
//
// Replaces eth_consensus_specs_tpu/ops/pairing_device.py final_exponentiation
// (:281: _easy_j :231, then _hard_exp_j :277, a naive power by H = (p^4 -
// p^2 + 1)/r, 1,268 bits with 633 ones). It gives m^H itself, m = f^((p^6 -
// 1)(p^2 + 1)) the easy part, by H = ((x-1)^2/3)(x+p)(x^2+p^2-1) + 1: one
// power by the 126-bit e = (x-1)^2/3 (125 squarings, 47 products), then
// K12's tail from b = m^e (three powers by x, a Frobenius map, a
// p^2-Frobenius map, three products) and a last product by m. The same
// element as the naive power, so the same canonical words.
//
// One block runs the chain on the cooperative tower (fp12_coop.cuh), as K12
// does (final_exp.cu): 64 x 4 threads, four lanes an Fq product, every
// Fq12 operation a few rounds of independent Fq products and lazy sums, the
// values in shared memory, every squaring after the easy part a
// Granger-Scott squaring (coop_pow_cyc). The easy part's Fq12
// inverse is two programs (inv_a, inv_b) around one Fq inverse of a norm,
// a binary extended GCD on one thread (fp_gcd.cuh): the GT export's inputs
// are public, so a variable-time inverse is allowed, and on the card it beat
// the engine's 4-bit-window Fermat chain on four lanes (PERF.md).
// Bound on the H100: a chain of 393 product rounds (chip_smoke.py
// final_exp_gt_rounds) and the cheaper of the two inverses, the GCD's steps
// or the Fermat chain's rounds.
//
// Input: canonical u32 words f [2, 3, 2, 12]; output: the canonical words of
// f^((p^12-1)/r) [2, 3, 2, 12].
#include "fp12_coop.cuh"
#include "fp_gcd.cuh"

// (x-1)^2/3 and |x|, as K20's powers take them
constexpr uint64_t kEHi = 0x396c8c005555e156ull, kELo = 0x8c00aaab0000aaabull, kXAbs = 0xd201000000010000ull;

// dst = src^x for the negative BLS parameter: the power by |x|, then the
// conjugate
template <int L>
__device__ void gt_powx(const Coop g, int dst, int src) {
  coop_pow_cyc<L>(g, dst, src, 0, kXAbs, 63);
  coop_run<L>(g, kOp_conj, dst, 0, 0, dst);
}

constexpr int kFeLanes = 4;  // lanes an Fq product
constexpr int kFeThreads = 64 * kFeLanes;
static_assert(coop_group_fits<kFamFq12>(kFeThreads, kFeLanes), "a round wider than the group");

// S, then the chain's values f, t, m, b, c, d, e, g, then the inverse's Z slots
constexpr int kGtSlots = kCoopSlots + 8 * 12 + kInvWork;

__global__ __launch_bounds__(kFeThreads) void final_exp_gt_kernel(
    const uint32_t* __restrict__ f_words, uint32_t* __restrict__ out) {
  constexpr int L = kFeLanes;
  __shared__ uint32_t mem[12 * kGtSlots];
  __shared__ uint32_t tab[kCoopTableWords];
  coop_stage_table(tab);
  const Coop g{mem, kGtSlots, 0, static_cast<int>(threadIdx.x), 1, kFeThreads,
               reinterpret_cast<const uint16_t*>(tab)};
  const int F = kCoopSlots, T = F + 12, M = T + 12, B = M + 12, C = B + 12, D = C + 12,
            E = D + 12, G = E + 12, W = G + 12;
  coop_load_words(g, F, f_words);
  coop_init(g);
  coop_run<L>(g, kOp_load, F, 0, 0, F);
  // easy part: m = f^((p^6 - 1)(p^2 + 1))
  coop_run<L>(g, kOp_inv_a, F, 0, W, T);
  if (threadIdx.x == 0) {  // the norm's inverse, x R -> x^-1 R, on one thread
    fp x, inv, r3;
    coop_read(x, g, W + kInvNorm);
    fp_inv_gcd(inv.v, x.v);
    coop_read(r3, g, g.s + kC_r3);
    fp_mul(inv, inv, r3);
    coop_write(g, W + kInvInv, inv);
  }
  coop_sync(g);
  coop_run<L>(g, kOp_inv_b, F, 0, W, T);
  coop_run<L>(g, kOp_mulc, T, F, 0, T);  // f^-1 conj(f) = f^(p^6 - 1)
  coop_run<L>(g, kOp_frob2, T, 0, 0, M);
  coop_run<L>(g, kOp_mul, M, T, 0, M);
  coop_pow_cyc<L>(g, B, M, kEHi, kELo, 125);  // b = m^((x-1)^2 / 3)
  // g = b^((x+p)(x^2+p^2-1)): c = b^(x+p), then c^(x^2) c^(p^2) conj(c)
  gt_powx<L>(g, C, B);
  coop_run<L>(g, kOp_frob, B, 0, 0, T);
  coop_run<L>(g, kOp_mul, C, T, 0, C);
  gt_powx<L>(g, D, C);
  gt_powx<L>(g, E, D);
  coop_run<L>(g, kOp_frob2, C, 0, 0, T);
  coop_run<L>(g, kOp_mul, E, T, 0, G);
  coop_run<L>(g, kOp_mulc, G, C, 0, G);
  coop_run<L>(g, kOp_mul, G, M, 0, G);  // m^H
  coop_run<L>(g, kOp_store, G, 0, 0, G);  // canonical words (a product by 1)
  coop_store_words(g, G, out);
}

// f, out: u32[2, 3, 2, 12] canonical; out may not alias f.
extern "C" int final_exp_gt_launch(const void* f, void* out, cudaStream_t stream) {
  final_exp_gt_kernel<<<1, kFeThreads, 0, stream>>>(static_cast<const uint32_t*>(f),
                                                    static_cast<uint32_t*>(out));
  return static_cast<int>(cudaGetLastError());
}
