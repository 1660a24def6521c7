// K12: the final-exponentiation membership check of a pairing product.
//
// Replaces eth_consensus_specs_tpu/ops/pairing_device.py final_exp_is_one
// (:259) and the small jits it chains (_easy_j :231, _powx_j :215,
// _mul_conj_j :225, _frob1_j / _frob2_j, _cube_j :249, _is_one_j :255):
// the easy part m = f^((p^6-1)(p^2+1)), then m^(3H) with
// 3H = (x-1)^2 (x+p)(x^2+p^2-1) + 3, which is 1 exactly when m^H is
// (gcd(3, r) = 1). The Fq inverse inside the easy part is a Fermat power.
//
// One thread runs the whole chain: five powers by x (63 squarings and 5
// products each), a dozen products and Frobenius maps, one inverse. Bound
// on the H100: the chain's dependent Fq12 operations, about 14,000 Fq
// products in a row; it uses one SM of 132. A later design splits each Fq12
// operation across a warp.
//
// Input: canonical u32 words f [2, 3, 2, 12]; output: i32 1 or 0.
#include "bls_fp.cuh"

__device__ __noinline__ void mul_conj(fp12& r, const fp12& a, const fp12& b) {
  fp12 c;
  fp12_conj(c, b);
  fp12_mul(r, a, c);
}

__global__ void final_exp_is_one_kernel(const uint32_t* __restrict__ f_words,
                                        int32_t* __restrict__ out) {
  if (threadIdx.x != 0 || blockIdx.x != 0) return;
  fp12 f, t, m, a, b, c, d, g;
  fp12_load(f, f_words);
  // easy part
  fp12_inv(t, f);
  fp12_conj(f, f);
  fp12_mul(t, f, t);  // f^(p^6 - 1)
  fp12_frobenius2(m, t);
  fp12_mul(m, m, t);  // ^(p^2 + 1)
  // hard part, times 3
  fp12_powx(a, m);
  mul_conj(a, a, m);  // m^(x-1)
  fp12_powx(b, a);
  mul_conj(b, b, a);  // m^((x-1)^2)
  fp12_powx(c, b);
  fp12_frobenius(t, b);
  fp12_mul(c, c, t);  // b^(x+p)
  fp12_powx(d, c);
  fp12_powx(d, d);  // c^(x^2)
  fp12_frobenius2(t, c);
  fp12_mul(g, d, t);
  mul_conj(g, g, c);
  fp12_sqr(t, m);
  fp12_mul(t, t, m);  // m^3
  fp12_mul(g, g, t);
  *out = fp12_is_one(g) ? 1 : 0;
}

// f: u32[2, 3, 2, 12] canonical; out: i32[1].
extern "C" int final_exp_is_one_launch(const void* f, void* out, cudaStream_t stream) {
  final_exp_is_one_kernel<<<1, 32, 0, stream>>>(static_cast<const uint32_t*>(f),
                                                 static_cast<int32_t*>(out));
  return static_cast<int>(cudaGetLastError());
}
