// The BLS12-381 scalar field Fr on the card, for K16 (fr_fft.cu).
//
// Counterpart of eth_consensus_specs_tpu/ops/limb_field.py (LimbField :24 at
// the 255-bit r, 9 x 30-bit limbs, R = 2^270). Here Fr is 8 x 32-bit words,
// little-endian, and every value is kept canonical in [0, r). r < 2^255, so
// a sum of two values never carries out of 256 bits. The product is CIOS
// Montgomery with R = 2^256 in PTX carry chains (carry.cuh), as bls_fp.cuh's
// Fq product: fr_mul(a, b) = a * b / 2^256 mod r. K16 keeps its values
// canonical and multiplies them only by constants stored in Montgomery form
// (w * 2^256 mod r): fr_mul of a canonical value and such a constant is the
// canonical product a * w, so no value ever enters or leaves Montgomery
// form. The torch side (ops/limb_field.py, 10 x 26-bit limbs, R = 2^260)
// meets this one only in u32 words.
#pragma once
#include "carry.cuh"

struct fr {
  uint32_t v[8];
};

__constant__ uint32_t FR_R[8] = {0x00000001u, 0xffffffffu, 0xfffe5bfeu, 0x53bda402u,
                                 0x09a1d805u, 0x3339d808u, 0x299d7d48u, 0x73eda753u};
constexpr uint32_t FR_NP = 0xffffffffu;  // -r^-1 mod 2^32

// r = t - r if t >= r, else t (t < 2r in 8 words)
__device__ __forceinline__ void fr_final_sub(fr& r, const uint32_t* t) {
  uint32_t d[8];
  d[0] = ptx_sub_cc(t[0], FR_R[0]);
#pragma unroll
  for (int j = 1; j < 8; ++j) d[j] = ptx_subc_cc(t[j], FR_R[j]);
  const uint32_t borrow = ptx_subc(0u, 0u);  // all ones where t < r
#pragma unroll
  for (int j = 0; j < 8; ++j) r.v[j] = borrow ? t[j] : d[j];
}

__device__ __forceinline__ void fr_add(fr& r, const fr& a, const fr& b) {
  uint32_t t[8];
  t[0] = ptx_add_cc(a.v[0], b.v[0]);
#pragma unroll
  for (int j = 1; j < 8; ++j) t[j] = ptx_addc_cc(a.v[j], b.v[j]);
  fr_final_sub(r, t);  // a + b < 2r < 2^256: no carry out
}

__device__ __forceinline__ void fr_sub(fr& r, const fr& a, const fr& b) {
  uint32_t t[8];
  t[0] = ptx_sub_cc(a.v[0], b.v[0]);
#pragma unroll
  for (int j = 1; j < 8; ++j) t[j] = ptx_subc_cc(a.v[j], b.v[j]);
  const uint32_t mask = ptx_subc(0u, 0u);  // all ones on a borrow: add r back
  r.v[0] = ptx_add_cc(t[0], FR_R[0] & mask);
#pragma unroll
  for (int j = 1; j < 7; ++j) r.v[j] = ptx_addc_cc(t[j], FR_R[j] & mask);
  r.v[7] = ptx_addc(t[7], FR_R[7] & mask);
}

// t[0..8] += m * r (the low halves at j, the high halves at j + 1), then
// t >>= 32. t[0] + lo(m r0) is 0 mod 2^32 by the choice of m; the sum fits 9
// words, so t[8] takes the last carry and nothing leaves it.
__device__ __forceinline__ void fr_redc_row(uint32_t* t, uint32_t m) {
  ptx_mad_lo_cc(m, FR_R[0], t[0]);
#pragma unroll
  for (int j = 1; j < 8; ++j) t[j] = ptx_madc_lo_cc(m, FR_R[j], t[j]);
  t[8] = ptx_addc(t[8], 0u);
  t[1] = ptx_mad_hi_cc(m, FR_R[0], t[1]);
#pragma unroll
  for (int j = 1; j < 7; ++j) t[j + 1] = ptx_madc_hi_cc(m, FR_R[j], t[j + 1]);
  t[8] = ptx_madc_hi(m, FR_R[7], t[8]);
#pragma unroll
  for (int j = 0; j < 8; ++j) t[j] = t[j + 1];
  t[8] = 0;
}

// CIOS Montgomery product a * b / 2^256 mod r of canonical operands. Row i
// adds a * b_i (a low-half chain and a high-half chain) and m r, then drops
// the low word. Bounds (r < 2^255): before a row t < 2r < 2^256, 8 words;
// within it t + a b_i + m r < 2^256 + 2^288, 9 words; after the last row
// t < 2r, so one conditional subtraction.
__device__ __forceinline__ void fr_mul(fr& r, const fr& a, const fr& b) {
  uint32_t t[9];
  const uint32_t b0 = b.v[0];
#pragma unroll
  for (int j = 0; j < 8; ++j) t[j] = a.v[j] * b0;
  t[1] = ptx_mad_hi_cc(a.v[0], b0, t[1]);
#pragma unroll
  for (int j = 1; j < 7; ++j) t[j + 1] = ptx_madc_hi_cc(a.v[j], b0, t[j + 1]);
  t[8] = ptx_madc_hi(a.v[7], b0, 0u);
  fr_redc_row(t, t[0] * FR_NP);
#pragma unroll
  for (int i = 1; i < 8; ++i) {
    const uint32_t bi = b.v[i];
    t[0] = ptx_mad_lo_cc(a.v[0], bi, t[0]);
#pragma unroll
    for (int j = 1; j < 8; ++j) t[j] = ptx_madc_lo_cc(a.v[j], bi, t[j]);
    t[8] = ptx_addc(0u, 0u);
    t[1] = ptx_mad_hi_cc(a.v[0], bi, t[1]);
#pragma unroll
    for (int j = 1; j < 7; ++j) t[j + 1] = ptx_madc_hi_cc(a.v[j], bi, t[j + 1]);
    t[8] = ptx_madc_hi(a.v[7], bi, t[8]);
    fr_redc_row(t, t[0] * FR_NP);
  }
  fr_final_sub(r, t);
}
