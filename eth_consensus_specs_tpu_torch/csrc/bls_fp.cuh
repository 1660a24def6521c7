// BLS12-381 base field and its quadratic extension on the card, shared by
// the BLS kernels: the one-thread Fq and Fq2 functions below serve K10's
// lanes passes, K13 and K15's lanes passes (g1_jac.cuh, g2_jac.cuh); the
// cooperative round engine (fp12_coop.cuh), on which K10's and K15's folds,
// K11, K12, K14, K17 and K20 run, takes this header's Fq product and
// constants.
//
// Fq: 12 x 32-bit limbs, little-endian, in Montgomery form with R = 2^384,
// every value kept canonical in [0, p). Multiplication is CIOS Montgomery in
// PTX carry chains (mad.lo.cc / madc.hi.cc on 32-bit lanes, where a 64-bit
// limb would be emulated); squaring takes each cross product once. Fq2 =
// Fq[u]/(u^2+1), the host oracle's (crypto/fields.py).
//
// Boundary: values cross as little-endian u32 words, 12 per Fq element, in
// one of two forms, which each kernel names in its header. K10 (g1_sum.cu)
// reads and writes this header's Montgomery form (x * 2^384 mod p) as it is.
// K11, K12 and K20 read and write canonical values; the cooperative tower's
// load and store programs enter Montgomery form (a product by R^2) and leave
// it (a product by 1), as fp_load and fp_store do here. The torch side uses
// another layout (15 x 26-bit limbs, R = 2^390); the two meet only in these
// words (ops/field_limbs.py: from_words / from_card_words).
//
// The constants below are p, -p^-1 mod 2^32, R^2 mod p, R mod p (one) and
// p - 2 (the Fermat exponent), in Montgomery form where they are field
// values; a test (tests/test_torch_bls_field.py) recomputes each from the
// field's definition.
//
// Multiplication is inlined into the Fq2 functions; those are __noinline__,
// so that the kernels stay small to build. fp_mul_call and fp_sqr_call are
// the product as a call, for code that would inline many (K10's one-thread
// G1 adds, K13's map).
#pragma once
#include "carry.cuh"

struct fp {
  uint32_t v[12];
};
struct fp2 {
  fp c0, c1;
};

__constant__ uint32_t FP_P[12] = {0xffffaaabu, 0xb9feffffu, 0xb153ffffu, 0x1eabfffeu, 0xf6b0f624u, 0x6730d2a0u,
     0xf38512bfu, 0x64774b84u, 0x434bacd7u, 0x4b1ba7b6u, 0x397fe69au, 0x1a0111eau};
constexpr uint32_t FP_NP = 0xfffcfffdu;
__constant__ uint32_t FP_R2[12] = {0x1c341746u, 0xf4df1f34u, 0x09d104f1u, 0x0a76e6a6u, 0x4c95b6d5u, 0x8de5476cu,
     0x939d83c0u, 0x67eb88a9u, 0xb519952du, 0x9a793e85u, 0x92cae3aau, 0x11988fe5u};
__constant__ uint32_t FP_ONE[12] = {0x0002fffdu, 0x76090000u, 0xc40c0002u, 0xebf4000bu, 0x53c758bau, 0x5f489857u,
     0x70525745u, 0x77ce5853u, 0xa256ec6du, 0x5c071a97u, 0xfa80e493u, 0x15f65ec3u};
__constant__ uint32_t FP_PM2[12] = {0xffffaaa9u, 0xb9feffffu, 0xb153ffffu, 0x1eabfffeu, 0xf6b0f624u, 0x6730d2a0u,
     0xf38512bfu, 0x64774b84u, 0x434bacd7u, 0x4b1ba7b6u, 0x397fe69au, 0x1a0111eau};
// ------------------------------------------------------------------- Fq --

__device__ __forceinline__ void fp_set(fp& r, const uint32_t* c) {
#pragma unroll
  for (int i = 0; i < 12; ++i) r.v[i] = c[i];
}

__device__ __forceinline__ void fp_zero(fp& r) {
#pragma unroll
  for (int i = 0; i < 12; ++i) r.v[i] = 0;
}

__device__ __forceinline__ bool fp_is_zero(const fp& a) {
  uint32_t acc = 0;
#pragma unroll
  for (int i = 0; i < 12; ++i) acc |= a.v[i];
  return acc == 0;
}

__device__ __forceinline__ bool fp_eq(const fp& a, const fp& b) {
  uint32_t acc = 0;
#pragma unroll
  for (int i = 0; i < 12; ++i) acc |= a.v[i] ^ b.v[i];
  return acc == 0;
}

// r = t - p if t (with carry word hi) >= p, else t; t < 2p.
__device__ __forceinline__ void fp_reduce(fp& r, const uint32_t* t, uint32_t hi) {
  uint32_t d[12];
  int64_t borrow = 0;
#pragma unroll
  for (int i = 0; i < 12; ++i) {
    int64_t s = (int64_t)t[i] - FP_P[i] + borrow;
    d[i] = (uint32_t)s;
    borrow = s >> 32;  // 0 or -1
  }
  const bool ge = hi != 0 || borrow == 0;
#pragma unroll
  for (int i = 0; i < 12; ++i) r.v[i] = ge ? d[i] : t[i];
}

__device__ __forceinline__ void fp_add(fp& r, const fp& a, const fp& b) {
  uint32_t t[12];
  uint64_t c = 0;
#pragma unroll
  for (int i = 0; i < 12; ++i) {
    uint64_t s = (uint64_t)a.v[i] + b.v[i] + c;
    t[i] = (uint32_t)s;
    c = s >> 32;
  }
  fp_reduce(r, t, (uint32_t)c);
}

__device__ __forceinline__ void fp_sub(fp& r, const fp& a, const fp& b) {
  uint32_t t[12];
  int64_t borrow = 0;
#pragma unroll
  for (int i = 0; i < 12; ++i) {
    int64_t s = (int64_t)a.v[i] - b.v[i] + borrow;
    t[i] = (uint32_t)s;
    borrow = s >> 32;
  }
  const uint32_t mask = borrow ? 0xFFFFFFFFu : 0u;  // add p back on a borrow
  uint64_t c = 0;
#pragma unroll
  for (int i = 0; i < 12; ++i) {
    uint64_t s = (uint64_t)t[i] + (FP_P[i] & mask) + c;
    r.v[i] = (uint32_t)s;
    c = s >> 32;
  }
}

__device__ __forceinline__ void fp_neg(fp& r, const fp& a) {
  fp z;
  fp_zero(z);
  fp_sub(r, z, a);
}

// t[0..12] += m * p (two chains: the low halves at j, the high halves at
// j + 1), then t >>= 32. t[0] + lo(m p0) is 0 mod 2^32 by the choice of m;
// the sum fits 13 words (the callers' bounds), so t[12] takes the last
// carry and nothing leaves it.
__device__ __forceinline__ void fp_redc_row(uint32_t* t, uint32_t m) {
  ptx_mad_lo_cc(m, FP_P[0], t[0]);
#pragma unroll
  for (int j = 1; j < 12; ++j) t[j] = ptx_madc_lo_cc(m, FP_P[j], t[j]);
  t[12] = ptx_addc(t[12], 0u);
  t[1] = ptx_mad_hi_cc(m, FP_P[0], t[1]);
#pragma unroll
  for (int j = 1; j < 11; ++j) t[j + 1] = ptx_madc_hi_cc(m, FP_P[j], t[j + 1]);
  t[12] = ptx_madc_hi(m, FP_P[11], t[12]);
#pragma unroll
  for (int j = 0; j < 12; ++j) t[j] = t[j + 1];
  t[12] = 0;
}

// r = t - p if t >= p, else t (t < 2p in 12 words)
__device__ __forceinline__ void fp_final_sub(fp& r, const uint32_t* t) {
  uint32_t d[12];
  d[0] = ptx_sub_cc(t[0], FP_P[0]);
#pragma unroll
  for (int j = 1; j < 12; ++j) d[j] = ptx_subc_cc(t[j], FP_P[j]);
  const uint32_t borrow = ptx_subc(0u, 0u);  // all ones where t < p
#pragma unroll
  for (int j = 0; j < 12; ++j) r.v[j] = borrow ? t[j] : d[j];
}

// CIOS Montgomery product a * b / 2^384 mod p for a, b under 3p, canonical.
// Row i adds a * b_i (a low-half chain and a high-half chain) and m p, then
// drops the low word. Bounds (p < 2^381): before a row t < a + p < 2^383, so
// 12 words and t[12] = 0; within it t + a b_i + m p < 2^415, 13 words; at
// the end t < 9p^2/R + p < 2p, so one conditional subtraction. About 610
// instructions, all on carry chains (tools/fq_mul_sass.py counts the SASS).
__device__ __forceinline__ void fp_mul(fp& r, const fp& a, const fp& b) {
  uint32_t t[13];
  const uint32_t b0 = b.v[0];
#pragma unroll
  for (int j = 0; j < 12; ++j) t[j] = a.v[j] * b0;
  t[1] = ptx_mad_hi_cc(a.v[0], b0, t[1]);
#pragma unroll
  for (int j = 1; j < 11; ++j) t[j + 1] = ptx_madc_hi_cc(a.v[j], b0, t[j + 1]);
  t[12] = ptx_madc_hi(a.v[11], b0, 0u);
  fp_redc_row(t, t[0] * FP_NP);
#pragma unroll
  for (int i = 1; i < 12; ++i) {
    const uint32_t bi = b.v[i];
    t[0] = ptx_mad_lo_cc(a.v[0], bi, t[0]);
#pragma unroll
    for (int j = 1; j < 12; ++j) t[j] = ptx_madc_lo_cc(a.v[j], bi, t[j]);
    t[12] = ptx_addc(0u, 0u);
    t[1] = ptx_mad_hi_cc(a.v[0], bi, t[1]);
#pragma unroll
    for (int j = 1; j < 11; ++j) t[j + 1] = ptx_madc_hi_cc(a.v[j], bi, t[j + 1]);
    t[12] = ptx_madc_hi(a.v[11], bi, t[12]);
    fp_redc_row(t, t[0] * FP_NP);
  }
  fp_final_sub(r, t);
}

// r = a^2 / 2^384 mod p for a under 3p: the same words as fp_mul(r, a, a).
// The 24-word square takes each off-diagonal product a_i a_j (i < j) once,
// doubles the sum and adds the diagonal a_i^2; the low 12 words are then
// reduced by 12 rows of fp_redc_row (t < 2^384 + m p 2^0 < 2^414 within a
// row, under p + 1 after the last) and the high 12 words added: (a^2 + M p)
// / R with the one M < R that makes it exact, as fp_mul's, so after the
// conditional subtraction the two agree word for word.
__device__ __forceinline__ void fp_sqr(fp& r, const fp& a) {
  uint32_t s[24];
  // row 0: a_0 a_j at j (low halves, fresh words) and j + 1 (high halves)
#pragma unroll
  for (int j = 1; j < 12; ++j) s[j] = a.v[0] * a.v[j];
  s[2] = ptx_mad_hi_cc(a.v[0], a.v[1], s[2]);
#pragma unroll
  for (int j = 2; j < 11; ++j) s[j + 1] = ptx_madc_hi_cc(a.v[0], a.v[j], s[j + 1]);
  s[12] = ptx_madc_hi(a.v[0], a.v[11], 0u);
  // rows 1..10: a_i a_j (j > i) at i + j and i + j + 1; the rows so far fit
  // words below i + 12, so the low chain's carry opens word i + 12 and the
  // high chain's last sum leaves no carry
#pragma unroll
  for (int i = 1; i < 11; ++i) {
    s[2 * i + 1] = ptx_mad_lo_cc(a.v[i], a.v[i + 1], s[2 * i + 1]);
#pragma unroll
    for (int j = i + 2; j < 12; ++j) s[i + j] = ptx_madc_lo_cc(a.v[i], a.v[j], s[i + j]);
    s[i + 12] = ptx_addc(0u, 0u);
    if (i + 1 == 11) {
      s[i + 12] += __umulhi(a.v[i], a.v[11]);  // one product: no chain
    } else {
      s[2 * i + 2] = ptx_mad_hi_cc(a.v[i], a.v[i + 1], s[2 * i + 2]);
#pragma unroll
      for (int j = i + 2; j < 11; ++j) s[i + j + 1] = ptx_madc_hi_cc(a.v[i], a.v[j], s[i + j + 1]);
      s[i + 12] = ptx_madc_hi(a.v[i], a.v[11], s[i + 12]);
    }
  }
  // double words 1..22 (word 0 is 0), the carry into word 23
  s[1] = ptx_add_cc(s[1], s[1]);
#pragma unroll
  for (int k = 2; k < 23; ++k) s[k] = ptx_addc_cc(s[k], s[k]);
  s[23] = ptx_addc(0u, 0u);
  // the diagonal a_i^2 at 2i and 2i + 1, one chain
  s[0] = ptx_mad_lo_cc(a.v[0], a.v[0], 0u);
  s[1] = ptx_madc_hi_cc(a.v[0], a.v[0], s[1]);
#pragma unroll
  for (int i = 1; i < 11; ++i) {
    s[2 * i] = ptx_madc_lo_cc(a.v[i], a.v[i], s[2 * i]);
    s[2 * i + 1] = ptx_madc_hi_cc(a.v[i], a.v[i], s[2 * i + 1]);
  }
  s[22] = ptx_madc_lo_cc(a.v[11], a.v[11], s[22]);
  s[23] = ptx_madc_hi(a.v[11], a.v[11], s[23]);
  // reduce the low half, add the high half
  uint32_t t[13];
#pragma unroll
  for (int j = 0; j < 12; ++j) t[j] = s[j];
  t[12] = 0;
#pragma unroll
  for (int i = 0; i < 12; ++i) fp_redc_row(t, t[0] * FP_NP);
  t[0] = ptx_add_cc(t[0], s[12]);
#pragma unroll
  for (int j = 1; j < 11; ++j) t[j] = ptx_addc_cc(t[j], s[12 + j]);
  t[11] = ptx_addc(t[11], s[23]);
  fp_final_sub(r, t);
}

// The same product and squaring as calls, one copy of their code in the
// kernel. A function that would inline many products runs them through
// these, so that its code stays in the SM's instruction cache: a one-thread
// G1 add inlines 16 (some 300 KB of SASS), a window of K13's powers 5. On the
// card K10's one-thread adds took 0.31 -> 0.23 ms at [128, 512] and K13 2.06
// -> 1.67 ms with them (PERF.md); the tower and the round engine inline the
// product, which there was as fast or faster.
__device__ __noinline__ void fp_mul_call(fp& r, const fp& a, const fp& b) { fp_mul(r, a, b); }
__device__ __noinline__ void fp_sqr_call(fp& r, const fp& a) { fp_sqr(r, a); }

// canonical words -> Montgomery form, and back
__device__ __forceinline__ void fp_load(fp& r, const uint32_t* w) {
  fp a, r2;
#pragma unroll
  for (int i = 0; i < 12; ++i) a.v[i] = w[i];
  fp_set(r2, FP_R2);
  fp_mul(r, a, r2);
}

__device__ __forceinline__ void fp_store(uint32_t* w, const fp& a) {
  fp one, c;
  fp_zero(one);
  one.v[0] = 1;
  fp_mul(c, a, one);
#pragma unroll
  for (int i = 0; i < 12; ++i) w[i] = c.v[i];
}

// Fermat inverse a^(p-2) by square-and-multiply; 0 maps to 0.
__device__ __noinline__ void fp_inv(fp& r, const fp& a) {
  fp acc;
  fp_set(acc, FP_ONE);
  for (int bit = 380; bit >= 0; --bit) {
    fp_sqr(acc, acc);
    if ((FP_PM2[bit >> 5] >> (bit & 31)) & 1u) fp_mul(acc, acc, a);
  }
  r = acc;
}

// ------------------------------------------------------------------ Fq2 --

__device__ __forceinline__ void fp2_add(fp2& r, const fp2& a, const fp2& b) {
  fp_add(r.c0, a.c0, b.c0);
  fp_add(r.c1, a.c1, b.c1);
}

__device__ __forceinline__ void fp2_sub(fp2& r, const fp2& a, const fp2& b) {
  fp_sub(r.c0, a.c0, b.c0);
  fp_sub(r.c1, a.c1, b.c1);
}

__device__ __forceinline__ void fp2_neg(fp2& r, const fp2& a) {
  fp_neg(r.c0, a.c0);
  fp_neg(r.c1, a.c1);
}

__device__ __forceinline__ void fp2_conj(fp2& r, const fp2& a) {
  r.c0 = a.c0;
  fp_neg(r.c1, a.c1);
}

__device__ __forceinline__ bool fp2_is_zero(const fp2& a) {
  return fp_is_zero(a.c0) && fp_is_zero(a.c1);
}

// Karatsuba: (a0 b0 - a1 b1) + ((a0 + a1)(b0 + b1) - a0 b0 - a1 b1) u
__device__ __noinline__ void fp2_mul(fp2& r, const fp2& a, const fp2& b) {
  fp t0, t1, sa, sb, full;
  fp_mul(t0, a.c0, b.c0);
  fp_mul(t1, a.c1, b.c1);
  fp_add(sa, a.c0, a.c1);
  fp_add(sb, b.c0, b.c1);
  fp_mul(full, sa, sb);
  fp_sub(r.c0, t0, t1);
  fp_sub(full, full, t0);
  fp_sub(r.c1, full, t1);
}

// (a0 + a1)(a0 - a1) + 2 a0 a1 u
__device__ __noinline__ void fp2_sqr(fp2& r, const fp2& a) {
  fp s, d, t, b;
  fp_add(s, a.c0, a.c1);
  fp_sub(d, a.c0, a.c1);
  fp_mul(t, s, d);
  fp_mul(b, a.c0, a.c1);
  r.c0 = t;
  fp_add(r.c1, b, b);
}

// times xi = 1 + u: (c0 - c1, c0 + c1)
__device__ __forceinline__ void fp2_mul_xi(fp2& r, const fp2& a) {
  fp t0, t1;
  fp_sub(t0, a.c0, a.c1);
  fp_add(t1, a.c0, a.c1);
  r.c0 = t0;
  r.c1 = t1;
}

__device__ __noinline__ void fp2_inv(fp2& r, const fp2& a) {
  fp s0, s1, n, ninv;
  fp_sqr(s0, a.c0);
  fp_sqr(s1, a.c1);
  fp_add(n, s0, s1);
  fp_inv(ninv, n);
  fp_mul(r.c0, a.c0, ninv);
  fp_mul(s1, a.c1, ninv);
  fp_neg(r.c1, s1);
}
