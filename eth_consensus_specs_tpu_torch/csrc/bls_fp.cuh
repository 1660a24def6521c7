// BLS12-381 base field and its tower on the card, shared by K10 (g1_sum.cu),
// K11 (miller.cu) and K12 (final_exp.cu).
//
// Fq: 12 x 32-bit limbs, little-endian, in Montgomery form with R = 2^384,
// every value kept canonical in [0, p). Multiplication is CIOS Montgomery:
// Hopper issues the 32 x 32 -> 64-bit products as IMAD.WIDE on 32-bit
// lanes, where a 64-bit limb would be emulated. The tower is the host
// oracle's (crypto/fields.py): Fq2 = Fq[u]/(u^2+1), Fq6 = Fq2[v]/(v^3 - xi),
// Fq12 = Fq6[w]/(w^2 - v), xi = 1 + u; an Fq12 is laid out [half][v][u], as
// the port's torch tensors are.
//
// Boundary: values cross as little-endian u32 words, 12 per Fq element, in
// one of two forms, which each kernel names in its header. K10 (g1_sum.cu)
// reads and writes this header's Montgomery form (x * 2^384 mod p) as it is.
// K11 and K12 read and write canonical values: fp_load enters Montgomery form
// (a product by R^2), fp_store leaves it (a product by 1). The torch side
// uses another layout (15 x 26-bit limbs, R = 2^390); the two meet only in
// these words (ops/field_limbs.py: from_words / from_card_words).
//
// The constants below are p, -p^-1 mod 2^32, R^2 mod p, R mod p (one), p - 2
// (the Fermat exponent), and the Frobenius constants gamma1_i = xi^(i(p-1)/6)
// (Fq2) and gamma2_i = xi^(i(p^2-1)/6) (in Fq), in Montgomery form; a test
// (tests/test_torch_bls_field.py) recomputes each from the field's
// definition.
//
// Multiplication is inlined into the tower functions; the tower functions
// themselves are __noinline__, so that the kernels stay small to build.
#pragma once
#include "common.cuh"

struct fp {
  uint32_t v[12];
};
struct fp2 {
  fp c0, c1;
};
struct fp6 {
  fp2 c0, c1, c2;
};
struct fp12 {
  fp6 c0, c1;
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
__constant__ uint32_t FROB1[6][2][12] = {
    {{0x0002fffdu, 0x76090000u, 0xc40c0002u, 0xebf4000bu, 0x53c758bau, 0x5f489857u,
      0x70525745u, 0x77ce5853u, 0xa256ec6du, 0x5c071a97u, 0xfa80e493u, 0x15f65ec3u},
     {0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u,
      0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u}},
    {{0xb319d465u, 0x07089552u, 0xb50a8313u, 0xc6695f92u, 0xd117228fu, 0x97e83cccu,
      0xb2dc29eeu, 0xa35baecau, 0x5daace4du, 0x1ce393eau, 0xb0fb66ebu, 0x08f2220fu},
     {0x4ce5d646u, 0xb2f66aadu, 0xfc497cecu, 0x5842a06bu, 0x2599d394u, 0xcf4895d4u,
      0x40a8e8d0u, 0xc11b9cbau, 0xe5a0de89u, 0x2e3813cbu, 0x88847fafu, 0x110eefdau}},
    {{0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u,
      0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u},
     {0x8671f071u, 0xcd03c9e4u, 0x1fcda5d2u, 0x5dab2246u, 0xd3851b95u, 0x587042afu,
      0x01bacb9eu, 0x8eb60ebeu, 0x83d050d2u, 0x03f97d6eu, 0x54638741u, 0x18f02065u}},
    {{0x5aa30fdau, 0x7bcfa7a2u, 0x2a927e7cu, 0xdc17dec1u, 0x6b4ebef1u, 0x2f088dd8u,
      0xda74d4a7u, 0xd1ca2087u, 0x96cebc1du, 0x2da25966u, 0xbbfd87d2u, 0x0e2b7eedu},
     {0x5aa30fdau, 0x7bcfa7a2u, 0x2a927e7cu, 0xdc17dec1u, 0x6b4ebef1u, 0x2f088dd8u,
      0xda74d4a7u, 0xd1ca2087u, 0x96cebc1du, 0x2da25966u, 0xbbfd87d2u, 0x0e2b7eedu}},
    {{0x867545c3u, 0x890dc9e4u, 0x3285a5d5u, 0x2af32253u, 0x309b7e2cu, 0x50880866u,
      0x7e881024u, 0xa20d1b8cu, 0xe2db9068u, 0x14e4f04fu, 0x1564853au, 0x14e56d3fu},
     {0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u,
      0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u}},
    {{0x0dbce43fu, 0x82d83cf5u, 0xdf9d018fu, 0xa2813e53u, 0x3c65e181u, 0xc6f0caa5u,
      0x8d50fe95u, 0x7525cf52u, 0xf4798a6bu, 0x4a85ed50u, 0x6cf8eebdu, 0x171da0fdu},
     {0xf242c66cu, 0x3726c30au, 0xd1b6fe70u, 0x7c2ac1aau, 0xba4b14a2u, 0xa04007fbu,
      0x66341429u, 0xef517c32u, 0x4ed2226bu, 0x0095ba65u, 0xcc86f7ddu, 0x02e370ecu}}};
__constant__ uint32_t FROB2[6][12] = {
    {0x0002fffdu, 0x76090000u, 0xc40c0002u, 0xebf4000bu, 0x53c758bau, 0x5f489857u,
     0x70525745u, 0x77ce5853u, 0xa256ec6du, 0x5c071a97u, 0xfa80e493u, 0x15f65ec3u},
    {0x798dba3au, 0xecfb361bu, 0x91865a2cu, 0xc100ddb8u, 0x232bda8eu, 0x0ec08ff1u,
     0xf1ca4721u, 0xd5c13cc6u, 0xbf7b5c04u, 0x47222a47u, 0xe51c5f59u, 0x0110f184u},
    {0x798a64e8u, 0x30f1361bu, 0x7ece5a2au, 0xf3b8ddabu, 0xc61577f7u, 0x16a8ca3au,
     0x74fd029bu, 0xc26a2ff8u, 0x60701c6eu, 0x3636b766u, 0x241b6160u, 0x051ba4abu},
    {0xfffcaaaeu, 0x43f5ffffu, 0xed47fffdu, 0x32b7fff2u, 0xa2e99d69u, 0x07e83a49u,
     0x8332bb7au, 0xeca8f331u, 0xa0f4c069u, 0xef148d1eu, 0x3eff0206u, 0x040ab326u},
    {0x8671f071u, 0xcd03c9e4u, 0x1fcda5d2u, 0x5dab2246u, 0xd3851b95u, 0x587042afu,
     0x01bacb9eu, 0x8eb60ebeu, 0x83d050d2u, 0x03f97d6eu, 0x54638741u, 0x18f02065u},
    {0x867545c3u, 0x890dc9e4u, 0x3285a5d5u, 0x2af32253u, 0x309b7e2cu, 0x50880866u,
     0x7e881024u, 0xa20d1b8cu, 0xe2db9068u, 0x14e4f04fu, 0x1564853au, 0x14e56d3fu}};

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

// CIOS Montgomery product a * b / 2^384 mod p. Each 32 x 32-bit product plus
// two 32-bit words fits 64 bits; the running sum stays under 2p.
__device__ __forceinline__ void fp_mul(fp& r, const fp& a, const fp& b) {
  uint32_t t[14];
#pragma unroll
  for (int i = 0; i < 14; ++i) t[i] = 0;
#pragma unroll
  for (int i = 0; i < 12; ++i) {
    uint64_t c = 0;
#pragma unroll
    for (int j = 0; j < 12; ++j) {
      uint64_t s = (uint64_t)a.v[j] * b.v[i] + t[j] + c;
      t[j] = (uint32_t)s;
      c = s >> 32;
    }
    uint64_t s = (uint64_t)t[12] + c;
    t[12] = (uint32_t)s;
    t[13] = (uint32_t)(s >> 32);
    const uint32_t m = t[0] * FP_NP;
    s = (uint64_t)m * FP_P[0] + t[0];
    c = s >> 32;
#pragma unroll
    for (int j = 1; j < 12; ++j) {
      s = (uint64_t)m * FP_P[j] + t[j] + c;
      t[j - 1] = (uint32_t)s;
      c = s >> 32;
    }
    s = (uint64_t)t[12] + c;
    t[11] = (uint32_t)s;
    t[12] = t[13] + (uint32_t)(s >> 32);
  }
  fp_reduce(r, t, t[12]);
}

__device__ __forceinline__ void fp_sqr(fp& r, const fp& a) { fp_mul(r, a, a); }

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

__device__ __forceinline__ void fp2_mul_fp(fp2& r, const fp2& a, const fp& s) {
  fp_mul(r.c0, a.c0, s);
  fp_mul(r.c1, a.c1, s);
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

// ------------------------------------------------------------------ Fq6 --

__device__ __forceinline__ void fp6_add(fp6& r, const fp6& a, const fp6& b) {
  fp2_add(r.c0, a.c0, b.c0);
  fp2_add(r.c1, a.c1, b.c1);
  fp2_add(r.c2, a.c2, b.c2);
}

__device__ __forceinline__ void fp6_sub(fp6& r, const fp6& a, const fp6& b) {
  fp2_sub(r.c0, a.c0, b.c0);
  fp2_sub(r.c1, a.c1, b.c1);
  fp2_sub(r.c2, a.c2, b.c2);
}

__device__ __forceinline__ void fp6_neg(fp6& r, const fp6& a) {
  fp2_neg(r.c0, a.c0);
  fp2_neg(r.c1, a.c1);
  fp2_neg(r.c2, a.c2);
}

// times v: (c0, c1, c2) -> (c2 xi, c0, c1)
__device__ __forceinline__ void fp6_mul_v(fp6& r, const fp6& a) {
  fp2 t;
  fp2_mul_xi(t, a.c2);
  r.c2 = a.c1;
  r.c1 = a.c0;
  r.c0 = t;
}

__device__ __noinline__ void fp6_mul(fp6& r, const fp6& a, const fp6& b) {
  fp2 t0, t1, t2, x, y, u, c0, c1, c2;
  fp2_mul(t0, a.c0, b.c0);
  fp2_mul(t1, a.c1, b.c1);
  fp2_mul(t2, a.c2, b.c2);
  // c0 = t0 + ((a1 + a2)(b1 + b2) - t1 - t2) xi
  fp2_add(x, a.c1, a.c2);
  fp2_add(y, b.c1, b.c2);
  fp2_mul(u, x, y);
  fp2_sub(u, u, t1);
  fp2_sub(u, u, t2);
  fp2_mul_xi(u, u);
  fp2_add(c0, t0, u);
  // c1 = (a0 + a1)(b0 + b1) - t0 - t1 + t2 xi
  fp2_add(x, a.c0, a.c1);
  fp2_add(y, b.c0, b.c1);
  fp2_mul(u, x, y);
  fp2_sub(u, u, t0);
  fp2_sub(u, u, t1);
  fp2_mul_xi(x, t2);
  fp2_add(c1, u, x);
  // c2 = (a0 + a2)(b0 + b2) - t0 - t2 + t1
  fp2_add(x, a.c0, a.c2);
  fp2_add(y, b.c0, b.c2);
  fp2_mul(u, x, y);
  fp2_sub(u, u, t0);
  fp2_sub(u, u, t2);
  fp2_add(c2, u, t1);
  r.c0 = c0;
  r.c1 = c1;
  r.c2 = c2;
}

__device__ __noinline__ void fp6_inv(fp6& r, const fp6& a) {
  fp2 t0, t1, t2, x, y, d;
  fp2_sqr(t0, a.c0);
  fp2_mul(x, a.c1, a.c2);
  fp2_mul_xi(x, x);
  fp2_sub(t0, t0, x);  // a^2 - b c xi
  fp2_sqr(t1, a.c2);
  fp2_mul_xi(t1, t1);
  fp2_mul(x, a.c0, a.c1);
  fp2_sub(t1, t1, x);  // c^2 xi - a b
  fp2_sqr(t2, a.c1);
  fp2_mul(x, a.c0, a.c2);
  fp2_sub(t2, t2, x);  // b^2 - a c
  fp2_mul(x, a.c2, t1);
  fp2_mul(y, a.c1, t2);
  fp2_add(x, x, y);
  fp2_mul_xi(x, x);
  fp2_mul(d, a.c0, t0);
  fp2_add(d, d, x);
  fp2_inv(d, d);
  fp2_mul(r.c0, t0, d);
  fp2_mul(r.c1, t1, d);
  fp2_mul(r.c2, t2, d);
}

// ----------------------------------------------------------------- Fq12 --

__device__ __forceinline__ fp& fp12_at(fp12& a, int k) {  // k = 6 half + 2 v + u
  return reinterpret_cast<fp*>(&a)[k];
}

__device__ __forceinline__ const fp& fp12_at(const fp12& a, int k) {
  return reinterpret_cast<const fp*>(&a)[k];
}

__device__ __forceinline__ void fp12_set_one(fp12& r) {
  for (int k = 1; k < 12; ++k) fp_zero(fp12_at(r, k));
  fp_set(fp12_at(r, 0), FP_ONE);
}

__device__ __forceinline__ bool fp12_is_one(const fp12& a) {
  fp one;
  fp_set(one, FP_ONE);
  bool ok = fp_eq(fp12_at(a, 0), one);
  for (int k = 1; k < 12; ++k) ok = ok && fp_is_zero(fp12_at(a, k));
  return ok;
}

__device__ __forceinline__ void fp12_conj(fp12& r, const fp12& a) {
  r.c0 = a.c0;
  fp6_neg(r.c1, a.c1);
}

// Karatsuba over the Fq6 halves
__device__ __noinline__ void fp12_mul(fp12& r, const fp12& a, const fp12& b) {
  fp6 t0, t1, sa, sb, full, v;
  fp6_mul(t0, a.c0, b.c0);
  fp6_mul(t1, a.c1, b.c1);
  fp6_add(sa, a.c0, a.c1);
  fp6_add(sb, b.c0, b.c1);
  fp6_mul(full, sa, sb);
  fp6_sub(full, full, t0);
  fp6_sub(r.c1, full, t1);
  fp6_mul_v(v, t1);
  fp6_add(r.c0, t0, v);
}

// complex squaring: c0 = (a0 + a1)(a0 + v a1) - ab - v ab, c1 = 2 ab
__device__ __noinline__ void fp12_sqr(fp12& r, const fp12& a) {
  fp6 ab, s, t, prod, v;
  fp6_mul(ab, a.c0, a.c1);
  fp6_add(s, a.c0, a.c1);
  fp6_mul_v(t, a.c1);
  fp6_add(t, a.c0, t);
  fp6_mul(prod, s, t);
  fp6_sub(prod, prod, ab);
  fp6_mul_v(v, ab);
  fp6_sub(r.c0, prod, v);
  fp6_add(r.c1, ab, ab);
}

__device__ __noinline__ void fp12_inv(fp12& r, const fp12& a) {
  fp6 s0, s1, t;
  fp6_mul(s0, a.c0, a.c0);
  fp6_mul(s1, a.c1, a.c1);
  fp6_mul_v(s1, s1);
  fp6_sub(t, s0, s1);
  fp6_inv(t, t);
  fp6_mul(r.c0, a.c0, t);
  fp6_mul(s0, a.c1, t);
  fp6_neg(r.c1, s0);
}

// f -> f^p: coefficient i of f = sum a_i w^i (at half i % 2, v i / 2) is
// conjugated and multiplied by gamma1_i
__device__ __noinline__ void fp12_frobenius(fp12& r, const fp12& a) {
  fp12 out;
  for (int h = 0; h < 2; ++h) {
    for (int v = 0; v < 3; ++v) {
      const int i = 2 * v + h;
      fp2 c, g;
      c.c0 = fp12_at(a, 6 * h + 2 * v);
      c.c1 = fp12_at(a, 6 * h + 2 * v + 1);
      fp2_conj(c, c);
      fp_set(g.c0, FROB1[i][0]);
      fp_set(g.c1, FROB1[i][1]);
      fp2_mul(c, c, g);
      fp12_at(out, 6 * h + 2 * v) = c.c0;
      fp12_at(out, 6 * h + 2 * v + 1) = c.c1;
    }
  }
  r = out;
}

// f -> f^(p^2): coefficient i times gamma2_i, which lies in Fq
__device__ __noinline__ void fp12_frobenius2(fp12& r, const fp12& a) {
  fp12 out;
  for (int h = 0; h < 2; ++h) {
    for (int v = 0; v < 3; ++v) {
      fp g;
      fp_set(g, FROB2[2 * v + h]);
      fp_mul(fp12_at(out, 6 * h + 2 * v), fp12_at(a, 6 * h + 2 * v), g);
      fp_mul(fp12_at(out, 6 * h + 2 * v + 1), fp12_at(a, 6 * h + 2 * v + 1), g);
    }
  }
  r = out;
}

// a^x for the negative BLS parameter: a^|x| by square-and-multiply over
// |x| = 0xd201000000010000 (63 squarings, 5 products), then conjugated
// (inversion in the cyclotomic subgroup)
__device__ __noinline__ void fp12_powx(fp12& r, const fp12& a) {
  constexpr uint64_t kX = 0xd201000000010000ull;
  fp12 acc = a;
  for (int bit = 62; bit >= 0; --bit) {
    fp12_sqr(acc, acc);
    if ((kX >> bit) & 1ull) fp12_mul(acc, acc, a);
  }
  fp12_conj(r, acc);
}

// s * (0, a3, a5) for an Fq6 s = (s0, s1, s2):
// (xi (s1 a5 + s2 a3), s0 a3 + xi s2 a5, s0 a5 + s1 a3)
__device__ __forceinline__ void fp6_mul_sparse(fp6& r, const fp6& s, const fp2& a3, const fp2& a5) {
  fp2 x, y, c0, c1, c2;
  fp2_mul(x, s.c1, a5);
  fp2_mul(y, s.c2, a3);
  fp2_add(x, x, y);
  fp2_mul_xi(c0, x);
  fp2_mul(x, s.c0, a3);
  fp2_mul(y, s.c2, a5);
  fp2_mul_xi(y, y);
  fp2_add(c1, x, y);
  fp2_mul(x, s.c0, a5);
  fp2_mul(y, s.c1, a3);
  fp2_add(c2, x, y);
  r.c0 = c0;
  r.c1 = c1;
  r.c2 = c2;
}

// f * (py + a3 w^3 + a5 w^5): l = (py, 0, 0) + (0, a3, a5) w, so
// f l = (py f0 + v (f1 L1)) + (f0 L1 + py f1) w
__device__ __noinline__ void fp12_mul_line(fp12& r, const fp12& f, const fp& py, const fp2& a3,
                                           const fp2& a5) {
  fp6 s0, s1, v;
  fp6_mul_sparse(s0, f.c0, a3, a5);
  fp6_mul_sparse(s1, f.c1, a3, a5);
  fp12 scaled;
  for (int k = 0; k < 12; ++k) fp_mul(fp12_at(scaled, k), fp12_at(f, k), py);
  fp6_mul_v(v, s1);
  fp6_add(r.c0, scaled.c0, v);
  fp6_add(r.c1, scaled.c1, s0);
}

__device__ __forceinline__ void fp12_load(fp12& r, const uint32_t* w) {
  for (int k = 0; k < 12; ++k) fp_load(fp12_at(r, k), w + 12 * k);
}

__device__ __forceinline__ void fp12_store(uint32_t* w, const fp12& a) {
  for (int k = 0; k < 12; ++k) fp_store(w + 12 * k, fp12_at(a, k));
}
