// The binary extended GCD inverse in Fq on one thread, for public values
// (variable time): K13's warp inverse and K14's affine step (h2c.cu), and
// K20's easy-part inverse (final_exp_gt.cu). ops/fq12_coop.py gcd_inverse runs
// the same steps on host ints.
#pragma once
#include "bls_fp.cuh"

// 12-word helpers of the binary GCD (plain integers, not field elements)
__device__ __forceinline__ bool gcd_lt(const uint32_t* a, const uint32_t* b) {
  for (int k = 11; k >= 0; --k)
    if (a[k] != b[k]) return a[k] < b[k];
  return false;
}

__device__ __forceinline__ void gcd_sub(uint32_t* a, const uint32_t* b) {  // a -= b, a >= b
  int64_t c = 0;
#pragma unroll
  for (int k = 0; k < 12; ++k) {
    c += static_cast<int64_t>(a[k]) - b[k];
    a[k] = static_cast<uint32_t>(c);
    c >>= 32;
  }
}

__device__ __forceinline__ void gcd_half(uint32_t* a, bool add_p) {  // (a + add_p p) / 2, a < p
  uint64_t c = 0;
  uint32_t t[12];
#pragma unroll
  for (int k = 0; k < 12; ++k) {
    c += static_cast<uint64_t>(a[k]) + (add_p ? FP_P[k] : 0u);
    t[k] = static_cast<uint32_t>(c);
    c >>= 32;
  }
#pragma unroll
  for (int k = 0; k < 11; ++k) a[k] = (t[k] >> 1) | (t[k + 1] << 31);
  a[11] = t[11] >> 1;  // a + p < 2^382: no carry out of word 11
}

__device__ __forceinline__ void gcd_sub_mod(uint32_t* a, const uint32_t* b) {  // a = a - b mod p
  if (gcd_lt(a, b)) {
    uint64_t c = 0;
#pragma unroll
    for (int k = 0; k < 12; ++k) {
      c += static_cast<uint64_t>(a[k]) + FP_P[k];
      a[k] = static_cast<uint32_t>(c);
      c >>= 32;
    }
  }
  gcd_sub(a, b);
}

__device__ __forceinline__ bool gcd_is_one(const uint32_t* a) {
  uint32_t rest = a[0] ^ 1u;
#pragma unroll
  for (int k = 1; k < 12; ++k) rest |= a[k];
  return rest == 0;
}

// r = a^-1 mod p (plain integers) for any a below 2^384, 0 for a = 0 mod p,
// by the binary extended GCD: u = x1 a and v = x2 a (mod p) throughout.
// Variable time: for public values only. ops/fq12_coop.py gcd_inverse runs
// the same steps.
__device__ __noinline__ void fp_inv_gcd(uint32_t* r, const uint32_t* a) {
  uint32_t u[12], v[12], x1[12], x2[12], p[12];
#pragma unroll
  for (int k = 0; k < 12; ++k) {
    u[k] = a[k];
    v[k] = p[k] = FP_P[k];
    x1[k] = x2[k] = 0;
  }
  x1[0] = 1;
  while (!gcd_lt(u, p)) gcd_sub(u, p);
  uint32_t nz = 0;
#pragma unroll
  for (int k = 0; k < 12; ++k) nz |= u[k];
  if (nz == 0) {
#pragma unroll
    for (int k = 0; k < 12; ++k) r[k] = 0;
    return;
  }
  while (!gcd_is_one(u) && !gcd_is_one(v)) {
    while (!(u[0] & 1u)) {
      gcd_half(u, false);
      gcd_half(x1, x1[0] & 1u);
    }
    while (!(v[0] & 1u)) {
      gcd_half(v, false);
      gcd_half(x2, x2[0] & 1u);
    }
    if (!gcd_lt(u, v)) {
      gcd_sub(u, v);
      gcd_sub_mod(x1, x2);
    } else {
      gcd_sub(v, u);
      gcd_sub_mod(x2, x1);
    }
  }
  const uint32_t* out = gcd_is_one(u) ? x1 : x2;
#pragma unroll
  for (int k = 0; k < 12; ++k) r[k] = out[k];
}
