// The BLS12-381 scalar field Fr on the card, for K16 (fr_fft.cu).
//
// Counterpart of eth_consensus_specs_tpu/ops/limb_field.py (LimbField :24 at
// the 255-bit r, 9 x 30-bit limbs, R = 2^270). Here Fr is 8 x 32-bit words,
// little-endian, and every value is kept canonical in [0, r). r < 2^255, so
// a sum of two values never carries out of 256 bits. The product is CIOS
// Montgomery with R = 2^256: fr_mul(a, b) = a * b / 2^256 mod r. K16 keeps
// its values canonical and multiplies them only by constants stored in
// Montgomery form (w * 2^256 mod r): fr_mul of a canonical value and such a
// constant is the canonical product a * w, so no value ever enters or leaves
// Montgomery form. The torch side (ops/limb_field.py, 10 x 26-bit limbs,
// R = 2^260) meets this one only in u32 words.
#pragma once
#include "common.cuh"

struct fr {
  uint32_t v[8];
};

__constant__ uint32_t FR_R[8] = {0x00000001u, 0xffffffffu, 0xfffe5bfeu, 0x53bda402u,
                                 0x09a1d805u, 0x3339d808u, 0x299d7d48u, 0x73eda753u};
constexpr uint32_t FR_NP = 0xffffffffu;  // -r^-1 mod 2^32

// r = t - r if t (with carry word hi) >= r, else t; t < 2r.
__device__ __forceinline__ void fr_reduce(fr& r, const uint32_t* t, uint32_t hi) {
  uint32_t d[8];
  int64_t borrow = 0;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    int64_t s = (int64_t)t[i] - FR_R[i] + borrow;
    d[i] = (uint32_t)s;
    borrow = s >> 32;  // 0 or -1
  }
  const bool ge = hi != 0 || borrow == 0;
#pragma unroll
  for (int i = 0; i < 8; ++i) r.v[i] = ge ? d[i] : t[i];
}

__device__ __forceinline__ void fr_add(fr& r, const fr& a, const fr& b) {
  uint32_t t[8];
  uint64_t c = 0;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    uint64_t s = (uint64_t)a.v[i] + b.v[i] + c;
    t[i] = (uint32_t)s;
    c = s >> 32;
  }
  fr_reduce(r, t, (uint32_t)c);
}

__device__ __forceinline__ void fr_sub(fr& r, const fr& a, const fr& b) {
  uint32_t t[8];
  int64_t borrow = 0;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    int64_t s = (int64_t)a.v[i] - b.v[i] + borrow;
    t[i] = (uint32_t)s;
    borrow = s >> 32;
  }
  const uint32_t mask = borrow ? 0xFFFFFFFFu : 0u;  // add r back on a borrow
  uint64_t c = 0;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    uint64_t s = (uint64_t)t[i] + (FR_R[i] & mask) + c;
    r.v[i] = (uint32_t)s;
    c = s >> 32;
  }
}

// CIOS Montgomery product a * b / 2^256 mod r of canonical operands. Each
// 32 x 32-bit product plus two 32-bit words fits 64 bits; the running sum
// stays under 2r.
__device__ __forceinline__ void fr_mul(fr& r, const fr& a, const fr& b) {
  uint32_t t[10];
#pragma unroll
  for (int i = 0; i < 10; ++i) t[i] = 0;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    uint64_t c = 0;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      uint64_t s = (uint64_t)a.v[j] * b.v[i] + t[j] + c;
      t[j] = (uint32_t)s;
      c = s >> 32;
    }
    uint64_t s = (uint64_t)t[8] + c;
    t[8] = (uint32_t)s;
    t[9] = (uint32_t)(s >> 32);
    const uint32_t m = t[0] * FR_NP;
    s = (uint64_t)m * FR_R[0] + t[0];
    c = s >> 32;
#pragma unroll
    for (int j = 1; j < 8; ++j) {
      s = (uint64_t)m * FR_R[j] + t[j] + c;
      t[j - 1] = (uint32_t)s;
      c = s >> 32;
    }
    s = (uint64_t)t[8] + c;
    t[7] = (uint32_t)s;
    t[8] = t[9] + (uint32_t)(s >> 32);
  }
  fr_reduce(r, t, t[8]);
}
