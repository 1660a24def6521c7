// G2 (E'(Fq2)) Jacobian arithmetic on the card, over bls_fp.cuh's fp2:
// the device functions of K13, K14 (h2c.cu) and K15 (g2_sum.cu).
//
// Device counterparts of eth_consensus_specs_tpu/ops/g2_jacobian.py:
// g2_dbl (:74), the complete g2_add (:95), g2_neg (:152), g2_mul_z (:156),
// g2_psi (:195), g2_clear_cofactor (:210) and g2_to_affine (:225); their
// plain torch twins are eth_consensus_specs_tpu_torch/ops/g2_jacobian.py.
// The JAX add selects every case by lane mask; here a thread branches, but
// to the same values: Q = O gives P (even when P = O too), P = O gives Q,
// P + P takes the doubling, P + (-P) keeps the generic formula's X3 and Y3
// with Z3 = 0. So a kernel built on these returns the plain version's
// Jacobian words, not only its points.
//
// Values are bls_fp.cuh's Montgomery form (R = 2^384), canonical in [0, p).
// The psi constants below are 1 / xi^((p-1)/3) and 1 / xi^((p-1)/2) in that
// form; a CPU test (tests/test_torch_h2c.py) recomputes them.
#pragma once
#include "bls_fp.cuh"

struct g2j {
  fp2 X, Y, Z;
};

__constant__ uint32_t PSI_XY[2][2][12] = {
    {{0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u,
      0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u},
     {0x867545c3u, 0x890dc9e4u, 0x3285a5d5u, 0x2af32253u, 0x309b7e2cu, 0x50880866u,
      0x7e881024u, 0xa20d1b8cu, 0xe2db9068u, 0x14e4f04fu, 0x1564853au, 0x14e56d3fu}},
    {{0xa55c9ad1u, 0x3e2f585du, 0x86c18183u, 0x4294213du, 0x8b623732u, 0x382844c8u,
      0x19103e18u, 0x92ad2afdu, 0xac7cf0b9u, 0x1d794e4fu, 0x7d825ec8u, 0x0bd592fcu},
     {0x5aa30fdau, 0x7bcfa7a2u, 0x2a927e7cu, 0xdc17dec1u, 0x6b4ebef1u, 0x2f088dd8u,
      0xda74d4a7u, 0xd1ca2087u, 0x96cebc1du, 0x2da25966u, 0xbbfd87d2u, 0x0e2b7eedu}}};

constexpr uint64_t kBlsXAbs = 0xd201000000010000ull;  // |x|, x the BLS parameter

__device__ __forceinline__ void fp2_set(fp2& r, const uint32_t (*c)[12]) {
  fp_set(r.c0, c[0]);
  fp_set(r.c1, c[1]);
}

__device__ __forceinline__ void fp2_zero(fp2& r) {
  fp_zero(r.c0);
  fp_zero(r.c1);
}

// dbl-2009-l (a = 0): Y = 0 or Z = 0 give Z3 = 2 Y Z = 0
__device__ __noinline__ void g2_dbl(g2j& r, const g2j& p) {
  fp2 A, B, C, D, E, t, X3, Y3, Z3;
  fp2_sqr(A, p.X);
  fp2_sqr(B, p.Y);
  fp2_sqr(C, B);
  fp2_add(t, p.X, B);
  fp2_sqr(t, t);
  fp2_sub(t, t, A);
  fp2_sub(t, t, C);
  fp2_add(D, t, t);
  fp2_add(E, A, A);
  fp2_add(E, E, A);
  fp2_sqr(t, E);
  fp2_sub(X3, t, D);
  fp2_sub(X3, X3, D);
  fp2_add(C, C, C);
  fp2_add(C, C, C);
  fp2_add(C, C, C);
  fp2_sub(t, D, X3);
  fp2_mul(t, E, t);
  fp2_sub(Y3, t, C);
  fp2_mul(t, p.Y, p.Z);
  fp2_add(Z3, t, t);
  r.X = X3;
  r.Y = Y3;
  r.Z = Z3;
}

// add-2007-bl, complete (see the header note for the cases)
__device__ __noinline__ void g2_add(g2j& r, const g2j& p, const g2j& q) {
  if (fp2_is_zero(q.Z)) {
    r = p;
    return;
  }
  if (fp2_is_zero(p.Z)) {
    r = q;
    return;
  }
  fp2 Z1Z1, Z2Z2, U1, U2, S1, S2, H, rr, I, J, V, t, X3, Y3, Z3;
  fp2_sqr(Z1Z1, p.Z);
  fp2_sqr(Z2Z2, q.Z);
  fp2_mul(U1, p.X, Z2Z2);
  fp2_mul(U2, q.X, Z1Z1);
  fp2_mul(S1, p.Y, q.Z);
  fp2_mul(S1, S1, Z2Z2);
  fp2_mul(S2, q.Y, p.Z);
  fp2_mul(S2, S2, Z1Z1);
  fp2_sub(H, U2, U1);
  fp2_sub(rr, S2, S1);
  const bool same_x = fp2_is_zero(H);
  if (same_x && fp2_is_zero(rr)) {
    g2_dbl(r, p);
    return;
  }
  fp2_add(rr, rr, rr);
  fp2_add(t, H, H);
  fp2_sqr(I, t);
  fp2_mul(J, H, I);
  fp2_mul(V, U1, I);
  fp2_sqr(X3, rr);
  fp2_sub(X3, X3, J);
  fp2_add(t, V, V);
  fp2_sub(X3, X3, t);
  fp2_sub(t, V, X3);
  fp2_mul(Y3, rr, t);
  fp2_mul(t, S1, J);
  fp2_add(t, t, t);
  fp2_sub(Y3, Y3, t);
  if (same_x) {
    fp2_zero(Z3);  // P + (-P)
  } else {
    fp2_add(t, p.Z, q.Z);
    fp2_sqr(t, t);
    fp2_sub(t, t, Z1Z1);
    fp2_sub(t, t, Z2Z2);
    fp2_mul(Z3, t, H);
  }
  r.X = X3;
  r.Y = Y3;
  r.Z = Z3;
}

__device__ __forceinline__ void g2_neg(g2j& r, const g2j& p) {
  r.X = p.X;
  fp2_neg(r.Y, p.Y);
  r.Z = p.Z;
}

// [|x|]P: 63 doublings, an add of P after each set bit below the top one
__device__ __noinline__ void g2_mul_z(g2j& r, const g2j& p) {
  g2j acc = p;
  for (int bit = 62; bit >= 0; --bit) {
    g2_dbl(acc, acc);
    if ((kBlsXAbs >> bit) & 1ull) g2_add(acc, acc, p);
  }
  r = acc;
}

// psi on Jacobian coordinates: conjugate each, scale X and Y
__device__ __noinline__ void g2_psi(g2j& r, const g2j& p) {
  fp2 c;
  fp2_set(c, PSI_XY[0]);
  fp2_conj(r.X, p.X);
  fp2_mul(r.X, r.X, c);
  fp2_set(c, PSI_XY[1]);
  fp2_conj(r.Y, p.Y);
  fp2_mul(r.Y, r.Y, c);
  fp2_conj(r.Z, p.Z);
}

// [h_eff]P, Budroni-Pintore: [z^2]P + [z]P - P - psi([z+1]P) + psi^2(2P)
__device__ __noinline__ void g2_clear_cofactor(g2j& r, const g2j& p) {
  g2j a, b, t, acc, n;
  g2_mul_z(a, p);
  g2_mul_z(b, a);
  g2_add(t, a, p);
  g2_psi(t, t);
  g2_add(acc, b, a);
  g2_neg(n, p);
  g2_add(acc, acc, n);
  g2_neg(n, t);
  g2_add(acc, acc, n);
  g2_dbl(t, p);
  g2_psi(t, t);
  g2_psi(t, t);
  g2_add(r, acc, t);
}

// affine (x, y) by one Fq2 inversion; Z = 0 inverts to 0, so O gives (0, 0)
__device__ __noinline__ bool g2_to_affine(fp2& x, fp2& y, const g2j& p) {
  fp2 zi, zi2, zi3;
  fp2_inv(zi, p.Z);
  fp2_sqr(zi2, zi);
  fp2_mul(zi3, zi2, zi);
  fp2_mul(x, p.X, zi2);
  fp2_mul(y, p.Y, zi3);
  return fp2_is_zero(p.Z);
}

// one Fq2 coordinate of 24 u32 words (c0 then c1), as they lie in memory
__device__ __forceinline__ void fp2_read(fp2& r, const uint32_t* w) {
  fp_set(r.c0, w);
  fp_set(r.c1, w + 12);
}

__device__ __forceinline__ void fp2_write(uint32_t* w, const fp2& a) {
#pragma unroll
  for (int k = 0; k < 12; ++k) {
    w[k] = a.c0.v[k];
    w[12 + k] = a.c1.v[k];
  }
}
