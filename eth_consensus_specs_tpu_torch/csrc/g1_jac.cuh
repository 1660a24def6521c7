// G1 in Jacobian coordinates on the card, shared by K10 (g1_sum.cu) and
// K17 (g1_msm.cu).
//
// The device form of eth_consensus_specs_tpu/ops/g1_msm.py _dbl (:55,
// dbl-2009-l) and the complete _add (:80, add-2007-bl with every case chosen
// by mask in JAX, by branch here), over bls_fp.cuh's Montgomery Fq
// (x * 2^384 mod p). Z = 0 is infinity. The add is branch-complete: a Z = 0
// operand passes the other one through, P + P doubles, P + (-P) gives Z = 0
// (with the generic formula's X and Y, as the JAX select keeps them). The
// plain torch twins (ops/g1_msm.py _dbl, _add) compute the same words.
#pragma once
#include "bls_fp.cuh"

struct g1j {
  fp X, Y, Z;
};

// dbl-2009-l (a = 0); Y = 0 or Z = 0 give Z3 = 0
__device__ __noinline__ void g1_dbl(g1j& r, const g1j& p) {
  fp A, B, C, D, E, F, t, X3, Y3, Z3;
  fp_sqr(A, p.X);
  fp_sqr(B, p.Y);
  fp_sqr(C, B);
  fp_add(t, p.X, B);
  fp_sqr(t, t);
  fp_sub(t, t, A);
  fp_sub(t, t, C);
  fp_add(D, t, t);
  fp_add(E, A, A);
  fp_add(E, E, A);
  fp_sqr(F, E);
  fp_add(t, D, D);
  fp_sub(X3, F, t);
  fp_add(C, C, C);
  fp_add(C, C, C);
  fp_add(C, C, C);
  fp_sub(t, D, X3);
  fp_mul(t, E, t);
  fp_sub(Y3, t, C);
  fp_mul(t, p.Y, p.Z);
  fp_add(Z3, t, t);
  r.X = X3;
  r.Y = Y3;
  r.Z = Z3;
}

__device__ __noinline__ void g1_add(g1j& r, const g1j& p, const g1j& q) {
  if (fp_is_zero(p.Z)) {
    r = q;
    return;
  }
  if (fp_is_zero(q.Z)) {
    r = p;
    return;
  }
  fp Z1Z1, Z2Z2, U1, U2, S1, S2, H, rr, I, J, V, t, X3, Y3, Z3;
  fp_sqr(Z1Z1, p.Z);
  fp_sqr(Z2Z2, q.Z);
  fp_mul(U1, p.X, Z2Z2);
  fp_mul(U2, q.X, Z1Z1);
  fp_mul(S1, p.Y, q.Z);
  fp_mul(S1, S1, Z2Z2);
  fp_mul(S2, q.Y, p.Z);
  fp_mul(S2, S2, Z1Z1);
  fp_sub(H, U2, U1);
  fp_sub(rr, S2, S1);
  const bool same_x = fp_is_zero(H), same_y = fp_is_zero(rr);
  if (same_x && same_y) {
    g1_dbl(r, p);
    return;
  }
  fp_add(rr, rr, rr);
  fp_add(t, H, H);
  fp_sqr(I, t);
  fp_mul(J, H, I);
  fp_mul(V, U1, I);
  fp_sqr(X3, rr);
  fp_sub(X3, X3, J);
  fp_add(t, V, V);
  fp_sub(X3, X3, t);
  fp_sub(t, V, X3);
  fp_mul(Y3, rr, t);
  fp_mul(t, S1, J);
  fp_add(t, t, t);
  fp_sub(Y3, Y3, t);
  if (same_x) {
    fp_zero(Z3);  // P + (-P)
  } else {
    fp_add(t, p.Z, q.Z);
    fp_sqr(t, t);
    fp_sub(t, t, Z1Z1);
    fp_sub(t, t, Z2Z2);
    fp_mul(Z3, t, H);
  }
  r.X = X3;
  r.Y = Y3;
  r.Z = Z3;
}

__device__ __forceinline__ void g1_load(g1j& p, const uint32_t* X, const uint32_t* Y,
                                        const uint32_t* Z, int64_t lane) {
  fp_set(p.X, X + lane * 12);
  fp_set(p.Y, Y + lane * 12);
  fp_set(p.Z, Z + lane * 12);
}
