// K10: every item's G1 committee sum in one launch.
//
// Replaces eth_consensus_specs_tpu/ops/g1_msm.py sum_many_kernel (:168): the
// vmapped pairwise _tree_sum (:140) over the complete Jacobian _add (:80,
// add-2007-bl, every case chosen by mask) and _dbl (:55, dbl-2009-l), with
// the field from ops/field_limbs.py:75-196.
//
// One block per item. The JAX tree pairs lane j with lane j + n/2 at every
// level; here thread t (of T) first sums its own lanes t, t + T, t + 2T, ...
// in that same order (the halving tree over a thread's M = L / T lanes is
// the adjacent-pair tree over their bit-reversed order, which a stack of
// log2(M) + 1 partial sums walks), and the block finishes the remaining
// levels over T partial sums in shared memory. So the output is the JAX
// program's Jacobian (X, Y, Z), not only the same point. The add is
// branch-complete: a Z = 0 operand passes the other one through, P + P
// doubles, P + (-P) gives Z = 0 (with the generic formula's X and Y, as the
// JAX select keeps them).
//
// Bound on the H100: integer throughput, 16 Fq products of some 450 32-bit
// instructions per point add, L - 1 adds per item; and the dependency floor
// of log2(L) adds in a row, one thread's chain. The chain is what binds at
// [128, 512] (9 adds); throughput binds at [8, 32768].
//
// Inputs: X, Y, Z [I, L, 12] u32 words in Montgomery form (x * 2^384 mod p,
// bls_fp.cuh's own form, as the JAX kernel takes Montgomery rows), Z = 0 for
// infinity and padding lanes, L a power of two; output the Jacobian sums
// [I, 3, 12] in the same form. No conversion on the card.
#include "bls_fp.cuh"

struct g1j {
  fp X, Y, Z;
};

constexpr int kThreads = 256;
constexpr int kMaxStack = 24;

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

__global__ __launch_bounds__(kThreads) void g1_sum_many_kernel(
    const uint32_t* __restrict__ X, const uint32_t* __restrict__ Y, const uint32_t* __restrict__ Z,
    uint32_t* __restrict__ out, int64_t lanes, int threads, int log_m) {
  __shared__ g1j part[kThreads];
  const int64_t item = blockIdx.x;
  const int j = threadIdx.x;
  const uint32_t* x = X + item * lanes * 12;
  const uint32_t* y = Y + item * lanes * 12;
  const uint32_t* z = Z + item * lanes * 12;
  if (j < threads) {
    const int64_t m_count = int64_t(1) << log_m;
    g1j stack[kMaxStack];
    int height[kMaxStack];
    int sp = 0;
    for (int64_t k = 0; k < m_count; ++k) {
      const int64_t m = log_m ? (int64_t)(__brevll((unsigned long long)k) >> (64 - log_m)) : 0;
      g1j p;
      g1_load(p, x, y, z, j + m * threads);
      int h = 0;
      while (sp > 0 && height[sp - 1] == h) {
        g1_add(p, stack[sp - 1], p);
        --sp;
        ++h;
      }
      stack[sp] = p;
      height[sp] = h;
      ++sp;
    }
    part[j] = stack[0];
  }
  __syncthreads();
  for (int n = threads; n > 1; n >>= 1) {
    const int h = n >> 1;
    if (j < h) g1_add(part[j], part[j], part[j + h]);
    __syncthreads();
  }
  if (j == 0) {
    uint32_t* o = out + item * 36;
    const fp* r = &part[0].X;
    for (int c = 0; c < 3; ++c)
      for (int k = 0; k < 12; ++k) o[12 * c + k] = r[c].v[k];
  }
}

// X, Y, Z: u32[items, lanes, 12] Montgomery; out: u32[items, 3, 12] Montgomery.
extern "C" int g1_sum_many_launch(const void* X, const void* Y, const void* Z, void* out,
                                  int64_t items, int64_t lanes, cudaStream_t stream) {
  if (items < 1 || items > 0x7FFFFFFFLL || lanes < 1 || (lanes & (lanes - 1)) != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int threads = static_cast<int>(lanes < kThreads ? lanes : kThreads);
  int log_m = 0;
  while ((int64_t(threads) << log_m) < lanes) ++log_m;
  if (log_m + 1 > kMaxStack) return static_cast<int>(cudaErrorInvalidValue);
  g1_sum_many_kernel<<<(unsigned)items, kThreads, 0, stream>>>(
      static_cast<const uint32_t*>(X), static_cast<const uint32_t*>(Y),
      static_cast<const uint32_t*>(Z), static_cast<uint32_t*>(out), lanes, threads, log_m);
  return static_cast<int>(cudaGetLastError());
}
