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
#include "g1_jac.cuh"

constexpr int kThreads = 256;
constexpr int kMaxStack = 24;

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
