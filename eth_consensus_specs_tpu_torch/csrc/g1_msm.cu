// K17: every item's full-scalar G1 multi-scalar multiplication in one launch.
//
// Replaces eth_consensus_specs_tpu/ops/g1_msm.py msm_many_kernel (:183),
// which vmaps _msm_lanes (:175) over items: _scalar_mul_lane (:119), a
// 256-step MSB-first double-and-add per lane (acc = 2 acc, then acc + P
// where the bit is set), then the pairwise _tree_sum (:140) over the lanes.
// msm_kernel (:153) is this kernel with one item. The point arithmetic is
// K10's (g1_jac.cuh: dbl-2009-l and the complete add-2007-bl).
//
// One block per item. Thread t (of T = min(L, 256)) multiplies lane t, then
// lanes t + T, t + 2T, ... and adds each product into its running sum in
// that order; the block then sums the T partials by the halving tree in
// shared memory (partial j takes j + n/2, n the power of two at or above T,
// the pad infinity). The scalars are public, so a thread branches on its
// bit where JAX selects. The lanes are not padded to a power of two as in
// JAX: a KZG flush of n blobs launches at exactly 2n + 1 lanes. The words
// differ from JAX's (another tree over other lanes), the affine point does
// not; the plain twin (ops/g1_msm.py msm_many_ref) runs these same steps and
// gives these same words.
//
// Bound on the H100: a dependency chain. The function needs at least, per
// lane, the chain of a half scalar (G1's endomorphism splits k into two of
// 128 bits): some 127 doublings (7 Fq products each) and, with 4-bit
// windows, 31 adds (16 each), about 1,400 Fq products of ~450 instructions,
// plus a tree over the half-lanes. This design's chain is 256 doublings and
// an add for each set bit, some 3,900 products, 2.8x that, in one thread,
// with only 2 blocks (a flush's two items) on the card.
//
// Inputs: K u32[I, L, 8] scalars (little-endian words, any 256-bit value);
// X, Y, Z u32[I, L, 12] affine or Jacobian points in bls_fp.cuh's Montgomery
// form (x * 2^384 mod p), Z = 0 for infinity and padding lanes. Output: the
// Jacobian sums u32[I, 3, 12] in the same form.
#include "g1_jac.cuh"

constexpr int kThreads = 256;

__device__ __forceinline__ void g1_scalar_mul(g1j& q, const g1j& p, const uint32_t* k) {
  fp_zero(q.X);
  fp_zero(q.Y);
  fp_zero(q.Z);
  for (int w = 7; w >= 0; --w) {
    const uint32_t word = k[w];
    for (int b = 31; b >= 0; --b) {
      g1_dbl(q, q);
      if ((word >> b) & 1u) g1_add(q, q, p);
    }
  }
}

__global__ __launch_bounds__(kThreads) void g1_msm_many_kernel(
    const uint32_t* __restrict__ K, const uint32_t* __restrict__ X, const uint32_t* __restrict__ Y,
    const uint32_t* __restrict__ Z, uint32_t* __restrict__ out, int64_t lanes, int threads,
    int tree) {
  __shared__ g1j part[kThreads];
  const int64_t item = blockIdx.x;
  const int j = threadIdx.x;
  const uint32_t* x = X + item * lanes * 12;
  const uint32_t* y = Y + item * lanes * 12;
  const uint32_t* z = Z + item * lanes * 12;
  const uint32_t* k = K + item * lanes * 8;
  if (j < threads) {
    g1j acc, p, q;
    for (int64_t lane = j; lane < lanes; lane += threads) {
      g1_load(p, x, y, z, lane);
      g1_scalar_mul(q, p, k + lane * 8);
      if (lane == j) {
        acc = q;
      } else {
        g1_add(acc, acc, q);
      }
    }
    part[j] = acc;
  } else if (j < tree) {
    fp_zero(part[j].X);
    fp_zero(part[j].Y);
    fp_zero(part[j].Z);
  }
  __syncthreads();
  for (int n = tree; n > 1; n >>= 1) {
    const int h = n >> 1;
    if (j < h) g1_add(part[j], part[j], part[j + h]);
    __syncthreads();
  }
  if (j == 0) {
    uint32_t* o = out + item * 36;
    const fp* r = &part[0].X;
    for (int c = 0; c < 3; ++c)
      for (int i = 0; i < 12; ++i) o[12 * c + i] = r[c].v[i];
  }
}

// K: u32[items, lanes, 8]; X, Y, Z: u32[items, lanes, 12] Montgomery;
// out: u32[items, 3, 12] Montgomery.
extern "C" int g1_msm_many_launch(const void* K, const void* X, const void* Y, const void* Z,
                                  void* out, int64_t items, int64_t lanes, cudaStream_t stream) {
  if (items < 1 || items > 0x7FFFFFFFLL || lanes < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const int threads = static_cast<int>(lanes < kThreads ? lanes : kThreads);
  int tree = 1;
  while (tree < threads) tree <<= 1;
  g1_msm_many_kernel<<<(unsigned)items, kThreads, 0, stream>>>(
      static_cast<const uint32_t*>(K), static_cast<const uint32_t*>(X),
      static_cast<const uint32_t*>(Y), static_cast<const uint32_t*>(Z),
      static_cast<uint32_t*>(out), lanes, threads, tree);
  return static_cast<int>(cudaGetLastError());
}
