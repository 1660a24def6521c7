// K15: every item's G2 committee sum in one launch (the aggregate signature
// of each ragged committee).
//
// Replaces eth_consensus_specs_tpu/ops/g2_aggregate.py g2_sum_many_kernel
// (:103): the log-depth butterfly fold _lane_fold (:69), which at each step s
// adds every lane to its lane XOR 2^s partner, over the complete
// g2_jacobian.g2_add (:95). Lane 0 of that butterfly is the adjacent-pair
// tree: ((L0 + L1) + (L2 + L3)) + ..., the lower half always first. This
// kernel computes that tree and nothing else, so its Jacobian words equal
// the plain version's (ops/g2_aggregate.py _lane_fold), not only its points.
//
// One block per item. Thread t of T sums its own M = L / T contiguous lanes,
// t M .. t M + M - 1, with a stack of partial sums (the binary counter walks
// the adjacent-pair tree over them), then the block finishes the tree over
// the T partial sums in shared memory (stride 1, 2, 4, ...). The add (in
// g2_jac.cuh) is complete: infinity passthroughs, P + P doubles, P - P gives
// Z = 0.
//
// Bound on the H100: a point add is about 43 Fq products (add-2007-bl's 11
// products and 5 squarings, in Fq2: 3 and 2 Fq products each), some 450
// 32-bit instructions each; L - 1 adds an item spread over the card, or the
// chain of log2(L) adds in a row, one thread's; at a committee's shape
// ([1, 512], [64, 512]) the chain binds.
//
// Inputs: X, Y, Z [I, L, 2, 12] u32 words in bls_fp.cuh's Montgomery form
// (x * 2^384 mod p, as the JAX kernel takes Montgomery rows), Z = 0 for
// infinity and padding lanes, L a power of two; output the Jacobian sums
// [I, 3, 2, 12] in the same form.
#include "g2_jac.cuh"

constexpr int kThreads = 128;  // 128 G2 partials (288 bytes each) in shared memory
constexpr int kMaxStack = 24;

__device__ __forceinline__ void g2_load(g2j& p, const uint32_t* X, const uint32_t* Y,
                                        const uint32_t* Z, int64_t lane) {
  fp2_read(p.X, X + lane * 24);
  fp2_read(p.Y, Y + lane * 24);
  fp2_read(p.Z, Z + lane * 24);
}

__global__ __launch_bounds__(kThreads) void g2_sum_many_kernel(
    const uint32_t* __restrict__ X, const uint32_t* __restrict__ Y, const uint32_t* __restrict__ Z,
    uint32_t* __restrict__ out, int64_t lanes, int threads, int log_m) {
  __shared__ g2j part[kThreads];
  const int64_t item = blockIdx.x;
  const int j = threadIdx.x;
  const uint32_t* x = X + item * lanes * 24;
  const uint32_t* y = Y + item * lanes * 24;
  const uint32_t* z = Z + item * lanes * 24;
  if (j < threads) {
    const int64_t m_count = int64_t(1) << log_m;
    g2j stack[kMaxStack];
    int height[kMaxStack];
    int sp = 0;
    for (int64_t k = 0; k < m_count; ++k) {
      g2j p;
      g2_load(p, x, y, z, j * m_count + k);
      int h = 0;
      while (sp > 0 && height[sp - 1] == h) {
        g2_add(p, stack[sp - 1], p);
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
  for (int s = 1; s < threads; s <<= 1) {
    if ((j & (2 * s - 1)) == 0 && j + s < threads) g2_add(part[j], part[j], part[j + s]);
    __syncthreads();
  }
  if (j == 0) {
    uint32_t* o = out + item * 72;
    fp2_write(o, part[0].X);
    fp2_write(o + 24, part[0].Y);
    fp2_write(o + 48, part[0].Z);
  }
}

// X, Y, Z: u32[items, lanes, 2, 12] Montgomery; out: u32[items, 3, 2, 12] Montgomery.
extern "C" int g2_sum_many_launch(const void* X, const void* Y, const void* Z, void* out,
                                  int64_t items, int64_t lanes, cudaStream_t stream) {
  if (items < 1 || items > 0x7FFFFFFFLL || lanes < 1 || (lanes & (lanes - 1)) != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int threads = static_cast<int>(lanes < kThreads ? lanes : kThreads);
  int log_m = 0;
  while ((int64_t(threads) << log_m) < lanes) ++log_m;
  if (log_m + 1 > kMaxStack) return static_cast<int>(cudaErrorInvalidValue);
  g2_sum_many_kernel<<<(unsigned)items, kThreads, 0, stream>>>(
      static_cast<const uint32_t*>(X), static_cast<const uint32_t*>(Y),
      static_cast<const uint32_t*>(Z), static_cast<uint32_t*>(out), lanes, threads, log_m);
  return static_cast<int>(cudaGetLastError());
}
