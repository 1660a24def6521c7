// K11: the batched Miller loop and the product of its values.
//
// Replaces eth_consensus_specs_tpu/ops/pairing_device.py miller_from_coeffs
// (:170, a lax.scan of the 68 steps vmapped over pairs) and its chunk fold
// _miller_chunk_fold (:301), with the tower of ops/fq12_tower.py and
// ops/lazy_limbs.py. The JAX chunking into 8 pairs is an XLA compile
// artifact and is not kept: any fold order gives the same canonical product.
//
// Two kernels, each with its own entry point (and launch count):
// * miller_loop_kernel: one thread a pair runs all 68 steps (square f on a
//   doubling row, then the sparse line product), conjugates for the negative
//   BLS parameter, and writes its Fq12 (1 for an inactive pair) to scratch;
// * miller_fold_kernel: one block multiplies the values pairwise, level by
//   level, in place in scratch, and writes the product.
//
// Bound on the H100: a pair's steps depend one on the next, 63 squarings and
// 68 line products, about 6,400 Fq products in a row, so one thread's chain
// of some 2.9 million dependent 32-bit instructions sets the time whatever
// the batch; the fold adds log2(B) Fq12 products. An Fq12 is 144 words, so the
// loop's state lives in local memory (L1), not registers.
//
// Inputs: canonical u32 words coeffs [B, 68, 2, 2, 12] ((a3, lam * xi^-1)
// per step), px, py [B, 12], active i32[B]; scratch [B, 2, 3, 2, 12] holds
// Montgomery words between the two kernels; out [2, 3, 2, 12] canonical.
#include "bls_fp.cuh"

constexpr int kSteps = 68;  // 63 doublings and 5 additions: ops/pairing_device.py N_STEPS
constexpr int kLoopThreads = 32;
constexpr int kFoldThreads = 256;

// 1 where a step squares f first (a doubling step), 0 after a set bit of |x|
__constant__ uint8_t SQR_FLAGS[kSteps] = {
    1, 0, 1, 1, 0, 1, 1, 1, 0, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 1, 1, 1, 1, 1,
    1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1,
    1, 1, 1, 0, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1};

__device__ __forceinline__ void fp12_copy_raw(uint32_t* w, const fp12& a) {
  const uint32_t* s = reinterpret_cast<const uint32_t*>(&a);
  for (int k = 0; k < 144; ++k) w[k] = s[k];
}

__device__ __forceinline__ void fp12_read_raw(fp12& a, const uint32_t* w) {
  uint32_t* d = reinterpret_cast<uint32_t*>(&a);
  for (int k = 0; k < 144; ++k) d[k] = w[k];
}

__global__ __launch_bounds__(kLoopThreads) void miller_loop_kernel(
    const uint32_t* __restrict__ coeffs, const uint32_t* __restrict__ px,
    const uint32_t* __restrict__ py, const int32_t* __restrict__ active,
    uint32_t* __restrict__ scratch, int64_t pairs) {
  const int64_t i = blockIdx.x * (int64_t)kLoopThreads + threadIdx.x;
  if (i >= pairs) return;
  fp12 f;
  fp12_set_one(f);
  if (active[i]) {
    fp npx, fpy;
    fp_load(npx, px + i * 12);
    fp_neg(npx, npx);
    fp_load(fpy, py + i * 12);
    const uint32_t* row = coeffs + i * (kSteps * 48);
    for (int step = 0; step < kSteps; ++step, row += 48) {
      if (SQR_FLAGS[step]) fp12_sqr(f, f);
      fp2 a3, a5;
      fp_load(a3.c0, row);
      fp_load(a3.c1, row + 12);
      fp_load(a5.c0, row + 24);
      fp_load(a5.c1, row + 36);
      fp2_mul_fp(a5, a5, npx);
      fp12_mul_line(f, f, fpy, a3, a5);
    }
    fp12_conj(f, f);
  }
  fp12_copy_raw(scratch + i * 144, f);
}

__global__ __launch_bounds__(kFoldThreads) void miller_fold_kernel(uint32_t* __restrict__ scratch,
                                                                  uint32_t* __restrict__ out,
                                                                  int64_t pairs) {
  for (int64_t n = pairs; n > 1;) {
    const int64_t h = (n + 1) / 2;
    for (int64_t j = threadIdx.x; j < n - h; j += blockDim.x) {
      fp12 a, b;
      fp12_read_raw(a, scratch + j * 144);
      fp12_read_raw(b, scratch + (j + h) * 144);
      fp12_mul(a, a, b);
      fp12_copy_raw(scratch + j * 144, a);
    }
    __syncthreads();
    n = h;
  }
  if (threadIdx.x == 0) {
    fp12 a;
    fp12_read_raw(a, scratch);
    fp12_store(out, a);
  }
}

// coeffs u32[pairs, 68, 2, 2, 12], px, py u32[pairs, 12] canonical, active
// i32[pairs] -> scratch u32[pairs, 2, 3, 2, 12] Montgomery.
extern "C" int miller_loop_launch(const void* coeffs, const void* px, const void* py,
                                  const void* active, void* scratch, int64_t pairs,
                                  cudaStream_t stream) {
  if (pairs < 1 || pairs > (int64_t(1) << 30)) return static_cast<int>(cudaErrorInvalidValue);
  const int64_t blocks = (pairs + kLoopThreads - 1) / kLoopThreads;
  miller_loop_kernel<<<(unsigned)blocks, kLoopThreads, 0, stream>>>(
      static_cast<const uint32_t*>(coeffs), static_cast<const uint32_t*>(px),
      static_cast<const uint32_t*>(py), static_cast<const int32_t*>(active),
      static_cast<uint32_t*>(scratch), pairs);
  return static_cast<int>(cudaGetLastError());
}

// scratch u32[pairs, 2, 3, 2, 12] Montgomery (overwritten) -> out
// u32[2, 3, 2, 12] canonical.
extern "C" int miller_fold_launch(void* scratch, void* out, int64_t pairs, cudaStream_t stream) {
  if (pairs < 1 || pairs > (int64_t(1) << 30)) return static_cast<int>(cudaErrorInvalidValue);
  miller_fold_kernel<<<1, kFoldThreads, 0, stream>>>(static_cast<uint32_t*>(scratch),
                                                    static_cast<uint32_t*>(out), pairs);
  return static_cast<int>(cudaGetLastError());
}
