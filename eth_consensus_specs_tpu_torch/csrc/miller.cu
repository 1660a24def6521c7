// K11: the batched Miller loop and the product of its values.
//
// Replaces eth_consensus_specs_tpu/ops/pairing_device.py miller_from_coeffs
// (:170, a lax.scan of the 68 steps vmapped over pairs) and its chunk fold
// _miller_chunk_fold (:301), with the tower of ops/fq12_tower.py and
// ops/lazy_limbs.py. The JAX chunking into 8 pairs is an XLA compile
// artifact and is not kept: any fold order gives the same canonical product.
//
// Two kernels, each with its own entry point (and launch count):
// * miller_loop_kernel: a group of 64 threads runs one pair on the
//   cooperative tower (fp12_coop.cuh), f in shared memory, one lane an Fq
//   product. A doubling step is four rounds (the squaring's 36 products, its
//   Fq6 level, the line's 48 products reading the square as sums of that
//   level, the line's sum), an addition step two (the line's). A block holds
//   kMlGroups pairs. The pair's 68 x 4 coefficient words are staged in shared
//   memory by cp.async, word-major, step 0's first so the bulk lands while
//   step 0 squares; each line round also takes the next step's coefficients
//   into Montgomery form (4 more products), and a prologue takes py, -px and
//   step 0's. Conjugated for the negative BLS parameter (1 for an inactive
//   pair), the block's values are multiplied in a product tree in shared
//   memory and the block's product written to scratch.
// * miller_fold_kernel: one block of kFoldGroups groups multiplies the
//   blocks' products pairwise, level by level, in scratch, and writes the
//   product.
//
// Bound on the H100: a pair's steps depend one on the next, 63 squarings and
// 68 line products, 131 product rounds and 131 add rounds in a row; the
// blocks' fold adds log2 of the blocks' count Fq12 products.
//
// Inputs: canonical u32 words coeffs [B, 68, 2, 2, 12] ((a3, lam * xi^-1)
// per step), px, py [B, 12], active i32[B]; scratch [B, 2, 3, 2, 12] holds
// Montgomery words between the two kernels (one row a block of the first);
// out [2, 3, 2, 12] canonical.
#include "fp12_coop.cuh"

constexpr int kSteps = 68;  // 63 doublings and 5 additions: ops/pairing_device.py N_STEPS
constexpr int kMlLanes = 1;  // lanes an Fq product
constexpr int kMlThreads = 64 * kMlLanes;  // a group: one pair
constexpr int kMlGroups = 2;  // pairs a block: 129 pairs over 65 SMs
static_assert(coop_group_fits(kMlThreads, kMlLanes), "a round wider than the group");
// a group's slots: S, f, the coefficients (68 steps x a3, lam xi^-1), py, px
constexpr int kMlGroupSlots = kCoopSlots + 12 + kSteps * 4 + 2;
constexpr int kMlStride = kMlGroupSlots * kMlGroups;
constexpr int kMlSmem = (12 * kMlStride + kCoopTableWords) * 4;

// 1 where a step squares f first (a doubling step), 0 after a set bit of |x|
__constant__ uint8_t SQR_FLAGS[kSteps] = {
    1, 0, 1, 1, 0, 1, 1, 1, 0, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 1, 1, 1, 1, 1,
    1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1,
    1, 1, 1, 0, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1};

__device__ __forceinline__ void cp_async4(uint32_t* dst, const uint32_t* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(d), "l"(src) : "memory");
}

__global__ __launch_bounds__(kMlThreads * kMlGroups) void miller_loop_kernel(
    const uint32_t* __restrict__ coeffs, const uint32_t* __restrict__ px,
    const uint32_t* __restrict__ py, const int32_t* __restrict__ active,
    uint32_t* __restrict__ scratch, int64_t pairs) {
  constexpr int L = kMlLanes;
  extern __shared__ uint32_t mem[];  // the groups' slots, then the table
  coop_stage_table(mem + 12 * kMlStride);
  const int grp = threadIdx.x / kMlThreads;
  const Coop g{mem, kMlStride, grp * kMlGroupSlots, static_cast<int>(threadIdx.x % kMlThreads),
               1 + grp, kMlThreads, reinterpret_cast<const uint16_t*>(mem + 12 * kMlStride)};
  const int F = g.s + kCoopSlots, C = F + 12, PZ = C + kSteps * 4;
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kMlGroups + grp;
  const bool live = i < pairs && active[i] != 0;  // the same for the whole group
  coop_set_one(g, F);
  if (live) {
    const uint32_t* row = coeffs + i * (kSteps * 48);
    // step 0's words, then the rest: word w is word w % 12 of slot C + w / 12
    for (int w = g.tid; w < 48; w += g.nthreads)
      cp_async4(mem + (w % 12) * kMlStride + C + w / 12, row + w);
    asm volatile("cp.async.commit_group;" ::: "memory");
    for (int w = 48 + g.tid; w < kSteps * 48; w += g.nthreads)
      cp_async4(mem + (w % 12) * kMlStride + C + w / 12, row + w);
    asm volatile("cp.async.commit_group;" ::: "memory");
    if (g.tid < 24) {
      const uint32_t* src = g.tid < 12 ? py : px;
      mem[(g.tid % 12) * kMlStride + PZ + g.tid / 12] = src[i * 12 + g.tid % 12];
    }
    asm volatile("cp.async.wait_group 1;" ::: "memory");  // step 0's words
  }
  coop_init(g);
  if (live) {
    coop_run<L>(g, kOp_prep, 0, C, PZ, 0);
    // step 0 squares while the bulk of the coefficients lands
    coop_run<L>(g, kOp_sqr, F, 0, 0, F);
    asm volatile("cp.async.wait_group 0;" ::: "memory");
    coop_sync(g);
    coop_run<L>(g, kOp_line_conv, F, C, PZ, F);
    for (int step = 1; step < kSteps; ++step) {
      const bool last = step + 1 == kSteps;
      const int op = SQR_FLAGS[step] ? (last ? kOp_sqr_line : kOp_sqr_line_conv)
                                     : (last ? kOp_line : kOp_line_conv);
      coop_run<L>(g, op, F, C + 4 * step, PZ, F);
    }
    coop_run<L>(g, kOp_conj, F, 0, 0, F);
  }
  // the block's product tree over its groups' values
  __syncthreads();
  for (int n = kMlGroups; n > 1;) {
    const int h = (n + 1) / 2;
    if (grp < n - h) coop_run<L>(g, kOp_mul, F, F + h * kMlGroupSlots, 0, F);
    __syncthreads();
    n = h;
  }
  if (grp == 0) coop_store_words(g, F, scratch + static_cast<int64_t>(blockIdx.x) * 144);
}

// the fold's block: 512 threads in groups, a group's slots S and two Fq12
constexpr int kFoldGroups = 512 / kMlThreads;
constexpr int kFoldGroupSlots = kCoopSlots + 24;
constexpr int kFoldStride = kFoldGroupSlots * kFoldGroups;
constexpr int kFoldSmem = (12 * kFoldStride + kCoopTableWords) * 4;

__global__ __launch_bounds__(kMlThreads * kFoldGroups) void miller_fold_kernel(
    uint32_t* __restrict__ scratch, uint32_t* __restrict__ out, int64_t values) {
  constexpr int L = kMlLanes;
  extern __shared__ uint32_t mem[];  // the groups' slots, then the table
  coop_stage_table(mem + 12 * kFoldStride);
  const int grp = threadIdx.x / kMlThreads;
  const Coop g{mem, kFoldStride, grp * kFoldGroupSlots,
               static_cast<int>(threadIdx.x % kMlThreads), 1 + grp, kMlThreads,
               reinterpret_cast<const uint16_t*>(mem + 12 * kFoldStride)};
  const int A = g.s + kCoopSlots, B = A + 12;
  coop_init(g);
  for (int64_t n = values; n > 1;) {
    const int64_t h = (n + 1) / 2;
    for (int64_t base = 0; base < n - h; base += kFoldGroups) {
      const int64_t j = base + grp;
      if (j < n - h) {
        coop_load_words(g, A, scratch + j * 144);
        coop_load_words(g, B, scratch + (j + h) * 144);
        coop_sync(g);
        coop_run<L>(g, kOp_mul, A, B, 0, A);
        coop_store_words(g, A, scratch + j * 144);
      }
      __syncthreads();
    }
    n = h;
  }
  if (grp == 0) {
    coop_load_words(g, A, scratch);
    coop_sync(g);
    coop_run<L>(g, kOp_store, A, 0, 0, A);
    coop_store_words(g, A, out);
  }
}

// both kernels take more than 48 KB of shared memory: allow it once
static cudaError_t size_kernels() {
  static bool sized = false;
  if (sized) return cudaSuccess;
  cudaError_t e = cudaFuncSetAttribute(miller_loop_kernel,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, kMlSmem);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(miller_fold_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             kFoldSmem);
  sized = e == cudaSuccess;
  return e;
}

// coeffs u32[pairs, 68, 2, 2, 12], px, py u32[pairs, 12] canonical, active
// i32[pairs] -> scratch u32[blocks, 2, 3, 2, 12] Montgomery, one row a block
// of kMlGroups pairs.
extern "C" int miller_loop_launch(const void* coeffs, const void* px, const void* py,
                                  const void* active, void* scratch, int64_t pairs,
                                  cudaStream_t stream) {
  if (pairs < 1 || pairs > (int64_t(1) << 30)) return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t e = size_kernels();
  if (e != cudaSuccess) return static_cast<int>(e);
  const int64_t blocks = (pairs + kMlGroups - 1) / kMlGroups;
  miller_loop_kernel<<<static_cast<unsigned>(blocks), kMlThreads * kMlGroups, kMlSmem, stream>>>(
      static_cast<const uint32_t*>(coeffs), static_cast<const uint32_t*>(px),
      static_cast<const uint32_t*>(py), static_cast<const int32_t*>(active),
      static_cast<uint32_t*>(scratch), pairs);
  return static_cast<int>(cudaGetLastError());
}

// scratch: the first kernel's rows (overwritten) -> out u32[2, 3, 2, 12]
// canonical.
extern "C" int miller_fold_launch(void* scratch, void* out, int64_t pairs, cudaStream_t stream) {
  if (pairs < 1 || pairs > (int64_t(1) << 30)) return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t e = size_kernels();
  if (e != cudaSuccess) return static_cast<int>(e);
  miller_fold_kernel<<<1, kMlThreads * kFoldGroups, kFoldSmem, stream>>>(
      static_cast<uint32_t*>(scratch), static_cast<uint32_t*>(out),
      (pairs + kMlGroups - 1) / kMlGroups);
  return static_cast<int>(cudaGetLastError());
}
