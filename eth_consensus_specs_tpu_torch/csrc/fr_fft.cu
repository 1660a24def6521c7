// K16: a batch of radix-2 DIT FFTs over Fr, every row at once.
//
// Replaces eth_consensus_specs_tpu/ops/fr_fft.py fft_stages (:61), run by
// _compiled_fft (:101) under batch_fft_mont (:160), with the inverse's n^-1
// scaling (batch_fft_field :205-207): all log2(n) stages of the DIT over
// each row, stage m (the half-size, 1, 2, 4, ...) pairing positions
// (g*2m + k, g*2m + k + m) with the twiddle w_m[k] = roots[k * n / (2m)].
//
// Layout. A row of up to 4,096 elements lives in shared memory: one block
// a row (or a 4,096-element chunk of a longer row) loads it, gathered by the
// bit reversal of the row's positions when the input is in natural order,
// runs every stage whose pairs fall inside the chunk (m < 4,096) with a
// barrier between stages, and writes it back once. Shared memory holds the
// chunk word-major (word w of element j at w * C + j), so a warp reads 32
// consecutive words. A 4,096-chunk is 128 KB of the SM's 228 KB: one block
// an SM. A longer row (8,192 for the DAS extension) finishes with one launch
// a remaining stage, each butterfly read from and written to global memory
// in place. The wrapper makes one fr_fft_chunk_launch and then one
// fr_fft_stage_launch a remaining stage: 1 + log2(n / 4096) launches a
// batch (1 at n <= 4096), each counted under its own kernel.
//
// Values are canonical words in and out, and stay canonical: each twiddle
// and the scale n^-1 arrive in Montgomery form (x * 2^256 mod r, uploaded
// once per root table by the wrapper), and fr_mul of a canonical value and
// a Montgomery constant is the canonical product (fr.cuh), so there is no
// conversion pass on either side. Input values must be below r.
//
// Bound on the H100: the bytes (each row read once and written once, 32 B an
// element: 16 MB for the 64 x 4096 flush, about 5 us) against the integer
// work (n/2 log2(n) Fr products a row, some 250 instructions each: 0.4 G
// instructions for the flush, about 12 us on both integer pipes). With one
// 128 KB block an SM, 64 rows fill 64 of the 132 SMs, and a block's 512
// threads take 4 butterflies a stage one after the other.
#include "fr.cuh"

constexpr int kChunkLog = 12;  // 4,096 elements, 128 KB of shared memory
constexpr int kThreads = 512;
constexpr int kStageThreads = 256;

__device__ __forceinline__ void fr_ld(fr& a, const uint32_t* p) {
  const uint4 lo = *reinterpret_cast<const uint4*>(p);
  const uint4 hi = *reinterpret_cast<const uint4*>(p + 4);
  a.v[0] = lo.x; a.v[1] = lo.y; a.v[2] = lo.z; a.v[3] = lo.w;
  a.v[4] = hi.x; a.v[5] = hi.y; a.v[6] = hi.z; a.v[7] = hi.w;
}

__device__ __forceinline__ void fr_st(uint32_t* p, const fr& a) {
  *reinterpret_cast<uint4*>(p) = make_uint4(a.v[0], a.v[1], a.v[2], a.v[3]);
  *reinterpret_cast<uint4*>(p + 4) = make_uint4(a.v[4], a.v[5], a.v[6], a.v[7]);
}

__device__ __forceinline__ void sm_ld(fr& a, const uint32_t* s, int c, int j) {
#pragma unroll
  for (int w = 0; w < 8; ++w) a.v[w] = s[w * c + j];
}

__device__ __forceinline__ void sm_st(uint32_t* s, int c, int j, const fr& a) {
#pragma unroll
  for (int w = 0; w < 8; ++w) s[w * c + j] = a.v[w];
}

// (a, b) <- (a + b w, a - b w)
__device__ __forceinline__ void butterfly(fr& a, fr& b, const fr& w) {
  fr t;
  fr_mul(t, b, w);
  fr_sub(b, a, t);
  fr_add(a, a, t);
}

__global__ __launch_bounds__(kThreads) void fr_fft_chunk_kernel(
    const uint32_t* __restrict__ in, uint32_t* __restrict__ out, const uint32_t* __restrict__ tw,
    const uint32_t* __restrict__ scale, int log_n, int log_c, int bitrev) {
  extern __shared__ uint32_t sm[];
  const int c = 1 << log_c;
  const int64_t n = int64_t(1) << log_n;
  const int64_t row = int64_t(blockIdx.x) >> (log_n - log_c);
  const int64_t base = (int64_t(blockIdx.x) & ((int64_t(1) << (log_n - log_c)) - 1)) << log_c;
  const uint32_t* src = in + row * n * 8;
  for (int j = threadIdx.x; j < c; j += blockDim.x) {
    const int64_t p = base + j;
    const int64_t s =
        (bitrev && log_n > 0) ? (int64_t)(__brevll((unsigned long long)p) >> (64 - log_n)) : p;
    fr a;
    fr_ld(a, src + s * 8);
    sm_st(sm, c, j, a);
  }
  __syncthreads();
  for (int ls = 0; ls < log_c; ++ls) {
    const int m = 1 << ls;
    for (int t = threadIdx.x; t < (c >> 1); t += blockDim.x) {
      const int k = t & (m - 1);
      const int i0 = ((t >> ls) << (ls + 1)) + k;
      fr a, b, w;
      sm_ld(a, sm, c, i0);
      sm_ld(b, sm, c, i0 + m);
      fr_ld(w, tw + (int64_t)(m - 1 + k) * 8);
      butterfly(a, b, w);
      sm_st(sm, c, i0, a);
      sm_st(sm, c, i0 + m, b);
    }
    __syncthreads();
  }
  fr sc;
  if (scale) fr_ld(sc, scale);
  uint32_t* dst = out + (row * n + base) * 8;
  for (int j = threadIdx.x; j < c; j += blockDim.x) {
    fr a;
    sm_ld(a, sm, c, j);
    if (scale) fr_mul(a, a, sc);
    fr_st(dst + (int64_t)j * 8, a);
  }
}

__global__ __launch_bounds__(kStageThreads) void fr_fft_stage_kernel(
    uint32_t* __restrict__ vals, const uint32_t* __restrict__ tw, const uint32_t* __restrict__ scale,
    int log_n, int ls, int64_t total) {
  const int64_t t = int64_t(blockIdx.x) * blockDim.x + threadIdx.x;
  if (t >= total) return;
  const int64_t row = t >> (log_n - 1);
  const int64_t bt = t & ((int64_t(1) << (log_n - 1)) - 1);
  const int64_t m = int64_t(1) << ls;
  const int64_t k = bt & (m - 1);
  const int64_t i0 = ((bt >> ls) << (ls + 1)) + k;
  uint32_t* v = vals + (row << log_n) * 8;
  fr a, b, w;
  fr_ld(a, v + i0 * 8);
  fr_ld(b, v + (i0 + m) * 8);
  fr_ld(w, tw + (m - 1 + k) * 8);
  butterfly(a, b, w);
  if (scale) {
    fr sc;
    fr_ld(sc, scale);
    fr_mul(a, a, sc);
    fr_mul(b, b, sc);
  }
  fr_st(v + i0 * 8, a);
  fr_st(v + (i0 + m) * 8, b);
}

// One launch of fr_fft_chunk_kernel: every stage with m < 2^log_c.
// in: u32[rows, 2^log_n, 8] canonical values (read only); out: the same shape,
// written; tw: u32[2^log_n - 1, 8] Montgomery twiddles, stage m at rows m - 1
// .. 2m - 2; scale: null or u32[8] Montgomery, applied after the chunk's last
// stage (the caller passes it only when log_c == log_n); log_c: the chunk,
// min(log_n, kChunkLog); bitrev: 1 when the rows are in natural order
// (gathered by bit reversal on load), 0 when they are already in the DIT's
// input order.
extern "C" int fr_fft_chunk_launch(const void* in, void* out, const void* tw, const void* scale,
                                   int64_t rows, int log_n, int log_c, int bitrev,
                                   cudaStream_t stream) {
  if (rows < 1 || log_n < 0 || log_n > 26 || log_c < 0 || log_c > kChunkLog ||
      log_c != (log_n < kChunkLog ? log_n : kChunkLog))
    return static_cast<int>(cudaErrorInvalidValue);
  const int64_t blocks = rows << (log_n - log_c);
  if (blocks > 0x7FFFFFFFLL) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = (size_t(1) << log_c) * 32;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        fr_fft_chunk_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const int half = (1 << log_c) >> 1;
  const int threads = half < 1 ? 1 : (half < kThreads ? half : kThreads);
  fr_fft_chunk_kernel<<<(unsigned)blocks, threads, smem, stream>>>(
      static_cast<const uint32_t*>(in), static_cast<uint32_t*>(out),
      static_cast<const uint32_t*>(tw), static_cast<const uint32_t*>(scale), log_n, log_c, bitrev);
  return static_cast<int>(cudaGetLastError());
}

// One launch of fr_fft_stage_kernel: stage ls (ls >= kChunkLog) of every row
// of vals (u32[rows, 2^log_n, 8], in place); scale as above, passed for the
// last stage only.
extern "C" int fr_fft_stage_launch(void* vals, const void* tw, const void* scale, int64_t rows,
                                   int log_n, int ls, cudaStream_t stream) {
  if (rows < 1 || log_n > 26 || ls < kChunkLog || ls >= log_n)
    return static_cast<int>(cudaErrorInvalidValue);
  const int64_t total = rows << (log_n - 1);
  const int64_t blocks = (total + kStageThreads - 1) / kStageThreads;
  if (blocks > 0x7FFFFFFFLL) return static_cast<int>(cudaErrorInvalidValue);
  fr_fft_stage_kernel<<<(unsigned)blocks, kStageThreads, 0, stream>>>(
      static_cast<uint32_t*>(vals), static_cast<const uint32_t*>(tw),
      static_cast<const uint32_t*>(scale), log_n, ls, total);
  return static_cast<int>(cudaGetLastError());
}
