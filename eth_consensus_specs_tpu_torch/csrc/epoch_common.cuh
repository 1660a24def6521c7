// Scalar machinery shared by the accounting-epoch kernels K4
// (altair_epoch.cu) and K9 (state_columns.cu): unsigned min/max, the
// integer square root and weigh_justification_and_finalization, as in
// eth_consensus_specs_tpu/ops/state_columns.py (isqrt_u64 :132,
// justification_update :172); the division by an invariant divisor; the
// block sums; the cooperative launch over the blocks the card holds at
// once. All arithmetic is uint64_t, wrapping as the JAX package's uint64
// lanes do; epochs such as FAR_FUTURE_EPOCH = 2^64 - 1 compare unsigned.
#pragma once
#include <cstdint>
#include <cuda_runtime.h>

__device__ __forceinline__ uint64_t umin(uint64_t a, uint64_t b) { return a < b ? a : b; }
__device__ __forceinline__ uint64_t umax(uint64_t a, uint64_t b) { return a < b ? b : a; }

// integer_squareroot: float64 seed, then two corrections each way.
__device__ __forceinline__ uint64_t isqrt_u64(uint64_t x) {
  uint64_t r = umin(static_cast<uint64_t>(sqrt(__ull2double_rn(x))), 0xFFFFFFFFull);
#pragma unroll
  for (int i = 0; i < 2; ++i)
    if (r > 0 && r * r > x) r -= 1;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const uint64_t rp = r + 1;
    if (rp <= 0xFFFFFFFFull && rp * rp <= x) r = rp;
  }
  return r;
}

// Division by an invariant divisor d >= 1 as a multiply-high and shifts by a
// 65-bit reciprocal (Granlund & Montgomery, "Division by Invariant Integers
// using Multiplication", 1994, Figure 4.1; as libdivide derives it), exact
// for every u64 dividend: n / d = (t + ((n - t) >> sh1)) >> sh2 with
// t = mulhi(magic, n), where l = ceil(log2 d), magic = floor(2^64 (2^l - d)
// / d) + 1, sh1 = min(l, 1), sh2 = max(l - 1, 0). For d = 1 (l = 0): magic
// 1, no shifts, n itself. The host derives a constant's (divisor_magic in
// ops/state_columns.py); make_divisor derives an epoch's on the card.
struct Divisor {
  uint64_t magic;
  uint32_t sh1, sh2;
};

__device__ __forceinline__ uint64_t divq(uint64_t n, const Divisor& d) {
  const uint64_t t = __umul64hi(d.magic, n);
  return (t + ((n - t) >> d.sh1)) >> d.sh2;
}

// floor((u1 * 2^64 + u0) / v) for u1 < v (the quotient fits 64 bits):
// Hacker's Delight divlu, two 64/32-bit digit steps with corrections.
__device__ inline uint64_t div128_64(uint64_t u1, uint64_t u0, uint64_t v) {
  const uint64_t b = 1ull << 32;
  const int s = __clzll(v);
  v <<= s;
  const uint64_t vn1 = v >> 32, vn0 = v & 0xFFFFFFFFull;
  const uint64_t un32 = (u1 << s) | (s ? u0 >> (64 - s) : 0);
  const uint64_t un10 = u0 << s;
  const uint64_t un1 = un10 >> 32, un0 = un10 & 0xFFFFFFFFull;
  uint64_t q1 = un32 / vn1, rhat = un32 - q1 * vn1;
  while (q1 >= b || q1 * vn0 > b * rhat + un1) {
    q1 -= 1;
    rhat += vn1;
    if (rhat >= b) break;
  }
  const uint64_t un21 = un32 * b + un1 - q1 * v;
  uint64_t q0 = un21 / vn1;
  rhat = un21 - q0 * vn1;
  while (q0 >= b || q0 * vn0 > b * rhat + un0) {
    q0 -= 1;
    rhat += vn1;
    if (rhat >= b) break;
  }
  return q1 * b + q0;
}

__device__ inline Divisor make_divisor(uint64_t d) {
  const int l = d == 1 ? 0 : 64 - __clzll(d - 1);
  const uint64_t r = (l == 64 ? 0ull : 1ull << l) - d;  // 2^l - d, below d
  return Divisor{div128_64(r, 0, d) + 1, static_cast<uint32_t>(l < 1 ? l : 1),
                 static_cast<uint32_t>(l > 0 ? l - 1 : 0)};
}

// The scalar justification state read by the epoch (device pointers, in the
// order of the Python JustificationState).
struct JustState {
  const uint64_t* cur_epoch;
  const uint8_t* bits;
  const uint64_t* prev_je;
  const uint8_t* prev_jr;
  const uint64_t* cur_je;
  const uint8_t* cur_jr;
  const uint64_t* fin_e;
  const uint8_t* fin_r;
  const uint8_t *block_root_prev, *block_root_cur;
  const uint64_t* slashings_sum;
};

// Where the epoch writes the justification outputs.
struct JustOutputs {
  uint8_t* bits;
  uint64_t* prev_je;
  uint8_t* prev_jr;
  uint64_t* cur_je;
  uint8_t* cur_jr;
  uint64_t* fin_e;
  uint8_t* fin_r;
};

__device__ __forceinline__ void copy_root(uint8_t* dst, const uint8_t* src) {
#pragma unroll
  for (int b = 0; b < 32; ++b) dst[b] = src[b];
}

// weigh_justification_and_finalization with the genesis guard (epochs 0
// and 1 leave everything unchanged), branch-free over the three balances.
// Returns the finalized epoch after justification, which the leak test of
// the same epoch reads; writes every output when `write` (one thread).
__device__ __forceinline__ uint64_t justification_update(const JustState& j,
                                                         const JustOutputs& o,
                                                         uint64_t prev_tgt, uint64_t cur_tgt,
                                                         uint64_t total, bool write) {
  const uint64_t cur = *j.cur_epoch;
  const uint64_t prev = cur > 0 ? cur - 1 : 0;
  const bool do_justif = cur > 1;
  const bool old_b0 = j.bits[0], old_b1 = j.bits[1], old_b2 = j.bits[2], old_b3 = j.bits[3];
  const uint64_t old_prev_je = *j.prev_je, old_cur_je = *j.cur_je, old_fin_e = *j.fin_e;
  const bool just_prev = prev_tgt * 3 >= total * 2;
  const bool just_cur = cur_tgt * 3 >= total * 2;
  const bool b0 = just_cur, b1 = old_b0 || just_prev, b2 = old_b1, b3 = old_b2;
  const uint64_t new_cur_je = just_cur ? cur : (just_prev ? prev : old_cur_je);
  const uint8_t* new_cur_jr =
      just_cur ? j.block_root_cur : (just_prev ? j.block_root_prev : j.cur_jr);
  // finalization ladder: later (shorter-span) rules override earlier ones
  uint64_t fin_e = old_fin_e;
  const uint8_t* fin_r = j.fin_r;
  if (b1 && b2 && b3 && old_prev_je + 3 == cur) { fin_e = old_prev_je; fin_r = j.prev_jr; }
  if (b1 && b2 && old_prev_je + 2 == cur) { fin_e = old_prev_je; fin_r = j.prev_jr; }
  if (b0 && b1 && b2 && old_cur_je + 2 == cur) { fin_e = old_cur_je; fin_r = j.cur_jr; }
  if (b0 && b1 && old_cur_je + 1 == cur) { fin_e = old_cur_je; fin_r = j.cur_jr; }
  const uint64_t out_fin_e = do_justif ? fin_e : old_fin_e;
  if (write) {
    o.bits[0] = do_justif ? b0 : old_b0;
    o.bits[1] = do_justif ? b1 : old_b1;
    o.bits[2] = do_justif ? b2 : old_b2;
    o.bits[3] = do_justif ? b3 : old_b3;
    *o.prev_je = do_justif ? old_cur_je : old_prev_je;
    copy_root(o.prev_jr, do_justif ? j.cur_jr : j.prev_jr);
    *o.cur_je = do_justif ? new_cur_je : old_cur_je;
    copy_root(o.cur_jr, do_justif ? new_cur_jr : j.cur_jr);
    *o.fin_e = out_fin_e;
    copy_root(o.fin_r, do_justif ? fin_r : j.fin_r);
  }
  return out_fin_e;
}

// Sum kSums u64 values of every thread of the block (a multiple of 32
// threads, at most 1,024) with one atomicAdd each into `sums`. Unsigned
// addition wraps the same in every order, so the result is deterministic.
template <int kSums>
__device__ __forceinline__ void block_sums_atomic(uint64_t (&s)[kSums],
                                                  unsigned long long* sums) {
  __shared__ uint64_t part[32][kSums];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int k = 0; k < kSums; ++k) {
    for (int off = 16; off > 0; off >>= 1) s[k] += __shfl_down_sync(0xFFFFFFFFu, s[k], off);
    if (lane == 0) part[warp][k] = s[k];
  }
  __syncthreads();
  if (warp == 0) {
    const int warps = blockDim.x >> 5;
#pragma unroll
    for (int k = 0; k < kSums; ++k) {
      uint64_t v = lane < warps ? part[lane][k] : 0;
      for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xFFFFFFFFu, v, off);
      if (lane == 0) atomicAdd(sums + k, static_cast<unsigned long long>(v));
    }
  }
}

// One cooperative launch of `kernel` (`threads` a block, its argument block
// `args` by value) over enough blocks for `n` items at `per_block` a block,
// at most the blocks of the kernel that fit on the card at once (queried
// once a device). Returns the launch's CUDA error code.
template <typename Args>
inline int launch_coresident(void (*kernel)(Args), int threads, int64_t n, int64_t per_block,
                             const Args* args, cudaStream_t stream) {
  static int cache[64];
  if (n < 1) return static_cast<int>(cudaErrorInvalidValue);
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev >= 64) return static_cast<int>(cudaErrorInvalidDevice);
  if (cache[dev] == 0) {
    int sms = 0, per_sm = 0;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, 0);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (sms * per_sm <= 0) return static_cast<int>(cudaErrorInvalidConfiguration);
    cache[dev] = sms * per_sm;
  }
  int64_t blocks = (n + per_block - 1) / per_block;
  blocks = blocks < cache[dev] ? blocks : cache[dev];
  void* params[] = {const_cast<Args*>(args)};
  err = cudaLaunchCooperativeKernel((const void*)kernel, dim3(static_cast<unsigned>(blocks)),
                                    dim3(threads), params, 0, stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}
