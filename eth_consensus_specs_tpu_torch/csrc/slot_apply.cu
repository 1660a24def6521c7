// K18: one slot's participation and balance scatter over the registry.
//
// Replaces eth_consensus_specs_tpu/ops/slot_pipeline.py _compiled_slot_apply
// (:205), the scatter half of the slot's one donated program (its re-root
// half is post_epoch_state_root_inc, which the port runs over K3, K5, K6,
// K1 and K2). For a registry of n validators and a plan of valid updates:
//
//   new_flags[v]   = prev_flags[v] | 0b111   where v is a flag index
//   new_tgt[v]     = 1                        where v is a flag index
//   new_balance[v] = balance[v] + sum of the rewards at v, mod 2^64
//
// JAX counts the hits of each validator by scatter-add and ORs the mask
// where the count is positive; the result is the same as setting the flags
// once per index, since the OR is idempotent. The committed columns are not
// donated (a failed slot leaves the state as it was), so the outputs are new
// buffers:
//
// slot_apply_launch: one pass over n that copies the three columns into the
// outputs. Bound by bytes: 2 x (8 + 1 + 1) B a validator, 20.97 MB at 2^20.
//
// slot_apply_scatter_launch: one thread a lane, the flag lanes first, then
// the reward lanes. A flag lane stores prev | 0b111 and 1: duplicates store
// the same bytes. A reward lane adds with a 64-bit atomicAdd, exact and
// independent of order, so duplicates accumulate and the sum wraps mod 2^64
// as JAX's u64 scatter-add does. Bound by bytes: 4 B an index plus the two
// bytes it sets a flag lane, 12 B a reward lane plus its balance word.
//
// The wrapper (ops/slot_pipeline.py slot_apply) checks every index against
// [0, n) on the host before launch; the kernel trusts them.
#include "common.cuh"

constexpr int kThreads = 256;

__global__ void slot_apply_kernel(const uint64_t* __restrict__ balance,
                                  const uint8_t* __restrict__ flags,
                                  const uint8_t* __restrict__ tgt,
                                  uint64_t* __restrict__ new_balance,
                                  uint8_t* __restrict__ new_flags,
                                  uint8_t* __restrict__ new_tgt, int64_t n) {
  const int64_t stride = int64_t(gridDim.x) * blockDim.x;
  for (int64_t i = int64_t(blockIdx.x) * blockDim.x + threadIdx.x; i < n; i += stride) {
    new_balance[i] = balance[i];
    new_flags[i] = flags[i];
    new_tgt[i] = tgt[i];
  }
}

__global__ void slot_apply_scatter_kernel(const uint8_t* __restrict__ flags,
                                          uint64_t* new_balance, uint8_t* new_flags,
                                          uint8_t* new_tgt, const int32_t* __restrict__ flag_idx,
                                          int64_t n_flags, const int32_t* __restrict__ reward_idx,
                                          const uint64_t* __restrict__ reward_amt,
                                          int64_t n_rewards) {
  const int64_t t = int64_t(blockIdx.x) * blockDim.x + threadIdx.x;
  if (t < n_flags) {
    const int64_t v = flag_idx[t];
    new_flags[v] = flags[v] | uint8_t(0b111);
    new_tgt[v] = 1;
  } else if (t < n_flags + n_rewards) {
    const int64_t r = t - n_flags;
    atomicAdd(reinterpret_cast<unsigned long long*>(new_balance + reward_idx[r]),
              static_cast<unsigned long long>(reward_amt[r]));
  }
}

// balance, new_balance: u64[n]; flags, tgt, new_flags, new_tgt: u8[n].
extern "C" int slot_apply_launch(const void* balance, const void* flags, const void* tgt,
                                 void* new_balance, void* new_flags, void* new_tgt, int64_t n,
                                 cudaStream_t stream) {
  if (n < 0) return static_cast<int>(cudaErrorInvalidValue);
  int64_t blocks = (n + kThreads - 1) / kThreads;
  if (blocks > 132 * 16) blocks = 132 * 16;
  if (blocks > 0)
    slot_apply_kernel<<<(unsigned)blocks, kThreads, 0, stream>>>(
        static_cast<const uint64_t*>(balance), static_cast<const uint8_t*>(flags),
        static_cast<const uint8_t*>(tgt), static_cast<uint64_t*>(new_balance),
        static_cast<uint8_t*>(new_flags), static_cast<uint8_t*>(new_tgt), n);
  return static_cast<int>(cudaGetLastError());
}

// flag_idx: i32[n_flags]; reward_idx: i32[n_rewards]; reward_amt: u64[n_rewards].
extern "C" int slot_apply_scatter_launch(const void* flags, void* new_balance, void* new_flags,
                                         void* new_tgt, const void* flag_idx, int64_t n_flags,
                                         const void* reward_idx, const void* reward_amt,
                                         int64_t n_rewards, cudaStream_t stream) {
  if (n_flags < 0 || n_rewards < 0 || n_flags + n_rewards < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const int64_t blocks = (n_flags + n_rewards + kThreads - 1) / kThreads;
  slot_apply_scatter_kernel<<<(unsigned)blocks, kThreads, 0, stream>>>(
      static_cast<const uint8_t*>(flags), static_cast<uint64_t*>(new_balance),
      static_cast<uint8_t*>(new_flags), static_cast<uint8_t*>(new_tgt),
      static_cast<const int32_t*>(flag_idx), n_flags, static_cast<const int32_t*>(reward_idx),
      static_cast<const uint64_t*>(reward_amt), n_rewards);
  return static_cast<int>(cudaGetLastError());
}
