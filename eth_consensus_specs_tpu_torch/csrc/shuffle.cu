// K8: every swap-or-not round of the whole-permutation shuffle, one launch.
//
// Replaces eth_consensus_specs_tpu/ops/shuffle.py _device_shuffle_kernel
// (:78), whose body is a fori_loop of `rounds` whole-array passes: flip,
// max, a gather from the digest table and a select over all n lanes each
// round. A lane's rounds read only its own index, the round's pivot and
// the digest table, so lanes are independent: here one thread per lane
// runs all its rounds in registers and writes its index once. The pivots
// sit in shared memory; the table (rounds x chunks x 32 B, 11.8 MB at
// 2^20 lanes and 90 rounds, made by K7) stays in the 50 MB L2, where each
// round reads one 4-byte word of it per lane.
//
// Bound on the H100: about 16 integer instructions per lane and round, and
// one dependent L2 load per round, so a lane's rounds are a chain of L2
// latencies; with 2^20 lanes the card holds about four waves of them.
//
// Hazards handled: C's % of a negative number is negative, so
// flip = pivot - idx gets n added when it is below zero (JAX's jnp.mod
// floors); the decision byte is taken from a big-endian digest word; the
// last chunk may be short (n not a multiple of 256), which only means no
// position reads past it.
#include "common.cuh"

constexpr int kMaxRounds = 256;  // the round is one byte of the hashed message

__global__ void shuffle_rounds_kernel(const uint32_t* __restrict__ digests,
                                      const int32_t* __restrict__ pivots,
                                      int32_t* __restrict__ out, int64_t n, int rounds,
                                      int64_t num_chunks) {
  __shared__ int32_t piv[kMaxRounds];
  for (int r = threadIdx.x; r < rounds; r += blockDim.x) piv[r] = pivots[r];
  __syncthreads();
  const int64_t i = blockIdx.x * (int64_t)blockDim.x + threadIdx.x;
  if (i >= n) return;
  int64_t idx = i;
  const uint32_t* table = digests;
  for (int r = 0; r < rounds; ++r, table += num_chunks * 8) {
    int64_t flip = piv[r] - idx;
    if (flip < 0) flip += n;
    const int64_t pos = flip > idx ? flip : idx;
    const uint32_t in_chunk = static_cast<uint32_t>(pos & 255);
    const uint32_t word = __ldg(table + (pos >> 8) * 8 + (in_chunk >> 5));
    const uint32_t byte_idx = in_chunk >> 3;
    const uint32_t byte = (word >> (8 * (3 - (byte_idx & 3)))) & 0xFFu;
    if ((byte >> (in_chunk & 7)) & 1u) idx = flip;
  }
  out[i] = static_cast<int32_t>(idx);
}

// digests: rounds x num_chunks x 8 big-endian words; pivots: int32[rounds]
// in [0, n); out: int32[n].
extern "C" int shuffle_rounds_launch(const void* digests, const void* pivots, void* out,
                                     int64_t n, int rounds, int64_t num_chunks,
                                     cudaStream_t stream) {
  if (n < 1 || n > 0x7FFFFFFFLL || rounds < 0 || rounds > kMaxRounds ||
      num_chunks != (n + 255) / 256)
    return static_cast<int>(cudaErrorInvalidValue);
  const int threads = 256;
  const int64_t blocks = (n + threads - 1) / threads;
  shuffle_rounds_kernel<<<(unsigned)blocks, threads, 0, stream>>>(
      static_cast<const uint32_t*>(digests), static_cast<const int32_t*>(pivots),
      static_cast<int32_t*>(out), n, rounds, num_chunks);
  return static_cast<int>(cudaGetLastError());
}
