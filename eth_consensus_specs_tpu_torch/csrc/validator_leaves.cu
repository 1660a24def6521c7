// K3: the per-validator root chain of the registry tree.
//
// Replaces eth_consensus_specs_tpu/ops/state_root.py _validator_leaf_rows
// (:143), the part of validator_registry_root (:161) that recomputes each
// Validator container root from its static nodes and the one field the
// accounting epoch changes:
//   eb_chunk = SSZ chunk of effective_balance (u64 little-endian in bytes 0..7)
//   B = H(eb_chunk, slashed_chunk);  E = H(node_a, B);  root = H(E, node_f)
// One thread per validator, three pair hashes (six compressions) with
// every intermediate in registers (the chain in validator_root.cuh, which
// the forest update shares); reads 104 B and writes the 32-byte leaf that
// K2 then reduces. Integer-ALU bound.
//
// Two entries:
// - validator_leaves_launch: every validator, rows 0..n-1 of `out` (the
//   full registry, or the leaf rows of the incremental forest's validator
//   tree when it is built). With gate_count set it returns at once unless
//   *gate_count > gate_dense: JAX's dense branch of the incremental update.
// - validator_leaves_at_launch: the chain at a gathered index list, as the
//   incremental path's _validator_leaf_fn (state_root.py:721) runs it on the
//   dirty rows; an index outside [0, n) gives the SSZ zero chunk (the
//   padding of the leaf level). With count set, only rows j < *count are
//   hashed, and with dense >= 0 none when *count > dense: JAX's sparse
//   branch of the incremental update. Every row j < cap is written, the
//   rows not hashed as zero chunks, so the output needs no fill.
// Since the forest update (forest_update.cu) computes the registry's dirty
// leaves itself, no path gates the first entry or calls the second.
//
// The indexed entry, written for latency. 4,096 rows are 32 blocks of 128
// threads, a thread a row: far from the card's throughput, so a call takes
// one row's latency, its loads and then its chain of dependent pair hashes.
// The design cuts both: the index and the gate's count are read in one
// round trip, then all of the row's loads are issued together; and the
// first pair hash, B = H(chunk(eff), slashed_chunk), comes from a table
// where it can. Effective balances are multiples of the increment (10^9
// Gwei in every preset) up to 2048 increments (electra's maximum), and a
// slashed chunk is the chunk of false or of true: the table holds B for
// those 2 x 2049 pairs (131 KB, resident in L2 after its first reads),
// built once per card by validator_b_table_launch. A row outside them
// hashes B as before. The chain is then one L2 read and two pair hashes.
#include "common.cuh"
#include "validator_root.cuh"

__global__ void validator_leaves_kernel(const uint64_t* __restrict__ eff,
                                        const uint32_t* __restrict__ slashed,
                                        const uint32_t* __restrict__ node_a,
                                        const uint32_t* __restrict__ node_f,
                                        uint32_t* __restrict__ out, int64_t n,
                                        const int* __restrict__ gate_count, int gate_dense) {
  if (gate_count != nullptr && *gate_count <= gate_dense) return;
  const int64_t i = blockIdx.x * (int64_t)blockDim.x + threadIdx.x;
  if (i >= n) return;
  uint32_t node[8];
  validator_root(eff, slashed, node_a, node_f, i, node);
  store8(out + i * 8, node);
}

constexpr uint64_t kIncrement = 1000000000ull;  // EFFECTIVE_BALANCE_INCREMENT, Gwei
constexpr uint64_t kTableIncrements = 2048;     // MAX_EFFECTIVE_BALANCE_ELECTRA / increment
constexpr int kTableRows = 2 * (int)(kTableIncrements + 1);
constexpr uint32_t kSlashedWord = 0x01000000u;  // the SSZ chunk of true: its first big-endian word
constexpr int kAtThreads = 128;

__device__ __forceinline__ void ldg8(const uint32_t* p, uint32_t v[8]) {
  const uint4* q = reinterpret_cast<const uint4*>(p);
  const uint4 x = __ldg(q), y = __ldg(q + 1);
  v[0] = x.x; v[1] = x.y; v[2] = x.z; v[3] = x.w;
  v[4] = y.x; v[5] = y.y; v[6] = y.z; v[7] = y.w;
}

// Row 2k + s of the table: B = H(chunk(k * increment), the chunk of s).
__global__ void validator_b_table_kernel(uint32_t* __restrict__ table) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= kTableRows) return;
  const uint64_t e = (uint64_t)(r >> 1) * kIncrement;
  uint32_t w[16] = {};
  w[0] = bswap32(static_cast<uint32_t>(e));
  w[1] = bswap32(static_cast<uint32_t>(e >> 32));
  w[8] = (r & 1) ? kSlashedWord : 0u;
  uint32_t b[8];
  sha256_pair(w, b);
  store8(table + 8 * r, b);
}

__global__ __launch_bounds__(kAtThreads) void validator_leaves_at_kernel(
    const uint64_t* __restrict__ eff, const uint32_t* __restrict__ slashed,
    const uint32_t* __restrict__ node_a, const uint32_t* __restrict__ node_f,
    const int* __restrict__ idx, const int* __restrict__ count, int dense, int64_t n, int cap,
    const uint32_t* __restrict__ table, uint32_t* __restrict__ out) {
  const int64_t j = blockIdx.x * (int64_t)kAtThreads + threadIdx.x;
  if (j >= cap) return;
  // the index and the gate's count in one round trip
  const int64_t i = __ldg(idx + j);
  const int live = count != nullptr ? __ldg(count) : cap;
  const bool open = count == nullptr || dense < 0 || live <= dense;
  uint32_t node[8] = {0, 0, 0, 0, 0, 0, 0, 0};
  if (open && j < live && i >= 0 && i < n) {
    // every load of the row at once
    const uint64_t e = __ldg(reinterpret_cast<const unsigned long long*>(eff) + i);
    uint32_t s[8], a[8], f[8], b[8];
    ldg8(slashed + 8 * i, s);
    ldg8(node_a + 8 * i, a);
    ldg8(node_f + 8 * i, f);
    const uint64_t k = e / kIncrement;
    const bool canonical = (s[1] | s[2] | s[3] | s[4] | s[5] | s[6] | s[7]) == 0u &&
                           (s[0] == 0u || s[0] == kSlashedWord);
    if (canonical && k <= kTableIncrements && k * kIncrement == e) {
      ldg8(table + 8 * (2 * k + (s[0] != 0u)), b);  // B from the table, one L2 read
    } else {
      uint32_t w[16];
      w[0] = bswap32(static_cast<uint32_t>(e));
      w[1] = bswap32(static_cast<uint32_t>(e >> 32));
#pragma unroll
      for (int q = 2; q < 8; ++q) w[q] = 0u;
#pragma unroll
      for (int q = 0; q < 8; ++q) w[8 + q] = s[q];
      sha256_pair(w, b);  // B = H(eb_chunk, slashed_chunk)
    }
    sha256_hash_pair(a, b, node);     // E = H(A, B): its first rounds read A alone
    sha256_hash_pair(node, f, node);  // root = H(E, F)
  }
  store8(out + 8 * j, node);
}

extern "C" int validator_leaves_launch(const void* eff, const void* slashed, const void* node_a,
                                       const void* node_f, void* out, int64_t n,
                                       const void* gate_count, int gate_dense,
                                       cudaStream_t stream) {
  if (n > 0) {
    const int threads = 128;
    const int64_t blocks = (n + threads - 1) / threads;
    validator_leaves_kernel<<<(unsigned)blocks, threads, 0, stream>>>(
        static_cast<const uint64_t*>(eff), static_cast<const uint32_t*>(slashed),
        static_cast<const uint32_t*>(node_a), static_cast<const uint32_t*>(node_f),
        static_cast<uint32_t*>(out), n, static_cast<const int*>(gate_count), gate_dense);
  }
  return static_cast<int>(cudaGetLastError());
}

// table: u32[kTableRows, 8] on the card, written by one launch.
extern "C" int validator_b_table_launch(void* table, cudaStream_t stream) {
  const int threads = 128;
  validator_b_table_kernel<<<(kTableRows + threads - 1) / threads, threads, 0, stream>>>(
      static_cast<uint32_t*>(table));
  return static_cast<int>(cudaGetLastError());
}

// out: cap x 8 words, every row written; table: validator_b_table_launch's.
extern "C" int validator_leaves_at_launch(const void* eff, const void* slashed,
                                          const void* node_a, const void* node_f,
                                          const void* idx, const void* count, int dense,
                                          int64_t n, int cap, const void* table, void* out,
                                          cudaStream_t stream) {
  if (cap < 1 || table == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  validator_leaves_at_kernel<<<(cap + kAtThreads - 1) / kAtThreads, kAtThreads, 0, stream>>>(
      static_cast<const uint64_t*>(eff), static_cast<const uint32_t*>(slashed),
      static_cast<const uint32_t*>(node_a), static_cast<const uint32_t*>(node_f),
      static_cast<const int*>(idx), static_cast<const int*>(count), dense, n, cap,
      static_cast<const uint32_t*>(table), static_cast<uint32_t*>(out));
  return static_cast<int>(cudaGetLastError());
}
