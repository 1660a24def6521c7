// K19: one slot's block against the dense plane, one cooperative launch
// spread over the card.
//
// Replaces eth_consensus_specs_tpu/ops/block_epoch.py process_slot_columnar
// (:265) with _apply_withdrawals (:224), _apply_attestation (:164),
// _apply_deposits (:218) and _apply_sync (:196), the body of the slot scan
// of _block_epoch_chain_impl (:406). The balance, both participation columns
// and the scalars (next withdrawal index, next withdrawal validator, the
// proposer numerator left after the last row) are updated in place. All u64
// arithmetic is unsigned and wraps as JAX's uint64 does.
//
// The spec walks the rows, the deposits and the sync positions in order.
// The order matters in three places only, and each has an exact parallel
// form:
//
// - Attestation rows. A row's new = flags & ~pre depends on earlier rows
//   only through part[idx], so a column ends as pre | the OR of every live
//   lane's flags, whatever the order, and the reward for bit b of
//   (column, validator) goes to the FIRST row whose live lane carries b
//   while pre lacks it. Each row's numerator share is a u64 sum, which wraps
//   the same in any order; only the carry over rows, divided at each pay
//   row, is sequential, and that is a scan over the per-row sums: a pay
//   row's quotient is (S[p] - S[previous pay row]) / denominator, S the
//   inclusive prefix sum, and the numerator left is S[last] - S[last pay].
// - Sync positions. Indices repeat and a decrease clamps at 0 per
//   operation, so one validator's positions go in order; different
//   validators do not interact. The proposer's chain interleaves its own
//   positions with +prop_r for every set bit; between two of its own
//   positions those adds are one multiply by the count of set bits there.
// - Withdrawals set balances, so they come before the proposer's pay, the
//   deposits and the sync; they never touch the participation columns.
//
// One launch of G blocks x 1,024 threads, G from the occupancy API (all
// resident at once), two grid barriers:
//
// A. Block 0 runs the capella sweep over the window (start + i) % n,
//    i < bound = min(n, sweep), 16 positions a thread (16 x 1,024 = 16,384,
//    mainnet's sweep; thread t's k-th is k * 1,024 + t, so loads coalesce):
//    ballots and a block scan rank the eligible positions, the first
//    max_withdrawals are paid (a full withdrawal leaves 0, a partial one the
//    maximum effective balance), then the pointer rules: after a full
//    payload resume after the last paid position, otherwise skip the whole
//    sweep, mod n. The other blocks meanwhile take the lanes, one a thread
//    (a grid-stride loop past that): a live lane (idx < n, bit, flags != 0)
//    reads pre = part[idx] and records its row as a minimum for each bit of
//    flags & ~pre in the first-setter scratch, one u64 a (column, validator)
//    holding three 16-bit row minima (0xFFFF: none), by atomicCAS on their
//    halfword-wise minimum (__vminu2).
// B. grid.sync(). A lane's new bits are the bits whose recorded minimum is
//    its own row (indices are unique within a row, JAX's contract, so the
//    minimum names one lane). It adds weight(new) * base_reward[idx] to its
//    row: a segmented warp scan over the row keys, then one 64-bit atomicAdd
//    a row segment and warp. It ORs its flags into part[idx] with a 32-bit
//    atomicOr on the aligned word (part is u8). Deposits add with a 64-bit
//    atomicAdd; duplicates commute.
// C. grid.sync(). Block 0: the pay rows by block scans of the row sums
//    (each reset to 0 once read) and of the pay flags, the quotients summed
//    and added to the proposer; then the sync aggregate: the positions staged in shared
//    memory, a block scan of the set bits, a bitonic sort of
//    (validator << 10 | position) keys, and the first thread of each run of
//    one validator walks that run in order in a register and writes once;
//    the proposer's run adds prop_r times the set bits between its own
//    positions (or, outside the committee, thread 0 adds the pay and
//    prop_r times every set bit). The other blocks reset the scratch entries
//    of their live lanes, so the scratch is clean for the next slot and no
//    slot runs a memset over n.
//
// Bound on the H100: by bytes, about 1.3 MB a slot at 2^20 validators x 128
// rows x 512 lanes (the window's four columns, the rows, the live lanes'
// flags and base rewards, the walk), 0.4 us. This design's chain is the
// launch, two grid barriers, a few random round trips per phase, and in
// block 0 the sort (45 steps at 512 positions) and the longest run of one
// validator's sync positions plus the proposer's own positions.
//
// The wrapper (ops/block_epoch.py block_slot) checks shapes, types and the
// limits below and passes the scratch (2n + kMaxRows u64, all ones then
// zeros, left so again); the chain checks every index once before its first
// slot (rows and deposits <= n, sync indices and proposers < n). Pad lanes
// carry idx == n and are never read.
#include <cooperative_groups.h>

#include "common.cuh"

namespace cg = cooperative_groups;

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr int kWindowPerThread = 16;
constexpr int kMaxWindow = kThreads * kWindowPerThread;
constexpr int kMaxSync = kThreads;  // one sort key a thread of block 0
constexpr int kMaxRows = kThreads;  // one row sum a thread of block 0
constexpr int kPosBits = 10;        // a sync position in the sort key
constexpr unsigned long long kNone = ~0ull;  // a clean first-setter entry
static_assert(kMaxSync <= (1 << kPosBits), "a sync position must fit its key field");
static_assert(kMaxRows < 0xFFFF, "a row must fit a 16-bit minimum below the none value");

struct SlotArgs {
  uint64_t* balance;
  uint8_t* cur;
  uint8_t* prev;
  uint64_t* scal;     // [next_wd_index, next_wd_validator, numerator]
  unsigned long long* first;    // [2, n] first-setter minima: cur, then prev
  unsigned long long* row_sum;  // [kMaxRows]
  const uint64_t* base_reward;
  const uint64_t* eff;
  const uint64_t* wd_epoch;
  const uint8_t* cred;
  const uint64_t* epoch;
  const uint64_t* part_r;
  const uint64_t* prop_r;
  const int32_t* att_idx;  // [rows, lanes]
  const uint8_t* att_bits;
  const uint8_t* att_flags;  // [rows]
  const uint8_t* att_cur;
  const uint8_t* att_pay;
  const int32_t* proposer;  // one index
  const int32_t* sync_idx;  // [sync]
  const uint8_t* sync_bits;
  const int32_t* dep_idx;  // [deps]
  const uint64_t* dep_amt;
  int64_t n;
  int rows, lanes, sync, deps;
  uint64_t w0, w1, w2, denom, max_w, sweep, max_eb;
  int with_wd;
};

// Inclusive scan of one value a thread over the 1,024 threads; *total gets
// the block's sum. Every thread must call it.
template <typename T>
__device__ T block_scan(T x, T* warp_sums, T* total) {
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const T y = __shfl_up_sync(0xffffffffu, x, off);
    if (lane >= off) x += y;
  }
  if (lane == 31) warp_sums[w] = x;
  __syncthreads();
  if (w == 0) {
    T v = warp_sums[lane];
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const T y = __shfl_up_sync(0xffffffffu, v, off);
      if (lane >= off) v += y;
    }
    warp_sums[lane] = v;
  }
  __syncthreads();
  if (w > 0) x += warp_sums[w - 1];
  *total = warp_sums[kWarps - 1];
  __syncthreads();  // warp_sums may be reused at once
  return x;
}

// The sweep, in block 0. Position i = k * 1,024 + t of the window is thread
// t's k-th, so each load of a warp is coalesced; a position's rank counts
// the eligible positions before it: a warp ballot within its group of 32,
// and a block scan over the 512 groups, which lie in window order (k, then
// the warp).
__device__ void withdrawals(const SlotArgs& a, uint32_t* group_below, uint32_t* warp_counts,
                            uint32_t* last_pos) {
  const int t = threadIdx.x, lane = t & 31, w = t >> 5;
  const uint64_t n = a.n, start = a.scal[1] % n, epoch = *a.epoch;
  const uint64_t bound = a.sweep < n ? a.sweep : n;
  uint32_t elig = 0, full = 0;  // bit k: position k * kThreads + t
#pragma unroll
  for (int k = 0; k < kWindowPerThread; ++k) {
    const uint64_t i = uint64_t(k) * kThreads + t;
    bool f = false, p = false;
    if (i < bound) {
      const uint64_t v = start + i < n ? start + i : start + i - n;
      const uint64_t bal = a.balance[v];
      const bool cred = a.cred[v] != 0;
      f = cred && a.wd_epoch[v] <= epoch && bal > 0;
      p = cred && a.eff[v] == a.max_eb && bal > a.max_eb;
    }
    const unsigned e = __ballot_sync(0xffffffffu, f || p);
    if (lane == 0) group_below[k * kWarps + w] = __popc(e);
    elig |= uint32_t(f || p) << k;
    full |= uint32_t(f) << k;
  }
  if (t == 0) *last_pos = 0;
  __syncthreads();
  constexpr int kGroups = kWindowPerThread * kWarps;
  const uint32_t c = t < kGroups ? group_below[t] : 0;
  uint32_t total;
  const uint32_t incl = block_scan<uint32_t>(c, warp_counts, &total);
  if (t < kGroups) group_below[t] = incl - c;
  __syncthreads();
  const unsigned below_me = (1u << lane) - 1;
#pragma unroll
  for (int k = 0; k < kWindowPerThread; ++k) {
    const unsigned e = __ballot_sync(0xffffffffu, (elig >> k) & 1u);
    if (!((elig >> k) & 1u)) continue;
    const uint64_t rank = group_below[k * kWarps + w] + __popc(e & below_me) + 1;
    if (rank > a.max_w) continue;
    const uint64_t i = uint64_t(k) * kThreads + t;
    a.balance[start + i < n ? start + i : start + i - n] = ((full >> k) & 1u) ? 0 : a.max_eb;
    atomicMax(last_pos, uint32_t(i));
  }
  __syncthreads();
  if (t == 0) {
    const uint64_t taken = total < a.max_w ? total : a.max_w;
    a.scal[0] += taken;
    a.scal[1] = taken == a.max_w ? (start + *last_pos + 1) % n : (start + a.sweep) % n;
  }
}

// A u64 written by another block before the last grid.sync(): read past L1.
__device__ __forceinline__ uint64_t ld_l2(const uint64_t* p) {
  return __ldcg(reinterpret_cast<const unsigned long long*>(p));
}

__device__ __forceinline__ uint64_t field_min(uint64_t x, uint64_t y) {
  return uint64_t(__vminu2(uint32_t(x), uint32_t(y))) |
         (uint64_t(__vminu2(uint32_t(x >> 32), uint32_t(y >> 32))) << 32);
}

// Lane g of the slot, when live: its row, column and validator.
struct Lane {
  int r;
  int col;  // 0: current, 1: previous
  int64_t idx;
  uint8_t flags;
  bool live;
};

__device__ __forceinline__ Lane lane_at(const SlotArgs& a, int g) {
  Lane l;
  l.r = g / a.lanes;
  l.flags = a.att_flags[l.r];
  l.col = a.att_cur[l.r] ? 0 : 1;
  l.idx = a.att_idx[g];
  l.live = l.flags != 0 && uint64_t(l.idx) < uint64_t(a.n) && a.att_bits[g] != 0;
  return l;
}

__global__ void __launch_bounds__(kThreads, 1) block_slot_kernel(const SlotArgs a) {
  cg::grid_group grid = cg::this_grid();
  __shared__ uint32_t warp_counts[kWarps];
  __shared__ uint32_t group_below[kWindowPerThread * kWarps];
  __shared__ unsigned long long warp_sums[kWarps];
  __shared__ uint32_t last_pos;
  __shared__ unsigned long long keys[kMaxSync];
  __shared__ uint16_t before[kMaxSync];  // set bits at the positions before
  __shared__ uint8_t s_bit[kMaxSync];
  __shared__ unsigned long long pay_at[kMaxRows];
  __shared__ unsigned long long pay_total;
  __shared__ int prop_in_sync;
  const int t = threadIdx.x;
  const int64_t n = a.n;
  const int total = a.rows * a.lanes;
  // block 0 takes the sweep and the pay and sync; the others the lanes
  const int lane_blocks = gridDim.x > 1 ? gridDim.x - 1 : 1;
  const int lane_block = gridDim.x > 1 ? int(blockIdx.x) - 1 : 0;
  const bool lanes_here = lane_block >= 0;
  const int stride = lane_blocks * kThreads;
  const int tid = lane_block * kThreads + t;

  // A: the sweep; the first setters
  if (blockIdx.x == 0 && a.with_wd) withdrawals(a, group_below, warp_counts, &last_pos);
  if (lanes_here) {
    for (int g = tid; g < total; g += stride) {
      const Lane l = lane_at(a, g);
      if (!l.live) continue;
      const uint8_t* part = l.col ? a.prev : a.cur;
      const uint32_t cand = l.flags & 7u & ~uint32_t(part[l.idx]);
      if (cand == 0) continue;
      unsigned long long want = kNone;  // row r in the fields of the candidate bits
      for (int b = 0; b < 3; ++b)
        if ((cand >> b) & 1u) want &= ~(uint64_t(0xFFFF ^ l.r) << (16 * b));
      unsigned long long* slot = a.first + l.col * n + l.idx;
      unsigned long long old = kNone;
      while (true) {
        const unsigned long long nv = field_min(old, want);
        if (nv == old) break;
        const unsigned long long seen = atomicCAS(slot, old, nv);
        if (seen == old) break;
        old = seen;
      }
    }
  }
  grid.sync();

  // B: credit each lane's first-set bits to its row; OR the flags; deposits
  if (lanes_here) {
    const int lane = t & 31;
    for (int g = tid; g - lane < total; g += stride) {  // warp-uniform trip count
      unsigned long long v = 0;
      int key = -1;
      if (g < total) {
        const Lane l = lane_at(a, g);
        key = l.r;
        if (l.live) {
          const uint64_t mins = __ldcg(a.first + l.col * n + l.idx);
          uint32_t nb = 0;
          for (int b = 0; b < 3; ++b)
            if (((l.flags >> b) & 1u) && ((mins >> (16 * b)) & 0xFFFF) == uint64_t(l.r))
              nb |= 1u << b;
          const uint64_t w = ((nb & 1) ? a.w0 : 0) + ((nb & 2) ? a.w1 : 0) + ((nb & 4) ? a.w2 : 0);
          v = w * a.base_reward[l.idx];
          uint8_t* part = l.col ? a.prev : a.cur;
          if (l.flags & ~__ldcg(part + l.idx)) {  // a stale read only skips a no-op
            const uintptr_t addr = reinterpret_cast<uintptr_t>(part + l.idx);
            atomicOr(reinterpret_cast<unsigned int*>(addr & ~uintptr_t(3)),
                     uint32_t(l.flags) << (8 * (addr & 3)));
          }
        }
      }
      // rows are contiguous runs of g: a segmented scan leaves each run's
      // sum in its last lane
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const unsigned long long up = __shfl_up_sync(0xffffffffu, v, off);
        const int up_key = __shfl_up_sync(0xffffffffu, key, off);
        if (lane >= off && up_key == key) v += up;
      }
      const int next_key = __shfl_down_sync(0xffffffffu, key, 1);
      if ((lane == 31 || next_key != key) && key >= 0 && v != 0) atomicAdd(a.row_sum + key, v);
    }
    for (int d = tid; d < a.deps; d += stride) {
      const int64_t idx = a.dep_idx[d];
      if (idx < n)
        atomicAdd(reinterpret_cast<unsigned long long*>(a.balance + idx),
                  static_cast<unsigned long long>(a.dep_amt[d]));
    }
  }
  grid.sync();

  // C: reset the scratch; block 0 pays the proposer and runs the sync aggregate
  if (lanes_here) {
    for (int g = tid; g < total; g += stride) {
      const Lane l = lane_at(a, g);
      if (l.live) a.first[l.col * n + l.idx] = kNone;
    }
  }
  if (blockIdx.x != 0) return;

  unsigned long long x = 0;
  bool pay = false;
  if (t < a.rows) {
    x = __ldcg(a.row_sum + t);
    a.row_sum[t] = 0;
    pay = a.att_pay[t] != 0;
  }
  unsigned long long s_all;
  const unsigned long long s = block_scan<unsigned long long>(x, warp_sums, &s_all);
  uint32_t n_pay;
  const uint32_t rank = block_scan<uint32_t>(pay, warp_counts, &n_pay) - pay;
  if (pay) pay_at[rank] = s;
  __syncthreads();
  unsigned long long q = 0;
  if (t < int(n_pay)) q = (pay_at[t] - (t ? pay_at[t - 1] : 0ull)) / a.denom;
  unsigned long long q_all;
  block_scan<unsigned long long>(q, warp_sums, &q_all);
  if (t == 0) {
    a.scal[2] = s_all - (n_pay ? pay_at[n_pay - 1] : 0ull);
    pay_total = q_all;
    prop_in_sync = 0;
  }

  const int64_t prop = a.proposer[0];
  const uint64_t pr = *a.part_r, qr = *a.prop_r;
  uint32_t bit = 0;
  unsigned long long key = kNone;
  if (t < a.sync) {
    bit = a.sync_bits[t] != 0;
    s_bit[t] = bit;
    key = (uint64_t(a.sync_idx[t]) << kPosBits) | uint64_t(t);
  }
  uint32_t bits_all;
  const uint32_t incl = block_scan<uint32_t>(bit, warp_counts, &bits_all);
  if (t < a.sync) before[t] = uint16_t(incl - bit);
  int width = 1;
  while (width < a.sync) width <<= 1;
  keys[t] = key;
  __syncthreads();
  for (int k = 2; k <= width; k <<= 1) {  // bitonic sort of the first `width` keys
    for (int j = k >> 1; j > 0; j >>= 1) {
      const int p = t ^ j;
      if (t < width && p > t) {
        const unsigned long long lo = keys[t], hi = keys[p];
        if ((lo > hi) == ((t & k) == 0)) {
          keys[t] = hi;
          keys[p] = lo;
        }
      }
      __syncthreads();
    }
  }
  if (t < a.sync) {
    const int64_t v = int64_t(keys[t] >> kPosBits);
    if (t == 0 || int64_t(keys[t - 1] >> kPosBits) != v) {  // the run's first position
      const bool is_prop = v == prop;
      uint64_t bal = ld_l2(a.balance + v);
      uint32_t seen = 0;  // set bits already added for the proposer
      if (is_prop) {
        bal += pay_total;
        prop_in_sync = 1;
      }
      for (int u = t; u < a.sync && int64_t(keys[u] >> kPosBits) == v; ++u) {
        const int k = int(keys[u] & ((1u << kPosBits) - 1));
        if (is_prop) {
          bal += qr * uint64_t(before[k] - seen);
          seen = before[k];
        }
        bal = s_bit[k] ? bal + pr : (bal >= pr ? bal - pr : 0);
      }
      if (is_prop) bal += qr * uint64_t(bits_all - seen);
      a.balance[v] = bal;
    }
  }
  __syncthreads();
  if (t == 0 && !prop_in_sync)
    a.balance[prop] = ld_l2(a.balance + prop) + pay_total + qr * uint64_t(bits_all);
}

// Most blocks of the kernel that fit on the card at once, queried once per
// device.
static int coresident_blocks() {
  static int cache[64];
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev >= 64) return 0;
  if (cache[dev] == 0) {
    int sms = 0, per_sm = 0;
    if (cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess) return 0;
    if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, block_slot_kernel, kThreads, 0) !=
        cudaSuccess)
      return 0;
    cache[dev] = sms * per_sm;
  }
  return cache[dev];
}

// State, updated in place: balance u64[n], cur and prev u8[n] (4-byte
// aligned), scal u64[3]. Scratch: u64[2n + kMaxRows], the first 2n all ones
// and the rest 0, left so. Static: base_reward, eff, wd_epoch u64[n], cred
// u8[n]; epoch, part_r, prop_r u64[1] on the device. The slot: att_idx
// i32[rows, lanes], att_bits u8[rows, lanes], att_flags, att_cur, att_pay
// u8[rows], proposer i32[1], sync_idx i32[sync], sync_bits u8[sync], dep_idx
// i32[deps], dep_amt u64[deps]. params (host): w0, w1, w2, denominator,
// max_withdrawals, sweep, max_effective_balance, with_withdrawals; params[8]
// receives the number of blocks launched.
extern "C" int block_slot_launch(void* balance, void* cur, void* prev, void* scal, void* scratch,
                                 const void* base_reward, const void* eff, const void* wd_epoch,
                                 const void* cred, const void* epoch, const void* part_r,
                                 const void* prop_r, const void* att_idx, const void* att_bits,
                                 const void* att_flags, const void* att_cur, const void* att_pay,
                                 const void* proposer, const void* sync_idx, const void* sync_bits,
                                 const void* dep_idx, const void* dep_amt, int64_t n, int64_t rows,
                                 int64_t lanes, int64_t sync, int64_t deps, int64_t* params,
                                 cudaStream_t stream) {
  SlotArgs a;
  a.balance = static_cast<uint64_t*>(balance);
  a.cur = static_cast<uint8_t*>(cur);
  a.prev = static_cast<uint8_t*>(prev);
  a.scal = static_cast<uint64_t*>(scal);
  a.first = static_cast<unsigned long long*>(scratch);
  a.row_sum = a.first + 2 * n;
  a.base_reward = static_cast<const uint64_t*>(base_reward);
  a.eff = static_cast<const uint64_t*>(eff);
  a.wd_epoch = static_cast<const uint64_t*>(wd_epoch);
  a.cred = static_cast<const uint8_t*>(cred);
  a.epoch = static_cast<const uint64_t*>(epoch);
  a.part_r = static_cast<const uint64_t*>(part_r);
  a.prop_r = static_cast<const uint64_t*>(prop_r);
  a.att_idx = static_cast<const int32_t*>(att_idx);
  a.att_bits = static_cast<const uint8_t*>(att_bits);
  a.att_flags = static_cast<const uint8_t*>(att_flags);
  a.att_cur = static_cast<const uint8_t*>(att_cur);
  a.att_pay = static_cast<const uint8_t*>(att_pay);
  a.proposer = static_cast<const int32_t*>(proposer);
  a.sync_idx = static_cast<const int32_t*>(sync_idx);
  a.sync_bits = static_cast<const uint8_t*>(sync_bits);
  a.dep_idx = static_cast<const int32_t*>(dep_idx);
  a.dep_amt = static_cast<const uint64_t*>(dep_amt);
  a.n = n;
  a.w0 = uint64_t(params[0]);
  a.w1 = uint64_t(params[1]);
  a.w2 = uint64_t(params[2]);
  a.denom = uint64_t(params[3]);
  a.max_w = uint64_t(params[4]);
  a.sweep = uint64_t(params[5]);
  a.max_eb = uint64_t(params[6]);
  a.with_wd = params[7] != 0;
  const uint64_t bound = a.sweep < uint64_t(n) ? a.sweep : uint64_t(n);
  if (n < 1 || n > 0x7FFFFFFFLL || rows < 0 || rows > kMaxRows || lanes < 0 ||
      rows * lanes > (1LL << 30) || sync < 0 || sync > kMaxSync || deps < 0 ||
      deps > (1LL << 30) || a.denom == 0 ||
      (a.with_wd && (bound < 1 || bound > uint64_t(kMaxWindow))) ||
      (reinterpret_cast<uintptr_t>(cur) & 3) || (reinterpret_cast<uintptr_t>(prev) & 3))
    return static_cast<int>(cudaErrorInvalidValue);
  a.rows = int(rows);
  a.lanes = int(lanes);
  a.sync = int(sync);
  a.deps = int(deps);
  const int fit = coresident_blocks();
  if (fit <= 0) {
    const cudaError_t err = cudaGetLastError();
    return static_cast<int>(err != cudaSuccess ? err : cudaErrorInvalidConfiguration);
  }
  const int64_t work = rows * lanes > deps ? rows * lanes : deps;
  const int64_t want = 1 + (work + kThreads - 1) / kThreads;
  const int blocks = int(want < fit ? want : fit);
  params[8] = blocks;
  void* args[] = {&a};
  const cudaError_t err = cudaLaunchCooperativeKernel((const void*)block_slot_kernel, dim3(blocks),
                                                      dim3(kThreads), args, 0, stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}
