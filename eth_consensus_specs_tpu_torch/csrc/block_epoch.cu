// K19: one slot's block against the dense plane, in spec order.
//
// Replaces eth_consensus_specs_tpu/ops/block_epoch.py process_slot_columnar
// (:265) with _apply_withdrawals (:224), _apply_attestation (:164),
// _apply_deposits (:218) and _apply_sync (:196), the body of the slot scan
// of _block_epoch_chain_impl (:406). One launch a slot, one block of 1,024
// threads, the four phases in order with a barrier between them; the
// balance, both participation columns and the scalars (next withdrawal
// index, next withdrawal validator, the proposer numerator left after the
// last row) are updated in place. All u64 arithmetic is unsigned and wraps
// as JAX's uint64 does.
//
// 1. Withdrawals (the capella sweep): the window (start + i) % n for
//    i < bound = min(n, sweep), 16 positions a thread (16 x 1,024 = 16,384,
//    mainnet's sweep); a block-wide prefix count of the eligible positions
//    pays the first max_withdrawals (a full withdrawal leaves 0, a partial
//    one the maximum effective balance); then the pointer rules: after a
//    full payload resume after the last paid position, otherwise skip the
//    whole sweep, mod n. The window's positions are distinct (bound <= n).
// 2. Attestation rows, strictly in order (a later row may name a validator
//    an earlier one set): a row's lanes are threads; a live lane
//    (idx < n, bit, flags != 0) sets new = flags & ~part[idx] into the
//    current or previous column and adds weight(new) * base_reward[idx] to
//    a block sum (warp shuffles, then one slot per warp, double-buffered so
//    that one barrier a row suffices). Thread 0 carries the numerator and
//    at a pay row adds numerator / denominator to the proposer. Indices are
//    unique within a row (JAX's contract), so a lane's read and write of
//    part[idx] meet no other lane's.
// 3. Deposits: live lanes (idx < n) add with a 64-bit atomicAdd; duplicates
//    commute.
// 4. Sync aggregate: thread 0 walks the positions in order (indices repeat,
//    the proposer may sit in the committee, and a decrease clamps at 0 per
//    operation, so the walk is sequential), the proposer's balance held in a
//    register; the indices and bits are first staged in shared memory by
//    every thread.
//
// Bound on the H100: by bytes, about 1.3 MB a slot at 2^20 validators x 128
// rows x 512 lanes (the window's four columns, the rows, the live lanes'
// flags and base rewards, the walk), 0.4 us; this design instead keeps a
// serial chain of A row barriers and SY dependent walk steps, each a global
// memory round trip, and uses one SM of 132. A later design may take the
// first row that sets each validator's flag by atomicMin and parallelise the
// walk.
//
// The wrapper (ops/block_epoch.py block_slot) checks shapes and types; the
// chain checks every index once before its first slot (rows and deposits
// <= n, sync indices and proposers < n). Pad lanes carry idx == n and are
// never read.
#include "common.cuh"

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr int kWindowPerThread = 16;
constexpr int kMaxWindow = kThreads * kWindowPerThread;
constexpr int kMaxSync = 1024;

struct SlotArgs {
  uint64_t* balance;
  uint8_t* cur;
  uint8_t* prev;
  uint64_t* scal;  // [next_wd_index, next_wd_validator, numerator]
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
  int64_t n, rows, lanes, sync, deps;
  uint64_t w0, w1, w2, denom, max_w, sweep, max_eb;
  int with_wd;
};

__device__ void withdrawals(const SlotArgs& a, uint32_t* counts, uint32_t* last_pos) {
  const int t = threadIdx.x;
  const uint64_t n = a.n, start = a.scal[1], epoch = *a.epoch;
  const uint64_t bound = a.sweep < n ? a.sweep : n;
  const uint64_t base = uint64_t(t) * kWindowPerThread;
  uint32_t elig = 0, full = 0;
  for (int k = 0; k < kWindowPerThread; ++k) {
    const uint64_t i = base + k;
    if (i >= bound) break;
    const uint64_t v = (start + i) % n;
    const uint64_t bal = a.balance[v];
    const bool cred = a.cred[v] != 0;
    const bool f = cred && a.wd_epoch[v] <= epoch && bal > 0;
    const bool p = cred && a.eff[v] == a.max_eb && bal > a.max_eb;
    elig |= uint32_t(f || p) << k;
    full |= uint32_t(f) << k;
  }
  counts[t] = __popc(elig);
  if (t == 0) *last_pos = 0;
  __syncthreads();
  for (int off = 1; off < kThreads; off <<= 1) {  // inclusive prefix count
    const uint32_t add = t >= off ? counts[t - off] : 0;
    __syncthreads();
    counts[t] += add;
    __syncthreads();
  }
  const uint32_t total = counts[kThreads - 1];
  uint32_t rank = counts[t] - __popc(elig);
  for (int k = 0; k < kWindowPerThread; ++k) {
    if (!((elig >> k) & 1u)) continue;
    if (uint64_t(++rank) > a.max_w) break;
    a.balance[(start + base + k) % n] = ((full >> k) & 1u) ? 0 : a.max_eb;
    atomicMax(last_pos, uint32_t(base + k));
  }
  __syncthreads();
  if (t == 0) {
    const uint64_t taken = total < a.max_w ? total : a.max_w;
    a.scal[0] += taken;
    a.scal[1] = taken == a.max_w ? (start + *last_pos + 1) % n : (start + a.sweep) % n;
  }
}

__global__ void __launch_bounds__(kThreads, 1) block_slot_kernel(const SlotArgs a) {
  __shared__ uint32_t counts[kThreads];
  __shared__ uint32_t last_pos;
  __shared__ unsigned long long red[2][kWarps];
  __shared__ int32_t s_idx[kMaxSync];
  __shared__ uint8_t s_bit[kMaxSync];
  const int t = threadIdx.x;
  const int64_t n = a.n;

  if (a.with_wd) withdrawals(a, counts, &last_pos);
  __syncthreads();

  const int64_t prop = a.proposer[0];
  unsigned long long num = 0;  // thread 0's
  for (int64_t r = 0; r < a.rows; ++r) {
    const uint8_t flags = a.att_flags[r];
    uint8_t* part = a.att_cur[r] ? a.cur : a.prev;
    unsigned long long sum = 0;
    if (flags != 0) {
      for (int64_t c = t; c < a.lanes; c += kThreads) {
        const int64_t off = r * a.lanes + c;
        const int64_t idx = a.att_idx[off];
        if (idx >= n || !a.att_bits[off]) continue;
        const uint8_t pre = part[idx];
        const uint8_t nb = flags & uint8_t(~pre);
        if (nb == 0) continue;
        part[idx] = pre | nb;
        const uint64_t w = ((nb & 1) ? a.w0 : 0) + ((nb & 2) ? a.w1 : 0) + ((nb & 4) ? a.w2 : 0);
        sum += w * a.base_reward[idx];
      }
    }
    for (int off = 16; off > 0; off >>= 1) sum += __shfl_down_sync(0xffffffffu, sum, off);
    if ((t & 31) == 0) red[r & 1][t >> 5] = sum;
    __syncthreads();
    if (t == 0) {
      for (int w = 0; w < kWarps; ++w) num += red[r & 1][w];
      if (a.att_pay[r]) {
        a.balance[prop] += num / a.denom;
        num = 0;
      }
    }
  }
  if (t == 0) a.scal[2] = num;
  for (int64_t k = t; k < a.sync; k += kThreads) {
    s_idx[k] = a.sync_idx[k];
    s_bit[k] = a.sync_bits[k];
  }
  __syncthreads();

  for (int64_t d = t; d < a.deps; d += kThreads) {
    const int64_t idx = a.dep_idx[d];
    if (idx < n)
      atomicAdd(reinterpret_cast<unsigned long long*>(a.balance + idx),
                static_cast<unsigned long long>(a.dep_amt[d]));
  }
  __syncthreads();

  if (t == 0) {
    const uint64_t pr = *a.part_r, qr = *a.prop_r;
    uint64_t pbal = a.balance[prop];
    for (int64_t k = 0; k < a.sync; ++k) {
      const int64_t i = s_idx[k];
      const bool bit = s_bit[k] != 0;
      const uint64_t cur = i == prop ? pbal : a.balance[i];
      const uint64_t nv = bit ? cur + pr : (cur >= pr ? cur - pr : 0);
      if (i == prop)
        pbal = nv;
      else
        a.balance[i] = nv;
      if (bit) pbal += qr;
    }
    a.balance[prop] = pbal;
  }
}

// State, updated in place: balance u64[n], cur and prev u8[n], scal u64[3].
// Static: base_reward, eff, wd_epoch u64[n], cred u8[n]; epoch, part_r,
// prop_r u64[1] on the device. The slot: att_idx i32[rows, lanes], att_bits
// u8[rows, lanes], att_flags, att_cur, att_pay u8[rows], proposer i32[1],
// sync_idx i32[sync], sync_bits u8[sync], dep_idx i32[deps], dep_amt
// u64[deps]. params (host): w0, w1, w2, denominator, max_withdrawals, sweep,
// max_effective_balance, with_withdrawals.
extern "C" int block_slot_launch(void* balance, void* cur, void* prev, void* scal,
                                 const void* base_reward, const void* eff, const void* wd_epoch,
                                 const void* cred, const void* epoch, const void* part_r,
                                 const void* prop_r, const void* att_idx, const void* att_bits,
                                 const void* att_flags, const void* att_cur, const void* att_pay,
                                 const void* proposer, const void* sync_idx, const void* sync_bits,
                                 const void* dep_idx, const void* dep_amt, int64_t n, int64_t rows,
                                 int64_t lanes, int64_t sync, int64_t deps, const int64_t* params,
                                 cudaStream_t stream) {
  SlotArgs a;
  a.balance = static_cast<uint64_t*>(balance);
  a.cur = static_cast<uint8_t*>(cur);
  a.prev = static_cast<uint8_t*>(prev);
  a.scal = static_cast<uint64_t*>(scal);
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
  a.rows = rows;
  a.lanes = lanes;
  a.sync = sync;
  a.deps = deps;
  a.w0 = uint64_t(params[0]);
  a.w1 = uint64_t(params[1]);
  a.w2 = uint64_t(params[2]);
  a.denom = uint64_t(params[3]);
  a.max_w = uint64_t(params[4]);
  a.sweep = uint64_t(params[5]);
  a.max_eb = uint64_t(params[6]);
  a.with_wd = params[7] != 0;
  const uint64_t bound = a.sweep < uint64_t(n) ? a.sweep : uint64_t(n);
  if (n < 1 || rows < 0 || lanes < 0 || sync < 0 || sync > kMaxSync || deps < 0 ||
      a.denom == 0 || (a.with_wd && (bound < 1 || bound > uint64_t(kMaxWindow))))
    return static_cast<int>(cudaErrorInvalidValue);
  block_slot_kernel<<<1, kThreads, 0, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}
