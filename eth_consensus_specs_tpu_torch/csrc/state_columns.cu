// K9: the phase0 fused accounting epoch over u64 columns.
//
// Replaces eth_consensus_specs_tpu/ops/state_columns.py
// epoch_accounting_impl (:232): justification and finalization, the
// attestation rewards and penalties (source, target, head, the inclusion
// delay micro-rewards, the inactivity leak), the slashings sweep and
// effective-balance hysteresis. One cooperative launch over the blocks the
// card holds at once, K4's design (altair_epoch.cu) with a second grid
// barrier behind the proposer scatter:
//   (a) the sweep: each warp takes a run of kRun x 32 (256) consecutive
//       validators, each lane every 32nd of them, so that every load and
//       store is coalesced; a lane loads eff, slashed, act, exit and the
//       four attestation masks of its 8, keeps eff and one byte of mask
//       bits a validator in registers (unslashed source, target and head
//       attester; active in the previous epoch; slashed), zeroes their
//       reward slots, and adds to the five masked effective-balance sums
//       (total active; the unslashed source, target and head attesters of
//       the previous epoch; the unslashed current-epoch target attesters):
//       warp shuffles and one atomicAdd a block a sum into the per-stream
//       scratch. The JAX kernel sums six: its previous-target balance for
//       justification and its target attesting balance are the same mask,
//       summed here once. Validators past the grid's runs (more than the
//       card holds in registers) are swept one at a time and re-read later.
//   (b) a grid barrier. Then the epoch's scalars, once a block, by the
//       first lanes of four warps side by side: justification and
//       finalization (written by block 0 alone), the leak and the finality
//       delay, each flag's reward factor att_bal / incr, the slashing
//       quantum; the reciprocals of isqrt(total) x BASE_REWARDS_PER_EPOCH,
//       total / incr and total. The block's last two warps meanwhile fill a
//       table of the reciprocals of the inclusion delays 1..kDelays.
//   (c) the credit pass: for each validator of the run its base reward;
//       an unslashed source attester's proposer reward (base reward /
//       PROPOSER_REWARD_QUOTIENT) is atomically added to the reward slot of
//       validator incl_proposer[i] (clipped to [0, n-1]; u64 atomics
//       commute, so the result is deterministic); then its own rewards and
//       its penalties, kept in shared memory, the penalties written. The
//       atomics drain into L2 while the lane computes: the scatter costs
//       the issuing of its atomics, not their round trips.
//   (d) a second grid barrier: every atomic has landed and every block has
//       read the sums, so block 0 zeroes the sums (the scratch is zero
//       between launches; the host fills nothing). The settle pass: each
//       validator's reward slot joins its own rewards; the balance, the
//       slashings sweep and the effective balance are written.
// The excess validators take the same passes one at a time, re-read, their
// own rewards parked in their balance slot across the barrier. The passes
// load a validator's columns one validator ahead of the one they compute,
// read-only (ld.global.nc: nothing writes the inputs during the launch).
// Every divisor but the inclusion delay is the same for the whole epoch, so
// each such division is a multiply-high and shifts (divq, epoch_common.cuh):
// the constants' reciprocals come from the host, the epoch's are derived
// once a block. The delay varies per validator: a delay in [1, kDelays] (a
// valid chain's lie in [1, SLOTS_PER_EPOCH]) divides by the block's table,
// a larger one by the exact u64 division. All arithmetic is uint64_t:
// unsigned additions and atomicAdds wrap the same in every order and the
// products keep their wrap, so the result is bit-exact with the JAX uint64
// lanes. Epoch compares are unsigned (FAR_FUTURE_EPOCH = 2^64 - 1 sits in
// the exit and withdrawable columns). Genesis guards: no rewards or
// penalties at epoch 0, no justification at epochs 0 and 1.
// Bound on the H100: memory, 61 bytes read and 32 written a validator; the
// scatter's random 8-byte atomics and the reward slots' zeroing and
// re-read go to L2.
#include <cooperative_groups.h>

#include "common.cuh"
#include "epoch_common.cuh"

namespace cg = cooperative_groups;

#ifndef K9_RUN
#define K9_RUN 8
#endif
#ifndef K9_MIN_BLOCKS  // blocks an SM must hold: 4 of 256 threads leave 64 registers a thread
#define K9_MIN_BLOCKS (32 / K9_RUN)
#endif
constexpr int kThreads = 256;
constexpr int kRun = K9_RUN;  // consecutive validators a thread keeps in registers
constexpr int kSums = 5;      // total active, source, target, head, current target
constexpr int kDelays = 64;   // inclusion delays divided by the block's table of reciprocals
static_assert(kRun % 4 == 0, "a run keeps its mask bytes four a word");
static_assert(kDelays <= kThreads - 128, "the table fills warps the scalar step leaves free");

struct Phase0Args {
  // constants (EpochParams; BASE_REWARDS_PER_EPOCH below 2^32), with the
  // reciprocals of incr, PROPOSER_REWARD_QUOTIENT and
  // INACTIVITY_PENALTY_QUOTIENT
  uint64_t incr, base_reward_factor, base_rewards_per_epoch, min_epochs_to_inactivity_penalty,
      proportional_slashing_multiplier, half_slashings_vector, hysteresis_down, hysteresis_up,
      max_effective_balance;
  Divisor d_incr, d_prq, d_ipq;
  int64_t n;
  // columns (EpochColumns)
  const uint64_t *eff, *bal;
  const uint8_t* slashed;
  const uint64_t *act, *exit, *wd;
  const uint8_t *src, *tgt, *head, *cur_tgt;
  const uint64_t* incl_delay;
  const int64_t* incl_proposer;
  JustState just;
  // the five sums, zero between launches
  unsigned long long* scratch;
  // outputs (EpochResult)
  uint64_t *out_bal, *out_eff;
  JustOutputs out_just;
  unsigned long long* out_rewards;
  uint64_t* out_penalties;
};

// The epoch's scalars, computed once a block.
struct Scalars {
  uint64_t prev, finality_delay, factor[3], slash_epoch, adj;
  Divisor d_br, d_units, d_total;  // isqrt(total) x BASE_REWARDS_PER_EPOCH, total / incr, total
  bool in_leak, do_acc;
};

// Mask bits of a validator: unslashed source, target and head attester
// (kAtt0 << k); active in the previous epoch; slashed; taken by this
// epoch's slashings sweep (set by the credit pass).
constexpr uint32_t kAtt0 = 1, kActivePrev = 8, kSlashed = 16, kSlashNow = 32;

__device__ __forceinline__ uint64_t ldu(const uint64_t* p) {
  return __ldg(reinterpret_cast<const unsigned long long*>(p));
}
__device__ __forceinline__ int64_t ldi(const int64_t* p) {
  return __ldg(reinterpret_cast<const long long*>(p));
}

// A validator's columns of the sweep.
struct SweepIn {
  uint64_t eff, act, exit;
  uint8_t slashed, src, tgt, head, cur_tgt;
};

__device__ __forceinline__ SweepIn load_sweep(const Phase0Args& a, int64_t i) {
  return SweepIn{ldu(a.eff + i), ldu(a.act + i), ldu(a.exit + i), __ldg(a.slashed + i),
                 __ldg(a.src + i), __ldg(a.tgt + i), __ldg(a.head + i), __ldg(a.cur_tgt + i)};
}

// One validator of the sweep: its mask bits; adds to the sums.
__device__ __forceinline__ uint32_t classify(const SweepIn& v, uint64_t cur, uint64_t prev,
                                             uint64_t (&s)[kSums]) {
  const bool slashed = v.slashed;
  const bool att[3] = {v.src && !slashed, v.tgt && !slashed, v.head && !slashed};
  if (v.act <= cur && cur < v.exit) s[0] += v.eff;
  uint32_t bits =
      (v.act <= prev && prev < v.exit ? kActivePrev : 0u) | (slashed ? kSlashed : 0u);
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    if (att[k]) s[1 + k] += v.eff;
    bits |= att[k] ? kAtt0 << k : 0u;
  }
  if (v.cur_tgt && !slashed) s[4] += v.eff;
  return bits;
}

// A validator's columns of the credit pass.
struct CreditIn {
  uint64_t wd, delay;
  int64_t includer;
};

__device__ __forceinline__ CreditIn load_credit(const Phase0Args& a, int64_t i) {
  return CreditIn{ldu(a.wd + i), ldu(a.incl_delay + i), ldi(a.incl_proposer + i)};
}

// eff * BASE_REWARD_FACTOR // isqrt(total) // BASE_REWARDS_PER_EPOCH, in one
// division: floor(floor(x / a) / b) = floor(x / (a b)) for positive a and b
__device__ __forceinline__ uint64_t base_reward(const Phase0Args& a, const Scalars& c,
                                                uint64_t eff) {
  return divq(eff * a.base_reward_factor, c.d_br);
}

// x // max(delay, 1), exact for every u64 delay: by the block's table up to
// kDelays, by the u64 division past it.
__device__ __forceinline__ uint64_t div_delay(uint64_t x, uint64_t delay, const Divisor* delays) {
  const uint64_t d = delay > 1 ? delay : 1;
  return d <= kDelays ? divq(x, delays[d - 1]) : x / d;
}

// What the credit pass leaves of a validator: its rewards but the proposer
// micro-rewards scattered to it, its penalties, its mask bits with kSlashNow.
struct Credit {
  uint64_t rewards, penalties;
  uint32_t bits;
};

// One validator of the credit pass; scatters its proposer reward.
__device__ __forceinline__ Credit credit_one(const Phase0Args& a, const Scalars& c,
                                             const Divisor* delays, uint64_t eff, uint32_t bits,
                                             const CreditIn& v) {
  const bool slashed = bits & kSlashed;
  const bool eligible = (bits & kActivePrev) || (slashed && c.prev + 1 < v.wd);
  Credit out{0, 0, bits | (slashed && c.slash_epoch == v.wd ? kSlashNow : 0u)};
  if (!c.do_acc) return out;
  const uint64_t br = base_reward(a, c, eff);
  const uint64_t proposer_reward = divq(br, a.d_prq);
  if (bits & kAtt0) {
    const int64_t p = v.includer < 0 ? 0 : (v.includer > a.n - 1 ? a.n - 1 : v.includer);
    atomicAdd(a.out_rewards + p, static_cast<unsigned long long>(proposer_reward));
    out.rewards = div_delay(br - proposer_reward, v.delay, delays);
  }
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const bool att = bits & (kAtt0 << k);
    // during a leak attesters are credited as if participation were optimal
    if (eligible && att) out.rewards += c.in_leak ? br : divq(br * c.factor[k], c.d_units);
    if (eligible && !att) out.penalties += br;
  }
  if (eligible && c.in_leak) {
    out.penalties += a.base_rewards_per_epoch * br - proposer_reward;
    if (!(bits & (kAtt0 << 1))) out.penalties += divq(eff * c.finality_delay, a.d_ipq);
  }
  return out;
}

// One validator of the settle pass: its reward slot (the proposer
// micro-rewards scattered to it) joins its own rewards; the balance, the
// slashings sweep (every epoch, no genesis guard) and the effective-balance
// hysteresis.
__device__ __forceinline__ void settle_one(const Phase0Args& a, const Scalars& c, int64_t i,
                                           uint64_t eff, bool slash_now, uint64_t own,
                                           uint64_t penalties, uint64_t slot, uint64_t bal) {
  const uint64_t rewards = own + slot;
  a.out_rewards[i] = rewards;
  bal += rewards;
  bal -= umin(bal, penalties);
  if (slash_now) bal -= umin(bal, divq(divq(eff, a.d_incr) * c.adj, c.d_total) * a.incr);
  a.out_bal[i] = bal;
  const bool crossed = bal + a.hysteresis_down < eff || eff + a.hysteresis_up < bal;
  a.out_eff[i] = crossed ? umin(divq(bal, a.d_incr) * a.incr, a.max_effective_balance) : eff;
}

__global__ void __launch_bounds__(kThreads, K9_MIN_BLOCKS) phase0_epoch_kernel(Phase0Args a) {
  cg::grid_group grid = cg::this_grid();
  __shared__ Scalars sc;
  __shared__ Divisor delays[kDelays];
  __shared__ uint64_t own[kRun][kThreads], pens[kRun][kThreads];  // across the second barrier
  const uint64_t cur = *a.just.cur_epoch;
  const uint64_t prev = cur > 0 ? cur - 1 : 0;
  const int t = threadIdx.x;
  const int64_t g = static_cast<int64_t>(blockIdx.x) * kThreads + t;
  const int64_t threads = static_cast<int64_t>(gridDim.x) * kThreads;
  // a warp's run: kRun x 32 consecutive validators, validator j x 32 + lane
  // of it this lane's, so that every load and store of the warp is coalesced
  const int64_t base = (g - (t & 31)) * kRun + (t & 31);
  const int64_t excess = threads * kRun;  // past the runs: one at a time, re-read

  // (a) the sweep: this thread's run in registers, its reward slots zeroed
  uint64_t s[kSums] = {0, 0, 0, 0, 0};
  uint64_t eff[kRun];
  uint32_t bits[kRun / 4];  // a byte a validator
#pragma unroll
  for (int j = 0; j < kRun / 4; ++j) bits[j] = 0;
  SweepIn sweep_next = base < a.n ? load_sweep(a, base) : SweepIn{};
#pragma unroll
  for (int j = 0; j < kRun; ++j) {
    const int64_t i = base + 32 * j;
    const SweepIn v = sweep_next;
    if (j + 1 < kRun && i + 32 < a.n) sweep_next = load_sweep(a, i + 32);
    eff[j] = 0;
    if (i < a.n) {
      eff[j] = v.eff;
      bits[j / 4] |= classify(v, cur, prev, s) << (8 * (j % 4));
      a.out_rewards[i] = 0;
    }
  }
#pragma unroll 1
  for (int64_t i = excess + g; i < a.n; i += threads) {
    classify(load_sweep(a, i), cur, prev, s);
    a.out_rewards[i] = 0;
  }
  block_sums_atomic<kSums>(s, a.scratch);
  grid.sync();

  // (b) the epoch's scalars, once a block, on the first lanes of warps 0-3;
  // the delay table on the last warps
  if (t < 128 && (t & 31) == 0) {
    const uint64_t incr = a.incr;
    uint64_t sums[kSums];
#pragma unroll
    for (int k = 0; k < kSums; ++k) sums[k] = __ldcg(a.scratch + k);
    const uint64_t total = umax(sums[0], incr);
    if (t == 0) {
      const uint64_t fin_e = justification_update(a.just, a.out_just, umax(sums[2], incr),
                                                  umax(sums[4], incr), total, blockIdx.x == 0);
      sc.prev = prev;
      sc.finality_delay = prev - fin_e;
      sc.in_leak = sc.finality_delay > a.min_epochs_to_inactivity_penalty;
      sc.do_acc = cur > 0;
#pragma unroll
      for (int k = 0; k < 3; ++k) sc.factor[k] = divq(umax(sums[1 + k], incr), a.d_incr);
      sc.slash_epoch = cur + a.half_slashings_vector;
      sc.adj = umin(*a.just.slashings_sum * a.proportional_slashing_multiplier, total);
    } else if (t == 32) {
      sc.d_br = make_divisor(isqrt_u64(total) * a.base_rewards_per_epoch);  // below 2^64
    } else if (t == 64) {
      sc.d_units = make_divisor(divq(total, a.d_incr));
    } else {
      sc.d_total = make_divisor(total);
    }
  } else if (t >= kThreads - kDelays) {
    delays[t - (kThreads - kDelays)] = make_divisor(t - (kThreads - kDelays) + 1);
  }
  __syncthreads();
  const Scalars& c = sc;

  // (c) the credit pass with the proposer scatter: the run, then the excess
  // re-read, its own rewards parked in its balance slot
  CreditIn credit_next = base < a.n ? load_credit(a, base) : CreditIn{};
#pragma unroll
  for (int j = 0; j < kRun; ++j) {
    const int64_t i = base + 32 * j;
    const CreditIn v = credit_next;
    if (j + 1 < kRun && i + 32 < a.n) credit_next = load_credit(a, i + 32);
    if (i < a.n) {
      const Credit cr =
          credit_one(a, c, delays, eff[j], (bits[j / 4] >> (8 * (j % 4))) & 0xFF, v);
      own[j][t] = cr.rewards;
      pens[j][t] = cr.penalties;
      a.out_penalties[i] = cr.penalties;
      bits[j / 4] |= cr.bits << (8 * (j % 4));
    }
  }
#pragma unroll 1
  for (int64_t i = excess + g; i < a.n; i += threads) {
    uint64_t unused[kSums] = {0, 0, 0, 0, 0};
    const SweepIn v = load_sweep(a, i);
    const Credit cr = credit_one(a, c, delays, v.eff, classify(v, cur, prev, unused),
                                 load_credit(a, i));
    a.out_penalties[i] = cr.penalties;
    a.out_bal[i] = cr.rewards;
  }
  grid.sync();
  if (blockIdx.x == 0 && t < kSums) a.scratch[t] = 0;  // every block has read them

  // (d) the settle pass: the run, then the excess re-read
  uint64_t slot_next = base < a.n ? __ldcg(a.out_rewards + base) : 0;
  uint64_t bal_next = base < a.n ? ldu(a.bal + base) : 0;
#pragma unroll
  for (int j = 0; j < kRun; ++j) {
    const int64_t i = base + 32 * j;
    const uint64_t slot = slot_next, bal = bal_next;
    if (j + 1 < kRun && i + 32 < a.n) {
      slot_next = __ldcg(a.out_rewards + i + 32);
      bal_next = ldu(a.bal + i + 32);
    }
    if (i < a.n)
      settle_one(a, c, i, eff[j], (bits[j / 4] >> (8 * (j % 4))) & kSlashNow, own[j][t],
                 pens[j][t], slot, bal);
  }
#pragma unroll 1
  for (int64_t i = excess + g; i < a.n; i += threads) {
    const bool slash_now = __ldg(a.slashed + i) && c.slash_epoch == ldu(a.wd + i);
    settle_one(a, c, i, ldu(a.eff + i), slash_now, __ldcg(a.out_bal + i),
               __ldcg(a.out_penalties + i), __ldcg(a.out_rewards + i), ldu(a.bal + i));
  }
}

extern "C" int phase0_epoch_launch(const Phase0Args* args, cudaStream_t stream) {
  return launch_coresident(phase0_epoch_kernel, kThreads, args->n, int64_t{kThreads} * kRun, args,
                           stream);
}
