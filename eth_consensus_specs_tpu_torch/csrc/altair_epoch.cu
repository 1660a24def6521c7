// K4: the altair+ fused accounting epoch over u64 columns.
//
// Replaces eth_consensus_specs_tpu/ops/altair_epoch.py
// altair_epoch_accounting_impl (:142) with the scalar machinery it calls
// from ops/state_columns.py (isqrt_u64 :132, justification_update :172).
// One cooperative launch over the blocks the card holds at once:
//   (a) the sweep: each warp takes a run of kRun x 32 (256) consecutive
//       validators, each lane every 32nd of them, so that every load and
//       store is coalesced; a lane loads act, exit, eff, slashed, the
//       previous epoch's flags and the current target flag of its 8,
//       keeps eff and five mask bits a validator in registers, and adds to
//       the five masked effective-balance sums (total active, previous-epoch
//       source/target/head participants, current target): warp shuffles and
//       one atomicAdd a block a sum into the per-stream scratch. u64
//       addition wraps the same in every order, so the sums are
//       deterministic. Validators past the grid's runs (more than the card
//       holds in registers) are swept one at a time and re-read in (c).
//   (b) one grid barrier. Then one thread of each block computes the
//       epoch's scalars into shared memory: justification and finalization
//       (written by block 0 alone), the leak, isqrt(total), the base reward
//       per increment, each flag's reward factor, the slashing quantum and
//       the divisors; it then arrives at a counter, and the last block to
//       arrive resets the sums and the counter, so the scratch is zero
//       between launches and the host fills nothing.
//   (c) every thread applies its run: it reads only wd, the scores, the
//       balances (and electra's MaxEB column), updates the inactivity score,
//       the balance in the spec's sequential clamped order (reward_k, then
//       penalty_k, k = source, target, head; inactivity; slashing) and the
//       effective balance with hysteresis, and writes the three outputs.
// Every divisor of (c) is the same for the whole epoch, so each division is
// a multiply-high and shifts by a 65-bit reciprocal (Granlund & Montgomery,
// "Division by Invariant Integers using Multiplication", 1994, Figure 4.1;
// as libdivide derives it), exact for every u64 dividend and every divisor
// >= 1. The constants' reciprocals come from the host; the epoch's (the
// reward's active_increments x WEIGHT_DENOMINATOR, the total's) are derived
// once a block. All arithmetic is uint64_t, wrapping exactly as the JAX
// uint64 lanes do; the products keep their wrap, only the divisions change.
// isqrt_u64, the justification update, the block sums, the division by
// invariants and the cooperative launch are shared with K9 through
// epoch_common.cuh.
// Bound on the H100: memory, about 75 bytes read or written per validator
// (83 with electra's MaxEB column).
#include <cooperative_groups.h>

#include "common.cuh"
#include "epoch_common.cuh"

namespace cg = cooperative_groups;

#ifndef K4_RUN
#define K4_RUN 8
#endif
#ifndef K4_MIN_BLOCKS  // blocks an SM must hold: 4 of 256 threads leave 64 registers a thread
#define K4_MIN_BLOCKS (32 / K4_RUN)
#endif
constexpr int kThreads = 256;
constexpr int kRun = K4_RUN;  // consecutive validators a thread keeps in registers
constexpr int kSums = 5;      // total active, prev source, prev target, prev head, cur target
static_assert(kRun == 8 || kRun == 16, "a run keeps its mask bytes four a word");

struct EpochArgs {
  // constants (AltairEpochParams), weights in flag order source, target, head
  uint64_t incr, base_reward_factor, w[3], head_flag_index, min_epochs_to_inactivity_penalty,
      inactivity_score_bias, inactivity_score_recovery_rate, proportional_slashing_multiplier,
      half_slashings_vector, hysteresis_down, hysteresis_up, max_effective_balance,
      electra_slashing, weight_denominator;
  Divisor d_incr, d_wden, d_inactivity;  // incr, WEIGHT_DENOMINATOR, bias x quotient
  int64_t n;
  // columns
  const uint64_t *eff, *bal;
  const uint8_t* slashed;
  const uint64_t *act, *exit, *wd;
  const uint8_t *prev_flags, *cur_tgt;
  const uint64_t* scores;
  const uint64_t* max_eb;  // per-validator ceiling, or null for the constant
  JustState just;
  // the five sums and the arrival counter, zero between launches
  unsigned long long* scratch;
  // outputs
  uint64_t *out_bal, *out_eff, *out_scores;
  JustOutputs out_just;
};

// The epoch's scalars, computed once a block.
struct Scalars {
  uint64_t prev, brpi, reward_mul[3], slash_epoch, slash_q;
  Divisor d_reward, d_total;
  bool in_leak, do_acc;
};

// Mask bits of a validator: active in the previous epoch, slashed, and
// participating (active, flag set, unslashed) per flag.
constexpr uint32_t kActivePrev = 1, kSlashed = 2, kPart0 = 4;

// One validator of the sweep: its mask bits; adds to the sums.
__device__ __forceinline__ uint32_t classify(uint64_t cur, uint64_t prev, uint64_t act,
                                             uint64_t ex, uint64_t e, bool slashed, uint32_t flags,
                                             bool cur_tgt, uint64_t (&s)[kSums]) {
  const bool active_cur = act <= cur && cur < ex;
  const bool active_prev = act <= prev && prev < ex;
  uint32_t bits = (active_prev ? kActivePrev : 0u) | (slashed ? kSlashed : 0u);
  if (active_cur) s[0] += e;
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const bool part = active_prev && ((flags >> k) & 1u) && !slashed;
    if (part) s[1 + k] += e;
    bits |= part ? kPart0 << k : 0u;
  }
  if (active_cur && cur_tgt && !slashed) s[4] += e;
  return bits;
}

struct Update {
  uint64_t bal, eff, score;
};

// One validator of the apply pass.
__device__ __forceinline__ Update apply_one(const EpochArgs& a, const Scalars& c, uint64_t eff,
                                            uint32_t bits, uint64_t wd, uint64_t old_score,
                                            uint64_t bal, uint64_t ceiling) {
  const bool active_prev = bits & kActivePrev, slashed = bits & kSlashed;
  const bool part1 = bits & (kPart0 << 1);
  const bool eligible = active_prev || (slashed && c.prev + 1 < wd);

  // inactivity scores (post-justification leak state)
  uint64_t score = old_score;
  if (eligible) score = part1 ? score - umin(1, score) : score + a.inactivity_score_bias;
  if (eligible && !c.in_leak) score -= umin(a.inactivity_score_recovery_rate, score);
  const uint64_t score_out = c.do_acc ? score : old_score;

  // flag rewards and penalties, applied in order with clamping
  const uint64_t eff_incr = divq(eff, a.d_incr);
  const uint64_t base_reward = eff_incr * c.brpi;
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const bool part = bits & (kPart0 << k);
    const uint64_t r_k = (c.do_acc && eligible && part && !c.in_leak)
                             ? divq(base_reward * c.reward_mul[k], c.d_reward)
                             : 0;
    const uint64_t pen_k =
        (static_cast<uint64_t>(k) != a.head_flag_index && c.do_acc && eligible && !part)
            ? divq(base_reward * a.w[k], a.d_wden)
            : 0;
    bal += r_k;
    bal -= umin(bal, pen_k);
  }
  if (c.do_acc && eligible && !part1)
    bal -= umin(bal, divq(eff * score_out, a.d_inactivity));

  // slashings sweep
  if (slashed && c.slash_epoch == wd) {
    const uint64_t pen = a.electra_slashing ? eff_incr * c.slash_q
                                            : divq(eff_incr * c.slash_q, c.d_total) * a.incr;
    bal -= umin(bal, pen);
  }

  // effective-balance hysteresis
  const bool crossed = bal + a.hysteresis_down < eff || eff + a.hysteresis_up < bal;
  const uint64_t new_eff = crossed ? umin(divq(bal, a.d_incr) * a.incr, ceiling) : eff;
  return Update{bal, new_eff, score_out};
}

// A validator past the grid's runs: read, classified and applied alone.
__device__ __forceinline__ void apply_reread(const EpochArgs& a, const Scalars& c, uint64_t cur,
                                             int64_t i) {
  uint64_t unused[kSums] = {0, 0, 0, 0, 0};
  const uint64_t e = a.eff[i];
  const uint32_t b = classify(cur, c.prev, a.act[i], a.exit[i], e, a.slashed[i], a.prev_flags[i],
                              a.cur_tgt[i], unused);
  const Update u = apply_one(a, c, e, b, a.wd[i], a.scores[i], a.bal[i],
                             a.max_eb ? a.max_eb[i] : a.max_effective_balance);
  a.out_bal[i] = u.bal;
  a.out_eff[i] = u.eff;
  a.out_scores[i] = u.score;
}

__global__ void __launch_bounds__(kThreads, K4_MIN_BLOCKS) altair_epoch_kernel(EpochArgs a) {
  cg::grid_group grid = cg::this_grid();
  __shared__ Scalars sc;
  const uint64_t cur = *a.just.cur_epoch;
  const uint64_t prev = cur > 0 ? cur - 1 : 0;
  const int64_t g = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  const int64_t threads = static_cast<int64_t>(gridDim.x) * kThreads;
  // a warp's run: kRun x 32 consecutive validators, validator j x 32 + lane
  // of it this lane's, so that every load and store of the warp is coalesced
  const int64_t base = (g - (threadIdx.x & 31)) * kRun + (threadIdx.x & 31);
  const int64_t excess = threads * kRun;  // past the runs: swept and applied one at a time

  // (a) the sweep: this thread's run in registers
  uint64_t s[kSums] = {0, 0, 0, 0, 0};
  uint64_t eff[kRun];
  uint32_t bits[kRun / 4];  // a byte a validator
#pragma unroll
  for (int j = 0; j < kRun / 4; ++j) bits[j] = 0;
#pragma unroll
  for (int j = 0; j < kRun; ++j) {
    const int64_t i = base + 32 * j;
    eff[j] = 0;
    if (i < a.n) {
      eff[j] = a.eff[i];
      bits[j / 4] |= classify(cur, prev, a.act[i], a.exit[i], eff[j], a.slashed[i],
                              a.prev_flags[i], a.cur_tgt[i], s)
                     << (8 * (j % 4));
    }
  }
#pragma unroll 1
  for (int64_t i = excess + g; i < a.n; i += threads)
    classify(cur, prev, a.act[i], a.exit[i], a.eff[i], a.slashed[i], a.prev_flags[i],
             a.cur_tgt[i], s);
  block_sums_atomic<kSums>(s, a.scratch);
  grid.sync();

  // (b) the epoch's scalars, once a block; the last block to read the sums resets them
  if (threadIdx.x == 0) {
    const uint64_t incr = a.incr;
    uint64_t sums[kSums];
#pragma unroll
    for (int k = 0; k < kSums; ++k) sums[k] = __ldcg(a.scratch + k);
    const uint64_t total = umax(sums[0], incr);
    const uint64_t out_fin_e = justification_update(a.just, a.out_just, umax(sums[2], incr),
                                                    umax(sums[4], incr), total, blockIdx.x == 0);
    sc.prev = prev;
    sc.in_leak = prev - out_fin_e > a.min_epochs_to_inactivity_penalty;
    sc.do_acc = cur > 0;
    sc.brpi = incr * a.base_reward_factor / isqrt_u64(total);
    const uint64_t active_increments = divq(total, a.d_incr);
#pragma unroll
    for (int k = 0; k < 3; ++k) sc.reward_mul[k] = a.w[k] * divq(umax(sums[1 + k], incr), a.d_incr);
    sc.d_reward = make_divisor(active_increments * a.weight_denominator);
    sc.d_total = make_divisor(total);
    sc.slash_epoch = cur + a.half_slashings_vector;
    const uint64_t adj = umin(*a.just.slashings_sum * a.proportional_slashing_multiplier, total);
    sc.slash_q = a.electra_slashing ? adj / active_increments : adj;
    __threadfence();
    if (atomicAdd(a.scratch + kSums, 1ull) == gridDim.x - 1) {
#pragma unroll
      for (int k = 0; k <= kSums; ++k) a.scratch[k] = 0;
    }
  }
  __syncthreads();
  const Scalars& c = sc;

  // (c) apply: the run from registers, then the excess re-read
#pragma unroll
  for (int j = 0; j < kRun; ++j) {
    const int64_t i = base + 32 * j;
    if (i < a.n) {
      const Update u = apply_one(a, c, eff[j], (bits[j / 4] >> (8 * (j % 4))) & 0xFF, a.wd[i],
                                 a.scores[i], a.bal[i],
                                 a.max_eb ? a.max_eb[i] : a.max_effective_balance);
      a.out_bal[i] = u.bal;
      a.out_eff[i] = u.eff;
      a.out_scores[i] = u.score;
    }
  }
#pragma unroll 1
  for (int64_t i = excess + g; i < a.n; i += threads) apply_reread(a, c, cur, i);
}

extern "C" int altair_epoch_launch(const EpochArgs* args, cudaStream_t stream) {
  return launch_coresident(altair_epoch_kernel, kThreads, args->n, int64_t{kThreads} * kRun, args,
                           stream);
}
