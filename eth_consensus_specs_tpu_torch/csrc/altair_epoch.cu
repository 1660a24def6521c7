// K4: the altair+ fused accounting epoch over u64 columns.
//
// Replaces eth_consensus_specs_tpu/ops/altair_epoch.py
// altair_epoch_accounting_impl (:142) with the scalar machinery it calls
// from ops/state_columns.py (isqrt_u64 :132, justification_update :172).
// Two launches, no host round trip:
//   (a) epoch_sums: five masked effective-balance sums (total active,
//       previous-epoch source/target/head participants, current target)
//       as a grid-stride sweep, warp shuffles and one atomicAdd per block
//       and sum into a zeroed 5-word buffer. u64 addition wraps the same
//       in every order, so the sums are deterministic.
//   (b) epoch_apply: one thread per validator. Each thread recomputes the
//       cheap scalar work from the sums (justification and finalization,
//       isqrt, base reward per increment, the leak, the slashing quantum),
//       then updates its inactivity score, its balance in the spec's
//       sequential clamped order (reward_k, then penalty_k, k = source,
//       target, head; inactivity; slashing) and its effective balance with
//       hysteresis. Thread 0 writes the justification outputs.
// All arithmetic is uint64_t, wrapping exactly as the JAX uint64 lanes do.
// isqrt_u64, the justification update and the block sums are shared with
// K9 through epoch_common.cuh.
// Bound on the H100: memory, about 83 bytes read or written per validator.
#include "common.cuh"
#include "epoch_common.cuh"

struct EpochArgs {
  // constants (AltairEpochParams), weights in flag order source, target, head
  uint64_t incr, base_reward_factor, w[3], weight_denominator, head_flag_index,
      min_epochs_to_inactivity_penalty, inactivity_score_bias,
      inactivity_score_recovery_rate, inactivity_penalty_quotient,
      proportional_slashing_multiplier, epochs_per_slashings_vector, hysteresis_quotient,
      hysteresis_downward_multiplier, hysteresis_upward_multiplier, max_effective_balance,
      electra_slashing;
  int64_t n;
  // columns
  const uint64_t *eff, *bal;
  const uint8_t* slashed;
  const uint64_t *act, *exit, *wd;
  const uint8_t *prev_flags, *cur_tgt;
  const uint64_t* scores;
  const uint64_t* max_eb;  // per-validator ceiling, or null for the constant
  JustState just;
  // the five sums of launch (a), zeroed by the caller
  unsigned long long* sums;
  // outputs
  uint64_t *out_bal, *out_eff, *out_scores;
  JustOutputs out_just;
};

constexpr int kSums = 5;  // total active, prev source, prev target, prev head, cur target

__global__ void epoch_sums_kernel(EpochArgs a) {
  const uint64_t cur = *a.just.cur_epoch;
  const uint64_t prev = cur > 0 ? cur - 1 : 0;
  uint64_t s[kSums] = {0, 0, 0, 0, 0};
  for (int64_t i = blockIdx.x * (int64_t)blockDim.x + threadIdx.x; i < a.n;
       i += (int64_t)gridDim.x * blockDim.x) {
    const uint64_t act = a.act[i], ex = a.exit[i], e = a.eff[i];
    const bool unslashed = !a.slashed[i];
    const bool active_cur = act <= cur && cur < ex;
    const bool active_prev = act <= prev && prev < ex;
    const unsigned flags = a.prev_flags[i];
    if (active_cur) s[0] += e;
#pragma unroll
    for (int k = 0; k < 3; ++k)
      if (active_prev && ((flags >> k) & 1u) && unslashed) s[1 + k] += e;
    if (active_cur && a.cur_tgt[i] && unslashed) s[4] += e;
  }
  block_sums_atomic<kSums>(s, a.sums);
}

__global__ void epoch_apply_kernel(EpochArgs a) {
  const int64_t i = blockIdx.x * (int64_t)blockDim.x + threadIdx.x;
  if (i >= a.n) return;
  const uint64_t incr = a.incr;
  const uint64_t cur = *a.just.cur_epoch;
  const uint64_t prev = cur > 0 ? cur - 1 : 0;
  const uint64_t total = umax(a.sums[0], incr);
  uint64_t part_bal[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) part_bal[k] = umax(a.sums[1 + k], incr);
  const uint64_t cur_tgt_bal = umax(a.sums[4], incr);

  // -- justification and finalization (weigh_justification_and_finalization)
  const uint64_t out_fin_e =
      justification_update(a.just, a.out_just, part_bal[1], cur_tgt_bal, total, i == 0);
  const bool in_leak = prev - out_fin_e > a.min_epochs_to_inactivity_penalty;
  const bool do_acc = cur > 0;

  // -- this validator
  const uint64_t eff = a.eff[i], act = a.act[i], ex = a.exit[i], wd = a.wd[i];
  const bool slashed = a.slashed[i];
  const bool active_prev = act <= prev && prev < ex;
  const bool eligible = active_prev || (slashed && prev + 1 < wd);
  const unsigned flags = a.prev_flags[i];
  bool part[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) part[k] = active_prev && ((flags >> k) & 1u) && !slashed;

  // inactivity scores (post-justification leak state)
  const uint64_t old_score = a.scores[i];
  uint64_t score = old_score;
  if (eligible) score = part[1] ? score - umin(1, score) : score + a.inactivity_score_bias;
  if (eligible && !in_leak) score -= umin(a.inactivity_score_recovery_rate, score);
  const uint64_t score_out = do_acc ? score : old_score;
  a.out_scores[i] = score_out;

  // flag rewards and penalties, applied in order with clamping
  const uint64_t brpi = incr * a.base_reward_factor / isqrt_u64(total);
  const uint64_t base_reward = (eff / incr) * brpi;
  const uint64_t active_increments = total / incr;
  const uint64_t wden = a.weight_denominator;
  uint64_t bal = a.bal[i];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const uint64_t weight = a.w[k];
    const uint64_t reward =
        base_reward * weight * (part_bal[k] / incr) / (active_increments * wden);
    const uint64_t r_k = (do_acc && eligible && part[k] && !in_leak) ? reward : 0;
    const uint64_t pen_k = (static_cast<uint64_t>(k) != a.head_flag_index && do_acc &&
                            eligible && !part[k])
                               ? base_reward * weight / wden
                               : 0;
    bal += r_k;
    bal -= umin(bal, pen_k);
  }
  const uint64_t pen_inact =
      eff * score_out / (a.inactivity_score_bias * a.inactivity_penalty_quotient);
  bal -= umin(bal, (do_acc && eligible && !part[1]) ? pen_inact : 0);

  // slashings sweep
  const uint64_t adj = umin(*a.just.slashings_sum * a.proportional_slashing_multiplier, total);
  const bool slash_now = slashed && cur + a.epochs_per_slashings_vector / 2 == wd;
  const uint64_t slash_penalty = a.electra_slashing
                                     ? adj / (total / incr) * (eff / incr)
                                     : (eff / incr) * adj / total * incr;
  bal -= umin(bal, slash_now ? slash_penalty : 0);
  a.out_bal[i] = bal;

  // effective-balance hysteresis
  const uint64_t hyst = incr / a.hysteresis_quotient;
  const uint64_t down = hyst * a.hysteresis_downward_multiplier;
  const uint64_t up = hyst * a.hysteresis_upward_multiplier;
  const bool crossed = bal + down < eff || eff + up < bal;
  const uint64_t ceiling = a.max_eb ? a.max_eb[i] : a.max_effective_balance;
  a.out_eff[i] = crossed ? umin(bal - bal % incr, ceiling) : eff;
}

extern "C" int epoch_sums_launch(const EpochArgs* args, cudaStream_t stream) {
  const int threads = 256;
  int64_t blocks = (args->n + threads - 1) / threads;
  if (blocks > 132 * 8) blocks = 132 * 8;
  if (blocks > 0) epoch_sums_kernel<<<(unsigned)blocks, threads, 0, stream>>>(*args);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int epoch_apply_launch(const EpochArgs* args, cudaStream_t stream) {
  const int threads = 256;
  const int64_t blocks = (args->n + threads - 1) / threads;
  if (blocks > 0) epoch_apply_kernel<<<(unsigned)blocks, threads, 0, stream>>>(*args);
  return static_cast<int>(cudaGetLastError());
}
