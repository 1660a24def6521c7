// K9: the phase0 fused accounting epoch over u64 columns.
//
// Replaces eth_consensus_specs_tpu/ops/state_columns.py
// epoch_accounting_impl (:232): justification and finalization, the
// attestation rewards and penalties (source, target, head, the inclusion
// delay micro-rewards, the inactivity leak), the slashings sweep and
// effective-balance hysteresis. K4's design (altair_epoch.cu), in three
// launches with no host round trip:
//   (a) phase0_sums: five masked effective-balance sums (total active; the
//       unslashed source, target and head attesters of the previous epoch;
//       the unslashed current-epoch target attesters) with one atomicAdd
//       per block and sum. The JAX kernel sums six: its previous-target
//       balance for justification and its target attesting balance are the
//       same mask, summed here once.
//   (b) phase0_proposer: the proposer micro-rewards, a scatter-add of each
//       unslashed source attester's proposer reward into the reward of
//       validator incl_proposer[i] (clipped to [0, n-1]), as atomicAdds into
//       the zeroed rewards column. It must be complete before any final
//       balance is formed, which the launch boundary guarantees.
//   (c) phase0_apply: one thread per validator recomputes the scalar work
//       from the sums (justification, whose finalized epoch the leak test
//       reads; isqrt of the total), adds its own rewards to what (b) left in
//       its reward lane and writes rewards, penalties, the balance and the
//       effective balance. Thread 0 writes the justification outputs.
// All arithmetic is uint64_t: unsigned additions and atomicAdds wrap the
// same in every order, so the result is bit-exact with the JAX uint64
// lanes. Epoch compares are unsigned (FAR_FUTURE_EPOCH = 2^64 - 1 sits in
// the exit and withdrawable columns). Genesis guards: no rewards or
// penalties at epoch 0, no justification at epochs 0 and 1.
// Bound on the H100: memory, about 69 bytes read and 32 written per
// validator, the 1-byte masks and the scatter's random 8-byte atomics in L2.
#include "common.cuh"
#include "epoch_common.cuh"

struct Phase0Args {
  // constants (EpochParams)
  uint64_t incr, base_reward_factor, base_rewards_per_epoch, proposer_reward_quotient,
      min_epochs_to_inactivity_penalty, inactivity_penalty_quotient,
      proportional_slashing_multiplier, epochs_per_slashings_vector, hysteresis_quotient,
      hysteresis_downward_multiplier, hysteresis_upward_multiplier, max_effective_balance;
  int64_t n;
  // columns (EpochColumns)
  const uint64_t *eff, *bal;
  const uint8_t* slashed;
  const uint64_t *act, *exit, *wd;
  const uint8_t *src, *tgt, *head, *cur_tgt;
  const uint64_t* incl_delay;
  const int64_t* incl_proposer;
  JustState just;
  // the five sums of launch (a), zeroed by the caller
  unsigned long long* sums;
  // outputs (EpochResult); rewards zeroed by the caller
  uint64_t *out_bal, *out_eff;
  JustOutputs out_just;
  unsigned long long* out_rewards;
  uint64_t* out_penalties;
};

constexpr int kSums = 5;  // total active, source, target, head, current target

__global__ void phase0_sums_kernel(Phase0Args a) {
  const uint64_t cur = *a.just.cur_epoch;
  uint64_t s[kSums] = {0, 0, 0, 0, 0};
  for (int64_t i = blockIdx.x * (int64_t)blockDim.x + threadIdx.x; i < a.n;
       i += (int64_t)gridDim.x * blockDim.x) {
    const uint64_t e = a.eff[i];
    const bool unslashed = !a.slashed[i];
    if (a.act[i] <= cur && cur < a.exit[i]) s[0] += e;
    if (unslashed) {
      if (a.src[i]) s[1] += e;
      if (a.tgt[i]) s[2] += e;
      if (a.head[i]) s[3] += e;
      if (a.cur_tgt[i]) s[4] += e;
    }
  }
  block_sums_atomic<kSums>(s, a.sums);
}

// eff * BASE_REWARD_FACTOR // isqrt(total) // BASE_REWARDS_PER_EPOCH
__device__ __forceinline__ uint64_t base_reward(const Phase0Args& a, uint64_t eff,
                                                uint64_t sqrt_total) {
  return eff * a.base_reward_factor / sqrt_total / a.base_rewards_per_epoch;
}

__global__ void phase0_proposer_kernel(Phase0Args a) {
  const int64_t i = blockIdx.x * (int64_t)blockDim.x + threadIdx.x;
  if (i >= a.n || *a.just.cur_epoch == 0 || a.slashed[i] || !a.src[i]) return;
  const uint64_t sqrt_total = isqrt_u64(umax(a.sums[0], a.incr));
  const uint64_t reward = base_reward(a, a.eff[i], sqrt_total) / a.proposer_reward_quotient;
  int64_t p = a.incl_proposer[i];
  p = p < 0 ? 0 : (p > a.n - 1 ? a.n - 1 : p);
  atomicAdd(a.out_rewards + p, static_cast<unsigned long long>(reward));
}

__global__ void phase0_apply_kernel(Phase0Args a) {
  const int64_t i = blockIdx.x * (int64_t)blockDim.x + threadIdx.x;
  if (i >= a.n) return;
  const uint64_t incr = a.incr;
  const uint64_t cur = *a.just.cur_epoch;
  const uint64_t prev = cur > 0 ? cur - 1 : 0;
  const uint64_t total = umax(a.sums[0], incr);
  uint64_t att_bal[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) att_bal[k] = umax(a.sums[1 + k], incr);
  const uint64_t cur_tgt_bal = umax(a.sums[4], incr);

  // -- justification and finalization; the leak reads its finalized epoch
  const uint64_t fin_e =
      justification_update(a.just, a.out_just, att_bal[1], cur_tgt_bal, total, i == 0);
  const uint64_t finality_delay = prev - fin_e;
  const bool in_leak = finality_delay > a.min_epochs_to_inactivity_penalty;

  // -- this validator
  const uint64_t eff = a.eff[i], act = a.act[i], ex = a.exit[i], wd = a.wd[i];
  const bool slashed = a.slashed[i];
  const bool active_prev = act <= prev && prev < ex;
  const bool eligible = active_prev || (slashed && prev + 1 < wd);
  const bool att[3] = {a.src[i] && !slashed, a.tgt[i] && !slashed, a.head[i] && !slashed};

  const uint64_t br = base_reward(a, eff, isqrt_u64(total));
  const uint64_t proposer_reward = br / a.proposer_reward_quotient;
  const uint64_t total_units = total / incr;
  uint64_t rewards = a.out_rewards[i];  // the proposer micro-rewards of launch (b)
  uint64_t penalties = 0;
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    // during a leak attesters are credited as if participation were optimal
    const uint64_t full = in_leak ? br : br * (att_bal[k] / incr) / total_units;
    if (eligible && att[k]) rewards += full;
    if (eligible && !att[k]) penalties += br;
  }
  if (att[0]) {
    const uint64_t delay = a.incl_delay[i];
    rewards += (br - proposer_reward) / (delay > 1 ? delay : 1);
  }
  if (eligible && in_leak) {
    penalties += a.base_rewards_per_epoch * br - proposer_reward;
    if (!att[1]) penalties += eff * finality_delay / a.inactivity_penalty_quotient;
  }
  if (cur == 0) rewards = penalties = 0;
  a.out_rewards[i] = rewards;
  a.out_penalties[i] = penalties;
  uint64_t bal = a.bal[i] + rewards;
  bal -= umin(bal, penalties);

  // slashings sweep (every epoch, no genesis guard)
  const uint64_t adj = umin(*a.just.slashings_sum * a.proportional_slashing_multiplier, total);
  const bool slash_now = slashed && cur + a.epochs_per_slashings_vector / 2 == wd;
  bal -= umin(bal, slash_now ? (eff / incr) * adj / total * incr : 0);
  a.out_bal[i] = bal;

  // effective-balance hysteresis
  const uint64_t hyst = incr / a.hysteresis_quotient;
  const uint64_t down = hyst * a.hysteresis_downward_multiplier;
  const uint64_t up = hyst * a.hysteresis_upward_multiplier;
  const bool crossed = bal + down < eff || eff + up < bal;
  a.out_eff[i] = crossed ? umin(bal - bal % incr, a.max_effective_balance) : eff;
}

extern "C" int phase0_sums_launch(const Phase0Args* args, cudaStream_t stream) {
  const int threads = 256;
  int64_t blocks = (args->n + threads - 1) / threads;
  if (blocks > 132 * 8) blocks = 132 * 8;
  if (blocks > 0) phase0_sums_kernel<<<(unsigned)blocks, threads, 0, stream>>>(*args);
  return static_cast<int>(cudaGetLastError());
}

static int launch_per_validator(void (*kernel)(Phase0Args), const Phase0Args* args,
                                cudaStream_t stream) {
  const int threads = 256;
  const int64_t blocks = (args->n + threads - 1) / threads;
  if (blocks > 0) kernel<<<(unsigned)blocks, threads, 0, stream>>>(*args);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int phase0_proposer_launch(const Phase0Args* args, cudaStream_t stream) {
  return launch_per_validator(phase0_proposer_kernel, args, stream);
}

extern "C" int phase0_apply_launch(const Phase0Args* args, cudaStream_t stream) {
  return launch_per_validator(phase0_apply_kernel, args, stream);
}
