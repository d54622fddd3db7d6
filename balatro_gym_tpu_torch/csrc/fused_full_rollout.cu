// Whole-rollout kernel of the flagship full-game env, for Hopper (sm_90a).
//
// Replaces: balatro_gym_tpu/ops/fused_full_rollout.py:_kernel (the Pallas
// TPU kernel behind rollout_full_fused), which loops _step over n steps.
// Same semantics, bit for bit: play with scoring, discard, select, 40
// consumables, shop buy/reroll/sell/end, blind selection and the acting
// bosses, with autoreset. The plain PyTorch version beside it
// (ops/fused_full_rollout.py) is held against it on the card, and against
// the reference's rows program on the CPU.
//
// What bounds it on this card: integer work per env-step. A step is a long
// stateful program with data-dependent indexing (64 deck slots, 151 shop
// jokers, 64 Immolate priorities, a 543-exchange sorting network at
// autoreset) and several hundred Threefry hashes of 20 rounds each where
// the shop is rebuilt. Memory traffic is one read and one write of the
// ~2.1 KB packed state per env per call, plus 4 B/env-step of fed actions.
//
// What the design does about it: one thread per env; the packed [rows, B]
// state (envs contiguous, so every load and store coalesces) is read into
// a per-thread struct once, stepped n_steps times and written back. Where
// the TPU program computes every branch and selects, this kernel switches
// on the action and runs only the taken branch; the RNG stays bit-exact
// because every draw is keyed by (stream, counter), and each branch bumps
// exactly the counters the TPU program's merge keeps. Unsigned priority
// words are compared as uint32 (the TPU program flips the sign bit to
// order them as int32: the same order). The state lives in local memory
// (it does not fit in registers); shared memory, occupancy and the
// instruction mix are later work.
//
// The state, its load and store and the step are in full_step.cuh, shared
// with the policy-collection kernels; its notes give the numerics.
//
// Randomness: fed mode reads actions[t * n_envs + e]; sampled mode draws
// the action from random_bits32(split_child(seed_key(seed), e), t) through
// the TPU kernel's uniform-over-legal ladder. Every game draw, in both
// modes, uses the named streams: fold_in(fold_in(key, stream), counter).

#ifndef FULL_ROLLOUT_HOST_SHIM
#include <cuda_runtime.h>
#endif
#include <stdint.h>

#include "full_step.cuh"

namespace {

__global__ void __launch_bounds__(kBlock)
fused_full_rollout_kernel(const int* __restrict__ cards_in, const int* __restrict__ ints_in,
                          const uint32_t* __restrict__ rng_in, const int* __restrict__ actions,
                          const float* __restrict__ ft, int* __restrict__ cards_out,
                          int* __restrict__ ints_out, uint32_t* __restrict__ rng_out,
                          float* __restrict__ reward_out, int* __restrict__ epi_out,
                          int n_envs, int n_steps, int use_actions, uint32_t key0,
                          uint32_t key1) {
  const int e = blockIdx.x * kBlock + threadIdx.x;
  if (e >= n_envs) return;
  const size_t B = (size_t)n_envs;
  State s;
  load_state(s, cards_in, ints_in, rng_in, e, B);

  TfKey child = {0u, 0u};
  if (!use_actions) child = tf_split_child(TfKey{key0, key1}, (uint32_t)e);
  float tot = 0.f;
  int epi = 0;
  for (int t = 0; t < n_steps; ++t) {
    const int a = use_actions ? actions[(size_t)t * B + e]
                              : sample_action(s, tf_bits32(child, (uint32_t)t));
    bool done = false;
    tot = fadd(tot, step<false>(s, a, ft, done));
    epi += done;
  }

  store_state(s, cards_out, ints_out, rng_out, e, B);
  reward_out[e] = tot;
  epi_out[e] = epi;
}

}  // namespace

#ifndef FULL_ROLLOUT_HOST_SHIM
// Launches the rollout on ``stream``. Inputs: cards [384, n_envs] i32,
// ints [132, n_envs] i32, rng [18, n_envs] u32 (the packed state), the fed
// actions [n_steps, n_envs] i32 when use_actions, and the float tables
// (powers of 1.5 [96], 0.8 [12], 1.15 [100], hand quality [12], ln 10
// [1]); outputs,
// allocated by the caller: the packed state, reward [n_envs] f32 and
// episodes [n_envs] i32. (key0, key1) = seed_key(seed) for sampled mode.
// Returns the launch's cudaError_t.
extern "C" int fused_full_rollout_launch(const int* cards_in, const int* ints_in,
                                         const unsigned int* rng_in, const int* actions,
                                         const float* ftab, int* cards_out, int* ints_out,
                                         unsigned int* rng_out, float* reward_out,
                                         int* epi_out, int n_envs, int n_steps,
                                         int use_actions, unsigned int key0,
                                         unsigned int key1, void* stream) {
  if (n_envs <= 0) return (int)cudaSuccess;
  const int grid = (n_envs + kBlock - 1) / kBlock;
  fused_full_rollout_kernel<<<grid, kBlock, 0, (cudaStream_t)stream>>>(
      cards_in, ints_in, rng_in, actions, ftab, cards_out, ints_out, rng_out, reward_out,
      epi_out, n_envs, n_steps, use_actions, key0, key1);
  return (int)cudaGetLastError();
}
#endif
