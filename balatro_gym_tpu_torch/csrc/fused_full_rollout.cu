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
// What bounds it on this card: the latency of each thread's dependent
// integer chains, hidden only by resident warps. A step is a long stateful
// program with data-dependent indexing (64 deck slots, 151 shop jokers, 64
// Immolate priorities, a 543-exchange sorting network at autoreset) and
// several hundred Threefry hashes of 20 rounds each where the shop is
// rebuilt; an env's steps are serial, so a thread is one chain. Memory
// traffic is one read and one write of the ~2.1 KB packed state per env per
// call, plus 4 B/env-step of fed actions, and the State's own local-memory
// accesses, which the resident warps hide as well.
//
// What the design does about it: one thread per env; the packed [rows, B]
// state (envs contiguous, so every load and store coalesces) is read into
// a per-thread State once, stepped n_steps times and written back. Where
// the TPU program computes every branch and selects, this kernel switches
// on the action and runs only the taken branch; the RNG stays bit-exact
// because every draw is keyed by (stream, counter), and each branch bumps
// exactly the counters the TPU program's merge keeps. Unsigned priority
// words are compared as uint32 (the TPU program flips the sign bit to
// order them as int32: the same order). The launch shape is the kernel's
// own, for resident warps:
// * the compact State (888 B, card channels as bytes; full_step.cuh) in
//   local memory, so registers, not the State, bound occupancy;
// * blocks of kRolloutBlock (64) threads and at least kRolloutMinBlocks
//   (16) blocks an SM, so the compiler holds a thread to 64 registers and
//   1,024 threads fit an SM: 135,168 on the card, every env of the
//   131072-env flagship shape resident at once. 64 registers cost 288 B of
//   spill stores; the warps gained outweigh them. On one NVIDIA H100 80GB
//   HBM3 at 700 W (PERF.md), 131072 x 256 sampled: 59.7 ms, against 72.7
//   at 96 registers and 5 blocks of 128;
// * the State is not in shared memory, as K3a's is: at 888 B a slot an SM
//   holds 256 envs, 8 warps, too few to hide the chains (94-110 ms);
// * the autoreset's sort keeps its loops (step<false>): the unrolled form's
//   64 live words cost spills here (61.7 ms at 64 registers).
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

// K2's launch shape (see above).
constexpr int kRolloutBlock = 64, kRolloutMinBlocks = 16;

__global__ void __launch_bounds__(kRolloutBlock, kRolloutMinBlocks)
fused_full_rollout_kernel(const int* __restrict__ cards_in, const int* __restrict__ ints_in,
                          const uint32_t* __restrict__ rng_in, const int* __restrict__ actions,
                          const float* __restrict__ ft, int* __restrict__ cards_out,
                          int* __restrict__ ints_out, uint32_t* __restrict__ rng_out,
                          float* __restrict__ reward_out, int* __restrict__ epi_out,
                          int n_envs, int n_steps, int use_actions, uint32_t key0,
                          uint32_t key1) {
  const int e = blockIdx.x * kRolloutBlock + threadIdx.x;
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
  fused_full_rollout_kernel<<<(n_envs + kRolloutBlock - 1) / kRolloutBlock, kRolloutBlock, 0,
                              (cudaStream_t)stream>>>(
      cards_in, ints_in, rng_in, actions, ftab, cards_out, ints_out, rng_out, reward_out,
      epi_out, n_envs, n_steps, use_actions, key0, key1);
  return (int)cudaGetLastError();
}

// K2's launch shape and what the compiler gave it: out[0] threads a block,
// out[1] shared bytes a block, out[2] registers a thread, out[3] local
// (stack) bytes a thread.
extern "C" int fused_full_rollout_info(int* out) {
  cudaFuncAttributes a;
  const cudaError_t err = cudaFuncGetAttributes(&a, fused_full_rollout_kernel);
  if (err != cudaSuccess) return (int)err;
  out[0] = kRolloutBlock;
  out[1] = (int)a.sharedSizeBytes;
  out[2] = a.numRegs;
  out[3] = (int)a.localSizeBytes;
  return (int)cudaSuccess;
}
#endif
