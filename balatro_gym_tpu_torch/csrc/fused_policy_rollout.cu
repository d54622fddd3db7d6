// Policy-collection kernels of the flagship full-game env, for Hopper
// (sm_90a): one env step with the next step's policy inputs (K3a), the
// policy inputs of a state (K3b), and the categorical sampler between the
// policy and the step.
//
// Replaces:
// * K3a: balatro_gym_tpu/ops/fused_policy_rollout.py:174 _kernel_step, one
//   fed step of the whole-rollout kernel's _step writing the packed state,
//   reward, done, and the observation and mask rows of the post-step state;
// * K3b: balatro_gym_tpu/ops/fused_policy_rollout.py:190 _kernel_observe,
//   the observation and mask rows of a state.
// The sampler replaces no Pallas kernel: the reference leaves
// jax.random.categorical to XLA. Written in torch it is some two hundred
// elementwise launches over a [60, B] block of int64 words a step, more
// than K3a and the policy together, so it is a kernel here.
//
// What bounds them on this card. K3a and K3b move memory: each reads the
// 2,136 B packed state of an env, K3a writes it back, and both write 756 B
// of observation and 60 B of mask (K3a also 5 B of reward and done): about
// 5.1 KB an env for K3a, 24 MB for K3b, at 8192 envs. The step's own
// integer work (Threefry hashes of the named streams, the shop rebuild, the
// autoreset's sort) depends on the action taken; one env step's dependent
// chain is long (tens of microseconds), so at collection widths the card
// waits on latency, not on bandwidth. The sampler does integer work: 60
// Threefry hashes of 20 rounds an env, 120 logf and 60 expf.
//
// What the design does about it: one thread per env, as K2; every row is
// written with envs contiguous, so stores coalesce; the observation and mask
// are written feature-major ([189, B] f32, [60, B] bytes), and the wrapper
// hands out the transposed views the policy's first matmul reads without a
// copy. K3b reads the state into a per-thread State (local memory, 888 B of
// stack and no spills with the compact State). K3a, the
// one launched every collection step, has a launch shape of its own:
// * blocks of kStepBlock (32) threads, so that 8192 envs make 256 blocks and
//   every one of the card's 132 SMs gets work (kBlock's 128 left 68 idle);
// * the env's compact State (888 B, full_step.cuh) in dynamic shared
//   memory, one slot a thread, 28,416 B a block: the step's runtime-indexed
//   deck and hand slots are then on chip, where a local State took 255
//   registers, 3,552 B of stack and 1.8 KB of spill stores. full_step.cuh's
//   helpers take State&, so load_state, step and store_state run on the slot
//   unchanged, and every bit is the same. The slot stride, 111 eight-byte
//   units, is odd, so a field read by a warp at one offset meets at most
//   2-way bank conflicts;
// * the autoreset's deck sort unrolled (step<true>, reset_state's unrolled
//   form), its 64 words in registers: a launch lasts as long as its slowest
//   warp, and on an H100 any warp with a resetting env paid ~100 us for the
//   looped sort.
// The sampler keeps one env's 60 logits in a thread, so the Gumbel argmax and
// the log-softmax at the drawn action need no reduction across threads; it
// reads the logits in the layout the policy's matmul wrote them (strides
// passed in), so no copy is made.
//
// Numerics: every observation row is the reference's f32 expression with
// _rn intrinsics (__fdiv_rn, never a reciprocal multiply); log1pf for the
// chips-needed row. The sampler draws word a * B + e of
// jax.random.bits(step_key, (60, B)), u = uniform(minval=tiny, maxval=1),
// Gumbel -log(-log(u)), and takes the lowest index among equal maxima, as
// jnp.argmax does.

#ifndef FULL_ROLLOUT_HOST_SHIM
#include <cuda_runtime.h>
#endif
#include <float.h>
#include <math.h>
#include <stdint.h>

#include "full_step.cuh"

namespace {

constexpr int kObs = 189, kActions = 60;
// K3a's launch shape (see above).
constexpr int kStepBlock = 32;
constexpr size_t kStepSmem = kStepBlock * sizeof(State);

// K3a's dynamic shared memory: State slots of its block's threads.
extern __shared__ __align__(16) unsigned char k3a_slots[];

// The observation rows of a State (the reference's _obs_rows, the engine's
// observe_vector): env e of B, row r at obs[r * B + e].
__device__ void write_obs(const State& s, float* __restrict__ obs, int e, size_t B) {
  int r = 0;
  auto put = [&](float v) { obs[(size_t)(r++) * B + e] = v; };
  for (int p = 0; p < kHand; ++p) {
    const bool present = p < s.hn && s.hidx[p] >= 0;
    for (int rank = 2; rank <= 14; ++rank) put(present && s.hrk[p] == rank ? 1.f : 0.f);
    for (int suit = 0; suit < 4; ++suit) put(present && s.hsu[p] == suit ? 1.f : 0.f);
  }
  for (int j = 0; j < kJok; ++j) put(fdiv((float)s.jok[j], 150.f));
  for (int h = 0; h < kLvl; ++h) put(fdiv((float)s.lvl[h], 15.f));
  for (int i = 0; i < kShop; ++i) put(fdiv((float)s.sty[i], 4.f));
  for (int i = 0; i < kShop; ++i) put(fminf(1.f, fdiv((float)s.sco[i], 1000.f)));
  for (int ph = 0; ph < 4; ++ph) put(s.phase == ph ? 1.f : 0.f);
  put(fdiv((float)s.money, 20.f));
  put(fdiv((float)s.ante, 8.f));
  put(fdiv((float)s.round, 3.f));
  put(fdiv((float)s.hl, 4.f));
  put(fdiv((float)s.dl, 3.f));
  put(fminf(2.f, fdiv((float)s.rchips, (float)(s.need > 1 ? s.need : 1))));
  put(fdiv(log1pf((float)s.need), 10.f));
  put(fdiv((float)s.jn, 5.f));
  put(fdiv((float)s.cn, 2.f));
  put(s.bact ? 1.f : 0.f);
  put(fdiv((float)(s.bact ? s.bid : 0), 28.f));
  put((s.sel & 0xFFu) != 0 ? 1.f : 0.f);
}

// The legal-action mask rows of a State (the engine's action_mask).
__device__ void write_mask(const State& s, uint8_t* __restrict__ mask, int e, size_t B) {
  for (int a = 0; a < kActions; ++a) mask[(size_t)a * B + e] = legal(s, a) ? 1 : 0;
}

// K3b.
__global__ void __launch_bounds__(kBlock)
policy_observe_kernel(const int* __restrict__ cards, const int* __restrict__ ints,
                      const uint32_t* __restrict__ rng, float* __restrict__ obs,
                      uint8_t* __restrict__ mask, int n_envs) {
  const int e = blockIdx.x * kBlock + threadIdx.x;
  if (e >= n_envs) return;
  const size_t B = (size_t)n_envs;
  State s;
  load_state(s, cards, ints, rng, e, B);
  write_obs(s, obs, e, B);
  write_mask(s, mask, e, B);
}

// K3a.
__global__ void __launch_bounds__(kStepBlock)
policy_step_kernel(const int* __restrict__ cards_in, const int* __restrict__ ints_in,
                   const uint32_t* __restrict__ rng_in, const int* __restrict__ actions,
                   const float* __restrict__ ft, int* __restrict__ cards_out,
                   int* __restrict__ ints_out, uint32_t* __restrict__ rng_out,
                   float* __restrict__ reward_out, uint8_t* __restrict__ done_out,
                   float* __restrict__ obs, uint8_t* __restrict__ mask, int n_envs) {
  const int e = blockIdx.x * kStepBlock + threadIdx.x;
  if (e >= n_envs) return;
  const size_t B = (size_t)n_envs;
  State& s = reinterpret_cast<State*>(k3a_slots)[threadIdx.x];
  load_state(s, cards_in, ints_in, rng_in, e, B);
  bool done = false;
  const float reward = step<true>(s, actions[e], ft, done);
  store_state(s, cards_out, ints_out, rng_out, e, B);
  reward_out[e] = reward;
  done_out[e] = done ? 1 : 0;
  write_obs(s, obs, e, B);
  write_mask(s, mask, e, B);
}

// Categorical sample of env e over its 60 logits, logits[e * s_env + a *
// s_act] (the policy's [B, 60] output in whatever layout its last matmul
// left: column-major makes these loads coalesce), with key (k0, k1), and
// the log-softmax at the drawn action.
__global__ void __launch_bounds__(kBlock)
policy_sample_kernel(const float* __restrict__ logits, int64_t s_env, int64_t s_act,
                     int n_envs, uint32_t k0, uint32_t k1, int* __restrict__ action,
                     float* __restrict__ log_prob) {
  const int e = blockIdx.x * kBlock + threadIdx.x;
  if (e >= n_envs) return;
  const float* l = logits + e * s_env;
  float best = -INFINITY, mx = -INFINITY;
  int arg = 0;
  for (int a = 0; a < kActions; ++a) {
    const float la = l[a * s_act];
    const uint32_t bits = random_bits32(k0, k1, (uint32_t)a * (uint32_t)n_envs + (uint32_t)e);
    // uniform(minval=tiny, maxval=1): f * (1 - tiny) + tiny, at least tiny
    const float u = fmaxf(FLT_MIN, fadd(fmul(tf_uniform_f32(bits), 1.f), FLT_MIN));
    const float v = fadd(la, -logf(-logf(u)));
    if (v > best) {
      best = v;
      arg = a;
    }
    mx = fmaxf(mx, la);
  }
  float sum = 0.f;
  for (int a = 0; a < kActions; ++a) sum = fadd(sum, expf(fsub(l[a * s_act], mx)));
  action[e] = arg;
  log_prob[e] = fsub(fsub(l[arg * s_act], mx), logf(sum));
}

inline int grid_of(int n_envs) { return (n_envs + kBlock - 1) / kBlock; }

}  // namespace

#ifndef FULL_ROLLOUT_HOST_SHIM
// Each launcher runs its kernel on ``stream`` and returns the launch's
// cudaError_t. The packed state is cards [384, n_envs] i32, ints [132,
// n_envs] i32 and rng [18, n_envs] u32; observation rows [189, n_envs] f32
// and mask rows [60, n_envs] u8 are written feature-major. Outputs are
// allocated by the caller.

// K3b: observation and mask of a packed state.
extern "C" int policy_observe_launch(const int* cards, const int* ints, const unsigned int* rng,
                                     float* obs, unsigned char* mask, int n_envs,
                                     void* stream) {
  if (n_envs <= 0) return (int)cudaSuccess;
  policy_observe_kernel<<<grid_of(n_envs), kBlock, 0, (cudaStream_t)stream>>>(
      cards, ints, rng, obs, mask, n_envs);
  return (int)cudaGetLastError();
}

// K3a: one fed step (actions [n_envs] i32; ftab the float tables of
// fused_full_rollout_launch), then the packed state, reward [n_envs] f32,
// done [n_envs] u8 and the observation and mask of the post-step state. The
// kernel's shared-memory limit is set on the first launch on each device.
extern "C" int policy_step_launch(const int* cards_in, const int* ints_in,
                                  const unsigned int* rng_in, const int* actions,
                                  const float* ftab, int* cards_out, int* ints_out,
                                  unsigned int* rng_out, float* reward, unsigned char* done,
                                  float* obs, unsigned char* mask, int n_envs, void* stream) {
  if (n_envs <= 0) return (int)cudaSuccess;
  static bool ready[64] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev < 0 || dev >= 64) return (int)cudaErrorInvalidDevice;
  if (!ready[dev]) {
    err = cudaFuncSetAttribute(policy_step_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)kStepSmem);
    if (err != cudaSuccess) return (int)err;
    ready[dev] = true;
  }
  policy_step_kernel<<<(n_envs + kStepBlock - 1) / kStepBlock, kStepBlock, kStepSmem,
                       (cudaStream_t)stream>>>(cards_in, ints_in, rng_in, actions, ftab,
                                               cards_out, ints_out, rng_out, reward, done,
                                               obs, mask, n_envs);
  return (int)cudaGetLastError();
}

// K3a's launch shape and what the compiler gave it: out[0] threads a block,
// out[1] dynamic shared bytes a block, out[2] registers a thread, out[3]
// local (stack) bytes a thread.
extern "C" int policy_step_info(int* out) {
  cudaFuncAttributes a;
  const cudaError_t err = cudaFuncGetAttributes(&a, policy_step_kernel);
  if (err != cudaSuccess) return (int)err;
  out[0] = kStepBlock;
  out[1] = (int)kStepSmem;
  out[2] = a.numRegs;
  out[3] = (int)a.localSizeBytes;
  return (int)cudaSuccess;
}

// The sampler: logits [n_envs, 60] f32 with element strides (s_env, s_act)
// -> action [n_envs] i32, log_prob [n_envs] f32; (k0, k1) is the step's key.
extern "C" int policy_sample_launch(const float* logits, long long s_env, long long s_act,
                                    int n_envs, unsigned int k0, unsigned int k1, int* action,
                                    float* log_prob, void* stream) {
  if (n_envs <= 0) return (int)cudaSuccess;
  policy_sample_kernel<<<grid_of(n_envs), kBlock, 0, (cudaStream_t)stream>>>(
      logits, s_env, s_act, n_envs, k0, k1, action, log_prob);
  return (int)cudaGetLastError();
}
#endif
