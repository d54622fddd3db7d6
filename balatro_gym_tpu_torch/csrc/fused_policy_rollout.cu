// Policy-collection kernels of the flagship full-game env, for Hopper
// (sm_90a): one env step with the next step's policy inputs (K3a), the
// policy inputs of a state (K3b), the categorical sampler between the
// policy and the step, the engine's step without reset (env_step_kernel)
// and the engine's reset (env_reset_kernel).
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
// env_step_kernel replaces none either: it is the engine's own step
// (balatro_gym_tpu/engine/full_env.py step, XLA there), K3a's step without
// its autoreset, for engine.full_env.step. Nor does env_reset_kernel: it is
// the engine's reset (balatro_gym_tpu/engine/full_env.py reset, and
// step_autoreset's, XLA there), for engine.full_env.reset, autoreset and
// step_autoreset.
//
// What bounds them on this card. K3a moves memory: it reads the 2,136 B
// packed state of an env and writes it back, with 756 B of observation, 60 B
// of mask and 5 B of reward and done: about 5.1 KB an env. The step's own
// integer work (Threefry hashes of the named streams, the shop rebuild, the
// autoreset's sort) depends on the action taken; one env step's dependent
// chain is long (tens of microseconds), so at collection widths the card
// waits on latency, not on bandwidth. K3b moves memory too: of the packed
// state it needs 69 int rows and, for each card in the hand, its rank and
// suit (at most 85 words, 340 B an env), and it writes 816 B: 9.5 MB, 2.8 us
// at 3.35 TB/s, at 8192 envs. The sampler does integer work: 60 Threefry
// hashes of 20 rounds an env (4,500 integer operations, 37 M at 8192 envs,
// about 1 us of the card's INT32 rate), 120 logf and 60 expf, and reads 240
// B of logits.
//
// What the design does about it. Every row is written with envs contiguous,
// so stores coalesce; the observation and mask are written feature-major
// ([189, B] f32, [60, B] bytes), and the wrapper hands out the transposed
// views the policy's first matmul reads without a copy. K3a steps the
// engine's step's blocks of envs; each kernel has a launch shape of its own.
//
// env_step_kernel runs step<true, false>: the step without the reset, so a
// done env keeps its final state and the engine's own reset
// (env_reset_kernel) replaces it. It writes the packed state, reward and
// done, and no observation or mask: for a done env they would be those of
// the state the reset replaces. Its traffic is K3a's less the observation
// and mask, 4.3 KB an env (10.5 us at 8192 envs), but a launch lasts as long
// as its slowest warp, and a warp runs the union of the branches its envs
// take, one after another: play (scoring, then a beat's shop generation of
// 151 hashes in one chain, or a draw) ~70 us, a shop generation alone ~52,
// a consumable ~46, the rest ~20-25, the load and store alone ~19 (PERF.md).
// So each block of kEnvStepBlock envs steps them in warps of one branch
// group (env_step_kernel's phases below), the envs' compact States (888 B,
// full_step.cuh) in slots of dynamic shared memory (cudaFuncSetAttribute on
// the first launch on a device): the step's runtime-indexed deck and hand
// slots are then on chip, where a local State took 255 registers and 3,552
// B of stack. full_step.cuh's helpers take State&, so load_state, step and
// store_state run on a slot unchanged, and every bit is the same. The slot
// stride, 111 eight-byte units, is odd, so a field read by a warp at one
// offset meets at most 2-way bank conflicts. The shop generation, which
// three branches reach, runs once a warp after the branches join (step's
// kJoinShop), where a warp ran it once a branch. The other forms measured
// (one thread an env in 32-thread blocks, 128-env blocks, a class pass
// ordering the whole batch first) were slower (PERF.md).
//
// K3a is env_step_kernel's step with the autoreset, the observation and the
// mask, on the same blocks of kEnvStepBlock envs and the same classify and
// place, but kStepJobs threads an env (policy_step_kernel below). One thread
// an env in 32-thread blocks paid three costs a launch: a warp ran the union
// of its envs' branches; any warp holding an ended env sorted 64 words in
// one thread (reset_state), ~26 us of dependent compare-exchanges whatever
// branch group it ran; and at 8192 envs an SM held two warps, so each
// thread's ~530 row loads and ~780 row stores waited on memory latency in
// one chain (on the card ~17 us to load a block and ~19 to store it, of an
// ~85-us launch, PERF.md). So:
// * run: warp w steps places 32w..32w+31, envs of one branch group;
// * reset: the block's ended envs get a fresh episode in their slots, one
//   warp an env (autoreset_slot): each lane draws 2 of the 52 deck words
//   and 12 pads, the warp sorts them in shared memory (sort64, as the
//   engine's reset does), each lane deals 2 deck slots. In training ~1.6%
//   of envs end a step, about one a block;
// * load, store: the kStepJobs threads of an env each load or store a part
//   of its rows, a warp's lanes one row of 32 neighbouring envs.
// On the trainer's states a launch fell from ~131 to ~75 us, the step of its
// play branch now ~70% of it. The other forms measured (one thread an env
// in these blocks, 32-env blocks, a register bound for two blocks an SM)
// were slower or no faster (PERF.md).
//
// env_reset_kernel, one warp an env and kResetEnvs envs a block: a warp's
// lanes draw the 52 words of the engine's permutation shuffle, two a lane,
// and sort the (word, index) keys with a bitonic network in shared memory,
// one compare-exchange a lane a stage; lane 0 writes the other fields. Then
// the block's warps store its envs' rows together, a lane an env, so that
// each row's store is one coalesced line. What bounds it: 2,148 B an env
// that resets, 56 hashes and the sort's 672 compare-exchanges; the
// autoreset mode resets the few envs that ended, and a block none of whose
// envs resets returns at once.
//
// K3b, kObserveGroups threads an env. One thread an env in 128-thread
// blocks left 68 of the 132 SMs idle at 8192 envs, and each thread read all
// 534 packed rows of its env into a State in one chain, though the
// observation and mask read 85 of them. A block now serves kObserveEnvs (32)
// envs with kObserveGroups warps (256 blocks at 8192 envs), in two phases
// split by __syncthreads:
// * load: warp g runs the load jobs j = g (mod kObserveGroups) of its 32
//   envs (kObserveJobs: a hand position each, then six groups of rows),
//   each a few independent coalesced 128 B row loads (the hand's card
//   ranks and suits are gathers by deck slot), into the fields of the env's
//   State slot in shared memory (28,416 B a block) that obs_row and legal
//   read, with load_state's expressions;
// * emit: warp g writes the observation rows r = g (mod kObserveGroups)
//   and the mask rows a = g (mod kObserveGroups) of its 32 envs, each a
//   coalesced 128 B (or 32 B) store of one row by a warp. obs_row(s, r) is
//   write_obs's expression of row r.
// Staging the whole packed tile of a block in shared memory (cp.async) and
// running load_state on it was measured first: 16.8-23.1 us, against 22.7
// for the old shape. With 8 threads an env the field loads took 158
// registers (one block an SM, two waves); with 16 or 32, 32 registers and
// every block resident at once; 32 was the faster by 6% (PERF.md).
//
// The sampler, kSampleGroups threads an env. One thread ran an env's 60
// hashes in one chain, again in 64 blocks of 128. A block now serves
// kSampleEnvs (32) envs with kSampleGroups warps; lane l of warp g takes env
// l's kPerThread actions a = g (mod kSampleGroups). Four phases split by
// __syncthreads:
// * stage: the thread starts asynchronous copies (cp.async) of its share of
//   the block's 32 x 60 logits into shared memory, the loop ordered so that
//   neighbouring threads read neighbouring addresses in either layout (the
//   policy's matmul leaves the logits column-major), and computes the Gumbel
//   noise of its actions while they travel; its loop is unrolled, so its
//   hash chains interleave. The pitch, 33 floats an action, keeps the
//   copies' stores and the lanes' reads free of bank conflicts;
// * partials: each thread's best perturbed logit (value, action), lowest
//   action on ties, and its largest logit;
// * sums: each thread combines the groups' largest logits and sums
//   expf(logit - max) over its actions;
// * write: warp 0 combines the groups' best values in group order with
//   argmax's rule (a larger value, or an equal one at a lower action) and
//   the partial sums in group order, and writes the action and its
//   log-softmax.
// Every phase reads and writes shared memory through plain pointers, so the
// host build of the tests runs a block's threads phase by phase.
//
// Numerics: every observation row is the reference's f32 expression with
// _rn intrinsics (__fdiv_rn, never a reciprocal multiply); log1pf for the
// chips-needed row. The sampler draws word a * B + e of
// jax.random.bits(step_key, (60, B)), u = uniform(minval=tiny, maxval=1),
// Gumbel -log(-log(u)), and takes the lowest index among equal maxima, as
// jnp.argmax does; its log-softmax sums the 60 exponentials in another order
// than torch's log_softmax (within 1e-6 of it).

#ifndef FULL_ROLLOUT_HOST_SHIM
#include <cuda_runtime.h>
#endif
#include <float.h>
#include <math.h>
#include <stdint.h>

#include "full_step.cuh"

namespace {

constexpr int kObs = 189, kActions = 60;
// The engine's step and K3a: kEnvStepBlock envs a block. The engine's
// reset: kResetEnvs envs (warps) a block, one a lane when it stores.
constexpr int kEnvStepBlock = 64, kResetEnvs = 32;
// K3b's: kObserveJobs load jobs of an env (see observe_load) shared by its
// kObserveGroups threads.
constexpr int kObserveEnvs = 32, kObserveGroups = 32, kObserveJobs = kHand + 6;
constexpr int kObserveBlock = kObserveEnvs * kObserveGroups;
// The sampler's: each thread takes kPerThread of an env's actions.
constexpr int kSampleEnvs = 32, kSampleGroups = 12, kPerThread = kActions / kSampleGroups;
constexpr int kSampleBlock = kSampleEnvs * kSampleGroups;
constexpr int kPitch = kSampleEnvs + 1;
static_assert(kActions % kSampleGroups == 0, "every thread takes as many actions");

// The dynamic shared memory of K3a and the engine's step: State slots of a
// block's envs, and what their phases share.
extern __shared__ __align__(16) unsigned char k3a_slots[];

#ifndef FULL_ROLLOUT_HOST_SHIM
// An asynchronous 4 B copy from device into shared memory (cp.async) and the
// wait for all of a thread's; the host build's shim defines them as a plain
// copy and nothing.
__device__ __forceinline__ void copy_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   (unsigned)__cvta_generic_to_shared(dst)),
               "l"(src));
}
__device__ __forceinline__ void copy_async_wait() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}
#endif

// Observation row r of a State (the reference's _obs_rows, the engine's
// observe_vector).
__device__ __forceinline__ float obs_row(const State& s, int r) {
  if (r < kHand * 17) {
    const int p = r / 17, k = r % 17;
    const bool present = p < s.hn && s.hidx[p] >= 0;
    return present && (k < 13 ? s.hrk[p] == k + 2 : s.hsu[p] == k - 13) ? 1.f : 0.f;
  }
  r -= kHand * 17;
  if (r < kJok) return fdiv((float)s.jok[r], 150.f);
  r -= kJok;
  if (r < kLvl) return fdiv((float)s.lvl[r], 15.f);
  r -= kLvl;
  if (r < kShop) return fdiv((float)s.sty[r], 4.f);
  r -= kShop;
  if (r < kShop) return fminf(1.f, fdiv((float)s.sco[r], 1000.f));
  r -= kShop;
  if (r < 4) return s.phase == r ? 1.f : 0.f;
  switch (r - 4) {
    case 0: return fdiv((float)s.money, 20.f);
    case 1: return fdiv((float)s.ante, 8.f);
    case 2: return fdiv((float)s.round, 3.f);
    case 3: return fdiv((float)s.hl, 4.f);
    case 4: return fdiv((float)s.dl, 3.f);
    case 5: return fminf(2.f, fdiv((float)s.rchips, (float)(s.need > 1 ? s.need : 1)));
    case 6: return fdiv(log1pf((float)s.need), 10.f);
    case 7: return fdiv((float)s.jn, 5.f);
    case 8: return fdiv((float)s.cn, 2.f);
    case 9: return s.bact ? 1.f : 0.f;
    case 10: return fdiv((float)(s.bact ? s.bid : 0), 28.f);
    default: return (s.sel & 0xFFu) != 0 ? 1.f : 0.f;
  }
}

// The observation rows of a State (the reference's _obs_rows, the engine's
// observe_vector): env e of B, row r at obs[r * B + e]. K3a's straight-line
// form of obs_row's expressions: a loop over obs_row made K3a 17-51% slower.
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

// K3b's phases for thread (lane l, warp g) of the block of envs from `base`.
// Load: warp g runs the jobs j = g (mod kObserveGroups) of env base + l,
// each reading some of the fields obs_row and legal read, as load_state
// reads them, into the env's State slot: job p < 8 hand position p, then the
// selection, phase and done flag; the jokers; the hand levels; the shop's
// types and the money; the shop's costs; the round's scalars. No other field
// of the slot is set.
__device__ void observe_load(State* slots, const int* __restrict__ cards,
                             const int* __restrict__ ints, int l, int g, int base, int n_envs) {
  const int e = base + l;
  if (e >= n_envs) return;
  const size_t B = (size_t)n_envs;
  State& s = slots[l];
#define IN(r) ints[(size_t)(r) * B + e]
  for (int j = g; j < kObserveJobs; j += kObserveGroups) {
    if (j < kHand) {
      const int h = IN(R_HIDX + j);
      const bool in_deck = j < IN(S_HN) && h >= 0 && h < kDeck;
      s.hidx[j] = h;
      s.hrk[j] = in_deck ? cards[(size_t)(0 * kDeck + h) * B + e] : 0;
      s.hsu[j] = in_deck ? cards[(size_t)(1 * kDeck + h) * B + e] : 0;
      continue;
    }
    switch (j - kHand) {
      case 0:
        s.sel = 0;
        for (int p = 0; p < kHand; ++p) s.sel |= (uint32_t)(IN(R_SEL + p) != 0) << p;
        s.hn = IN(S_HN);
        s.phase = IN(S_PHASE);
        s.done = IN(S_DONE) != 0;
        break;
      case 1:
        for (int i = 0; i < kJok; ++i) s.jok[i] = IN(R_JOK + i);
        s.jn = IN(S_JN);
        s.cn = IN(S_CN);
        break;
      case 2:
        for (int h = 0; h < kLvl; ++h) s.lvl[h] = IN(R_LVL + h);
        break;
      case 3:
        for (int r = 0; r < kShop; ++r) s.sty[r] = IN(R_STY + r);
        s.sn = IN(S_SN);
        s.money = IN(S_MONEY);
        s.rcost = IN(S_RCOST);
        break;
      case 4:
        for (int r = 0; r < kShop; ++r) s.sco[r] = IN(R_SCO + r);
        break;
      default:
        s.ante = IN(S_ANTE); s.round = IN(S_ROUND); s.hl = IN(S_HL); s.dl = IN(S_DL);
        s.rchips = IN(S_RCHIPS); s.need = IN(S_NEED); s.bid = IN(S_BID);
        s.bact = IN(S_BACT) != 0;
    }
  }
#undef IN
}

// Emit: warp g's observation and mask rows of env base + l.
__device__ void observe_emit(const State* slots, float* __restrict__ obs,
                             uint8_t* __restrict__ mask, int l, int g, int base, int n_envs) {
  const int e = base + l;
  if (e >= n_envs) return;
  const size_t B = (size_t)n_envs;
  const State& s = slots[l];
  for (int r = g; r < kObs; r += kObserveGroups) obs[(size_t)r * B + e] = obs_row(s, r);
  for (int a = g; a < kActions; a += kObserveGroups)
    mask[(size_t)a * B + e] = legal(s, a) ? 1 : 0;
}

// K3b. The packed rng rows are not read: no observation row depends on them.
__global__ void __launch_bounds__(kObserveBlock)
policy_observe_kernel(const int* __restrict__ cards, const int* __restrict__ ints,
                      const uint32_t* __restrict__ rng, float* __restrict__ obs,
                      uint8_t* __restrict__ mask, int n_envs) {
  __shared__ State slots[kObserveEnvs];
  const int l = threadIdx.x % kObserveEnvs, g = threadIdx.x / kObserveEnvs;
  const int base = blockIdx.x * kObserveEnvs;
  observe_load(slots, cards, ints, l, g, base, n_envs);
  __syncthreads();
  observe_emit(slots, obs, mask, l, g, base, n_envs);
}

// The engine's step: K3a's step without the autoreset, the observation or
// the mask, kEnvStepBlock envs a block, in four phases split by
// __syncthreads:
// * classify: thread t reads the fields branch_class reads of the block's
//   env t into State slot t and writes its branch class;
// * place: thread t finds env t's place p in the block's run order and
//   loads the env into State slot p with load_state (a warp's row loads
//   coalesce);
// * run: thread p steps slot p, so a warp steps the envs of one branch
//   group and slots meet at most 2-way bank conflicts (the slot rule);
// * store: thread t stores slot p of env t.
// The run order: the block's envs in class order, but each of the four
// branch groups (branch_group) starts on a warp, the gap before it filled
// with envs of the cheapest classes (the order's tail). A warp then runs
// one group's branches, and the gaps' envs cost it little; the shop
// generation runs once a warp, after its lanes' branches join (kJoinShop).
// The slots, the classes, each env's place and each place's env lie in
// dynamic shared memory (kEnvStepSmem). Each env's result depends on its
// own column only, so an order of stepping changes no bit.
constexpr size_t kEnvStepSmem = kEnvStepBlock * (sizeof(State) + 1 + 2 * sizeof(int16_t));
static_assert(kEnvStepSmem <= 232448, "a block's shared memory, 227 KB");

struct EnvStepSmem {
  State* slots;
  uint8_t* cls;
  int16_t* place;    // env t's place
  int16_t* env_at;   // place p's env
};

__device__ __forceinline__ EnvStepSmem env_step_smem_of(unsigned char* base) {
  State* slots = reinterpret_cast<State*>(base);
  uint8_t* cls = reinterpret_cast<uint8_t*>(slots + kEnvStepBlock);
  int16_t* place = reinterpret_cast<int16_t*>(cls + kEnvStepBlock);
  return {slots, cls, place, place + kEnvStepBlock};
}

// The fields branch_class reads, from env e's packed int rows.
__device__ void load_class_fields(State& s, const int* __restrict__ ints, int e, size_t B) {
#define IN(r) ints[(size_t)(r) * B + e]
  s.sel = 0;
  for (int p = 0; p < kHand; ++p) s.sel |= (uint32_t)(IN(R_SEL + p) != 0) << p;
  for (int r = 0; r < kShop; ++r) s.sco[r] = IN(R_SCO + r);
  s.hn = IN(S_HN); s.jn = IN(S_JN); s.cn = IN(S_CN); s.ante = IN(S_ANTE);
  s.phase = IN(S_PHASE); s.career = IN(S_CAREER); s.money = IN(S_MONEY); s.dl = IN(S_DL);
  s.sn = IN(S_SN); s.rcost = IN(S_RCOST);
  s.done = IN(S_DONE) != 0;
#undef IN
}

__device__ __forceinline__ void env_step_classify(EnvStepSmem sm,
                                                  const int* __restrict__ ints_in,
                                                  const int* __restrict__ actions, int t,
                                                  int base, int n_envs) {
  const int e = base + t;
  if (e >= n_envs) {
    sm.cls[t] = kBranchClasses;      // past the last env: ranked last
    return;
  }
  load_class_fields(sm.slots[t], ints_in, e, (size_t)n_envs);
  sm.cls[t] = (uint8_t)branch_class(sm.slots[t], actions[e]);
}

__device__ __forceinline__ int round_up32(int x) { return (x + 31) & ~31; }

// Env t's place among a block's `envs` envs: its stable rank r in class
// order, moved as the run order wants (see above). n0-n3: the block's envs
// of each group; the gaps after groups 0, 1 and 2 take the last envs of
// group 3, in that order from its end.
__device__ __forceinline__ int env_step_place_of(const uint8_t* cls, int t, int envs) {
  static_assert(kBranchGroups == 4, "the place of an env in four groups");
  const int c = cls[t];
  int r = 0, n0 = 0, n1 = 0, n2 = 0, n3 = 0;
  for (int u = 0; u < envs; ++u) {
    const int cu = cls[u];
    r += cu < c || (cu == c && u < t);
    const int g = cu < kBranchClasses ? branch_group(cu) : kBranchGroups;
    n0 += g == 0;
    n1 += g == 1;
    n2 += g == 2;
    n3 += g == 3;
  }
  if (c == kBranchClasses) return r;                          // past the last env
  const int gap0 = min(round_up32(n0) - n0, n3);
  const int gap1 = min(round_up32(n1) - n1, n3 - gap0);
  const int gap2 = min(round_up32(n2) - n2, n3 - gap0 - gap1);
  if (r < n0) return r;
  if (r < n0 + n1) return r + gap0;
  if (r < n0 + n1 + n2) return r + gap0 + gap1;
  const int q = r - n0 - n1 - n2, rest = n3 - gap0 - gap1 - gap2;  // rank in group 3
  if (q >= n3 - gap0) return n0 + q - (n3 - gap0);
  if (q >= n3 - gap0 - gap1) return n0 + gap0 + n1 + q - (n3 - gap0 - gap1);
  if (q >= rest) return n0 + gap0 + n1 + gap1 + n2 + q - rest;
  return n0 + gap0 + n1 + gap1 + n2 + gap2 + q;
}

__device__ __forceinline__ void env_step_place(EnvStepSmem sm,
                                               const int* __restrict__ cards_in,
                                               const int* __restrict__ ints_in,
                                               const uint32_t* __restrict__ rng_in, int t,
                                               int base, int n_envs) {
  const int p = env_step_place_of(sm.cls, t, kEnvStepBlock);
  sm.place[t] = (int16_t)p;
  sm.env_at[p] = (int16_t)t;
  if (base + t < n_envs)
    load_state(sm.slots[p], cards_in, ints_in, rng_in, base + t, (size_t)n_envs);
}

// One env's step with its outputs, kept out of the kernel's body: inlined
// there, it cost the load phase its batched loads (SASS: each row's load
// waited for the previous row's shared store; the load phase took ~56 k
// cycles against ~30 k, PERF.md). It writes its outputs itself, so that no
// value of the caller's lives across the call.
__device__ __noinline__ void env_step_one(State& s, int a, const float* __restrict__ ft,
                                          float* __restrict__ reward,
                                          uint8_t* __restrict__ done_out) {
  bool done = false;
  *reward = step<true, false, true>(s, a, ft, done);
  *done_out = done ? 1 : 0;
}

__device__ __forceinline__ void env_step_run(EnvStepSmem sm, const int* __restrict__ actions,
                                             const float* __restrict__ ft,
                                             float* __restrict__ reward_out,
                                             uint8_t* __restrict__ done_out, int p, int base,
                                             int n_envs) {
  const int e = base + sm.env_at[p];
  if (e >= n_envs) return;
  env_step_one(sm.slots[p], actions[e], ft, reward_out + e, done_out + e);
}

__device__ __forceinline__ void env_step_store(EnvStepSmem sm, int* __restrict__ cards_out,
                                               int* __restrict__ ints_out,
                                               uint32_t* __restrict__ rng_out, int t, int base,
                                               int n_envs) {
  if (base + t >= n_envs) return;
  store_state(sm.slots[sm.place[t]], cards_out, ints_out, rng_out, base + t, (size_t)n_envs);
}

// The second bound caps registers at 65,536 / (kEnvStepBlock x 14), so 72
// (K3a's shape's own count): with a second bound of 1 ptxas took 218, with
// 256 threads and none 64 with spills (PERF.md).
__global__ void __launch_bounds__(kEnvStepBlock, 14)
env_step_kernel(const int* __restrict__ cards_in, const int* __restrict__ ints_in,
                const uint32_t* __restrict__ rng_in, const int* __restrict__ actions,
                const float* __restrict__ ft, int* __restrict__ cards_out,
                int* __restrict__ ints_out, uint32_t* __restrict__ rng_out,
                float* __restrict__ reward_out, uint8_t* __restrict__ done_out, int n_envs) {
  const int t = threadIdx.x, base = blockIdx.x * kEnvStepBlock;
  const EnvStepSmem sm = env_step_smem_of(k3a_slots);
  env_step_classify(sm, ints_in, actions, t, base, n_envs);
  __syncthreads();
  env_step_place(sm, cards_in, ints_in, rng_in, t, base, n_envs);
  __syncthreads();
  env_step_run(sm, actions, ft, reward_out, done_out, t, base, n_envs);
  __syncthreads();
  env_step_store(sm, cards_out, ints_out, rng_out, t, base, n_envs);
}

// The engine's reset (the port's full_env.reset and autoreset): a fresh
// episode, written in place on the packed rows, for each env whose mask
// byte is set; kResetEnvs envs a block, in two phases split by
// __syncthreads:
// * shuffle: warp w writes env w's fresh episode into State slot w
//   (reset_slot), where the env is masked;
// * store: warp p < kStoreParts stores part p of the rows (store_part) of
//   the block's masked envs, lane l env l, so that a row's store is one
//   128-byte line.
// A block none of whose envs is masked returns at once. The episode's key
// is keys[e] where keys is given, else fold_in(key, step count) of the
// env's own rows.
static_assert(kResetEnvs == 32 && kStoreParts <= kResetEnvs, "a lane an env, a warp a part");

__device__ __forceinline__ TfKey reset_key(const int* __restrict__ ints,
                                           const uint32_t* __restrict__ rng,
                                           const uint32_t* __restrict__ keys, int e, size_t B) {
  if (keys) return {keys[2 * e], keys[2 * e + 1]};
  return tf_fold_in({rng[e], rng[B + e]}, (uint32_t)ints[(size_t)S_STEPC * B + e]);
}

__device__ __forceinline__ bool reset_masked(const uint8_t* __restrict__ mask, int e,
                                             int n_envs) {
  return e < n_envs && mask[e];
}

// A fresh episode with key `key` in slot s by one warp, over 64 sort keys
// v: each lane draws 2 of the words, the warp sorts them (sort64), each
// lane deals 2 deck slots, and lane 0 sets the other fields and the key.
// lanes(f) as in sort64.
template <typename Lanes>
__device__ void reset_slot(State& s, uint64_t* v, TfKey key, Lanes&& lanes) {
  const TfKey sub = engine_shuffle_key(key);
  lanes([&](int l) {
    v[l] = engine_deck_key(sub, l);
    v[l + 32] = engine_deck_key(sub, l + 32);
  });
  sort64(v, lanes);
  lanes([&](int l) {
    reset_deal(s, v, l);
    if (l != 0) return;
    reset_fields(s);
    s.key = key;
  });
}

// K3a's autoreset of the ended env in slot s by one warp: reset_state's
// fresh episode (the kernels' own shuffle, PARITY #B8, #B16, not the
// engine's), over 64 sort keys v. Each lane draws 2 of the 52 deck words
// and 12 pads, the warp sorts them (sort64), each lane deals 2 deck slots,
// and lane 0 sets the other fields and the key. The words differ in their
// low 6 bits, so the order is that of reset_state's network. Every lane
// reads the key and step count before the first lanes(f) returns, and lane
// 0 rewrites them only in the last. lanes(f) as in sort64.
template <typename Lanes>
__device__ void autoreset_slot(State& s, uint64_t* v, Lanes&& lanes) {
  const TfKey key = tf_fold_in(s.key, (uint32_t)s.sc);
  const TfKey dk = tf_fold_in(tf_fold_in(key, (uint32_t)ST_DECK), 0u);
  lanes([&](int l) {
    v[l] = deck_word(dk, l);
    v[l + 32] = l + 32 < 52 ? deck_word(dk, l + 32) : 0xFFFFFFFFu;
  });
  sort64(v, lanes);
  lanes([&](int l) {
    deal(s, l, (uint32_t)v[l]);
    deal(s, l + 32, (uint32_t)v[l + 32]);
    if (l != 0) return;
    reset_fields(s);
    s.key = key;
  });
}

struct ResetSmem {
  State slots[kResetEnvs];
  uint64_t keys[kResetEnvs][kDeck];
};

// The store phase's thread (part p, lane l): env base + l's part p, where
// the env is masked.
__device__ __forceinline__ void reset_store(const ResetSmem& sm, int p, int l,
                                            const uint8_t* __restrict__ mask,
                                            int* __restrict__ cards, int* __restrict__ ints,
                                            uint32_t* __restrict__ rng, int base, int n_envs) {
  if (p < kStoreParts && reset_masked(mask, base + l, n_envs))
    store_part(sm.slots[l], p, cards, ints, rng, base + l, (size_t)n_envs);
}

__global__ void __launch_bounds__(kResetEnvs * 32)
env_reset_kernel(int* __restrict__ cards, int* __restrict__ ints, uint32_t* __restrict__ rng,
                 const uint8_t* __restrict__ mask, const uint32_t* __restrict__ keys,
                 int n_envs) {
  __shared__ ResetSmem sm;
  const int w = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int base = blockIdx.x * kResetEnvs, e = base + w;
  const bool masked = reset_masked(mask, e, n_envs);
  if (!__syncthreads_or(masked)) return;
  if (masked)
    reset_slot(sm.slots[w], sm.keys[w], reset_key(ints, rng, keys, e, (size_t)n_envs),
               [&](auto f) {
                 f(lane);
                 __syncwarp();
               });
  __syncthreads();
  reset_store(sm, w, lane, mask, cards, ints, rng, base, n_envs);
}

// K3a: one fed step with its autoreset, then the packed state, reward, done
// and the observation and mask rows of the post-step state. kEnvStepBlock
// envs a block and kStepJobs threads an env (kStepThreads), in six phases
// split by __syncthreads:
// * classify: env_step_kernel's, threads t < kEnvStepBlock;
// * place: thread t < kEnvStepBlock finds env t's place, as env_step_place;
// * load: thread (job j, env i) loads part j of env i's rows into the slot
//   of its place (load_part), with load_state's expressions;
// * run: thread p < kEnvStepBlock fills slot p's hand from its deck
//   (load_hand, load_state's last loop) and steps it as env_step_kernel does
//   (the step without its autoreset, the shop generation joined);
// * reset: warp w gives each ended env of the places p = w (mod kStepWarps)
//   a fresh episode (autoreset_slot) with its 64 sort keys;
// * store: thread (job j, env i) stores part j of env i's rows, its state
//   (store_cards, store_ints, store_rng), observation and mask.
// Thread t is job t / kEnvStepBlock of env t % kEnvStepBlock, so a warp's
// lanes load or store one row of 32 neighbouring envs.
// Its dynamic shared memory (kStepSmem): env_step_kernel's, then each
// warp's sort keys.
constexpr int kStepJobs = 4, kStepThreads = kEnvStepBlock * kStepJobs;
constexpr int kStepWarps = kStepThreads / 32;
constexpr size_t kStepSmem = kEnvStepSmem + kStepWarps * kDeck * sizeof(uint64_t);
static_assert(kEnvStepSmem % alignof(uint64_t) == 0, "the sort keys are aligned");
static_assert(kStepSmem <= 232448, "a block's shared memory, 227 KB");

struct PolicyStepSmem {
  EnvStepSmem env;
  uint64_t* keys;    // warp w's 64 at keys + w * kDeck
};

__device__ __forceinline__ PolicyStepSmem policy_step_smem_of(unsigned char* base) {
  return {env_step_smem_of(base), reinterpret_cast<uint64_t*>(base + kEnvStepSmem)};
}

__device__ __forceinline__ void policy_step_place(EnvStepSmem sm, int t) {
  if (t >= kEnvStepBlock) return;
  const int p = env_step_place_of(sm.cls, t, kEnvStepBlock);
  sm.place[t] = (int16_t)p;
  sm.env_at[p] = (int16_t)t;
}

// Part j of env e's packed rows into State s, with load_state's expressions:
// the deck's card channels 0-1, 2-3, channel 4 and the alive set, then the
// int and rng rows. The hand's channels and in-hand set are load_hand's.
__device__ void load_part(State& s, int j, const int* __restrict__ cards_in,
                          const int* __restrict__ ints_in, const uint32_t* __restrict__ rng_in,
                          int e, size_t B) {
#define CARD(c, d) cards_in[(size_t)((c) * kDeck + (d)) * B + e]
  if (j == 0) {
    for (int d = 0; d < kDeck; ++d) {
      s.rk[d] = CARD(0, d);
      s.su[d] = CARD(1, d);
    }
    return;
  }
  if (j == 1) {
    for (int d = 0; d < kDeck; ++d) {
      s.en[d] = CARD(2, d);
      s.ed[d] = CARD(3, d);
    }
    return;
  }
  if (j == 2) {
    uint64_t al = 0;
    for (int d = 0; d < kDeck; ++d) {
      s.sl[d] = CARD(4, d);
      if (CARD(5, d) != 0) al |= 1ull << d;
    }
    s.al = al;
    return;
  }
#undef CARD
#define IN(r) ints_in[(size_t)(r) * B + e]
  uint32_t sel = 0, fd = 0, high = 0;
  for (int p = 0; p < kHand; ++p) {
    s.hidx[p] = IN(R_HIDX + p);
    sel |= (uint32_t)(IN(R_SEL + p) != 0) << p;
    fd |= (uint32_t)(IN(R_FD + p) != 0) << p;
    high |= (uint32_t)(IN(R_HIGH + p) != 0) << p;
  }
  s.sel = sel;
  s.fd = fd;
  s.high = high;
  for (int i = 0; i < kJok; ++i) s.jok[i] = IN(R_JOK + i);
  for (int i = 0; i < kCons; ++i) s.cons[i] = IN(R_CONS + i);
  for (int r = 0; r < kShop; ++r) {
    s.sty[r] = IN(R_STY + r);
    s.sit[r] = IN(R_SIT + r);
    s.sco[r] = IN(R_SCO + r);
  }
  for (int h = 0; h < kLvl; ++h) {
    s.lvl[h] = IN(R_LVL + h);
    s.pc[h] = IN(R_PC + h);
  }
  s.hn = IN(S_HN); s.jn = IN(S_JN); s.green = IN(S_GREEN); s.bus = IN(S_BUS);
  s.cn = IN(S_CN); s.vou = IN(S_VOU); s.jslots = IN(S_JSLOTS); s.cslots = IN(S_CSLOTS);
  s.ante = IN(S_ANTE); s.round = IN(S_ROUND); s.phase = IN(S_PHASE); s.need = IN(S_NEED);
  s.career = IN(S_CAREER); s.rchips = IN(S_RCHIPS); s.best = IN(S_BEST);
  s.money = IN(S_MONEY); s.hl = IN(S_HL); s.dl = IN(S_DL); s.hsize = IN(S_HSIZE);
  s.sn = IN(S_SN); s.rbase = IN(S_RBASE); s.rcost = IN(S_RCOST); s.bid = IN(S_BID);
  s.btypes = IN(S_BTYPES); s.bverd = IN(S_BVERD); s.hpt = IN(S_HPT); s.hpa = IN(S_HPA);
  s.jsold = IN(S_JSOLD); s.sc = IN(S_STEPC);
  s.bact = IN(S_BACT) != 0;
  s.bfirst = IN(S_BFIRST) != 0;
  s.done = IN(S_DONE) != 0;
  s.bp = (uint64_t)(uint32_t)IN(S_BPLO) | ((uint64_t)(uint32_t)IN(S_BPHI) << 32);
#undef IN
  s.key.k0 = rng_in[e];
  s.key.k1 = rng_in[B + e];
  for (int k = 0; k < kCtr; ++k) s.ctr[k] = rng_in[(size_t)(2 + k) * B + e];
}

// The hand's channels from the deck and the in-hand set: load_state's last
// loop, once every part of the env is in s.
__device__ __forceinline__ void load_hand(State& s) {
  s.ih = 0;
  for (int p = 0; p < kHand; ++p) {
    const int h = s.hidx[p];
    const bool held = p < s.hn && h >= 0;
    const bool in_deck = held && h < kDeck;
    s.hrk[p] = in_deck ? s.rk[h] : 0;
    s.hsu[p] = in_deck ? s.su[h] : 0;
    s.hen[p] = in_deck ? s.en[h] : 0;
    s.hed[p] = in_deck ? s.ed[h] : 0;
    s.hsl[p] = in_deck ? s.sl[h] : 0;
    if (held) s.ih |= 1ull << clampi(h, 0, kDeck - 1);
  }
}

__device__ __forceinline__ void policy_step_load(EnvStepSmem sm, const int* __restrict__ cards_in,
                                                 const int* __restrict__ ints_in,
                                                 const uint32_t* __restrict__ rng_in, int t,
                                                 int base, int n_envs) {
  const int i = t % kEnvStepBlock, e = base + i;
  if (e < n_envs)
    load_part(sm.slots[sm.place[i]], t / kEnvStepBlock, cards_in, ints_in, rng_in, e,
              (size_t)n_envs);
}

__device__ __forceinline__ void policy_step_run(EnvStepSmem sm, const int* __restrict__ actions,
                                                const float* __restrict__ ft,
                                                float* __restrict__ reward_out,
                                                uint8_t* __restrict__ done_out, int p, int base,
                                                int n_envs) {
  if (p >= kEnvStepBlock || base + sm.env_at[p] >= n_envs) return;
  load_hand(sm.slots[p]);
  env_step_run(sm, actions, ft, reward_out, done_out, p, base, n_envs);
}

// Warp w's share of the reset phase; lanes(f) as in sort64. Every lane of
// the warp reads the same slots, so the warp takes its places together.
template <typename Lanes>
__device__ void policy_step_reset(PolicyStepSmem sm, int w, int base, int n_envs,
                                  Lanes&& lanes) {
  for (int p = w; p < kEnvStepBlock; p += kStepWarps)
    if (base + sm.env.env_at[p] < n_envs && sm.env.slots[p].done)
      autoreset_slot(sm.env.slots[p], sm.keys + w * kDeck, lanes);
}

__device__ __forceinline__ void policy_step_store(EnvStepSmem sm, int* __restrict__ cards_out,
                                                  int* __restrict__ ints_out,
                                                  uint32_t* __restrict__ rng_out,
                                                  float* __restrict__ obs,
                                                  uint8_t* __restrict__ mask, int t, int base,
                                                  int n_envs) {
  const int i = t % kEnvStepBlock, e = base + i;
  if (e >= n_envs) return;
  const size_t B = (size_t)n_envs;
  const State& s = sm.slots[sm.place[i]];
  switch (t / kEnvStepBlock) {
    case 0: store_cards(s, cards_out, e, B, 0, kDeck / 2); break;
    case 1: store_cards(s, cards_out, e, B, kDeck / 2, kDeck); break;
    case 2:
      store_ints(s, ints_out, e, B);
      store_rng(s, rng_out, e, B);
      write_mask(s, mask, e, B);
      break;
    default: write_obs(s, obs, e, B);
  }
}

__global__ void __launch_bounds__(kStepThreads)
policy_step_kernel(const int* __restrict__ cards_in, const int* __restrict__ ints_in,
                   const uint32_t* __restrict__ rng_in, const int* __restrict__ actions,
                   const float* __restrict__ ft, int* __restrict__ cards_out,
                   int* __restrict__ ints_out, uint32_t* __restrict__ rng_out,
                   float* __restrict__ reward_out, uint8_t* __restrict__ done_out,
                   float* __restrict__ obs, uint8_t* __restrict__ mask, int n_envs) {
  const int t = threadIdx.x, base = blockIdx.x * kEnvStepBlock;
  const PolicyStepSmem sm = policy_step_smem_of(k3a_slots);
  if (t < kEnvStepBlock) env_step_classify(sm.env, ints_in, actions, t, base, n_envs);
  __syncthreads();
  policy_step_place(sm.env, t);
  __syncthreads();
  policy_step_load(sm.env, cards_in, ints_in, rng_in, t, base, n_envs);
  __syncthreads();
  policy_step_run(sm.env, actions, ft, reward_out, done_out, t, base, n_envs);
  __syncthreads();
  const int lane = t % 32;
  policy_step_reset(sm, t / 32, base, n_envs, [&](auto f) {
    f(lane);
    __syncwarp();
  });
  __syncthreads();
  policy_step_store(sm.env, cards_out, ints_out, rng_out, obs, mask, t, base, n_envs);
}

// The sampler's shared memory: the logits and the Gumbel noise of action a
// of lane l at [a * kPitch + l], and each thread's partials.
struct SampleSmem {
  float logit[kActions * kPitch], noise[kActions * kPitch];
  float best[kSampleGroups][kSampleEnvs], mx[kSampleGroups][kSampleEnvs];
  float sum[kSampleGroups][kSampleEnvs];
  int arg[kSampleGroups][kSampleEnvs];
};

// The sampler's phases for thread (lane l, warp g) of the block of envs from
// `base`, over logits[e * s_env + a * s_act] (the policy's [B, 60] output in
// whatever layout its last matmul left) with key (k0, k1); the thread's
// actions are a = g + i * kSampleGroups.
// Stage: the thread's share of the block's logits copied asynchronously (envs
// fastest where their stride is the smaller, else actions), and, while they
// travel, the Gumbel noise of its own actions.
__device__ void sample_stage(SampleSmem& sm, const float* __restrict__ logits, int64_t s_env,
                             int64_t s_act, int l, int g, int base, int n_envs, uint32_t k0,
                             uint32_t k1) {
  const int envs = min(kSampleEnvs, n_envs - base);
  const bool env_fast = s_env <= s_act;
  for (int i = g * kSampleEnvs + l; i < kActions * kSampleEnvs; i += kSampleBlock) {
    const int a = env_fast ? i / kSampleEnvs : i % kActions;
    const int m = env_fast ? i % kSampleEnvs : i / kActions;
    if (m < envs) copy_async4(&sm.logit[a * kPitch + m], &logits[(base + m) * s_env + a * s_act]);
  }
  const int e = base + l;
  if (e < n_envs) {
#pragma unroll
    for (int i = 0; i < kPerThread; ++i) {
      const int a = g + i * kSampleGroups;
      const uint32_t bits = random_bits32(k0, k1, (uint32_t)a * (uint32_t)n_envs + (uint32_t)e);
      // uniform(minval=tiny, maxval=1): f * (1 - tiny) + tiny, at least tiny
      const float u = fmaxf(FLT_MIN, fadd(fmul(tf_uniform_f32(bits), 1.f), FLT_MIN));
      sm.noise[a * kPitch + l] = -logf(-logf(u));
    }
  }
  copy_async_wait();
}

// Partials: the best Gumbel-perturbed logit of the thread's actions (the
// lowest action among equal ones) and their largest logit.
__device__ void sample_partials(SampleSmem& sm, int l, int g, int base, int n_envs) {
  if (base + l >= n_envs) return;
  float best = -INFINITY, mx = -INFINITY;
  int arg = g;
#pragma unroll
  for (int i = 0; i < kPerThread; ++i) {
    const int a = g + i * kSampleGroups;
    const float la = sm.logit[a * kPitch + l];
    const float v = fadd(la, sm.noise[a * kPitch + l]);
    if (v > best) {
      best = v;
      arg = a;
    }
    mx = fmaxf(mx, la);
  }
  sm.best[g][l] = best;
  sm.arg[g][l] = arg;
  sm.mx[g][l] = mx;
}

__device__ __forceinline__ float sample_max(const SampleSmem& sm, int l) {
  float mx = sm.mx[0][l];
  for (int h = 1; h < kSampleGroups; ++h) mx = fmaxf(mx, sm.mx[h][l]);
  return mx;
}

// Sums: expf(logit - max) over the thread's actions.
__device__ void sample_sums(SampleSmem& sm, int l, int g, int base, int n_envs) {
  if (base + l >= n_envs) return;
  const float mx = sample_max(sm, l);
  float sum = 0.f;
#pragma unroll
  for (int i = 0; i < kPerThread; ++i)
    sum = fadd(sum, expf(fsub(sm.logit[(g + i * kSampleGroups) * kPitch + l], mx)));
  sm.sum[g][l] = sum;
}

// Write: warp 0 combines the groups in group order and writes env base + l's
// action and log-softmax.
__device__ void sample_write(const SampleSmem& sm, int l, int g, int base, int n_envs,
                             int* __restrict__ action, float* __restrict__ log_prob) {
  const int e = base + l;
  if (g != 0 || e >= n_envs) return;
  float best = sm.best[0][l], sum = sm.sum[0][l];
  int arg = sm.arg[0][l];
  for (int h = 1; h < kSampleGroups; ++h) {
    const float v = sm.best[h][l];
    const int a = sm.arg[h][l];
    if (v > best || (v == best && a < arg)) {
      best = v;
      arg = a;
    }
    sum = fadd(sum, sm.sum[h][l]);
  }
  action[e] = arg;
  log_prob[e] = fsub(fsub(sm.logit[arg * kPitch + l], sample_max(sm, l)), logf(sum));
}

// The sampler. The step's key is read on the card from key[0], key[1], so
// that a CUDA graph replays the launch with the words the card holds then.
__global__ void __launch_bounds__(kSampleBlock)
policy_sample_kernel(const float* __restrict__ logits, int64_t s_env, int64_t s_act,
                     int n_envs, const uint32_t* __restrict__ key, int* __restrict__ action,
                     float* __restrict__ log_prob) {
  __shared__ SampleSmem sm;
  const int l = threadIdx.x % kSampleEnvs, g = threadIdx.x / kSampleEnvs;
  const int base = blockIdx.x * kSampleEnvs;
  sample_stage(sm, logits, s_env, s_act, l, g, base, n_envs, key[0], key[1]);
  __syncthreads();
  sample_partials(sm, l, g, base, n_envs);
  __syncthreads();
  sample_sums(sm, l, g, base, n_envs);
  __syncthreads();
  sample_write(sm, l, g, base, n_envs, action, log_prob);
}

}  // namespace

#ifndef FULL_ROLLOUT_HOST_SHIM
// Each launcher runs its kernel on ``stream`` and returns the launch's
// cudaError_t. The packed state is cards [384, n_envs] i32, ints [132,
// n_envs] i32 and rng [18, n_envs] u32; observation rows [189, n_envs] f32
// and mask rows [60, n_envs] u8 are written feature-major. Outputs are
// allocated by the caller.

// A kernel's launch shape and what the compiler gave it: out[0] threads a
// block, out[1] shared bytes a block (dynamic and static), out[2] registers
// a thread, out[3] local (stack) bytes a thread.
template <typename Kernel>
static int kernel_info(Kernel kernel, int block, size_t dynamic_smem, int* out) {
  cudaFuncAttributes a;
  const cudaError_t err = cudaFuncGetAttributes(&a, kernel);
  if (err != cudaSuccess) return (int)err;
  out[0] = block;
  out[1] = (int)(dynamic_smem + a.sharedSizeBytes);
  out[2] = a.numRegs;
  out[3] = (int)a.localSizeBytes;
  return (int)cudaSuccess;
}

// K3b: observation and mask of a packed state.
extern "C" int policy_observe_launch(const int* cards, const int* ints, const unsigned int* rng,
                                     float* obs, unsigned char* mask, int n_envs,
                                     void* stream) {
  if (n_envs <= 0) return (int)cudaSuccess;
  policy_observe_kernel<<<(n_envs + kObserveEnvs - 1) / kObserveEnvs, kObserveBlock, 0,
                          (cudaStream_t)stream>>>(cards, ints, rng, obs, mask, n_envs);
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
  policy_step_kernel<<<(n_envs + kEnvStepBlock - 1) / kEnvStepBlock, kStepThreads, kStepSmem,
                       (cudaStream_t)stream>>>(cards_in, ints_in, rng_in, actions, ftab,
                                               cards_out, ints_out, rng_out, reward, done,
                                               obs, mask, n_envs);
  return (int)cudaGetLastError();
}

// The engine's step: one fed step without autoreset, then the packed state,
// reward [n_envs] f32 and done [n_envs] u8 (arguments as policy_step_launch's),
// kEnvStepBlock envs a block. The kernel's shared-memory limit is set on
// the first launch on each device.
extern "C" int env_step_launch(const int* cards_in, const int* ints_in,
                               const unsigned int* rng_in, const int* actions,
                               const float* ftab, int* cards_out, int* ints_out,
                               unsigned int* rng_out, float* reward, unsigned char* done,
                               int n_envs, void* stream) {
  if (n_envs <= 0) return (int)cudaSuccess;
  static bool ready[64] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev < 0 || dev >= 64) return (int)cudaErrorInvalidDevice;
  if (!ready[dev]) {
    err = cudaFuncSetAttribute(env_step_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)kEnvStepSmem);
    if (err != cudaSuccess) return (int)err;
    ready[dev] = true;
  }
  env_step_kernel<<<(n_envs + kEnvStepBlock - 1) / kEnvStepBlock, kEnvStepBlock, kEnvStepSmem,
                    (cudaStream_t)stream>>>(cards_in, ints_in, rng_in, actions, ftab, cards_out,
                                            ints_out, rng_out, reward, done, n_envs);
  return (int)cudaGetLastError();
}

// The engine's reset: a fresh episode written in place on the packed rows
// (cards, ints, rng as above) of each env whose mask [n_envs] u8 byte is
// set, from keys [n_envs, 2] u32 where given, else from each env's own key
// and step count.
extern "C" int env_reset_launch(int* cards, int* ints, unsigned int* rng,
                                const unsigned char* mask, const unsigned int* keys,
                                int n_envs, void* stream) {
  if (n_envs <= 0) return (int)cudaSuccess;
  env_reset_kernel<<<(n_envs + kResetEnvs - 1) / kResetEnvs, kResetEnvs * 32, 0,
                     (cudaStream_t)stream>>>(cards, ints, rng, mask, keys, n_envs);
  return (int)cudaGetLastError();
}

// The sampler: logits [n_envs, 60] f32 with element strides (s_env, s_act)
// -> action [n_envs] i32, log_prob [n_envs] f32; the step's key is read on
// the card from key[0], key[1] (u32), so that a CUDA graph can replay the
// launch with new words.
extern "C" int policy_sample_key_launch(const float* logits, long long s_env, long long s_act,
                                        int n_envs, const unsigned int* key, int* action,
                                        float* log_prob, void* stream) {
  if (n_envs <= 0) return (int)cudaSuccess;
  policy_sample_kernel<<<(n_envs + kSampleEnvs - 1) / kSampleEnvs, kSampleBlock, 0,
                         (cudaStream_t)stream>>>(logits, s_env, s_act, n_envs, key, action,
                                                 log_prob);
  return (int)cudaGetLastError();
}

// Each kernel's launch shape (kernel_info's out[4]).
extern "C" int policy_step_info(int* out) {
  return kernel_info(policy_step_kernel, kStepThreads, kStepSmem, out);
}
extern "C" int env_step_info(int* out) {
  return kernel_info(env_step_kernel, kEnvStepBlock, kEnvStepSmem, out);
}
extern "C" int env_reset_info(int* out) {
  return kernel_info(env_reset_kernel, kResetEnvs * 32, 0, out);
}
extern "C" int policy_observe_info(int* out) {
  return kernel_info(policy_observe_kernel, kObserveBlock, 0, out);
}
extern "C" int policy_sample_info(int* out) {
  return kernel_info(policy_sample_kernel, kSampleBlock, 0, out);
}
#endif
