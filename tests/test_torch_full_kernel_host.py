"""The CUDA sources of the flagship-env kernels, compiled as host C++,
against their plain versions, on the CPU.

There is no nvcc here, so the kernels' logic is checked by compiling
csrc/fused_full_rollout.cu (K2) and csrc/fused_policy_rollout.cu (K3a, K3b
and the sampler) with g++ through a small shim: the CUDA
qualifiers become plain C++, the float intrinsics become the same IEEE
operations (``-ffp-contract=off`` keeps multiplies and adds apart, as the
``_rn`` intrinsics do on the card), ``__float2int_rz`` saturates as the
card's conversion does, and the threads run one after another; for K3b
and the sampler, whose threads share an env through shared memory, block
by block, each phase of the kernel (the code between two ``__syncthreads``)
for every thread of the block before the next. A field that a kernel
failed to set would show: the build fills every uninitialised local (K2's
State) with a junk pattern (``-ftrivial-auto-var-init=pattern``), and the
shared memory of K3a, K3b and the sampler is a host array filled with a
junk pattern before each thread (K3a) or block runs. What this cannot check (the build
for sm_90a, the launch, local and shared memory, ``logf`` of the card's
math library) is checked on the card by
tests/test_torch_full_rollout_cuda.py, tests/test_torch_policy_rollout_cuda.py and
chip_smoke.py. The tables and
ids that the kernel source spells out are read from it and held equal to
the port's.

Tolerance: none, except where the host's math library and torch's CPU
one may differ in the last bit: rewards (their ``log`` term) compare
within 1e-4, the observation's ``log1p`` row within 1 ulp, and a sampled
action may differ only where the two largest Gumbel-perturbed logits lie
within 1e-5 (the draw's ``log``); every other output bit for bit.
"""
import ctypes
import re
import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch

from balatro_gym_tpu_torch.core import rng as R
from balatro_gym_tpu_torch.core.constants import (
    BASE_HAND_CHIPS, BASE_HAND_MULT, PLANET_HAND, Phase, _blind_chips)
from balatro_gym_tpu_torch.engine import consumable_logic as CL
from balatro_gym_tpu_torch.engine import full_env as FE
from balatro_gym_tpu_torch.engine import shop_logic as SL
from balatro_gym_tpu_torch.ops import boss as BB
from balatro_gym_tpu_torch.ops import fused_full_battery as BAT
from balatro_gym_tpu_torch.ops import fused_full_rollout as F
from balatro_gym_tpu_torch.ops import fused_policy_rollout as FP
from balatro_gym_tpu_torch.ops import joker_tables as JT
from balatro_gym_tpu_torch.ops import kernel_rng as KR
from balatro_gym_tpu_torch.train.networks import ActorCritic

CSRC = Path(F.__file__).resolve().parents[1] / "csrc"


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """This module's torch ops are many and small: one intra-op thread per
    test worker keeps parallel workers from oversubscribing the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

SHIM = r"""
#pragma once
#include <algorithm>
#include <climits>
#include <cmath>
#include <cstdint>
#include <cstring>
#define __device__
#define __global__
#define __forceinline__ inline
#define __noinline__ __attribute__((noinline))
#define __constant__ static const
#define __launch_bounds__(...)
#define __restrict__
#define __shared__
#define __align__(n) __attribute__((aligned(n)))
using std::max;
using std::min;
struct Dim3 { int x; };
static Dim3 blockIdx, threadIdx;
inline float __fmul_rn(float a, float b) { return a * b; }
inline float __fadd_rn(float a, float b) { return a + b; }
inline float __fsub_rn(float a, float b) { return a - b; }
inline float __fdiv_rn(float a, float b) { return a / b; }
inline float __uint_as_float(uint32_t u) { float f; memcpy(&f, &u, 4); return f; }
inline float __int_as_float(int i) { float f; memcpy(&f, &i, 4); return f; }
struct __attribute__((aligned(16))) int4 { int x, y, z, w; };
struct __attribute__((aligned(16))) float4 { float x, y, z, w; };
struct __attribute__((aligned(8))) uint2 { uint32_t x, y; };
inline float4 make_float4(float x, float y, float z, float w) { return {x, y, z, w}; }
inline int __float2int_rz(float x) {
  if (std::isnan(x)) return 0;
  if (x >= 2147483648.f) return INT_MAX;
  if (x <= -2147483648.f) return INT_MIN;
  return (int)x;
}
inline int __popc(uint32_t x) { return __builtin_popcount(x); }
inline int __clz(uint32_t x) { return x ? __builtin_clz(x) : 32; }
inline int __popcll(uint64_t x) { return __builtin_popcountll(x); }
inline int __ffs(uint32_t x) { return __builtin_ffs((int)x); }
inline int __ffsll(uint64_t x) { return __builtin_ffsll((long long)x); }
// A block's threads run phase by phase (see POLICY_LAUNCH), so a barrier is
// nothing, and an asynchronous copy into shared memory is a plain one. The
// launch file runs the phases of a kernel that votes over its block
// (__syncthreads_or) itself and never calls the kernel.
inline void __syncthreads() {}
inline int __syncthreads_or(int p) { return p; }
inline void __syncwarp() {}
inline void copy_async4(void* dst, const void* src) { memcpy(dst, src, 4); }
inline void copy_async_wait() {}
"""

HOST_LAUNCH = r"""
#define FULL_ROLLOUT_HOST_SHIM
#include "shim.h"
#include "fused_full_rollout.cu"
extern "C" void host_launch(const int* ci, const int* ii, const uint32_t* ri, const int* act,
                            const float* ft, int* co, int* io, uint32_t* ro, float* rw,
                            int* ep, int n, int steps, int use, uint32_t k0, uint32_t k1) {
  for (int e = 0; e < n; ++e) {
    blockIdx.x = e / kRolloutBlock;
    threadIdx.x = e % kRolloutBlock;
    fused_full_rollout_kernel(ci, ii, ri, act, ft, co, io, ro, rw, ep, n, steps, use, k0, k1);
  }
}
"""


def _cuda_source():
    """The kernel's source with the step header it includes."""
    return "\n".join((CSRC / f).read_text() for f in ("fused_full_rollout.cu", "full_step.cuh"))


def _constant_table(name):
    m = re.search(r"__constant__ int %s\[\w+\] = \{([^}]*)\};" % name, _cuda_source())
    assert m, name
    return [int(v) for v in m.group(1).replace("\n", " ").split(",")]


def _enum_values():
    """name -> value of every ``enum { ... }`` member in the kernel source."""
    out = {}
    for body in re.findall(r"enum\s*\{(.*?)\};", _cuda_source(), re.S):
        nxt = 0
        for item in re.sub(r"//[^\n]*", "", body).split(","):
            item = item.strip()
            if not item:
                continue
            name, _, val = (x.strip() for x in item.partition("="))
            nxt = int(val, 0) if val else nxt
            out[name] = nxt
            nxt += 1
    return out


@pytest.mark.parametrize("name,table", [
    ("c_base_chips", BASE_HAND_CHIPS), ("c_base_mult", BASE_HAND_MULT),
    ("c_blind", _blind_chips), ("c_planet_obs", FE.PLANET_OBS_OF_HAND),
    ("c_planet_hand", PLANET_HAND), ("c_enh_tarot", CL.ENH_TAROT),
    ("c_enh_count", CL.ENH_COUNT), ("c_wraith", CL.WRAITH_JOKERS),
    ("c_soul", CL.SOUL_JOKERS), ("c_editions3", CL.EDITIONS3),
    ("c_enh_pool7", CL.ENH_POOL7), ("c_pack_costs", SL.PACK_COSTS),
    ("c_voucher_costs", SL.VOUCHER_COSTS), ("c_jcost", JT.JOKER_BASE_COST_NP)])
def test_kernel_constant_tables_equal_port_tables(name, table):
    assert _constant_table(name) == np.asarray(table).ravel().tolist()


def test_kernel_ids_equal_port_ids():
    """The kernel's row map, stream, phase, boss and consumable ids."""
    ids = _enum_values()
    want = {n: getattr(F, n) for n in ids if n.startswith(("R_", "S_"))}
    want.update(ST_DECK=R.STREAM_ID["deck_shuffle"], ST_SHOP_GEN=R.STREAM_ID["shop_generation"],
                ST_SHOP_REROLL=R.STREAM_ID["shop_reroll"],
                ST_JOKER_EFFECTS=R.STREAM_ID["joker_effects"],
                ST_BOSS=R.STREAM_ID["boss_abilities"],
                ST_CARD_ENH=R.STREAM_ID["card_enhancement"],
                ST_SEAL=R.STREAM_ID["seal_applications"],
                ST_CONSUMABLE=R.STREAM_ID["consumable_effects"],
                PH_PLAY=int(Phase.PLAY), PH_SHOP=int(Phase.SHOP),
                PH_BLIND=int(Phase.BLIND_SELECT), IT_PACK=SL.IT_PACK, IT_CARD=SL.IT_CARD,
                IT_JOKER=SL.IT_JOKER, IT_VOUCHER=SL.IT_VOUCHER, N_BOSS=BB.N_BOSS,
                C_PLANET_BASE=CL.PLANET_BASE, C_ENUMNAME_OFFSET=CL.ENUMNAME_OFFSET)
    want.update({n: getattr(BB, n[2:]) for n in ids if n.startswith("B_")})
    want.update({n: getattr(CL, n[2:]) for n in ids
                 if n.startswith("C_") and n not in want})
    assert len(want) > 100
    assert {n: ids[n] for n in want} == want


def _compile(tmp_path_factory, launch_source):
    """A host build of a kernel source through the shim, loaded."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to compile the kernel source as host C++")
    d = tmp_path_factory.mktemp("host_kernel")
    (d / "shim.h").write_text(SHIM)
    (d / "host_launch.cpp").write_text(launch_source)
    lib = d / "libhost.so"
    subprocess.run([gxx, "-std=c++17", "-O1", "-ffp-contract=off", "-fPIC", "-shared",
                    "-ftrivial-auto-var-init=pattern", f"-I{CSRC}", "-o", str(lib),
                    str(d / "host_launch.cpp")],
                   check=True, capture_output=True, text=True)
    return ctypes.CDLL(str(lib))


@pytest.fixture(scope="module")
def host_kernel(tmp_path_factory):
    so = _compile(tmp_path_factory, HOST_LAUNCH)
    so.host_launch.argtypes = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 3 + [ctypes.c_uint] * 2

    def run(packed, actions, seed, n_steps):
        B = packed["ints"].shape[1]
        out = {k: torch.empty_like(v) for k, v in packed.items()}
        tot, epi = torch.empty(B), torch.empty(B, dtype=torch.int32)
        so.host_launch(packed["cards"].data_ptr(), packed["ints"].data_ptr(),
                       packed["rng"].data_ptr(),
                       actions.data_ptr() if actions is not None else None,
                       F.float_tables("cpu").data_ptr(), out["cards"].data_ptr(),
                       out["ints"].data_ptr(), out["rng"].data_ptr(), tot.data_ptr(),
                       epi.data_ptr(), B, n_steps, int(actions is not None), 0,
                       seed & 0xFFFFFFFF)
        return out, tot, epi
    return run


def _compare(host_kernel, packed, actions, seed, n_steps):
    want = F._reference_packed(packed, actions, seed, n_steps)
    got = host_kernel(packed, actions, seed, n_steps)
    for k in ("cards", "ints", "rng"):
        bad = torch.nonzero(got[0][k] != want[0][k])
        assert len(bad) == 0, f"{k} differs at {bad[:5].tolist()}"
    assert torch.equal(got[2], want[2])
    np.testing.assert_allclose(got[1].numpy(), want[1].numpy(), rtol=0, atol=1e-4)
    return int(want[2].sum())


def test_host_kernel_sampled(host_kernel):
    packed = F.pack_full_state(F.default_reset(3, 512, "cpu"))
    episodes = _compare(host_kernel, packed, None, 3, 40)
    assert episodes > 0


def _legal_script(st, n_steps, rng):
    """An ``n_steps`` coverage-biased legal script from ``st``, made by
    stepping the plain version."""
    s, script = st, []
    for _ in range(n_steps):
        a = BAT.sample_legal(F.legal_mask(s).numpy(), rng)
        script.append(a)
        s = F.rollout_full_fused(0, len(a), 1, actions=a[None], init_state=s,
                                device="cpu")["state"]
    return np.stack(script)


def _battery(n, n_steps, rng):
    """A diversified state of ``n`` envs and a legal script from it."""
    st = BAT.surgery(F.rollout_full_fused(5, n, 4, device="cpu")["state"], rng)
    return st, _legal_script(st, n_steps, rng)


def test_host_kernel_fed_battery(host_kernel):
    st, script = _battery(512, 24, np.random.default_rng(1))
    assert all(v > 0 for v in BAT.coverage(script).values()), BAT.coverage(script)
    _compare(host_kernel, F.pack_full_state(st), torch.as_tensor(script), 0, len(script))


@pytest.mark.parametrize("mode", ("sampled", "fed"))
@pytest.mark.parametrize("n", (1, 31, 33, 257))
def test_host_kernel_partial_blocks(host_kernel, n, mode):
    """K2 at env counts that leave a partial block of its 64 threads (and
    blocks past the first): 16 sampled steps from the default reset, or 8
    fed legal steps from a diversified state."""
    if mode == "sampled":
        _compare(host_kernel, F.pack_full_state(F.default_reset(n, n, "cpu")), None, n, 16)
    else:
        st, script = _battery(n, 8, np.random.default_rng(n))
        _compare(host_kernel, F.pack_full_state(st), torch.as_tensor(script), 0, len(script))


def _extreme_cards(n):
    """A mid-game batch whose card channels take their extreme legal values
    (the State keeps them as bytes): alive odd slots rank 14, suit 3,
    enhancement 8, edition 4, seal 4; alive even slots rank 2 and 0 in the
    other channels; dead slots 0 in every channel."""
    st = F.rollout_full_fused(9, n, 6, device="cpu")["state"]
    odd = (torch.arange(64) % 2 == 1).expand(n, 64)
    for name, hi, lo in (("card_rank", 14, 2), ("card_suit", 3, 0), ("card_enh", 8, 0),
                         ("card_ed", 4, 0), ("card_seal", 4, 0)):
        v = torch.where(odd, hi, lo).to(torch.int32)
        setattr(st, name, torch.where(st.card_alive, v, 0).to(torch.int32))
    assert int(st.card_alive.sum()) < 64 * n and bool((st.phase == 0).any())
    return st


@pytest.mark.parametrize("kernel", ("K2", "K3a"))
def test_host_kernels_extreme_card_values(request, kernel):
    """K2 and K3a on the extreme card channels, 4 fed legal steps, against
    the plain version."""
    st, rng = _extreme_cards(96), np.random.default_rng(4)
    packed = F.pack_full_state(st)
    if kernel == "K2":
        _compare(request.getfixturevalue("host_kernel"), packed,
                 torch.as_tensor(_legal_script(st, 4, rng)), 0, 4)
        return
    _, step, _ = request.getfixturevalue("host_policy")
    for t in range(4):
        a = torch.as_tensor(BAT.sample_legal(F._legal_rows(F._load(packed)).T.numpy(), rng))
        ref = FP.step_rows_reference(packed, a)
        assert_step_equal(step(packed, a.to(torch.int32)), ref, f"extreme step {t}")
        packed = ref[0]


# ---------------------------------------------------------------------------
# The policy-collection kernels (csrc/fused_policy_rollout.cu)
# ---------------------------------------------------------------------------

POLICY_LAUNCH = r"""
#define FULL_ROLLOUT_HOST_SHIM
#include "shim.h"
#include "fused_policy_rollout.cu"
namespace {
__attribute__((aligned(16))) unsigned char k3a_slots[kStepSmem];
State observe_slots[kObserveEnvs];
SampleSmem sample_smem;
}
// One warp's lanes, in turn: the host's form of a warp's phase.
const auto host_lanes = [](auto f) {
  for (int l = 0; l < 32; ++l) f(l);
};
// K3a (policy_step_kernel), block by block, each phase for every thread (the
// reset phase: every warp) of the block before the next, over shared memory
// filled with junk.
extern "C" void host_step(const int* c, const int* i, const uint32_t* r, const int* act,
                          const float* ft, int* co, int* io, uint32_t* ro, float* rw,
                          uint8_t* done, float* obs, uint8_t* mask, int n) {
  const PolicyStepSmem sm = policy_step_smem_of(k3a_slots);
  for (int base = 0; base < n; base += kEnvStepBlock) {
    memset(k3a_slots, 0xA5, kStepSmem);
    for (int t = 0; t < kEnvStepBlock; ++t) env_step_classify(sm.env, i, act, t, base, n);
    for (int t = 0; t < kStepThreads; ++t) policy_step_place(sm.env, t);
    for (int t = 0; t < kStepThreads; ++t) policy_step_load(sm.env, c, i, r, t, base, n);
    for (int t = 0; t < kStepThreads; ++t) policy_step_run(sm.env, act, ft, rw, done, t, base, n);
    for (int w = 0; w < kStepWarps; ++w) policy_step_reset(sm, w, base, n, host_lanes);
    for (int t = 0; t < kStepThreads; ++t)
      policy_step_store(sm.env, co, io, ro, obs, mask, t, base, n);
  }
}
// K3a's load phase and load_hand against load_state: env e of n <= kEnvStepBlock
// (at place n - 1 - e) from shared memory filled with junk, and a State of
// load_state filled with the same junk; both stored to (co, io, ro), (cw, iw, rw).
// Returns the number of envs whose two States differ in any byte.
extern "C" int host_step_load(const int* c, const int* i, const uint32_t* r, int* co, int* io,
                               uint32_t* ro, int* cw, int* iw, uint32_t* rw, int n) {
  const PolicyStepSmem sm = policy_step_smem_of(k3a_slots);
  memset(k3a_slots, 0xA5, kStepSmem);
  for (int t = 0; t < kEnvStepBlock; ++t) sm.env.place[t] = (int16_t)(n - 1 - t);
  for (int t = 0; t < kStepThreads; ++t) policy_step_load(sm.env, c, i, r, t, 0, n);
  int differ = 0;
  for (int e = 0; e < n; ++e) {
    State& got = sm.env.slots[n - 1 - e];
    load_hand(got);
    store_state(got, co, io, ro, e, (size_t)n);
    State s;
    memset(&s, 0xA5, sizeof(State));
    load_state(s, c, i, r, e, (size_t)n);
    store_state(s, cw, iw, rw, e, (size_t)n);
    differ += memcmp(&s, &got, sizeof(State)) != 0;
  }
  return differ;
}
// K3a's reset phase on one block of n <= kEnvStepBlock envs, each loaded
// into the slot of its own place with its done flag where ended[e] is set,
// over shared memory filled with junk, stored to (co, io, ro); and
// reset_state's unrolled form on the same flagged envs, stored to (cw, iw, rw).
extern "C" void host_step_reset(const int* c, const int* i, const uint32_t* r,
                                const uint8_t* ended, int* co, int* io, uint32_t* ro, int* cw,
                                int* iw, uint32_t* rw, int n) {
  const PolicyStepSmem sm = policy_step_smem_of(k3a_slots);
  memset(k3a_slots, 0xA5, kStepSmem);
  for (int p = 0; p < kEnvStepBlock; ++p) {
    sm.env.env_at[p] = (int16_t)p;
    if (p >= n) continue;
    load_state(sm.env.slots[p], c, i, r, p, (size_t)n);
    sm.env.slots[p].done = ended[p] != 0;
  }
  for (int w = 0; w < kStepWarps; ++w) policy_step_reset(sm, w, 0, n, host_lanes);
  for (int e = 0; e < n; ++e) {
    store_state(sm.env.slots[e], co, io, ro, e, (size_t)n);
    State s;
    load_state(s, c, i, r, e, (size_t)n);
    s.done = ended[e] != 0;
    if (ended[e]) reset_state<true>(s);
    store_state(s, cw, iw, rw, e, (size_t)n);
  }
}
// The engine's step (env_step_kernel), block by block, each phase for
// every thread of the block before the next, over shared memory filled
// with junk.
extern "C" void host_env_step(const int* c, const int* i, const uint32_t* r, const int* act,
                              const float* ft, int* co, int* io, uint32_t* ro, float* rw,
                              uint8_t* done, int n) {
  const EnvStepSmem sm = env_step_smem_of(k3a_slots);
  for (int base = 0; base < n; base += kEnvStepBlock) {
    memset(k3a_slots, 0xA5, kEnvStepSmem);
    for (int t = 0; t < kEnvStepBlock; ++t) env_step_classify(sm, i, act, t, base, n);
    for (int t = 0; t < kEnvStepBlock; ++t) env_step_place(sm, c, i, r, t, base, n);
    for (int t = 0; t < kEnvStepBlock; ++t) env_step_run(sm, act, ft, rw, done, t, base, n);
    for (int t = 0; t < kEnvStepBlock; ++t) env_step_store(sm, co, io, ro, t, base, n);
  }
}
// env_step_kernel's run order of a block of `envs` envs: each env's place
// from the block's classes.
extern "C" void host_places(const uint8_t* cls, int envs, int16_t* out) {
  for (int t = 0; t < envs; ++t) out[t] = (int16_t)env_step_place_of(cls, t, envs);
}
// The engine's reset (env_reset_kernel), block by block over shared memory
// filled with junk: a block with no masked env skipped, then the shuffle
// phase of each masked env's warp, then the store phase of every thread.
ResetSmem reset_smem;
extern "C" void host_env_reset(int* c, int* i, uint32_t* r, const uint8_t* mask,
                               const uint32_t* keys, int n) {
  for (int base = 0; base < n; base += kResetEnvs) {
    bool any = false;
    for (int w = 0; w < kResetEnvs; ++w) any = any || reset_masked(mask, base + w, n);
    if (!any) continue;
    memset(&reset_smem, 0xA5, sizeof reset_smem);
    for (int w = 0; w < kResetEnvs; ++w)
      if (reset_masked(mask, base + w, n))
        reset_slot(reset_smem.slots[w], reset_smem.keys[w],
                   reset_key(i, r, keys, base + w, (size_t)n), host_lanes);
    for (int w = 0; w < kResetEnvs; ++w)
      for (int l = 0; l < 32; ++l) reset_store(reset_smem, w, l, mask, c, i, r, base, n);
  }
}
// The warp's sort of 64 keys.
extern "C" void host_sort64(uint64_t* v) { sort64(v, host_lanes); }
// K3b and the sampler, block by block: each phase runs for every thread of
// the block before the next one starts (the kernels' __syncthreads), over
// shared memory filled with junk before the block runs.
extern "C" void host_observe(const int* c, const int* i, float* obs, uint8_t* mask, int n) {
  State* slots = observe_slots;
  for (int base = 0; base < n; base += kObserveEnvs) {
    memset(slots, 0xA5, sizeof observe_slots);
    for (int t = 0; t < kObserveBlock; ++t)
      observe_load(slots, c, i, t % kObserveEnvs, t / kObserveEnvs, base, n);
    for (int t = 0; t < kObserveBlock; ++t)
      observe_emit(slots, obs, mask, t % kObserveEnvs, t / kObserveEnvs, base, n);
  }
}
extern "C" void host_sample(const float* logits, int64_t s_env, int64_t s_act, int n,
                            uint32_t k0, uint32_t k1, int* act, float* lp) {
  SampleSmem& sm = sample_smem;
  for (int base = 0; base < n; base += kSampleEnvs) {
    memset(&sm, 0xA5, sizeof sm);
    for (int t = 0; t < kSampleBlock; ++t)
      sample_stage(sm, logits, s_env, s_act, t % kSampleEnvs, t / kSampleEnvs, base, n, k0, k1);
    for (int t = 0; t < kSampleBlock; ++t)
      sample_partials(sm, t % kSampleEnvs, t / kSampleEnvs, base, n);
    for (int t = 0; t < kSampleBlock; ++t) sample_sums(sm, t % kSampleEnvs, t / kSampleEnvs, base, n);
    for (int t = 0; t < kSampleBlock; ++t)
      sample_write(sm, t % kSampleEnvs, t / kSampleEnvs, base, n, act, lp);
  }
}
extern "C" int host_sample_groups() { return kSampleGroups; }
// The sampler's write phase for one env on given partials: group h's best
// perturbed logit best[h] at action arg[h], each group's largest logit 0 and
// exponential sum 1.
extern "C" int host_sample_combine(const float* best, const int* arg) {
  SampleSmem& sm = sample_smem;
  memset(&sm, 0, sizeof sm);
  for (int h = 0; h < kSampleGroups; ++h) {
    sm.best[h][0] = best[h];
    sm.arg[h][0] = arg[h];
    sm.sum[h][0] = 1.f;
  }
  int action = -1;
  float lp = 0.f;
  sample_write(sm, 0, 0, 0, 1, &action, &lp);
  return action;
}
"""

LOG1P_ROW = FP.OBS_DIM - 6       # log1p(chips_needed) / 10: a library function


@pytest.fixture(scope="module")
def host_policy(tmp_path_factory):
    so = _compile(tmp_path_factory, POLICY_LAUNCH)
    so.host_observe.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int]
    so.host_step.argtypes = [ctypes.c_void_p] * 12 + [ctypes.c_int]
    so.host_env_step.argtypes = [ctypes.c_void_p] * 10 + [ctypes.c_int]
    so.host_step_reset.argtypes = [ctypes.c_void_p] * 10 + [ctypes.c_int]
    so.host_step_load.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int]
    so.host_sample.argtypes = [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_longlong,
                               ctypes.c_int, ctypes.c_uint, ctypes.c_uint, ctypes.c_void_p,
                               ctypes.c_void_p]
    so.host_sample_combine.argtypes = [ctypes.c_void_p, ctypes.c_void_p]

    def rows(n):
        return (torch.empty(FP.OBS_DIM, n), torch.empty(FP.N_ACTIONS, n, dtype=torch.bool))

    def observe(packed):
        obs, mask = rows(packed["ints"].shape[1])
        so.host_observe(packed["cards"].data_ptr(), packed["ints"].data_ptr(),
                        obs.data_ptr(), mask.data_ptr(), obs.shape[1])
        return obs.T, mask.T

    def step(packed, actions):
        n = packed["ints"].shape[1]
        out = {k: torch.empty_like(v) for k, v in packed.items()}
        reward, done = torch.empty(n), torch.empty(n, dtype=torch.bool)
        obs, mask = rows(n)
        so.host_step(*(packed[k].data_ptr() for k in ("cards", "ints", "rng")),
                     actions.data_ptr(), F.float_tables("cpu").data_ptr(),
                     *(out[k].data_ptr() for k in ("cards", "ints", "rng")),
                     reward.data_ptr(), done.data_ptr(), obs.data_ptr(), mask.data_ptr(), n)
        return out, reward, done, obs.T, mask.T

    def env_step(packed, actions):
        n = packed["ints"].shape[1]
        out = {k: torch.empty_like(v) for k, v in packed.items()}
        reward, done = torch.empty(n), torch.empty(n, dtype=torch.bool)
        so.host_env_step(*(packed[k].data_ptr() for k in ("cards", "ints", "rng")),
                         actions.data_ptr(), F.float_tables("cpu").data_ptr(),
                         *(out[k].data_ptr() for k in ("cards", "ints", "rng")),
                         reward.data_ptr(), done.data_ptr(), n)
        return out, reward, done

    def step_reset(packed, ended):
        """K3a's reset phase and ``reset_state<true>`` on the envs of one
        block where ``ended``: the packed rows of each."""
        n = packed["ints"].shape[1]
        ended = ended.to(torch.bool).contiguous()
        got, want = ({k: torch.empty_like(v) for k, v in packed.items()} for _ in range(2))
        so.host_step_reset(*(packed[k].data_ptr() for k in ("cards", "ints", "rng")),
                           ended.data_ptr(), *(got[k].data_ptr() for k in ("cards", "ints", "rng")),
                           *(want[k].data_ptr() for k in ("cards", "ints", "rng")), n)
        return got, want

    def step_load(packed):
        """K3a's load phase and ``load_state`` on the envs of one block: the
        number of envs whose States differ in a byte, and the packed rows
        each stores."""
        n = packed["ints"].shape[1]
        got, want = ({k: torch.empty_like(v) for k, v in packed.items()} for _ in range(2))
        differ = so.host_step_load(*(packed[k].data_ptr() for k in ("cards", "ints", "rng")),
                                   *(got[k].data_ptr() for k in ("cards", "ints", "rng")),
                                   *(want[k].data_ptr() for k in ("cards", "ints", "rng")), n)
        return differ, got, want

    step.env_step = env_step
    step.reset = step_reset
    step.load = step_load

    def sample(key, logits):
        n = logits.shape[0]
        action, lp = torch.empty(n, dtype=torch.int32), torch.empty(n)
        so.host_sample(logits.data_ptr(), *logits.stride(), n, *key, action.data_ptr(),
                       lp.data_ptr())
        return action, lp

    def combine(best, arg):
        best = np.ascontiguousarray(best, np.float32)
        arg = np.ascontiguousarray(arg, np.int32)
        return so.host_sample_combine(best.ctypes.data, arg.ctypes.data)

    sample.groups = so.host_sample_groups()
    sample.combine = combine
    return observe, step, sample


def assert_obs_mask(got, want, what):
    """Observation and mask bit for bit, but the log1p row within 1 ulp."""
    (g_obs, g_mask), (w_obs, w_mask) = got, want
    assert torch.equal(g_mask, w_mask), what
    other = torch.ones(FP.OBS_DIM, dtype=torch.bool)
    other[LOG1P_ROW] = False
    bad = torch.nonzero(g_obs[:, other] != w_obs[:, other])
    assert len(bad) == 0, f"{what}: obs differs at {bad[:5].tolist()}"
    ulp = (g_obs[:, LOG1P_ROW].view(torch.int32) - w_obs[:, LOG1P_ROW].view(torch.int32)).abs()
    assert int(ulp.max()) <= 1, what


def assert_step_equal(got, want, what):
    for k in ("cards", "ints", "rng"):
        bad = torch.nonzero(got[0][k] != want[0][k])
        assert len(bad) == 0, f"{what}: {k} differs at {bad[:5].tolist()}"
    assert torch.equal(got[2], want[2]), what
    # the reward's log term (plays past ante 3) may differ in the last bit
    np.testing.assert_allclose(got[1].numpy(), want[1].numpy(), rtol=0, atol=1e-4)
    assert_obs_mask(got[3:], want[3:], what)


def near_ties(key, logits, tol=1e-5):
    """[B] bool: envs whose two largest Gumbel-perturbed logits lie within
    ``tol``, where a last-bit difference of ``log`` may flip the draw."""
    n = logits.shape[0]
    u = KR.uniform_f32(KR.random_bits32(*key, torch.arange(60 * n).view(60, n)),
                       float(np.finfo(np.float32).tiny), 1.0)
    top2 = (logits + (-torch.log(-torch.log(u))).T).topk(2, 1).values
    return top2[:, 0] - top2[:, 1] <= tol


def assert_samples_agree(got, want, key, logits, what):
    """Actions equal but at near-ties (at most 0.1% of envs); log-probs of
    equal actions within 1e-6."""
    same = got[0] == want[0]
    assert bool(near_ties(key, logits)[~same].all()), what
    assert int((~same).sum()) <= max(1, logits.shape[0] // 1000), what
    np.testing.assert_allclose(got[1][same].numpy(), want[1][same].numpy(), rtol=0, atol=1e-6)


def test_host_policy_kernels_along_a_collection(host_policy):
    """512 envs x 8 steps of a collection from the default reset: K3b, the
    sampler and K3a against their plain versions at every step."""
    observe, step, sample = host_policy
    net = ActorCritic(FP.N_ACTIONS, FP.OBS_DIM, generator=torch.Generator().manual_seed(1))
    packed = F.pack_full_state(F.default_reset(3, 512, "cpu"))
    obs, mask = FP.observe_rows_reference(packed)
    assert_obs_mask(observe(packed), (obs, mask), "observe")
    for t, key in enumerate(FP.step_keys(3, 8)):
        with torch.no_grad():
            logits, _ = net(obs, mask)
        want = FP.sample(key, logits)
        for layout in (logits.contiguous(), logits.T.contiguous().T):     # both strides
            assert_samples_agree(sample(key, layout), want, key, logits, f"sample {t}")
        ref = FP.step_rows_reference(packed, want[0])
        assert_step_equal(step(packed, want[0]), ref, f"step {t}")
        packed, _, _, obs, mask = ref
    assert F._load(packed)["phase"].eq(0).any()


SMALL_SIZES = (1, 31, 33, 257, 512)      # partial blocks of 32 envs; 512 whole ones


def _diversified(n):
    """A surgically diversified state of ``n`` envs and a 4-step legal
    script from it."""
    return _battery(n, 4, np.random.default_rng(n))


@pytest.mark.parametrize("n", SMALL_SIZES)
def test_host_observe_partial_blocks(host_policy, n):
    """K3b, its State slots filled with junk but the fields its warps load,
    against the plain version on the default reset and along a 4-step legal
    script from a diversified state."""
    observe, _, _ = host_policy
    packed = F.pack_full_state(F.default_reset(n, n, "cpu"))
    assert_obs_mask(observe(packed), FP.observe_rows_reference(packed), f"n={n} reset")
    st, script = _diversified(n)
    packed = F.pack_full_state(st)
    for t, a in enumerate(script):
        assert_obs_mask(observe(packed), FP.observe_rows_reference(packed), f"n={n} step {t}")
        packed = FP.step_rows_reference(packed, torch.as_tensor(a))[0]
    assert_obs_mask(observe(packed), FP.observe_rows_reference(packed), f"n={n} end")


@pytest.mark.parametrize("n", SMALL_SIZES)
def test_host_sampler_partial_blocks(host_policy, n):
    """The sampler in both logits layouts against ``sample``, on a policy's
    logits of a diversified state, where every third env has no legal
    action: its 60 logits are -1e9, every perturbed value rounds to -1e9,
    and the lowest action, 0, must win the tie."""
    _, _, sample = host_policy
    net = ActorCritic(FP.N_ACTIONS, FP.OBS_DIM, generator=torch.Generator().manual_seed(n))
    obs, mask = FP.observe_rows_reference(F.pack_full_state(_diversified(n)[0]))
    mask[::3] = False
    with torch.no_grad():
        logits, _ = net(obs, mask)
    for t, key in enumerate(FP.step_keys(n, 3)):
        want = FP.sample(key, logits)
        assert bool((want[0][::3] == 0).all())
        for layout in (logits.contiguous(), logits.T.contiguous().T):
            got = sample(key, layout)
            assert torch.equal(got[0][::3], want[0][::3]), f"n={n} key {t}"
            assert_samples_agree(got, want, key, logits, f"n={n} key {t}")


def test_host_sampler_combine_ties(host_policy):
    """The sampler's combine over its action groups (group h holds actions
    h, h + G, ...): among equal best values the lowest action wins, in
    whichever group it lies; a larger value wins over a lower action."""
    _, _, sample = host_policy
    G = sample.groups
    first, last = np.arange(G), np.arange(G) + 60 - G        # each group's first and last action
    ties = np.full(G, -1.0)
    ties[[0, -1]] = 2.0
    assert sample.combine(ties, np.r_[last[:-1], first[-1]]) == G - 1      # a later group, lower
    assert sample.combine(ties, last) == last[0]                           # an earlier group, lower
    assert sample.combine(np.zeros(G), np.r_[last[:-1], first[-1]]) == G - 1
    assert sample.combine(np.zeros(G), first) == 0
    larger = np.zeros(G)
    larger[-1] = 0.5
    assert sample.combine(larger, first) == G - 1
    assert sample.combine(np.full(G, -np.inf), first) == 0


def test_host_policy_step_fed_battery(host_policy):
    """K3a along the 512 x 24 fed battery (every action class, boss,
    consumable, joker and shop lanes) against the plain step."""
    _, step, _ = host_policy
    rng = np.random.default_rng(1)
    st = BAT.surgery(F.rollout_full_fused(5, 512, 4, device="cpu")["state"], rng)
    packed, script = F.pack_full_state(st), []
    for t in range(24):
        a = torch.as_tensor(BAT.sample_legal(F._legal_rows(F._load(packed)).T.numpy(), rng))
        script.append(a.numpy())
        ref = FP.step_rows_reference(packed, a)
        assert_step_equal(step(packed, a.to(torch.int32)), ref, f"battery step {t}")
        packed = ref[0]
    assert all(v > 0 for v in BAT.coverage(np.stack(script)).values())


@pytest.mark.parametrize("n", (1, 31, 33, 63, 64, 65, 128, 129, 257))
def test_host_policy_step_partial_blocks(host_policy, n):
    """K3a at env counts around its blocks of 64 envs (a partial block,
    whole ones, an env past the last whole block), along 8 fed legal steps
    from a diversified state, against the plain step."""
    _, step, _ = host_policy
    rng = np.random.default_rng(n)
    st = BAT.surgery(F.rollout_full_fused(n, n, 4, device="cpu")["state"], rng)
    packed = F.pack_full_state(st)
    for t in range(8):
        a = torch.as_tensor(BAT.sample_legal(F._legal_rows(F._load(packed)).T.numpy(), rng))
        ref = FP.step_rows_reference(packed, a)
        assert_step_equal(step(packed, a.to(torch.int32)), ref, f"n={n} step {t}")
        packed = ref[0]


def test_host_policy_step_reset_batches(host_policy):
    """K3a on the autoreset batches: with ante 101 every env resets
    (its deck shuffled anew in its State slot), with the no-op action none
    does; both against the plain step."""
    _, step, _ = host_policy
    packed = F.pack_full_state(F.default_reset(6, 96, "cpu"))
    for what, (p, a), ends in zip(("no_reset", "all_reset"),
                                  BAT.reset_batches(packed), (False, True)):
        ref = FP.step_rows_reference(p, a)
        assert_step_equal(step(p, a), ref, what)
        assert bool((ref[2] == ends).all()), what


@pytest.mark.parametrize("ended", ("every", "single"))
def test_host_policy_step_warp_reset_equals_reset_state(host_policy, ended):
    """K3a's reset phase (a warp an ended env, the sort in shared memory)
    against ``reset_state<true>`` (the sort in one thread) on the same
    slots of a block of 64 mid-game envs, each with its own key and step
    count: every env flagged, or one alone (its neighbours' slots then keep
    the loaded state). Deck and fields, as the packed rows hold them, bit
    for bit."""
    _, step, _ = host_policy
    packed = F.pack_full_state(F.rollout_full_fused(8, 64, 6, device="cpu")["state"])
    packed["ints"][F.S_STEPC] = torch.arange(64, dtype=torch.int32) * 7 + 1
    mask = torch.ones(64, dtype=torch.bool) if ended == "every" else torch.arange(64) == 37
    got, want = step.reset(packed, mask)
    for k in ("cards", "ints", "rng"):
        bad = torch.nonzero(got[k] != want[k])
        assert len(bad) == 0, f"{k} differs at {bad[:5].tolist()}"
    fresh = F._load(got)
    assert bool((fresh["ante"][mask] == 1).all()) and bool((fresh["sc"][mask] == 0).all())
    kept = {k: v[..., ~mask] for k, v in packed.items()}
    assert all(torch.equal(got[k][..., ~mask], kept[k]) for k in got)


@pytest.mark.parametrize("n", (37, 64))
def test_host_policy_step_load_equals_load_state(host_policy, n):
    """K3a's load phase (four threads an env, each a part of its rows, into
    the slot of its place) and its hand fill against ``load_state`` on the
    same junk-filled memory: every byte of the State and the packed rows it
    stores. The rows are random words (the hand's deck slots and size around
    their ranges), since both only copy and convert them."""
    _, step, _ = host_policy
    g = torch.Generator().manual_seed(n)
    packed = {"cards": torch.randint(-2**31, 2**31, (6, F.N_DECK, n), generator=g,
                                     dtype=torch.int64).to(torch.int32),
              "ints": torch.randint(-2**31, 2**31, (F.NI, n), generator=g,
                                    dtype=torch.int64).to(torch.int32),
              "rng": torch.randint(-2**31, 2**31, (F.NR, n), generator=g,
                                   dtype=torch.int64).to(torch.int32)}
    packed["cards"][5] = torch.randint(0, 2, (F.N_DECK, n), generator=g, dtype=torch.int32)
    packed["ints"][F.R_HIDX:F.R_HIDX + 10] = torch.randint(-2, 70, (10, n), generator=g,
                                                           dtype=torch.int32)
    packed["ints"][F.S_HN] = torch.randint(-1, 10, (n,), generator=g, dtype=torch.int32)
    differ, got, want = step.load(packed)
    assert differ == 0
    assert all(torch.equal(got[k], want[k]) for k in got)


@pytest.mark.parametrize("n", (33, 512))
def test_host_env_step_fed_battery(host_policy, n):
    """The engine's step kernel (K3a's step without its autoreset) along 12
    fed legal steps of a diversified state, then on the autoreset batches
    (every env ending keeps its final state), against the plain
    ``_step(..., autoreset=False)``."""
    _, step, _ = host_policy
    rng = np.random.default_rng(n + 1)
    st = BAT.surgery(F.rollout_full_fused(n, n, 4, device="cpu")["state"], rng)
    packed = F.pack_full_state(st)
    for t in range(12):
        a = torch.as_tensor(BAT.sample_legal(F._legal_rows(F._load(packed)).T.numpy(), rng))
        got, want = step.env_step(packed, a.to(torch.int32)), FP.env_step_rows_reference(packed, a)
        for k in ("cards", "ints", "rng"):
            bad = torch.nonzero(got[0][k] != want[0][k])
            assert len(bad) == 0, f"step {t}: {k} differs at {bad[:5].tolist()}"
        assert torch.equal(got[2], want[2]), t
        np.testing.assert_allclose(got[1].numpy(), want[1].numpy(), rtol=0, atol=1e-4)
        packed = FP.step_rows_reference(packed, a)[0]       # go on from the reset state
    for (p, a), ends in zip(BAT.reset_batches(packed), (False, True)):
        got, want = step.env_step(p, a), FP.env_step_rows_reference(p, a)
        assert all(torch.equal(got[0][k], want[0][k]) for k in p) and torch.equal(got[2], want[2])
        assert bool((got[2] == ends).all()) and torch.equal(got[1], want[1])
        assert bool((F._load(got[0])["done"] == ends).all())

