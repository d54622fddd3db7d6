"""The CUDA source of the sim rollout kernel (K4, csrc/fused_rollout.cu),
compiled as host C++, against its plain version, on the CPU.

The source is built with g++ through the shim of
tests/test_torch_full_kernel_host.py and run block by block: the staging
phase for every thread of a block, then the rollout phase for every
thread, over shared memory (the per-env table columns, the deck windows
and the power tables) filled with a junk pattern before each block; every
uninitialised local is filled with a junk pattern too. What this cannot
check (the build for sm_90a, the launch, the registers) is checked on the
card by tests/test_torch_fused_rollout_cuda.py and chip_smoke.py.

Tolerance: none. Every output, the reward sums included, equals the plain
version bit for bit.
"""
import ctypes

import numpy as np
import pytest
import torch

from balatro_gym_tpu_torch.engine import sim_env
from balatro_gym_tpu_torch.ops import fused_rollout as FR
from balatro_gym_tpu_torch.ops import hand_eval as HE
from balatro_gym_tpu_torch.ops import joker_tables as JT
from balatro_gym_tpu_torch.ops import kernel_rng as KR
from tests.test_torch_full_kernel_host import _compile

HOST_LAUNCH = r"""
#define FULL_ROLLOUT_HOST_SHIM
#include "shim.h"
#include "fused_rollout.cu"
namespace { RolloutSmem smem; }
extern "C" void host_rollout(const float* scal, const float* rt, const float* st, const float* ht,
                             const int* act, int* ro, int* so, int* sto, float* rw, int n,
                             int steps, int use, uint32_t k0, uint32_t k1) {
  for (int base = 0; base < n; base += kBlock) {
    memset(&smem, 0xA5, sizeof smem);
    for (int t = 0; t < kBlock; ++t) rollout_stage(smem, scal, rt, st, ht, t, base, n);
    for (int t = 0; t < kBlock; ++t)
      rollout_run(smem, scal, act, ro, so, sto, rw, t, base, n, steps, use, k0, k1);
  }
}
// The evaluation of n hands: ranks, suits [n, 5], k [n]; type and mask out
// (bit c for card c). Cards 5..7 of the hand repeat cards 0..2: never
// selected, they must not count.
extern "C" void host_evaluate(const int* r, const int* s, const int* k, int req, int skip,
                              int* ht, int* smask, int n) {
  for (int i = 0; i < n; ++i) {
    uint32_t rw = 0u, sw = 0u;
    for (int c = 0; c < kCards; ++c) {
      rw |= (uint32_t)r[5 * i + c % 5] << (4 * c);
      sw |= (uint32_t)s[5 * i + c % 5] << (4 * c);
    }
    const Eval ev = evaluate5(rw, sw, ((1u << (4 * k[i])) - 1u) & kLow, k[i], req, skip != 0);
    ht[i] = ev.ht;
    smask[i] = 0;
    for (int c = 0; c < kCards; ++c) smask[i] |= (int)((ev.smask >> (4 * c)) & 1u) << c;
  }
}
extern "C" void host_pow_tables(float* p3, float* p15) {
  memcpy(p3, c_pow3, sizeof c_pow3);
  memcpy(p15, c_pow15, sizeof c_pow15);
}
extern "C" int host_block() { return kBlock; }
"""

BENCH = (1, 31, 34, 48, 72)
RANDOM = (27, 117, 34, 16, 0)              # Misprint + Bloodstone (+ Abstract, Half)
JOKER_SETS = np.asarray((
    (0, 0, 0, 0, 0), BENCH, (6, 7, 131, 135, 0),
    (18, 69, 16, 23, 108),                 # Four Fingers, Shortcut, Half, Mystic, Acrobat
    (116, 118, 119, 2, 3), (147, 140, 128, 122, 61),
), np.int32)


@pytest.fixture(scope="module")
def host(tmp_path_factory):
    threads = torch.get_num_threads()
    torch.set_num_threads(1)        # many small ops: keep parallel workers apart
    so = _compile(tmp_path_factory, HOST_LAUNCH)
    so.host_rollout.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 3 + [ctypes.c_uint] * 2
    so.host_evaluate.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_int] * 2
                                 + [ctypes.c_void_p] * 2 + [ctypes.c_int])
    so.host_pow_tables.argtypes = [ctypes.c_void_p] * 2
    yield so
    torch.set_num_threads(threads)


def run_host(so, seed, n, steps, jokers, actions=None):
    """The host build's outputs (ranks, suits, stats, reward) on the
    coefficient rows of ``jokers``."""
    coef = FR.joker_coefficients(jokers, n, device="cpu")
    out = (torch.empty(8, n, dtype=torch.int32), torch.empty(8, n, dtype=torch.int32),
           torch.empty(8, n, dtype=torch.int32), torch.empty(n))
    act = None if actions is None else torch.as_tensor(actions, dtype=torch.int32).contiguous()
    so.host_rollout(*(c.data_ptr() for c in coef), None if act is None else act.data_ptr(),
                    *(o.data_ptr() for o in out), n, steps, int(act is not None), 0,
                    seed & 0xFFFFFFFF)
    return out, coef, act


def assert_host_equals_plain(so, seed, n, steps, jokers, actions=None):
    got, coef, act = run_host(so, seed, n, steps, jokers, actions)
    want = FR._reference_rows(coef, seed, act, steps)
    for name, g, w in zip(("ranks", "suits", "stats", "reward"), got, want):
        bad = torch.nonzero(g != w)
        assert len(bad) == 0, f"{name} differs at {bad[:5].tolist()}"
    return dict(zip(("ranks", "suits", "stats", "reward"), got))


def legal_script(jok, n, steps, seed):
    """Mask-legal actions, drawn with numpy against the port's sim engine."""
    rng = np.random.default_rng(seed)
    k1, k2 = KR.seed_key(seed)
    st = sim_env.reset(torch.stack(KR.split_child(k1, k2, torch.arange(n)), -1),
                       torch.as_tensor(jok))
    acts = np.zeros((steps, n), np.int32)
    for t in range(steps):
        cum = np.cumsum(sim_env.action_mask(st).numpy(), axis=1)
        acts[t] = np.argmax(cum > rng.random((n, 1)) * cum[:, -1:], axis=1)
        st, _, _ = sim_env.step_autoreset(st, torch.as_tensor(acts[t]))
    return acts


def test_fed_legal_scripts_over_six_joker_sets(host):
    n = 384
    jok = JOKER_SETS[np.arange(n) % len(JOKER_SETS)]
    out = assert_host_equals_plain(host, 0, n, 24, jok, legal_script(jok, n, 24, 11))
    assert int(out["stats"][5].sum()) > n // 2                  # autoresets crossed


@pytest.mark.parametrize("jokers", ["bench", "misprint+bloodstone", "mixed"])
def test_sampled(host, jokers):
    n = 320
    rng = np.random.default_rng(1)
    jok = {"bench": np.asarray(BENCH), "misprint+bloodstone": np.asarray(RANDOM),
           "mixed": np.concatenate([JOKER_SETS[np.arange(n // 2) % len(JOKER_SETS)],
                                    rng.integers(0, 151, (n - n // 2, 5))]).astype(np.int32)
           }[jokers]
    out = assert_host_equals_plain(host, 3, n, 40, jok)
    assert int(out["stats"][5].sum()) > 0


@pytest.mark.parametrize("n", [1, 257, "block+3"])
def test_partial_blocks(host, n):
    n = host.host_block() + 3 if n == "block+3" else n
    jok = JOKER_SETS[np.arange(n) % len(JOKER_SETS)]
    assert_host_equals_plain(host, n, n, 16, jok)
    assert_host_equals_plain(host, 0, n, 8, jok, legal_script(jok, n, 8, n))


def test_illegal_fed_script(host):
    """Discards past the limit run the deck dry: the refill clamps to the
    deck's first slot, and both versions stay on valid, equal cards."""
    n = 256
    rng = np.random.default_rng(5)
    jok = JOKER_SETS[rng.integers(0, len(JOKER_SETS), n)]
    acts = rng.integers(0, 10, (48, n)).astype(np.int32)
    out = assert_host_equals_plain(host, 5, n, 48, jok, acts)
    assert int(out["ranks"].min()) >= 2 and int(out["stats"][0].min()) < 0


def _hands(n, rng):
    """Hands that reach every type: ranks from a narrow range (equal ranks),
    runs, wheels, one rank, or any; suits from one, two, three or four."""
    narrow = rng.integers(2, 6, (n, 5))
    runs = rng.integers(2, 8, (n, 1)) + np.arange(5)[None] + rng.integers(0, 2, (n, 5))
    wheel = rng.choice([14, 2, 3, 4, 5, 6], (n, 5))
    same = np.repeat(rng.integers(2, 15, (n, 1)), 5, 1)
    wide = rng.integers(2, 15, (n, 5))
    pick = rng.integers(0, 5, (n, 1))
    ranks = np.select([pick == 0, pick == 1, pick == 2, pick == 3],
                      [narrow, np.minimum(runs, 14), wheel, same], wide)
    suits = rng.integers(0, 4, (n, 5)) % rng.integers(1, 5, (n, 1))
    k = rng.integers(1, 6, n)
    return ranks.astype(np.int32), suits.astype(np.int32), k.astype(np.int32)


@pytest.mark.parametrize("four_fingers", [False, True])
@pytest.mark.parametrize("shortcut", [False, True])
def test_evaluation_equals_evaluate_sim(host, four_fingers, shortcut):
    """The kernel's five-card evaluation against the engine's evaluate_sim
    on 20,000 hands a flag pair, every hand type reached."""
    n = 20000
    ranks, suits, k = _hands(n, np.random.default_rng(7 + 2 * four_fingers + shortcut))
    ht = np.empty(n, np.int32)
    sm = np.empty(n, np.int32)
    host.host_evaluate(ranks.ctypes.data, suits.ctypes.data, k.ctypes.data,
                       4 if four_fingers else 5, int(shortcut), ht.ctypes.data, sm.ctypes.data, n)
    pad = np.zeros((n, 3), np.int32)
    r8, s8 = (torch.as_tensor(np.concatenate([x, pad + 2], 1)) for x in (ranks, suits))
    sel = torch.arange(8)[None] < torch.as_tensor(k)[:, None]
    want_ht, want_mask = HE.evaluate_sim(r8, s8, sel, four_fingers, shortcut)
    want_sm = ((want_mask & sel).to(torch.int64) << torch.arange(8)).sum(1)
    np.testing.assert_array_equal(ht, want_ht.numpy())
    np.testing.assert_array_equal(sm, want_sm.numpy())
    assert set(np.unique(ht)) == set(range(12))


def test_staged_halves_hold_every_sum():
    """Every staged word is two 16-bit halves of non-negative integers: the
    largest chips and mult a step can add up (5 jokers of the largest entry
    in every row, 5 scoring cards) stay below 2**16, so a pair added as one
    word never carries into its other half."""
    t = JT.get_tables()
    top = {k: 5 * int(np.asarray(getattr(t, k)).max()) for k in (
        "chips_flat", "mult_flat", "ind_chip_rank", "ind_mult_rank", "ind_chip_suit",
        "ind_mult_suit", "ind_money_suit", "mult_if_suit", "chips_hand_sim",
        "mult_hand_sim", "x2_hand_sim", "x3_hand_sim", "x3_flat")}
    assert min(int(np.asarray(getattr(t, k)).min()) for k in top) >= 0
    mult_const = top["mult_flat"] + 15 * 5 + 3 * 5 * 5        # + Mystic Summit, Abstract
    chips = 160 + top["chips_hand_sim"] + top["chips_flat"] + 5 * (
        11 + top["ind_chip_rank"] + top["ind_chip_suit"])
    mult = 16 + top["mult_hand_sim"] + mult_const + 5 * (
        top["ind_mult_rank"] + top["ind_mult_suit"])
    money = 5 * top["ind_money_suit"]
    assert max(chips, mult, money, top["mult_if_suit"], top["x2_hand_sim"],
               top["x3_hand_sim"] + top["x3_flat"] + 5) < 1 << 16
    # The joker counts packed into 4-bit fields reach at most 5.
    coef = FR.joker_coefficients(np.full((151, 5), np.arange(151)[:, None]), 151)[0]
    for row in (FR.S_TRIB, FR.S_SEEING, FR.S_BLACKB, FR.S_FLOWER, FR.S_BARON,
                FR.S_MISPRINT, FR.S_BLOOD):
        assert 0 <= int(coef[row].min()) and int(coef[row].max()) <= 5
    assert int(coef[FR.S_HALF20].max()) < 1 << 16 and int(coef[FR.S_STM13].max()) < 1 << 16


def test_power_tables_equal_the_chains(host):
    """Entry i of each power table is the reference's float32 chain of
    multiplies by 3 (by 1.5) after i steps."""
    p3, p15 = np.empty(13, np.float32), np.empty(21, np.float32)
    host.host_pow_tables(p3.ctypes.data, p15.ctypes.data)
    for table, base in ((p3, 3.0), (p15, 1.5)):
        chain = [np.float32(1.0)]
        for _ in range(len(table) - 1):
            chain.append(np.float32(chain[-1] * np.float32(base)))
        np.testing.assert_array_equal(table.view(np.uint32), np.asarray(chain).view(np.uint32))
