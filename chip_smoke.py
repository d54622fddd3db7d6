#!/usr/bin/env python3
"""Check the PyTorch port's entry points on one CUDA card, at the shapes
they run at.

    python3 chip_smoke.py          # from the repository root; one card, nvcc

The card's parity check: each kernel and each path of the port that runs on
the card, held against the kernels' plain versions at production shapes (bit
for bit unless a contract below says otherwise), with the launches it makes,
the legality of its actions, resume and data-parallel parity. It times
nothing and bounds nothing: ``benchmark/run.py`` measures the port (its
cells' ``device_ops`` give each kernel's card time in context), and
``ops/policy_kernels_ab.py``, ``ops/sim_kernels_ab.py`` and ``python -m
balatro_gym_tpu_torch.ops.alu_ceiling`` time kernels alone. The two
whole-rollout kernels run at bench.py's shapes: ``ops.fused_rollout.
rollout_fused`` (the sim engine, K4, csrc/fused_rollout.cu) at 131072 envs x
256 steps with jokers (1, 31, 34, 48, 72), and ``ops.fused_full_rollout.
rollout_full_fused`` (the flagship full-game env, K2,
csrc/fused_full_rollout.cu) at 131072 envs x 256 steps, actions sampled on
the card in both. Phases, each printed on its own line and numbered as
PERF.md and the card tests cite them; any failure raises and the run exits
non-zero:

1. device: the card, its power limit, nvcc and torch;
2. build: nvcc builds the five kernel sources of csrc/ into
   build/kernels/, one process each, started together, and prints each
   kernel's registers, stack and spills;
3. sim main path: one rollout at the bench shape with the launch counter
   reset before and read after; its outputs are checked for shape and
   range, bit for bit against the plain version of the same call, and by
   their mean reward and episodes per env-step against the torch sim
   engine's random rollout (sim_env.rollout_random_per_env) at that shape;
4. fed parity: 4096 envs x 32 steps of mask-legal action scripts over six
   joker sets; kernel == plain version bit for bit, and == the float64 sim
   engine (states exact, reward within 2e-3);
5. sampled parity: 131072 envs x 32 steps; kernel == plain version bit for
   bit, with the bench jokers, with Misprint and Bloodstone, and mixed;
7. full-env main path: one sampled rollout at 131072 x 256 from the
   default reset (the engine's reset kernel ``env_reset_kernel``, one
   launch), the launch counters reset before and read after; outputs
   checked for shape and range; the same call at 131072 x 32 equals its
   plain version bit for bit (state, reward, episodes);
8. full-env fed battery: 16384 envs after a 4-step sampled prelude and the
   state surgery of ops/fused_full_battery.py, 64 steps of coverage-biased
   legal actions made by stepping the plain version; the kernel's one
   64-step call equals the chained plain steps bit for bit, and every
   action class is fed;
10. policy main path: ``ops.fused_policy_rollout.collect_policy_fused``
    (K3b, then policy forward -> sampler -> K3a each step, from
    csrc/fused_policy_rollout.cu) with a seeded ``ActorCritic(256, 256)`` on
    the card at PPO's collection shape, 8192 envs x 256 steps from the
    default reset, the launch counters reset before and read after (K3b 1,
    K3a 256, sampler 256); every action legal under the mask its step
    consumed, finite log-probs <= 0, shapes and dtypes;
11. policy parity: K3b, K3a and the sampler against their plain versions
    on the same inputs along the main path's first 16 steps (8192 envs),
    the sampler on the logits in the layout the main path gives it and on a
    copy in the other one (row-major or column-major), and K3a along phase
    8's 16384 x 64 fed battery; the main path's recorded actions replayed
    through K2, step by step and in one call, give the same rewards, dones
    and final state;
13. hand histograms (K5, csrc/hand_histograms.cu): its entry point
    ``ops.hand_histograms.hand_histograms`` at 1,048,576 envs of seeded
    cards with ranks in [-1, 17] and suits in [-1, 9] (some outside every
    bin), the launch counter reset before and read after; kernel == plain
    bit for bit;
14. ALU ceiling (K6, csrc/alu_ceiling.cu): kernel == plain x 128 rounds at
    2 seeded tiles and on the probe's own inputs at both its shapes (64 and
    1,056 tiles); then the probe's entry point ``alu_ceiling.main`` at 10
    reps (its rates not printed), the launch counter reset just before:
    2 x (1 + 3 x 10) launches;
15. trainer main path: ``train.ppo.make_ppo`` on the flagship env with the
    ``fast_decay`` recipe of scripts/train_headline_r04.py (8192 envs x 128
    steps, bf16, env_shuffle, 1 epoch, 4 minibatches, lr and entropy decay
    over 5 updates, ``ActorCritic(256, 256)`` from ``init_fn``), 5 updates,
    the collection one CUDA graph replayed by each (``replays`` 5): the
    wrappers' launch counters, reset before, read after the first update
    (its warm-up and capture: K3b 2, K3a and the sampler 256), unchanged by
    the replays, and the kernels that ran in the other 4 counted by name in
    a profile of the card (K3b 1, K3a 128, sampler 128 an update); every
    recorded action legal under its mask, metrics finite, parameters moved,
    episodes > 0;
16. trainer parity: at 1024 envs x 8 steps, 2 epochs, 2 minibatches, from a
    mid-game state, the fused update against the same update over the
    kernels' plain versions on the card (bf16 with env_shuffle, and float32
    with the flat shuffle): trajectories and packed state bit for bit but
    the sampler's log-probs (within 1e-6, its contract), parameters within
    1e-6, metrics within 1e-5 relative;
18. full step: the engine's own ``engine.full_env.step`` (pack,
    ``env_step_kernel``, unpack) at 8192 envs x 32 steps of the battery
    (every action class, an illegal action in every 11th env, envs on their
    last hand, past the score cap and already done) against the plain
    no-reset step on the card, bit for bit (packed state, reward, done);
    ``step_autoreset`` (``env_step_kernel``, then ``env_reset_kernel`` on
    the done envs) against the plain step plus the engine's torch reset,
    and ``env_reset_kernel`` on each step's done envs against its plain
    version; ``observe_vector`` and ``action_mask`` (K3b) against their
    plain rows;
19. generic PPO: ``make_ppo(full_env_hooks())`` with the ``fast_decay``
    recipe but ``fused_rollout=False``, 8192 x 128, ``ActorCritic(256,
    256)``, 3 updates, the launch counters reset before and read after
    (``env_step_fused`` and ``env_reset_fused`` 128 each an update; K3b 2 a
    step and 2 for the last value; K3a and the sampler none); every action
    legal, metrics finite, parameters moved;
20. evaluate: a greedy anti-loop ``evaluate_policy`` of phase 19's policy,
    1024 episodes x 256 steps on the card (256 step launches, 1 reset);
21. gym shell: ``envs.BalatroGymEnv`` on the card for 100 random legal
    steps against the same shell on the CPU (observations with their numpy
    dtypes, rewards, dones), then ``BalatroEnvValidator``'s determinism and
    action-mask checks on the card;
22. imitation and resume: ``train.bc.make_bc`` at its default
    ``ActorCritic(256, 256)`` and 8192 envs, 3 updates with the launch
    counters reset before and read after (K3b 2, ``env_step_kernel`` and
    ``env_reset_kernel`` 1 each an update), against the same 3 updates over
    the kernels' plain versions on the card (observation, mask, expert
    targets and env states bit for bit but the observation's log1p row,
    within 1 ulp; loss and parameters within 1e-6);
    ``train.expert.rollout_expert`` at 8192 x 64, its actions replayed and
    every one legal under the mask, its reward above a masked-uniform
    random policy's from the same reset;
    ``collect_expert_trajectories(2, seed=7, max_steps=40)`` on the card
    against tests/fixtures/expert_regression.json (ints exact, floats within
    1e-4); and a fused ``fast_decay`` update at 8192 x 128 saved, restored
    into another state (``utils.checkpoint``) and the next update equal to
    the uninterrupted one bit for bit;
23. other learners and the macro shell: ``train.a2c.make_a2c`` at
    ``A2CConfig(n_envs=8192)`` (rollout 5, ``ActorCritic(256, 256)``) on
    the flagship env for 3 updates, the launch counters reset before and
    read after (K3b 2 a step and 2 for the last value, ``env_step_kernel``
    and ``env_reset_kernel`` 1 each a step), against the same updates over
    the kernels' plain versions on the card (masks, actions, rewards, dones
    and env states bit for bit, the normalised observation but its log1p
    row bit for bit and that row within 1e-5, parameters and RMSprop's
    ``nu`` within 1e-6); ``train.dqn.make_dqn`` at ``DQNConfig(n_envs=8192,
    steps_per_update=4)`` (100,000-transition ring, batch 512,
    ``QNetwork(256, 256)``) for 4 updates, the fourth wrapping the ring to
    ``buf_ptr`` 31,072 at ``buf_len`` 100,000 (K3b 4 a step,
    ``env_step_kernel`` and ``env_reset_kernel`` 1 each a step), against
    the plain versions likewise (the ring bit for bit but the observations'
    log1p row, within 1 ulp; parameters within 1e-6); ``envs.macro_env`` at
    8192 envs for 64 steps of seeded random legal actions on the card
    against the same on the CPU (every field, reward and observation
    exact), its ``BalatroMacroGymEnv`` for 100 steps on the card against
    the CPU's; and ``train.tune.tune`` at 2 trials x 2 updates of 1024 envs
    on the flagship env (``backend`` random-search, each trial's parameters
    ``_sample(random.Random(0))``'s);
24. data parallel (``parallel.mesh``): (a) two ranks share the card over
    gloo (NCCL refuses two ranks on one GPU), children of this script
    started by ``mesh.launch`` with a timeout, loading phase 2's build:
    ``make_distributed_ppo`` with the ``fast_decay`` recipe at 8192 x 128
    global (4096 envs a rank), 3 updates, each a replay of the collection's
    graph, on each rank the launch counters read as in phase 15 (the
    capture's in the first update; the last 2, under the profiler, K3a and
    the sampler 128, K3b 1 an update by kernel name), ``all_reduce`` called
    epochs x minibatches + 4 + 1 times an update on each rank, the ranks'
    parameters equal bit for bit after every update, every action legal,
    metrics finite; then phase 16's parity config over the 2 ranks, the fused
    update against the plain versions' on each rank's shard (trajectories
    and packed state bit for bit, the sampler's log-probs within 1e-6,
    parameters within 1e-6); (b) one rank over NCCL (in a child): the
    recipe's updates, each a replay of the learner's graph (the launch
    counters unchanged after the warm-up's capture), ``all_reduce`` as in
    (a), metrics finite; (c)
    over the 2 ranks, ``rollout_fused_sharded`` at 131072 x 256 sampled
    with the bench jokers (each rank == ``rollout_fused(seed + rank *
    n_local_tiles, 65536, ...)`` bit for bit, K4 once a rank), fed at 4096 x
    32 with phase 4's scripts (the ranks' shards, concatenated, == the
    one-process call), and ``rollout_full_sharded`` at 131072 x 32 sampled
    from the default reset (each rank == ``rollout_full_fused`` on its slice
    of the default reset with the strided seed; K2 and ``env_reset_kernel``
    once a rank); (d) ``python -m balatro_gym_tpu_torch.parallel.
    scaling_bench --env full`` runs on the card and exits 0.

Float32 matmuls run in full float32 (``allow_tf32`` stays False). The last
two lines are the kernels' JSON record (each kernel's launches on the path
that checked it and its largest difference from its plain version) and the
result line. Imports torch and the port only; the machine with the card has
no JAX.
"""
from __future__ import annotations

import contextlib
import copy
import datetime
import hashlib
import io
import json
import os
import random
import re
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np
import torch

from balatro_gym_tpu_torch.core.constants import Phase
from balatro_gym_tpu_torch.engine import full_env as FE
from balatro_gym_tpu_torch.engine import sim_env
from balatro_gym_tpu_torch.envs import BalatroEnvValidator, BalatroGymEnv, BalatroMacroGymEnv
from balatro_gym_tpu_torch.envs import macro_env as ME
from balatro_gym_tpu_torch.ops import alu_ceiling as AC
from balatro_gym_tpu_torch.ops import cuda_build
from balatro_gym_tpu_torch.ops import fused_full_battery as BAT
from balatro_gym_tpu_torch.ops import fused_full_rollout as FF
from balatro_gym_tpu_torch.ops import fused_policy_rollout as FP
from balatro_gym_tpu_torch.ops import fused_rollout as FR
from balatro_gym_tpu_torch.ops import hand_histograms as HH
from balatro_gym_tpu_torch.ops import kernel_rng as KR
from balatro_gym_tpu_torch.parallel import mesh as PM
from balatro_gym_tpu_torch.train import a2c as TA
from balatro_gym_tpu_torch.train import bc as BC
from balatro_gym_tpu_torch.train import dqn as TD
from balatro_gym_tpu_torch.train import evaluate as EV
from balatro_gym_tpu_torch.train import expert as EX
from balatro_gym_tpu_torch.train import ppo as TP
from balatro_gym_tpu_torch.train import trajectories as TJ
from balatro_gym_tpu_torch.train import tune as TT
from balatro_gym_tpu_torch.train.networks import ActorCritic
from balatro_gym_tpu_torch.utils.checkpoint import restore_train_state, save_train_state

N_ENVS, N_STEPS = 131072, 256          # bench.py's headline shape
BENCH_JOKERS = (1, 31, 34, 48, 72)
JOKER_SETS = np.asarray((
    (0, 0, 0, 0, 0), (1, 31, 34, 48, 72), (6, 7, 131, 135, 0),
    (18, 69, 16, 23, 108), (116, 118, 119, 2, 3), (147, 140, 128, 122, 61),
), np.int32)
RANDOM_JOKERS = (27, 117, 34, 16, 0)    # Misprint + Bloodstone (+ Abstract, Half)
FIELDS = ("hand_rank", "hand_suit", "deck_n", "money", "hands_left",
          "discards_left", "score", "episodes", "total_reward")
Z_MAX = 5.0     # means agree within 5 standard errors of their difference
DEV = "cuda"
FULL_CHECK_STEPS = 32                  # full-env kernel == plain at 131072 x this
FED_ENVS, FED_STEPS = 16384, 64
POLICY_ENVS, POLICY_STEPS = 8192, 256  # bench.py's policy_collect_steps_per_sec shape
POLICY_CHECK_STEPS = 16                # kernels == plain along this many main-path steps
LOG1P_ROW = FP.OBS_DIM - 6             # log1p(chips_needed) / 10: within 1 ulp
HIST_ENVS = 1 << 20                    # K5 at 1,048,576 envs
ALU_CHECK_TILES = 2
ALU_PROBE_REPS = 10                    # alu_ceiling.main's --reps: its path, not its rate
# scripts/train_headline_r04.py's fast_decay recipe, 5 updates
TRAIN = dict(n_envs=8192, rollout_len=128, epochs=1, minibatches=4, fused_rollout=True,
             bf16_compute=True, env_shuffle=True, total_updates=5, ent_coef_final=5e-4,
             lr_final=5e-5)
TRAIN_UPDATES = 5
PARITY = dict(n_envs=1024, rollout_len=8, epochs=2, minibatches=2, fused_rollout=True,
              total_updates=5, ent_coef_final=5e-4, lr_final=5e-5)
PARAM_ATOL, METRIC_RTOL = 1e-6, 1e-5    # the CPU tests' tolerances (tests/test_torch_ppo.py)
STEP_ENVS, STEP_CHECK_STEPS = 8192, 32  # the engine's step against plain, the fast_decay width
# The fast_decay recipe over the generic rollout (the engine's step, K3b), 3 updates
GENERIC = {**TRAIN, "fused_rollout": False, "total_updates": 3}
GENERIC_UPDATES = 3
EVAL_EPISODES, EVAL_STEPS = 1024, 256
GYM_STEPS = 100
# Phase 22: behaviour cloning at make_bc's default net, ActorCritic(256, 256),
# and the trainer's 8192 envs; the expert's rollout; the expert fixture
BC_ENVS, BC_UPDATES = 8192, 3
EXPERT_ENVS, EXPERT_STEPS = 8192, 64
EXPERT_FIXTURE = Path(__file__).resolve().parent / "tests" / "fixtures" / "expert_regression.json"
FIXTURE_ATOL = 1e-4     # the fixture's float64 rewards against the float32 engine's
# Phase 23: A2C and DQN at 8192 envs on the flagship env with their default
# nets, the macro env at 8192 envs, the search at 1024
A2C_ENVS, A2C_UPDATES = 8192, 3
DQN_ENVS, DQN_UPDATES, DQN_STEPS = 8192, 4, 4
MACRO_ENVS, MACRO_STEPS, MACRO_SHELL_STEPS = 8192, 64, 100
TUNE_TRIALS, TUNE_UPDATES, TUNE_ENVS = 2, 2, 1024
NORM_LOG1P_ATOL = 1e-5  # A2C's normalised log1p row: its statistics read the 1-ulp row


def log(phase, msg):
    print(f"[{phase}] {msg}", flush=True)


def sh(*cmd):
    return subprocess.run(cmd, capture_output=True, text=True, check=True).stdout.strip()


def max_abs_diff(a, b):
    return max(float((a[f].double() - b[f].double()).abs().max()) for f in FIELDS)


def assert_bitwise(a, b, what):
    for f in FIELDS:
        if not torch.equal(a[f], b[f]):
            bad = int((a[f] != b[f]).sum())
            raise AssertionError(f"{what}: {f} differs in {bad} entries")


def phase_device():
    smi = sh("nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader").splitlines()[0].strip()
    nvcc = sh(cuda_build.nvcc_path(), "--version").splitlines()[-1]
    print(smi, flush=True)
    log("1 device", f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()} | "
        f"nvidia-smi: {smi} | {nvcc} | torch {torch.__version__} "
        f"(CUDA {torch.version.cuda}) | python {sys.version.split()[0]}")


KERNEL_SOURCES = ("fused_rollout.cu", "fused_full_rollout.cu", "fused_policy_rollout.cu",
                  "hand_histograms.cu", "alu_ceiling.cu")


def ptxas_summary(text):
    """ptxas's register, stack and spill lines, each after the name of the
    kernel or function it belongs to."""
    out, name = [], "?"
    for ln in text.splitlines():
        m = re.search(r"(?:entry function|Function properties for) '?(\w+)", ln)
        if m:
            short = re.search(r"[a-z][a-z_]*_(?:kernel|state)|step", m.group(1))
            name = short.group(0) if short else m.group(1)[:24]
        elif "registers" in ln or "spill" in ln or "stack" in ln:
            out.append(f"{name}: {ln.replace('ptxas info    :', '').strip()}")
    return out


def phase_build():
    cuda_build.load_all(KERNEL_SOURCES)
    for source in KERNEL_SOURCES:
        info = cuda_build.build_log[source]
        ptxas = ptxas_summary(info["ptxas"])
        log("2 build", f"{source} ok in {info['seconds']:.1f} s (cached={info['cached']}) "
            f"-> {info['path']}; ptxas: {' | '.join(ptxas) or 'n/a'}")


def phase_main_path():
    FR.rollout_fused.launches = 0
    out = FR.rollout_fused(0, N_ENVS, N_STEPS, BENCH_JOKERS, device=DEV)
    torch.cuda.synchronize()
    launches = FR.rollout_fused.launches
    assert launches >= 1, "the main path launched no kernel"
    assert out["hand_rank"].shape == (N_ENVS, 8) and out["total_reward"].shape == (N_ENVS,)
    r = out["total_reward"]
    assert bool(torch.isfinite(r).all()), "non-finite reward"
    assert int(out["hand_rank"].min()) >= 2 and int(out["hand_rank"].max()) <= 14
    assert int(out["hand_suit"].min()) >= 0 and int(out["hand_suit"].max()) <= 3
    assert int(out["hands_left"].min()) >= 1 and int(out["hands_left"].max()) <= 4
    assert int(out["discards_left"].min()) >= 0 and int(out["discards_left"].max()) <= 3
    assert int(out["deck_n"].min()) >= 9 and int(out["deck_n"].max()) <= 44
    assert int(out["episodes"].sum()) > 0

    # The same call's plain version on the card: equal bit for bit over all
    # 256 steps (Threefry counters up to 2560).
    assert_bitwise(out, FR.rollout_fused_reference(0, N_ENVS, N_STEPS, BENCH_JOKERS,
                                                   device=DEV), "main path kernel vs plain")

    # The float64 engine's random rollout at the same shape: same
    # distribution (uniform legal actions), other random stream.
    key = torch.tensor([0, 1], dtype=torch.int64, device=DEV)
    _, rs, es = sim_env.rollout_random_per_env(key, N_ENVS, N_STEPS, BENCH_JOKERS)
    checks = []
    for name, k, s in (("reward", r.double(), rs), ("episodes", out["episodes"].double(),
                                                      es.double())):
        mk, ms = float(k.mean()) / N_STEPS, float(s.mean()) / N_STEPS
        se = (float(k.var()) / N_ENVS + float(s.var()) / N_ENVS) ** 0.5 / N_STEPS
        z = abs(mk - ms) / se
        checks.append(f"{name}/env-step kernel {mk:.6f} engine {ms:.6f} z={z:.2f}")
        assert z <= Z_MAX, f"{name} per env-step differs by {z:.2f} standard errors"
    log("3 main path", f"ok: rollout_fused {N_ENVS}x{N_STEPS} launches={launches}; "
        f"kernel == plain bitwise; {'; '.join(checks)}")
    return launches


def legal_script(jok, n_envs, n_steps, seed):
    """Mask-legal actions made with numpy against the torch sim engine, and
    the engine's replay of them (final state, reward sums, episodes)."""
    rng = np.random.default_rng(seed)
    k1, k2 = KR.seed_key(seed, device=DEV)
    st = sim_env.reset(torch.stack(KR.split_child(k1, k2, torch.arange(
        n_envs, device=DEV)), -1), torch.as_tensor(jok, device=DEV))
    acts = np.zeros((n_steps, n_envs), np.int32)
    tot = torch.zeros(n_envs, dtype=torch.float64, device=DEV)
    for t in range(n_steps):
        mask = sim_env.action_mask(st).cpu().numpy()
        cum = np.cumsum(mask, axis=1)
        acts[t] = np.argmax(cum > rng.random((n_envs, 1)) * cum[:, -1:], axis=1)
        st, rew, _ = sim_env.step_autoreset(st, torch.as_tensor(acts[t], device=DEV))
        tot += rew
    return acts, st, tot


def phase_fed():
    n, steps = 4096, 32
    jok = JOKER_SETS[np.arange(n) % len(JOKER_SETS)]
    acts, ref, tot = legal_script(jok, n, steps, seed=11)
    k = FR.rollout_fused(0, n, steps, jok, actions=acts, device=DEV)
    p = FR.rollout_fused_reference(0, n, steps, jok, actions=acts, device=DEV)
    torch.cuda.synchronize()
    assert_bitwise(k, p, "fed kernel vs plain")
    for f in ("hand_rank", "hand_suit", "deck_n", "money", "hands_left",
              "discards_left", "score"):
        want = getattr(ref, f)
        if not torch.equal(k[f].long(), want):
            raise AssertionError(f"fed kernel vs sim_env: {f} differs in "
                                 f"{int((k[f].long() != want).sum())} envs")
    rerr = float((k["total_reward"].double() - tot).abs().max())
    assert rerr <= 2e-3, f"fed kernel vs sim_env reward max abs err {rerr}"
    eps = int(k["episodes"].sum())
    log("4 fed parity", f"ok: {n}x{steps}, 6 joker sets; kernel == plain bitwise; "
        f"kernel == sim_env states, reward max abs err {rerr:.2e} (atol 2e-3); "
        f"{eps} episodes crossed")
    return max_abs_diff(k, p)


def phase_sampled():
    steps = 32
    mixed = np.concatenate([JOKER_SETS, [RANDOM_JOKERS]])
    mixed = mixed[np.arange(N_ENVS) % len(mixed)]
    err = 0.0
    for name, jok in (("bench", BENCH_JOKERS), ("misprint+bloodstone", RANDOM_JOKERS),
                      ("mixed", mixed)):
        k = FR.rollout_fused(5, N_ENVS, steps, jok, device=DEV)
        p = FR.rollout_fused_reference(5, N_ENVS, steps, jok, device=DEV)
        torch.cuda.synchronize()
        assert_bitwise(k, p, f"sampled kernel vs plain ({name})")
        err = max(err, max_abs_diff(k, p))
    log("5 sampled parity", f"ok: {N_ENVS}x{steps}, kernel == plain bitwise for bench, "
        "misprint+bloodstone and mixed joker sets")
    return err


def assert_full_equal(k, p, what):
    bad = FF.states_equal(k["state"], p["state"])
    if bad:
        raise AssertionError(f"{what}: state fields differ: {bad}")
    for f in ("total_reward", "episodes"):
        if not torch.equal(k[f], p[f]):
            raise AssertionError(f"{what}: {f} differs in {int((k[f] != p[f]).sum())} envs")


def full_max_abs_diff(k, p):
    diffs = [float((k[f].double() - p[f].double()).abs().max()) for f in ("total_reward",
                                                                           "episodes")]
    for name, a in vars(k["state"]).items():
        diffs.append(float((a.double() - getattr(p["state"], name).double()).abs().max()))
    return max(diffs)


def phase_full_main():
    FF.rollout_full_fused.launches = FP.env_reset_fused.launches = 0
    out = FF.rollout_full_fused(0, N_ENVS, N_STEPS, device=DEV)
    torch.cuda.synchronize()
    launches = FF.rollout_full_fused.launches
    assert launches >= 1, "the full-env main path launched no kernel"
    assert FP.env_reset_fused.launches == 1, "the default reset did not launch env_reset"
    st, r, epi = out["state"], out["total_reward"], out["episodes"]
    assert st.card_rank.shape == (N_ENVS, 64) and r.shape == (N_ENVS,) and epi.shape == (N_ENVS,)
    assert bool(torch.isfinite(r).all()), "non-finite reward"
    assert bool(torch.isin(st.phase, torch.tensor([int(p) for p in Phase], device=DEV)).all())
    ranks = st.card_rank[st.card_alive]
    assert int(ranks.min()) >= 2 and int(ranks.max()) <= 14, "alive slot rank outside [2, 14]"
    assert bool((st.hand_n >= 0).all() and (st.hand_n <= st.hand_size).all())
    assert int(st.money.min()) >= 0 and int(st.money.max()) < 10 ** 7
    assert int(st.ante.min()) >= 1 and int(st.ante.max()) <= 101
    assert int(epi.sum()) > 0 and not bool(st.done.any())

    # The same call, shorter, against its plain version on the card.
    k = FF.rollout_full_fused(0, N_ENVS, FULL_CHECK_STEPS, device=DEV)
    p = FF.rollout_full_rows_reference(0, N_ENVS, FULL_CHECK_STEPS, device=DEV)
    assert_full_equal(k, p, "full-env main path kernel vs plain")
    log("7 full main path", f"ok: rollout_full_fused {N_ENVS}x{N_STEPS} launches={launches} "
        f"(its default reset: env_reset 1); "
        f"{int(epi.sum())} episodes, mean reward/env-step "
        f"{float(r.double().mean()) / N_STEPS:.4f}, antes {int(st.ante.min())}-"
        f"{int(st.ante.max())}, phases {torch.bincount(st.phase.long(), minlength=3).tolist()}; "
        f"at {N_ENVS}x{FULL_CHECK_STEPS} kernel == plain bitwise")
    return launches, full_max_abs_diff(k, p)


def phase_full_fed():
    rng = np.random.default_rng(2)
    st = BAT.surgery(FF.rollout_full_rows_reference(3, FED_ENVS, 4, device=DEV)["state"], rng)
    s, script = st, []
    tot = torch.zeros(FED_ENVS, device=DEV)
    epi = torch.zeros(FED_ENVS, dtype=torch.int32, device=DEV)
    for _ in range(FED_STEPS):
        a = BAT.sample_legal(FF.legal_mask(s).cpu().numpy(), rng)
        script.append(a)
        o = FF.rollout_full_rows_reference(0, FED_ENVS, 1, actions=a[None], init_state=s)
        s, tot, epi = o["state"], tot + o["total_reward"], epi + o["episodes"]
    cov = BAT.coverage(np.stack(script))
    missing = [name for name, c in cov.items() if c == 0]
    assert not missing, f"fed battery never fed {missing}"
    k = FF.rollout_full_fused(0, FED_ENVS, FED_STEPS, init_state=st,
                              actions=torch.as_tensor(np.stack(script), device=DEV))
    plain = {"state": s, "total_reward": tot, "episodes": epi}
    assert_full_equal(k, plain, "fed battery kernel vs plain")
    log("8 full fed battery", f"ok: {FED_ENVS}x{FED_STEPS}, kernel == chained plain steps "
        f"bitwise; {int(epi.sum())} episodes; coverage {cov}")
    return full_max_abs_diff(k, plain), st, np.stack(script)


def policy_counts():
    return {"K3b": FP.observe_fused.launches, "K3a": FP.step_fused.launches,
            "sampler": FP.sample_fused.launches}


def obs_diff(got, want):
    """(max abs difference, entries of the log1p row that differ); every
    other row must be equal bit for bit, the log1p row within 1 ulp."""
    other = torch.arange(FP.OBS_DIM, device=got.device) != LOG1P_ROW
    if not torch.equal(got[:, other], want[:, other]):
        bad = torch.nonzero(got[:, other] != want[:, other])
        raise AssertionError(f"observation rows differ at {bad[:5].tolist()}")
    g, w = got[:, LOG1P_ROW], want[:, LOG1P_ROW]
    ulp = int((g.view(torch.int32) - w.view(torch.int32)).abs().max())
    assert ulp <= 1, f"log1p row off by {ulp} ulp"
    return float((got - want).abs().max()), int((g != w).sum())


def assert_step_equal(k, p, what):
    """K3a's outputs against its plain version's; returns obs_diff."""
    for name in ("cards", "ints", "rng"):
        if not torch.equal(k[0][name], p[0][name]):
            bad = int((k[0][name] != p[0][name]).sum())
            raise AssertionError(f"{what}: {name} differs in {bad} entries")
    assert torch.equal(k[1], p[1]), f"{what}: reward differs"
    assert torch.equal(k[2], p[2]), f"{what}: done differs"
    assert torch.equal(k[4], p[4]), f"{what}: mask differs"
    return obs_diff(k[3], p[3])


def make_policy():
    return ActorCritic(FP.N_ACTIONS, FP.OBS_DIM, (256, 256),
                       generator=torch.Generator().manual_seed(0)).to(DEV)


def phase_policy_main():
    assert not torch.backends.cuda.matmul.allow_tf32, "float32 matmuls must not use TF32"
    net = make_policy()
    st0 = FF.default_reset(0, POLICY_ENVS, DEV)
    FP.observe_fused.launches = FP.step_fused.launches = FP.sample_fused.launches = 0
    final, traj = FP.collect_policy_fused(net, st0, 0, POLICY_STEPS, device=DEV)
    torch.cuda.synchronize()
    launches = policy_counts()
    assert launches == {"K3b": 1, "K3a": POLICY_STEPS, "sampler": POLICY_STEPS}, launches
    shape = (POLICY_STEPS, POLICY_ENVS)
    for k, dt in (("action", torch.int32), ("log_prob", torch.float32),
                  ("value", torch.float32), ("reward", torch.float32), ("done", torch.bool)):
        assert traj[k].shape == shape and traj[k].dtype == dt, (k, traj[k].shape, traj[k].dtype)
    lp = traj["log_prob"]
    assert bool(torch.isfinite(lp).all() and (lp <= 0).all()), "log_prob not finite and <= 0"
    assert bool(torch.isfinite(traj["value"]).all() and torch.isfinite(traj["reward"]).all())
    assert final.ante.shape == (POLICY_ENVS,) and not bool(final.done.any())

    # Replay the recorded actions through K3a: each was legal under the mask
    # its step consumed (or no action was), and the run is deterministic.
    packed = FF.pack_full_state(st0)
    obs, mask = FP.observe_fused(packed, device=DEV)
    illegal = torch.zeros((), dtype=torch.int64, device=DEV)
    for t in range(POLICY_STEPS):
        a = traj["action"][t]
        ok = mask.gather(1, a.long()[:, None])[:, 0] | ~mask.any(1)
        illegal += (~ok).sum()
        packed, reward, done, obs, mask = FP.step_fused(packed, a, device=DEV)
        assert torch.equal(reward, traj["reward"][t]) and torch.equal(done, traj["done"][t])
    assert int(illegal) == 0, f"{int(illegal)} sampled actions were illegal"
    assert FF.states_equal(FF.unpack_full_state(packed), final) == []
    hist = torch.bincount(traj["action"].flatten().long(), minlength=60).cpu()
    log("10 policy main path", f"ok: collect_policy_fused {POLICY_ENVS}x{POLICY_STEPS} "
        f"ActorCritic(256, 256) launches={launches}; every action legal; "
        f"{int(traj['done'].sum())} episodes, mean reward/env-step "
        f"{float(traj['reward'].double().mean()):.4f}, log_prob in "
        f"[{float(lp.min()):.3f}, {float(lp.max()):.3f}], antes {int(final.ante.min())}-"
        f"{int(final.ante.max())}; actions play {int(hist[0])} discard {int(hist[1])} "
        f"select {int(hist[2:10].sum())} use {int(hist[10:15].sum())} shop "
        f"{int(hist[20:37].sum())} blind {int(hist[45:49].sum())}; allow_tf32=False")
    return launches, net, st0, traj, final


def other_layout(logits):
    """A copy of ``[B, 60]`` logits in the other layout: row-major if they
    are column-major, else column-major."""
    return logits.contiguous() if logits.stride(0) == 1 else logits.T.contiguous().T


def phase_policy_parity(net, st0, traj, final, battery):
    """Kernels against plain versions on the same inputs; K2 replay."""
    errs = {"K3a": 0.0, "K3b": 0.0, "sampler": 0.0}
    log1p_diff = {"K3a": 0, "K3b": 0}
    packed = FF.pack_full_state(st0)
    obs, mask = FP.observe_fused(packed, device=DEV)
    p_obs, p_mask = FP.observe_rows_reference(packed)
    assert torch.equal(mask, p_mask), "K3b mask differs"
    errs["K3b"], log1p_diff["K3b"] = obs_diff(obs, p_obs)
    for t, key in enumerate(FP.seed_key_rows(0, POLICY_STEPS, DEV)[:POLICY_CHECK_STEPS]):
        with torch.no_grad():
            logits, _ = net(obs, mask)
        pa, plp = FP.sample(key, logits)
        # the layout the main path gives the sampler, then the other one
        for layout in (logits, other_layout(logits)):
            a, lp = FP.sample_fused(key, layout, device=DEV)
            assert torch.equal(a, pa), (f"sampler step {t}, strides {layout.stride()}: "
                                        f"{int((a != pa).sum())} actions differ")
            assert torch.equal(a, traj["action"][t]), f"step {t}: the main path's action differs"
            errs["sampler"] = max(errs["sampler"], float((lp - plp).abs().max()))
            assert errs["sampler"] <= 1e-6, f"sampler log_prob differs by {errs['sampler']}"
        strides = (logits.stride(), other_layout(logits).stride())
        out = FP.step_fused(packed, a, device=DEV)
        e, n = assert_step_equal(out, FP.step_rows_reference(packed, a), f"K3a step {t}")
        errs["K3a"], log1p_diff["K3a"] = max(errs["K3a"], e), log1p_diff["K3a"] + n
        packed, _, _, obs, mask = out

    st, script = battery
    packed = FF.pack_full_state(st)
    for t in range(len(script)):
        a = torch.as_tensor(script[t], dtype=torch.int32, device=DEV)
        out = FP.step_fused(packed, a, device=DEV)
        e, n = assert_step_equal(out, FP.step_rows_reference(packed, a), f"K3a battery step {t}")
        errs["K3a"], log1p_diff["K3a"] = max(errs["K3a"], e), log1p_diff["K3a"] + n
        packed = out[0]

    # The main path's actions through K2: step by step, then in one call.
    packed = FF.pack_full_state(st0)
    tot = torch.zeros(POLICY_ENVS, device=DEV)
    for t in range(POLICY_STEPS):
        packed, r, d = FF._kernel_packed(packed, traj["action"][t][None].contiguous(), 0, 1)
        assert torch.equal(r, traj["reward"][t]), f"K2 replay step {t}: reward differs"
        assert torch.equal(d.bool(), traj["done"][t]), f"K2 replay step {t}: done differs"
        tot = tot + traj["reward"][t]
    assert FF.states_equal(FF.unpack_full_state(packed), final) == []
    whole = FF.rollout_full_fused(0, POLICY_ENVS, POLICY_STEPS, actions=traj["action"],
                                  init_state=st0, device=DEV)
    assert FF.states_equal(whole["state"], final) == [], "K2 replay: final state differs"
    assert torch.equal(whole["total_reward"], tot), "K2 replay: total reward differs"
    assert torch.equal(whole["episodes"], traj["done"].sum(0, dtype=torch.int32))
    log("11 policy parity", f"ok: {POLICY_ENVS}x{POLICY_CHECK_STEPS} of the main path: K3b, "
        f"sampler and K3a == plain (the sampler on the main path's logits, strides "
        f"{strides[0]}, and on a copy in the other layout, strides {strides[1]}: actions "
        f"bitwise, log_prob max abs err {errs['sampler']:.3g}); K3a == plain along the "
        f"{script.shape[1]}x{len(script)} fed "
        f"battery; "
        f"log1p row entries 1 ulp apart: K3b {log1p_diff['K3b']}, K3a {log1p_diff['K3a']}; "
        f"the main path's {POLICY_STEPS} recorded actions through K2 step by step and in "
        f"one call: rewards, dones and final state bitwise")
    return errs


def card_profile(fn):
    """The names of the kernels the card ran while ``fn`` ran, one a launch
    (a CUDA graph's replayed kernels included), from the profiler."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return [e.name for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]


POLICY_KERNELS = (("K3a", "policy_step_kernel"), ("K3b", "policy_observe_kernel"),
                  ("sampler", "policy_sample_kernel"))


def kernel_launches(names):
    """Launches of K3a, K3b and the sampler among ``card_profile``'s kernel
    names."""
    return {k: sum(kernel in n for n in names) for k, kernel in POLICY_KERNELS}


def phase_hist():
    g = torch.Generator(device=DEV).manual_seed(13)
    n = HIST_ENVS
    ranks = torch.randint(-1, 18, (n, 8), generator=g, device=DEV, dtype=torch.int32)
    suits = torch.randint(-1, 10, (n, 8), generator=g, device=DEV, dtype=torch.int32)
    mask = torch.rand(n, 8, generator=g, device=DEV) < 0.6
    HH.hand_histograms.launches = 0
    out = HH.hand_histograms(ranks, suits, mask, device=DEV)
    torch.cuda.synchronize()
    launches = HH.hand_histograms.launches
    assert launches == 1, launches
    err = 0.0
    for name, k, p in zip(("rank_hist", "suit_hist", "chips"), out,
                          HH.hand_histograms_reference(ranks, suits, mask)):
        err = max(err, float((k.double() - p.double()).abs().max()))
        if not torch.equal(k, p):
            raise AssertionError(f"K5 {name} differs in {int((k != p).sum())} entries")
    outside = int((((ranks < 0) | (ranks > 15)) & mask).sum())
    counted = int(out[0].sum())
    assert counted == int(mask.sum()) - outside, "an out-of-range rank was counted"
    log("13 hand histograms", f"ok: hand_histograms {n} envs launches={launches}; kernel == "
        f"plain bitwise ({outside} masked cards with a rank outside [0, 16) counted in no "
        f"bin)")
    return launches, err


def phase_alu():
    g = torch.Generator(device=DEV).manual_seed(14)
    seeded = torch.randint(-2 ** 31, 2 ** 31 - 1, (ALU_CHECK_TILES, 8, 8, 128), generator=g,
                           device=DEV, dtype=torch.int64).to(torch.int32)
    # Kernel == plain on seeded values and on the probe's own inputs at both
    # of its shapes.
    err = 0.0
    AC.alu_chains.launches = 0
    for what, x in ((f"{ALU_CHECK_TILES} seeded tiles", seeded),
                    *((f"the probe's {n} tiles", AC.probe_input(n, DEV))
                      for n in (AC.REFERENCE_TILES, AC.SATURATING_TILES))):
        k, p = AC.alu_chains(x, AC.ROUNDS, device=DEV), AC.alu_chains_reference(x, AC.ROUNDS)
        err = max(err, float((k.long() - p.long()).abs().max()))
        if not torch.equal(k, p):
            raise AssertionError(f"K6 differs from its plain version at {what} in "
                                 f"{int((k != p).sum())} entries")
    checked = AC.alu_chains.launches
    assert checked == 3, checked
    # The probe's own path, the one that gives the INT32 rate; its JSON line
    # (rates) is not this check's output.
    AC.alu_chains.launches = 0
    with contextlib.redirect_stdout(io.StringIO()):
        res = AC.main(["--rounds", str(AC.ROUNDS), "--reps", str(ALU_PROBE_REPS)])
    torch.cuda.synchronize()
    launches = AC.alu_chains.launches
    assert launches == 2 * (1 + 3 * ALU_PROBE_REPS), launches
    assert set(res["shapes"]) == {"reference_shape", "saturating"}, res["shapes"]
    log("14 alu ceiling", f"ok: kernel == plain bitwise at {ALU_CHECK_TILES} seeded tiles and "
        f"on the probe's inputs at {AC.REFERENCE_TILES} and {AC.SATURATING_TILES} tiles, x "
        f"{AC.ROUNDS} rounds ({checked} launches); alu_ceiling.main --reps {ALU_PROBE_REPS} "
        f"launches={launches}")
    return launches, err


def legal_count(traj):
    """Recorded actions not legal under the mask their step consumed (an
    env with no legal action takes any), summed on the card."""
    ok = traj.mask.gather(2, traj.action.long()[..., None])[..., 0] | ~traj.mask.any(2)
    return (~ok).sum()


def phase_train_main():
    cfg = TP.PPOConfig(**TRAIN)
    init_fn, update_fn, _ = TP.make_ppo(TP.full_env_hooks(), cfg, device=DEV)
    state = {"ts": init_fn([int(w) for w in KR.seed_key(0, device="cpu")])}
    p0 = [p.detach().clone() for p in TP.param_list(state["ts"].params)]
    illegal = torch.zeros((), dtype=torch.int64, device=DEV)
    episodes = torch.zeros((), dtype=torch.int64, device=DEV)
    history = []

    def run(n):
        nonlocal illegal, episodes
        for _ in range(n):
            rec = {}
            state["ts"], m = update_fn(state["ts"], record=rec)
            illegal += legal_count(rec["traj"])
            episodes += rec["traj"].done.sum()
            history.append(m)

    FP.observe_fused.launches = FP.step_fused.launches = FP.sample_fused.launches = 0
    run(1)                                 # captures the collection's graph, then replays it
    captured = policy_counts()
    launches = kernel_launches(card_profile(lambda: run(TRAIN_UPDATES - 1)))
    ts = state["ts"]
    T = cfg.rollout_len
    once = {"K3b": 1, "K3a": T, "sampler": T}
    # the wrappers count the capture's warm-up and capture; a replay launches no wrapper
    assert captured == {k: 2 * n for k, n in once.items()}, captured
    assert policy_counts() == captured, (policy_counts(), captured)
    assert update_fn.collection.replays == TRAIN_UPDATES, update_fn.collection.replays
    want = {k: (TRAIN_UPDATES - 1) * n for k, n in once.items()}
    assert launches == want, (launches, want)
    assert int(illegal) == 0, f"{int(illegal)} sampled actions were illegal"
    hist = [{k: float(v) for k, v in m.items()} for m in history]
    assert all(np.isfinite(v) for m in hist for v in m.values()), hist
    moved = max(float((p.detach() - q).abs().max()) for p, q in zip(TP.param_list(ts.params), p0))
    assert moved > 0, "the parameters did not move"
    assert int(episodes) > 0, "no episode ended"
    log("15 trainer main path", f"ok: make_ppo(full_env_hooks(), fast_decay) "
        f"{cfg.n_envs}x{T}, ActorCritic(256, 256), {TRAIN_UPDATES} updates, {TRAIN_UPDATES} "
        f"collection graph replays; the wrappers' launches in the capture {captured}, "
        f"launches in the last {TRAIN_UPDATES - 1} updates (profiler) {launches}; "
        f"every action legal; {int(episodes)} episodes; params moved (max {moved:.3g}); "
        f"metrics by update: {[{k: round(v, 5) for k, v in m.items()} for m in hist]}")
    return launches


def phase_train_parity():
    errs = {"params": 0.0, "metrics_rel": 0.0, "log_prob": 0.0}
    for bf16, shuffle in ((True, True), (False, False)):
        cfg = TP.PPOConfig(**PARITY, bf16_compute=bf16, env_shuffle=shuffle)
        init_fn, fused, _ = TP.make_ppo(TP.full_env_hooks(), cfg, device=DEV)
        plain_hooks = TP.full_env_hooks()._replace(
            fused_ops=(FP.observe_rows_reference, FP.sample, FP.step_rows_reference))
        _, plain, _ = TP.make_ppo(plain_hooks, cfg, device=DEV)
        ts = init_fn([int(w) for w in KR.seed_key(1, device="cpu")])
        for _ in range(2):                                 # a mid-game start
            ts, _ = fused(ts)
        tp = copy.deepcopy(ts)
        rk, rp = {}, {}
        ts, mk = fused(ts, record=rk)
        tp, mp = plain(tp, record=rp)
        torch.cuda.synchronize()
        what = f"trainer parity (bf16={bf16}, env_shuffle={shuffle})"
        for name in TP.Transition._fields:
            a, b = getattr(rk["traj"], name), getattr(rp["traj"], name)
            if name == "log_prob":                  # the sampler's contract: within 1e-6
                errs["log_prob"] = max(errs["log_prob"], float((a - b).abs().max()))
                assert errs["log_prob"] <= 1e-6, f"{what}: log_prob off by {errs['log_prob']}"
            elif not torch.equal(a, b):
                raise AssertionError(f"{what}: trajectory {name} differs in "
                                     f"{int((a != b).sum())} entries")
        assert torch.equal(rk["raw"], rp["raw"]), f"{what}: raw rewards differ"
        for k in ("cards", "ints", "rng"):
            assert torch.equal(ts.env_states[k], tp.env_states[k]), f"{what}: packed {k}"
        d = max(float((a.detach() - b.detach()).abs().max())
                for a, b in zip(TP.param_list(ts.params), TP.param_list(tp.params)))
        r = max(abs(float(mk[k]) - float(mp[k])) / max(abs(float(mp[k])), 1e-30) for k in mk)
        assert d <= PARAM_ATOL, f"{what}: params differ by {d}"
        assert all(abs(float(mk[k]) - float(mp[k])) <= METRIC_RTOL * abs(float(mp[k])) + 1e-7
                   for k in mk), f"{what}: metrics {mk} vs {mp}"
        errs["params"], errs["metrics_rel"] = max(errs["params"], d), max(errs["metrics_rel"], r)
    log("16 trainer parity", f"ok: {PARITY['n_envs']}x{PARITY['rollout_len']}, 2 epochs x 2 "
        f"minibatches, bf16+env_shuffle and f32+flat shuffle: fused update == plain update "
        f"(trajectories and packed state bitwise, the sampler's log-probs within "
        f"{errs['log_prob']:.3g}), params max abs diff {errs['params']:.3g} "
        f"(atol {PARAM_ATOL}), metrics max rel diff {errs['metrics_rel']:.3g}")
    return errs


def phase_env_step():
    """The engine's step (env_step_kernel) and reset (env_reset_kernel),
    and step_autoreset, against their plain versions along a fed battery;
    the policy inputs against theirs."""
    n = STEP_ENVS
    rng = np.random.default_rng(18)
    st = BAT.surgery(FF.rollout_full_rows_reference(4, n, 4, device=DEV)["state"], rng)
    env = torch.arange(n, device=DEV)
    st.hands_left = torch.where((env % 8 == 3) & (st.phase == 0), 1, st.hands_left)
    st.chips_scored = torch.where(env % 64 == 5, 1_000_000_001, st.chips_scored)
    st.done = st.done | (env % 64 == 37)
    errs = {"reward": 0.0, "obs": 0.0, "reset": 0.0}
    counts = {"ended": 0, "illegal": 0, "log1p_ulp": 0}
    k0 = generic_counts()
    script = []
    for t in range(STEP_CHECK_STEPS):
        obs, mask = FE.observe_vector(st), FE.action_mask(st)
        p_obs, p_mask = FP.observe_rows_reference(FF.pack_full_state(st))
        assert torch.equal(mask, p_mask), f"step {t}: action_mask differs from its plain rows"
        e, nd = obs_diff(obs, p_obs)
        errs["obs"], counts["log1p_ulp"] = max(errs["obs"], e), counts["log1p_ulp"] + nd
        a = BAT.sample_legal(mask.cpu().numpy(), rng)
        for i in np.flatnonzero(np.arange(n) % 11 == t % 11):
            illegal = np.flatnonzero(~mask[i].cpu().numpy())
            a[i] = rng.choice(illegal)
        script.append(a)
        a = torch.as_tensor(a, device=DEV)
        s1, r1, d1 = FE.step(st, a)
        sp, rp, dp = FF._step(FF._load(FF.pack_full_state(st)), a, autoreset=False)
        plain = FF._store(sp)
        for k, v in FF.pack_full_state(s1).items():
            if not torch.equal(v, plain[k]):
                raise AssertionError(f"step {t}: env_step {k} differs in "
                                     f"{int((v != plain[k]).sum())} entries")
        assert torch.equal(d1, dp), f"step {t}: done differs"
        errs["reward"] = max(errs["reward"], float((r1 - rp).abs().max()))
        assert torch.equal(r1, rp), f"step {t}: reward differs by {errs['reward']}"
        s2, r2, d2 = FE.step_autoreset(st, a)
        final = FF.unpack_full_state(plain)
        k1, k2 = KR.fold_in(final.key[:, 0], final.key[:, 1], final.step_count.to(torch.int64))
        want = FE.where_envs(dp, FE.reset_reference(torch.stack([k1, k2], -1)), final)
        bad = FF.states_equal(s2, want)
        assert not bad, f"step {t}: step_autoreset differs from plain step + reset in {bad}"
        assert torch.equal(r2, rp) and torch.equal(d2, dp)
        rows = {k: v.clone() for k, v in plain.items()}
        FP.env_reset_fused(rows, dp, device=DEV)
        want = FP.env_reset_rows_reference(plain, dp)
        errs["reset"] = max(errs["reset"], *(float((rows[k].long() - want[k].long()).abs().max())
                                             for k in rows))
        assert all(torch.equal(rows[k], want[k]) for k in rows), f"step {t}: env_reset differs"
        counts["ended"] += int(d1.sum())
        counts["illegal"] += int((~mask.gather(1, a.long()[:, None])[:, 0]).sum())
        st = s2
    torch.cuda.synchronize()
    launched = {k: v - k0[k] for k, v in generic_counts().items()}
    assert launched == {"env_step": 2 * STEP_CHECK_STEPS, "env_reset": 2 * STEP_CHECK_STEPS,
                        "K3b": 2 * STEP_CHECK_STEPS, "K3a": 0, "sampler": 0}, launched
    cov = BAT.coverage(np.stack(script))
    assert all(v > 0 for v in cov.values()), cov
    assert counts["ended"] > 0 and counts["illegal"] > 0

    log("18 full step", f"ok: {n} envs x {STEP_CHECK_STEPS} steps of the battery "
        f"(coverage {cov}; {counts['illegal']} illegal actions, {counts['ended']} ends): "
        f"full_env.step (env_step_kernel) == plain no-reset step "
        f"bitwise (packed state, reward, done); step_autoreset (env_step_kernel, then "
        f"env_reset_kernel) == plain step + the engine's torch reset bitwise; env_reset_kernel "
        f"on each step's done envs == its plain version bitwise; observe_vector and "
        f"action_mask (K3b) == plain rows (log1p row entries 1 ulp apart: "
        f"{counts['log1p_ulp']}); launches {launched}")
    return max(errs["reward"], errs["obs"]), errs["reset"]


ENGINE_WRAPPERS = {"env_step": FP.env_step_fused, "env_reset": FP.env_reset_fused,
                   "K3b": FP.observe_fused, "K3a": FP.step_fused, "sampler": FP.sample_fused}


def generic_counts():
    return {name: fn.launches for name, fn in ENGINE_WRAPPERS.items()}


def zero_counts():
    for fn in ENGINE_WRAPPERS.values():
        fn.launches = 0


def phase_generic_train():
    """The fast_decay recipe over the generic rollout: the engine's step
    kernel and K3b, the policy and ``categorical`` in torch."""
    cfg = TP.PPOConfig(**GENERIC)
    init_fn, update_fn, _ = TP.make_ppo(TP.full_env_hooks(), cfg, device=DEV)
    ts = init_fn([int(w) for w in KR.seed_key(0, device="cpu")])
    p0 = [p.detach().clone() for p in TP.param_list(ts.params)]
    illegal = torch.zeros((), dtype=torch.int64, device=DEV)
    episodes = torch.zeros((), dtype=torch.int64, device=DEV)
    zero_counts()
    hist = []
    for _ in range(GENERIC_UPDATES):
        rec = {}
        ts, m = update_fn(ts, record=rec)
        illegal += legal_count(rec["traj"])
        episodes += rec["traj"].done.sum()
        hist.append({k: float(v) for k, v in m.items()})
    launches = generic_counts()
    T = cfg.rollout_len
    want = {"env_step": GENERIC_UPDATES * T, "env_reset": GENERIC_UPDATES * T,
            "K3b": GENERIC_UPDATES * 2 * (T + 1), "K3a": 0, "sampler": 0}
    assert launches == want, (launches, want)
    assert int(illegal) == 0, f"{int(illegal)} sampled actions were illegal"
    assert all(np.isfinite(v) for m in hist for v in m.values()), hist
    moved = max(float((p.detach() - q).abs().max()) for p, q in zip(TP.param_list(ts.params), p0))
    assert moved > 0 and int(episodes) > 0
    log("19 generic PPO", f"ok: make_ppo(full_env_hooks(), fast_decay, fused_rollout=False) "
        f"{cfg.n_envs}x{T}, ActorCritic(256, 256), {GENERIC_UPDATES} updates, launches="
        f"{launches} (env_step {T} an update, K3b 2 a step and 2 for the last value); every "
        f"action legal; {int(episodes)} episodes; params moved (max {moved:.3g}); metrics by "
        f"update {[{k: round(v, 5) for k, v in m.items()} for m in hist]}")
    return ts, launches


def phase_evaluate(ts):
    """A greedy anti-loop evaluation of phase 19's policy on the card."""
    n0 = (FP.env_step_fused.launches, FP.env_reset_fused.launches)
    stats = EV.evaluate_policy(lambda p, o, m: p(o, m), ts.params, TP.full_env_hooks(),
                               EVAL_EPISODES, EVAL_STEPS, seed=7, obs_stats=ts.obs_stats)
    assert (FP.env_step_fused.launches - n0[0], FP.env_reset_fused.launches - n0[1]) == (
        EVAL_STEPS, 1)
    assert set(stats) == {"episodes", "mean_reward", "mean_length", "max_reward",
                          "mean_ante", "max_ante"}, stats
    assert 0 <= stats["episodes"] <= EVAL_EPISODES and 0 < stats["mean_length"] <= EVAL_STEPS
    assert np.isfinite(stats["mean_reward"]) and stats["max_ante"] >= 1
    log("20 evaluate", f"ok: evaluate_policy greedy anti-loop, {EVAL_EPISODES} episodes x "
        f"{EVAL_STEPS} steps, phase 19's policy and statistics: {stats}; env_step launches "
        f"{EVAL_STEPS}, env_reset 1 (its reset)")


def phase_gym():
    """The Gym shell on the card: random legal steps against the same shell
    on the CPU, and the validator's two checks."""
    card, cpu = BalatroGymEnv(seed=21), BalatroGymEnv(seed=21, device="cpu")
    o, _ = card.reset()
    oc, _ = cpu.reset()
    rng = np.random.default_rng(21)
    ends, reward = 0, 0.0
    for t in range(GYM_STEPS):
        assert o.keys() == oc.keys() and all(
            o[k].dtype == oc[k].dtype and np.array_equal(o[k], oc[k]) for k in o), t
        a = int(rng.choice(np.flatnonzero(o["action_mask"])))
        o, r, d, _, _ = card.step(a)
        oc, rc, dc, _, _ = cpu.step(a)
        assert (r, d) == (rc, dc), (t, r, rc, d, dc)
        reward += r
        if d:
            ends += 1
            o, _ = card.reset()
            oc, _ = cpu.reset()
    assert BalatroEnvValidator.validate_determinism()
    assert BalatroEnvValidator.validate_action_masking()
    log("21 gym shell", f"ok: BalatroGymEnv on the card, {GYM_STEPS} random legal steps == the "
        f"same shell on the CPU (observations with their dtypes, rewards, dones); {ends} "
        f"episodes ended, reward {reward:.2f}; validate_determinism and "
        f"validate_action_masking on the card pass")


def plain_engine_hooks():
    """The flagship env's hooks over the kernels' plain versions on the
    card: the observation and mask from K3b's plain rows, the step from
    ``env_step_kernel``'s plain rows, the resets ``env_reset_kernel``'s
    (the engine's torch reset)."""
    def inputs(st):
        return FP.observe_rows_reference(FF.pack_full_state(st))

    def step_autoreset(st, actions):
        packed, reward, done = FP.env_step_rows_reference(FF.pack_full_state(st),
                                                          actions.to(torch.int32))
        packed = FP.env_reset_rows_reference(packed, done)
        return FF.unpack_full_state(packed), reward, done

    return TP.full_env_hooks()._replace(reset=FE.reset_reference,
                                        observe=lambda st: inputs(st)[0],
                                        action_mask=lambda st: inputs(st)[1],
                                        step_autoreset=step_autoreset)


def snapshot_equal(a, b):
    """Keys of two checkpoint files' flat dicts whose values differ."""
    fa, fb = (torch.load(Path(p) / "state.pt", weights_only=True) for p in (a, b))
    assert fa.keys() == fb.keys()
    return [k for k in fa if not (torch.equal(fa[k], fb[k]) if torch.is_tensor(fa[k])
                                  else fa[k] == fb[k])]


def fixture_diff(got, want, path=""):
    """Largest float difference between two trajectory trees; raises where
    their structure, types, ints or bools differ."""
    assert type(got) is type(want), (path, type(got), type(want))
    if isinstance(want, dict):
        assert got.keys() == want.keys(), (path, got.keys() ^ want.keys())
        return max((fixture_diff(got[k], want[k], f"{path}.{k}") for k in want), default=0.0)
    if isinstance(want, list):
        assert len(got) == len(want), (path, len(got), len(want))
        return max((fixture_diff(g, w, f"{path}[{i}]") for i, (g, w) in enumerate(zip(got, want))),
                   default=0.0)
    if isinstance(want, float):
        return abs(got - want)
    assert got == want, (path, got, want)
    return 0.0


def phase_imitation():
    """The imitation path on the card: behaviour cloning against the same
    updates over the plain versions, the expert's rollout against a random
    policy, the expert fixture, and a resumed fused-trainer update."""
    key = [int(w) for w in KR.seed_key(0, device="cpu")]
    init_fn, update_fn = BC.make_bc(BC_ENVS, device=DEV)
    plain_init, plain_update = BC.make_bc(BC_ENVS, hooks=plain_engine_hooks(), device=DEV)

    # BC: 3 updates through the kernels, the launch counters reset before
    # and read after; then the same 3 over the plain versions
    bc = init_fn(key)
    runs = {"card": [], "plain": []}
    zero_counts()
    for _ in range(BC_UPDATES):
        rec = {}
        bc, m = update_fn(bc, record=rec)
        runs["card"].append((rec, m, bc.env_states, [p.detach().clone() for p in TP.param_list(bc.params)]))
    torch.cuda.synchronize()
    launches = generic_counts()
    want = {"env_step": BC_UPDATES, "env_reset": BC_UPDATES, "K3b": 2 * BC_UPDATES, "K3a": 0,
            "sampler": 0}
    assert launches == want, (launches, want)
    bp = plain_init(key)
    for _ in range(BC_UPDATES):
        rec = {}
        bp, m = plain_update(bp, record=rec)
        runs["plain"].append((rec, m, bp.env_states, [p.detach().clone() for p in TP.param_list(bp.params)]))
    errs = {"obs": 0.0, "log1p_entries": 0, "loss": 0.0, "params": 0.0}
    for u, (k, p) in enumerate(zip(runs["card"], runs["plain"])):
        d, n_log1p = obs_diff(k[0]["obs"], p[0]["obs"])
        errs["obs"], errs["log1p_entries"] = max(errs["obs"], d), errs["log1p_entries"] + n_log1p
        assert torch.equal(k[0]["mask"], p[0]["mask"]), f"BC update {u}: mask"
        assert torch.equal(k[0]["target"], p[0]["target"]), f"BC update {u}: targets"
        bad = FF.states_equal(k[2], p[2])
        assert bad == [], f"BC update {u}: env state fields differ: {bad}"
        errs["loss"] = max(errs["loss"], abs(float(k[1]["bc_loss"]) - float(p[1]["bc_loss"])))
        errs["params"] = max(errs["params"], max(float((a - b).abs().max())
                                                 for a, b in zip(k[3], p[3])))
    assert errs["loss"] <= PARAM_ATOL and errs["params"] <= PARAM_ATOL, errs
    hist = [{n: float(v) for n, v in r[1].items()} for r in runs["card"]]
    assert all(np.isfinite(v) for m in hist for v in m.values()), hist
    del runs, bp

    # the expert's rollout, its actions replayed and checked legal, and a
    # masked-uniform random policy from the same reset
    ekey = (0, 11)
    fin, e_total, e_eps, e_ante = EX.rollout_expert(ekey, EXPERT_ENVS, EXPERT_STEPS, device=DEV)
    k1, k2 = (torch.tensor(w, dtype=torch.int64, device=DEV) for w in ekey)
    reset = FE.reset(torch.stack(KR.split_child(k1, k2, torch.arange(EXPERT_ENVS, device=DEV)), -1))
    st, total, illegal = reset, torch.zeros((), device=DEV), 0
    for _ in range(EXPERT_STEPS):
        a = EX.expert_action(st)
        illegal += int((~FE.action_mask(st).gather(1, a.long()[:, None])).sum())
        st, r, _ = FE.step_autoreset(st, a)
        total = total + r.sum()
    assert illegal == 0, f"{illegal} expert actions were illegal"
    assert float(total) == float(e_total), (float(total), float(e_total))
    assert FF.states_equal(st, fin) == []
    st, r_total = reset, torch.zeros((), device=DEV)
    for k in KR.split_keys((0, 9), EXPERT_STEPS):
        a, _ = TP.categorical(k, torch.where(FE.action_mask(st), 0.0, -torch.inf))
        st, r, _ = FE.step_autoreset(st, a)
        r_total = r_total + r.sum()
    assert float(e_total) > float(r_total), (float(e_total), float(r_total))

    # the expert fixture on the card
    want_fx = json.loads(EXPERT_FIXTURE.read_text())
    got_fx = TJ.collect_expert_trajectories(2, seed=7, max_steps=40, device=DEV)
    fx_err = fixture_diff(got_fx, want_fx)
    assert fx_err <= FIXTURE_ATOL, fx_err

    # resume: one fused fast_decay update, save, restore into another
    # state, and the next update equals the uninterrupted one bit for bit
    cfg = TP.PPOConfig(**TRAIN)
    t_init, t_update, _ = TP.make_ppo(TP.full_env_hooks(), cfg, device=DEV)
    ts, _ = t_update(t_init(key))
    with tempfile.TemporaryDirectory() as tmp:
        save_train_state(Path(tmp) / "step_1", ts)
        restored = restore_train_state(Path(tmp) / "step_1", t_init([0, 1]))
        cont, m_cont = t_update(ts)
        res, m_res = t_update(restored)
        save_train_state(Path(tmp) / "cont", cont)
        save_train_state(Path(tmp) / "res", res)
        bad = snapshot_equal(Path(tmp) / "cont", Path(tmp) / "res")
        ckpt_mb = (Path(tmp) / "step_1" / "state.pt").stat().st_size / 2 ** 20
    assert bad == [], f"the resumed update differs in {bad[:5]}"
    assert all(torch.equal(m_cont[k], m_res[k]) for k in m_cont), (m_cont, m_res)
    log("22 imitation and resume", f"ok: make_bc({BC_ENVS}), ActorCritic(256, 256), "
        f"{BC_UPDATES} updates, launches={launches} (K3b 2 and env_step_kernel 1 an update); "
        f"== the same updates over the plain versions on the card (obs, mask, targets and "
        f"env states bit for bit, the log1p row within 1 ulp: {errs['log1p_entries']} entries "
        f"differ, max {errs['obs']:.3g}; loss within {errs['loss']:.3g}, params within "
        f"{errs['params']:.3g}); metrics {[{n: round(v, 5) for n, v in m.items()} for m in hist]}; "
        f"rollout_expert {EXPERT_ENVS}x{EXPERT_STEPS}: reward {float(e_total):.2f} > random "
        f"{float(r_total):.2f} from the same reset, {int(e_eps)} episodes, max ante "
        f"{int(e_ante)}, every action legal; expert fixture (2 x 40) == "
        f"tests/fixtures/expert_regression.json (ints exact, floats within {fx_err:.3g}); "
        f"fused fast_decay {cfg.n_envs}x{cfg.rollout_len}: the update after a restore == the "
        f"uninterrupted one bit for bit (snapshot {ckpt_mb:.1f} MiB)")
    return launches


def compared_updates(update_fn, ts, plain_update, tp, updates, compare):
    """``updates`` updates through the kernels, each followed by the same
    update over the plain versions, which ``compare(u, card record, plain
    record, card state, plain state)`` holds against it. Returns (state,
    metrics by update)."""
    hist = []
    for u in range(updates):
        rk, rp = {}, {}
        ts, m = update_fn(ts, record=rk)
        hist.append({k: float(v) for k, v in m.items()})
        tp, _ = plain_update(tp, record=rp)
        compare(u, rk, rp, ts, tp)
    return ts, hist


def max_param_diff(a, b):
    return max(float((x.detach() - y.detach()).abs().max()) for x, y in zip(a, b))


def phase_other_learners():
    """A2C and DQN on the flagship env against the same updates over the
    plain versions, the macro env and shell on the card against the CPU,
    and the hyperparameter search."""
    key = [int(w) for w in KR.seed_key(0, device="cpu")]
    other = torch.arange(FP.OBS_DIM, device=DEV) != LOG1P_ROW

    # A2C
    cfg = TA.A2CConfig(n_envs=A2C_ENVS)
    init_fn, update_fn = TA.make_a2c(TP.full_env_hooks(), cfg, device=DEV)
    _, plain_update = TA.make_a2c(plain_engine_hooks(), cfg, device=DEV)
    ts = init_fn(key)
    a2c_err = {"obs_log1p": 0.0, "params": 0.0, "nu": 0.0}

    def a2c_compare(u, rk, rp, ts, tp):
        for k in ("mask", "action", "reward", "done"):
            assert torch.equal(rk[k], rp[k]), f"A2C update {u}: {k}"
        assert torch.equal(rk["obs"][..., other], rp["obs"][..., other]), f"A2C update {u}: obs"
        a2c_err["obs_log1p"] = max(a2c_err["obs_log1p"], float((rk["obs"] - rp["obs"]).abs().max()))
        bad = FF.states_equal(ts.env_states, tp.env_states)
        assert bad == [], f"A2C update {u}: env state fields differ: {bad}"
        a2c_err["params"] = max(a2c_err["params"], max_param_diff(
            TP.param_list(ts.params), TP.param_list(tp.params)))
        a2c_err["nu"] = max(a2c_err["nu"], max_param_diff(ts.opt_state.nu, tp.opt_state.nu))

    zero_counts()
    ts, a2c_hist = compared_updates(update_fn, ts, plain_update, copy.deepcopy(ts),
                                    A2C_UPDATES, a2c_compare)
    a2c_launches = generic_counts()
    T = cfg.rollout_len
    want = {"env_step": A2C_UPDATES * T, "env_reset": A2C_UPDATES * T,
            "K3b": A2C_UPDATES * (2 * T + 2), "K3a": 0, "sampler": 0}
    assert a2c_launches == want, (a2c_launches, want)
    assert a2c_err["obs_log1p"] <= NORM_LOG1P_ATOL, a2c_err
    assert a2c_err["params"] <= PARAM_ATOL and a2c_err["nu"] <= PARAM_ATOL, a2c_err
    assert all(np.isfinite(v) for m in a2c_hist for v in m.values()), a2c_hist
    del ts

    # DQN: the fourth update wraps the ring
    dcfg = TD.DQNConfig(n_envs=DQN_ENVS, steps_per_update=DQN_STEPS)
    init_fn, update_fn = TD.make_dqn(TP.full_env_hooks(), dcfg, device=DEV)
    _, plain_update = TD.make_dqn(plain_engine_hooks(), dcfg, device=DEV)
    ts = init_fn(key)
    dqn_err = {"obs_log1p_entries": 0, "params": 0.0, "target": 0.0}

    def dqn_compare(u, rk, rp, ts, tp):
        for k in ("action", "reward", "done", "sample"):
            assert torch.equal(rk[k], rp[k]), f"DQN update {u}: {k}"
        assert rk["ready"] == rp["ready"] and (ts.buf_ptr, ts.buf_len) == (tp.buf_ptr, tp.buf_len)
        for name in ("buf_obs", "buf_next_obs"):
            dqn_err["obs_log1p_entries"] += obs_diff(getattr(ts, name), getattr(tp, name))[1]
        for name in ("buf_action", "buf_reward", "buf_next_mask", "buf_done"):
            assert torch.equal(getattr(ts, name), getattr(tp, name)), f"DQN update {u}: {name}"
        assert FF.states_equal(ts.env_states, tp.env_states) == [], f"DQN update {u}"
        dqn_err["params"] = max(dqn_err["params"], max_param_diff(
            TP.param_list(ts.params), TP.param_list(tp.params)))
        dqn_err["target"] = max(dqn_err["target"], max_param_diff(
            TP.param_list(ts.target_params), TP.param_list(tp.target_params)))

    zero_counts()
    ts, dqn_hist = compared_updates(update_fn, ts, plain_update, copy.deepcopy(ts),
                                    DQN_UPDATES, dqn_compare)
    dqn_launches = generic_counts()
    want = {"env_step": DQN_UPDATES * DQN_STEPS, "env_reset": DQN_UPDATES * DQN_STEPS,
            "K3b": DQN_UPDATES * 4 * DQN_STEPS, "K3a": 0, "sampler": 0}
    assert dqn_launches == want, (dqn_launches, want)
    ring = (ts.buf_ptr, ts.buf_len)
    assert ring == (DQN_UPDATES * DQN_STEPS * DQN_ENVS % dcfg.buffer_size, dcfg.buffer_size), ring
    assert ts.opt_state.count == DQN_UPDATES, ts.opt_state.count
    assert dqn_err["params"] <= PARAM_ATOL and dqn_err["target"] <= PARAM_ATOL, dqn_err
    assert all(np.isfinite(v) for m in dqn_hist for v in m.values()), dqn_hist
    del ts

    # the macro env: the card against the CPU, step by step
    keys = torch.stack(KR.split_child(torch.tensor(0), torch.tensor(23),
                                      torch.arange(MACRO_ENVS)), -1)
    sc, sk = ME.reset(keys), ME.reset(keys.to(DEV))
    g = torch.Generator().manual_seed(23)
    ends = 0
    for t in range(MACRO_STEPS):
        mask = ME.action_mask(sc)
        assert torch.equal(ME.action_mask(sk).cpu(), mask), f"macro step {t}: mask"
        # a done env (past ante 8) has no legal action and stays as it is
        a = torch.multinomial(mask.float() + ~mask.any(1, keepdim=True), 1,
                              generator=g)[:, 0].to(torch.int32)
        sk, rk, dk = ME.step(sk, a.to(DEV))
        sc, rc, dc = ME.step(sc, a)
        assert torch.equal(rk.cpu(), rc) and torch.equal(dk.cpu(), dc), f"macro step {t}"
        for name, v in vars(sc).items():
            assert torch.equal(getattr(sk, name).cpu(), v), f"macro step {t}: {name}"
        ok = ME.observe(sk)
        for name, v in ME.observe(sc).items():
            assert torch.equal(ok[name].cpu(), v), f"macro step {t}: observation {name}"
        ends += int(dc.sum())
    macro_ante = int(sc.ante.max())
    card_shell, cpu_shell = BalatroMacroGymEnv(seed=23), BalatroMacroGymEnv(seed=23, device="cpu")
    (o, _), (oc, _) = card_shell.reset(), cpu_shell.reset()
    rng = np.random.default_rng(23)
    shell_ends = 0
    for t in range(MACRO_SHELL_STEPS):
        assert o.keys() == oc.keys() and all(
            o[k].dtype == oc[k].dtype and np.array_equal(o[k], oc[k]) for k in o), t
        act = int(rng.choice(np.flatnonzero(o["action_mask"])))
        o, r, d, _, _ = card_shell.step(act)
        oc, rc_, dc_, _, _ = cpu_shell.step(act)
        assert (r, d) == (rc_, dc_), (t, r, rc_)
        if d:
            shell_ends += 1
            (o, _), (oc, _) = card_shell.reset(), cpu_shell.reset()

    # the search: random search, each trial's parameters recorded
    seen, sample = [], TT._sample
    TT._sample = lambda r: seen.append(sample(r)) or seen[-1]
    try:
        tune_out = TT.tune(TUNE_TRIALS, "full", TUNE_UPDATES, TUNE_ENVS)
    finally:
        TT._sample = sample
    ref = random.Random(0)
    assert tune_out["backend"] == "random-search" and tune_out["trials"] == TUNE_TRIALS
    assert seen == [sample(ref) for _ in range(TUNE_TRIALS)], seen
    assert np.isfinite(tune_out["best_value"]) and tune_out["best_params"] in seen
    log("23 other learners and macro", f"ok: A2C {A2C_ENVS}x{T} ActorCritic(256, 256), "
        f"{A2C_UPDATES} updates, launches={a2c_launches} (K3b 2 a step + 2, env_step 1 a step) "
        f"== the plain versions on the card (masks, actions, rewards, dones, env states bit for "
        f"bit; normalised log1p row within {a2c_err['obs_log1p']:.3g}; params within "
        f"{a2c_err['params']:.3g}, nu within {a2c_err['nu']:.3g}); DQN {DQN_ENVS}x{DQN_STEPS}, "
        f"ring {dcfg.buffer_size}, QNetwork(256, 256), {DQN_UPDATES} updates, launches="
        f"{dqn_launches} (K3b 4 a step, env_step 1 a step); ring wrapped to ptr {ring[0]} len "
        f"{ring[1]}; == the plain versions (ring bit for bit, {dqn_err['obs_log1p_entries']} "
        f"log1p entries 1 ulp apart; params within {dqn_err['params']:.3g}, target within "
        f"{dqn_err['target']:.3g}); macro env {MACRO_ENVS}x{MACRO_STEPS} random legal steps on "
        f"the card == the CPU (every field, reward and observation), {ends} episodes ended, max "
        f"ante {macro_ante}; BalatroMacroGymEnv {MACRO_SHELL_STEPS} steps on the card == the "
        f"CPU's ({shell_ends} episodes); tune {TUNE_TRIALS} trials x {TUNE_UPDATES} updates at "
        f"{TUNE_ENVS} envs (full): {tune_out}")
    return a2c_launches, dqn_launches


# ---------------------------------------------------------------------------
# Phase 24: data parallel
# ---------------------------------------------------------------------------

# Two ranks share the card over gloo (NCCL refuses two ranks on one GPU);
# one rank runs over NCCL. The recipe is phase 15's at 8192 x 128 global.
DP_RANKS, DP_UPDATES, DP_NCCL_UPDATES = 2, 3, 2
DP_TIMEOUT_S = 420                  # a group of children, start-up included
DP_SIM = (131072, 256)              # rollout_fused_sharded, sampled
DP_FED = (4096, 32)                 # rollout_fused_sharded, fed (phase 4's scripts)
DP_FULL = (131072, 32)              # rollout_full_sharded, sampled
DP_SEED = 7
ROOT = Path(__file__).resolve().parent


def dp_counts():
    return {"K3a": FP.step_fused.launches, "K3b": FP.observe_fused.launches,
            "sampler": FP.sample_fused.launches, "K4": FR.rollout_fused.launches,
            "K2": FF.rollout_full_fused.launches, "env_step": FP.env_step_fused.launches,
            "env_reset": FP.env_reset_fused.launches}


def zero_dp_counts():
    for fn in (FP.step_fused, FP.observe_fused, FP.sample_fused, FR.rollout_fused,
               FF.rollout_full_fused, FP.env_step_fused, FP.env_reset_fused):
        fn.launches = 0


class AllReduceCounter:
    """Counts ``torch.distributed.all_reduce`` calls while entered."""

    def __enter__(self):
        import torch.distributed as dist
        self.calls, self.orig = 0, dist.all_reduce

        def counted(*args, **kw):
            self.calls += 1
            return self.orig(*args, **kw)
        dist.all_reduce = counted
        return self

    def __exit__(self, *exc):
        import torch.distributed as dist
        dist.all_reduce = self.orig


def param_digest(net):
    h = hashlib.sha256()
    for p in TP.param_list(net):
        h.update(p.detach().float().cpu().numpy().tobytes())
    return h.hexdigest()


def dp_train(mesh):
    """(a) The fused fast_decay update over the ranks."""
    cfg = TP.PPOConfig(**TRAIN)
    init_fn, step_fn, _ = PM.make_distributed_ppo(TP.full_env_hooks(), cfg, mesh)
    state = {"ts": init_fn([int(w) for w in KR.seed_key(0, device="cpu")]), "illegal": 0}
    digests, hist = [], []

    def run(n):
        for _ in range(n):
            rec = {}
            state["ts"], m = step_fn(state["ts"], record=rec)
            state["illegal"] += int(legal_count(rec["traj"]))
            digests.append(param_digest(state["ts"].params))
            hist.append({k: float(v) for k, v in m.items()})
            del rec

    zero_dp_counts()
    with AllReduceCounter() as all_reduce:
        run(1)                             # captures the collection's graph, then replays it
        captured = dp_counts()
        launches = kernel_launches(card_profile(lambda: run(DP_UPDATES - 1)))
    illegal = state["illegal"]
    T = cfg.rollout_len
    once = {"K3b": 1, "K3a": T, "sampler": T}
    assert {k: captured[k] for k in once} == {k: 2 * n for k, n in once.items()}, captured
    assert dp_counts() == captured, (dp_counts(), captured)
    assert step_fn.collection.replays == DP_UPDATES, step_fn.collection.replays
    want = {k: (DP_UPDATES - 1) * n for k, n in once.items()}
    assert launches == want, (launches, want)
    assert illegal == 0, f"rank {mesh.rank}: {illegal} sampled actions were illegal"
    assert all(np.isfinite(v) for m in hist for v in m.values()), hist
    return {"launches": launches, "captured": captured, "digests": digests,
            "metrics_by_update": hist, "all_reduce_calls": all_reduce.calls,
            "local_envs": cfg.n_envs // mesh.size}


def dp_parity(mesh):
    """(a) Phase 16's parity config over the ranks: the fused update against
    the plain versions' on each rank's shard."""
    errs = {"params": 0.0, "metrics_rel": 0.0, "log_prob": 0.0}
    plain_hooks = TP.full_env_hooks()._replace(
        fused_ops=(FP.observe_rows_reference, FP.sample, FP.step_rows_reference))
    for bf16, shuffle in ((True, True), (False, False)):
        cfg = TP.PPOConfig(**PARITY, bf16_compute=bf16, env_shuffle=shuffle)
        init_fn, fused, _ = PM.make_distributed_ppo(TP.full_env_hooks(), cfg, mesh)
        _, plain, _ = PM.make_distributed_ppo(plain_hooks, cfg, mesh)
        ts = init_fn([int(w) for w in KR.seed_key(1, device="cpu")])
        for _ in range(2):                                 # a mid-game start
            ts, _ = fused(ts)
        tp = copy.deepcopy(ts)
        rk, rp = {}, {}
        ts, mk = fused(ts, record=rk)
        tp, mp = plain(tp, record=rp)
        torch.cuda.synchronize()
        what = f"rank {mesh.rank} parity (bf16={bf16}, env_shuffle={shuffle})"
        for name in TP.Transition._fields:
            a, b = getattr(rk["traj"], name), getattr(rp["traj"], name)
            if name == "log_prob":
                errs["log_prob"] = max(errs["log_prob"], float((a - b).abs().max()))
                assert errs["log_prob"] <= 1e-6, f"{what}: log_prob off by {errs['log_prob']}"
            elif not torch.equal(a, b):
                raise AssertionError(f"{what}: trajectory {name} differs in "
                                     f"{int((a != b).sum())} entries")
        assert torch.equal(rk["raw"], rp["raw"]), f"{what}: raw rewards differ"
        for k in ("cards", "ints", "rng"):
            assert torch.equal(ts.env_states[k], tp.env_states[k]), f"{what}: packed {k}"
        d = max(float((a.detach() - b.detach()).abs().max())
                for a, b in zip(TP.param_list(ts.params), TP.param_list(tp.params)))
        assert d <= PARAM_ATOL, f"{what}: params differ by {d}"
        assert all(abs(float(mk[k]) - float(mp[k])) <= METRIC_RTOL * abs(float(mp[k])) + 1e-7
                   for k in mk), f"{what}: metrics {mk} vs {mp}"
        r = max(abs(float(mk[k]) - float(mp[k])) / max(abs(float(mp[k])), 1e-30) for k in mk)
        errs["params"], errs["metrics_rel"] = max(errs["params"], d), max(errs["metrics_rel"], r)
    return errs


def dp_rollouts(mesh, tmp):
    """(c) The sharded rollouts on this rank."""
    out, dev, r = {}, mesh.device, mesh.rank
    n, T = DP_SIM
    local = n // mesh.size
    zero_dp_counts()
    got = PM.rollout_fused_sharded(DP_SEED, n, T, BENCH_JOKERS, mesh=mesh)
    out["sim"] = {"launches": dp_counts()["K4"]}
    one = FR.rollout_fused(DP_SEED + r * max(1, local // PM.FUSED_TILE), local, T, BENCH_JOKERS,
                           device=dev)
    assert_bitwise(got, one, f"rank {r}: rollout_fused_sharded vs the one-process call")
    assert int(got["episodes"].sum()) > 0
    out["sim"]["max_abs_err"] = max_abs_diff(got, one)

    fed = np.load(Path(tmp) / "fed.npz")
    zero_dp_counts()
    got = PM.rollout_fused_sharded(0, DP_FED[0], DP_FED[1], fed["jokers"], mesh=mesh,
                                   actions=fed["actions"])
    out["fed"] = {"launches": dp_counts()["K4"]}
    np.savez(Path(tmp) / f"fed_rank{r}.npz", **{k: v.cpu().numpy() for k, v in got.items()})

    n, T = DP_FULL
    local = n // mesh.size
    zero_dp_counts()
    got = PM.rollout_full_sharded(DP_SEED, n, T, mesh=mesh)
    c = dp_counts()
    out["full"] = {"launches": c["K2"], "reset_launches": c["env_reset"]}
    init = FF.default_reset(DP_SEED, local, dev, first=r * local)
    one = FF.rollout_full_fused(DP_SEED + r * (local // PM.FULL_TILE), local, T,
                                init_state=init, device=dev)
    assert_full_equal(got, one, f"rank {r}: rollout_full_sharded vs the one-process call")
    out["full"]["max_abs_err"] = full_max_abs_diff(got, one)
    assert (c["K2"], c["env_reset"]) == (1, 1), c
    return out


def dp_rank_main(tmp):
    """A child of phase 24 (a) and (c): one of DP_RANKS ranks sharing the
    card over gloo."""
    PM.init_distributed(backend="gloo")
    try:
        mesh = PM.make_mesh()
        res = {"rank": mesh.rank, "size": mesh.size, "device": str(mesh.device),
               "backend": torch.distributed.get_backend(), "train": dp_train(mesh),
               "parity": dp_parity(mesh), "rollouts": dp_rollouts(mesh, tmp)}
    finally:
        PM.destroy()
    res["built_nothing"] = all(v["cached"] for v in cuda_build.build_log.values())
    (Path(tmp) / f"rank{mesh.rank}.json").write_text(json.dumps(res))
    return 0


def dp_nccl_main(tmp):
    """A child of phase 24 (b): the recipe's updates on one rank over NCCL
    (gloo where torch has no NCCL, said in the result)."""
    import torch.distributed as dist
    backend = "nccl" if dist.is_nccl_available() else "gloo"
    dist.init_process_group(backend, init_method="env://", world_size=1, rank=0,
                            timeout=datetime.timedelta(seconds=PM.INIT_TIMEOUT_S))
    try:
        mesh = PM.make_mesh()
        cfg = TP.PPOConfig(**TRAIN)
        init_fn, step_fn, _ = PM.make_distributed_ppo(TP.full_env_hooks(), cfg, mesh)
        ts, _ = step_fn(init_fn([int(w) for w in KR.seed_key(0, device="cpu")]))   # capture
        zero_dp_counts()
        hist = []
        with AllReduceCounter() as all_reduce:
            for _ in range(DP_NCCL_UPDATES):
                ts, m = step_fn(ts)
                hist.append({k: float(v) for k, v in m.items()})
        launches = dp_counts()
        res = {"backend": dist.get_backend(), "nccl_available": dist.is_nccl_available(),
               "launches": launches, "metrics_by_update": hist,
               "all_reduce_per_update": all_reduce.calls / DP_NCCL_UPDATES}
    finally:
        PM.destroy()
    # the collection captured in the first update; a replay launches no wrapper
    assert {k: launches[k] for k in ("K3b", "K3a", "sampler")} == {
        "K3b": 0, "K3a": 0, "sampler": 0}, launches
    assert step_fn.collection.replays == 1 + DP_NCCL_UPDATES, step_fn.collection.replays
    assert all(np.isfinite(v) for m in hist for v in m.values()), hist
    res["built_nothing"] = all(v["cached"] for v in cuda_build.build_log.values())
    (Path(tmp) / "nccl.json").write_text(json.dumps(res))
    return 0


def phase_data_parallel():
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        filter(None, [str(ROOT), os.environ.get("PYTHONPATH")])))
    with tempfile.TemporaryDirectory() as tmp:
        n, steps = DP_FED
        jok = JOKER_SETS[np.arange(n) % len(JOKER_SETS)]
        acts, _, _ = legal_script(jok, n, steps, seed=11)
        np.savez(Path(tmp) / "fed.npz", jokers=jok, actions=acts)
        PM.launch([sys.executable, str(ROOT / "chip_smoke.py"), "--dp-rank", tmp], DP_RANKS,
                  timeout=DP_TIMEOUT_S, env=env, cwd=ROOT)
        ranks = [json.loads((Path(tmp) / f"rank{r}.json").read_text()) for r in range(DP_RANKS)]
        shards = [dict(np.load(Path(tmp) / f"fed_rank{r}.npz")) for r in range(DP_RANKS)]
        one = FR.rollout_fused(0, n, steps, jok, actions=acts, device=DEV)
        for k, v in one.items():
            cat = np.concatenate([s[k] for s in shards])
            if not np.array_equal(cat, v.cpu().numpy()):
                raise AssertionError(f"fed shards concatenated vs the one-process call: {k}")
        PM.launch([sys.executable, str(ROOT / "chip_smoke.py"), "--dp-nccl", tmp], 1,
                  timeout=DP_TIMEOUT_S, env=env, cwd=ROOT)
        nccl = json.loads((Path(tmp) / "nccl.json").read_text())
    proc = subprocess.run([sys.executable, "-m", "balatro_gym_tpu_torch.parallel.scaling_bench",
                           "--env", "full"], capture_output=True, text=True, cwd=ROOT, env=env,
                          timeout=DP_TIMEOUT_S)
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-4000:]
    bench = json.loads(proc.stdout.strip().splitlines()[-1])
    assert bench["n_devices"] == torch.cuda.device_count() and bench["value"] > 0

    for r, res in enumerate(ranks):
        assert (res["rank"], res["size"], res["backend"]) == (r, DP_RANKS, "gloo"), res
        assert res["built_nothing"], f"rank {r} built a kernel"
    for u in range(DP_UPDATES):
        assert len({res["train"]["digests"][u] for res in ranks}) == 1, \
            f"update {u}: the ranks' parameters differ"
        assert ranks[0]["train"]["metrics_by_update"][u] == \
            ranks[1]["train"]["metrics_by_update"][u], u
    assert nccl["built_nothing"], "the NCCL child built a kernel"
    cfg = TP.PPOConfig(**TRAIN)
    want_ar = cfg.epochs * cfg.minibatches + 4 + 1       # minibatches, two statistics, metrics
    assert nccl["all_reduce_per_update"] == want_ar, nccl
    assert all(res["train"]["all_reduce_calls"] == DP_UPDATES * want_ar for res in ranks), \
        [res["train"]["all_reduce_calls"] for res in ranks]
    log("24 data parallel", f"ok: (a) {DP_RANKS} ranks sharing the card over gloo, "
        f"fast_decay {cfg.n_envs}x{cfg.rollout_len} global ({ranks[0]['train']['local_envs']} "
        f"envs a rank), {DP_UPDATES} updates, each a replay of the collection's graph: the "
        f"wrappers' launches in the capture a rank "
        f"{[res['train']['captured'] for res in ranks]}, launches in the last "
        f"{DP_UPDATES - 1} updates a rank (profiler) "
        f"{[res['train']['launches'] for res in ranks]}; {want_ar} all_reduce calls an update "
        f"on each rank; parameters equal across ranks after "
        f"every update; every action legal; parity over the ranks (fused == plain on each "
        f"shard): params within {max(res['parity']['params'] for res in ranks):.3g}, log-probs "
        f"within {max(res['parity']['log_prob'] for res in ranks):.3g}; (b) one rank over "
        f"{nccl['backend']} (nccl available: {nccl['nccl_available']}): {DP_NCCL_UPDATES} "
        f"replayed updates, the wrappers' launches {nccl['launches']}, {want_ar} all_reduce "
        f"calls an update; (c) "
        f"rollout_fused_sharded {DP_SIM[0]}x{DP_SIM[1]} sampled: each rank == "
        f"rollout_fused(seed + rank * n_local_tiles) bitwise, K4 "
        f"{[res['rollouts']['sim']['launches'] for res in ranks]} launches; fed {n}x{steps}: "
        f"the shards concatenated == the one-process call; rollout_full_sharded "
        f"{DP_FULL[0]}x{DP_FULL[1]}: each rank == rollout_full_fused on its slice bitwise, K2 "
        f"{[res['rollouts']['full']['launches'] for res in ranks]} and env_reset "
        f"{[res['rollouts']['full']['reset_launches'] for res in ranks]} launches; (d) "
        f"scaling_bench --env full exits 0 on {bench['n_devices']} card(s)")
    return {"train": [res["train"]["launches"] for res in ranks],
            "sim": [res["rollouts"]["sim"]["launches"] for res in ranks],
            "full": [res["rollouts"]["full"]["launches"] for res in ranks],
            "full_reset": [res["rollouts"]["full"]["reset_launches"] for res in ranks]}


def main(argv):
    if not torch.cuda.is_available():
        print("chip_smoke: torch sees no CUDA card", file=sys.stderr)
        return 1
    if argv[:1] == ["--dp-rank"]:
        return dp_rank_main(argv[1])
    if argv[:1] == ["--dp-nccl"]:
        return dp_nccl_main(argv[1])
    phase_device()
    phase_build()
    launches = phase_main_path()
    err = max(phase_fed(), phase_sampled())
    full_launches, full_err = phase_full_main()
    fed_err, fed_st, fed_script = phase_full_fed()
    full_err = max(full_err, fed_err)
    policy_launches, net, st0, traj, final = phase_policy_main()
    policy_err = phase_policy_parity(net, st0, traj, final, (fed_st, fed_script))
    hist_launches, hist_err = phase_hist()
    alu_launches, alu_err = phase_alu()
    train_launches = phase_train_main()
    phase_train_parity()
    step_err, reset_err = phase_env_step()
    g_ts, generic = phase_generic_train()
    phase_evaluate(g_ts)
    phase_gym()
    bc = phase_imitation()
    a2c, dqn = phase_other_learners()
    dp = phase_data_parallel()

    # Each kernel's launches on the path that checked it, and its largest
    # difference from its plain version there; then its launches on the
    # other paths that run it (K3a, K3b and the sampler in a replayed graph
    # by kernel name under the profiler, over the last updates).
    src = "balatro_gym_tpu_torch/csrc/"
    policy_src = src + "fused_policy_rollout.cu"
    kernels = [{"name": name, "source": source, "replaces": replaces, "launches": n,
                "max_abs_err": e} for name, source, replaces, n, e in (
        ("fused_rollout", src + "fused_rollout.cu", "balatro_gym_tpu/ops/fused_rollout.py:126",
         launches, err),
        ("fused_full_rollout", src + "fused_full_rollout.cu",
         "balatro_gym_tpu/ops/fused_full_rollout.py:2299", full_launches, full_err),
        ("policy_step", policy_src, "balatro_gym_tpu/ops/fused_policy_rollout.py:174",
         policy_launches["K3a"], policy_err["K3a"]),
        ("policy_observe", policy_src, "balatro_gym_tpu/ops/fused_policy_rollout.py:190",
         policy_launches["K3b"], policy_err["K3b"]),
        ("policy_sample", policy_src, "balatro_gym_tpu/ops/fused_policy_rollout.py:444",
         policy_launches["sampler"], policy_err["sampler"]),
        ("env_step", policy_src, "balatro_gym_tpu/engine/full_env.py:870",
         generic["env_step"], step_err),
        ("env_reset", policy_src, "balatro_gym_tpu/engine/full_env.py:163",
         generic["env_reset"], reset_err),
        ("hand_histograms", src + "hand_histograms.cu",
         "balatro_gym_tpu/ops/pallas_kernels.py:44", hist_launches, hist_err),
        ("alu_chains", src + "alu_ceiling.cu", "scripts/vpu_ceiling.py:28", alu_launches,
         alu_err))]
    by_name = {k["name"]: k for k in kernels}
    by_name["fused_rollout"]["dp_launches_by_rank"] = dp["sim"]
    by_name["fused_full_rollout"]["dp_launches_by_rank"] = dp["full"]
    for key, name in POLICY_KERNELS:
        by_name[name.removesuffix("_kernel")].update(
            trainer_launches=train_launches[key], trainer_profiled_updates=TRAIN_UPDATES - 1,
            dp_launches_by_rank=[r[key] for r in dp["train"]],
            dp_profiled_updates=DP_UPDATES - 1)
    for key, name in (("K3b", "policy_observe"), ("env_step", "env_step"),
                      ("env_reset", "env_reset")):
        by_name[name].update(imitation_launches=bc[key], a2c_launches=a2c[key],
                             dqn_launches=dqn[key])
    by_name["policy_observe"]["generic_launches"] = generic["K3b"]
    by_name["env_reset"]["dp_launches_by_rank"] = dp["full_reset"]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
