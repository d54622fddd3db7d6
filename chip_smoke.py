#!/usr/bin/env python3
"""Run the PyTorch port's rollouts, kernels and trainer on one CUDA card
and check them.

    python3 chip_smoke.py          # from the repository root; one card, nvcc

Drives the port's CUDA kernels through its entry points. The two
whole-rollout kernels run at bench.py's shapes:
``ops.fused_rollout.rollout_fused`` (the sim engine, csrc/fused_rollout.cu)
at 131072 envs x 256 steps with jokers (1, 31, 34, 48, 72), and
``ops.fused_full_rollout.rollout_full_fused`` (the flagship full-game env,
csrc/fused_full_rollout.cu) at 131072 envs x 256 steps, actions sampled on
the card in both. The policy collection
(``ops.fused_policy_rollout.collect_policy_fused``, kernels K3a, K3b and the
sampler) runs at bench.py's ``policy_collect_steps_per_sec`` shape, 8192
envs x 256 steps with ``ActorCritic(256, 256)``; the PPO trainer
(``train.ppo.make_ppo``) runs the ``fast_decay`` recipe, 8192 envs x 128
steps an update, over the fused collection and over the generic rollout
(the engine's step kernel ``env_step_kernel`` and K3b); evaluation, the
Gym shell, behaviour cloning and the expert (``train.bc``,
``train.expert``) run on the engine's step and K3b; the hand histograms (K5)
and the ALU ceiling probe (K6) run through their own entry points. Phases,
each printed on its own line; any failure raises and the run exits
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
6. sim timing: median of 5 CUDA-event samples, as env-steps/s: the call
   at 131072 x 256 (10 back-to-back calls per sample, the joker
   coefficients included), the kernel alone on its coefficient rows (10
   back-to-back launches) and the plain version at 131072 x 32 (one call
   per sample); K4's launch shape (block, shared bytes, registers, stack)
   read from the built kernel, and the SASS of its step loop against the
   source operations an env-step (``K4_STEP_OPS``);
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
9. full-env timing: the kernel at 131072 x 256 (10 back-to-back calls per
   sample, each with its default reset's ``env_reset_kernel`` launch) and
   the plain version at 131072 x 8, median of 5 samples; K2's
   launch shape (block, shared bytes, registers, stack) read from the
   built kernel;
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
    8's 16384 x 64 fed battery; the main path's
    recorded actions replayed through K2, step by step and in one call,
    give the same rewards, dones and final state;
12. policy timing: median of 5 CUDA-event samples of the collection at
    8192 x 256, of K3a, K3b, the policy forward and the sampler called
    alone at 8192 envs (20 back-to-back calls) and of their plain
    versions, of the sampler on the other layout's copy and on logits made
    as the trainer makes them (a bf16 policy on the normalised
    observation, phase 17's layout), each with its logits' strides, of K3a
    on a no-autoreset and an all-autoreset batch (the
    main path's state at step 16 with the no-op action 59, without and with
    ante 101: ops/fused_full_battery.py's ``reset_batches``, each held
    against the plain step bit for bit before it is timed), and of the
    plain collection at 8192 x 4; K3a's, K3b's and the sampler's launch
    shapes (block, shared bytes, registers, stack) are read from the built
    kernels; the profiler gives
    each kernel's card time per launch and, over a 16-step collection, the
    card's idle share and card time per step; each kernel's bound (bytes
    over 3.35 TB/s or integer operations over the data sheet's INT32 rate)
    is printed with the one that binds;
13. hand histograms (K5, csrc/hand_histograms.cu): its entry point
    ``ops.hand_histograms.hand_histograms`` at 1,048,576 envs of seeded
    cards with ranks in [-1, 17] and suits in [-1, 9] (some outside every
    bin), the launch counter reset before and read after; kernel == plain
    bit for bit; median of 5 CUDA-event samples of 20 back-to-back calls;
    K5's launch shape read from the built kernel;
14. ALU ceiling (K6, csrc/alu_ceiling.cu): kernel == plain x 128 rounds at
    2 seeded tiles and on the probe's own inputs at both its shapes; the
    probe's entry point ``ops.alu_ceiling.main`` (launch counter reset
    before and read after) measures the int32 operation rate at the
    reference script's shape (64 tiles) and at a saturating one (1,056
    tiles, four times the card's 132 x 2,048 thread slots), and reads the
    SASS of the kernel's loop; every kernel's bound is printed under the
    data-sheet INT32 rate and under this measured one, which is the higher
    and so gives the bound of record (``bound_ms``), but for K6's own: its
    loop's SASS over the card's issue limit (132 SMs x 128 lanes x 1.98
    GHz);
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
17. trainer timing: median of 5 updates at 8192 x 128 after a warm-up, as
    PPO env-steps/s; one update split into its stages (collection, stats,
    last value + GAE, shuffle + SGD) by CUDA events; K3a's, K3b's and the
    sampler's card time a launch in the update (profiler); the card's idle
    share of an update from the profiler's card time against the unprofiled
    update time; the host's enqueue of one K3a call (``step_fused`` on the
    trainer's 8192 envs, 100 back-to-back calls with no sync) and the time
    of a fixed Python loop, which say how fast the host that sets the
    update's time ran in this run;
18. full step: the engine's own ``engine.full_env.step`` (pack,
    ``env_step_kernel``, unpack) at 8192 envs x 32 steps of the battery
    (every action class, an illegal action in every 11th env, envs on their
    last hand, past the score cap and already done) against the plain
    no-reset step on the card, bit for bit (packed state, reward, done);
    ``step_autoreset`` (``env_step_kernel``, then ``env_reset_kernel`` on
    the done envs) against the plain step plus the engine's torch reset,
    and ``env_reset_kernel`` on each step's done envs against its plain
    version; ``observe_vector`` and ``action_mask`` (K3b) against their
    plain rows; the kernel's card time behind a card sleep (median of 5
    rounds of 20 calls), K3a's on the same inputs, the ``step`` and
    ``step_autoreset`` calls' times and the plain step's; by branch class:
    ``env_step_kernel`` held against the plain step and timed on batches in
    which every env takes one branch class (``BAT.class_batches``), no env
    ends or every env is over, on the battery's mix and on each of its
    classes alone; ``env_reset_kernel`` in its autoreset mode on the
    battery's done envs and in its fresh mode over 8192 and 131072 envs,
    each held against its plain version and timed, with the ``autoreset``
    and ``reset`` calls; the launch shapes and ptxas lines of both kernels,
    and K2's, K3a's, ``env_step_kernel``'s and the sampler's ptxas lines
    beside those recorded (``RECORDED_PTXAS``; printed, not held: a
    redesign changes them);
19. generic PPO: ``make_ppo(full_env_hooks())`` with the ``fast_decay``
    recipe but ``fused_rollout=False``, 8192 x 128, ``ActorCritic(256,
    256)``, 3 updates, the launch counters reset before and read after
    (``env_step_fused`` and ``env_reset_fused`` 128 each an update; K3b 2 a
    step and 2 for the last value; K3a and the sampler none); every action
    legal, metrics finite; the median update by CUDA events, its stages,
    and the card's idle share (profiler card time against the unprofiled
    update); ``env_step_kernel`` on the state and actions of the first
    update's step 64 (the generic mix) and on each of its classes alone,
    held against the plain step and timed;
20. evaluate: a greedy anti-loop ``evaluate_policy`` of phase 19's policy,
    1024 episodes x 256 steps on the card (256 step launches, 1 reset);
    its statistics and wall time;
21. gym shell: ``envs.BalatroGymEnv`` on the card for 100 random legal
    steps against the same shell on the CPU (observations with their numpy
    dtypes, rewards, dones), then ``BalatroEnvValidator``'s determinism and
    action-mask checks on the card;
22. imitation and resume: ``train.bc.make_bc`` at its default
    ``ActorCritic(256, 256)`` and 8192 envs, 3 updates with the launch
    counters reset before and read after (K3b 2, ``env_step_kernel`` and
    ``env_reset_kernel`` 1 each an update), against the same 3 updates over
    the kernels' plain
    versions on the card (observation, mask, expert targets and env states
    bit for bit but the observation's log1p row, within 1 ulp; loss and
    parameters within 1e-6); one update's time by CUDA events and its card
    time and idle share by the profiler; ``train.expert.rollout_expert``
    at 8192 x 64, its actions replayed and every one legal under the mask,
    its reward above a masked-uniform random policy's from the same reset;
    one ``expert_action`` at 8192 envs by CUDA events;
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
    the kernels' plain versions
    on the card (masks, actions, rewards, dones and env states bit for
    bit, the normalised observation but its log1p row bit for bit and that
    row within 1e-5, parameters and RMSprop's ``nu`` within 1e-6);
    ``train.dqn.make_dqn`` at ``DQNConfig(n_envs=8192,
    steps_per_update=4)`` (100,000-transition ring, batch 512,
    ``QNetwork(256, 256)``) for 4 updates, the fourth wrapping the ring to
    ``buf_ptr`` 31,072 at ``buf_len`` 100,000 (K3b 4 a step,
    ``env_step_kernel`` and ``env_reset_kernel`` 1 each a step), against
    the plain versions likewise
    (the ring bit for bit but the observations' log1p row, within 1 ulp;
    parameters within 1e-6); each update's time by CUDA events and the
    card's idle share by the profiler; ``envs.macro_env`` at 8192 envs for
    64 steps of seeded random legal actions on the card against the same
    on the CPU (every field, reward and observation exact), its
    ``BalatroMacroGymEnv`` for 100 steps on the card against the CPU's;
    and ``train.tune.tune`` at 2 trials x 2 updates of 1024 envs on the
    flagship env (``backend`` random-search, each trial's parameters
    ``_sample(random.Random(0))``'s);
24. data parallel (``parallel.mesh``): (a) two ranks share the card over
    gloo (NCCL refuses two ranks on one GPU), children of this script
    started by ``mesh.launch`` with a timeout, loading phase 2's build:
    ``make_distributed_ppo`` with the ``fast_decay`` recipe at 8192 x 128
    global (4096 envs a rank), 3 updates, each a replay of the collection's
    graph, on each rank the launch counters read as in phase 15 (the
    capture's in the first update; the last 2, under the profiler, K3a
    and the sampler 128, K3b 1 an update by kernel name), the ranks'
    parameters equal bit for bit after every update, every action legal,
    metrics finite, each rank's update time by CUDA events (the last 2
    under the profiler) and its host time in ``all_reduce``; then phase 16's parity
    config over the 2 ranks, the fused update against the plain versions'
    on each rank's shard (trajectories and packed state bit for bit, the
    sampler's log-probs within 1e-6, parameters within 1e-6); (b) one rank
    over NCCL (in a child): the same recipe's update time beside the
    undistributed update's, the two in turns in that process, and phase
    17's, and its all-reduces an update (each update a replay of its
    learner's graph: the launch counters unchanged after the warm-up's
    capture, ``replays`` 6 each); (c) over the 2
    ranks, ``rollout_fused_sharded`` at 131072 x 256 sampled with the bench
    jokers (each rank == ``rollout_fused(seed + rank * n_local_tiles,
    65536, ...)`` bit for bit, K4 once a rank), fed at 4096 x 32 with
    phase 4's scripts (the ranks' shards, concatenated, == the one-process
    call), and ``rollout_full_sharded`` at 131072 x 32 sampled from the
    default reset (each rank == ``rollout_full_fused`` on its slice of the
    default reset with the strided seed; K2 and ``env_reset_kernel`` once
    a rank); (d) ``python -m balatro_gym_tpu_torch.parallel.scaling_bench
    --env full`` (one card: N = 1, an efficiency of 1 by construction).
    Printed in the ``{"data_parallel": ...}`` line.

Float32 matmuls run in full float32 (``allow_tf32`` stays False). The last
five lines are the trainer's JSON record, that of phases 19-23, that of
phase 24, the kernels' JSON record (each kernel's bound under both INT32
rates) and the result line.
Imports torch and the port only; the machine with the card has no JAX.
"""
from __future__ import annotations

import copy
import datetime
import hashlib
import json
import os
import random
import re
import statistics
import subprocess
import sys
import tempfile
import time
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
from balatro_gym_tpu_torch.train.normalize import init_stats, normalize
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
FULL_PLAIN_STEPS = 8
POLICY_ENVS, POLICY_STEPS = 8192, 256  # bench.py's policy_collect_steps_per_sec shape
POLICY_CHECK_STEPS = 16                # kernels == plain along this many main-path steps
POLICY_PLAIN_STEPS = 4
LOG1P_ROW = FP.OBS_DIM - 6             # log1p(chips_needed) / 10: within 1 ulp
HIST_ENVS = 1 << 20                    # K5 at 1,048,576 envs
ALU_CHECK_TILES = 2
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
# K2's and K3a's ptxas lines as phase 2 printed them before the engine's
# step kernel joined their step (NVIDIA H100 80GB HBM3, CUDA 12.9). Phase 18
# prints today's beside them and says whether they are equal; it does not
# hold them, since a redesign of K2 or K3a or another toolkit changes them.
RECORDED_PTXAS = {
    "fused_full_rollout_kernel": [
        "1488 bytes stack frame, 288 bytes spill stores, 272 bytes spill loads",
        "Used 64 registers, used 0 barriers, 1488 bytes cumulative stack size"],
    "policy_step_kernel": [
        "160 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads",
        "Used 94 registers, used 0 barriers, 160 bytes cumulative stack size"],
    "env_step_kernel": [
        "160 bytes stack frame, 28 bytes spill stores, 48 bytes spill loads",
        "Used 72 registers, used 1 barriers, 160 bytes cumulative stack size"],
    # the step's key read on the card where given (30 registers before)
    "policy_sample_kernel": [
        "0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads",
        "Used 32 registers, used 1 barriers, 21984 bytes smem"],
}

# The least time the card could take: NVIDIA's data-sheet HBM rate,
# 3.35 TB/s; INT32 at 132 SMs x 64 INT32 lanes x 1.98 GHz (H100 SXM, Hopper
# white paper), until phase 14 measures the card's own INT32 rate with K6
# (above this one: the compiler spreads integer work over the FMA pipe as
# IMAD and VIADD). A Threefry-2x32 hash is 75 integer operations: 20 rounds of
# (add, rotate, xor), 5 key injections of 2 adds, 4 set-up ops, 1 xor.
HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 132 * 64 * 1.98e9
# The issue limit: 4 schedulers an SM each issue one 32-lane warp
# instruction a clock, so 132 x 128 thread-instructions at 1.98 GHz.
ISSUE_PER_S = 132 * 128 * 1.98e9
THREEFRY_OPS = 75
# K4's integer source operations an env-step, stage by stage, counted from
# the algorithm as csrc/fused_rollout.cu states it (its note holds the same
# table), at the bench jokers: sampled, no Four Fingers, Shortcut, Misprint
# or Bloodstone, so one hash a step. A C operator, compare, select, shared
# load or conversion counts one.
K4_STEP_OPS = {
    "hash and uniform action": THREEFRY_OPS + 8,
    "decode and the selection": 8,
    "of a kind (4 shifted compares of the rank word)": 69,
    "flush (two suit candidates)": 31,
    "present ranks": 25,
    "straight (windows, wheel, scoring cards)": 63,
    "hand type and scoring mask": 18,
    "score (5 rank terms, 4 suit terms)": 105,
    "mult terms (Half, Queens, Kings, Spade-or-Club)": 39,
    "exponents and powers": 34,
    "score product": 5,
    "outcome": 14,
    "refill from the deck window": 13,
    "autoreset": 10,
    "loop": 3,
}
PACKED_BYTES = (6 * 64 + FF.NI + FF.NR) * 4      # one env's packed state
# packed int rows the observation and mask read: the hand's slots and
# selection (16), jokers (5), levels (12), shop types and costs (20) and 16
# scalars (csrc/fused_policy_rollout.cu's observe_load)
K3B_ROWS = 69


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


def cuda_ms(fn, calls=1, samples=5):
    """Median and all samples of ``fn``'s time per call on the card: each
    sample is ``calls`` back-to-back calls between two CUDA events, after a
    warm-up, so with ``calls > 1`` the host enqueues ahead of the card as a
    rollout loop does."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(samples):
        t0, t1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        t0.record()
        for _ in range(calls):
            fn()
        t1.record()
        t1.synchronize()
        times.append(t0.elapsed_time(t1) / calls)
    return statistics.median(times), times


def host_call_us(fn, calls=100, samples=5):
    """Median host time of one call of ``fn`` in us, issued ``calls`` times
    back to back with no sync: its enqueue cost while the card keeps up."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(samples):
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        times.append((time.perf_counter() - t0) / calls * 1e6)
        torch.cuda.synchronize()
    return statistics.median(times)


def host_loop_ms():
    """ms of a fixed pure-Python loop: how fast the host's CPU runs now (the
    trainer's update is host-bound, so its time follows this)."""
    t0 = time.perf_counter()
    acc = 0
    for i in range(2_000_000):
        acc += i & 7
    return (time.perf_counter() - t0) * 1e3


def bound(n_bytes, n_ops, int32_rate=INT32_OPS_PER_S):
    """(least ms, what binds): the bytes a function must move over the HBM
    rate against its integer operations over an INT32 rate (the data
    sheet's unless given)."""
    by_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    by_ops = n_ops / int32_rate * 1e3
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops, "operations")


def phase_device():
    smi = sh("nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader").splitlines()[0].strip()
    nvcc = sh(cuda_build.nvcc_path(), "--version").splitlines()[-1]
    print(smi, flush=True)
    log("1 device", f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()} | "
        f"nvidia-smi: {smi} | {nvcc} | torch {torch.__version__} "
        f"(CUDA {torch.version.cuda}) | python {sys.version.split()[0]}")
    return smi


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
    t0 = time.perf_counter()
    assert_bitwise(out, FR.rollout_fused_reference(0, N_ENVS, N_STEPS, BENCH_JOKERS,
                                                   device=DEV), "main path kernel vs plain")
    plain_s = time.perf_counter() - t0

    # The float64 engine's random rollout at the same shape: same
    # distribution (uniform legal actions), other random stream.
    t0 = time.perf_counter()
    key = torch.tensor([0, 1], dtype=torch.int64, device=DEV)
    _, rs, es = sim_env.rollout_random_per_env(key, N_ENVS, N_STEPS, BENCH_JOKERS)
    torch.cuda.synchronize()
    engine_s = time.perf_counter() - t0
    checks = []
    for name, k, s in (("reward", r.double(), rs), ("episodes", out["episodes"].double(),
                                                      es.double())):
        mk, ms = float(k.mean()) / N_STEPS, float(s.mean()) / N_STEPS
        se = (float(k.var()) / N_ENVS + float(s.var()) / N_ENVS) ** 0.5 / N_STEPS
        z = abs(mk - ms) / se
        checks.append(f"{name}/env-step kernel {mk:.6f} engine {ms:.6f} z={z:.2f}")
        assert z <= Z_MAX, f"{name} per env-step differs by {z:.2f} standard errors"
    log("3 main path", f"ok: rollout_fused {N_ENVS}x{N_STEPS} launches={launches}; "
        f"kernel == plain bitwise (plain {plain_s:.1f} s); {'; '.join(checks)} "
        f"(engine rollout {engine_s:.1f} s)")
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


def phase_timing(smi):
    n0 = FR.rollout_fused.launches
    calls = 10
    k_ms, k_all = cuda_ms(lambda: FR.rollout_fused(1, N_ENVS, N_STEPS, BENCH_JOKERS,
                                                   device=DEV), calls=calls)
    assert FR.rollout_fused.launches == n0 + 1 + 5 * calls, "timed calls did not all launch"
    coef = FR.joker_coefficients(BENCH_JOKERS, N_ENVS, device=DEV)
    a_ms, a_all = cuda_ms(lambda: FR._kernel_rows(coef, 1, None, N_STEPS), calls=calls)
    plain_steps = 32
    p_ms, p_all = cuda_ms(lambda: FR.rollout_fused_reference(1, N_ENVS, plain_steps,
                                                             BENCH_JOKERS, device=DEV))
    k_rate = N_ENVS * N_STEPS / (k_ms / 1e3)
    p_rate = N_ENVS * plain_steps / (p_ms / 1e3)
    shape = FR.rollout_kernel_shape()
    sass = cuda_build.sass_loop(cuda_build.build_log["fused_rollout.cu"]["path"],
                                "fused_rollout_kernel")
    log("6 timing", f"call {N_ENVS}x{N_STEPS} ({calls} calls per sample, the joker "
        f"coefficients included): median {k_ms:.3f} ms (samples "
        f"{', '.join(f'{t:.3f}' for t in k_all)}) = {k_rate:.4g} env-steps/s; kernel alone "
        f"on its coefficient rows: median {a_ms:.3f} ms (samples "
        f"{', '.join(f'{t:.3f}' for t in a_all)}) = {N_ENVS * N_STEPS / (a_ms / 1e3):.4g} "
        f"env-steps/s; plain {N_ENVS}x{plain_steps}: median {p_ms:.1f} ms "
        f"(samples {', '.join(f'{t:.1f}' for t in p_all)}) = {p_rate:.4g} env-steps/s; "
        f"kernel/plain {k_rate / p_rate:.1f}x; K4 {shape['block']} threads a block, "
        f"{shape['shared_bytes']} B shared a block, {shape['registers']} registers, "
        f"{shape['stack_bytes']} B stack; step loop {len(sass)} SASS against "
        f"{sum(K4_STEP_OPS.values())} source ops an env-step ({K4_STEP_OPS}) [{smi}]")
    return {"ms": k_ms, "kernel_alone_ms": a_ms, "plain_ms": p_ms, "env_steps_per_s": k_rate,
            "plain_env_steps_per_s": p_rate, "launch_shape": shape, "loop_sass": len(sass)}


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
    t0 = time.perf_counter()
    p = FF.rollout_full_rows_reference(0, N_ENVS, FULL_CHECK_STEPS, device=DEV)
    torch.cuda.synchronize()
    plain_s = time.perf_counter() - t0
    assert_full_equal(k, p, "full-env main path kernel vs plain")
    log("7 full main path", f"ok: rollout_full_fused {N_ENVS}x{N_STEPS} launches={launches} "
        f"(its default reset: env_reset 1); "
        f"{int(epi.sum())} episodes, mean reward/env-step "
        f"{float(r.double().mean()) / N_STEPS:.4f}, antes {int(st.ante.min())}-"
        f"{int(st.ante.max())}, phases {torch.bincount(st.phase.long(), minlength=3).tolist()}; "
        f"at {N_ENVS}x{FULL_CHECK_STEPS} kernel == plain bitwise (plain {plain_s:.1f} s)")
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


def phase_full_timing(smi):
    n0 = (FF.rollout_full_fused.launches, FP.env_reset_fused.launches)
    calls = 10
    k_ms, k_all = cuda_ms(lambda: FF.rollout_full_fused(1, N_ENVS, N_STEPS, device=DEV),
                          calls=calls)
    assert (FF.rollout_full_fused.launches - n0[0], FP.env_reset_fused.launches - n0[1]) == (
        1 + 5 * calls, 1 + 5 * calls), "timed calls did not all launch K2 and the reset"
    packed = FF.pack_full_state(FF.default_reset(1, N_ENVS, DEV))
    a_ms, a_all = cuda_ms(lambda: FF._kernel_packed(packed, None, 1, N_STEPS), calls=calls)
    p_ms, p_all = cuda_ms(lambda: FF.rollout_full_rows_reference(1, N_ENVS, FULL_PLAIN_STEPS,
                                                                 device=DEV))
    k_rate = N_ENVS * N_STEPS / (k_ms / 1e3)
    p_rate = N_ENVS * FULL_PLAIN_STEPS / (p_ms / 1e3)
    shape = FF.rollout_kernel_shape()
    log("9 full timing", f"call {N_ENVS}x{N_STEPS} ({calls} calls per sample, default reset "
        f"by env_reset_kernel included): median {k_ms:.3f} ms (samples {', '.join(f'{t:.3f}' for t in k_all)}) = "
        f"{k_rate:.4g} env-steps/s; kernel alone on a packed state: median {a_ms:.3f} ms "
        f"(samples {', '.join(f'{t:.3f}' for t in a_all)}) = "
        f"{N_ENVS * N_STEPS / (a_ms / 1e3):.4g} env-steps/s; plain {N_ENVS}x"
        f"{FULL_PLAIN_STEPS}: median {p_ms:.1f} ms (samples "
        f"{', '.join(f'{t:.1f}' for t in p_all)}) = {p_rate:.4g} env-steps/s; kernel/plain "
        f"{k_rate / p_rate:.1f}x; K2 {shape['block']} threads a block, "
        f"{shape['shared_bytes']} B shared a block, {shape['registers']} registers, "
        f"{shape['stack_bytes']} B stack [{smi}]")
    return k_ms, a_ms, p_ms, k_rate, p_rate, shape


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


def trainer_logits(obs, mask):
    """Logits as the trainer's collection makes them (train/ppo.py's
    ``rollout`` with ``bf16_compute``): a seeded bf16 ``ActorCritic(256,
    256)`` on the observation normalised by fresh running statistics."""
    net = ActorCritic(FP.N_ACTIONS, FP.OBS_DIM, (256, 256), compute_dtype=torch.bfloat16,
                      generator=torch.Generator().manual_seed(0)).to(DEV)
    with torch.no_grad():
        return net(normalize(init_stats(FP.OBS_DIM, DEV), obs), mask)[0]


def phase_policy_parity(net, st0, traj, final, battery):
    """Kernels against plain versions on the same inputs; K2 replay."""
    errs = {"K3a": 0.0, "K3b": 0.0, "sampler": 0.0}
    log1p_diff = {"K3a": 0, "K3b": 0}
    packed = FF.pack_full_state(st0)
    obs, mask = FP.observe_fused(packed, device=DEV)
    p_obs, p_mask = FP.observe_rows_reference(packed)
    assert torch.equal(mask, p_mask), "K3b mask differs"
    errs["K3b"], log1p_diff["K3b"] = obs_diff(obs, p_obs)
    for t, key in enumerate(FP.step_keys(0, POLICY_STEPS)[:POLICY_CHECK_STEPS]):
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
        mid = (packed, a)                          # a mid-game state and its actions
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
    return errs, mid


def card_profile(fn):
    """The card's activity while ``fn`` runs, from the profiler: (idle share
    of the span from its first kernel's start to its last one's end, card
    time per kernel name in ms as a list per launch); (None, {}) where the
    profiler records no card activity."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    spans = sorted((e.time_range.start, e.time_range.end, e.name) for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA)
    if not spans:
        return None, {}
    busy, (s0, e0, _) = 0.0, spans[0]
    by_name = {}
    for s, e, name in spans:
        by_name.setdefault(name, []).append((e - s) / 1e3)
        if s > e0:
            busy += e0 - s0
            s0, e0 = s, e
        else:
            e0 = max(e0, e)
    busy += e0 - s0
    span = max(e for _, e, _ in spans) - spans[0][0]
    return 1.0 - busy / span, by_name


POLICY_KERNELS = (("K3a", "policy_step_kernel"), ("K3b", "policy_observe_kernel"),
                  ("sampler", "policy_sample_kernel"))


def kernel_launches(by_name):
    """Launches of K3a, K3b and the sampler in ``card_profile``'s card time
    by kernel name: the kernels that ran, a CUDA graph's included."""
    return {k: sum(len(ds) for n, ds in by_name.items() if kernel in n)
            for k, kernel in POLICY_KERNELS}


def hand_cards(packed):
    """Hand positions of a packed state that hold a deck card, summed over
    its envs: K3b reads the rank and suit of each."""
    ints = packed["ints"]
    hidx = ints[FF.R_HIDX:FF.R_HIDX + 8]
    pos = torch.arange(8, device=ints.device)[:, None]
    return int(((pos < ints[FF.S_HN]) & (hidx >= 0) & (hidx < 64)).sum())


def policy_work(n, cards):
    """(bytes, integer operations) of one launch of K3a, K3b and the sampler
    at ``n`` envs: for K3a the packed state read and written, the action,
    reward and done, the observation and mask rows; for K3b the 69 packed
    int rows that the observation and mask read, the rank and suit of each
    of the ``cards`` hand cards, and the observation and mask rows; for the
    sampler the logits, action and log-probability, and 60 Threefry hashes
    an env."""
    return {"K3a": (n * (2 * PACKED_BYTES + 4 + 4 + 1 + 4 * FP.OBS_DIM + FP.N_ACTIONS), 0),
            "K3b": (n * (K3B_ROWS * 4 + 4 * FP.OBS_DIM + FP.N_ACTIONS) + 2 * 4 * cards, 0),
            "sampler": (n * (4 * FP.N_ACTIONS + 4 + 4), n * FP.N_ACTIONS * THREEFRY_OPS)}


def phase_policy_timing(smi, net, mid):
    st = FF.default_reset(1, POLICY_ENVS, DEV)
    n0 = policy_counts()
    coll_ms, coll_all = cuda_ms(lambda: FP.collect_policy_fused(net, st, 1, POLICY_STEPS,
                                                                device=DEV))
    assert policy_counts()["K3a"] == n0["K3a"] + 6 * POLICY_STEPS, "timed calls did not launch"
    plain_ms, plain_all = cuda_ms(lambda: FP.collect_policy_reference(
        net, st, 1, POLICY_PLAIN_STEPS, device=DEV))
    packed, a = mid
    obs, mask = FP.observe_fused(packed, device=DEV)
    with torch.no_grad():
        logits, _ = net(obs, mask)
    o_logits, t_logits = other_layout(logits), trainer_logits(obs, mask)
    key = FP.step_keys(1, 1)[0]
    calls = 20

    def policy():
        with torch.no_grad():
            net(obs, mask)

    no_reset, all_reset = BAT.reset_batches(packed)
    for what, (p, act), ends in (("no_reset", no_reset, False), ("all_reset", all_reset, True)):
        out = FP.step_fused(p, act, device=DEV)
        assert_step_equal(out, FP.step_rows_reference(p, act), f"K3a {what}")
        assert bool((out[2] == ends).all()), f"K3a {what}: done is not {ends} everywhere"
    # name: (call, plain version, part of the kernel's name in the profile)
    parts = {
        "K3a": (lambda: FP.step_fused(packed, a, device=DEV),
                lambda: FP.step_rows_reference(packed, a), "policy_step_kernel"),
        "K3a no_reset": (lambda: FP.step_fused(*no_reset, device=DEV), None,
                         "policy_step_kernel"),
        "K3a all_reset": (lambda: FP.step_fused(*all_reset, device=DEV), None,
                          "policy_step_kernel"),
        "K3b": (lambda: FP.observe_fused(packed, device=DEV),
                lambda: FP.observe_rows_reference(packed), "policy_observe_kernel"),
        "sampler": (lambda: FP.sample_fused(key, logits, device=DEV),
                    lambda: FP.sample(key, logits), "policy_sample_kernel"),
        "sampler other_layout": (lambda: FP.sample_fused(key, o_logits, device=DEV), None,
                                 "policy_sample_kernel"),
        "sampler trainer": (lambda: FP.sample_fused(key, t_logits, device=DEV), None,
                            "policy_sample_kernel"),
        "policy": (policy, None, ""),
    }
    times = {}
    for name, (fn, plain, kernel) in parts.items():
        call_ms = cuda_ms(fn, calls=calls)
        _, by_name = card_profile(lambda: [fn() for _ in range(calls)])
        card = [d for n, ds in by_name.items() if kernel in n for d in ds]
        card_ms = (statistics.median(card) if kernel else sum(card) / calls) if card else None
        times[name] = {"call": call_ms, "card_ms": card_ms,
                       "plain": cuda_ms(plain) if plain is not None else None}
    shapes = {"K3a": FP.step_kernel_shape(), "K3b": FP.observe_kernel_shape(),
              "sampler": FP.sample_kernel_shape()}
    layouts = {"sampler": logits.stride(), "sampler other_layout": o_logits.stride(),
               "sampler trainer": t_logits.stride()}
    window = 16
    idle, by_name = card_profile(lambda: FP.collect_policy_fused(net, st, 1, window, device=DEV))
    top = sorted(((sum(ds), n) for n, ds in by_name.items()), reverse=True)[:6]
    # The profiler slows the host, so its window overstates the card's idle
    # share; the card time a step against the unprofiled step time does not.
    card_step_ms = sum(map(sum, by_name.values())) / window if by_name else None
    step_ms = coll_ms / POLICY_STEPS
    idle_run = None if card_step_ms is None else max(0.0, 1.0 - card_step_ms / step_ms)

    n = POLICY_ENVS
    cards = hand_cards(packed)
    bounds = {k: bound(*w) for k, w in policy_work(n, cards).items()}
    rate = n * POLICY_STEPS / (coll_ms / 1e3)
    fmt = ", ".join

    def part_txt(name, tm):
        (c_med, c_all), txt = tm["call"], name
        if tm["card_ms"] is not None:
            txt += f" card {tm['card_ms'] * 1e3:.1f} us per launch (profiler),"
        txt += f" call {c_med * 1e3:.1f} us (samples {fmt(f'{x * 1e3:.1f}' for x in c_all)})"
        if tm["plain"] is not None:
            txt += f", plain {tm['plain'][0]:.3f} ms"
        if name in layouts:
            txt += f", logits strides {layouts[name]}"
        if name in bounds:
            txt += f", bound {bounds[name][0] * 1e3:.2f} us ({bounds[name][1]}, data-sheet INT32)"
        return txt

    log("12 policy timing", f"collection {n}x{POLICY_STEPS}: median {coll_ms:.3f} ms "
        f"(samples {fmt(f'{x:.3f}' for x in coll_all)}) = {rate:.4g} env-steps/s = "
        f"{coll_ms / POLICY_STEPS * 1e3:.1f} us/step; plain collection {n}x"
        f"{POLICY_PLAIN_STEPS}: median {plain_ms:.1f} ms (samples "
        f"{fmt(f'{x:.1f}' for x in plain_all)}) = "
        f"{plain_ms / POLICY_PLAIN_STEPS:.1f} ms/step; alone at {n} envs ({calls} back-to-back "
        f"calls): {'; '.join(part_txt(k, v) for k, v in times.items())}; launch shapes: "
        + "; ".join(f"{k} {v['block']} threads a block, {v['shared_bytes']} B shared a block, "
                    f"{v['registers']} registers, {v['stack_bytes']} B stack"
                    for k, v in shapes.items())
        + f"; a {window}-step "
        f"collection under the profiler: "
        + ("not measured (no card activity in the profile)" if idle is None else
           f"card idle {idle:.4f} of its span, card time per step {card_step_ms * 1e3:.1f} us, "
           f"top {[(nm[:40], round(ms / window * 1e3, 1)) for ms, nm in top]} (us per step); "
           f"card idle share of the unprofiled collection 1 - {card_step_ms * 1e3:.1f} / "
           f"{step_ms * 1e3:.1f} us = {idle_run:.4f}")
        + f" [{smi}]")
    return {"coll_ms": coll_ms, "plain_coll_ms": plain_ms, "times": times, "bounds": bounds,
            "rate": rate, "idle": idle_run, "idle_profiled": idle, "shapes": shapes,
            "layouts": layouts, "hand_cards": cards}


def hist_work(n):
    """(bytes, operations) of K5 at ``n`` envs: 8 int32 ranks, 8 int32
    suits and 8 mask bytes read, 16 + 8 + 1 float32 written an env; 24
    compares and 24 adds a card."""
    return n * (8 * 4 + 8 * 4 + 8 + (HH.R_PAD + HH.S_PAD + 1) * 4), n * 8 * 48


def phase_hist(smi):
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
    calls = 20
    k_ms, k_all = cuda_ms(lambda: HH.hand_histograms(ranks, suits, mask, device=DEV),
                          calls=calls)
    p_ms, p_all = cuda_ms(lambda: HH.hand_histograms_reference(ranks, suits, mask))
    b = bound(*hist_work(n))
    shape = HH.kernel_shape()
    log("13 hand histograms", f"ok: hand_histograms {n} envs launches={launches}; kernel == "
        f"plain bitwise ({outside} masked cards with a rank outside [0, 16) counted in no "
        f"bin); kernel median {k_ms * 1e3:.2f} us a call ({calls} back-to-back calls, samples "
        f"{', '.join(f'{t * 1e3:.2f}' for t in k_all)}), bound {b[0] * 1e3:.2f} us ({b[1]}), "
        f"plain median {p_ms:.3f} ms (samples {', '.join(f'{t:.3f}' for t in p_all)}); K5 "
        f"{shape['block']} threads a block, {shape['shared_bytes']} B shared a block, "
        f"{shape['registers']} registers, {shape['stack_bytes']} B stack [{smi}]")
    return {"launches": launches, "max_abs_err": err, "ms": k_ms, "plain_ms": p_ms,
            "work": hist_work(n), "shape": shape}


def phase_alu(smi):
    g = torch.Generator(device=DEV).manual_seed(14)
    seeded = torch.randint(-2 ** 31, 2 ** 31 - 1, (ALU_CHECK_TILES, 8, 8, 128), generator=g,
                           device=DEV, dtype=torch.int64).to(torch.int32)
    # Kernel == plain on seeded values and on the probe's own inputs at both
    # of its shapes; these launches come before the counted run.
    err = 0.0
    for what, x in ((f"{ALU_CHECK_TILES} seeded tiles", seeded),
                    *((f"the probe's {n} tiles", AC.probe_input(n, DEV))
                      for n in (AC.REFERENCE_TILES, AC.SATURATING_TILES))):
        k, p = AC.alu_chains(x, AC.ROUNDS, device=DEV), AC.alu_chains_reference(x, AC.ROUNDS)
        err = max(err, float((k.long() - p.long()).abs().max()))
        if not torch.equal(k, p):
            raise AssertionError(f"K6 differs from its plain version at {what} in "
                                 f"{int((k != p).sum())} entries")
    AC.alu_chains.launches = 0
    res = AC.main(["--rounds", str(AC.ROUNDS), "--reps", "200"])
    torch.cuda.synchronize()
    launches = AC.alu_chains.launches
    assert launches == 2 * (1 + 3 * 200), launches
    sat = res["shapes"]["saturating"]
    xs = AC.probe_input(AC.SATURATING_TILES, DEV)
    p_ms, _ = cuda_ms(lambda: AC.alu_chains_reference(xs, AC.ROUNDS), samples=3)
    sass = res["sass_loop"]
    rate = res["int32_ops_per_s"]["saturating"]
    log("14 alu ceiling", f"ok: kernel == plain bitwise at {ALU_CHECK_TILES} seeded tiles and "
        f"on the probe's inputs at {AC.REFERENCE_TILES} and {AC.SATURATING_TILES} tiles, x "
        f"{AC.ROUNDS} rounds; alu_ceiling.main launches={launches}: int32 source ops/s "
        f"{res['int32_ops_per_s']['reference_shape']:.4g} at {AC.REFERENCE_TILES} tiles "
        f"({res['shapes']['reference_shape']['ms_per_launch'] * 1e3:.2f} us a launch), "
        f"{rate:.4g} at {AC.SATURATING_TILES} tiles ({sat['ms_per_launch'] * 1e3:.2f} us a "
        f"launch) = {rate / INT32_OPS_PER_S:.3f} x the data sheet's {INT32_OPS_PER_S:.4g}; "
        f"loop body {sass['instructions']} SASS for 32 chain-rounds = "
        f"{sass['per_chain_round']:.3f} a chain-round against {AC.OPS_PER_ROUND} source ops "
        f"({sass['opcodes']}); plain at {AC.SATURATING_TILES} tiles {p_ms:.1f} ms [{smi}]")
    chains = AC.SATURATING_TILES * 8192
    work = (2 * 4 * chains, AC.source_ops(AC.SATURATING_TILES, AC.ROUNDS))
    return {"launches": launches, "max_abs_err": err, "ms": sat["ms_per_launch"],
            "plain_ms": p_ms, "sass_ops": chains * AC.ROUNDS * sass["per_chain_round"],
            "ms_reference_shape": res["shapes"]["reference_shape"]["ms_per_launch"],
            "rate": rate, "rate_reference_shape": res["int32_ops_per_s"]["reference_shape"],
            "sass": sass, "work": work}


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
    _, by_name = card_profile(lambda: run(TRAIN_UPDATES - 1))
    launches = kernel_launches(by_name)
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
    return ts, update_fn, launches, hist


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


def phase_train_timing(smi, ts, update_fn):
    cfg = TP.PPOConfig(**TRAIN)
    steps = cfg.n_envs * cfg.rollout_len
    state = {"ts": update_fn(ts)[0]}                       # warm-up
    torch.cuda.synchronize()

    def one(record=None):
        state["ts"], _ = update_fn(state["ts"], record=record)

    times, host = [], []
    for _ in range(5):
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        e0.record()
        one()
        e1.record()
        e1.synchronize()
        host.append((time.perf_counter() - t0) * 1e3)
        times.append(e0.elapsed_time(e1))
    upd_ms = statistics.median(times)
    rec = {}
    one(rec)
    torch.cuda.synchronize()
    ev = rec["events"]
    stages = {name: ev[i - 1][1].elapsed_time(e) for i, (name, e) in enumerate(ev) if i}
    idle_prof, by_name = card_profile(one)
    card_ms = sum(map(sum, by_name.values())) if by_name else None
    idle = None if card_ms is None else max(0.0, 1.0 - card_ms / upd_ms)
    top = sorted(((sum(ds), len(ds), n) for n, ds in by_name.items()), reverse=True)[:8]
    in_trainer = {}                      # the policy kernels' card time a launch in the update
    for name, kernel in POLICY_KERNELS:
        ds = [d for n, dl in by_name.items() if kernel in n for d in dl]
        in_trainer[name] = {"launches": len(ds), "us": statistics.median(ds) * 1e3 if ds else None}
    rate = steps / (upd_ms / 1e3)
    envs = state["ts"].env_states
    noop = torch.full((cfg.n_envs,), 59, dtype=torch.int32, device=DEV)
    step_us = host_call_us(lambda: FP.step_fused(envs, noop, device=DEV))
    loop_ms = host_loop_ms()
    log("17 trainer timing", f"update {cfg.n_envs}x{cfg.rollout_len} (fast_decay): median "
        f"{upd_ms:.3f} ms (CUDA events; samples {', '.join(f'{t:.3f}' for t in times)}; host "
        f"clock {statistics.median(host):.3f} ms) = {rate:.4g} PPO env-steps/s; stages of one "
        f"update (ms): {', '.join(f'{k} {v:.3f}' for k, v in stages.items())}; "
        + ("card activity not measured (no card activity in the profile)" if card_ms is None
           else f"card time an update {card_ms:.3f} ms (profiler) -> card idle share "
                f"{idle:.4f} of the unprofiled update ({idle_prof:.4f} of the profiled one); "
                f"top kernels {[(n[:48], c, round(ms, 3)) for ms, c, n in top]} (launches, ms); "
                f"policy kernels (median card us a launch, launches): "
                + ", ".join(f"{k} {v['us']:.1f} x{v['launches']}" for k, v in in_trainer.items()
                            if v["us"] is not None))
        + f"; host: one step_fused call enqueued in {step_us:.1f} us (median of 5 x 100 "
        f"back-to-back calls), a fixed Python loop {loop_ms:.1f} ms [{smi}]")
    return {"update_ms": upd_ms, "update_ms_samples": times, "host_update_ms": host,
            "env_steps_per_s": rate, "stages_ms": stages, "card_ms_per_update": card_ms,
            "card_idle_share": idle, "card_idle_share_profiled": idle_prof,
            "top_kernels": [{"name": n, "launches": c, "ms": ms} for ms, c, n in top],
            "policy_kernels_us": in_trainer,
            "host_step_fused_us": step_us, "host_loop_ms": loop_ms}

def card_ms_behind_sleep(fn, calls=20, rounds=5):
    """Median and all rounds of ``fn``'s card time per call: ``calls``
    back-to-back calls between two CUDA events, queued behind a card sleep
    long enough for the host to enqueue them all, so the host's time to
    call is not counted."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(rounds):
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(40_000_000)          # ~20 ms at 1.98 GHz
        e0.record()
        for _ in range(calls):
            fn()
        e1.record()
        e1.synchronize()
        times.append(e0.elapsed_time(e1) / calls)
    return statistics.median(times), times


def ptxas_lines(source, kernel):
    """This run's ptxas lines of ``kernel`` (phase 2's build)."""
    return [ln.split(": ", 1)[1] for ln in ptxas_summary(cuda_build.build_log[source]["ptxas"])
            if ln.startswith(kernel + ":")]


def phase_env_step(smi):
    """The engine's step (env_step_kernel) and reset (env_reset_kernel),
    and step_autoreset, against their plain versions along a fed battery;
    the policy inputs against theirs; the step kernel by branch class, and
    the reset kernel in both modes."""
    n = STEP_ENVS
    rng = np.random.default_rng(18)
    st = BAT.surgery(FF.rollout_full_rows_reference(4, n, 4, device=DEV)["state"], rng)
    env = torch.arange(n, device=DEV)
    st.hands_left = torch.where((env % 8 == 3) & (st.phase == 0), 1, st.hands_left)
    st.chips_scored = torch.where(env % 64 == 5, 1_000_000_001, st.chips_scored)
    st.done = st.done | (env % 64 == 37)
    errs = {"reward": 0.0, "obs": 0.0}
    counts = {"ended": 0, "illegal": 0, "autoresets": 0, "log1p_ulp": 0}
    k0 = generic_counts()
    script, mid, pool = [], None, []
    for t in range(STEP_CHECK_STEPS):
        pool.append(FF.pack_full_state(st))
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
        assert all(torch.equal(rows[k], want[k]) for k in rows), f"step {t}: env_reset differs"
        counts["ended"] += int(d1.sum())
        counts["illegal"] += int((~mask.gather(1, a.long()[:, None])[:, 0]).sum())
        if t == STEP_CHECK_STEPS // 2:
            mid = (FF.pack_full_state(st), a, plain, dp)
        st = s2
    torch.cuda.synchronize()
    launched = {k: v - k0[k] for k, v in generic_counts().items()}
    assert launched == {"env_step": 2 * STEP_CHECK_STEPS, "env_reset": 2 * STEP_CHECK_STEPS,
                        "K3b": 2 * STEP_CHECK_STEPS, "K3a": 0, "sampler": 0}, launched
    cov = BAT.coverage(np.stack(script))
    assert all(v > 0 for v in cov.values()), cov
    assert counts["ended"] > 0 and counts["illegal"] > 0

    packed, a, after, ended = mid
    calls = 20
    k_ms, k_all = card_ms_behind_sleep(lambda: FP.env_step_fused(packed, a, device=DEV), calls)
    state = FF.unpack_full_state(packed)
    call_ms, call_all = cuda_ms(lambda: FE.step(state, a), calls=calls)
    auto_ms, auto_all = cuda_ms(lambda: FE.step_autoreset(state, a), calls=calls)
    p_ms, p_all = cuda_ms(lambda: FP.env_step_rows_reference(packed, a))
    k3a_ms, _ = card_ms_behind_sleep(lambda: FP.step_fused(packed, a, device=DEV), calls)
    no_reset, all_reset = BAT.reset_batches(packed)
    for what, (p, act), ends in (("no_reset", no_reset, False), ("all_end", all_reset, True)):
        assert bool((FP.env_step_rows_reference(p, act)[2] == ends).all()), what
    batches = {"idle (action 59)": no_reset, "over (ante 101)": all_reset,
               **BAT.class_batches(pool, n, rng), "battery mix": (packed, a)}
    del pool
    classes = step_class_table({**batches, **class_splits("battery mix", packed, a)})
    reset = reset_timing(after, ended)
    reset_err = reset.pop("max_abs_err")
    shape = FP.env_step_kernel_shape()
    b = bound(n * (2 * PACKED_BYTES + 9), 0)
    ptxas = {k: ptxas_lines(src, k) for k, src in (
        ("fused_full_rollout_kernel", "fused_full_rollout.cu"),
        ("policy_step_kernel", "fused_policy_rollout.cu"),
        ("env_step_kernel", "fused_policy_rollout.cu"),
        ("policy_sample_kernel", "fused_policy_rollout.cu"))}
    env_ptxas = {k: ptxas_lines("fused_policy_rollout.cu", k) for k in (
        "env_step_kernel", "env_reset_kernel")}
    same = {k: "equal" if lines == RECORDED_PTXAS[k] else "CHANGED"
            for k, lines in ptxas.items()}
    fmt = ", ".join
    log("18 full step", f"ok: {n} envs x {STEP_CHECK_STEPS} steps of the battery "
        f"(coverage {cov}; {counts['illegal']} illegal actions, {counts['ended']} ends): "
        f"full_env.step (env_step_kernel) == plain no-reset step "
        f"bitwise (packed state, reward, done); step_autoreset (env_step_kernel, then "
        f"env_reset_kernel) == plain step + the engine's torch reset bitwise; env_reset_kernel "
        f"on each step's done envs == its plain version bitwise; observe_vector and "
        f"action_mask (K3b) == plain rows (log1p row entries 1 ulp apart: "
        f"{counts['log1p_ulp']}); launches {launched}; env_step_kernel at {n} envs, card time "
        f"behind a sleep ({calls} back-to-back calls): median {k_ms * 1e3:.1f} us (rounds "
        f"{fmt(f'{x * 1e3:.1f}' for x in k_all)}); K3a on the same inputs "
        f"{k3a_ms * 1e3:.1f} us; full_env.step call (pack, kernel, unpack) median "
        f"{call_ms:.3f} ms (samples {fmt(f'{x:.3f}' for x in call_all)}), step_autoreset call "
        f"{auto_ms:.3f} ms (samples {fmt(f'{x:.3f}' for x in auto_all)}); plain no-reset step "
        f"{p_ms:.1f} ms; bound {b[0] * 1e3:.2f} us ({b[1]}: 2 x {PACKED_BYTES} + 9 B an env at "
        f"{HBM_BYTES_PER_S:.3g} B/s); launch shape {shape}; ptxas {env_ptxas}; "
        + "; ".join(f"{name} {ptxas[k]} ({same[k]} to the recorded {RECORDED_PTXAS[k]})"
                    for name, k in (("K2", "fused_full_rollout_kernel"),
                                    ("K3a", "policy_step_kernel"),
                                    ("env_step_kernel", "env_step_kernel"),
                                    ("sampler", "policy_sample_kernel")))
        + f"; env_step_kernel by branch class: {class_table_text(classes)}; "
        f"env_reset_kernel: {reset_text(reset)} [{smi}]")
    return {"max_abs_err": max(errs.values()), "ms": k_ms, "ms_rounds": k_all,
            "classes": classes, "plain_ms": p_ms, "call_ms": call_ms,
            "step_autoreset_call_ms": auto_ms, "k3a_same_inputs_ms": k3a_ms,
            "launch_shape": shape, "ptxas": env_ptxas,
            "work": (n * (2 * PACKED_BYTES + 9), 0), "shape": [n], "reset": reset,
            "reset_max_abs_err": reset_err}


# A reset's integer work an env: 56 Threefry hashes (its key's fold_in, the
# shuffle key's three, the 52 words) and the 672 compare-exchanges of the
# 64-key bitonic sort at 8 int32 operations each (two 32-bit halves
# compared, two 64-bit selects).
RESET_OPS = 56 * THREEFRY_OPS + 672 * 8
RESET_ENVS = N_ENVS                     # fresh mode at the K2 call's width


def reset_work(masked, n):
    """(bytes, integer operations) of a reset of ``masked`` of ``n`` envs:
    each masked env's rows written and its key and step count read, and
    the mask."""
    return masked * (PACKED_BYTES + 12) + n, masked * RESET_OPS


def reset_timing(packed, mask, calls=20):
    """env_reset_kernel in autoreset mode on ``packed`` (the battery's
    post-step rows, ``mask`` its done envs) and in fresh mode over every
    env at 8192 and at 131072 (the K2 call's default reset), each held
    against its plain version bit for bit (``max_abs_err``: the largest
    difference of a row entry over the cases); card times behind a sleep,
    the plain versions' and the calls' (``autoreset``, ``reset``) by CUDA
    events."""
    out, err = {}, 0
    n = mask.shape[0]
    cases = {"autoreset": (packed, mask, None, n)}
    for m in (n, RESET_ENVS):
        keys = torch.stack(KR.split_child(*KR.seed_key(9, device=DEV),
                                          torch.arange(m, device=DEV)), -1)
        zeros = {k: torch.zeros(v.shape[:-1] + (m,), dtype=v.dtype, device=DEV)
                 for k, v in packed.items()}
        cases[f"fresh {m}"] = (zeros, torch.ones(m, dtype=torch.bool, device=DEV), keys, m)
    for what, (p, msk, keys, m) in cases.items():
        rows = {k: v.clone() for k, v in p.items()}
        FP.env_reset_fused(rows, msk, keys, device=DEV)
        want = FP.env_reset_rows_reference(p, msk, keys)
        err = max(err, *(int((rows[k].long() - want[k].long()).abs().max()) for k in rows))
        assert all(torch.equal(rows[k], want[k]) for k in rows), f"env_reset {what}"
        masked = int(msk.sum())
        k_ms, k_all = card_ms_behind_sleep(lambda: FP.env_reset_fused(rows, msk, keys, device=DEV),
                                           calls)
        p_ms, _ = cuda_ms(lambda: FP.env_reset_rows_reference(p, msk, keys), samples=3)
        out[what] = {"envs": m, "masked": masked, "ms": k_ms, "ms_rounds": k_all,
                     "plain_ms": p_ms, "work": reset_work(masked, m)}
    state = FF.unpack_full_state(packed)
    out["autoreset"]["call_ms"] = cuda_ms(lambda: FE.autoreset(state, mask), calls=calls)[0]
    keys = cases[f"fresh {RESET_ENVS}"][2]
    out[f"fresh {RESET_ENVS}"]["call_ms"] = cuda_ms(lambda: FE.reset(keys), calls=5)[0]
    out["shape"] = FP.env_reset_kernel_shape()
    out["max_abs_err"] = float(err)
    return out


def reset_text(r):
    return "; ".join(
        f"{what} ({v['masked']} of {v['envs']} envs): {v['ms'] * 1e3:.1f} us "
        f"(rounds {', '.join(f'{x * 1e3:.1f}' for x in v['ms_rounds'])}), plain "
        f"{v['plain_ms']:.3f} ms"
        + (f", call {v['call_ms']:.3f} ms" if "call_ms" in v else "")
        for what, v in r.items() if what != "shape") + f"; launch shape {r['shape']}"


def class_splits(name, packed, actions):
    """A mix's branch classes one at a time: for each class it holds, the
    same batch with only that class's envs taken (the others' action the
    no-op 59)."""
    cls = BAT.branch_classes(packed, actions)
    noop = torch.full_like(actions, 59)
    return {f"{name}, its {c}": (packed, torch.where(cls == i, actions, noop))
            for i, c in enumerate(BAT.BRANCH_CLASSES[:-1]) if bool((cls == i).any())}


def step_class_table(batches, calls=20):
    """Each fed-step batch's branch classes and env_step_kernel's card time
    a launch in us behind a sleep, the kernel first held against the plain
    no-reset step bit for bit."""
    table = {}
    for what, (p, a) in batches.items():
        want = FP.env_step_rows_reference(p, a)

        def fn():
            return FP.env_step_fused(p, a, device=DEV)
        got = fn()
        assert all(torch.equal(got[0][k], want[0][k]) for k in p), what
        assert torch.equal(got[1], want[1]) and torch.equal(got[2], want[2]), what
        table[what] = {"classes": BAT.class_histogram(p, a),
                       "us": card_ms_behind_sleep(fn, calls)[0] * 1e3}
    return table


def class_table_text(table):
    return "; ".join(f"{what} {row['classes']}: {row['us']:.1f} us"
                     for what, row in table.items())


ENGINE_WRAPPERS = {"env_step": FP.env_step_fused, "env_reset": FP.env_reset_fused,
                   "K3b": FP.observe_fused, "K3a": FP.step_fused, "sampler": FP.sample_fused}


def generic_counts():
    return {name: fn.launches for name, fn in ENGINE_WRAPPERS.items()}


def zero_counts():
    for fn in ENGINE_WRAPPERS.values():
        fn.launches = 0


def phase_generic_train(smi):
    """The fast_decay recipe over the generic rollout: the engine's step
    kernel and K3b, the policy and ``categorical`` in torch."""
    cfg = TP.PPOConfig(**GENERIC)
    hooks, calls, mix = TP.full_env_hooks(), [0], {}

    def recorded_step(st, actions):
        """The engine's step_autoreset; the state and actions of the first
        update's middle step are kept (the generic mix)."""
        if calls[0] == cfg.rollout_len // 2:
            mix["generic mix"] = (FF.pack_full_state(st), actions.to(torch.int32))
        calls[0] += 1
        return hooks.step_autoreset(st, actions)

    init_fn, update_fn, _ = TP.make_ppo(hooks._replace(step_autoreset=recorded_step), cfg,
                                        device=DEV)
    ts = init_fn([int(w) for w in KR.seed_key(0, device="cpu")])
    p0 = [p.detach().clone() for p in TP.param_list(ts.params)]
    illegal = torch.zeros((), dtype=torch.int64, device=DEV)
    episodes = torch.zeros((), dtype=torch.int64, device=DEV)
    zero_counts()
    hist, times, host, stages = [], [], [], []
    for _ in range(GENERIC_UPDATES):
        rec = {}
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        e0.record()
        ts, m = update_fn(ts, record=rec)
        e1.record()
        e1.synchronize()
        host.append((time.perf_counter() - t0) * 1e3)
        times.append(e0.elapsed_time(e1))
        ev = rec["events"]
        stages.append({name: ev[i - 1][1].elapsed_time(e) for i, (name, e) in enumerate(ev) if i})
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
    upd_ms = statistics.median(times)
    mid = stages[len(stages) // 2]
    state = {"ts": ts}

    def one():
        state["ts"], _ = update_fn(state["ts"])

    idle_prof, by_name = card_profile(one)
    card_ms = sum(map(sum, by_name.values())) if by_name else None
    idle = None if card_ms is None else max(0.0, 1.0 - card_ms / upd_ms)
    top = sorted(((sum(ds), len(ds), nm) for nm, ds in by_name.items()), reverse=True)[:8]
    env_us = [d for nm, ds in by_name.items() if "env_step_kernel" in nm for d in ds]
    rate = cfg.n_envs * T / (upd_ms / 1e3)
    classes = step_class_table({**mix, **class_splits("generic mix", *mix["generic mix"])})
    log("19 generic PPO", f"ok: make_ppo(full_env_hooks(), fast_decay, fused_rollout=False) "
        f"{cfg.n_envs}x{T}, ActorCritic(256, 256), {GENERIC_UPDATES} updates, launches="
        f"{launches} (env_step {T} an update, K3b 2 a step and 2 for the last value); every "
        f"action legal; {int(episodes)} episodes; params moved (max {moved:.3g}); update "
        f"median {upd_ms:.3f} ms (CUDA events; samples {', '.join(f'{x:.3f}' for x in times)}; "
        f"host clock {', '.join(f'{x:.3f}' for x in host)}) = {rate:.4g} PPO env-steps/s; "
        f"stages of the median update (ms): {', '.join(f'{k} {v:.3f}' for k, v in mid.items())}; "
        + ("card activity not measured (no card activity in the profile)" if card_ms is None
           else f"card time an update {card_ms:.3f} ms (profiler) -> card idle share "
                f"{idle:.4f} of the unprofiled update ({idle_prof:.4f} of the profiled one); "
                f"env_step_kernel {statistics.median(env_us) * 1e3 if env_us else 0:.1f} us a "
                f"launch x{len(env_us)}; top kernels {[(nm[:48], c, round(ms, 3)) for ms, c, nm in top]}"
                f" (launches, ms)")
        + f"; metrics by update {[{k: round(v, 5) for k, v in m.items()} for m in hist]}; "
        f"env_step_kernel on the first update's step {T // 2}: {class_table_text(classes)} "
        f"[{smi}]")
    return ts, {"config": GENERIC, "updates": GENERIC_UPDATES, "launches_main_path": launches,
                "update_ms": upd_ms, "update_ms_samples": times, "host_update_ms": host,
                "env_steps_per_s": rate, "stages_ms": mid, "card_ms_per_update": card_ms,
                "card_idle_share": idle, "card_idle_share_profiled": idle_prof,
                "env_step_in_update_us": statistics.median(env_us) * 1e3 if env_us else None,
                "generic_mix": classes,
                "top_kernels": [{"name": nm, "launches": c, "ms": ms} for ms, c, nm in top],
                "metrics_by_update": hist, "gpu": smi}


def phase_evaluate(smi, ts):
    """A greedy anti-loop evaluation of phase 19's policy on the card."""
    n0 = (FP.env_step_fused.launches, FP.env_reset_fused.launches)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    stats = EV.evaluate_policy(lambda p, o, m: p(o, m), ts.params, TP.full_env_hooks(),
                               EVAL_EPISODES, EVAL_STEPS, seed=7, obs_stats=ts.obs_stats)
    wall = time.perf_counter() - t0
    assert (FP.env_step_fused.launches - n0[0], FP.env_reset_fused.launches - n0[1]) == (
        EVAL_STEPS, 1)
    assert set(stats) == {"episodes", "mean_reward", "mean_length", "max_reward",
                          "mean_ante", "max_ante"}, stats
    assert 0 <= stats["episodes"] <= EVAL_EPISODES and 0 < stats["mean_length"] <= EVAL_STEPS
    assert np.isfinite(stats["mean_reward"]) and stats["max_ante"] >= 1
    log("20 evaluate", f"ok: evaluate_policy greedy anti-loop, {EVAL_EPISODES} episodes x "
        f"{EVAL_STEPS} steps, phase 19's policy and statistics: {stats}; env_step launches "
        f"{EVAL_STEPS}, env_reset 1 (its reset); wall {wall:.3f} s ({wall / EVAL_STEPS * 1e3:.2f} ms a step) [{smi}]")
    return {"stats": stats, "wall_s": wall, "episodes": EVAL_EPISODES, "steps": EVAL_STEPS}


def phase_gym(smi):
    """The Gym shell on the card: random legal steps against the same shell
    on the CPU, and the validator's two checks."""
    card, cpu = BalatroGymEnv(seed=21), BalatroGymEnv(seed=21, device="cpu")
    o, _ = card.reset()
    oc, _ = cpu.reset()
    rng = np.random.default_rng(21)
    ends, reward = 0, 0.0
    t0 = time.perf_counter()
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
    wall = time.perf_counter() - t0
    t0 = time.perf_counter()
    assert BalatroEnvValidator.validate_determinism()
    assert BalatroEnvValidator.validate_action_masking()
    vwall = time.perf_counter() - t0
    log("21 gym shell", f"ok: BalatroGymEnv on the card, {GYM_STEPS} random legal steps == the "
        f"same shell on the CPU (observations with their dtypes, rewards, dones); {ends} "
        f"episodes ended, reward {reward:.2f}; {wall:.2f} s for both shells; "
        f"validate_determinism and validate_action_masking on the card pass in {vwall:.2f} s "
        f"[{smi}]")
    return {"steps": GYM_STEPS, "ends": ends, "validators_s": vwall}


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


def phase_imitation(smi):
    """The imitation path on the card: behaviour cloning against the same
    updates over the plain versions, the expert's rollout against a random
    policy, the expert fixture, and a resumed fused-trainer update."""
    t_phase = time.perf_counter()
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
    bc_ms, bc_samples = cuda_ms(lambda: update_fn(bc), samples=5)
    state = {"bc": bc}

    def bc_one():
        state["bc"], _ = update_fn(state["bc"])

    idle_prof, by_name = card_profile(bc_one)
    bc_card_ms = sum(map(sum, by_name.values())) if by_name else None
    t0 = time.perf_counter()
    bc_one()
    torch.cuda.synchronize()
    bc_host_ms = (time.perf_counter() - t0) * 1e3

    # the expert's rollout, its actions replayed and checked legal, and a
    # masked-uniform random policy from the same reset
    ekey = (0, 11)
    t0 = time.perf_counter()
    fin, e_total, e_eps, e_ante = EX.rollout_expert(ekey, EXPERT_ENVS, EXPERT_STEPS, device=DEV)
    torch.cuda.synchronize()
    e_wall = time.perf_counter() - t0
    k1, k2 = (torch.tensor(w, dtype=torch.int64, device=DEV) for w in ekey)
    reset = FE.reset(torch.stack(KR.split_child(k1, k2, torch.arange(EXPERT_ENVS, device=DEV)), -1))
    st, total, illegal, mid = reset, torch.zeros((), device=DEV), 0, None
    for t in range(EXPERT_STEPS):
        a = EX.expert_action(st)
        illegal += int((~FE.action_mask(st).gather(1, a.long()[:, None])).sum())
        st, r, _ = FE.step_autoreset(st, a)
        total = total + r.sum()
        if t == EXPERT_STEPS // 2:
            mid = st
    assert illegal == 0, f"{illegal} expert actions were illegal"
    assert float(total) == float(e_total), (float(total), float(e_total))
    assert FF.states_equal(st, fin) == []
    st, r_total = reset, torch.zeros((), device=DEV)
    for k in KR.split_keys((0, 9), EXPERT_STEPS):
        a, _ = TP.categorical(k, torch.where(FE.action_mask(st), 0.0, -torch.inf))
        st, r, _ = FE.step_autoreset(st, a)
        r_total = r_total + r.sum()
    assert float(e_total) > float(r_total), (float(e_total), float(r_total))
    phases = torch.bincount(mid.phase.long(), minlength=4).tolist()
    ex_ms, ex_samples = cuda_ms(lambda: EX.expert_action(mid), samples=5)

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
    wall = time.perf_counter() - t_phase
    log("22 imitation and resume", f"ok: make_bc({BC_ENVS}), ActorCritic(256, 256), "
        f"{BC_UPDATES} updates, launches={launches} (K3b 2 and env_step_kernel 1 an update); "
        f"== the same updates over the plain versions on the card (obs, mask, targets and "
        f"env states bit for bit, the log1p row within 1 ulp: {errs['log1p_entries']} entries "
        f"differ, max {errs['obs']:.3g}; loss within {errs['loss']:.3g}, params within "
        f"{errs['params']:.3g}); metrics {[{n: round(v, 5) for n, v in m.items()} for m in hist]}; "
        f"one BC update {bc_ms:.3f} ms (CUDA events; samples "
        f"{', '.join(f'{x:.3f}' for x in bc_samples)}; host clock {bc_host_ms:.3f}), card "
        + ("time not measured (no card activity in the profile)" if bc_card_ms is None else
           f"time {bc_card_ms:.3f} ms (profiler), idle share {max(0.0, 1 - bc_card_ms / bc_ms):.4f}"
           f" of the unprofiled update ({idle_prof:.4f} of the profiled one)")
        + f"; rollout_expert {EXPERT_ENVS}x{EXPERT_STEPS} {e_wall:.3f} s: reward "
        f"{float(e_total):.2f} > random {float(r_total):.2f} from the same reset, "
        f"{int(e_eps)} episodes, max ante {int(e_ante)}, every action legal; expert_action "
        f"at {EXPERT_ENVS} envs {ex_ms:.3f} ms (CUDA events, mid-rollout phases {phases}; "
        f"samples {', '.join(f'{x:.3f}' for x in ex_samples)}); expert fixture (2 x 40) "
        f"== tests/fixtures/expert_regression.json (ints exact, floats within {fx_err:.3g}); "
        f"fused fast_decay {cfg.n_envs}x{cfg.rollout_len}: the update after a restore == the "
        f"uninterrupted one bit for bit (snapshot {ckpt_mb:.1f} MiB); {wall:.1f} s [{smi}]")
    return {"bc": {"envs": BC_ENVS, "updates": BC_UPDATES, "launches_main_path": launches,
                   "update_ms": bc_ms, "update_ms_samples": bc_samples,
                   "host_update_ms": bc_host_ms, "card_ms_per_update": bc_card_ms,
                   "card_idle_share_profiled": idle_prof, "plain_parity": errs,
                   "metrics_by_update": hist},
            "expert": {"envs": EXPERT_ENVS, "steps": EXPERT_STEPS, "rollout_s": e_wall,
                       "total_reward": float(e_total), "random_total_reward": float(r_total),
                       "episodes": int(e_eps), "max_ante": int(e_ante),
                       "expert_action_ms": ex_ms, "expert_action_ms_samples": ex_samples,
                       "fixture_max_float_diff": fx_err},
            "resume": {"config": TRAIN, "equal": True, "snapshot_mib": ckpt_mb},
            "wall_s": wall, "gpu": smi}


def timed_updates(update_fn, ts, plain_update, tp, updates, compare):
    """``updates`` updates through the kernels, each timed by CUDA events
    and followed by the same update over the plain versions, which
    ``compare(u, card record, plain record, card state, plain state)``
    holds against it. Returns (state, plain state, ms samples, metrics)."""
    times, hist = [], []
    for u in range(updates):
        rk, rp = {}, {}
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        e0.record()
        ts, m = update_fn(ts, record=rk)
        e1.record()
        e1.synchronize()
        times.append(e0.elapsed_time(e1))
        hist.append({k: float(v) for k, v in m.items()})
        tp, _ = plain_update(tp, record=rp)
        compare(u, rk, rp, ts, tp)
    return ts, tp, times, hist


def max_param_diff(a, b):
    return max(float((x.detach() - y.detach()).abs().max()) for x, y in zip(a, b))


def idle_of(update_fn, ts, upd_ms):
    """(card ms of one more update by the profiler, its idle share of the
    unprofiled update's time, the profiled update's own idle share)."""
    state = {"ts": ts}

    def one():
        state["ts"], _ = update_fn(state["ts"])

    idle_prof, by_name = card_profile(one)
    card_ms = sum(map(sum, by_name.values())) if by_name else None
    return card_ms, None if card_ms is None else max(0.0, 1.0 - card_ms / upd_ms), idle_prof


def phase_other_learners(smi):
    """A2C and DQN on the flagship env against the same updates over the
    plain versions, the macro env and shell on the card against the CPU,
    and the hyperparameter search."""
    t_phase = time.perf_counter()
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
    ts, _, a2c_times, a2c_hist = timed_updates(update_fn, ts, plain_update, copy.deepcopy(ts),
                                               A2C_UPDATES, a2c_compare)
    a2c_launches = generic_counts()
    T = cfg.rollout_len
    want = {"env_step": A2C_UPDATES * T, "env_reset": A2C_UPDATES * T,
            "K3b": A2C_UPDATES * (2 * T + 2), "K3a": 0, "sampler": 0}
    assert a2c_launches == want, (a2c_launches, want)
    assert a2c_err["obs_log1p"] <= NORM_LOG1P_ATOL, a2c_err
    assert a2c_err["params"] <= PARAM_ATOL and a2c_err["nu"] <= PARAM_ATOL, a2c_err
    assert all(np.isfinite(v) for m in a2c_hist for v in m.values()), a2c_hist
    a2c_ms = statistics.median(a2c_times)
    a2c_card, a2c_idle, a2c_idle_prof = idle_of(update_fn, ts, a2c_ms)
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
    ts, _, dqn_times, dqn_hist = timed_updates(update_fn, ts, plain_update, copy.deepcopy(ts),
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
    dqn_ms = statistics.median(dqn_times)
    dqn_card, dqn_idle, dqn_idle_prof = idle_of(update_fn, ts, dqn_ms)
    del ts

    # the macro env: the card against the CPU, step by step
    t0 = time.perf_counter()
    keys = torch.stack(KR.split_child(torch.tensor(0), torch.tensor(23),
                                      torch.arange(MACRO_ENVS)), -1)
    sc, sk = ME.reset(keys), ME.reset(keys.to(DEV))
    g = torch.Generator().manual_seed(23)
    step_ms, rewards, ends = [], 0.0, 0
    for t in range(MACRO_STEPS):
        mask = ME.action_mask(sc)
        assert torch.equal(ME.action_mask(sk).cpu(), mask), f"macro step {t}: mask"
        # a done env (past ante 8) has no legal action and stays as it is
        a = torch.multinomial(mask.float() + ~mask.any(1, keepdim=True), 1,
                              generator=g)[:, 0].to(torch.int32)
        ak = a.to(DEV)
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        e0.record()
        sk, rk, dk = ME.step(sk, ak)
        e1.record()
        sc, rc, dc = ME.step(sc, a)
        e1.synchronize()
        step_ms.append(e0.elapsed_time(e1))
        assert torch.equal(rk.cpu(), rc) and torch.equal(dk.cpu(), dc), f"macro step {t}"
        for name, v in vars(sc).items():
            assert torch.equal(getattr(sk, name).cpu(), v), f"macro step {t}: {name}"
        ok = ME.observe(sk)
        for name, v in ME.observe(sc).items():
            assert torch.equal(ok[name].cpu(), v), f"macro step {t}: observation {name}"
        rewards += float(rc.sum())
        ends += int(dc.sum())
    macro_wall = time.perf_counter() - t0
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
    t0 = time.perf_counter()
    seen, sample = [], TT._sample
    TT._sample = lambda r: seen.append(sample(r)) or seen[-1]
    try:
        tune_out = TT.tune(TUNE_TRIALS, "full", TUNE_UPDATES, TUNE_ENVS)
    finally:
        TT._sample = sample
    tune_s = time.perf_counter() - t0
    ref = random.Random(0)
    assert tune_out["backend"] == "random-search" and tune_out["trials"] == TUNE_TRIALS
    assert seen == [sample(ref) for _ in range(TUNE_TRIALS)], seen
    assert np.isfinite(tune_out["best_value"]) and tune_out["best_params"] in seen

    wall = time.perf_counter() - t_phase

    def idle_text(card_ms, idle, idle_prof):
        return ("card time not measured (no card activity in the profile)" if card_ms is None
                else f"card {card_ms:.3f} ms (profiler), idle share {idle:.4f} of the unprofiled "
                     f"update ({idle_prof:.4f} of the profiled one)")

    log("23 other learners and macro", f"ok: A2C {A2C_ENVS}x{T} ActorCritic(256, 256), "
        f"{A2C_UPDATES} updates, launches={a2c_launches} (K3b 2 a step + 2, env_step 1 a step) "
        f"== the plain versions on the card (masks, actions, rewards, dones, env states bit for "
        f"bit; normalised log1p row within {a2c_err['obs_log1p']:.3g}; params within "
        f"{a2c_err['params']:.3g}, nu within {a2c_err['nu']:.3g}); update median {a2c_ms:.3f} "
        f"ms (CUDA events; samples {', '.join(f'{x:.3f}' for x in a2c_times)}), "
        f"{idle_text(a2c_card, a2c_idle, a2c_idle_prof)}; DQN {DQN_ENVS}x{DQN_STEPS}, ring "
        f"{dcfg.buffer_size}, QNetwork(256, 256), {DQN_UPDATES} updates, launches={dqn_launches}"
        f" (K3b 4 a step, env_step 1 a step); ring wrapped to ptr {ring[0]} len {ring[1]}; == "
        f"the plain versions (ring bit for bit, {dqn_err['obs_log1p_entries']} log1p entries 1 "
        f"ulp apart; params within {dqn_err['params']:.3g}, target within "
        f"{dqn_err['target']:.3g}); update median {dqn_ms:.3f} ms (samples "
        f"{', '.join(f'{x:.3f}' for x in dqn_times)}), {idle_text(dqn_card, dqn_idle, dqn_idle_prof)}"
        f"; macro env {MACRO_ENVS}x{MACRO_STEPS} random legal steps on the card == the CPU "
        f"(every field, reward and observation), card step median "
        f"{statistics.median(step_ms):.3f} ms (CUDA events), {ends} episodes ended, max ante "
        f"{macro_ante}, {macro_wall:.1f} s for both; BalatroMacroGymEnv {MACRO_SHELL_STEPS} steps "
        f"on the card == the CPU's ({shell_ends} episodes); tune {TUNE_TRIALS} trials x "
        f"{TUNE_UPDATES} updates at {TUNE_ENVS} envs (full) {tune_s:.1f} s: {tune_out}; "
        f"{wall:.1f} s [{smi}]")
    return {"a2c": {"config": {"n_envs": A2C_ENVS, "rollout_len": T, "hidden": list(cfg.hidden)},
                    "updates": A2C_UPDATES, "launches_main_path": a2c_launches,
                    "update_ms": a2c_ms, "update_ms_samples": a2c_times,
                    "card_ms_per_update": a2c_card, "card_idle_share": a2c_idle,
                    "card_idle_share_profiled": a2c_idle_prof, "plain_parity": a2c_err,
                    "metrics_by_update": a2c_hist},
            "dqn": {"config": {"n_envs": DQN_ENVS, "steps_per_update": DQN_STEPS,
                               "buffer_size": dcfg.buffer_size, "batch_size": dcfg.batch_size,
                               "hidden": list(dcfg.hidden)},
                    "updates": DQN_UPDATES, "launches_main_path": dqn_launches,
                    "ring_ptr_len": list(ring), "update_ms": dqn_ms,
                    "update_ms_samples": dqn_times, "card_ms_per_update": dqn_card,
                    "card_idle_share": dqn_idle, "card_idle_share_profiled": dqn_idle_prof,
                    "plain_parity": dqn_err, "metrics_by_update": dqn_hist},
            "macro": {"envs": MACRO_ENVS, "steps": MACRO_STEPS,
                      "card_step_ms": statistics.median(step_ms), "card_step_ms_samples": step_ms,
                      "episodes": ends, "max_ante": macro_ante, "wall_s": macro_wall,
                      "shell_steps": MACRO_SHELL_STEPS},
            "tune": {**tune_out, "updates": TUNE_UPDATES, "envs": TUNE_ENVS, "wall_s": tune_s},
            "wall_s": wall, "gpu": smi}


# ---------------------------------------------------------------------------
# Phase 24: data parallel
# ---------------------------------------------------------------------------

# Two ranks share the card over gloo (NCCL refuses two ranks on one GPU);
# one rank runs over NCCL. The recipe is phase 15's at 8192 x 128 global.
DP_RANKS, DP_UPDATES, DP_NCCL_UPDATES = 2, 3, 5
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


class AllReduceClock:
    """Counts ``torch.distributed.all_reduce`` calls and the host's seconds
    in them (which include waiting for the card's queued work: gloo copies
    the buffer to the host)."""

    def __enter__(self):
        import torch.distributed as dist
        self.calls, self.seconds, self.orig = 0, 0.0, dist.all_reduce

        def timed(*args, **kw):
            t0 = time.perf_counter()
            try:
                return self.orig(*args, **kw)
            finally:
                self.calls += 1
                self.seconds += time.perf_counter() - t0
        dist.all_reduce = timed
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
    digests, hist, upd_ms, host_ms = [], [], [], []

    def run(n):
        for _ in range(n):
            rec = {}
            e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            t0 = time.perf_counter()
            e0.record()
            state["ts"], m = step_fn(state["ts"], record=rec)
            e1.record()
            e1.synchronize()
            host_ms.append((time.perf_counter() - t0) * 1e3)
            upd_ms.append(e0.elapsed_time(e1))
            state["illegal"] += int(legal_count(rec["traj"]))
            digests.append(param_digest(state["ts"].params))
            hist.append({k: float(v) for k, v in m.items()})
            del rec

    zero_dp_counts()
    with AllReduceClock() as clock:
        run(1)                             # captures the collection's graph, then replays it
        captured = dp_counts()
        _, by_name = card_profile(lambda: run(DP_UPDATES - 1))
    launches, illegal = kernel_launches(by_name), state["illegal"]
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
            "metrics_by_update": hist, "update_ms": upd_ms, "host_update_ms": host_ms,
            "all_reduce_calls": clock.calls, "all_reduce_host_ms": clock.seconds * 1e3,
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
    torch.cuda.synchronize()
    out["sim"] = {"launches": dp_counts()["K4"], "ms": cuda_ms(
        lambda: PM.rollout_fused_sharded(DP_SEED, n, T, BENCH_JOKERS, mesh=mesh), 3, 3)[0]}
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
    torch.cuda.synchronize()
    c = dp_counts()
    out["full"] = {"launches": c["K2"], "reset_launches": c["env_reset"], "ms": cuda_ms(
        lambda: PM.rollout_full_sharded(DP_SEED, n, T, mesh=mesh), 3, 3)[0]}
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


def timed_update(step_fn, ts):
    """(state, metrics, ms by CUDA events) of one update."""
    e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    e0.record()
    ts, m = step_fn(ts)
    e1.record()
    e1.synchronize()
    return ts, m, e0.elapsed_time(e1)


def dp_nccl_main(tmp):
    """A child of phase 24 (b): the recipe's update on one rank over NCCL
    (gloo where torch has no NCCL, said in the result), and in the same
    process the undistributed update, the two in turns (plain, mesh, mesh,
    plain), so that their difference is the key folding's and the
    reductions' cost."""
    import torch.distributed as dist
    backend = "nccl" if dist.is_nccl_available() else "gloo"
    dist.init_process_group(backend, init_method="env://", world_size=1, rank=0,
                            timeout=datetime.timedelta(seconds=PM.INIT_TIMEOUT_S))
    try:
        mesh = PM.make_mesh()
        cfg = TP.PPOConfig(**TRAIN)
        key = [int(w) for w in KR.seed_key(0, device="cpu")]
        init_fn, step_fn, _ = PM.make_distributed_ppo(TP.full_env_hooks(), cfg, mesh)
        plain_init, plain_fn, _ = TP.make_ppo(TP.full_env_hooks(), cfg, device=mesh.device)
        ts, tp = init_fn(key), plain_init(key)
        ts, _ = step_fn(ts)                                 # warm-up
        tp, _ = plain_fn(tp)
        torch.cuda.synchronize()
        times, plain_times, calls, seconds = [], [], 0, 0.0
        zero_dp_counts()
        for i in range(2 * DP_NCCL_UPDATES):
            if i % 4 in (1, 2):
                with AllReduceClock() as clock:
                    ts, m, ms = timed_update(step_fn, ts)
                times.append(ms)
                calls, seconds = calls + clock.calls, seconds + clock.seconds
            else:
                tp, _, ms = timed_update(plain_fn, tp)
                plain_times.append(ms)
        launches = dp_counts()
        res = {"backend": dist.get_backend(), "nccl_available": dist.is_nccl_available(),
               "update_ms": statistics.median(times), "update_ms_samples": times,
               "undistributed_ms": statistics.median(plain_times),
               "undistributed_ms_samples": plain_times,
               "all_reduce_per_update": calls / len(times),
               "all_reduce_host_ms_per_update": seconds * 1e3 / len(times),
               "launches": launches, "metrics": {k: float(v) for k, v in m.items()}}
    finally:
        PM.destroy()
    # both collections captured in the warm-up; a replay launches no wrapper
    assert {k: launches[k] for k in ("K3b", "K3a", "sampler")} == {
        "K3b": 0, "K3a": 0, "sampler": 0}, launches
    replays = (step_fn.collection.replays, plain_fn.collection.replays)
    assert replays == (1 + DP_NCCL_UPDATES, 1 + DP_NCCL_UPDATES), replays
    res["built_nothing"] = all(v["cached"] for v in cuda_build.build_log.values())
    (Path(tmp) / "nccl.json").write_text(json.dumps(res))
    return 0


def phase_data_parallel(smi, train_ms):
    t_phase = time.perf_counter()
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        filter(None, [str(ROOT), os.environ.get("PYTHONPATH")])))
    with tempfile.TemporaryDirectory() as tmp:
        n, steps = DP_FED
        jok = JOKER_SETS[np.arange(n) % len(JOKER_SETS)]
        acts, _, _ = legal_script(jok, n, steps, seed=11)
        np.savez(Path(tmp) / "fed.npz", jokers=jok, actions=acts)
        t0 = time.perf_counter()
        PM.launch([sys.executable, str(ROOT / "chip_smoke.py"), "--dp-rank", tmp], DP_RANKS,
                  timeout=DP_TIMEOUT_S, env=env, cwd=ROOT)
        ranks_s = time.perf_counter() - t0
        ranks = [json.loads((Path(tmp) / f"rank{r}.json").read_text()) for r in range(DP_RANKS)]
        shards = [dict(np.load(Path(tmp) / f"fed_rank{r}.npz")) for r in range(DP_RANKS)]
        one = FR.rollout_fused(0, n, steps, jok, actions=acts, device=DEV)
        for k, v in one.items():
            cat = np.concatenate([s[k] for s in shards])
            if not np.array_equal(cat, v.cpu().numpy()):
                raise AssertionError(f"fed shards concatenated vs the one-process call: {k}")
        t0 = time.perf_counter()
        PM.launch([sys.executable, str(ROOT / "chip_smoke.py"), "--dp-nccl", tmp], 1,
                  timeout=DP_TIMEOUT_S, env=env, cwd=ROOT)
        nccl_s = time.perf_counter() - t0
        nccl = json.loads((Path(tmp) / "nccl.json").read_text())
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", "balatro_gym_tpu_torch.parallel.scaling_bench",
                           "--env", "full"], capture_output=True, text=True, cwd=ROOT, env=env,
                          timeout=DP_TIMEOUT_S)
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-4000:]
    bench = json.loads(proc.stdout.strip().splitlines()[-1])
    bench_s = time.perf_counter() - t0
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
    assert all(res["train"]["all_reduce_calls"] == DP_UPDATES * want_ar for res in ranks)
    wall = time.perf_counter() - t_phase
    per_rank = [{"update_ms": res["train"]["update_ms"],
                 "all_reduce_host_ms": res["train"]["all_reduce_host_ms"],
                 "launches": res["train"]["launches"]} for res in ranks]
    log("24 data parallel", f"ok: (a) {DP_RANKS} ranks sharing the card over gloo, "
        f"fast_decay {cfg.n_envs}x{cfg.rollout_len} global ({ranks[0]['train']['local_envs']} "
        f"envs a rank), {DP_UPDATES} updates, each a replay of the collection's graph: the "
        f"wrappers' launches in the capture a rank "
        f"{[res['train']['captured'] for res in ranks]}, launches in the last "
        f"{DP_UPDATES - 1} updates a rank (profiler) "
        f"{[res['train']['launches'] for res in ranks]}; parameters equal across ranks after "
        f"every update; every action legal; update ms by rank (CUDA events; the first "
        f"holds each process's start-up on the card) "
        + "; ".join(f"rank {r}: {', '.join(f'{x:.3f}' for x in p['update_ms'])} with "
                    f"{p['all_reduce_host_ms']:.3f} ms of host in {want_ar * DP_UPDATES} "
                    f"all_reduce calls" for r, p in enumerate(per_rank))
        + f"; parity over the ranks (fused == plain on each shard): params within "
        f"{max(res['parity']['params'] for res in ranks):.3g}, log-probs within "
        f"{max(res['parity']['log_prob'] for res in ranks):.3g}; (b) one rank over "
        f"{nccl['backend']} (nccl available: {nccl['nccl_available']}): update median "
        f"{nccl['update_ms']:.3f} ms (samples {', '.join(f'{x:.3f}' for x in nccl['update_ms_samples'])}"
        f"), the undistributed update in turns with it in the same process "
        f"{nccl['undistributed_ms']:.3f} ms (samples "
        f"{', '.join(f'{x:.3f}' for x in nccl['undistributed_ms_samples'])}), phase 17's "
        f"{train_ms:.3f} ms, "
        f"{nccl['all_reduce_per_update']:g} all-reduces an update ({nccl['all_reduce_host_ms_per_update']:.3f}"
        f" ms of host in them); (c) rollout_fused_sharded {DP_SIM[0]}x{DP_SIM[1]} sampled: "
        f"each rank == rollout_fused(seed + rank * n_local_tiles) bitwise, K4 "
        f"{[res['rollouts']['sim']['launches'] for res in ranks]} launches, a call "
        f"{[round(res['rollouts']['sim']['ms'], 3) for res in ranks]} ms (CUDA events, median "
        f"of 3 x 3 calls, both ranks at once); fed {n}x{steps}: "
        f"the shards concatenated == the one-process call; rollout_full_sharded "
        f"{DP_FULL[0]}x{DP_FULL[1]}: each rank == rollout_full_fused on its slice bitwise, K2 "
        f"{[res['rollouts']['full']['launches'] for res in ranks]} and env_reset "
        f"{[res['rollouts']['full']['reset_launches'] for res in ranks]} launches, a call "
        f"{[round(res['rollouts']['full']['ms'], 3) for res in ranks]} ms; (d) scaling_bench "
        f"--env full: {json.dumps(bench)} (one card: N = 1); children {ranks_s:.1f} s, "
        f"{nccl_s:.1f} s, {bench_s:.1f} s; phase {wall:.1f} s [{smi}]")
    return {"ranks": DP_RANKS, "config": TRAIN, "updates": DP_UPDATES, "per_rank": per_rank,
            "digests_equal": True, "parity": [res["parity"] for res in ranks],
            "nccl": nccl, "undistributed_update_ms": train_ms,
            "rollouts": [res["rollouts"] for res in ranks], "scaling_bench": bench,
            "wall_s": wall, "gpu": smi}


def main(argv):
    if not torch.cuda.is_available():
        print("chip_smoke: torch sees no CUDA card", file=sys.stderr)
        return 1
    if argv[:1] == ["--dp-rank"]:
        return dp_rank_main(argv[1])
    if argv[:1] == ["--dp-nccl"]:
        return dp_nccl_main(argv[1])
    smi = phase_device()
    phase_build()
    launches = phase_main_path()
    err = max(phase_fed(), phase_sampled())
    k4 = phase_timing(smi)
    full_launches, full_err = phase_full_main()
    fed_err, fed_st, fed_script = phase_full_fed()
    full_err = max(full_err, fed_err)
    fk_ms, fa_ms, fp_ms, fk_rate, fp_rate, k2_shape = phase_full_timing(smi)
    policy_launches, net, st0, traj, final = phase_policy_main()
    policy_err, mid = phase_policy_parity(net, st0, traj, final, (fed_st, fed_script))
    pt = phase_policy_timing(smi, net, mid)
    hist = phase_hist(smi)
    alu = phase_alu(smi)
    ts, update_fn, train_launches, train_hist = phase_train_main()
    parity = phase_train_parity()
    tt = phase_train_timing(smi, ts, update_fn)
    es = phase_env_step(smi)
    g_ts, generic = phase_generic_train(smi)
    ev = phase_evaluate(smi, g_ts)
    gym = phase_gym(smi)
    imitation = phase_imitation(smi)
    learners = phase_other_learners(smi)
    dp = phase_data_parallel(smi, tt["update_ms"])

    # (bytes, integer operations) of each kernel's measured call
    work = {"fused_rollout": (N_ENVS * ((FR.N_SCAL + 32 + 32 + 64) * 4
                                        + (2 * FR.N_CARDS + 8 + 1) * 4),
                              N_ENVS * (N_STEPS * sum(K4_STEP_OPS.values()) + THREEFRY_OPS)),
            "fused_full_rollout": (N_ENVS * (2 * PACKED_BYTES + 8),
                                   N_ENVS * (N_STEPS + 1) * THREEFRY_OPS),
            **{k: w for k, w in zip(("policy_step", "policy_observe", "policy_sample"),
                                    policy_work(POLICY_ENVS, pt["hand_cards"]).values())},
            "hand_histograms": hist["work"], "alu_chains": alu["work"],
            "env_step": es["work"], "env_reset": es["reset"]["autoreset"]["work"]}
    src = "balatro_gym_tpu_torch/csrc/"
    policy_src = src + "fused_policy_rollout.cu"
    kernels = [{
        "name": "fused_rollout", "route": "cuda", "source": src + "fused_rollout.cu",
        "replaces": "balatro_gym_tpu/ops/fused_rollout.py:126",
        "launches": launches, "max_abs_err": err, **k4,
        "dp_launches_by_rank": [r["sim"]["launches"] for r in dp["rollouts"]],
        "shape": [N_ENVS, N_STEPS], "plain_shape": [N_ENVS, 32],
        "step_ops": K4_STEP_OPS}, {
        "name": "fused_full_rollout", "route": "cuda", "source": src + "fused_full_rollout.cu",
        "replaces": "balatro_gym_tpu/ops/fused_full_rollout.py:2299",
        "launches": full_launches, "max_abs_err": full_err, "ms": fk_ms, "plain_ms": fp_ms,
        "dp_launches_by_rank": [r["full"]["launches"] for r in dp["rollouts"]],
        "kernel_alone_ms": fa_ms,
        "shape": [N_ENVS, N_STEPS], "plain_shape": [N_ENVS, FULL_PLAIN_STEPS],
        "env_steps_per_s": fk_rate, "plain_env_steps_per_s": fp_rate, **k2_shape}]
    for name, kname, replaces in (
            ("K3a", "policy_step", "balatro_gym_tpu/ops/fused_policy_rollout.py:174"),
            ("K3b", "policy_observe", "balatro_gym_tpu/ops/fused_policy_rollout.py:190"),
            ("sampler", "policy_sample", "balatro_gym_tpu/ops/fused_policy_rollout.py:444")):
        tm = pt["times"][name]
        call_ms = tm["call"][0]
        kernels.append({
            "name": kname, "route": "cuda", "source": policy_src, "replaces": replaces,
            "launches": policy_launches[name],
            # by kernel name in a profile of the trainer's last updates (graph replays)
            "trainer_launches": train_launches[name],
            "trainer_profiled_updates": TRAIN_UPDATES - 1,
            "dp_launches_by_rank": [r["launches"][name] for r in dp["per_rank"]],
            "dp_profiled_updates": DP_UPDATES - 1,
            "max_abs_err": policy_err[name],
            "ms": tm["card_ms"] if tm["card_ms"] is not None else call_ms,
            "plain_ms": tm["plain"][0],
            "ms_from": "profiler" if tm["card_ms"] is not None else "events",
            "call_ms": call_ms, "shape": [POLICY_ENVS], **pt["shapes"][name]})
    kernels[-3]["collection_ms"] = pt["coll_ms"]
    kernels[-3]["collection_shape"] = [POLICY_ENVS, POLICY_STEPS]
    kernels[-3]["plain_collection_ms"] = pt["plain_coll_ms"]
    kernels[-3]["plain_collection_shape"] = [POLICY_ENVS, POLICY_PLAIN_STEPS]
    kernels[-3].update({f"{k}_ms": pt["times"][f"K3a {k}"]["card_ms"]
                        for k in ("no_reset", "all_reset")})
    kernels[-3]["card_idle_share"] = pt["idle"]
    kernels[-1].update({"logits_strides": pt["layouts"]["sampler"],
                        "other_layout_ms": pt["times"]["sampler other_layout"]["card_ms"],
                        "other_layout_strides": pt["layouts"]["sampler other_layout"],
                        "trainer_layout_ms": pt["times"]["sampler trainer"]["card_ms"],
                        "trainer_layout_strides": pt["layouts"]["sampler trainer"]})
    kernels[-3]["card_idle_share_profiled"] = pt["idle_profiled"]
    kernels[-2]["generic_launches"] = generic["launches_main_path"]["K3b"]
    kernels[-2]["imitation_launches"] = imitation["bc"]["launches_main_path"]["K3b"]
    kernels[-2]["a2c_launches"] = learners["a2c"]["launches_main_path"]["K3b"]
    kernels[-2]["dqn_launches"] = learners["dqn"]["launches_main_path"]["K3b"]
    kernels.append({
        "name": "env_step", "route": "cuda", "source": policy_src,
        "replaces": "balatro_gym_tpu/engine/full_env.py:870",
        "replaces_note": "the engine's step, XLA in the reference: no Pallas kernel",
        "launches": generic["launches_main_path"]["env_step"],
        "imitation_launches": imitation["bc"]["launches_main_path"]["env_step"],
        "a2c_launches": learners["a2c"]["launches_main_path"]["env_step"],
        "dqn_launches": learners["dqn"]["launches_main_path"]["env_step"],
        "max_abs_err": es["max_abs_err"], "ms": es["ms"], "ms_from": "events behind a sleep",
        "plain_ms": es["plain_ms"], "call_ms": es["call_ms"],
        "step_autoreset_call_ms": es["step_autoreset_call_ms"],
        "k3a_same_inputs_ms": es["k3a_same_inputs_ms"], "shape": es["shape"],
        "us_by_class": es["classes"], "us_on_generic_mix": generic["generic_mix"],
        "in_update_us": generic["env_step_in_update_us"],
        "ptxas": es["ptxas"], **es["launch_shape"]})
    rs = es["reset"]
    fresh = rs[f"fresh {RESET_ENVS}"]
    kernels.append({
        "name": "env_reset", "route": "cuda", "source": policy_src,
        "replaces": "balatro_gym_tpu/engine/full_env.py:163",
        "replaces_note": "the engine's reset, XLA in the reference (step_autoreset's at "
                         "balatro_gym_tpu/engine/full_env.py:905): no Pallas kernel",
        "launches": generic["launches_main_path"]["env_reset"],
        "imitation_launches": imitation["bc"]["launches_main_path"]["env_reset"],
        "a2c_launches": learners["a2c"]["launches_main_path"]["env_reset"],
        "dp_launches_by_rank": [r["full"]["reset_launches"] for r in dp["rollouts"]],
        "dqn_launches": learners["dqn"]["launches_main_path"]["env_reset"],
        "max_abs_err": es["reset_max_abs_err"], "ms": rs["autoreset"]["ms"],
        "ms_from": "events behind a sleep",
        "plain_ms": rs["autoreset"]["plain_ms"], "call_ms": rs["autoreset"]["call_ms"],
        "shape": [STEP_ENVS], "masked": rs["autoreset"]["masked"],
        "modes": {what: {k: v for k, v in r.items() if k != "work"}
                  for what, r in rs.items() if what != "shape"},
        "fresh_ms": fresh["ms"], "fresh_plain_ms": fresh["plain_ms"],
        "fresh_shape": [RESET_ENVS], "fresh_reset_call_ms": fresh["call_ms"],
        "fresh_bound_ms": bound(*fresh["work"], alu["rate"])[0], **rs["shape"]})
    kernels.append({
        "name": "hand_histograms", "route": "cuda", "source": src + "hand_histograms.cu",
        "replaces": "balatro_gym_tpu/ops/pallas_kernels.py:44", "launches": hist["launches"],
        "max_abs_err": hist["max_abs_err"], "ms": hist["ms"], "plain_ms": hist["plain_ms"],
        "shape": [HIST_ENVS, 8], "launch_shape": hist["shape"]})
    kernels.append({
        "name": "alu_chains", "route": "cuda", "source": src + "alu_ceiling.cu",
        "replaces": "scripts/vpu_ceiling.py:28", "launches": alu["launches"],
        "max_abs_err": alu["max_abs_err"], "ms": alu["ms"], "plain_ms": alu["plain_ms"],
        "ms_reference_shape": alu["ms_reference_shape"],
        "shape": [AC.SATURATING_TILES, 8, 8, 128], "rounds": AC.ROUNDS,
        "int32_ops_per_s": alu["rate"], "int32_ops_per_s_reference_shape":
            alu["rate_reference_shape"], "sass_loop": alu["sass"]})
    # The measured INT32 rate is above the data sheet's (K6 beats the data
    # sheet's bound), so the bound of record divides integer source ops by
    # the measured one; K6's own bound is its SASS over the issue limit, so
    # that it does not rest on its own run.
    lines = []
    for k in kernels:
        sheet, measured = bound(*work[k["name"]]), bound(*work[k["name"]], alu["rate"])
        k.update(bound_ms=measured[0], bound_by=measured[1],
                 bound_unit="int32 source ops over K6's measured source-op rate",
                 bound_ms_datasheet_int32=sheet[0], bound_by_datasheet_int32=sheet[1],
                 bound_ms_measured_int32=measured[0], library_ms=None, gpu=smi)
        lines.append(f"{k['name']} {sheet[0] * 1e3:.2f} us ({sheet[1]}) / {measured[0] * 1e3:.2f}"
                     f" us ({measured[1]})")
    issue = bound(alu["work"][0], alu["sass_ops"], ISSUE_PER_S)
    kernels[-1].update(bound_ms=issue[0], bound_by=issue[1],
                       bound_unit="SASS of the loop over the issue limit")
    log("14 alu ceiling", f"bounds under the data sheet's {INT32_OPS_PER_S:.4g} / the measured "
        f"{alu['rate']:.4g} int32 ops/s (bytes at {HBM_BYTES_PER_S:.3g} B/s; the JSON's "
        f"bound_ms is the second): " + "; ".join(lines) + f"; alu_chains' bound of record: "
        f"{alu['sass_ops']:.4g} SASS over the issue limit {ISSUE_PER_S:.4g} a second = "
        f"{issue[0] * 1e3:.2f} us ({issue[1]}), {issue[0] / alu['ms']:.3f} of its time")
    trainer = {"config": TRAIN, "updates": TRAIN_UPDATES,
               "launches_main_path": train_launches, "metrics_by_update": train_hist,
               "parity_params_max_abs_diff": parity["params"],
               "parity_metrics_max_rel_diff": parity["metrics_rel"], **tt, "gpu": smi}
    print(json.dumps({"trainer": trainer}), flush=True)
    print(json.dumps({"generic_trainer": generic, "evaluate": ev, "gym": gym,
                      "imitation": imitation, "other_learners": learners}), flush=True)
    print(json.dumps({"data_parallel": dp}), flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
