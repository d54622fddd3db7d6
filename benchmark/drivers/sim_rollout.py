"""Sampled whole rollouts of the single-blind sim engine (K4), call after
call.

Each call is the user's call, ``rollout_fused(seed_i, n_envs, n_steps,
jokers)``: ``n_envs`` fresh episodes, every env holding the configuration's
five jokers, stepped ``n_steps`` times by uniformly sampled legal actions
with autoreset; the joker coefficients are reduced anew in every call, as a
user's call reduces them. Call ``i`` of a run takes the seed ``(seed + i)
mod 2**32``. A closed loop (``harness/timing.closed_loop``) of calls.

The answers judged are env by env: for the first call of the window, one
drawn from the seed among its first ``sample_calls_within`` calls, and its
last, the final hand, counters, episode count and reward total of
``sample_envs`` envs drawn from the seed, against the reference's rollout
of the same (seed, env) pairs (``reference/sim_rollout.py``).

Faults that a run of this driver can have (``benchmark/faults.py``), each
planted in the kernel's entry and in its plain fallback: ``unchanged``, the
call returns a fresh episode and no reward; ``half_batch``, only the first
half of the envs stepped; ``altered``, +1 on every 64th env's reward total.
"""
from __future__ import annotations

import random

import torch

from benchmark import faults as FL
from benchmark.harness import compare as CMP
from benchmark.harness import timing

_M32 = 0xFFFFFFFF
WARM_CALLS = 2
COUNTERS = ("deck_n", "money", "hands_left", "discards_left", "score")
# The tiny size of the CPU tests, merged into the traffic.
TINY = {"rollout": {"n_envs": 64, "n_steps": 8}, "sample_envs": 3 * 64,
        "sample_calls_within": 2, "traced_steps": 2}


def _sizes(spec):
    return {**spec["config"]["rollout"], **spec["traffic"].get("rollout", {})}


def _call(run, i):
    from balatro_gym_tpu_torch.ops import fused_rollout as FR
    sz = run["sizes"]
    return FR.rollout_fused((run["seed"] + i) & _M32, sz["n_envs"], sz["n_steps"],
                            run["jokers"], device=run["dev"])


def setup(spec, seed: int, dev, trace: bool = False) -> dict:
    run = {"spec": spec, "seed": seed, "dev": dev, "sizes": _sizes(spec), "next": 0,
           "jokers": tuple(spec["config"]["jokers"]), "kept": {}}
    for _ in range(WARM_CALLS):
        _call(run, run["next"])
        run["next"] += 1
    return run


def window(run, seconds: float) -> dict:
    sz, tr = run["sizes"], run["spec"]["traffic"]
    first = run["next"]
    drawn = first + random.Random(run["seed"]).randrange(tr["sample_calls_within"])

    def step():
        i = run["next"]
        out = _call(run, i)
        if i in (first, drawn):
            run["kept"][i] = out
        run["last"] = out
        run["next"] += 1

    loop = timing.closed_loop(step, seconds, run["dev"])
    run["kept"][run["next"] - 1] = run.pop("last")
    return {"rollout_env_steps_per_s": loop["n"] * sz["n_envs"] * sz["n_steps"] / loop["wall"],
            "attempted": loop["n"], "spread": timing.spread(loop, "calls")}


def traced(run, n: int) -> dict:
    """``n`` calls; the last is kept for the check."""
    for _ in range(n):
        out = _call(run, run["next"])
        run["next"] += 1
    run["kept"] = {run["next"] - 1: out}
    return {"n_envs": run["sizes"]["n_envs"], "n_steps": run["sizes"]["n_steps"]}


def release(run) -> None:
    """Keep the sampled envs' answers and free every call's results."""
    kept, run["kept"] = run["kept"], {}
    rng = random.Random(run["seed"] ^ 0x5EED)
    n_envs, per = run["sizes"]["n_envs"], run["spec"]["traffic"]["sample_envs"] // len(kept)
    seeds, envs, rows, tot, epi = [], [], [], [], []
    for i, out in sorted(kept.items()):
        idx = torch.tensor(sorted(rng.sample(range(n_envs), min(per, n_envs))),
                           device=run["dev"])
        rows.append({"rank": out["hand_rank"][idx].T, "suit": out["hand_suit"][idx].T,
                     "counters": torch.stack([out[k][idx] for k in COUNTERS])})
        tot.append(out["total_reward"][idx])
        epi.append(out["episodes"][idx])
        seeds.append(torch.full_like(idx, (run["seed"] + i) & _M32))
        envs.append(idx)
    run["sample"] = {"seeds": torch.cat(seeds), "envs": torch.cat(envs)}
    run["record"] = {"rows": {k: torch.cat([r[k] for r in rows], -1) for k in rows[0]},
                     "total_reward": torch.cat(tot), "episodes": torch.cat(epi)}


def reference_record(run, reward_dtype=torch.float32) -> dict:
    """The reference's answers for the sampled envs (``reward_dtype=
    torch.bfloat16``: the control)."""
    from benchmark.reference import sim_rollout as RS
    s = run["sample"]
    jokers = torch.tensor(run["jokers"], device=s["envs"].device)
    return RS.sampled_rollout(s["seeds"], s["envs"], run["sizes"]["n_steps"], jokers,
                              reward_dtype=reward_dtype)


CONTROL = {"reward_dtype": torch.bfloat16}


def numbers(prog: dict, ref: dict) -> dict:
    return CMP.answer_numbers(prog, ref)


FAULTS = ("unchanged", "half_batch", "altered")


def _fresh(coef):
    """The kernel's outputs for envs that took no step: a fresh episode's
    hand and counters, no reward (``coef``: the call's coefficient rows)."""
    from balatro_gym_tpu_torch.ops import fused_rollout as FR
    scal = coef[0]
    n, dev = scal.shape[1], scal.device
    ranks = torch.tensor(FR._RESET_RANKS, device=dev)[:, None].repeat(1, n)
    suits = torch.full((FR.N_CARDS, n), FR._RESET_SUIT, dtype=torch.int32, device=dev)
    stats = torch.zeros(8, n, dtype=torch.int32, device=dev)
    stats[0], stats[1], stats[2], stats[3] = FR._RESET_DECK_N, scal[FR.S_MONEY0].int(), 4, 3
    return ranks, suits, stats, torch.zeros(n, device=dev)


def patches(fault: str) -> list:
    """``(module, attribute, wrap)`` for each function of the port that
    ``fault`` replaces by ``wrap(original)``."""
    from balatro_gym_tpu_torch.ops import fused_rollout as FR
    if fault == "unchanged":
        def wrap(f):
            def run(coef, seed, actions, n_steps):
                return _fresh(coef)
            return run
    elif fault == "half_batch":
        def wrap(f):
            def run(coef, seed, actions, n_steps):
                n = coef[0].shape[1] // 2
                half = f(tuple(c[:, :n].contiguous() for c in coef), seed,
                         None if actions is None else actions[:, :n].contiguous(), n_steps)
                rest = _fresh(tuple(c[:, n:] for c in coef))
                return tuple(torch.cat([a, b], -1) for a, b in zip(half, rest))
            return run
    elif fault == "altered":
        def wrap(f):
            def run(*a):
                ranks, suits, stats, reward = f(*a)
                return ranks, suits, stats, FL.bump(reward)
            return run
    else:
        raise ValueError(f"no fault {fault!r} for this driver")
    return [(FR, "_kernel_rows", wrap), (FR, "_reference_rows", wrap)]
