"""Sampled whole rollouts of the flagship env (K2), call after call.

Each call is the user's call, ``rollout_full_fused(seed_i, n_envs,
n_steps)``: the default reset of ``n_envs`` fresh games from ``seed_i``,
then ``n_steps`` steps of uniformly sampled legal actions, the final state
unpacked. Call ``i`` of a run takes the seed ``(seed + i) mod 2**32``. A
closed loop (``harness/timing.closed_loop``) of calls.

The answers judged are env by env: for the first call of the window, one
drawn from the seed among its first ``sample_calls_within`` calls, and its
last, the final packed state, reward total and episode count of
``sample_envs`` envs drawn from the seed, against the reference's rollout
of the same (seed, env) pairs.

Faults that a run of this driver can have (``benchmark/faults.py``), each
planted in the kernel's entry and in its plain fallback: ``unchanged``, the
call returns its start; ``half_batch``, only the first half of the envs
stepped; ``altered``, +1 on every 64th env's reward total.
"""
from __future__ import annotations

import random

import torch

from benchmark import faults as FL
from benchmark.harness import compare as CMP
from benchmark.harness import timing

_M32 = 0xFFFFFFFF
WARM_CALLS = 2
# The tiny size of the CPU tests, merged into the traffic.
TINY = {"rollout": {"n_envs": 64, "n_steps": 8}, "sample_envs": 3 * 64,
        "sample_calls_within": 2, "traced_steps": 2}


def _sizes(spec):
    return {**spec["config"]["rollout"], **spec["traffic"].get("rollout", {})}


def _call(run, i):
    from balatro_gym_tpu_torch.ops import fused_full_rollout as FF
    sz = run["sizes"]
    return FF.rollout_full_fused((run["seed"] + i) & _M32, sz["n_envs"], sz["n_steps"],
                                 device=run["dev"])


def setup(spec, seed: int, dev, trace: bool = False) -> dict:
    run = {"spec": spec, "seed": seed, "dev": dev, "sizes": _sizes(spec), "next": 0,
           "kept": {}}
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
    return {"n_envs": run["sizes"]["n_envs"]}


def release(run) -> None:
    """Keep the sampled envs' answers and free every call's results."""
    from benchmark.reference import full_step as RF
    kept, run["kept"] = run["kept"], {}
    rng = random.Random(run["seed"] ^ 0x5EED)
    n_envs, per = run["sizes"]["n_envs"], run["spec"]["traffic"]["sample_envs"] // len(kept)
    seeds, envs, rows, tot, epi = [], [], [], [], []
    for i, out in sorted(kept.items()):
        idx = torch.tensor(sorted(rng.sample(range(n_envs), min(per, n_envs))),
                           device=run["dev"])
        packed = RF.pack_full_state(out["state"])
        rows.append({k: v[..., idx] for k, v in packed.items()})
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
    from benchmark.reference import rollout as RR
    s = run["sample"]
    return RR.sampled_rollout(s["seeds"], s["envs"], run["sizes"]["n_steps"], reward_dtype)


CONTROL = {"reward_dtype": torch.bfloat16}


def numbers(prog: dict, ref: dict) -> dict:
    return CMP.answer_numbers(prog, ref)


FAULTS = ("unchanged", "half_batch", "altered")


def patches(fault: str) -> list:
    """``(module, attribute, wrap)`` for each function of the port that
    ``fault`` replaces by ``wrap(original)``."""
    from balatro_gym_tpu_torch.ops import fused_full_rollout as FF
    if fault == "unchanged":
        def wrap(f):
            def run(packed, actions, seed, n_steps):
                n = packed["ints"].shape[1]
                dev = packed["ints"].device
                return ({k: v.clone() for k, v in packed.items()}, torch.zeros(n, device=dev),
                        torch.zeros(n, dtype=torch.int32, device=dev))
            return run
    elif fault == "half_batch":
        def wrap(f):
            def run(packed, actions, seed, n_steps):
                n = packed["ints"].shape[1] // 2
                done, tot, epi = f({k: v[..., :n].contiguous() for k, v in packed.items()},
                                   actions, seed, n_steps)
                rows = {k: torch.cat([done[k], v[..., n:]], -1) for k, v in packed.items()}
                pad = packed["ints"].shape[1] - n
                return (rows, torch.cat([tot, tot.new_zeros(pad)]),
                        torch.cat([epi, epi.new_zeros(pad)]))
            return run
    elif fault == "altered":
        def wrap(f):
            def run(*a):
                rows, tot, epi = f(*a)
                return rows, FL.bump(tot), epi
            return run
    else:
        raise ValueError(f"no fault {fault!r} for this driver")
    return [(FF, "_kernel_packed", wrap), (FF, "_reference_packed", wrap)]
