"""PPO updates of the port's learner on the flagship env, back to back.

A closed loop (``harness/timing.closed_loop``) of updates. The
configuration's ``ppo`` recipe, with the traffic's ``ppo`` overrides, is
the port's ``PPOConfig`` over ``full_env_hooks()`` (or the hooks a driver
built on this one passes to :func:`setup`).

Set-up builds one learner from the seed (``make_ppo(hooks, cfg)``, its
weights replaced by the benchmark's), drives it through
:data:`SETUP_UPDATES` updates and keeps what the reference is held against:
each of the first :data:`CHECK_UPDATES` updates' loss, Adam's first moment
after the first, and the parameters before the first and after the last of
them. The same learner then runs the window.

Faults that a run of this driver can have (``benchmark/faults.py``):
``unchanged``, the optimizer step returns its state; ``half_batch``, the
loss over the first half of each minibatch; ``altered``, +1 on every 64th
env's reward where the env step (fused or the engine's) produces it.
"""
from __future__ import annotations

import dataclasses
import time

import torch

from benchmark import faults as FL
from benchmark.harness import compare as CMP
from benchmark.harness import timing
from benchmark.harness import yardstick as Y

_M32 = 0xFFFFFFFF
STAGES = ("collection", "stats", "last value + GAE", "shuffle + SGD")
SETUP_UPDATES = 3       # set-up's updates: the compared ones, then warm-up
CHECK_UPDATES = 2       # the updates the reference follows
# The tiny size of the CPU tests, merged into the traffic.
TINY = {"ppo": {"n_envs": 16, "rollout_len": 4}, "traced_steps": 2}


def recipe(spec) -> dict:
    return {**spec["config"]["ppo"], **spec["traffic"].get("ppo", {})}


def seed_key(seed: int) -> list:
    """The learner's Threefry key: the seed's two 32-bit words."""
    return [(seed >> 32) & _M32, seed & _M32]


def make_weights(spec, seed: int, dev) -> list:
    """The policy's parameters from the seed, on ``dev``, in one draw: a
    normal weight scaled by ``gain / sqrt(fan_in)`` (the torso's gain
    sqrt(2), the logits head's 0.01, the value head's 1), zero biases;
    ``[bias, weight]`` a layer, torso first, then logits, then value."""
    cfg = spec["config"]
    layers = Y.dense_widths(cfg["obs_dim"], cfg["ppo"]["hidden"], cfg["n_actions"])
    gains = [2 ** 0.5] * (len(layers) - 2) + [0.01, 1.0]
    g = torch.Generator(device=dev).manual_seed(seed)
    flat = torch.randn(sum(i * o for i, o in layers), generator=g, device=dev)
    out, at = [], 0
    for (i, o), gain in zip(layers, gains):
        out += [torch.zeros(o, device=dev), flat[at:at + i * o].view(o, i) * (gain / i ** 0.5)]
        at += i * o
    return out


def _hooks(hooks, trace, counters):
    if not trace:
        return hooks
    inner = hooks.step_autoreset

    def step_autoreset(state, action):
        t0 = time.perf_counter()
        out = inner(state, action)
        counters["step_autoreset_host_s"] += time.perf_counter() - t0
        counters["step_autoreset_calls"] += 1
        return out
    return hooks._replace(step_autoreset=step_autoreset)


def setup(spec, seed: int, dev, trace: bool = False, hooks=None) -> dict:
    """The learner after set-up; ``hooks`` defaults to ``full_env_hooks()``."""
    from balatro_gym_tpu_torch.train import ppo as TP
    cfg = recipe(spec)
    fields = {f.name for f in dataclasses.fields(TP.PPOConfig)}
    pcfg = TP.PPOConfig(**{k: (tuple(v) if k == "hidden" else v)
                           for k, v in cfg.items() if k in fields})
    counters = {"step_autoreset_host_s": 0.0, "step_autoreset_calls": 0}
    hooks = TP.full_env_hooks() if hooks is None else hooks
    init_fn, update_fn, _ = TP.make_ppo(_hooks(hooks, trace, counters), pcfg, device=dev)
    weights = make_weights(spec, seed, dev)
    ts = init_fn(seed_key(seed))
    with torch.no_grad():
        for p, w in zip(TP.param_list(ts.params), weights):
            p.copy_(w)
    rec = {"start": [p.detach().clone() for p in TP.param_list(ts.params)], "losses": []}
    for i in range(SETUP_UPDATES):
        ts, m = update_fn(ts)
        if i < CHECK_UPDATES:
            rec["losses"].append(m["loss"])
        if i == 0:
            rec["grad"] = [mu.clone() for mu in ts.opt_state.mu]
        if i == CHECK_UPDATES - 1:
            rec["end"] = [p.detach().clone() for p in TP.param_list(ts.params)]
    return {"spec": spec, "seed": seed, "dev": dev, "cfg": cfg, "ts": ts,
            "update_fn": update_fn, "record": rec, "counters": counters,
            "weights": weights}


def window(run, seconds: float) -> dict:
    cfg = run["cfg"]

    def step():
        run["ts"], _ = run["update_fn"](run["ts"])

    loop = timing.closed_loop(step, seconds, run["dev"])
    return {"train_env_steps_per_s": loop["n"] * cfg["n_envs"] * cfg["rollout_len"] / loop["wall"],
            "update_ms_p95": loop["q"][3], "attempted": loop["n"],
            "spread": timing.spread(loop, "updates")}


def traced(run, n: int) -> dict:
    """``n`` updates with the learner's stage events; returns the readers'
    context (the events are read once the harness has synchronised)."""
    update_fn, ts, cfg, spec = run["update_fn"], run["ts"], run["cfg"], run["spec"]
    counters = run["counters"]
    counters.update(step_autoreset_host_s=0.0, step_autoreset_calls=0)
    marks = []
    for _ in range(n):
        rec = {}
        ts, _ = update_fn(ts, record=rec)
        marks.append(rec["events"])
    run["ts"] = ts
    conf = spec["config"]

    def spans():
        out = {s: [] for s in STAGES}
        for evs in marks:
            for (_, a), (stage, b) in zip(evs, evs[1:]):
                out[stage].append(a.elapsed_time(b))
        return out

    return {"n_envs": cfg["n_envs"], "spans": spans, "counters": dict(counters),
            "flops": n * Y.ppo_update_flops(conf["obs_dim"], cfg["hidden"], conf["n_actions"],
                                            cfg["n_envs"], cfg["rollout_len"], cfg["epochs"])}


def release(run) -> None:
    rec = run["record"]
    rec["losses"] = [float(x) for x in rec["losses"]]
    for k in ("ts", "update_fn"):
        run.pop(k, None)


def reference_record(run, quant=None) -> dict:
    """The reference's record from the same inputs (``quant="fp8"``: the
    control)."""
    from benchmark.reference import ppo as RP
    cfg, dev = run["cfg"], run["dev"]
    st = RP.init_state(seed_key(run["seed"]), run["weights"], cfg, dev)
    rec = {"start": [p.detach().clone() for p in st["params"]], "losses": []}
    for i in range(CHECK_UPDATES):
        st, loss = RP.update(st, cfg, quant)
        rec["losses"].append(float(loss))
        if i == 0:
            rec["grad"] = [m.clone() for m in st["opt"]["mu"]]
    rec["end"] = [p.detach().clone() for p in st["params"]]
    return rec


CONTROL = {"quant": "fp8"}


def numbers(prog: dict, ref: dict) -> dict:
    return CMP.training_numbers(prog, ref)


FAULTS = ("unchanged", "half_batch", "altered")


def patches(fault: str) -> list:
    """``(module, attribute, wrap)`` for each function of the port that
    ``fault`` replaces by ``wrap(original)``."""
    from balatro_gym_tpu_torch.engine import full_env as FE
    from balatro_gym_tpu_torch.ops import fused_policy_rollout as FP
    from balatro_gym_tpu_torch.train import ppo as TP
    if fault == "unchanged":
        return [(TP, "adam_update", lambda f: lambda params, grads, st, *a, **k: st)]
    if fault == "half_batch":
        def half(f):
            def loss(net, batch, *a, **k):
                t, adv, ret = batch
                n = adv.shape[0] // 2
                return f(net, (type(t)(*(x[:n] for x in t)), adv[:n], ret[:n]), *a, **k)
            return loss
        return [(TP, "ppo_loss", half)]

    if fault != "altered":
        raise ValueError(f"no fault {fault!r} for this driver")

    def fused(f):
        def step(packed, actions, **k):
            out = f(packed, actions, **k)
            return (out[0], FL.bump(out[1]), *out[2:])
        step.launches = f.launches          # the kernel's wrapper counts on itself
        return step

    def generic(f):
        def step(state, actions):
            st, reward, done = f(state, actions)
            return st, FL.bump(reward), done
        return step
    return [(FP, "step_fused", fused), (FE, "step_autoreset", generic)]
