"""The policy-collection kernels of several builds of
``csrc/fused_policy_rollout.cu``, compared on the card in alternating order.

    python -m balatro_gym_tpu_torch.ops.policy_kernels_ab tree=balatro_gym_tpu_torch/csrc \\
        parent=build/parent/balatro_gym_tpu_torch/csrc [--kernels observe,sample,step,reset] \\
        [--envs 8192] [--rounds 10] [--calls 10]

Each ``LABEL=DIR`` names a directory holding a ``fused_policy_rollout.cu``
and the headers it includes: ``csrc/`` of this tree, of another commit
(``git archive``) or of a variant of it. Each is built with nvcc and the
flags of ``ops/cuda_build.py`` into ``build/policy_ab/<label>/``; its
ptxas lines are kept. The inputs are made on the card from fixed seeds: a
mid-game state (the default reset after 16 sampled steps of the
whole-rollout kernel) of ``--envs`` envs; for the sampler, the logits of a
seeded ``ActorCritic(256, 256)`` on that state's observation in the
column-major layout the policy's matmul leaves on the card (``policy``), in
a row-major copy (``row_major``), and those of the same policy in bf16 on
the normalised observation, as the PPO trainer with ``bf16_compute`` calls
it (``trainer``); for K3a, the state with actions drawn from the policy
(``mid``) and the no-autoreset and all-autoreset batches of
``ops/fused_full_battery.reset_batches``; for the engine's reset
(``env_reset_kernel``, in builds that have it), the mid-game state with
one env in 63 masked (``autoreset``: each env's own key, about the share of
envs that end in a step of the generic rollout) and zeroed rows with every
env masked and keys given (``fresh``), each reset in place on a copy.

Every build's outputs are first held against the plain versions: K3b bit
for bit but the ``log1p`` row (1 ulp), the sampler's actions bit for bit
and log-probs within 1e-6, K3a bit for bit but that row, the reset bit
for bit; at ``--envs`` and at 257 envs for K3b, the sampler and the reset
(a partial block). Then, for
``--rounds`` rounds, each (kernel, input, build) launches ``--calls`` times
back to back, the builds in turn and in reverse order every other round,
timed by CUDA events after the card has slept long enough for the host to
queue them all (so the host's launch cost is not counted); a round's sample
is their time divided by ``--calls``. Prints one JSON line: the card, each
build's ptxas lines, for each (kernel, input) every build's median and
interquartile range in us, with its samples, and for each K3a input its mix
(``step_mix``): the share of its envs in each branch group and the share
that reset, the divergence and the resetting that its times carry.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import statistics
import subprocess
from pathlib import Path

import torch

from balatro_gym_tpu_torch.ops import cuda_build
from balatro_gym_tpu_torch.ops import fused_full_battery as BAT
from balatro_gym_tpu_torch.ops import fused_full_rollout as FF
from balatro_gym_tpu_torch.ops import fused_policy_rollout as FP
from balatro_gym_tpu_torch.ops import kernel_rng as KR
from balatro_gym_tpu_torch.ops.alu_ceiling import card_name
from balatro_gym_tpu_torch.train.networks import ActorCritic
from balatro_gym_tpu_torch.train.normalize import init_stats, normalize

_P, _INT, _I64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
LOG1P_ROW = FP.OBS_DIM - 6


def build(builds: dict) -> dict:
    """label -> (library, ptxas lines): every build compiled at once."""
    procs = {}
    for label, csrc in builds.items():
        work = cuda_build.BUILD_DIR.parent / "policy_ab" / label
        work.mkdir(parents=True, exist_ok=True)
        lib = work / "libpolicy.so"
        procs[label] = (lib, subprocess.Popen(
            [cuda_build.nvcc_path(), *cuda_build.ARCH_FLAGS, *cuda_build.NVCC_FLAGS,
             "-o", str(lib), str(Path(csrc) / "fused_policy_rollout.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    out = {}
    for label, (lib, proc) in procs.items():
        _, err = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {builds[label]}:\n{err}")
        so = ctypes.CDLL(str(lib))
        so.policy_observe_launch.argtypes = [_P] * 5 + [_INT, _P]
        so.policy_step_launch.argtypes = [_P] * 12 + [_INT, _P]
        so.policy_sample_key_launch.argtypes = [_P, _I64, _I64, _INT, _P, _P, _P, _P]
        if hasattr(so, "env_reset_launch"):
            so.env_reset_launch.argtypes = [_P] * 5 + [_INT, _P]
        out[label] = (so, [ln.replace("ptxas info    :", "").strip() for ln in err.splitlines()
                           if any(w in ln for w in ("Compiling entry", "registers", "spill"))])
    return out


def inputs(n: int, dev) -> dict:
    """The inputs of the module docstring, at ``n`` envs."""
    st = FF.rollout_full_fused(0, n, 16, device=dev)["state"]
    packed = {k: v.contiguous() for k, v in FF.pack_full_state(st).items()}
    obs, mask = FP.observe_rows_reference(packed)
    net = ActorCritic(FP.N_ACTIONS, FP.OBS_DIM, (256, 256),
                      generator=torch.Generator().manual_seed(0)).to(dev)
    bf16 = ActorCritic(FP.N_ACTIONS, FP.OBS_DIM, (256, 256), compute_dtype=torch.bfloat16,
                       generator=torch.Generator().manual_seed(0)).to(dev)
    with torch.no_grad():
        logits = net(obs, mask)[0].T.contiguous().T
        trainer = bf16(normalize(init_stats(FP.OBS_DIM, dev), obs), mask)[0]
    key = FP.seed_key_rows(1, 1, dev)[0]
    no_reset, all_reset = BAT.reset_batches(packed)
    env = torch.arange(n, device=dev)
    keys = torch.stack(KR.split_child(*KR.seed_key(9, device=dev), env), -1)
    zeros = {k: torch.zeros_like(v) for k, v in packed.items()}
    return {"packed": packed, "key": key,
            "logits": {"policy": logits, "row_major": logits.contiguous(), "trainer": trainer},
            "step": {"mid": (packed, FP.sample(key, logits)[0]), "no_reset": no_reset,
                     "all_reset": all_reset},
            "reset": {"autoreset": (packed, env % 63 == 5, None),
                      "fresh": (zeros, env >= 0, keys)}}


# The step's branch groups (csrc/full_step.cuh branch_group): play; the
# other classes that generate a shop (reroll, skip); the consumables; the rest.
GROUPS = ("play", "shop_gen", "consumable", "rest")


def step_mix(packed, actions) -> dict:
    """A K3a input's shares of envs: in each of ``GROUPS`` by the class its
    step takes, and ending (so reset) in its step, by the plain step."""
    cls = BAT.branch_classes(packed, actions)
    c = {name: BAT.BRANCH_CLASSES.index(name) for name in ("play", "skip", "consumable")}
    group = torch.where(cls == c["play"], 0, torch.where(
        cls <= c["skip"], 1, torch.where(cls == c["consumable"], 2, 3)))
    shares = torch.bincount(group, minlength=len(GROUPS)).double() / len(cls)
    out = dict(zip(GROUPS, shares.tolist()))
    out["reset"] = float(FP.step_rows_reference(packed, actions)[2].double().mean())
    return out


def launchers(so, inp, dev) -> dict:
    """(kernel, input) -> (launch once, its outputs, the plain version's)."""
    stream = torch.cuda.current_stream(dev).cuda_stream
    packed = inp["packed"]
    n = packed["ints"].shape[1]
    ptrs = [packed[k].data_ptr() for k in ("cards", "ints", "rng")]
    out = {}
    obs = torch.empty(FP.OBS_DIM, n, device=dev)
    mask = torch.empty(FP.N_ACTIONS, n, dtype=torch.bool, device=dev)
    out["observe", "mid"] = (
        lambda: so.policy_observe_launch(*ptrs, obs.data_ptr(), mask.data_ptr(), n, stream),
        lambda: (obs.T, mask.T), lambda: FP.observe_rows_reference(packed))
    for name, logits in inp["logits"].items():
        action = torch.empty(n, dtype=torch.int32, device=dev)
        lp = torch.empty(n, device=dev)
        out["sample", name] = (
            lambda lg=logits, a=action, p=lp: so.policy_sample_key_launch(
                lg.data_ptr(), *lg.stride(), n, inp["key"].data_ptr(), a.data_ptr(),
                p.data_ptr(), stream),
            lambda a=action, p=lp: (a, p), lambda lg=logits: FP.sample(inp["key"], lg))
    ft = FF.float_tables(dev)
    for name, (p, a) in inp["step"].items():
        res = ({k: torch.empty_like(v) for k, v in p.items()}, torch.empty(n, device=dev),
               torch.empty(n, dtype=torch.bool, device=dev), torch.empty(FP.OBS_DIM, n, device=dev),
               torch.empty(FP.N_ACTIONS, n, dtype=torch.bool, device=dev))
        out["step", name] = (
            lambda p=p, a=a, r=res: so.policy_step_launch(
                *(p[k].data_ptr() for k in ("cards", "ints", "rng")), a.data_ptr(),
                ft.data_ptr(), *(r[0][k].data_ptr() for k in ("cards", "ints", "rng")),
                *(t.data_ptr() for t in r[1:]), n, stream),
            lambda r=res: (r[0], r[1], r[2], r[3].T, r[4].T),
            lambda p=p, a=a: FP.step_rows_reference(p, a))
    if not hasattr(so, "env_reset_launch"):
        return out
    for name, (p, m, keys) in inp["reset"].items():
        rows = {k: v.clone() for k, v in p.items()}
        words = None if keys is None else FF._w2i(keys).contiguous()
        out["reset", name] = (
            lambda r=rows, m=m, w=words: so.env_reset_launch(
                *(r[k].data_ptr() for k in ("cards", "ints", "rng")), m.data_ptr(),
                w.data_ptr() if w is not None else None, n, stream),
            lambda r=rows: r, lambda p=p, m=m, keys=keys: FP.env_reset_rows_reference(p, m, keys))
    return out


def _obs_equal(got, want):
    other = torch.arange(FP.OBS_DIM, device=got.device) != LOG1P_ROW
    ulp = (got[:, LOG1P_ROW].view(torch.int32) - want[:, LOG1P_ROW].view(torch.int32)).abs()
    return bool(torch.equal(got[:, other], want[:, other]) and int(ulp.max()) <= 1)


def agrees(kernel, got, want) -> bool:
    """A kernel's outputs against its plain version's, by the contract of
    the module docstring."""
    if kernel == "observe":
        return _obs_equal(got[0], want[0]) and bool(torch.equal(got[1], want[1]))
    if kernel == "sample":
        return bool(torch.equal(got[0], want[0])) and float(
            (got[1] - want[1]).abs().max()) <= 1e-6
    if kernel == "reset":
        return all(torch.equal(got[k], want[k]) for k in ("cards", "ints", "rng"))
    return (all(torch.equal(got[0][k], want[0][k]) for k in ("cards", "ints", "rng"))
            and all(torch.equal(g, w) for g, w in zip(got[1:3], want[1:3]))
            and bool(torch.equal(got[4], want[4])) and _obs_equal(got[3], want[3]))


def check(libs, kernels, n, dev) -> dict:
    """(label, kernel, input, envs) -> equal to the plain version."""
    out = {}
    for envs in (n, 257):
        inp = inputs(envs, dev)
        for label, (so, _) in libs.items():
            for (kernel, name), (launch, result, plain) in launchers(so, inp, dev).items():
                if kernel not in kernels or (envs != n and kernel == "step"):
                    continue
                assert launch() == 0, f"{label} {kernel} launch failed"
                torch.cuda.synchronize()
                out[f"{label} {kernel} {name} {envs}"] = agrees(kernel, result(), plain())
    return out


def card_us(launch, calls) -> float:
    """Card time in us a launch of ``calls`` back-to-back launches, between
    two CUDA events. The card first sleeps for about half a millisecond, so
    that the host has queued every launch before the first one starts, and
    the host's time to launch is not counted."""
    e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(1_000_000)
    e0.record()
    for _ in range(calls):
        launch()
    e1.record()
    e1.synchronize()
    return e0.elapsed_time(e1) * 1e3 / calls


def time_rounds(libs, kernels, n, rounds, calls, dev) -> dict:
    """(kernel, input) -> label -> card us a launch, one sample a round."""
    inp = inputs(n, dev)
    jobs = sorted(((kernel, name, label, launch)
                   for label, (so, _) in libs.items()
                   for (kernel, name), (launch, _, _) in launchers(so, inp, dev).items()
                   if kernel in kernels), key=lambda j: (j[0], j[1]))     # builds in turn
    for *_, launch in jobs:                                              # warm-up
        launch()
    torch.cuda.synchronize()
    samples = {}
    for r in range(rounds):
        for kernel, name, label, launch in (jobs[::-1] if r % 2 else jobs):
            us = card_us(launch, calls)
            samples.setdefault(f"{kernel} {name}", {}).setdefault(label, []).append(us)
    return samples


def summary(xs):
    q = statistics.quantiles(xs, n=4) if len(xs) > 1 else [xs[0]] * 3
    return {"median_us": statistics.median(xs), "iqr_us": q[2] - q[0], "samples_us": xs}


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("builds", nargs="+", help="LABEL=DIR of a fused_policy_rollout.cu")
    p.add_argument("--kernels", default="observe,sample,step")
    p.add_argument("--envs", type=int, default=8192)
    p.add_argument("--rounds", type=int, default=10)
    p.add_argument("--calls", type=int, default=10)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("policy_kernels_ab: torch sees no CUDA card")
    dev = torch.device("cuda", torch.cuda.current_device())
    builds = dict(b.split("=", 1) for b in args.builds)
    kernels = args.kernels.split(",")
    libs = build(builds)
    equal = check(libs, kernels, args.envs, dev)
    times = time_rounds(libs, kernels, args.envs, args.rounds, args.calls, dev)
    mix = ({f"step {name}": step_mix(p, a)
            for name, (p, a) in inputs(args.envs, dev)["step"].items()}
           if "step" in kernels else {})
    out = {"gpu": card_name(), "device": torch.cuda.get_device_name(0), "envs": args.envs,
           "rounds": args.rounds, "calls": args.calls, "builds": builds,
           "ptxas": {label: lines for label, (_, lines) in libs.items()},
           "equal_to_plain": equal, "all_equal": all(equal.values()),
           "us": {k: {label: summary(xs) for label, xs in v.items()} for k, v in times.items()},
           "mix": mix}
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":  # pragma: no cover
    main()
