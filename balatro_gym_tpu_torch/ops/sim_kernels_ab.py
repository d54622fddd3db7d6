"""The sim rollout kernel (K4) and the hand histograms (K5) of several
builds of ``csrc/``, compared on the card in alternating order.

    python -m balatro_gym_tpu_torch.ops.sim_kernels_ab tree=balatro_gym_tpu_torch/csrc \\
        parent=build/parent/balatro_gym_tpu_torch/csrc [--envs 131072] [--steps 256] \\
        [--hist-envs 1048576] [--rounds 10]

Each ``LABEL=DIR`` names a directory holding ``fused_rollout.cu``,
``hand_histograms.cu`` and the headers they include: ``csrc/`` of this
tree, of another commit (``git archive``) or of a variant of it. Both are
built with nvcc and the flags of ``ops/cuda_build.py`` into
``build/sim_ab/<label>/``; each build's ptxas lines, its launch shapes
(where the build reports them) and the SASS of K4's step loop are kept.
The inputs are made on the card from fixed seeds: the joker coefficient
rows of bench.py's jokers (1, 31, 34, 48, 72) at ``--envs`` envs for K4,
sampled actions (seed 1); ``--hist-envs`` envs of cards with ranks in
[-1, 17], suits in [-1, 9] and a random mask for K5.

Every build's outputs are first held against the plain versions bit for
bit: K4 at ``--envs`` x 32 steps with the bench jokers and at 257 envs x 32
steps with a mixed joker batch (a partial block, Four Fingers, Shortcut,
Misprint and Bloodstone among them), K5 at ``--hist-envs`` envs. Then, for
``--rounds`` rounds, each (kernel, build) launches back to back (K4 once
at ``--envs`` x ``--steps``, K5 20 times), the builds in turn and in
reverse order every other round, timed by CUDA events after the card has
slept long enough for the host to queue the launches; a round's sample is
their time divided by the launch count. ``K4 call`` times 5 back-to-back
``rollout_fused`` calls at the same shape launching the build's K4 (the
joker coefficients made each call, as a user's loop makes them), with no
sleep: the host's work counts. Prints one JSON line: the card,
each build's ptxas lines, shapes and K4 loop SASS, and for each kernel
every build's median and interquartile range in us, with its samples.
"""
from __future__ import annotations

import argparse
import collections
import ctypes
import json
import subprocess
from pathlib import Path

import numpy as np
import torch

from balatro_gym_tpu_torch.ops import cuda_build
from balatro_gym_tpu_torch.ops import fused_rollout as FR
from balatro_gym_tpu_torch.ops import hand_histograms as HH
from balatro_gym_tpu_torch.ops.alu_ceiling import card_name
from balatro_gym_tpu_torch.ops.policy_kernels_ab import card_us, summary

_P, _INT = ctypes.c_void_p, ctypes.c_int
SOURCES = {"K4": ("fused_rollout.cu", "fused_rollout"),
           "K5": ("hand_histograms.cu", "hand_histograms")}
BENCH_JOKERS = (1, 31, 34, 48, 72)
CHECK_STEPS = 32
HIST_CALLS = 20
CALLS = 5
SEED = 1


def mixed_jokers(n):
    """A joker batch of ``n`` envs cycling through sets with Four Fingers,
    Shortcut, Misprint, Bloodstone and the royals, then seeded ids."""
    sets = np.asarray(((0, 0, 0, 0, 0), BENCH_JOKERS, (6, 7, 131, 135, 0),
                       (18, 69, 16, 23, 108), (116, 118, 119, 2, 3),
                       (147, 140, 128, 122, 61), (27, 117, 34, 16, 0)), np.int32)
    rng = np.random.default_rng(0)
    return np.concatenate([sets[np.arange(n // 2) % len(sets)],
                           rng.integers(0, 151, (n - n // 2, 5))]).astype(np.int32)


def hist_inputs(n, dev):
    g = torch.Generator(device=dev).manual_seed(13)
    ranks = torch.randint(-1, 18, (n, 8), generator=g, device=dev, dtype=torch.int32)
    suits = torch.randint(-1, 10, (n, 8), generator=g, device=dev, dtype=torch.int32)
    return ranks, suits, torch.rand(n, 8, generator=g, device=dev) < 0.6


def build(builds: dict) -> dict:
    """label -> {kernel: (library, its path, ptxas lines)}: every build
    compiled at once."""
    procs = {}
    for label, csrc in builds.items():
        work = cuda_build.BUILD_DIR.parent / "sim_ab" / label
        work.mkdir(parents=True, exist_ok=True)
        for kernel, (source, _) in SOURCES.items():
            lib = work / f"lib{Path(source).stem}.so"
            procs[label, kernel] = (lib, subprocess.Popen(
                [cuda_build.nvcc_path(), *cuda_build.ARCH_FLAGS, *cuda_build.NVCC_FLAGS,
                 "-o", str(lib), str(Path(csrc) / source)],
                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    out = {}
    for (label, kernel), (lib, proc) in procs.items():
        _, err = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {builds[label]} {SOURCES[kernel][0]}:\n{err}")
        so = ctypes.CDLL(str(lib))
        name = SOURCES[kernel][1]
        launch = getattr(so, f"{name}_launch")
        launch.argtypes = (FR._C_ARGS if kernel == "K4" else [_P] * 7 + [_INT, _P])
        launch.restype = _INT
        out.setdefault(label, {})[kernel] = (so, lib, [
            ln.replace("ptxas info    :", "").strip() for ln in err.splitlines()
            if any(w in ln for w in ("Compiling entry", "registers", "spill"))])
    return out


def shape(so, kernel):
    """The build's launch shape, where it reports one (``<name>_info``)."""
    try:
        info = getattr(so, f"{SOURCES[kernel][1]}_info")
    except AttributeError:
        return None
    info.argtypes, info.restype = [_P], _INT
    out = (ctypes.c_int * 4)()
    if info(out) != 0:
        raise RuntimeError(f"{kernel} info failed")
    return dict(zip(("block", "shared_bytes", "registers", "stack_bytes"), out))


def k4_launcher(so, coef, n, steps, dev):
    """(launch once, its outputs) of a build's K4, sampled from seed 1."""
    outs = (torch.empty(8, n, dtype=torch.int32, device=dev),
            torch.empty(8, n, dtype=torch.int32, device=dev),
            torch.empty(8, n, dtype=torch.int32, device=dev),
            torch.empty(n, device=dev))
    stream = torch.cuda.current_stream(dev).cuda_stream

    def launch():
        return so.fused_rollout_launch(*(c.data_ptr() for c in coef), None,
                                       *(o.data_ptr() for o in outs), n, steps, 0, 0, SEED,
                                       stream)
    return launch, outs


def k5_launcher(so, inp, dev):
    """(launch once, its outputs) of a build's K5."""
    n = inp[0].shape[0]
    outs = (torch.empty(n, HH.R_PAD, device=dev), torch.empty(n, HH.S_PAD, device=dev),
            torch.empty(n, 1, device=dev))
    table = torch.as_tensor(HH.CHIP_TABLE, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream

    def launch():
        return so.hand_histograms_launch(*(t.data_ptr() for t in inp), table.data_ptr(),
                                         *(o.data_ptr() for o in outs), n, stream)
    return launch, outs


def k4_call(so, envs, steps, dev):
    """One ``rollout_fused`` call as a user makes it (its joker coefficients,
    checks and output allocations), launching this build's K4."""
    def call():
        tree_lib, FR._kernel_lib = FR._kernel_lib, lambda: so
        try:
            FR.rollout_fused(SEED, envs, steps, BENCH_JOKERS, device=dev)
        finally:
            FR._kernel_lib = tree_lib
    return call


def call_us(call, calls) -> float:
    """Time in us a call of ``calls`` back-to-back calls between two CUDA
    events, the host's work included (no card sleep first): a call's time
    as a loop over it sees it."""
    torch.cuda.synchronize()
    e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(calls):
        call()
    e1.record()
    e1.synchronize()
    return e0.elapsed_time(e1) * 1e3 / calls


def check(libs, envs, hist_envs, dev) -> dict:
    """'label case' -> equal to the plain version bit for bit."""
    cases = {}
    for case, jok, n in (("K4 bench", BENCH_JOKERS, envs),
                         ("K4 mixed 257", mixed_jokers(257), 257)):
        coef = FR.joker_coefficients(jok, n, device=dev)
        want = FR._reference_rows(coef, SEED, None, CHECK_STEPS)
        cases[case] = (lambda so, coef=coef, n=n: k4_launcher(so, coef, n, CHECK_STEPS, dev),
                       want)
    inp = hist_inputs(hist_envs, dev)
    cases["K5"] = (lambda so: k5_launcher(so, inp, dev), HH.hand_histograms_reference(*inp))
    out = {}
    for label, kernels in libs.items():
        for case, (make, want) in cases.items():
            launch, got = make(kernels[case[:2]][0])
            if launch() != 0:
                raise RuntimeError(f"{label} {case} launch failed")
            torch.cuda.synchronize()
            out[f"{label} {case}"] = all(torch.equal(g, w) for g, w in zip(got, want))
    return out


def time_rounds(libs, envs, steps, hist_envs, rounds, dev) -> dict:
    """kernel -> label -> us a launch (a call for ``K4 call``), one sample a
    round."""
    coef = FR.joker_coefficients(BENCH_JOKERS, envs, device=dev)
    inp = hist_inputs(hist_envs, dev)
    jobs = []
    for label, kernels in libs.items():
        so4 = kernels["K4"][0]
        jobs.append(("K4", label, k4_launcher(so4, coef, envs, steps, dev)[0], card_us, 1))
        jobs.append(("K4 call", label, k4_call(so4, envs, steps, dev), call_us, CALLS))
        jobs.append(("K5", label, k5_launcher(kernels["K5"][0], inp, dev)[0], card_us,
                     HIST_CALLS))
    jobs.sort(key=lambda j: j[0])                                        # builds in turn
    for _, _, launch, _, _ in jobs:                                      # warm-up
        launch()
    torch.cuda.synchronize()
    samples = {}
    for r in range(rounds):
        for kernel, label, launch, timer, calls in (jobs[::-1] if r % 2 else jobs):
            samples.setdefault(kernel, {}).setdefault(label, []).append(timer(launch, calls))
    return samples


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("builds", nargs="+", help="LABEL=DIR of a csrc/ copy")
    p.add_argument("--envs", type=int, default=131072)
    p.add_argument("--steps", type=int, default=256)
    p.add_argument("--hist-envs", type=int, default=1 << 20)
    p.add_argument("--rounds", type=int, default=10)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("sim_kernels_ab: torch sees no CUDA card")
    dev = torch.device("cuda", torch.cuda.current_device())
    builds = dict(b.split("=", 1) for b in args.builds)
    libs = build(builds)
    equal = check(libs, args.envs, args.hist_envs, dev)
    times = time_rounds(libs, args.envs, args.steps, args.hist_envs, args.rounds, dev)
    sass = {label: cuda_build.sass_loop(k["K4"][1], "fused_rollout_kernel")
            for label, k in libs.items()}
    out = {"gpu": card_name(), "device": torch.cuda.get_device_name(0), "envs": args.envs,
           "steps": args.steps, "hist_envs": args.hist_envs, "rounds": args.rounds,
           "builds": builds,
           "ptxas": {label: {k: v[2] for k, v in ks.items()} for label, ks in libs.items()},
           "shapes": {label: {k: shape(v[0], k) for k, v in ks.items()}
                      for label, ks in libs.items()},
           "k4_loop_sass": {label: {"instructions": len(ops),
                                    "opcodes": dict(collections.Counter(ops).most_common())}
                            for label, ops in sass.items()},
           "equal_to_plain": equal, "all_equal": all(equal.values()),
           "us": {k: {label: summary(xs) for label, xs in v.items()} for k, v in times.items()}}
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":  # pragma: no cover
    main()
