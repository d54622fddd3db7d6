"""Data-parallel scaling efficiency of the PPO update (weak scaling).

Port of ``balatro_gym_tpu/parallel/scaling_bench.py``. Measures the
distributed update's env-steps/s at 1 rank and at N ranks with the same
envs a rank, and reports the efficiency ``N_rate / (N * 1_rate)`` against
the reference's 0.8 target. Each measurement starts its ranks as
subprocesses (``mesh.launch``): on cards, one a card (``cuda:i``) over
NCCL, N = ``torch.cuda.device_count()``; on the CPU (``--device cpu``),
``--nproc`` ranks over gloo, the counterpart of the reference's virtual
CPU devices. On a machine with one card N is 1 and the efficiency is 1 by
construction (the two measurements are the same configuration): it says
nothing about scaling across cards.

    python -m balatro_gym_tpu_torch.parallel.scaling_bench --env full
    python -m balatro_gym_tpu_torch.parallel.scaling_bench --device cpu --nproc 2

Prints one JSON line with the reference's keys.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time
from pathlib import Path

import torch

_REPO = str(Path(__file__).resolve().parents[2])
RANKS_TIMEOUT_S = 900       # a measurement's ranks, start-up included


def _rank_main(argv):
    """One rank of :func:`measure`: prints ``RATE <env-steps/s>``."""
    from balatro_gym_tpu_torch.ops import kernel_rng as KR
    from balatro_gym_tpu_torch.parallel.mesh import (
        destroy, init_distributed, make_distributed_ppo, make_mesh)
    from balatro_gym_tpu_torch.train.ppo import PPOConfig, full_env_hooks, sim_env_hooks

    p = argparse.ArgumentParser()
    for name in ("--envs-per-dev", "--rollout", "--updates", "--seed"):
        p.add_argument(name, type=int)
    p.add_argument("--env")
    p.add_argument("--device", default=None)
    a = p.parse_args(argv)
    if a.device == "cpu":
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // int(os.environ["WORLD_SIZE"])))
    init_distributed(device=a.device)
    try:
        mesh = make_mesh(device=a.device)
        cfg = PPOConfig(n_envs=a.envs_per_dev * mesh.size, rollout_len=a.rollout, epochs=1,
                        minibatches=2, hidden=(64,))
        hooks = full_env_hooks() if a.env == "full" else sim_env_hooks()
        init_fn, step_fn, _ = make_distributed_ppo(hooks, cfg, mesh)
        ts = init_fn([int(w) for w in KR.seed_key(a.seed, device="cpu")])

        def sync(m):
            if mesh.device.type == "cuda":
                torch.cuda.synchronize(mesh.device)
            return float(m["loss"])

        ts, m = step_fn(ts)                         # warm-up
        sync(m)
        t0 = time.perf_counter()
        for _ in range(a.updates):
            ts, m = step_fn(ts)
        sync(m)
        dt = time.perf_counter() - t0
        print(f"RATE {a.updates * cfg.n_envs * cfg.rollout_len / dt!r}", flush=True)
    finally:
        destroy()


def measure(n_devices: int, envs_per_dev: int, rollout: int = 8, updates: int = 4,
            seed: int = 0, env: str = "sim", device=None) -> float:
    """env-steps/s of the distributed update over ``n_devices`` ranks (rank
    0's rate), each rank stepping ``envs_per_dev`` envs. ``device`` None is
    the card (one a rank, shared where ranks outnumber cards); ``"cpu"``
    runs the ranks on the CPU over gloo."""
    from balatro_gym_tpu_torch.parallel.mesh import launch

    argv = [sys.executable, "-m", "balatro_gym_tpu_torch.parallel.scaling_bench", "--rank",
            "--envs-per-dev", str(envs_per_dev), "--rollout", str(rollout), "--updates",
            str(updates), "--seed", str(seed), "--env", env]
    if device is not None:
        argv += ["--device", str(device)]
    env_vars = dict(os.environ, PYTHONPATH=os.pathsep.join(
        filter(None, [_REPO, os.environ.get("PYTHONPATH")])))
    outs = launch(argv, n_devices, timeout=RANKS_TIMEOUT_S, env=env_vars, cwd=_REPO)
    rate = [ln for ln in outs[0].splitlines() if ln.startswith("RATE ")]
    if not rate:
        raise RuntimeError(f"rank 0 printed no rate:\n{outs[0][-3000:]}")
    return float(rate[-1].split()[1])


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--envs-per-dev", type=int, default=64)
    p.add_argument("--rollout", type=int, default=8)
    p.add_argument("--updates", type=int, default=4)
    p.add_argument("--env", choices=("sim", "full"), default="sim",
                   help="'full' = the flagship Discrete(60) env")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    p.add_argument("--nproc", type=int, default=2, help="ranks on the CPU (--device cpu)")
    args = p.parse_args(argv)

    if args.device == "cpu":
        n = args.nproc
    else:
        if not torch.cuda.is_available():
            raise SystemExit("no CUDA card: torch.cuda.is_available() is False; pass "
                             "--device cpu to run the ranks on the CPU")
        n = torch.cuda.device_count()
    dev = "cpu" if args.device == "cpu" else None
    t1 = measure(1, args.envs_per_dev, args.rollout, args.updates, env=args.env, device=dev)
    tn = measure(n, args.envs_per_dev, args.rollout, args.updates, env=args.env, device=dev)
    eff = tn / (n * t1)
    out = {
        "metric": "dp_scaling_efficiency",
        "env": args.env,
        "n_devices": n,
        "steps_per_sec_1dev": round(t1, 1),
        "steps_per_sec_ndev": round(tn, 1),
        "value": round(eff, 3),
        "unit": "fraction",
        "vs_baseline": round(eff / 0.8, 3),  # target >= 0.8
    }
    print(json.dumps(out))
    return out


if __name__ == "__main__":  # pragma: no cover
    if sys.argv[1:2] == ["--rank"]:
        _rank_main(sys.argv[2:])
    else:
        main()
