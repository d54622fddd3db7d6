"""Training command line of the port: PPO, A2C or DQN on one device, and
data-parallel PPO over ranks.

Port of ``balatro_gym_tpu/train/cli.py``:

    python -m balatro_gym_tpu_torch.train.cli --env sim --updates 50
    python -m balatro_gym_tpu_torch.train.cli --env full --fused-rollout --bf16 --env-shuffle
    python -m balatro_gym_tpu_torch.train.cli --env full --updates 20
    python -m balatro_gym_tpu_torch.train.cli --algorithm a2c --env full --n-envs 8192 --rollout 5
    python -m balatro_gym_tpu_torch.train.cli --algorithm dqn --env full --n-envs 8192 --rollout 4
    python -m balatro_gym_tpu_torch.train.cli --env sim --updates 2 --device cpu
    torchrun --nproc-per-node 2 -m balatro_gym_tpu_torch.train.cli --distributed --env full

It runs on the card unless given ``--device cpu`` (the kernels' plain
versions then run on the CPU), prints one JSON line of metrics every
``--log-every`` updates and writes the reference's summary keys to
``--summary``. ``--env full`` without ``--fused-rollout`` trains over the
generic rollout (the engine's step, ``env_step_kernel``, and K3b for the
observation and mask), as A2C and DQN always do. As in the reference,
``--algorithm a2c`` takes ``A2CConfig(n_envs, rollout_len=--rollout,
lr)`` and ``--algorithm dqn`` ``DQNConfig(n_envs, lr,
steps_per_update=--rollout)``, every other option at the learner's
default; the rate is counted as ``n_envs * rollout`` env-steps an update.
``--checkpoint-dir D`` with ``--checkpoint-every N`` saves the learner's
whole state (for DQN the replay buffer too) to ``D/step_<i>`` after every
N-th update ``i`` of the run (``utils/checkpoint.py``), and ``--resume
D/step_<i>`` restores one after ``init_fn`` and trains on from it;
``--checkpoint-every`` alone saves nothing. ``--trace DIR`` profiles
updates 2-4 with ``utils.profiling.trace``: ``DIR/trace.json``, the
profiler's Chrome trace with the program's spans among its host events,
and ``DIR/spans.json``, each span name's count, total and self host ms and
host syncs, and the count of spans the tracer's full store dropped (rank 0
only). ``--wandb`` logs each metrics
line to a W&B run where ``wandb`` imports and starts, and trains without
logging where it does not.

``--distributed`` trains PPO through ``parallel.mesh.make_distributed_ppo``:
under a launcher (torchrun, ``python -m torch.distributed.run``) over its
ranks, ``--n-envs`` the global count (nccl where each rank owns a card,
gloo on the CPU or where ranks share a card), and alone as a mesh of one.
Only rank 0 prints, writes the summary (``n_devices`` is the world size)
and saves checkpoints; ``--resume`` over more than one rank exits non-zero
(a checkpoint holds rank 0's envs only). As in the reference, ``--algorithm
a2c|dqn`` trains alone; under a launcher of more than one rank, every run
that is not ``--distributed`` PPO exits non-zero, so that the ranks never
train separate learners in silence.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import time
from pathlib import Path

import torch

TRACED = (1, 3)     # --trace profiles updates 2-4 (0-based 1..3)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Balatro trainer (PyTorch)")
    p.add_argument("--algorithm", choices=["ppo", "a2c", "dqn"], default="ppo")
    p.add_argument("--env", choices=["sim", "full"], default="sim")
    p.add_argument("--updates", type=int, default=50)
    p.add_argument("--n-envs", type=int, default=1024)
    p.add_argument("--rollout", type=int, default=16)
    p.add_argument("--epochs", type=int, default=4)
    p.add_argument("--minibatches", type=int, default=4)
    p.add_argument("--lr", type=float, default=3e-4)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--distributed", action="store_true")
    p.add_argument("--checkpoint-dir", type=str, default="")
    p.add_argument("--checkpoint-every", type=int, default=0)
    p.add_argument("--resume", type=str, default="")
    p.add_argument("--log-every", type=int, default=10)
    p.add_argument("--wandb", action="store_true")
    p.add_argument("--trace", type=str, default="",
                   help="profile updates 2-4 into this directory ('' = no profile)")
    p.add_argument("--summary", type=str, default="training_summary.json",
                   help="where to write the run's summary ('' = nowhere)")
    p.add_argument("--fused-rollout", action="store_true",
                   help="collect through the fused collection kernels (full env only)")
    p.add_argument("--structured-net", action="store_true",
                   help="three-branch features extractor (full env only)")
    p.add_argument("--hidden", type=int, nargs="*", default=None,
                   help="flat-MLP hidden widths (default 256 256)")
    p.add_argument("--bf16", action="store_true",
                   help="bfloat16 matmuls for the policy net (params stay float32)")
    p.add_argument("--env-shuffle", action="store_true",
                   help="minibatches from an env-axis permutation (see PPOConfig)")
    p.add_argument("--ent-final", type=float, default=-1.0,
                   help="linear entropy-coefficient decay target (<0 = constant)")
    p.add_argument("--lr-final", type=float, default=-1.0,
                   help="linear lr decay target (<0 = constant)")
    p.add_argument("--device", type=str, default="cuda",
                   help="cuda (default) or cpu (the plain versions, for testing)")
    return p


def main(argv=None) -> dict:
    args = build_parser().parse_args(argv)
    from balatro_gym_tpu_torch.parallel import mesh as PM

    launched = PM.launcher_env()
    if launched is not None and launched[0] > 1 and not (
            args.distributed and args.algorithm == "ppo"):
        raise SystemExit(f"{launched[0]} ranks were launched, but only --distributed PPO "
                         "trains over ranks: each would train a learner of its own")
    if args.fused_rollout and args.env != "full":
        raise SystemExit("--fused-rollout requires --env full")
    if args.structured_net and args.env != "full":
        raise SystemExit("--structured-net requires --env full")

    from balatro_gym_tpu_torch.core.device import run_device
    from balatro_gym_tpu_torch.ops import kernel_rng as KR
    from balatro_gym_tpu_torch.train.ppo import (
        PPOConfig, full_env_hooks, make_ppo, sim_env_hooks)
    from balatro_gym_tpu_torch.utils.checkpoint import restore_train_state, save_train_state

    hooks = sim_env_hooks() if args.env == "sim" else full_env_hooks()
    mesh = None
    cfg = PPOConfig(n_envs=args.n_envs, rollout_len=args.rollout, epochs=args.epochs,
                    minibatches=args.minibatches, lr=args.lr,
                    fused_rollout=args.fused_rollout, structured_net=args.structured_net,
                    bf16_compute=args.bf16, env_shuffle=args.env_shuffle,
                    total_updates=args.updates, ent_coef_final=args.ent_final,
                    lr_final=args.lr_final,
                    **({"hidden": tuple(args.hidden)} if args.hidden else {}))
    if args.algorithm == "a2c":
        from balatro_gym_tpu_torch.train.a2c import A2CConfig, make_a2c

        init_fn, update_fn = make_a2c(
            hooks, A2CConfig(n_envs=args.n_envs, rollout_len=args.rollout, lr=args.lr),
            device=args.device)
    elif args.algorithm == "dqn":
        from balatro_gym_tpu_torch.train.dqn import DQNConfig, make_dqn

        init_fn, update_fn = make_dqn(
            hooks, DQNConfig(n_envs=args.n_envs, lr=args.lr, steps_per_update=args.rollout),
            device=args.device)
    elif args.distributed:
        PM.init_distributed(device=args.device)
        mesh = PM.make_mesh(device=args.device)
        if args.resume and mesh.size > 1:
            raise SystemExit("--resume over more than one rank: a checkpoint holds rank 0's "
                             "envs only")
        init_fn, update_fn, _ = PM.make_distributed_ppo(hooks, cfg, mesh)
    else:
        init_fn, update_fn, _ = make_ppo(hooks, cfg, device=args.device)
    lead = mesh is None or mesh.rank == 0
    wandb_run = None
    if args.wandb and lead:
        try:
            import wandb

            wandb_run = wandb.init(project="balatro-tpu", config=vars(args))
        except Exception:
            wandb_run = None  # offline / not installed: train anyway
    ts = init_fn([int(w) for w in KR.seed_key(args.seed, device="cpu")])
    if args.resume:
        ts = restore_train_state(args.resume, ts)
        print(f"resumed from {args.resume} at update {ts.update_idx}", flush=True)
    on_card = (run_device((), args.device) if mesh is None else mesh.device).type == "cuda"

    from balatro_gym_tpu_torch.utils import profiling

    t0 = time.perf_counter()
    metrics = {}
    tracing = contextlib.ExitStack()
    for i in range(args.updates):
        if args.trace and lead and i == TRACED[0]:
            tracing.enter_context(profiling.trace(args.trace))
        ts, metrics = update_fn(ts)
        if args.trace and lead and i == TRACED[1]:
            if on_card:
                torch.cuda.synchronize()
            tracing.close()
        if args.log_every and (i + 1) % args.log_every == 0 and lead:
            m = {k: float(v) for k, v in metrics.items()}
            m["update"] = i + 1
            m["env_steps_per_sec"] = (i + 1) * cfg.n_envs * cfg.rollout_len / (
                time.perf_counter() - t0)
            print(json.dumps(m), flush=True)
            if wandb_run:
                wandb_run.log(m)
        if args.checkpoint_every and args.checkpoint_dir and lead and \
                (i + 1) % args.checkpoint_every == 0:
            save_train_state(Path(args.checkpoint_dir) / f"step_{i + 1}", ts)
    if on_card:
        torch.cuda.synchronize()
    tracing.close()
    elapsed = time.perf_counter() - t0
    total_steps = args.updates * cfg.n_envs * cfg.rollout_len
    summary = {
        "algorithm": args.algorithm, "env": args.env, "total_env_steps": total_steps,
        "wall_seconds": elapsed, "steps_per_second": total_steps / elapsed,
        "updates": args.updates, "final_metrics": {k: float(v) for k, v in metrics.items()},
        "n_devices": 1 if mesh is None else mesh.size,
    }
    if lead:
        if args.summary:
            Path(args.summary).write_text(json.dumps(summary, indent=2))
        print(json.dumps(summary))
    if wandb_run:
        wandb_run.finish()
    PM.destroy()
    return summary


if __name__ == "__main__":  # pragma: no cover
    main()
