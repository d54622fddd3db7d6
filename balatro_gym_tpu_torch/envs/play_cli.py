"""Play Balatro by hand in a terminal (reference: play_by_hand.py).

Run: python -m balatro_gym_tpu_torch.envs.play_cli [--env full|macro|draw]
[--seed N] [--device cpu]

Port of ``balatro_gym_tpu/envs/play_cli.py``: the flagship env, the macro
env and the 8-card draw env.
"""
from __future__ import annotations

import argparse

import numpy as np


def main(argv=None):  # pragma: no cover - interactive
    p = argparse.ArgumentParser(description="Play Balatro by hand")
    p.add_argument("--env", choices=["full", "macro", "draw"], default="full")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", type=str, default="cuda",
                   help="cuda (default) or cpu")
    args = p.parse_args(argv)

    if args.env == "full":
        from balatro_gym_tpu_torch.envs import BalatroGymEnv

        env = BalatroGymEnv(seed=args.seed, render_mode="human", device=args.device)
    elif args.env == "macro":
        from balatro_gym_tpu_torch.envs import BalatroMacroGymEnv

        env = BalatroMacroGymEnv(seed=args.seed, render_mode="human", device=args.device)
    else:
        from balatro_gym_tpu_torch.envs import EightCardDrawGymEnv

        env = EightCardDrawGymEnv(seed=args.seed, render_mode="human", device=args.device)
    obs, _ = env.reset()
    total = 0.0
    while True:
        env.render()
        legal = np.flatnonzero(obs["action_mask"])
        print(f"Legal actions: {legal.tolist()}")
        try:
            raw = input("action> ").strip()
        except EOFError:
            break
        if raw in ("q", "quit", "exit"):
            break
        try:
            action = int(raw)
        except ValueError:
            print("enter an action id or q")
            continue
        obs, reward, done, trunc, info = env.step(action)
        total += reward
        print(f"reward {reward:+.2f}  (total {total:.2f})  {info or ''}")
        if done:
            print("=== episode over ===")
            obs, _ = env.reset()
            total = 0.0


if __name__ == "__main__":  # pragma: no cover
    main()
