"""Hyperparameter search (the reference's ``--tune`` Optuna path,
train_balatro_agent.py:482-531).

Port of ``balatro_gym_tpu/train/tune.py``: Optuna where it is installed,
else log-uniform random search over the same space with the same objective
(the mean reward of the last updates of a short PPO run, ``train.ppo.
make_ppo`` on one device). Optuna is installed neither here nor on the
card's machine, so the random search is what runs:

    python -m balatro_gym_tpu_torch.train.tune --trials 10 --env sim
    python -m balatro_gym_tpu_torch.train.tune --trials 2 --updates 1 --n-envs 16 --device cpu

prints one JSON line ``{"best_params", "best_value", "trials", "backend"}``.
Runs on the card unless given ``device="cpu"`` (``--device cpu``).
"""
from __future__ import annotations

import json
import math
import random
from typing import Any

SEARCH_SPACE = {
    # (low, high, log): the reference's suggest_float calls
    "lr": (1e-5, 1e-3, True),
    "ent_coef": (1e-4, 0.1, True),
    "clip_eps": (0.1, 0.4, False),
    "gae_lambda": (0.9, 0.99, False),
}


def _objective_factory(env: str, updates: int, n_envs: int, device=None):
    from balatro_gym_tpu_torch.ops import kernel_rng as KR
    from balatro_gym_tpu_torch.train.ppo import (
        PPOConfig, full_env_hooks, make_ppo, sim_env_hooks)

    hooks = sim_env_hooks() if env == "sim" else full_env_hooks()

    def run(params: dict[str, float], seed: int = 0) -> float:
        cfg = PPOConfig(n_envs=n_envs, rollout_len=8, epochs=2, minibatches=2, **params)
        init_fn, update_fn, _ = make_ppo(hooks, cfg, device=device)
        ts = init_fn([int(w) for w in KR.seed_key(seed, device="cpu")])
        rewards = []
        for _ in range(updates):
            ts, m = update_fn(ts)
            rewards.append(float(m["mean_reward"]))
        return sum(rewards[-3:]) / min(3, len(rewards))

    return run


def _sample(rng: random.Random) -> dict[str, float]:
    out = {}
    for k, (lo, hi, log) in SEARCH_SPACE.items():
        if log:
            out[k] = math.exp(rng.uniform(math.log(lo), math.log(hi)))
        else:
            out[k] = rng.uniform(lo, hi)
    return out


def tune(n_trials: int = 10, env: str = "sim", updates: int = 5, n_envs: int = 128,
         seed: int = 0, *, device=None) -> dict[str, Any]:
    """Run the search; returns {'best_params', 'best_value', 'trials',
    'backend'}."""
    objective = _objective_factory(env, updates, n_envs, device)
    try:
        import optuna

        def opt_obj(trial):
            params = {}
            for k, (lo, hi, log) in SEARCH_SPACE.items():
                params[k] = trial.suggest_float(k, lo, hi, log=log)
            return objective(params)

        study = optuna.create_study(direction="maximize")
        study.optimize(opt_obj, n_trials=n_trials)
        return {"best_params": study.best_params, "best_value": study.best_value,
                "trials": len(study.trials), "backend": "optuna"}
    except ImportError:
        rng = random.Random(seed)
        trials = []
        for _ in range(n_trials):
            params = _sample(rng)
            trials.append({"params": params, "value": objective(params)})
        best = max(trials, key=lambda t: t["value"])
        return {"best_params": best["params"], "best_value": best["value"],
                "trials": len(trials), "backend": "random-search"}


def main(argv=None) -> dict:
    import argparse

    p = argparse.ArgumentParser(description="PPO hyperparameter search (PyTorch, one device)")
    p.add_argument("--trials", type=int, default=10)
    p.add_argument("--env", choices=["sim", "full"], default="sim")
    p.add_argument("--updates", type=int, default=5)
    p.add_argument("--n-envs", type=int, default=128)
    p.add_argument("--device", type=str, default="cuda",
                   help="cuda (default) or cpu (the plain versions, for testing)")
    args = p.parse_args(argv)
    out = tune(args.trials, args.env, args.updates, args.n_envs, device=args.device)
    print(json.dumps(out))
    return out


if __name__ == "__main__":  # pragma: no cover
    main()
