"""Ante-progression reward shaping for the flagship env, inside training.

Port of ``balatro_gym_tpu/train/progression.py``, the batched form of the
reference's ``ProgressionRewardWrapper`` (``envs/wrappers.py`` holds the
host-side wrapper for Gym-shell users):

* +``ante_bonus`` x (new ante - the episode's best) when an env reaches a
  new ante this episode;
* +``best_bonus`` when it beats its own all-time best (kept across
  autoresets);
* an env on ante 1 for ``stuck_limit`` steps in a row ends with -50.

Shaping is for training only: evaluate on the unwrapped hooks, so peak
antes compare with plain PPO runs.
"""
from __future__ import annotations

import dataclasses

import torch

from balatro_gym_tpu_torch.train.ppo import EnvHooks


@dataclasses.dataclass
class ProgState:
    """A batch of shaped envs: the flagship env's state and ``[B]`` int32
    counters."""
    env: object                  # FullEnvState
    episode_best: torch.Tensor   # resets with the episode
    alltime_best: torch.Tensor   # kept across autoresets
    ante1_steps: torch.Tensor    # consecutive steps on ante 1


def progression_hooks(base: EnvHooks, ante_bonus: float = 200.0,
                      best_bonus: float = 100.0, stuck_limit: int = 150) -> EnvHooks:
    """``base`` (the flagship env's hooks) with progression shaping; the
    state carries each env's best and stuck counters through a rollout."""
    from balatro_gym_tpu_torch.engine import full_env as fe

    def reset(keys):
        env = base.reset(keys)
        one = torch.ones_like(env.ante)
        return ProgState(env=env, episode_best=one, alltime_best=one.clone(),
                         ante1_steps=torch.zeros_like(env.ante))

    def step_autoreset(ps: ProgState, action):
        st2, reward, done = fe.step(ps.env, action)
        reward = reward.to(torch.float32)
        ante = st2.ante
        adv = (ante - ps.episode_best).clamp(min=0)
        reward = reward + ante_bonus * adv.to(torch.float32)
        new_alltime = torch.maximum(ps.alltime_best, ante)
        reward = reward + torch.where(new_alltime > ps.alltime_best, best_bonus, 0.0)
        episode_best = torch.maximum(ps.episode_best, ante)
        ante1 = torch.where(ante == 1, ps.ante1_steps + 1, 0)
        stuck = ante1 >= stuck_limit
        reward = reward - torch.where(stuck, 50.0, 0.0)
        done = done | stuck
        return ProgState(env=fe.autoreset(st2, done), episode_best=torch.where(done, 1, episode_best),
                         alltime_best=new_alltime,
                         ante1_steps=torch.where(done, 0, ante1)), reward, done

    return EnvHooks(reset=reset, step_autoreset=step_autoreset,
                    step=None,  # training only: evaluate on the base hooks
                    observe=lambda ps: base.observe(ps.env),
                    action_mask=lambda ps: base.action_mask(ps.env),
                    n_actions=base.n_actions, obs_dim=base.obs_dim)
