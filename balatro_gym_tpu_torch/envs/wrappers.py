"""Host-side env wrappers: the reference's training-harness shims.

A copy of ``balatro_gym_tpu/envs/wrappers.py`` (numpy only), so that the
port imports nothing of the JAX package. Over any Gym shell:

* ``CurriculumWrapper`` — max-ante gating with performance-based advancement
  (reference: train_balatro_agent.py:126-170 CurriculumBalatroEnv +
  curiculum_learning.py:31-66).
* ``ProgressionRewardWrapper`` — +200 per new ante, +100 personal best,
  stuck-on-ante-1 penalties and forced termination, efficiency bonuses
  (reference: train_progressive.py:21-120).
* ``SafeEnvWrapper`` — terminates after N consecutive invalid actions with a
  penalty, caps episode length, converts internal exceptions into terminal
  steps (reference: train_balatro_fixed.py:228-282 SafeBalatroEnv). Invalid
  actions are already harmless in the engine (masked, -1 reward, no state
  change), so this wrapper only tracks the streaks and caps.
* ``FlatObsWrapper`` — flattens the Dict observation into one float32 Box
  (reference: train_balatro_fixed.py:20-225 BalatroEnvFixed rewrote dtypes
  for SB3; here the learner consumes a flat vector).
"""
from __future__ import annotations

import numpy as np


class _Wrapper:
    def __init__(self, env):
        self.env = env

    def __getattr__(self, name):
        return getattr(self.env, name)

    def reset(self, **kw):
        return self.env.reset(**kw)

    def step(self, action):
        return self.env.step(action)


class CurriculumWrapper(_Wrapper):
    """Gate episodes at a max ante; advance the stage on sustained success."""

    def __init__(self, env, start_max_ante: int = 2, win_threshold: float = 0.6,
                 window: int = 20):
        super().__init__(env)
        self.max_ante = start_max_ante
        self.win_threshold = win_threshold
        self.window = window
        self._results: list[bool] = []
        self._best_ante = 1

    def step(self, action):
        obs, reward, done, trunc, info = self.env.step(action)
        ante = int(obs["ante"])
        self._best_ante = max(self._best_ante, ante)
        if ante > self.max_ante:
            done = True
            info["curriculum_capped"] = True
            reward += 50.0  # reached the stage cap = stage win
            self._record(True)
        elif done:
            self._record(ante >= self.max_ante)
        return obs, reward, done, trunc, info

    def _record(self, won: bool):
        self._results.append(won)
        if len(self._results) >= self.window:
            if np.mean(self._results[-self.window:]) >= self.win_threshold:
                self.max_ante += 1
                self._results.clear()

    def reset(self, **kw):
        self._best_ante = 1
        return self.env.reset(**kw)


class ProgressionRewardWrapper(_Wrapper):
    """Ante-progression shaping (train_progressive.py:21-120)."""

    def __init__(self, env, ante_bonus: float = 200.0, best_bonus: float = 100.0,
                 stuck_limit: int = 150):
        super().__init__(env)
        self.ante_bonus = ante_bonus
        self.best_bonus = best_bonus
        self.stuck_limit = stuck_limit
        self._episode_best = 1
        self._alltime_best = 1
        self._steps_on_ante1 = 0

    def reset(self, **kw):
        self._episode_best = 1
        self._steps_on_ante1 = 0
        return self.env.reset(**kw)

    def step(self, action):
        obs, reward, done, trunc, info = self.env.step(action)
        ante = int(obs["ante"])
        if ante > self._episode_best:
            reward += self.ante_bonus * (ante - self._episode_best)
            self._episode_best = ante
            if ante > self._alltime_best:
                reward += self.best_bonus
                self._alltime_best = ante
        if ante == 1:
            self._steps_on_ante1 += 1
            if self._steps_on_ante1 >= self.stuck_limit:
                reward -= 50.0
                done = True
                info["stuck_on_ante_1"] = True
        else:
            self._steps_on_ante1 = 0
        return obs, reward, done, trunc, info


class SafeEnvWrapper(_Wrapper):
    """Invalid-action streak cap + episode step cap
    (train_balatro_fixed.py:228-282)."""

    def __init__(self, env, max_invalid: int = 50, max_steps: int = 1000,
                 invalid_penalty: float = -50.0):
        super().__init__(env)
        self.max_invalid = max_invalid
        self.max_steps = max_steps
        self.invalid_penalty = invalid_penalty
        self._invalid_streak = 0
        self._steps = 0

    def reset(self, **kw):
        self._invalid_streak = 0
        self._steps = 0
        return self.env.reset(**kw)

    def step(self, action):
        try:
            obs, reward, done, trunc, info = self.env.step(action)
        except Exception as e:  # fault containment (reference :263-270)
            obs, _ = self.env.reset()
            return obs, -100.0, True, False, {"error": repr(e)}
        self._steps += 1
        if reward == -1.0:
            self._invalid_streak += 1
            if self._invalid_streak >= self.max_invalid:
                reward += self.invalid_penalty
                done = True
                info["too_many_invalid"] = True
        else:
            self._invalid_streak = 0
        if self._steps >= self.max_steps:
            done = True
            info["max_steps_reached"] = True
        return obs, reward, done, trunc, info


class FlatObsWrapper(_Wrapper):
    """Dict obs -> single float32 vector (+ mask passthrough in info)."""

    _EXCLUDE = ("action_mask",)

    def _flatten(self, obs):
        parts = [np.asarray(obs[k], np.float32).ravel()
                 for k in sorted(obs) if k not in self._EXCLUDE]
        return np.concatenate(parts)

    def reset(self, **kw):
        obs, info = self.env.reset(**kw)
        info["action_mask"] = np.asarray(obs["action_mask"])
        return self._flatten(obs), info

    def step(self, action):
        obs, reward, done, trunc, info = self.env.step(action)
        info["action_mask"] = np.asarray(obs["action_mask"])
        return self._flatten(obs), reward, done, trunc, info
