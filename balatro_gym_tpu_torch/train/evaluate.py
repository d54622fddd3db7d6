"""Policy evaluation: N episodes of a policy, their statistics, and an
episode transcript.

Port of ``balatro_gym_tpu/train/evaluate.py``. The reference runs the
episodes as vmapped envs in one jitted scan; here they are a batch of envs
stepped in an eager loop on one device. The loop does not wait on the
card: step keys are split on the host before it, every per-step value stays
on the device, and the statistics come to the host once, at the end.
"""
from __future__ import annotations

from typing import Any, Callable

import torch

from balatro_gym_tpu_torch.core.device import run_device
from balatro_gym_tpu_torch.ops import kernel_rng as KR
from balatro_gym_tpu_torch.train.normalize import normalize
from balatro_gym_tpu_torch.train.ppo import _keys, categorical


def evaluate_policy(policy_fn: Callable, params: Any, hooks, n_episodes: int = 64,
                    max_steps: int = 256, seed: int = 0, greedy: bool = True,
                    obs_stats=None, greedy_antiloop: bool = True,
                    temperature: float = 1.0, *, device=None):
    """Run one episode per env for at most ``max_steps`` steps; returns the
    reference's statistics: ``episodes`` (envs whose episode ended),
    ``mean_reward``, ``mean_length``, ``max_reward`` and, for envs with an
    ante, ``mean_ante`` and ``max_ante`` (each env's peak ante while its
    episode was live, read from the state before and after each step).

    policy_fn(params, obs [B, D], mask [B, A]) -> (logits, value); params:
    an ``nn.Module`` whose parameters lie on the call's device. hooks: the
    batched ``EnvHooks`` of ``train/ppo.py``; its ``step`` (no autoreset)
    is used where it has one, else ``step_autoreset``. obs_stats: the
    training run's observation statistics, where it normalised them.
    greedy: argmax actions, with ``greedy_antiloop`` masking each env's
    actions already taken since its last nonzero reward (an eval-only
    heuristic, PARITY #B13; when every legal action has been tried, the
    mask clears); else actions sampled by :func:`train.ppo.categorical` from
    logits divided by ``temperature``. Envs reset from ``split(key(seed),
    n_episodes)``; step ``t`` samples with ``split(key(seed + 1),
    max_steps)[t]``. device: where to run (default: the device of the
    parameters if off the host, else the card; ``device="cpu"`` runs the
    plain versions).
    """
    tensors = list(params.parameters()) if isinstance(params, torch.nn.Module) else []
    dev = run_device(tensors, device)
    off = sorted({str(p.device) for p in tensors if p.device != dev})
    if off:
        raise ValueError(f"policy parameters lie on {off}, the call runs on {dev}: "
                         "move the policy there first")
    B = n_episodes
    step_fn = hooks.step or hooks.step_autoreset
    sts = hooks.reset(_keys([int(w) for w in KR.seed_key(seed, device="cpu")], B, dev))
    has_ante = hasattr(sts, "ante")
    ep_rew = torch.zeros(B, device=dev)
    ep_len = torch.zeros(B, dtype=torch.int32, device=dev)
    done_flag = torch.zeros(B, dtype=torch.bool, device=dev)
    max_ante = torch.zeros(B, dtype=torch.int32, device=dev)
    used = torch.zeros(B, hooks.n_actions, dtype=torch.bool, device=dev)
    ids = torch.arange(hooks.n_actions, device=dev)
    step_keys = KR.split_keys([int(w) for w in KR.seed_key(seed + 1, device="cpu")], max_steps)
    antiloop = greedy and greedy_antiloop
    with torch.no_grad():
        for k in step_keys:
            obs = hooks.observe(sts)
            if obs_stats is not None:
                obs = normalize(obs_stats, obs)
            mask = hooks.action_mask(sts)
            logits, _ = policy_fn(params, obs, mask)
            if antiloop:
                # Suppress tried actions; where none would be left, keep the
                # logits and let the cycle restart.
                blocked = used & mask
                any_free = (mask & ~blocked).any(-1, keepdim=True)
                logits = torch.where(blocked & any_free, -torch.inf, logits)
                used = used & any_free
            if greedy:
                action = logits.argmax(-1)
            else:
                action, _ = categorical(k, logits / temperature)
            sts2, rew, done = step_fn(sts, action)
            if antiloop:
                used = (used | (ids == action[:, None])) & ~((rew.abs() > 1e-6) | done)[:, None]
            live = ~done_flag
            ep_rew = ep_rew + torch.where(live, rew, 0.0).to(torch.float32)
            ep_len = ep_len + live.to(torch.int32)
            if has_ante:
                max_ante = torch.maximum(max_ante, torch.where(live, sts.ante, 0))
                max_ante = torch.maximum(max_ante, torch.where(live, sts2.ante, 0))
            done_flag = done_flag | done
            sts = sts2
    stats = {
        "episodes": int(done_flag.sum()),
        "mean_reward": float(ep_rew.double().mean()),
        "mean_length": float(ep_len.double().mean()),
        "max_reward": float(ep_rew.max()),
    }
    if has_ante:
        stats["mean_ante"] = float(max_ante.double().mean())
        stats["max_ante"] = int(max_ante.max())
    return stats


def transcript_episode(env, select_action, max_steps: int = 200) -> list[str]:
    """One episode through a Gym shell, as text lines (the reference's
    video path becomes a transcript)."""
    lines = []
    obs, _ = env.reset()
    total = 0.0
    for t in range(max_steps):
        action = int(select_action(obs))
        obs, r, done, trunc, info = env.step(action)
        total += r
        lines.append(f"t={t} a={action} r={r:+.2f} phase={int(obs['phase'])}"
                     f" ante={int(obs.get('ante', 0))}")
        if done:
            lines.append(f"episode done: total reward {total:.2f}")
            break
    return lines
