"""The flagship env's sampled whole rollout for chosen envs of chosen
calls, on the frozen copy.

Env ``e`` of a call with seed ``s`` starts from ``reset(split_child(
seed_key(s), e))`` and at step ``t`` takes the legal action that
``random_bits32(split_child(seed_key(s), e), t)`` picks; each env's path
depends on its own key alone, so any set of (seed, env) pairs can be run
together as one batch.
"""
from __future__ import annotations

import torch

from . import full_env as FE
from . import full_step as FF
from . import kernel_rng as KR


def sampled_rollout(seeds, envs, n_steps: int, reward_dtype=torch.float32) -> dict:
    """``seeds`` and ``envs``: ``[n]`` int64 tensors (a call's seed and an
    env index of it, per env). Returns the final packed ``rows`` (``cards``
    ``[6, 64, n]``, ``ints``, ``rng``), ``total_reward`` ``[n]`` (summed in
    ``reward_dtype``, returned as float32) and ``episodes`` ``[n]`` int32."""
    k1, k2 = KR.seed_key(seeds)
    child = KR.split_child(k1, k2, envs)
    s = FF._load(FF.pack_full_state(FE.reset_reference(torch.stack(child, -1))))
    tot = torch.zeros(envs.shape[0], dtype=reward_dtype, device=envs.device)
    epi = torch.zeros(envs.shape[0], dtype=torch.int32, device=envs.device)
    for t in range(n_steps):
        s, reward, done = FF._step(s, FF._sample_action(s, KR.random_bits32(*child, t)))
        tot = tot + reward.to(reward_dtype)
        epi = epi + done.to(torch.int32)
    return {"rows": FF._store(s), "total_reward": tot.float(), "episodes": epi}
