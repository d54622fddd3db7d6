"""Peaks of the card and the work a kernel or an update must do.

Peaks: NVIDIA H100 SXM5 80GB data sheet, dense rates at the 700 W power
limit (the run prints the card's ``power.limit`` beside them). No metric
uses an integer-op peak.

Bytes: each byte a kernel must read or write once, counted from the packed
layout of the flagship env (``cards`` 6 x 64 int32 rows, ``ints`` 132,
``rng`` 18: 2,136 B an env). Operations: the policy net's multiply-adds
(2 FLOP each) counted from its widths.
"""
from __future__ import annotations

BF16_FLOPS = 989e12          # dense bf16 tensor-core FLOP/s
HBM_BYTES = 3.35e12          # HBM3 bytes/s

STATE_BYTES = (6 * 64 + 132 + 18) * 4            # 2,136 B an env, packed
# K3a (policy_step_kernel): read the state and the action, write the state,
# the reward and done, and the next observation (189 floats) and mask (60).
K3A_BYTES = 2 * STATE_BYTES + 4 + 4 + 1 + 189 * 4 + 60     # 5,093 B an env
# env_step_kernel: read the state and the action, write the state, the
# reward and done.
ENV_STEP_BYTES = 2 * STATE_BYTES + 9                       # 4,281 B an env
# K2 (fused_full_rollout_kernel): read the start, write the final state,
# the reward total and the episode count.
K2_BYTES = 2 * STATE_BYTES + 8                             # 4,280 B an env


def dense_widths(obs_dim: int, hidden, n_actions: int):
    """(in, out) of each dense layer of the shared-torso actor-critic: the
    torso, then the logits and the value head side by side."""
    w = (obs_dim, *hidden)
    return list(zip(w, w[1:])) + [(w[-1], n_actions), (w[-1], 1)]


def forward_flops(obs_dim: int, hidden, n_actions: int) -> int:
    """FLOP of one forward pass of one env-step."""
    return sum(2 * i * o for i, o in dense_widths(obs_dim, hidden, n_actions))


def sgd_flops(obs_dim: int, hidden, n_actions: int) -> int:
    """FLOP of one sample's SGD step: its forward, every weight gradient,
    and every input gradient but the first layer's."""
    layers = dense_widths(obs_dim, hidden, n_actions)
    mm = [2 * i * o for i, o in layers]
    return 2 * sum(mm) + sum(mm[1:])


def ppo_update_flops(obs_dim, hidden, n_actions, n_envs, rollout_len, epochs) -> float:
    """FLOP of one PPO update: the collection's forwards, the last value and
    ``epochs`` passes of SGD over the rollout."""
    fwd = forward_flops(obs_dim, hidden, n_actions)
    return float(n_envs * rollout_len * fwd + n_envs * fwd
                 + epochs * n_envs * rollout_len * sgd_flops(obs_dim, hidden, n_actions))


def roofline_pct(bytes_moved: float, seconds: float) -> float | None:
    """The byte bound's share of a measured time, in %: None without a
    time."""
    if not seconds or seconds <= 0:
        return None
    return 100.0 * (bytes_moved / HBM_BYTES) / seconds
