"""DQN with a replay ring on the device, on batched envs, on one device.

Port of ``balatro_gym_tpu/train/dqn.py`` (reference: train_balatro_agent.py
--algorithm dqn, hyperparameters :346-360: lr 1e-4, buffer 100k, target
updates, epsilon-greedy exploration). One update collects
``steps_per_update`` steps of every env with epsilon-greedy actions over
the masked Q-values, writes each step's batch into the ring buffer, then
takes one TD step with plain Adam (``optax.adam(lr)``: eps 1e-8, no clip)
on a uniform sample of the buffer against the target network's masked
bootstrap. Below ``learning_starts`` transitions the parameters and the
Adam state (its count included) stay as they were; every
``target_update_every`` updates the target takes the parameters.

Keys are split as the reference splits them: ``init_fn`` 3 ways (net,
envs, run); an update into (next, steps, sample); a step's key into
(k_eps, k_rand). The buffer's tensors live on the learner's device (at the
reference's 100,000 transitions of the flagship env, 151 MB of
observations plus 6 MB of next masks). Observations are not normalised.

Every entry point runs on the card unless the caller passes
``device="cpu"``.
"""
from __future__ import annotations

import copy
import dataclasses
from typing import Any, Sequence

import numpy as np
import torch
from torch import nn

from balatro_gym_tpu_torch.core.device import run_device
from balatro_gym_tpu_torch.ops import kernel_rng as KR
from balatro_gym_tpu_torch.train.networks import _linear, load_flax_params
from balatro_gym_tpu_torch.train.ppo import (
    AdamState, EnvHooks, _flax_leaves, _keys, adam_init, adam_update, categorical, param_list,
    reference_env_states, reference_key, sim_env_hooks)

_F32 = torch.float32


class QNetwork(nn.Module):
    """The reference's ``QNetwork``: ``hidden`` Dense+ReLU layers, then a
    Dense to ``n_actions`` Q-values; illegal actions get exactly -1e9.
    Orthogonal weights (gain sqrt(2) hidden, 1.0 out) from ``generator``;
    ``load_flax_params`` carries the reference's flax weights instead."""

    def __init__(self, n_actions: int, obs_dim: int, hidden: Sequence[int] = (256, 256),
                 generator: torch.Generator | None = None):
        super().__init__()
        g = generator if generator is not None else torch.Generator().manual_seed(0)
        widths = (obs_dim, *hidden)
        self.hidden = nn.ModuleList(_linear(a, b, 2 ** 0.5, g) for a, b in zip(widths, widths[1:]))
        self.out = _linear(widths[-1], n_actions, 1.0, g)

    def dense_layers(self):
        """The Linear layers in the order of flax's ``Dense_0, Dense_1, ...``."""
        return [*self.hidden, self.out]

    def forward(self, obs, mask):
        x = obs
        for lin in self.hidden:
            x = torch.relu(lin(x))
        return torch.where(mask, self.out(x), -1e9)


@dataclasses.dataclass(frozen=True)
class DQNConfig:
    """The reference's ``DQNConfig``, field for field."""

    n_envs: int = 256
    buffer_size: int = 100_000        # transitions (ring, on the device)
    batch_size: int = 512
    lr: float = 1e-4
    gamma: float = 0.99
    eps_start: float = 1.0
    eps_end: float = 0.05
    eps_decay_updates: int = 500
    target_update_every: int = 100    # updates between target syncs
    steps_per_update: int = 4         # env steps collected per update
    learning_starts: int = 1_000      # transitions before TD updates
    hidden: tuple = (256, 256)


@dataclasses.dataclass
class DQNState:
    """The learner's state. ``params`` and ``target_params`` are
    ``QNetwork`` modules; an update changes ``params``, the Adam moments
    and the buffer's tensors in place (take ``copy.deepcopy`` of a state to
    keep it). ``key`` is the two words of the Threefry key; ``buf_ptr``
    and ``buf_len`` are python ints."""

    params: nn.Module
    target_params: nn.Module
    opt_state: AdamState
    env_states: Any
    key: tuple
    update_idx: int
    buf_obs: torch.Tensor        # [cap, D] f32
    buf_action: torch.Tensor     # [cap] i32
    buf_reward: torch.Tensor     # [cap] f32
    buf_next_obs: torch.Tensor   # [cap, D] f32
    buf_next_mask: torch.Tensor  # [cap, A] bool
    buf_done: torch.Tensor       # [cap] bool
    buf_ptr: int
    buf_len: int


def epsilon(cfg: DQNConfig, update_idx: int) -> float:
    """The linear exploration schedule, as the reference's jit computes it
    in float32 on the CPU: ``frac = clip(idx * fl(1 / decay_updates), 0,
    1)`` (the division by a constant becomes a reciprocal multiply), then
    ``eps_start + frac * (eps_end - eps_start)`` as one fused multiply-add,
    rounded once (the float64 product of two float32 values is exact)."""
    frac = np.clip(np.float32(update_idx) * np.float32(1.0 / cfg.eps_decay_updates),
                   np.float32(0), np.float32(1))
    return float(np.float32(np.float64(np.float32(cfg.eps_start)) + np.float64(frac)
                            * np.float64(np.float32(cfg.eps_end - cfg.eps_start))))


def huber(x, delta: float = 1.0):
    """``optax.huber_loss`` of an error: ``0.5 * min(|x|, d)**2 + d * (|x|
    - min(|x|, d))``."""
    a = x.abs()
    q = a.clamp(max=delta)
    return 0.5 * q ** 2 + delta * (a - q)


def td_loss(net, target_net, buf, sample, gamma: float):
    """The mean Huber TD error of the transitions ``sample`` of the ring
    ``buf`` (a DQNState): the online Q-value of the stored action, with no
    mask, against ``reward + gamma * max(target Q of the next state, its
    mask) * (1 - done)``, which carries no gradient."""
    with torch.no_grad():
        q_next = target_net(buf.buf_next_obs[sample], buf.buf_next_mask[sample])
        target = (buf.buf_reward[sample]
                  + gamma * q_next.amax(-1) * (1.0 - buf.buf_done[sample].to(_F32)))
    q = net(buf.buf_obs[sample], torch.ones_like(buf.buf_next_mask[sample]))
    q_a = q.gather(1, buf.buf_action[sample].long()[:, None])[:, 0]
    return huber(q_a - target).mean()


def make_dqn(hooks: EnvHooks, cfg: DQNConfig, *, device=None):
    """(init_fn, update_fn) of one DQN run on one device (default: the
    card; ``device="cpu"`` runs the kernels' plain versions).

    init_fn(key) -> DQNState; update_fn(ts, record=None) -> (DQNState,
    metrics): the metrics are the reference's keys (``epsilon`` and
    ``buffer`` as python floats, the rest 0-dim tensors on the device). A
    dict given as ``record`` is filled with the collection's ``action``,
    ``reward`` and ``done`` (``[steps, E]``), the TD batch's ``sample``
    indices and whether the update was ``ready``.

    A step writes its ``n_envs`` transitions to slots ``(ptr + i) % cap``;
    with ``n_envs > buffer_size`` one write would reach a slot twice, and
    which write the reference keeps is undefined, so such a config raises
    ``ValueError``."""
    if cfg.n_envs > cfg.buffer_size:
        raise ValueError(f"n_envs={cfg.n_envs} > buffer_size={cfg.buffer_size}: a step's ring "
                         "write would reach a slot twice")
    dev = run_device((), device)
    cap, A, D = cfg.buffer_size, hooks.n_actions, hooks.obs_dim

    def init_fn(key) -> DQNState:
        k_net, k_env, k_run = KR.split_keys(key, 3)
        net = QNetwork(A, D, tuple(cfg.hidden),
                       generator=torch.Generator().manual_seed((k_net[0] << 32) | k_net[1]))
        net = net.to(dev)
        return DQNState(
            params=net, target_params=copy.deepcopy(net), opt_state=adam_init(param_list(net)),
            env_states=hooks.reset(_keys(k_env, cfg.n_envs, dev)), key=k_run, update_idx=0,
            buf_obs=torch.zeros(cap, D, device=dev),
            buf_action=torch.zeros(cap, dtype=torch.int32, device=dev),
            buf_reward=torch.zeros(cap, device=dev),
            buf_next_obs=torch.zeros(cap, D, device=dev),
            buf_next_mask=torch.ones(cap, A, dtype=torch.bool, device=dev),
            buf_done=torch.zeros(cap, dtype=torch.bool, device=dev), buf_ptr=0, buf_len=0)

    def update_fn(ts: DQNState, record: dict | None = None):
        key, k_steps, k_sample = KR.split_keys(ts.key, 3)
        eps = epsilon(cfg, ts.update_idx)
        net, env_states = ts.params, ts.env_states
        ptr, blen = ts.buf_ptr, ts.buf_len
        arange = torch.arange(cfg.n_envs, device=dev)
        rewards, dones, actions = [], [], []
        with torch.no_grad():
            for k in KR.split_keys(k_steps, cfg.steps_per_update):
                obs, mask = hooks.observe(env_states), hooks.action_mask(env_states)
                q = net(obs, mask)
                k_eps, k_rand = KR.split_keys(k, 2)
                greedy = q.argmax(-1)              # the first of ties, as jnp.argmax
                rand, _ = categorical(k_rand, torch.where(mask, 0.0, -torch.inf))
                explore = KR.uniform_f32(KR.random_bits32(*k_eps, arange)) < eps
                action = torch.where(explore, rand, greedy).to(torch.int32)
                env_states, reward, done = hooks.step_autoreset(env_states, action)
                reward = reward.to(_F32)
                idx = (ptr + arange) % cap
                ts.buf_obs[idx] = obs
                ts.buf_action[idx] = action
                ts.buf_reward[idx] = reward
                ts.buf_next_obs[idx] = hooks.observe(env_states)
                ts.buf_next_mask[idx] = hooks.action_mask(env_states)
                ts.buf_done[idx] = done
                ptr, blen = (ptr + cfg.n_envs) % cap, min(blen + cfg.n_envs, cap)
                rewards.append(reward)
                dones.append(done)
                actions.append(action)

            # the TD batch: a uniform sample of the filled part of the ring
            sample = KR.randint(*k_sample, 0, max(blen, 1),
                                torch.arange(cfg.batch_size, device=dev))
        loss = td_loss(net, ts.target_params, ts, sample, cfg.gamma)
        ready = blen >= cfg.learning_starts
        params, opt = param_list(net), ts.opt_state
        if ready:
            grads = torch.autograd.grad(loss, params)
            opt = adam_update(params, grads, opt, cfg.lr, None, eps=1e-8)
        target_params = ts.target_params
        if (ts.update_idx + 1) % cfg.target_update_every == 0:
            target_params = copy.deepcopy(net)
        if record is not None:
            record.update(action=torch.stack(actions), reward=torch.stack(rewards),
                          done=torch.stack(dones), sample=sample, ready=ready)
        out = dataclasses.replace(ts, params=net, target_params=target_params, opt_state=opt,
                                  env_states=env_states, key=key,
                                  update_idx=ts.update_idx + 1, buf_ptr=ptr, buf_len=blen)
        return out, {"loss": loss.detach(), "epsilon": eps, "buffer": float(blen),
                     "mean_reward": torch.stack(rewards).mean(),
                     "episodes": torch.stack(dones).sum()}

    return init_fn, update_fn


def load_reference_dqn_state(hooks: EnvHooks, cfg: DQNConfig, ref: dict, *, device=None):
    """The reference's ``DQNState``, given as numpy arrays, as the port's.

    ``ref`` holds ``params`` and ``target_params`` (flax param dicts),
    ``mu``, ``nu`` and ``count`` (optax's Adam state), ``key``
    (``jax.random.key_data``), ``update_idx``, ``env_states`` (the flagship
    env's packed rows, else the SimEnvState's fields) and the ring:
    ``buf_obs``, ``buf_action``, ``buf_reward``, ``buf_next_obs``,
    ``buf_next_mask``, ``buf_done`` (int8 or bool), ``buf_ptr`` and
    ``buf_len``."""
    dev = run_device((), device)

    def net(tree):
        return load_flax_params(QNetwork(hooks.n_actions, hooks.obs_dim, tuple(cfg.hidden)),
                                tree).to(dev)

    params = net(ref["params"])

    def t(name, dtype):       # a copy: an update writes into the ring in place
        return torch.tensor(np.asarray(ref[name]), device=dev).to(dtype)

    return DQNState(
        params=params, target_params=net(ref["target_params"]),
        opt_state=AdamState(int(np.asarray(ref["count"])),
                            *([v.to(dev) for v in _flax_leaves(params, ref[k])]
                              for k in ("mu", "nu"))),
        env_states=reference_env_states(hooks, ref["env_states"], dev),
        key=reference_key(ref["key"]), update_idx=int(np.asarray(ref["update_idx"])),
        buf_obs=t("buf_obs", _F32), buf_action=t("buf_action", torch.int32),
        buf_reward=t("buf_reward", _F32), buf_next_obs=t("buf_next_obs", _F32),
        buf_next_mask=t("buf_next_mask", torch.bool), buf_done=t("buf_done", torch.bool),
        buf_ptr=int(np.asarray(ref["buf_ptr"])), buf_len=int(np.asarray(ref["buf_len"])))


def train(num_updates: int = 32, cfg: DQNConfig | None = None, seed: int = 0,
          hooks: EnvHooks | None = None, *, device=None):
    """Training on one device (default: the card) from ``key(seed)``.
    Returns (DQNState, last metrics)."""
    cfg = cfg or DQNConfig()
    hooks = hooks or sim_env_hooks()
    init_fn, update_fn = make_dqn(hooks, cfg, device=device)
    ts = init_fn([int(w) for w in KR.seed_key(seed, device="cpu")])
    metrics = None
    for _ in range(num_updates):
        ts, metrics = update_fn(ts)
    return ts, metrics
