"""Synchronous advantage actor-critic (A2C) on batched envs, on one device.

Port of ``balatro_gym_tpu/train/a2c.py`` (reference: train_balatro_agent.py
--algorithm a2c, hyperparameters :362-377: lr 7e-4, n_steps 5, gamma 0.99,
vf 0.5, ent 0.01). One update is one rollout of ``rollout_len`` steps of
every env through the hooks' ``observe``, ``action_mask`` and
``step_autoreset`` (on the flagship env: K3b and ``env_step_kernel`` on a
card), actions drawn by ``train.ppo.categorical``; the discounted returns
from the last state's value, cut at episode ends; and one full-batch
gradient step on ``-log pi * A + vf_coef * value MSE - ent_coef *
entropy`` with optax's ``chain(clip_by_global_norm(0.5), rmsprop(lr,
decay=0.99, eps=1e-5))`` written out (``train.ppo.rmsprop_update``).

Keys are split as the reference splits them: ``init_fn`` splits its key 3
ways (net, envs, run), an update ``split(key)`` into the next key and the
rollout's, and the rollout's into one key a step. As in the port's PPO,
``update_stats`` is fed the normalised observations (the reference's
quirk). Given a data-parallel ``mesh`` (``parallel/mesh.py``), an update is
the reference's ``axis_name`` path: the rank folded into the rollout key,
the gradients averaged over the ranks in one all-reduce and the observation
statistics merged across them; the metrics stay the rank's own, as in the
reference.

Every entry point runs on the card unless the caller passes
``device="cpu"``.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from balatro_gym_tpu_torch.core.device import run_device
from balatro_gym_tpu_torch.ops import kernel_rng as KR
from balatro_gym_tpu_torch.train.networks import ActorCritic, load_flax_params
from balatro_gym_tpu_torch.train.normalize import (
    RunningStats, init_stats, normalize, update_stats)
from balatro_gym_tpu_torch.train.ppo import (
    EnvHooks, RMSPropState, _flax_leaves, _keys, categorical, mean_grads, param_list,
    reference_env_states, reference_key, reference_stats, rmsprop_init, rmsprop_update,
    sim_env_hooks)

_F32 = torch.float32


@dataclasses.dataclass(frozen=True)
class A2CConfig:
    """The reference's ``A2CConfig``, field for field."""

    n_envs: int = 1024
    rollout_len: int = 5
    lr: float = 7e-4
    gamma: float = 0.99
    vf_coef: float = 0.5
    ent_coef: float = 0.01
    max_grad_norm: float = 0.5
    hidden: tuple = (256, 256)
    normalize_obs: bool = True


@dataclasses.dataclass
class A2CState:
    """The learner's state. ``params`` is the ``ActorCritic`` module (an
    update changes its parameters and ``opt_state`` in place: take
    ``copy.deepcopy`` of a state to keep it); ``key`` the two words of
    the Threefry key."""

    params: torch.nn.Module
    opt_state: RMSPropState
    env_states: Any
    key: tuple
    obs_stats: RunningStats
    update_idx: int


def make_a2c(hooks: EnvHooks, cfg: A2CConfig, *, device=None, mesh=None):
    """(init_fn, update_fn) of one A2C run on one device (default: the
    card; ``device="cpu"`` runs the kernels' plain versions), or of one rank
    of a data-parallel run over ``mesh`` (a ``parallel.mesh.Mesh``: then
    ``cfg.n_envs`` is the global count and this rank holds its
    ``n_envs // size`` envs, children ``rank * n_local ..`` of
    ``split(k_env, n_envs)``).

    init_fn(key) -> A2CState, ``key`` the two words of a Threefry key: the
    envs reset from ``split(k_env, n_envs)``; the weights are drawn
    orthogonal from a ``torch.Generator`` seeded with the ``k_net`` words
    (``load_reference_a2c_state`` carries the reference's instead).
    update_fn(ts, record=None) -> (A2CState, metrics): one update; the
    metrics are the reference's keys as 0-dim tensors on the device. A dict
    given as ``record`` is filled with the rollout's ``obs``, ``mask``,
    ``action``, ``value``, ``reward``, ``done`` (``[T, E, ...]``) and the
    discounted ``returns``."""
    if mesh is not None and cfg.n_envs % mesh.size:
        raise ValueError(f"n_envs={cfg.n_envs} not divisible by mesh size {mesh.size}")
    n_local = cfg.n_envs if mesh is None else cfg.n_envs // mesh.size
    first = 0 if mesh is None else mesh.rank * n_local
    dev = run_device((), device)

    def init_fn(key) -> A2CState:
        k_net, k_env, k_run = KR.split_keys(key, 3)
        net = ActorCritic(hooks.n_actions, hooks.obs_dim, tuple(cfg.hidden),
                          generator=torch.Generator().manual_seed((k_net[0] << 32) | k_net[1]))
        net = net.to(dev)
        return A2CState(params=net, opt_state=rmsprop_init(param_list(net)),
                        env_states=hooks.reset(_keys(k_env, n_local, dev, first)), key=k_run,
                        obs_stats=init_stats(hooks.obs_dim, dev), update_idx=0)

    def obs_mask(env_states, obs_stats):
        obs = hooks.observe(env_states)
        if cfg.normalize_obs:
            obs = normalize(obs_stats, obs)
        return obs, hooks.action_mask(env_states)

    def update_fn(ts: A2CState, record: dict | None = None):
        key, k_roll = KR.split_keys(ts.key, 2)
        if mesh is not None:
            k_roll = KR.fold_in(*k_roll, mesh.rank)
        net, env_states = ts.params, ts.env_states
        T, E = cfg.rollout_len, n_local
        buf = {"obs": torch.empty(T, E, hooks.obs_dim, device=dev),
               "mask": torch.empty(T, E, hooks.n_actions, dtype=torch.bool, device=dev),
               "action": torch.empty(T, E, dtype=torch.int64, device=dev),
               "value": torch.empty(T, E, device=dev), "reward": torch.empty(T, E, device=dev),
               "done": torch.empty(T, E, dtype=torch.bool, device=dev)}
        with torch.no_grad():
            for t, k in enumerate(KR.split_keys(k_roll, T)):
                obs, mask = obs_mask(env_states, ts.obs_stats)
                logits, value = net(obs, mask)
                action, _ = categorical(k, logits)
                env_states, reward, done = hooks.step_autoreset(env_states, action)
                for name, v in (("obs", obs), ("mask", mask), ("action", action),
                                ("value", value), ("reward", reward.to(_F32)), ("done", done)):
                    buf[name][t].copy_(v)
            _, last_v = net(*obs_mask(env_states, ts.obs_stats))
            returns = torch.empty_like(buf["value"])
            carry, nonterm = last_v, 1.0 - buf["done"].to(_F32)
            for t in reversed(range(T)):
                carry = buf["reward"][t] + cfg.gamma * carry * nonterm[t]
                returns[t] = carry
            adv = (returns - buf["value"]).reshape(-1)
        if record is not None:
            record.update(buf, returns=returns)

        o, m = buf["obs"].reshape(T * E, -1), buf["mask"].reshape(T * E, -1)
        logits, v = net(o, m)
        logp = torch.log_softmax(logits, -1)
        pg = -(logp.gather(1, buf["action"].reshape(-1, 1))[:, 0] * adv).mean()
        vf = 0.5 * ((v - returns.reshape(-1)) ** 2).mean()
        ent = -torch.where(m, torch.exp(logp) * logp, 0.0).sum(-1).mean()
        loss = pg + cfg.vf_coef * vf - cfg.ent_coef * ent
        params = param_list(net)
        grads = torch.autograd.grad(loss, params)
        if mesh is not None:
            grads, = mean_grads(mesh, grads)
        opt = rmsprop_update(params, grads, ts.opt_state, cfg.lr, cfg.max_grad_norm)
        obs_stats = (update_stats(ts.obs_stats, o, mesh) if cfg.normalize_obs else ts.obs_stats)
        out = A2CState(params=net, opt_state=opt, env_states=env_states, key=key,
                       obs_stats=obs_stats, update_idx=ts.update_idx + 1)
        return out, {"loss": loss.detach(), "pg_loss": pg.detach(), "vf_loss": vf.detach(),
                     "entropy": ent.detach(), "mean_reward": buf["reward"].mean(),
                     "episodes": buf["done"].sum()}

    return init_fn, update_fn


def load_reference_a2c_state(hooks: EnvHooks, cfg: A2CConfig, ref: dict, *, device=None):
    """The reference's ``A2CState``, given as numpy arrays, as the port's.

    ``ref`` holds ``params`` (the flax param dict), ``nu`` (optax's RMSprop
    moments, a tree of the same structure), ``obs_stats`` (``(mean, var,
    count)``), ``key`` (``jax.random.key_data``: two words),
    ``update_idx`` and ``env_states`` (the flagship env's packed rows
    ``{"cards", "ints", "rng"}``, else the SimEnvState's fields)."""
    dev = run_device((), device)
    net = load_flax_params(ActorCritic(hooks.n_actions, hooks.obs_dim, tuple(cfg.hidden)),
                           ref["params"]).to(dev)
    return A2CState(
        params=net, opt_state=RMSPropState([v.to(dev) for v in _flax_leaves(net, ref["nu"])]),
        env_states=reference_env_states(hooks, ref["env_states"], dev),
        key=reference_key(ref["key"]), obs_stats=reference_stats(ref["obs_stats"], dev),
        update_idx=int(np.asarray(ref["update_idx"])))


def train(num_updates: int = 16, cfg: A2CConfig | None = None, seed: int = 0,
          hooks: EnvHooks | None = None, *, device=None):
    """Training on one device (default: the card) from ``key(seed)``.
    Returns (A2CState, last metrics)."""
    cfg = cfg or A2CConfig()
    hooks = hooks or sim_env_hooks()
    init_fn, update_fn = make_a2c(hooks, cfg, device=device)
    ts = init_fn([int(w) for w in KR.seed_key(seed, device="cpu")])
    metrics = None
    for _ in range(num_updates):
        ts, metrics = update_fn(ts)
    return ts, metrics
