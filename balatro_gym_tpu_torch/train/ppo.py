"""PPO learner on batched envs, on one device.

Port of ``balatro_gym_tpu/train/ppo.py``. One update is: an optional
staggered reset of some envs, a rollout of ``rollout_len`` steps of every
env with the policy in the loop, the running observation and return
statistics, GAE, and ``epochs`` x ``minibatches`` steps of clipped PPO with
Adam. The hyperparameters and their defaults are the reference's.

The reference compiles an update into one XLA program; here it runs
eagerly:

* the net is an ``nn.Module`` (``train/networks.py``) whose parameters are
  the learner's parameters; gradients come from autograd;
* the optimizer is optax's ``chain(clip_by_global_norm(max_grad_norm),
  adam(lr, eps=1e-5))`` written out (:func:`adam_update`): the clip is a
  select on ``g_norm < max_norm``, Adam's bias corrections are float32 with
  the incremented count, and the linear ``lr`` schedule counts the steps
  applied. A minibatch that the KL gate skips advances no count (with
  ``kl_target`` set, the gate reads each minibatch's approx-KL on the
  host: one wait for the card a minibatch);
* every random draw comes from the Threefry key carried in the state
  (``ops/kernel_rng.py``), split as the reference splits it, so the same
  state gives the same env steps, actions and shuffles as the reference.

Two rollouts, as in the reference. With ``fused_rollout`` (the flagship env
only) a step is the collection of ``ops/fused_policy_rollout.py``: the
policy forward, the sampler kernel and the env step kernel K3a, which also
writes the next step's observation and mask; the env state stays packed
between updates. Otherwise the hooks' ``observe``, ``action_mask`` and
``step_autoreset`` run and ``jax.random.categorical``'s draw is written out
(:func:`categorical`): the sim env's path, and the flagship env's, whose
step is ``env_step_kernel`` and whose observation and mask are K3b on a
card.

Neither rollout synchronises with the card inside its step loop: the
generic rollout's step keys are split on the host before it, the fused
rollout's on the device from the key's two words (copied there from pinned
memory), and every per-step value stays on the device.

On a card, the fused rollout over the kernels' own wrappers (``fused_ops``
None) is one CUDA graph (a :class:`StageGraph`), captured on the
learner's first update and replayed once an update, so the host enqueues a
collection in one call instead of ~40 torch calls a step. Its kernels and
their order are the eager loop's, which runs on the CPU and over other
``fused_ops``; the generic rollout stays eager. Shuffle + SGD is a second
such graph on a card wherever its steps are fixed on the host (no
``mesh``, no KL gate), on either rollout: the numbers the host sets each
update (the permutations' key words, the entropy coefficient, each step's
lr and the reciprocals of Adam's bias corrections) reach it as one vector
copied from pinned memory. The eager stage, on the CPU, a mesh's ranks and
under the KL gate, runs the same body on python numbers.

Given a data-parallel ``mesh`` (``parallel/mesh.py``), an update is the
reference's ``axis_name`` path: each rank steps its own shard of the envs
with the same parameters, folds its rank into the rollout, shuffle and
reset keys, merges the statistics across ranks, and takes each minibatch's
step on the gradients averaged over the ranks in one all-reduce, which
carries the minibatch's approx-KL too, so every rank takes the same KL
decision and applies the same bits.

Every entry point runs on the card unless the caller passes
``device="cpu"``, where the kernels' plain versions run; on a card the
collection launches its kernels or raises.
"""
from __future__ import annotations

import copy
import dataclasses
import functools
from typing import Any, Callable, NamedTuple

import numpy as np
import torch

from balatro_gym_tpu_torch.core.device import run_device
from balatro_gym_tpu_torch.engine.full_env import where_envs
from balatro_gym_tpu_torch.ops import kernel_rng as KR
from balatro_gym_tpu_torch.train.networks import (
    ActorCritic, StructuredActorCritic, load_flax_params)
from balatro_gym_tpu_torch.train.normalize import (
    RunningStats, init_stats, normalize, normalize_reward, update_stats)
from balatro_gym_tpu_torch.utils import profiling as P

_F32 = torch.float32
_TINY = float(np.finfo(np.float32).tiny)


class EnvHooks(NamedTuple):
    """Batched env functions: every state holds a batch of envs."""

    reset: Callable[..., Any]           # keys [B, 2] -> state
    step_autoreset: Callable[..., Any]  # (state, action [B]) -> (state, reward, done)
    observe: Callable[..., Any]         # state -> [B, D] float32
    action_mask: Callable[..., Any]     # state -> [B, A] bool
    n_actions: int
    obs_dim: int
    # Optional step without autoreset: done envs keep their final state.
    # evaluate_policy prefers it, so terminal-step ante advances count.
    step: Any = None
    # The fused collection's (observe, sample, step) on packed rows; None:
    # the kernels' wrappers (observe_fused, sample_fused, step_fused)
    fused_ops: Any = None


@dataclasses.dataclass(frozen=True)
class PPOConfig:
    """The reference's ``PPOConfig``, field for field (its docstrings say
    what each does), less ``fused_interpret``: ``device="cpu"`` runs the
    fused collection's plain versions."""

    n_envs: int = 1024
    rollout_len: int = 16
    epochs: int = 4
    minibatches: int = 4
    lr: float = 3e-4
    gamma: float = 0.99
    gae_lambda: float = 0.95
    clip_eps: float = 0.2
    ent_coef: float = 0.01
    vf_coef: float = 0.5
    max_grad_norm: float = 0.5
    total_updates: int = 0
    ent_coef_final: float = -1.0
    lr_final: float = -1.0
    kl_target: float = 0.0
    repeat_penalty: float = 0.0
    cycle_penalty: float = 0.0
    reset_envs_every: int = 0
    hidden: tuple = (256, 256)
    normalize_obs: bool = True
    normalize_reward: bool = True
    bf16_compute: bool = False
    fused_rollout: bool = False
    structured_net: bool = False
    env_shuffle: bool = False


@dataclasses.dataclass
class AdamState:
    """optax's Adam state: ``count`` steps applied (also the lr schedule's
    count) and the moments, one tensor per parameter in
    :func:`param_list` order."""

    count: int
    mu: list
    nu: list


@dataclasses.dataclass
class TrainState:
    """The learner's state. ``params`` is the policy module (its parameters
    are the learner's); an update changes them and the Adam moments in
    place, so take ``copy.deepcopy`` of a state to keep it. ``env_states``
    is a batched env state (packed rows, the dict of
    ``pack_full_state``, on the fused path); ``key`` the two 32-bit words of
    the Threefry key."""

    params: torch.nn.Module
    opt_state: AdamState
    env_states: Any
    key: tuple
    update_idx: int
    obs_stats: RunningStats
    ret_stats: RunningStats
    ret_carry: torch.Tensor   # [n_envs] running discounted return


class Transition(NamedTuple):
    """A rollout, each field ``[rollout_len, n_envs, ...]``."""

    obs: torch.Tensor
    mask: torch.Tensor
    action: torch.Tensor
    log_prob: torch.Tensor
    value: torch.Tensor
    reward: torch.Tensor    # the training reward (normalised and shaped)
    done: torch.Tensor


# ---------------------------------------------------------------------------
# Optimizer: optax.chain(clip_by_global_norm, adam), written out
# ---------------------------------------------------------------------------


def param_list(net):
    """The parameters in flax's leaf order: ``Dense_i`` bias, then kernel
    (``weight``)."""
    return [p for lin in net.dense_layers() for p in (lin.bias, lin.weight)]


def adam_init(params) -> AdamState:
    return AdamState(0, [torch.zeros_like(p) for p in params],
                     [torch.zeros_like(p) for p in params])


def linear_schedule(init: float, end: float, steps: int):
    """``optax.linear_schedule(init, end, steps)`` of a step count, in
    float32."""
    def lr(count):
        c = np.float32(min(max(count, 0), steps))
        frac = np.float32(1) - c / np.float32(steps)
        return float(np.float32(init - end) * frac + np.float32(end))
    return lr


def clip_by_global_norm(grads, max_norm: float):
    """``optax.clip_by_global_norm``: the gradients scaled by ``max_norm /
    norm`` where their global norm is not below ``max_norm`` (a select, no
    host sync)."""
    g_norm = torch.sqrt(sum((g * g).sum() for g in grads))
    keep = g_norm < max_norm
    return [torch.where(keep, g, g / g_norm * max_norm) for g in grads]


def adam_bias_corrections(count: int, b1=0.9, b2=0.999) -> tuple:
    """Adam's ``(1 - b1**count, 1 - b2**count)`` in float32, as python
    floats."""
    return tuple(float(np.float32(1) - np.float32(b) ** np.float32(count)) for b in (b1, b2))


def adam_update(params, grads, st: AdamState, lr, max_norm: float | None,
                b1=0.9, b2=0.999, eps=1e-5, inv_bc=None) -> AdamState:
    """One step of ``chain(clip_by_global_norm(max_norm), adam(lr, eps))``,
    or of plain ``adam(lr, eps)`` with ``max_norm=None``: the parameters
    change in place; returns the new state. ``lr`` is a float or a 0-dim
    tensor. The moments are divided by the bias corrections at the
    incremented count (:func:`adam_bias_corrections`), or, given
    ``inv_bc``, multiplied by these reciprocals in float32: 0-dim tensors,
    where a CUDA graph replays the step at other counts. A card divides by
    a python number as that product, so the two forms agree bit for bit
    there."""
    if max_norm is not None:
        grads = clip_by_global_norm(grads, max_norm)
    count = st.count + 1
    if inv_bc is None:
        bc1, bc2 = adam_bias_corrections(count, b1, b2)
    mus, nus = [], []
    with torch.no_grad():
        for p, g, mu, nu in zip(params, grads, st.mu, st.nu):
            mu = (1 - b1) * g + b1 * mu
            nu = (1 - b2) * (g * g) + b2 * nu
            if inv_bc is None:
                step = (mu / bc1) / (torch.sqrt(nu / bc2) + eps)
            else:
                step = (mu * inv_bc[0]) / (torch.sqrt(nu * inv_bc[1]) + eps)
            p.add_((-lr) * step)
            mus.append(mu)
            nus.append(nu)
    return AdamState(count, mus, nus)


@dataclasses.dataclass
class RMSPropState:
    """optax's ``rmsprop`` state: the second moments ``nu``, one tensor per
    parameter in :func:`param_list` order."""

    nu: list


def rmsprop_init(params) -> RMSPropState:
    return RMSPropState([torch.zeros_like(p) for p in params])


def rmsprop_update(params, grads, st: RMSPropState, lr: float, max_norm: float | None,
                   decay: float = 0.99, eps: float = 1e-5) -> RMSPropState:
    """One step of ``chain(clip_by_global_norm(max_norm), rmsprop(lr,
    decay, eps))`` as optax 0.2.6 defines it (``eps_in_sqrt=True``, no
    bias correction, ``nu`` starting at 0): ``nu = (1 - decay) * g**2 +
    decay * nu``, then ``p -= lr * g * rsqrt(nu + eps)``. The parameters
    change in place; returns the new state."""
    if max_norm is not None:
        grads = clip_by_global_norm(grads, max_norm)
    nus = []
    with torch.no_grad():
        for p, g, nu in zip(params, grads, st.nu):
            nu = (1 - decay) * (g * g) + decay * nu
            p.add_((-lr) * (torch.rsqrt(nu + eps) * g))
            nus.append(nu)
    return RMSPropState(nus)


def mean_grads(mesh, grads, *extra):
    """The gradients (and any 0-dim ``extra`` values) averaged over the
    mesh's ranks in one all-reduce of a flat buffer: (grads, *extra)."""
    flat = mesh.sum_(torch.cat([g.reshape(-1) for g in grads]
                               + [x.reshape(1).to(grads[0].dtype) for x in extra]))
    flat = flat / mesh.size
    out, i = [], 0
    for g in grads:
        out.append(flat[i:i + g.numel()].view_as(g))
        i += g.numel()
    return (out, *flat[i:])


# ---------------------------------------------------------------------------
# The sampler of the generic rollout
# ---------------------------------------------------------------------------


def categorical(key, logits):
    """``jax.random.categorical(key, logits)`` over ``[B, A]`` logits and
    the log-softmax at the drawn action: (action ``[B]`` int64, log_prob
    ``[B]``). Element ``(b, a)`` is perturbed by ``-log(-log(u))``, ``u =
    uniform(bits[b * A + a], tiny, 1)`` of ``jax.random.bits(key, (B,
    A))``; ``key`` is two python ints."""
    n, a = logits.shape
    with P.span("sample.bits"):
        bits = KR.random_bits32(*key, torch.arange(n * a, device=logits.device).view(n, a))
    with P.span("sample.draw"):
        u = KR.uniform_f32(bits, _TINY, 1.0)
        action = (logits + (-torch.log(-torch.log(u)))).argmax(1)
        log_prob = torch.log_softmax(logits, 1).gather(1, action[:, None])[:, 0]
    return action, log_prob


def gae(traj: Transition, last_value, gamma: float, gae_lambda: float):
    """Generalised advantage estimation over ``[T, E]`` rewards, values
    and dones, from the value of the state after the last step: (advantages,
    returns)."""
    adv = torch.empty_like(traj.value)
    nonterm = 1.0 - traj.done.to(_F32)
    gae_t, next_value = torch.zeros_like(last_value), last_value
    for t in reversed(range(traj.value.shape[0])):
        delta = traj.reward[t] + gamma * next_value * nonterm[t] - traj.value[t]
        gae_t = delta + gamma * gae_lambda * nonterm[t] * gae_t
        adv[t] = gae_t
        next_value = traj.value[t]
    return adv, adv + traj.value


def ppo_loss(net, batch, ent_coef: float, cfg: PPOConfig):
    """The clipped PPO loss of a minibatch ``(Transition, advantages,
    returns)``: (total, (pg_loss, v_loss, entropy, approx_kl)), all but
    ``total`` detached. Advantages are standardised with the population
    std; the entropy sums over legal actions only."""
    t, adv, ret = batch
    logits, value = net(t.obs, t.mask)
    log_all = torch.log_softmax(logits, -1)
    log_prob = log_all.gather(1, t.action.to(torch.int64)[:, None])[:, 0]
    ratio = torch.exp(log_prob - t.log_prob)
    adv_n = (adv - adv.mean()) / (adv.std(correction=0) + 1e-8)
    pg1 = ratio * adv_n
    pg2 = ratio.clamp(1 - cfg.clip_eps, 1 + cfg.clip_eps) * adv_n
    pg_loss = -torch.minimum(pg1, pg2).mean()
    v_clip = t.value + (value - t.value).clamp(-cfg.clip_eps, cfg.clip_eps)
    v_loss = 0.5 * torch.maximum((value - ret) ** 2, (v_clip - ret) ** 2).mean()
    ent = -torch.where(t.mask, torch.exp(log_all) * log_all, 0.0).sum(-1).mean()
    total = pg_loss + cfg.vf_coef * v_loss - ent_coef * ent
    # Schulman's approx-KL E[(r - 1) - log r]: for the gate and the metrics
    approx_kl = ((ratio - 1.0) - (log_prob - t.log_prob)).mean().detach()
    return total, (pg_loss.detach(), v_loss.detach(), ent.detach(), approx_kl)


# ---------------------------------------------------------------------------
# The learner
# ---------------------------------------------------------------------------


def _make_net(hooks: EnvHooks, cfg: PPOConfig, generator):
    dt = torch.bfloat16 if cfg.bf16_compute else None
    if cfg.structured_net:
        return StructuredActorCritic(hooks.n_actions, hooks.obs_dim, compute_dtype=dt,
                                     generator=generator)
    return ActorCritic(hooks.n_actions, hooks.obs_dim, tuple(cfg.hidden), compute_dtype=dt,
                       generator=generator)


def _check(hooks: EnvHooks, cfg: PPOConfig, n_local: int | None = None):
    n = cfg.n_envs if n_local is None else n_local
    if cfg.env_shuffle and n % cfg.minibatches:
        raise ValueError("env_shuffle slices minibatches along the env axis: "
                         f"{n} envs % minibatches={cfg.minibatches}")
    if cfg.fused_rollout:
        from balatro_gym_tpu_torch.ops import fused_policy_rollout as FP
        if (hooks.obs_dim, hooks.n_actions) != (FP.OBS_DIM, FP.N_ACTIONS):
            raise ValueError("fused_rollout supports the flagship full env only")


def _keys(key, n, dev, first: int = 0):
    """Children ``first .. first + n - 1`` of ``split(key, N)`` (any ``N``
    past them) as a ``[n, 2]`` tensor of words on ``dev``."""
    return torch.stack(KR.split_child(*key, torch.arange(first, first + n, device=dev)), -1)


def _to_device(values, dtype, dev):
    """Host numbers as a 1-d ``dtype`` tensor on ``dev``: to a card from
    pinned memory, without a host sync."""
    t = torch.tensor(values, dtype=dtype)
    return t.pin_memory().to(dev, non_blocking=True) if dev.type == "cuda" else t


def lr_schedule(cfg: PPOConfig):
    """The learning rate of an Adam step count: linear from ``cfg.lr`` to
    ``cfg.lr_final`` over the run's steps where both are set, else
    ``cfg.lr``."""
    if cfg.lr_final >= 0.0 and cfg.total_updates > 0:
        return linear_schedule(cfg.lr, cfg.lr_final,
                               cfg.total_updates * cfg.epochs * cfg.minibatches)
    return lambda count: cfg.lr                                     # noqa: E731


def ent_coef_at(cfg: PPOConfig, update_idx: int) -> float:
    """The entropy coefficient of update ``update_idx``: linear from
    ``cfg.ent_coef`` to ``cfg.ent_coef_final`` over the run where both are
    set, in float32."""
    if cfg.ent_coef_final >= 0.0 and cfg.total_updates > 0:
        frac = np.clip(np.float32(update_idx) / np.float32(cfg.total_updates),
                       np.float32(0), np.float32(1))
        return float(np.float32(cfg.ent_coef)
                     + np.float32(cfg.ent_coef_final - cfg.ent_coef) * frac)
    return float(np.float32(cfg.ent_coef))


def make_sgd(cfg: PPOConfig, dev, mesh=None):
    """Shuffle + SGD, the last stage of :func:`make_ppo`'s update:
    ``sgd(net, opt, traj, adv, ret, keys, ent_coef, sched) -> (AdamState,
    metrics)``. ``cfg.epochs`` epochs over the rollout, each cut by a
    permutation (``keys``: the epoch's two key words as 0-dim int64
    tensors) into ``cfg.minibatches`` minibatches; each minibatch a PPO
    loss, its gradients and an Adam step at ``sched(count) = (lr, the
    reciprocals of the bias corrections or None)``, ``count`` the steps
    applied before it. The
    metrics are the minibatches' means of (loss, pg_loss, vf_loss, entropy,
    approx_kl, kl_skipped), one ``[6]`` tensor. With a ``mesh`` the
    gradients and approx-KL are averaged over the ranks; with
    ``cfg.kl_target`` a minibatch whose approx-KL exceeds it stops the
    steps (read on the host)."""
    flags = (torch.zeros((), device=dev), torch.ones((), device=dev))    # kl_skipped

    def sgd(net, opt, traj, adv, ret, keys, ent_coef, sched):
        T, E = traj.action.shape
        params, stop, rows = param_list(net), False, []
        for kt in keys:
            with P.span("ppo.sgd.shuffle"):
                if cfg.env_shuffle:
                    perm = KR.permutation(*kt, E).view(cfg.minibatches, -1)
                    pick = [lambda x, idx=idx: x[:, idx].reshape((-1,) + x.shape[2:])
                            for idx in perm]
                else:
                    perm = KR.permutation(*kt, T * E).view(cfg.minibatches, -1)
                    pick = [lambda x, idx=idx: x.reshape((T * E,) + x.shape[2:])[idx]
                            for idx in perm]
            for take in pick:
                with P.span("ppo.sgd.loss"):
                    batch = (Transition(*(take(x) for x in traj)), take(adv), take(ret))
                    total, aux = ppo_loss(net, batch, ent_coef, cfg)
                if mesh is None:
                    if cfg.kl_target > 0.0:
                        stop = stop or bool(aux[-1] > cfg.kl_target)
                    if not stop:
                        with P.span("ppo.sgd.backward"):
                            grads = torch.autograd.grad(total, params)
                elif not stop:      # the gate reads the KL averaged over the ranks
                    with P.span("ppo.sgd.backward"):
                        grads, kl = mean_grads(mesh, torch.autograd.grad(total, params), aux[-1])
                    if cfg.kl_target > 0.0:
                        stop = bool(kl > cfg.kl_target)
                if not stop:
                    with P.span("ppo.sgd.adam"):
                        lr, inv_bc = sched(opt.count)
                        opt = adam_update(params, grads, opt, lr, cfg.max_grad_norm,
                                          inv_bc=inv_bc)
                rows.append(torch.stack([total.detach(), *aux, flags[stop]]))
        return opt, torch.stack(rows).mean(0)
    return sgd


def sgd_scalars(cfg: PPOConfig, k_perm, update_idx: int, count: int) -> list:
    """The numbers the host sets for one shuffle + SGD of a fixed
    ``cfg.epochs x cfg.minibatches`` steps (no KL gate), as python numbers in
    the order :func:`read_sgd_scalars` reads them: each epoch's two key
    words (the children of ``split(k_perm, cfg.epochs)``, hashed from the
    python ints of ``k_perm``), the entropy coefficient of update
    ``update_idx``, then for each step the lr and the float32 reciprocals of
    Adam's two bias corrections, the steps counted from ``count``."""
    lr_at = lr_schedule(cfg)
    out = [w for i in range(cfg.epochs) for w in KR.split_child(*k_perm, i)]
    out.append(ent_coef_at(cfg, update_idx))
    for c in range(count, count + cfg.epochs * cfg.minibatches):
        out += [lr_at(c), *(float(np.float32(1) / np.float32(bc))
                            for bc in adam_bias_corrections(c + 1))]
    return out


def read_sgd_scalars(cfg: PPOConfig, scalars, count: int) -> tuple:
    """(keys, ent_coef, sched) of ``make_sgd``'s stage from a float64 tensor
    of :func:`sgd_scalars` (which holds the key words and float32 values
    exactly): the key words as 0-dim int64 tensors, the rest as 0-dim
    float32 tensors, ``sched`` counting the steps from ``count``."""
    n = 2 * cfg.epochs
    words, f = scalars[:n].to(torch.int64), scalars[n:].to(_F32)
    keys = [(words[i], words[i + 1]) for i in range(0, n, 2)]

    def sched(c):
        i = 1 + 3 * (c - count)
        return f[i], (f[i + 1], f[i + 2])
    return keys, f[0], sched


def _tensors(x) -> list:
    """The tensors of a stage's inputs in a fixed order: a policy's
    parameters, a dict's values by key, a dataclass's fields, a tuple's or
    list's items."""
    if isinstance(x, torch.nn.Module):
        return param_list(x)
    if torch.is_tensor(x):
        return [x]
    if isinstance(x, dict):
        x = [x[k] for k in sorted(x)]
    elif dataclasses.is_dataclass(x):
        x = [getattr(x, f.name) for f in dataclasses.fields(x)]
    elif not isinstance(x, (tuple, list)):
        return []
    return [t for v in x for t in _tensors(v)]


def _static_copy(x, keep):
    """A stage's inputs to capture it on: the policy deep-copied, every
    tensor cloned but those in ``keep``, the containers rebuilt."""
    if isinstance(x, torch.nn.Module):
        return copy.deepcopy(x)
    if torch.is_tensor(x):
        return x if any(x is k for k in keep) else x.clone()
    if isinstance(x, dict):
        return {k: _static_copy(v, keep) for k, v in x.items()}
    if dataclasses.is_dataclass(x):
        return dataclasses.replace(x, **{f.name: _static_copy(getattr(x, f.name), keep)
                                         for f in dataclasses.fields(x)})
    if isinstance(x, tuple) and hasattr(x, "_fields"):                 # a NamedTuple
        return type(x)(*(_static_copy(v, keep) for v in x))
    if isinstance(x, (tuple, list)):
        return type(x)(_static_copy(v, keep) for v in x)
    return x


class StageGraph:
    """A stage of the learner's update on a card as one CUDA graph,
    replayed once a call: the fused collection and shuffle + SGD.

    ``body(*args)`` is the stage. The first call runs it once on a side
    stream (the warm-up: the kernels' loads, cuBLAS's workspace, autograd's
    and the allocator's buffers; its outputs dropped), then captures it on
    static inputs: a copy of ``args`` (:func:`_static_copy`) less the
    tensors that ``shared()`` lists, which are their own static tensors
    (the collection graph's buffers, which every collection rewrites in
    place). Every call copies each input tensor into its static tensor
    where it is not that tensor already (so a restored or copied
    ``TrainState`` replays as well as the last one), replays the graph on
    the current stream and returns ``finish(args, out)``: ``out`` is the
    capture's outputs, the graph's own buffers, which the next replay
    overwrites. A failed capture raises.

    The kernels' wrappers count their launches (``.launches``) in the
    warm-up and in the capture, and not in a replay, which launches no
    wrapper; ``replays`` counts the replays. Spans: ``<span>.capture``
    around the first call's warm-up and capture (the stage's own spans are
    kept then, twice), ``<span>.replay`` around each replay."""

    def __init__(self, span: str, body, finish, shared=tuple):
        self.span, self.body, self.finish, self.shared = span, body, finish, shared
        self.graph, self.replays = None, 0

    def __call__(self, *args):
        if self.graph is None:
            with P.span(self.span + ".capture"):
                self.args = _static_copy(args, self.shared())
                self.static = _tensors(self.args)
                side = torch.cuda.Stream()
                side.wait_stream(torch.cuda.current_stream())
                with torch.cuda.stream(side):
                    self.body(*self.args)
                torch.cuda.current_stream().wait_stream(side)
                graph = torch.cuda.CUDAGraph()
                # thread_local: a data-parallel rank's communicator threads keep querying the card
                with torch.cuda.graph(graph, capture_error_mode="thread_local"):
                    self.out = self.body(*self.args)
                self.graph = graph
        with P.span(self.span + ".replay"), torch.no_grad():
            moved = [(s, x) for s, x in zip(self.static, _tensors(args)) if s is not x]
            torch._foreach_copy_([s for s, _ in moved], [x for _, x in moved])
            self.graph.replay()
            self.replays += 1
            return self.finish(args, self.out)


def _collection_outputs(args, out):
    """The fused rollout's outputs from its graph: the env rows and the
    return carry cloned; the trajectory, raw rewards, return carries and
    last observation and mask the graph's own buffers."""
    env, traj, raw, rets, carry, obs, mask = out
    return ({k: v.clone() for k, v in env.items()}, traj, raw, rets, carry.clone(), obs, mask)


def _where_lanes(lanes, a, b):
    """Per-env select of two batched env states: packed rows (the env axis
    last) or what ``full_env.where_envs`` takes."""
    if isinstance(a, dict):
        return {k: torch.where(lanes, a[k], b[k]) for k in a}
    return where_envs(lanes, a, b)


def make_ppo(hooks: EnvHooks, cfg: PPOConfig, *, device=None, mesh=None):
    """(init_fn, update_fn, policy_fn) of one PPO run on one device, or of
    one rank of a data-parallel run over ``mesh``.

    init_fn(key) -> TrainState, ``key`` the two words of a Threefry key.
    The env states and statistics are the reference's ``init_fn``'s; the
    weights cannot be (flax's initialiser is not torch's): they are drawn
    orthogonal from a ``torch.Generator`` seeded with the ``k_net`` words.
    update_fn(ts, record=None) -> (TrainState, metrics): one update; the
    metrics dict has the reference's keys, as 0-dim tensors on the device.
    Given a dict as ``record``, it is filled with the rollout's
    ``Transition`` (``traj``), its raw rewards (``raw``), the return carry
    of every step (``rets``) and the advantages (``adv``) (copies of the
    graph's buffers where the collection is one), and, on a card,
    ``events``: (stage, CUDA event) pairs recorded at the start and after
    each stage (collection, stats, last value + GAE, shuffle + SGD); the
    tracer (``utils/profiling.py``) is on for such an update. The update's
    spans: ``ppo.update`` around ``ppo.collect`` (a step's
    ``ppo.collect.observe``, ``.policy``, ``.sample``, ``.env``,
    ``.store``; :func:`categorical`'s ``sample.bits`` and ``sample.draw``;
    where the collection is a CUDA graph, ``ppo.collect.capture`` on the
    first update, which keeps the step spans, and ``ppo.collect.replay``),
    ``ppo.stats``, ``ppo.gae`` and ``ppo.sgd`` (an epoch's
    ``ppo.sgd.shuffle``, a minibatch's ``ppo.sgd.loss``, ``.backward``,
    ``.adam``; where the stage is a CUDA graph, ``ppo.sgd.capture`` on the
    first update, which keeps those spans, and ``ppo.sgd.replay``); the four
    stages also record the CUDA events. ``update_fn.collection`` is the
    rollout it calls, a :class:`StageGraph` (whose ``replays`` counts its
    replays) where the collection is a CUDA graph; ``update_fn.sgd`` the
    shuffle + SGD stage, a :class:`StageGraph` where that is one: on a card
    with no ``mesh`` and ``cfg.kl_target == 0``.
    policy_fn(params, obs, mask) -> (logits, value).

    device: where to run (default: the card; it raises where there is none;
    ``device="cpu"`` runs the fused collection's plain versions).

    mesh: a ``parallel.mesh.Mesh``; ``cfg.n_envs`` is then the global count,
    and this rank holds envs ``rank * n_local .. (rank + 1) * n_local - 1``
    of it (``n_local = n_envs // size``): ``init_fn`` resets those children
    of ``split(k_env, n_envs)``, and ``update_fn`` reduces as the
    reference's ``update_fn(ts, axis_name)`` does. The metrics are then
    the means over ranks, ``episodes`` their sum.
    """
    if mesh is not None and cfg.n_envs % mesh.size:
        raise ValueError(f"n_envs={cfg.n_envs} not divisible by mesh size {mesh.size}")
    n_local = cfg.n_envs if mesh is None else cfg.n_envs // mesh.size
    _check(hooks, cfg, n_local)
    dev = run_device((), device)
    fused = cfg.fused_rollout
    lr_at = lr_schedule(cfg)
    store_dt = torch.bfloat16 if (fused and cfg.bf16_compute) else _F32
    # the fused collection is a CUDA graph on a card over the kernels' own wrappers
    graphed = fused and dev.type == "cuda" and hooks.fused_ops is None
    # shuffle + SGD is one where its steps are fixed on the host: no mesh, no KL gate
    sgd_graphed = dev.type == "cuda" and mesh is None and cfg.kl_target == 0.0
    if fused:
        from balatro_gym_tpu_torch.ops import fused_full_rollout as FF
        from balatro_gym_tpu_torch.ops import fused_policy_rollout as FP
        observe_p, sample_p, step_p = hooks.fused_ops or (
            functools.partial(f, device=dev)
            for f in (FP.observe_fused, FP.sample_fused, FP.step_fused))

    def reset_envs(keys):
        st = hooks.reset(keys)
        if fused:
            return {k: v.contiguous() for k, v in FF.pack_full_state(st).items()}
        return st

    def init_fn(key) -> TrainState:
        k_net, k_env, k_run = KR.split_keys(key, 3)
        net = _make_net(hooks, cfg, torch.Generator().manual_seed((k_net[0] << 32) | k_net[1]))
        net = net.to(dev)
        first = 0 if mesh is None else mesh.rank * n_local
        return TrainState(
            params=net, opt_state=adam_init(param_list(net)),
            env_states=reset_envs(_keys(k_env, n_local, dev, first)), key=k_run, update_idx=0,
            obs_stats=init_stats(hooks.obs_dim, dev), ret_stats=init_stats(device=dev),
            ret_carry=torch.zeros(n_local, device=dev))

    def shape_reward(reward, action, prev_a):
        """The repeat penalty (training reward only)."""
        if not cfg.repeat_penalty:
            return reward
        rep = (action == prev_a) & (reward <= 0.0)
        return reward - cfg.repeat_penalty * rep.to(_F32)

    def cycle_shape(train_reward, raw, action, done, alo, ahi):
        """The since-last-reward action-set penalty, after reward
        normalisation; the bitsets are 32-bit words in int64."""
        if not cfg.cycle_penalty:
            return train_reward, alo, ahi
        a = action.to(torch.int64)
        low = a < 32
        sh = a & 31
        seen = ((torch.where(low, alo, ahi) >> sh) & 1) != 0
        shaped = train_reward - cfg.cycle_penalty * (seen & (raw <= 0.0)).to(_F32)
        bit = torch.ones_like(a) << sh
        nlo = alo | torch.where(low, bit, 0)
        nhi = ahi | torch.where(low, 0, bit)
        reset = (raw > 0.0) | done
        return shaped, torch.where(reset, 0, nlo), torch.where(reset, 0, nhi)

    def rollout(net, env_states, key, obs_stats, ret_stats, ret_carry):
        """Returns (env_states, traj, raw rewards, rets, ret_carry, last
        observation (raw), last mask). ``key``: the two words of the
        rollout's key, python ints, or on the fused path a ``[2]`` tensor on
        the device, whose step keys are split there."""
        T, E = cfg.rollout_len, ret_carry.shape[0]
        if fused:
            keys = FP.step_key_rows(key, T)
        else:               # a step's key splits into (k_act, k_step)
            keys = [KR.split_keys(k, 1)[0] for k in KR.split_keys(key, T)]
        buf = {
            "obs": torch.empty(T, E, hooks.obs_dim, dtype=store_dt, device=dev),
            "mask": torch.empty(T, E, hooks.n_actions, dtype=torch.bool, device=dev),
            "action": torch.empty(T, E, dtype=torch.int32, device=dev),
            **{k: torch.empty(T, E, device=dev) for k in ("log_prob", "value", "reward",
                                                           "raw", "rets")},
            "done": torch.empty(T, E, dtype=torch.bool, device=dev)}
        prev_a = torch.full((E,), -1, dtype=torch.int32, device=dev)
        alo = ahi = torch.zeros(E, dtype=torch.int64, device=dev)
        if fused:
            with P.span("ppo.collect.observe"):
                obs, mask = observe_p(env_states)
        for t, k in enumerate(keys):
            if not fused:
                with P.span("ppo.collect.observe"):
                    obs, mask = hooks.observe(env_states), hooks.action_mask(env_states)
            with P.span("ppo.collect.policy"):
                if cfg.normalize_obs:
                    obs = normalize(obs_stats, obs)
                logits, value = net(obs, mask)
            with P.span("ppo.collect.sample"):
                action, log_prob = sample_p(k, logits) if fused else categorical(k, logits)
            with P.span("ppo.collect.env"):
                if fused:
                    env_states, raw, done, next_obs, next_mask = step_p(env_states, action)
                else:
                    env_states, raw, done = hooks.step_autoreset(env_states, action)
                    raw = raw.to(_F32)
            with P.span("ppo.collect.store"):
                reward = shape_reward(raw, action, prev_a)
                prev_a = torch.where(done, -1, action).to(torch.int32)
                ret_carry = ret_carry * cfg.gamma * (1.0 - done.to(_F32)) + reward
                train_reward = (normalize_reward(ret_stats, reward) if cfg.normalize_reward
                                else reward)
                train_reward, alo, ahi = cycle_shape(train_reward, raw, action, done, alo, ahi)
                for name, v in (("obs", obs), ("mask", mask), ("action", action),
                                ("log_prob", log_prob), ("value", value),
                                ("reward", train_reward), ("raw", raw), ("done", done),
                                ("rets", ret_carry)):
                    buf[name][t].copy_(v)
            if fused:
                obs, mask = next_obs, next_mask
        if not fused:
            with P.span("ppo.collect.observe"):
                obs, mask = hooks.observe(env_states), hooks.action_mask(env_states)
        traj = Transition(*(buf[k] for k in Transition._fields))
        return env_states, traj, buf["raw"], buf["rets"], ret_carry, obs, mask

    collection = StageGraph("ppo.collect", rollout, _collection_outputs) if graphed else rollout
    stage = make_sgd(cfg, dev, mesh)

    def stage_on_scalars(net, opt, traj, adv, ret, scalars):
        opt, means = stage(net, opt, traj, adv, ret, *read_sgd_scalars(cfg, scalars, opt.count))
        return param_list(net), opt, means

    def sgd_outputs(args, out):
        """The weights copied into the learner's parameters; Adam's state
        (the count advanced by the graph's steps) and the metrics cloned, so
        nothing returned changes at the next replay."""
        (net, opt, *_), (params, new, means) = args, out
        torch._foreach_copy_(param_list(net), params)
        return (AdamState(opt.count + cfg.epochs * cfg.minibatches,
                          [m.clone() for m in new.mu], [v.clone() for v in new.nu]),
                means.clone())
    # on the fused path the trajectory is the collection graph's own buffers
    sgd = (StageGraph("ppo.sgd", stage_on_scalars, sgd_outputs,
                      (lambda: collection.out[1]) if graphed else tuple)
           if sgd_graphed else stage)

    def update_fn(ts: TrainState, record: dict | None = None):
        with P.recording(record is not None), P.span("ppo.update"):
            return update(ts, record)

    def update(ts: TrainState, record: dict | None):
        cuda = dev.type == "cuda"
        with torch.no_grad():
            with P.span("ppo.collect", events=cuda) as collect:
                key, k_roll, k_perm, k_reset = KR.split_keys(ts.key, 4)
                if mesh is not None:        # the carried key stays the same on every rank
                    k_roll, k_perm, k_reset = (KR.fold_in(*k, mesh.rank)
                                               for k in (k_roll, k_perm, k_reset))
                env_states, ret_carry0 = ts.env_states, ts.ret_carry
                E = ret_carry0.shape[0]
                net = ts.params
                if cfg.reset_envs_every:
                    lanes = ((ts.update_idx + torch.arange(E, device=dev))
                             % cfg.reset_envs_every) == 0
                    env_states = _where_lanes(lanes, reset_envs(_keys(k_reset, E, dev)),
                                              env_states)
                    ret_carry0 = torch.where(lanes, 0.0, ret_carry0)
                if fused:
                    k_roll = _to_device([int(w) for w in k_roll], torch.int64, dev)
                env_states, traj, raw, rets, ret_carry, last_obs, last_mask = collection(
                    net, env_states, k_roll, ts.obs_stats, ts.ret_stats, ret_carry0)
            with P.span("ppo.stats", events=cuda) as stats:
                obs_stats = (update_stats(ts.obs_stats,
                                          traj.obs.reshape(-1, hooks.obs_dim).to(_F32), mesh)
                             if cfg.normalize_obs else ts.obs_stats)
                ret_stats = (update_stats(ts.ret_stats, rets.reshape(-1), mesh)
                             if cfg.normalize_reward else ts.ret_stats)
            with P.span("ppo.gae", events=cuda) as last:
                if cfg.normalize_obs:
                    last_obs = normalize(ts.obs_stats, last_obs)
                _, last_value = net(last_obs, last_mask)
                adv, ret = gae(traj, last_value, cfg.gamma, cfg.gae_lambda)

        with P.span("ppo.sgd", events=cuda) as shuffle_sgd:
            if record is not None:      # the graph's buffers change at its next replay
                own = (lambda x: x.clone()) if graphed else (lambda x: x)  # noqa: E731
                record.update(traj=Transition(*map(own, traj)), raw=own(raw), rets=own(rets),
                              adv=adv)
            if sgd_graphed:
                scalars = _to_device(sgd_scalars(cfg, k_perm, ts.update_idx, ts.opt_state.count),
                                     torch.float64, dev)
                opt, means = sgd(net, ts.opt_state, traj, adv, ret, scalars)
            else:
                keys = [[torch.full((), w, dtype=torch.int64, device=dev) for w in k]
                        for k in KR.split_keys(k_perm, cfg.epochs)]
                opt, means = sgd(net, ts.opt_state, traj, adv, ret, keys,
                                 ent_coef_at(cfg, ts.update_idx), lambda c: (lr_at(c), None))
            loss, pg, vf, ent, approx_kl, kl_skipped = means
            mean_reward, episodes = raw.mean(), traj.done.sum()
            if mesh is not None:
                red = mesh.sum_(torch.stack([loss, pg, vf, ent, mean_reward, approx_kl,
                                             kl_skipped, episodes.to(_F32)]))
                loss, pg, vf, ent, mean_reward, approx_kl, kl_skipped = red[:7] / mesh.size
                episodes = red[7].to(episodes.dtype)
        if record is not None:
            events = record.setdefault("events", [])
            if cuda:        # the stages' ends, as one CUDA event each
                events += [("start", collect.events[0]), ("collection", collect.events[1]),
                           ("stats", stats.events[1]), ("last value + GAE", last.events[1]),
                           ("shuffle + SGD", shuffle_sgd.events[1])]
        out = TrainState(params=net, opt_state=opt, env_states=env_states, key=key,
                         update_idx=ts.update_idx + 1, obs_stats=obs_stats,
                         ret_stats=ret_stats, ret_carry=ret_carry)
        return out, {"loss": loss, "pg_loss": pg, "vf_loss": vf, "entropy": ent,
                     "mean_reward": mean_reward, "episodes": episodes,
                     "approx_kl": approx_kl, "kl_skipped": kl_skipped}

    def policy_fn(params, obs, mask):
        return params(obs, mask)

    update_fn.collection, update_fn.sgd = collection, sgd
    return init_fn, update_fn, policy_fn


# ---------------------------------------------------------------------------
# Envs, the reference's state, the training loop
# ---------------------------------------------------------------------------


def sim_env_hooks() -> EnvHooks:
    """The single-blind SimEnv (``engine/sim_env.py``)."""
    from balatro_gym_tpu_torch.engine import sim_env
    return EnvHooks(reset=sim_env.reset, step_autoreset=sim_env.step_autoreset,
                    step=sim_env.step_action, observe=sim_env.observe,
                    action_mask=sim_env.action_mask, n_actions=10, obs_dim=sim_env.OBS_DIM)


def full_env_hooks() -> EnvHooks:
    """The flagship Discrete(60) env."""
    from balatro_gym_tpu_torch.engine import full_env
    from balatro_gym_tpu_torch.ops import fused_policy_rollout as FP
    return EnvHooks(reset=full_env.reset, step_autoreset=full_env.step_autoreset,
                    step=full_env.step, observe=full_env.observe_vector,
                    action_mask=full_env.action_mask, n_actions=FP.N_ACTIONS,
                    obs_dim=FP.OBS_DIM)


def _flax_leaves(net, tree):
    """A flax-structured tree of ``[in, out]`` kernels and biases (numpy)
    as tensors in :func:`param_list` order."""
    dense = tree["params"]
    out = []
    for i, lin in enumerate(net.dense_layers()):
        layer = dense[f"Dense_{i}"]
        out += [torch.tensor(np.asarray(layer["bias"], np.float32)),
                torch.tensor(np.asarray(layer["kernel"], np.float32).T.copy())]
    return out


def load_reference_state(hooks: EnvHooks, cfg: PPOConfig, ref: dict, *, device=None):
    """The reference's ``TrainState``, given as numpy arrays, as the port's.

    ``ref`` holds ``params`` (the flax param dict), ``mu`` and ``nu``
    (optax's Adam moments, trees of the same structure), ``count`` (Adam's
    step count), ``obs_stats`` and ``ret_stats`` (each ``(mean, var,
    count)``), ``ret_carry``, ``key`` (``jax.random.key_data``: two
    words), ``update_idx`` and ``env_states``: the packed rows ``{"cards",
    "ints", "rng"}`` of ``pack_full_state`` for the flagship env, else the
    SimEnvState's fields."""
    _check(hooks, cfg)
    dev = run_device((), device)
    net = load_flax_params(_make_net(hooks, cfg, None), ref["params"]).to(dev)
    mu, nu = (_flax_leaves(net, ref[k]) for k in ("mu", "nu"))
    return TrainState(
        params=net, opt_state=AdamState(int(ref["count"]), [m.to(dev) for m in mu],
                                        [v.to(dev) for v in nu]),
        env_states=reference_env_states(hooks, ref["env_states"], dev,
                                        packed=cfg.fused_rollout),
        key=reference_key(ref["key"]), update_idx=int(ref["update_idx"]),
        obs_stats=reference_stats(ref["obs_stats"], dev),
        ret_stats=reference_stats(ref["ret_stats"], dev),
        ret_carry=torch.tensor(np.asarray(ref["ret_carry"], np.float32), device=dev))


def reference_env_states(hooks: EnvHooks, env, dev, packed: bool = False):
    """A reference's batched env state, as numpy arrays, as the port's: the
    flagship env's packed rows ``{"cards", "ints", "rng"}`` (unpacked into
    a ``FullEnvState`` unless ``packed``), else the SimEnvState's fields."""
    from balatro_gym_tpu_torch.ops import fused_full_rollout as FF
    from balatro_gym_tpu_torch.ops import fused_policy_rollout as FP
    if hooks.obs_dim != FP.OBS_DIM:
        from balatro_gym_tpu_torch.engine import sim_env
        return sim_env.state_from_numpy(env, device=dev)
    rows = {"cards": torch.as_tensor(np.asarray(env["cards"], np.int32), device=dev),
            "ints": torch.as_tensor(np.asarray(env["ints"], np.int32), device=dev),
            "rng": torch.as_tensor(np.asarray(env["rng"]).astype(np.uint32).view(np.int32),
                                   device=dev)}
    return rows if packed else FF.unpack_full_state(rows)


def reference_key(key) -> tuple:
    """``jax.random.key_data`` of one key as the port's pair of words."""
    return tuple(int(w) for w in np.asarray(key))


def reference_stats(t, dev) -> RunningStats:
    """A reference's ``(mean, var, count)`` running statistics."""
    return RunningStats(*(torch.tensor(np.asarray(x, np.float32), device=dev) for x in t))


def train(num_updates: int = 16, cfg: PPOConfig | None = None, seed: int = 0,
          hooks: EnvHooks | None = None, log_every: int = 0, *, device=None):
    """Training on one device (default: the card). Returns (TrainState,
    last metrics)."""
    cfg = cfg or PPOConfig()
    hooks = hooks or sim_env_hooks()
    init_fn, update_fn, _ = make_ppo(hooks, cfg, device=device)
    ts = init_fn([int(w) for w in KR.seed_key(seed, device="cpu")])
    metrics = None
    for i in range(num_updates):
        ts, metrics = update_fn(ts)
        if log_every and (i + 1) % log_every == 0:
            print(f"update {i + 1}: { {k: float(v) for k, v in metrics.items()} }")
    return ts, metrics
