"""A plain PPO update on the flagship env, written out on the frozen copy.

The same learner the port trains (its ``train/ppo.py``), on one device: a
rollout of ``rollout_len`` steps of every env with the policy in the loop,
the running observation and return statistics, GAE, and ``epochs`` x
``minibatches`` steps of clipped PPO with optax's ``clip_by_global_norm`` +
Adam written out. Two collections, as the port has them:

* fused: the observation and mask of the packed rows once, then a step is
  the policy, :func:`policy_rows.sample` and the fed step with its own
  autoreset (``policy_rows.step_rows_reference``), which gives the next
  policy inputs;
* generic: a step observes the rows, draws with :func:`categorical`
  (``jax.random.categorical`` over ``[B, A]``), steps without autoreset and
  resets the done envs from ``fold_in(key, step_count)``.

The network is the shared-torso tanh actor-critic over a flat parameter
list (bias, weight per dense layer; the logits head, then the value head).
``quant`` names a lower precision for the control: ``"fp8"`` rounds every
matmul's inputs and weights through float8 e4m3 before the bfloat16
product (forward only; gradients pass straight through).
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from . import full_env as FE
from . import full_step as FF
from . import kernel_rng as KR
from . import policy_rows as PR

_F32 = torch.float32
_TINY = float(np.finfo(np.float32).tiny)


# ---------------------------------------------------------------------------
# Network
# ---------------------------------------------------------------------------


def _dense(x, w, b, dt, quant):
    if dt is None:
        return F.linear(x, w, b)
    w = w.to(dt)
    if quant == "fp8":
        x, w = _fp8(x, dt), _fp8(w, dt)
    return F.linear(x, w) + b.to(dt)


def _fp8(t, dt):
    """``t`` rounded through float8 e4m3 in the forward pass; its gradient
    passes unrounded (straight through), as fp8 training keeps it."""
    return t + (t.to(torch.float8_e4m3fn).to(dt) - t).detach()


def forward(params, obs, mask, dt=None, quant=None):
    """(masked logits ``[B, A]`` float32, value ``[B]`` float32)."""
    x = obs if dt is None else obs.to(dt)
    n_hidden = len(params) // 2 - 2
    for i in range(n_hidden):
        x = torch.tanh(_dense(x, params[2 * i + 1], params[2 * i], dt, quant))
    bl, wl, bv, wv = params[-4:]
    logits = _dense(x, wl, bl, dt, quant).float()
    logits = torch.where(mask, logits, -1e9)
    return logits, _dense(x, wv, bv, dt, quant)[..., 0].float()


# ---------------------------------------------------------------------------
# Statistics, sampler, GAE, loss, optimizer
# ---------------------------------------------------------------------------


def init_stats(dim, dev):
    shape = () if dim is None else (dim,)
    return (torch.zeros(shape, device=dev), torch.ones(shape, device=dev),
            torch.full((), 1e-4, device=dev))


def update_stats(rs, batch):
    mean, var, count = rs
    b_mean, b_var = batch.mean(0), batch.var(0, correction=0)
    b_count = torch.full((), float(batch.shape[0]), device=batch.device)
    delta = b_mean - mean
    tot = count + b_count
    m2 = var * count + b_var * b_count + delta ** 2 * count * b_count / tot
    return mean + delta * b_count / tot, m2 / tot, tot


def normalize(rs, x, clip=10.0):
    return ((x - rs[0]) / torch.sqrt(rs[1] + 1e-8)).clamp(-clip, clip)


def normalize_reward(rs, r, clip=10.0):
    return (r / torch.sqrt(rs[1] + 1e-8)).clamp(-clip, clip)


def categorical(key, logits):
    """``jax.random.categorical(key, logits)`` over ``[B, A]`` and the
    log-softmax at the drawn action."""
    n, a = logits.shape
    idx = torch.arange(n * a, device=logits.device).view(n, a)
    u = KR.uniform_f32(KR.random_bits32(*key, idx), _TINY, 1.0)
    action = (logits + (-torch.log(-torch.log(u)))).argmax(1)
    return action, torch.log_softmax(logits, 1).gather(1, action[:, None])[:, 0]


def gae(reward, value, done, last_value, gamma, lam):
    adv = torch.empty_like(value)
    nonterm = 1.0 - done.to(_F32)
    g, nxt = torch.zeros_like(last_value), last_value
    for t in reversed(range(value.shape[0])):
        delta = reward[t] + gamma * nxt * nonterm[t] - value[t]
        g = delta + gamma * lam * nonterm[t] * g
        adv[t] = g
        nxt = value[t]
    return adv, adv + value


def ppo_loss(params, mb, ent_coef, cfg, dt, quant):
    logits, value = forward(params, mb["obs"], mb["mask"], dt, quant)
    log_all = torch.log_softmax(logits, -1)
    log_prob = log_all.gather(1, mb["action"].to(torch.int64)[:, None])[:, 0]
    ratio = torch.exp(log_prob - mb["log_prob"])
    adv = mb["adv"]
    adv_n = (adv - adv.mean()) / (adv.std(correction=0) + 1e-8)
    eps = cfg["clip_eps"]
    pg_loss = -torch.minimum(ratio * adv_n, ratio.clamp(1 - eps, 1 + eps) * adv_n).mean()
    v_clip = mb["value"] + (value - mb["value"]).clamp(-eps, eps)
    v_loss = 0.5 * torch.maximum((value - mb["ret"]) ** 2, (v_clip - mb["ret"]) ** 2).mean()
    ent = -torch.where(mb["mask"], torch.exp(log_all) * log_all, 0.0).sum(-1).mean()
    return pg_loss + cfg["vf_coef"] * v_loss - ent_coef * ent


def adam_step(params, grads, opt, lr, max_norm, b1=0.9, b2=0.999, eps=1e-5):
    g_norm = torch.sqrt(sum((g * g).sum() for g in grads))
    keep = g_norm < max_norm
    grads = [torch.where(keep, g, g / g_norm * max_norm) for g in grads]
    count = opt["count"] + 1
    bc1 = float(np.float32(1) - np.float32(b1) ** np.float32(count))
    bc2 = float(np.float32(1) - np.float32(b2) ** np.float32(count))
    mus, nus = [], []
    with torch.no_grad():
        for p, g, mu, nu in zip(params, grads, opt["mu"], opt["nu"]):
            mu = (1 - b1) * g + b1 * mu
            nu = (1 - b2) * (g * g) + b2 * nu
            p.add_((-lr) * ((mu / bc1) / (torch.sqrt(nu / bc2) + eps)))
            mus.append(mu)
            nus.append(nu)
    return {"count": count, "mu": mus, "nu": nus}


def _lr(cfg, count):
    if not (cfg["lr_final"] >= 0.0 and cfg["total_updates"] > 0):
        return cfg["lr"]
    steps = cfg["total_updates"] * cfg["epochs"] * cfg["minibatches"]
    c = np.float32(min(max(count, 0), steps))
    frac = np.float32(1) - c / np.float32(steps)
    return float(np.float32(cfg["lr"] - cfg["lr_final"]) * frac + np.float32(cfg["lr_final"]))


def _ent_coef(cfg, update_idx):
    if cfg["ent_coef_final"] >= 0.0 and cfg["total_updates"] > 0:
        frac = np.clip(np.float32(update_idx) / np.float32(cfg["total_updates"]),
                       np.float32(0), np.float32(1))
        return float(np.float32(cfg["ent_coef"])
                     + np.float32(cfg["ent_coef_final"] - cfg["ent_coef"]) * frac)
    return float(np.float32(cfg["ent_coef"]))


# ---------------------------------------------------------------------------
# State and update
# ---------------------------------------------------------------------------


def init_state(key, params, cfg, dev):
    """The learner's state before its first update: the envs reset from
    the second of ``split(key, 3)``, the third carried; ``params`` the
    given weights (cloned)."""
    _, k_env, k_run = KR.split_keys(key, 3)
    e = cfg["n_envs"]
    k1, k2 = (torch.tensor(w, dtype=torch.int64, device=dev) for w in k_env)
    keys = torch.stack(KR.split_child(k1, k2, torch.arange(e, device=dev)), -1)
    env = {k: v.contiguous() for k, v in FF.pack_full_state(FE.reset_reference(keys)).items()}
    params = [p.detach().clone().requires_grad_(True) for p in params]
    return {"params": params,
            "opt": {"count": 0, "mu": [torch.zeros_like(p) for p in params],
                    "nu": [torch.zeros_like(p) for p in params]},
            "env": env, "key": k_run, "update_idx": 0,
            "obs_stats": init_stats(PR.OBS_DIM, dev), "ret_stats": init_stats(None, dev),
            "ret_carry": torch.zeros(e, device=dev)}


def _generic_step(packed, action):
    packed, raw, done = PR.env_step_rows_reference(packed, action)
    return PR.env_reset_rows_reference(packed, done), raw, done


def _rollout(st, cfg, dt, quant):
    fused = cfg["fused_rollout"]
    T, E, dev = cfg["rollout_len"], cfg["n_envs"], st["ret_carry"].device
    keys = KR.split_keys(st["roll_key"], T)
    if not fused:
        keys = [KR.split_keys(k, 1)[0] for k in keys]
    store_dt = torch.bfloat16 if (fused and cfg["bf16_compute"]) else _F32
    buf = {"obs": torch.empty(T, E, PR.OBS_DIM, dtype=store_dt, device=dev),
           "mask": torch.empty(T, E, PR.N_ACTIONS, dtype=torch.bool, device=dev),
           "action": torch.empty(T, E, dtype=torch.int32, device=dev),
           **{k: torch.empty(T, E, device=dev) for k in ("log_prob", "value", "reward", "raw",
                                                         "rets")},
           "done": torch.empty(T, E, dtype=torch.bool, device=dev)}
    env, ret_carry = st["env"], st["ret_carry"]
    obs, mask = PR.observe_rows_reference(env)
    for t, k in enumerate(keys):
        if not fused and t:
            obs, mask = PR.observe_rows_reference(env)
        if cfg["normalize_obs"]:
            obs = normalize(st["obs_stats"], obs)
        logits, value = forward(st["params"], obs, mask, dt, quant)
        if fused:
            action, log_prob = PR.sample(k, logits)
            env, raw, done, next_obs, next_mask = PR.step_rows_reference(env, action)
        else:
            action, log_prob = categorical(k, logits)
            env, raw, done = _generic_step(env, action)
            raw = raw.to(_F32)
        ret_carry = ret_carry * cfg["gamma"] * (1.0 - done.to(_F32)) + raw
        train_reward = (normalize_reward(st["ret_stats"], raw) if cfg["normalize_reward"]
                        else raw)
        for name, v in (("obs", obs), ("mask", mask), ("action", action),
                        ("log_prob", log_prob), ("value", value), ("reward", train_reward),
                        ("raw", raw), ("done", done), ("rets", ret_carry)):
            buf[name][t].copy_(v)
        if fused:
            obs, mask = next_obs, next_mask
    if not fused:
        obs, mask = PR.observe_rows_reference(env)
    return env, buf, ret_carry, obs, mask


def update(st, cfg, quant=None):
    """One PPO update of ``st`` (changed in place where the port changes
    its own); returns (state, loss)."""
    dt = torch.bfloat16 if cfg["bf16_compute"] else None
    key, k_roll, k_perm, _ = KR.split_keys(st["key"], 4)
    st = dict(st, roll_key=k_roll)
    dev = st["ret_carry"].device
    with torch.no_grad():
        env, buf, ret_carry, last_obs, last_mask = _rollout(st, cfg, dt, quant)
        obs_stats = (update_stats(st["obs_stats"], buf["obs"].reshape(-1, PR.OBS_DIM).to(_F32))
                     if cfg["normalize_obs"] else st["obs_stats"])
        ret_stats = (update_stats(st["ret_stats"], buf["rets"].reshape(-1))
                     if cfg["normalize_reward"] else st["ret_stats"])
        if cfg["normalize_obs"]:
            last_obs = normalize(st["obs_stats"], last_obs)
        _, last_value = forward(st["params"], last_obs, last_mask, dt, quant)
        adv, ret = gae(buf["reward"], buf["value"], buf["done"], last_value, cfg["gamma"],
                       cfg["gae_lambda"])
    T, E = buf["action"].shape
    data = {k: buf[k] for k in ("obs", "mask", "action", "log_prob", "value")}
    data.update(adv=adv, ret=ret)
    ent_coef = _ent_coef(cfg, st["update_idx"])
    params, opt, losses = st["params"], st["opt"], []
    for k in KR.split_keys(k_perm, cfg["epochs"]):
        kt = [torch.full((), w, dtype=torch.int64, device=dev) for w in k]
        if cfg["env_shuffle"]:
            perm = KR.permutation(*kt, E).view(cfg["minibatches"], -1)
            picks = [{n: x[:, idx].reshape((-1,) + x.shape[2:]) for n, x in data.items()}
                     for idx in perm]
        else:
            perm = KR.permutation(*kt, T * E).view(cfg["minibatches"], -1)
            picks = [{n: x.reshape((T * E,) + x.shape[2:])[idx] for n, x in data.items()}
                     for idx in perm]
        for mb in picks:
            total = ppo_loss(params, mb, ent_coef, cfg, dt, quant)
            grads = torch.autograd.grad(total, params)
            opt = adam_step(params, grads, opt, _lr(cfg, opt["count"]), cfg["max_grad_norm"])
            losses.append(total.detach())
    loss = torch.stack(losses).mean()
    out = dict(st, opt=opt, env=env, key=key, update_idx=st["update_idx"] + 1,
               obs_stats=obs_stats, ret_stats=ret_stats, ret_carry=ret_carry)
    out.pop("roll_key")
    return out, loss
