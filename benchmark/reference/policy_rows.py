"""Frozen copy of the policy collection's plain versions on packed rows.

Copied from the port's ``ops/fused_policy_rollout.py``: the observation
rows (K3b), the fed step with autoreset and its next policy inputs (K3a),
the step without autoreset and the masked reset (the engine's step kernel
and reset kernel), and the sampler.
"""
from __future__ import annotations

import numpy as np
import torch

from . import full_env as FE
from . import full_step as FF
from . import kernel_rng as KR

OBS_DIM = 8 * 17 + FF.N_JOK + FF.N_LVL + FF.N_SHOP * 2 + 4 + 12     # = 189
N_ACTIONS = 60

_I32, _F32 = torch.int32, torch.float32
_TINY = float(np.finfo(np.float32).tiny)


def _obs_rows(s):
    """``[OBS_DIM, B]`` float32 observation rows of a step state (the
    ``_load`` dict of ops/fused_full_rollout.py): row ``d`` is
    ``observe_vector(state)[d]`` of every env."""
    dev = s["hn"].device
    present = (FF._positions(s) < s["hn"]) & (s["hidx"] >= 0)                 # [8, B]
    rank_oh = (s["hrk"][:, None] == torch.arange(2, 15, device=dev)[:, None]) & present[:, None]
    suit_oh = (s["hsu"][:, None] == torch.arange(4, device=dev)[:, None]) & present[:, None]
    cards = torch.cat([rank_oh, suit_oh], 1).reshape(8 * 17, -1).to(_F32)

    def f(name):
        return s[name].to(_F32)

    need = s["need"].clamp(min=1).to(_F32)
    scalars = torch.stack([
        FF._div(f("money"), 20.0), FF._div(f("ante"), 8.0), FF._div(f("round"), 3.0),
        FF._div(f("hl"), 4.0), FF._div(f("dl"), 3.0),
        FF._div(f("rchips"), need).clamp(max=2.0),
        FF._div(torch.log1p(f("need")), 10.0),
        FF._div(f("jn"), 5.0), FF._div(f("cn"), 2.0), f("bact"),
        FF._div(torch.where(s["bact"], s["bid"], 0).to(_F32), 28.0),
        s["sel"].any(0).to(_F32)])
    return torch.cat([
        cards, FF._div(f("jok"), 150.0), FF._div(f("lvl"), 15.0), FF._div(f("sty"), 4.0),
        FF._div(f("sco"), 1000.0).clamp(max=1.0),
        (s["phase"] == torch.arange(4, device=dev)[:, None]).to(_F32), scalars])


def observe_rows_reference(packed):
    """Observation ``[B, 189]`` float32 and action mask ``[B, 60]`` bool of
    a packed state, on its device."""
    s = FF._load(packed)
    return _obs_rows(s).T, FF._legal_rows(s).T


def step_rows_reference(packed, actions):
    """One fed step of every env of a packed state, on its device. Returns
    (packed state, reward ``[B]`` float32, done ``[B]`` bool, observation
    ``[B, 189]``, mask ``[B, 60]``); observation and mask are those of the
    post-step (post-autoreset) state, the next step's policy inputs."""
    s, reward, done = FF._step(FF._load(packed), actions)
    return FF._store(s), reward, done, _obs_rows(s).T, FF._legal_rows(s).T


def env_step_rows_reference(packed, actions):
    """One fed step of every env of a packed state without autoreset, on
    its device: (packed state, reward ``[B]`` float32, done ``[B]`` bool).
    A done env keeps its final state."""
    s, reward, done = FF._step(FF._load(packed), actions, autoreset=False)
    return FF._store(s), reward, done


def env_reset_rows_reference(packed, mask, keys=None):
    """The packed state with each env of ``mask`` (``[B]`` bool) replaced
    by a fresh episode, on its device: the port's ``full_env.reset`` of
    ``keys`` (``[B, 2]`` Threefry words) where given, else of
    ``fold_in(key, step_count)`` of each env's own state, as ``autoreset``
    takes it. Returns new rows."""
    st = FF.unpack_full_state(packed)
    if keys is None:
        keys = torch.stack(KR.fold_in(st.key[:, 0], st.key[:, 1],
                                      st.step_count.to(torch.int64)), -1)
    fresh = FE.reset_reference(keys.to(st.key.device))
    return FF.pack_full_state(FE.where_envs(mask.to(st.key.device), fresh, st))


def sample(step_key, logits):
    """``jax.random.categorical(step_key, logits.T, axis=0)`` and the
    log-softmax at the drawn action: (action ``[B]`` int32, log_prob
    ``[B]`` float32). ``step_key``: the key's two 32-bit words (python ints);
    ``logits``: ``[B, 60]`` float32 (illegal actions at -1e9)."""
    n, a = logits.shape
    idx = torch.arange(a * n, device=logits.device).view(a, n)
    u = KR.uniform_f32(KR.random_bits32(*step_key, idx), _TINY, 1.0)
    action = (logits + (-torch.log(-torch.log(u))).T).argmax(1)
    log_prob = torch.log_softmax(logits, 1).gather(1, action[:, None])[:, 0]
    return action.to(_I32), log_prob
