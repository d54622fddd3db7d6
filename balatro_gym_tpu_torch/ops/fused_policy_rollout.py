"""Policy-in-the-loop collection of the flagship env (CUDA kernels) and the
plain PyTorch versions of its parts.

Port of ``balatro_gym_tpu/ops/fused_policy_rollout.py``: the env side of PPO
collection, where each step's action comes from the learner's policy. A
collection is a loop of (policy forward -> categorical sample -> one env
step), and the step also emits the next step's policy inputs.

* ``step_fused`` launches ``csrc/fused_policy_rollout.cu``'s K3a: one fed
  step of every env (the whole-rollout kernel's ``step``, shared through
  ``csrc/full_step.cuh``: exact named-stream RNG, autoreset), writing the
  packed state, reward, done and the observation and action mask of the
  post-step state. ``observe_fused`` launches K3b: the observation and mask
  of a state, without stepping (a collection's step 0). ``sample_fused``
  launches the sampler: ``jax.random.categorical`` with the log-probability
  of the drawn action, its key two words on the card (a row of
  ``step_key_rows``, which a CUDA graph's replay reads anew). ``env_step_fused``
  launches ``env_step_kernel``: K3a's step without its autoreset,
  observation or mask, the engine's own ``step``
  (``engine.full_env.step``), which the reference leaves to XLA.
  ``env_reset_fused`` launches ``env_reset_kernel``: the engine's
  ``reset`` (a permutation shuffle, not the kernels' sort) of the masked
  envs, in place on packed rows. Each counts its launches in
  ``.launches``.
* ``step_rows_reference``, ``observe_rows_reference``, ``sample``,
  ``env_step_rows_reference`` and ``env_reset_rows_reference`` are their
  plain versions, on any device. The step and the mask are the
  whole-rollout module's
  (``ops/fused_full_rollout.py``); the observation rows ``_obs_rows``
  mirror the reference's ``_obs_rows`` (the engine's ``observe_vector``)
  op for op.
* ``collect_policy_fused`` runs a collection: K3b once, then ``n_steps`` x
  (policy forward -> ``sample_fused`` -> ``step_fused``), eagerly;
  ``collect_policy_reference`` runs the same loop over the plain versions.

Every entry point runs on the card unless the caller passes
``device="cpu"``; there it runs the plain versions. On a card a wrapper
launches its kernel or raises; it never falls back to the plain version.

Layouts. A packed state is the dict of ``pack_full_state``. Observations
come out as ``[B, 189]`` float32 and masks as ``[B, 60]`` bool, the layout
of ``vmap(observe_vector)`` and ``vmap(action_mask)`` that ``ActorCritic``
takes; the kernels write them feature-major (``[189, B]``, coalesced
across envs) and the wrappers return the transposed views, which
``F.linear`` reads without a copy.

Numerics. Every observation row is the reference's f32 expression: a
division is an IEEE division (the reference, run op by op, divides; XLA's
jit on the CPU would multiply by the reciprocal instead), so the plain
version divides by a tensor and the kernel uses ``__fdiv_rn``. Only the
``log1p(chips_needed) / 10`` row goes through a library function, which may
differ in the last bit between math libraries.

Sampling. Step ``t`` of a collection with ``seed`` uses the key
``split(key(seed), n_steps)[t]``, as the reference's ``_collect`` does.
Action ``a`` of env ``e`` is perturbed by Gumbel noise
``-log(-log(u))``, ``u = uniform(bits[a * B + e], minval=tiny, maxval=1)``
of ``jax.random.bits(key, (60, B))``, and the action is the first argmax
of logits plus noise.
"""
from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from balatro_gym_tpu_torch.core.device import check_arg, run_device
from balatro_gym_tpu_torch.ops import cuda_build
from balatro_gym_tpu_torch.ops import fused_full_rollout as FF
from balatro_gym_tpu_torch.ops import kernel_rng as KR

OBS_DIM = 8 * 17 + FF.N_JOK + FF.N_LVL + FF.N_SHOP * 2 + 4 + 12     # = 189
N_ACTIONS = 60

_I32, _F32 = torch.int32, torch.float32
_TINY = float(np.finfo(np.float32).tiny)


# ---------------------------------------------------------------------------
# Plain versions
# ---------------------------------------------------------------------------


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
    from balatro_gym_tpu_torch.engine import full_env as FE
    st = FF.unpack_full_state(packed)
    if keys is None:
        keys = torch.stack(KR.fold_in(st.key[:, 0], st.key[:, 1],
                                      st.step_count.to(torch.int64)), -1)
    fresh = FE.reset_reference(keys.to(st.key.device))
    return FF.pack_full_state(FE.where_envs(mask.to(st.key.device), fresh, st))


def sample(step_key, logits):
    """``jax.random.categorical(step_key, logits.T, axis=0)`` and the
    log-softmax at the drawn action: (action ``[B]`` int32, log_prob
    ``[B]`` float32). ``step_key``: the key's two 32-bit words, as python
    ints or as a ``[2]`` int32 tensor of their bit patterns on the logits'
    device (a row of :func:`step_key_rows`); ``logits``: ``[B, 60]`` float32
    (illegal actions at -1e9)."""
    n, a = logits.shape
    idx = torch.arange(a * n, device=logits.device).view(a, n)
    u = KR.uniform_f32(KR.random_bits32(*step_key, idx), _TINY, 1.0)
    action = (logits + (-torch.log(-torch.log(u))).T).argmax(1)
    log_prob = torch.log_softmax(logits, 1).gather(1, action[:, None])[:, 0]
    return action.to(_I32), log_prob


def step_keys(seed, n_steps: int):
    """Step ``t``'s key, ``split(key(seed), n_steps)[t]``, as two python
    ints each, computed on the host; :func:`step_key_rows` gives the same
    words on a device."""
    return KR.split_keys([int(w) for w in KR.seed_key(seed, device="cpu")], n_steps)


def step_key_rows(key, n_steps: int):
    """The ``n_steps`` children of ``split(key, n_steps)``, the words of
    :func:`step_keys`, as the rows of an ``[n_steps, 2]`` int32 tensor of
    their bit patterns on the device of ``key``, a ``[2]`` integer tensor of
    the key's words. Computed there, without a copy to or from the host,
    so a CUDA graph can capture it."""
    child = KR.split_child(*key, torch.arange(n_steps, device=key.device))
    return FF._w2i(torch.stack(child, -1))


def seed_key_rows(seed, n_steps: int, device):
    """:func:`step_keys` of ``seed`` as :func:`step_key_rows` on ``device``.
    The seed key's two words go to a card once, from pinned memory: a
    pageable copy would wait for the card's queue to drain."""
    key = torch.tensor([int(w) for w in KR.seed_key(seed, device="cpu")], dtype=torch.int64)
    if torch.device(device).type == "cuda":
        key = key.pin_memory().to(device, non_blocking=True)
    return step_key_rows(key, n_steps)


# ---------------------------------------------------------------------------
# CUDA kernels
# ---------------------------------------------------------------------------

_P, _INT, _I64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong


@functools.cache
def _kernel_lib():
    lib = cuda_build.load("fused_policy_rollout.cu")
    lib.policy_observe_launch.argtypes = [_P] * 5 + [_INT, _P]
    lib.policy_step_launch.argtypes = [_P] * 12 + [_INT, _P]
    lib.env_step_launch.argtypes = [_P] * 10 + [_INT, _P]
    lib.env_reset_launch.argtypes = [_P] * 5 + [_INT, _P]
    lib.policy_sample_key_launch.argtypes = [_P, _I64, _I64, _INT, _P, _P, _P, _P]
    infos = (lib.policy_step_info, lib.policy_observe_info, lib.policy_sample_info,
             lib.env_step_info, lib.env_reset_info)
    for fn in infos:
        fn.argtypes = [_P]
    for fn in (lib.policy_observe_launch, lib.policy_step_launch, lib.policy_sample_key_launch,
               lib.env_step_launch, lib.env_reset_launch, *infos):
        fn.restype = ctypes.c_int
    return lib


def _kernel_shape(name):
    """A kernel's launch shape and what the compiler gave it, on the current
    card: {"block": threads a block, "shared_bytes": shared memory a block,
    "registers": a thread, "stack_bytes": local memory a thread}."""
    out = (ctypes.c_int * 4)()
    err = getattr(_kernel_lib(), f"{name}_info")(out)
    if err != 0:
        raise RuntimeError(f"{name}_info failed: cudaError_t {err}")
    return dict(zip(("block", "shared_bytes", "registers", "stack_bytes"), out))


def step_kernel_shape():
    """K3a's launch shape (see ``_kernel_shape``)."""
    return _kernel_shape("policy_step")


def env_step_kernel_shape():
    """``env_step_kernel``'s launch shape (see ``_kernel_shape``)."""
    return _kernel_shape("env_step")


def env_reset_kernel_shape():
    """``env_reset_kernel``'s launch shape (see ``_kernel_shape``)."""
    return _kernel_shape("env_reset")


def observe_kernel_shape():
    """K3b's launch shape (see ``_kernel_shape``)."""
    return _kernel_shape("policy_observe")


def sample_kernel_shape():
    """The sampler's launch shape (see ``_kernel_shape``)."""
    return _kernel_shape("policy_sample")


def _launch(fn, name, dev, *args):
    with torch.cuda.device(dev):
        err = fn(*args, torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: cudaError_t {err}")


def _placed(packed, others, device):
    """(packed state on the call's device, the device)."""
    dev = run_device((*packed.values(), *others), device)
    return {k: v.to(dev).contiguous() for k, v in packed.items()}, dev


def _check_packed(packed, dev):
    n = packed["ints"].shape[-1]
    check_arg(packed["cards"], "cards", _I32, (6, FF.N_DECK, n), dev)
    check_arg(packed["ints"], "ints", _I32, (FF.NI, n), dev)
    check_arg(packed["rng"], "rng", _I32, (FF.NR, n), dev)
    return n


def _on_card(dev, name):
    if dev.type != "cuda":
        raise ValueError(f"{name}: no kernel for device {dev}")


def observe_fused(packed, *, device=None):
    """Observation ``[B, 189]`` and mask ``[B, 60]`` of a packed state: K3b
    on a card, the plain version with ``device="cpu"``."""
    packed, dev = _placed(packed, (), device)
    if dev.type == "cpu":
        return observe_rows_reference(packed)
    _on_card(dev, "observe_fused")
    n = _check_packed(packed, dev)
    obs = torch.empty(OBS_DIM, n, dtype=_F32, device=dev)
    mask = torch.empty(N_ACTIONS, n, dtype=torch.bool, device=dev)
    _launch(_kernel_lib().policy_observe_launch, "policy_observe", dev,
            packed["cards"].data_ptr(), packed["ints"].data_ptr(), packed["rng"].data_ptr(),
            obs.data_ptr(), mask.data_ptr(), n)
    observe_fused.launches += 1
    return obs.T, mask.T


observe_fused.launches = 0


def step_fused(packed, actions, *, device=None):
    """One fed step of every env (``actions`` ``[B]`` ids): K3a on a card,
    the plain version with ``device="cpu"``. Returns what
    :func:`step_rows_reference` returns."""
    packed, dev = _placed(packed, (actions,), device)
    actions = torch.as_tensor(actions).to(device=dev, dtype=_I32).contiguous()
    if dev.type == "cpu":
        return step_rows_reference(packed, actions)
    _on_card(dev, "step_fused")
    n = _check_packed(packed, dev)
    check_arg(actions, "actions", _I32, (n,), dev)
    out = {k: torch.empty_like(v) for k, v in packed.items()}
    reward = torch.empty(n, dtype=_F32, device=dev)
    done = torch.empty(n, dtype=torch.bool, device=dev)
    obs = torch.empty(OBS_DIM, n, dtype=_F32, device=dev)
    mask = torch.empty(N_ACTIONS, n, dtype=torch.bool, device=dev)
    _launch(_kernel_lib().policy_step_launch, "policy_step", dev,
            packed["cards"].data_ptr(), packed["ints"].data_ptr(), packed["rng"].data_ptr(),
            actions.data_ptr(), FF.float_tables(dev).data_ptr(), out["cards"].data_ptr(),
            out["ints"].data_ptr(), out["rng"].data_ptr(), reward.data_ptr(), done.data_ptr(),
            obs.data_ptr(), mask.data_ptr(), n)
    step_fused.launches += 1
    return out, reward, done, obs.T, mask.T


step_fused.launches = 0


def env_step_fused(packed, actions, *, device=None):
    """One fed step of every env without autoreset (``actions`` ``[B]``
    ids): ``env_step_kernel`` on a card, the plain version with
    ``device="cpu"``. Returns what :func:`env_step_rows_reference`
    returns."""
    packed, dev = _placed(packed, (actions,), device)
    actions = torch.as_tensor(actions).to(device=dev, dtype=_I32).contiguous()
    if dev.type == "cpu":
        return env_step_rows_reference(packed, actions)
    _on_card(dev, "env_step_fused")
    n = _check_packed(packed, dev)
    check_arg(actions, "actions", _I32, (n,), dev)
    out = {k: torch.empty_like(v) for k, v in packed.items()}
    reward = torch.empty(n, dtype=_F32, device=dev)
    done = torch.empty(n, dtype=torch.bool, device=dev)
    _launch(_kernel_lib().env_step_launch, "env_step", dev,
            packed["cards"].data_ptr(), packed["ints"].data_ptr(), packed["rng"].data_ptr(),
            actions.data_ptr(), FF.float_tables(dev).data_ptr(), out["cards"].data_ptr(),
            out["ints"].data_ptr(), out["rng"].data_ptr(), reward.data_ptr(), done.data_ptr(), n)
    env_step_fused.launches += 1
    return out, reward, done


env_step_fused.launches = 0


def env_reset_fused(packed, mask, keys=None, *, device=None):
    """Fresh episodes, in place on the packed rows, for the envs of
    ``mask`` (``[B]`` bool): ``env_reset_kernel`` on a card, the plain
    version (:func:`env_reset_rows_reference`, copied into the rows) with
    ``device="cpu"``. ``keys`` (``[B, 2]`` Threefry words) are the episodes'
    keys where given, else each env's ``fold_in(key, step_count)``. Returns
    the packed state, whose tensors are the caller's where they already lay
    on the call's device, contiguous."""
    others = (mask,) if keys is None else (mask, keys)
    packed, dev = _placed(packed, others, device)
    mask = torch.as_tensor(mask).to(device=dev, dtype=torch.bool).contiguous()
    if dev.type == "cpu":
        for k, v in env_reset_rows_reference(packed, mask, keys).items():
            packed[k].copy_(v)
        return packed
    _on_card(dev, "env_reset_fused")
    n = _check_packed(packed, dev)
    check_arg(mask, "mask", torch.bool, (n,), dev)
    if keys is not None:
        keys = FF._w2i(torch.as_tensor(keys).to(device=dev, dtype=torch.int64)).contiguous()
        check_arg(keys, "keys", _I32, (n, 2), dev)
    _launch(_kernel_lib().env_reset_launch, "env_reset", dev,
            packed["cards"].data_ptr(), packed["ints"].data_ptr(), packed["rng"].data_ptr(),
            mask.data_ptr(), keys.data_ptr() if keys is not None else None, n)
    env_reset_fused.launches += 1
    return packed


env_reset_fused.launches = 0


def sample_fused(step_key, logits, *, device=None):
    """:func:`sample` by the sampler kernel on a card, the plain version
    with ``device="cpu"``. The kernel reads ``logits`` in any layout (the
    policy's matmul may leave them column-major). On a card ``step_key`` is
    a ``[2]`` int32 tensor on that card (a row of :func:`step_key_rows`),
    which the kernel reads there; the plain version takes either form of
    :func:`sample`."""
    dev = run_device((step_key, logits), device)
    logits = logits.to(dev)
    if dev.type == "cpu":
        return sample(step_key, logits)
    _on_card(dev, "sample_fused")
    if not torch.is_tensor(step_key):
        raise ValueError("step_key: want a [2] int32 tensor (a row of step_key_rows), got "
                         f"{type(step_key).__name__}")
    n = logits.shape[0]
    if logits.dtype != _F32 or tuple(logits.shape) != (n, N_ACTIONS):
        raise ValueError(f"logits: want a float32 tensor of shape ({n}, {N_ACTIONS}), "
                         f"got {logits.dtype} {tuple(logits.shape)}")
    if N_ACTIONS * n >= 2 ** 32:
        raise ValueError(f"sample_fused: {n} envs overflow the 32-bit draw counter")
    action = torch.empty(n, dtype=_I32, device=dev)
    log_prob = torch.empty(n, dtype=_F32, device=dev)
    check_arg(step_key, "step_key", _I32, (2,), dev)
    _launch(_kernel_lib().policy_sample_key_launch, "policy_sample", dev, logits.data_ptr(),
            *logits.stride(), n, step_key.data_ptr(), action.data_ptr(), log_prob.data_ptr())
    sample_fused.launches += 1
    return action, log_prob


sample_fused.launches = 0


# ---------------------------------------------------------------------------
# Collection
# ---------------------------------------------------------------------------


def collect_policy_fused(policy, init_state, seed, n_steps: int, *, device=None):
    """Policy-in-the-loop collection: K3b once, then ``n_steps`` x (policy
    forward -> ``sample_fused`` -> ``step_fused``).

    policy: a module mapping (obs ``[B, 189]``, mask ``[B, 60]``) to
    (masked logits ``[B, 60]``, value ``[B]``), such as
    ``train.networks.ActorCritic``; its parameters must lie on the call's
    device. init_state: a batched FullEnvState. seed: the sampling seed
    (step ``t`` draws with ``split(key(seed), n_steps)[t]``). device: where
    to run (default: the device of the state or the policy if off the host,
    else the card; ``device="cpu"`` runs the plain versions).

    Returns (final FullEnvState, trajectory): ``action`` int32, ``log_prob``,
    ``value`` and ``reward`` float32 and ``done`` bool, each
    ``[n_steps, n_envs]``.
    """
    return _collect(policy, init_state, seed, n_steps, device, fused=True)


def collect_policy_reference(policy, init_state, seed, n_steps: int, *, device=None):
    """The plain PyTorch version of :func:`collect_policy_fused`, on any
    device, with the same arguments and results."""
    return _collect(policy, init_state, seed, n_steps, device, fused=False)


def _collect(policy, init_state, seed, n_steps, device, fused):
    params = list(policy.parameters())
    dev = run_device((init_state.ante, *params), device)
    off = sorted({str(p.device) for p in params if p.device != dev})
    if off:
        raise ValueError(f"policy parameters lie on {off}, the call runs on {dev}: "
                         "move the policy there first")
    if fused:
        observe, pick, step = (functools.partial(f, device=dev)
                               for f in (observe_fused, sample_fused, step_fused))
    else:
        observe, pick, step = observe_rows_reference, sample, step_rows_reference
    packed = {k: v.to(dev).contiguous() for k, v in FF.pack_full_state(init_state).items()}
    dtypes = {"action": _I32, "log_prob": _F32, "value": _F32, "reward": _F32,
              "done": torch.bool}
    traj = {k: [] for k in dtypes}
    with torch.no_grad():
        obs, mask = observe(packed)
        for row in seed_key_rows(seed, n_steps, dev):
            logits, value = policy(obs, mask)
            action, log_prob = pick(row, logits)
            packed, reward, done, obs, mask = step(packed, action)
            for k, v in zip(dtypes, (action, log_prob, value, reward, done)):
                traj[k].append(v)
    n = init_state.ante.shape[0]
    out = {k: torch.stack(v) if v else torch.empty(0, n, dtype=dtypes[k], device=dev)
           for k, v in traj.items()}
    return FF.unpack_full_state(packed), out
