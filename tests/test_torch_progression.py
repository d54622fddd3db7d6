"""The port's ``progression_hooks`` against the reference's, on the CPU.

The reference runs in the x64-off production configuration while
tests/conftest.py turns x64 on, so the JAX side runs out of process: this
file re-invokes itself with ``--mint <npz>``, and that process resets 128
shaped envs (``progression_hooks(full_env_hooks(), stuck_limit=4)``),
plants lanes at ante 3 (an ante bonus, and an all-time best in some of
them but not where the all-time best is already 4) and lanes on their last
hand (episodes that end), then runs 8 steps of the jitted
``vmap(step_autoreset)`` on coverage-biased legal actions, saving the
state and counters before and after each step.

The counters (episode best, all-time best, steps on ante 1), the flagship
state and ``done`` are exact; the shaped rewards within PARITY #B11's 1e-4
(XLA's jit contracts the reward's multiply-adds into FMAs).
"""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from balatro_gym_tpu_torch.ops import fused_full_rollout as TF
from balatro_gym_tpu_torch.train import ppo as TP
from balatro_gym_tpu_torch.train import progression as TPR
from tests.test_torch_full_env_step import state_from_fields

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N, STEPS, STUCK = 128, 8, 4
COUNTERS = ("episode_best", "alltime_best", "ante1_steps")
REWARD_ATOL = 1e-4


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """This module's torch ops are many and small: one intra-op thread per
    test worker keeps parallel workers from oversubscribing the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _mint(path):
    sys.path.insert(0, REPO)
    sys.path.insert(0, os.path.join(REPO, "scripts"))
    import jax
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", False)
    import dataclasses

    import jax.numpy as jnp

    from balatro_gym_tpu.train import ppo as JP
    from balatro_gym_tpu.train import progression as JPR
    from fused_full_common import sample_legal

    hooks = JPR.progression_hooks(JP.full_env_hooks(), stuck_limit=STUCK)
    ps = jax.vmap(hooks.reset)(jax.random.split(jax.random.key(3), N))
    env = np.arange(N)
    st = ps.env
    st = st.replace(ante=jnp.asarray(np.where(env % 4 == 1, 3, np.asarray(st.ante))),
                    hands_left=jnp.asarray(np.where(env % 4 == 2, 1, np.asarray(st.hands_left))))
    ps = ps.replace(env=st, alltime_best=jnp.asarray(np.where(env % 8 == 5, 4, 1), jnp.int32))
    out = {}

    def put(prefix, ps):
        for f in dataclasses.fields(ps.env):
            v = getattr(ps.env, f.name)
            out[f"{prefix}_{f.name}"] = np.asarray(
                jax.vmap(jax.random.key_data)(v) if f.name == "key" else v)
        for k in COUNTERS:
            out[f"{prefix}_{k}"] = np.asarray(getattr(ps, k))

    step_j = jax.jit(jax.vmap(hooks.step_autoreset))
    mask_j = jax.jit(jax.vmap(hooks.action_mask))
    rng = np.random.default_rng(4)
    acts = np.zeros((STEPS, N), np.int32)
    put("pre0", ps)
    for t in range(STEPS):
        acts[t] = sample_legal(np.asarray(mask_j(ps)), rng)
        ps, r, d = step_j(ps, jnp.asarray(acts[t]))
        put(f"pre{t + 1}", ps)
        out[f"out{t}_reward"], out[f"out{t}_done"] = np.asarray(r), np.asarray(d)
    out["acts"] = acts
    np.savez(path, **out)


@pytest.fixture(scope="module")
def minted(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("mint") / "progression.npz")
    env = dict(os.environ)
    env.pop("JAX_PLATFORMS", None)
    env["PYTHONPATH"] = os.pathsep.join(filter(None, [REPO, env.get("PYTHONPATH")]))
    res = subprocess.run([sys.executable, os.path.abspath(__file__), "--mint", path],
                         capture_output=True, text=True, timeout=900, env=env, cwd=REPO)
    assert res.returncode == 0, (res.stdout + res.stderr)[-4000:]
    return dict(np.load(path))


def prog_state(m, prefix):
    return TPR.ProgState(env=state_from_fields(m, prefix),
                         **{k: torch.as_tensor(m[f"{prefix}_{k}"]) for k in COUNTERS})


def test_progression_matches_reference(minted):
    hooks = TPR.progression_hooks(TP.full_env_hooks(), stuck_limit=STUCK)
    ps = prog_state(minted, "pre0")
    bonus = stuck = ended = 0
    for t in range(STEPS):
        ps, reward, done = hooks.step_autoreset(ps, torch.as_tensor(minted["acts"][t]))
        want = prog_state(minted, f"pre{t + 1}")
        for k in COUNTERS:
            np.testing.assert_array_equal(getattr(ps, k).numpy(), getattr(want, k).numpy(),
                                          err_msg=f"step {t}: {k}")
        assert TF.states_equal(ps.env, want.env) == [], t
        np.testing.assert_array_equal(done.numpy(), minted[f"out{t}_done"])
        np.testing.assert_allclose(reward.numpy(), minted[f"out{t}_reward"], rtol=0,
                                   atol=REWARD_ATOL)
        bonus += int((reward >= 100.0).sum())
        stuck += int((reward <= -50.0).sum())
        ended += int(done.sum())
    print(f"bonuses {bonus}, stuck {stuck}, ended {ended}")
    assert bonus > 0 and stuck > 0 and ended > stuck


def test_progression_reset_and_observation():
    hooks = TPR.progression_hooks(TP.full_env_hooks())
    keys = torch.stack(TF.sample_keys(0, 8, "cpu"), -1)
    ps = hooks.reset(keys)
    assert [int(getattr(ps, k).sum()) for k in COUNTERS] == [8, 8, 0]
    assert TF.states_equal(ps.env, TP.full_env_hooks().reset(keys)) == []
    assert hooks.step is None and (hooks.n_actions, hooks.obs_dim) == (60, 189)
    assert torch.equal(hooks.observe(ps), TP.full_env_hooks().observe(ps.env))
    assert torch.equal(hooks.action_mask(ps), TP.full_env_hooks().action_mask(ps.env))


def test_progression_trains_with_staggered_resets():
    """The generic rollout over shaped envs, with the staggered reset that
    merges ProgStates lane by lane."""
    hooks = TPR.progression_hooks(TP.full_env_hooks(), stuck_limit=3)
    cfg = TP.PPOConfig(n_envs=16, rollout_len=4, epochs=1, minibatches=2, hidden=(32,),
                       reset_envs_every=2)
    ts, metrics = TP.train(2, cfg, hooks=hooks, device="cpu")
    assert isinstance(ts.env_states, TPR.ProgState)
    assert int(metrics["episodes"]) > 0
    assert all(np.isfinite(float(v)) for v in metrics.values())


if __name__ == "__main__" and len(sys.argv) == 3 and sys.argv[1] == "--mint":
    _mint(sys.argv[2])
