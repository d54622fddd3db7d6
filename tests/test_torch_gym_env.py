"""The port's Gym shell ``BalatroGymEnv`` and its wrappers against the JAX
package's, on the CPU.

The reference runs in the x64-off production configuration while
tests/conftest.py turns x64 on, so the JAX side runs out of process: this
file re-invokes itself with ``--mint <npz>``, and that process drives the
reference's ``BalatroGymEnv`` on two seeds for 40 steps each (random legal
actions, every 7th step an illegal one, a reset after each episode end),
recording every observation, reward, done and ASCII render; saves the
state at step 10, steps 5 times, loads it and replays the 5 steps; and
runs each of the four wrappers (curriculum, progression, safe, flat
observation) over a fresh shell for 25 steps. The port replays the same
actions and must give the same observations (keys, values and numpy
dtypes), dones, infos and render text, and rewards within PARITY #B11's
1e-4 (XLA's jit contracts the reward's multiply-adds into FMAs).
"""
import contextlib
import io
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from balatro_gym_tpu_torch.envs import (BalatroEnvValidator, BalatroGymEnv,
                                        make_balatro_env)
from balatro_gym_tpu_torch.envs import wrappers as TW

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SEEDS = (1, 2)
STEPS = 40
SAVE_AT, REPLAY = 10, 5
WRAP_STEPS = 25
REWARD_ATOL = 1e-4
WRAPPERS = {
    "curriculum": lambda w, env: w.CurriculumWrapper(env, start_max_ante=1, window=2),
    "progression": lambda w, env: w.ProgressionRewardWrapper(env, stuck_limit=6),
    "safe": lambda w, env: w.SafeEnvWrapper(env, max_invalid=2, max_steps=9),
    "flat": lambda w, env: w.FlatObsWrapper(env),
}


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """This module's torch ops are many and small: one intra-op thread per
    test worker keeps parallel workers from oversubscribing the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _render(env):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        env.render()
    return buf.getvalue()


def _mask(obs, info):
    return np.asarray(info["action_mask"] if "action_mask" in info else obs["action_mask"])


# ---------------------------------------------------------------------------
# The out-of-process JAX side
# ---------------------------------------------------------------------------


def _mint(path):
    sys.path.insert(0, REPO)
    import jax
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", False)

    from balatro_gym_tpu.envs import BalatroGymEnv as JEnv
    from balatro_gym_tpu.envs import wrappers as JW

    out = {}

    def put_obs(prefix, obs):
        if isinstance(obs, dict):
            for k, v in obs.items():
                out[f"{prefix}_obs_{k}"] = v
        else:
            out[f"{prefix}_flat"] = obs

    for seed in SEEDS:
        env = JEnv(seed=seed, render_mode="human")
        obs, _ = env.reset()
        rng = np.random.default_rng(seed)
        acts, rew, done = [], [], []
        put_obs(f"s{seed}_reset", obs)
        for t in range(STEPS):
            mask = obs["action_mask"].astype(bool)
            pool = np.flatnonzero(~mask if t % 7 == 6 else mask)
            a = int(rng.choice(pool))
            if t == SAVE_AT:
                saved = env.save_state()
                branch = []
                for _ in range(REPLAY):
                    b = int(rng.choice(np.flatnonzero(env._obs()["action_mask"])))
                    o, r, d, _, _ = env.step(b)
                    branch.append((b, r, d, o))
                env.load_state(saved)
                replay = [env.step(b)[:3] for b, _, _, _ in branch]
                env.load_state(saved)
                out[f"s{seed}_branch_acts"] = np.array([b for b, *_ in branch])
                out[f"s{seed}_branch_rew"] = np.array([r for _, r, _, _ in branch])
                out[f"s{seed}_replay_rew"] = np.array([r for _, r, _ in replay])
                for i, (_, _, _, o) in enumerate(branch):
                    put_obs(f"s{seed}_branch{i}", o)
            obs, r, d, _, _ = env.step(a)
            acts.append(a)
            rew.append(r)
            done.append(d)
            put_obs(f"s{seed}_t{t}", obs)
            out[f"s{seed}_t{t}_render"] = np.array(_render(env))
            if d:
                obs, _ = env.reset()
                put_obs(f"s{seed}_t{t}_reset", obs)
        out[f"s{seed}_acts"], out[f"s{seed}_rew"] = np.array(acts), np.array(rew)
        out[f"s{seed}_done"] = np.array(done)

    for name, make in WRAPPERS.items():
        env = make(JW, JEnv(seed=5))
        obs, info = env.reset()
        rng = np.random.default_rng(11)
        acts, rew, done, infos = [], [], [], []
        for t in range(WRAP_STEPS):
            mask = _mask(obs, info).astype(bool)
            a = int(rng.choice(np.flatnonzero(~mask if t % 5 == 4 else mask)))
            obs, r, d, _, info = env.step(a)
            acts.append(a)
            rew.append(r)
            done.append(d)
            infos.append(repr(sorted((k, v) for k, v in info.items() if k != "action_mask")))
            put_obs(f"w_{name}_t{t}", obs)
            if d:
                obs, info = env.reset()
        out[f"w_{name}_acts"], out[f"w_{name}_rew"] = np.array(acts), np.array(rew)
        out[f"w_{name}_done"], out[f"w_{name}_info"] = np.array(done), np.array(infos)
    np.savez(path, **out)


@pytest.fixture(scope="module")
def minted(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("mint") / "gym.npz")
    env = dict(os.environ)
    env.pop("JAX_PLATFORMS", None)
    env["PYTHONPATH"] = os.pathsep.join(filter(None, [REPO, env.get("PYTHONPATH")]))
    res = subprocess.run([sys.executable, os.path.abspath(__file__), "--mint", path],
                         capture_output=True, text=True, timeout=900, env=env, cwd=REPO)
    assert res.returncode == 0, (res.stdout + res.stderr)[-4000:]
    return dict(np.load(path))


def assert_obs(got, m, prefix):
    """Keys, values and numpy dtypes."""
    keys = sorted(k[len(prefix) + 5:] for k in m if k.startswith(prefix + "_obs_"))
    assert sorted(got) == keys, prefix
    for k in keys:
        want = m[f"{prefix}_obs_{k}"]
        assert got[k].dtype == want.dtype and got[k].shape == want.shape, (prefix, k)
        np.testing.assert_array_equal(got[k], want, err_msg=f"{prefix}: {k}")


# ---------------------------------------------------------------------------
# The shell
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed", SEEDS)
def test_shell_matches_reference(minted, seed):
    env = BalatroGymEnv(seed=seed, render_mode="human", device="cpu")
    obs, info = env.reset()
    assert info == {}
    assert_obs(obs, minted, f"s{seed}_reset")
    acts = minted[f"s{seed}_acts"]
    for t, a in enumerate(acts):
        if t == SAVE_AT:
            saved = env.save_state()
            for i, b in enumerate(minted[f"s{seed}_branch_acts"]):
                o, r, _, _, _ = env.step(int(b))
                assert_obs(o, minted, f"s{seed}_branch{i}")
                assert abs(r - minted[f"s{seed}_branch_rew"][i]) <= REWARD_ATOL
            env.load_state(saved)
            replay = [env.step(int(b))[1] for b in minted[f"s{seed}_branch_acts"]]
            np.testing.assert_allclose(replay, minted[f"s{seed}_replay_rew"], rtol=0,
                                       atol=REWARD_ATOL)
            env.load_state(saved)
        obs, r, d, trunc, info = env.step(int(a))
        assert isinstance(r, float) and isinstance(d, bool) and trunc is False and info == {}
        assert abs(r - minted[f"s{seed}_rew"][t]) <= REWARD_ATOL, t
        assert d == bool(minted[f"s{seed}_done"][t]), t
        assert_obs(obs, minted, f"s{seed}_t{t}")
        assert _render(env) == str(minted[f"s{seed}_t{t}_render"]), t
        if d:
            obs, _ = env.reset()
            assert_obs(obs, minted, f"s{seed}_t{t}_reset")
    illegal = acts[6::7]
    assert (minted[f"s{seed}_rew"][6::7] == -1.0).all() and len(illegal) > 0


def test_save_state_replays_the_same_steps():
    env = make_balatro_env(seed=4, device="cpu")
    o, _ = env.reset()
    rng = np.random.default_rng(4)
    saved = env.save_state()
    acts, first = [], []
    for _ in range(6):
        a = int(rng.choice(np.flatnonzero(o["action_mask"])))
        o, r, d, _, _ = env.step(a)
        acts.append(a)
        first.append((r, d, o))
    env.load_state(saved)
    for a, (r1, d1, o1) in zip(acts, first):
        o2, r2, d2, _, _ = env.step(a)
        assert (r1, d1) == (r2, d2) and all(np.array_equal(o1[k], o2[k]) for k in o1)
    assert env.render() is None          # render_mode None prints nothing


def test_validator_checks_pass():
    assert BalatroEnvValidator.validate_determinism(steps=30, device="cpu")
    assert BalatroEnvValidator.validate_action_masking(steps=20, device="cpu")


def test_shell_runs_on_the_card_by_default(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        BalatroGymEnv(seed=0)


# ---------------------------------------------------------------------------
# The wrappers
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", list(WRAPPERS))
def test_wrapper_matches_reference(minted, name):
    env = WRAPPERS[name](TW, BalatroGymEnv(seed=5, device="cpu"))
    obs, info = env.reset()
    for t, a in enumerate(minted[f"w_{name}_acts"]):
        obs, r, d, _, info = env.step(int(a))
        assert abs(r - minted[f"w_{name}_rew"][t]) <= REWARD_ATOL, (name, t)
        assert d == bool(minted[f"w_{name}_done"][t]), (name, t)
        assert repr(sorted((k, v) for k, v in info.items() if k != "action_mask")) \
            == str(minted[f"w_{name}_info"][t]), (name, t)
        if isinstance(obs, dict):
            assert_obs(obs, minted, f"w_{name}_t{t}")
        else:
            want = minted[f"w_{name}_t{t}_flat"]
            assert obs.dtype == want.dtype
            np.testing.assert_array_equal(obs, want)
        if d:
            obs, info = env.reset()


def test_wrappers_are_a_copy_of_the_reference():
    """The port keeps its own copy of the numpy wrappers: the same classes
    with the same code."""
    import inspect

    from balatro_gym_tpu.envs import wrappers as JW
    for cls in ("CurriculumWrapper", "ProgressionRewardWrapper", "SafeEnvWrapper",
                "FlatObsWrapper", "_Wrapper"):
        assert inspect.getsource(getattr(TW, cls)) == inspect.getsource(getattr(JW, cls)), cls


if __name__ == "__main__" and len(sys.argv) == 3 and sys.argv[1] == "--mint":
    _mint(sys.argv[2])
