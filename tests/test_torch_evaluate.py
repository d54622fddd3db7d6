"""The port's ``evaluate_policy`` against the reference's, on the CPU.

A policy's flax parameters (``make_ppo``'s ``init_fn``) are loaded into the
port's ``ActorCritic`` with ``load_flax_params``, and both sides evaluate
it on the same seeds:

* the sim env (``sim_env_hooks()``, whose episodes end inside the
  window), in process with x64 on, as tests/test_train.py runs the
  reference and tests/test_torch_sim_env.py holds the port's sim engine:
  greedy with the anti-loop mask, and sampled at temperature 0.5;
* the flagship env (``full_env_hooks()``, the engine's step without
  autoreset), out of process in the x64-off production configuration
  (this file re-invokes itself with ``--mint <npz>``), greedy with the
  anti-loop mask and seeded observation statistics.

64 episodes of at most 32 steps each. ``episodes``, ``mean_length``,
``mean_ante`` and ``max_ante`` exact; ``mean_reward`` and ``max_reward``
within 1e-4 (PARITY #B11's reward tolerance: the reference's jit contracts
the flagship reward's multiply-adds into FMAs, and means are summed in
another order).
"""
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from balatro_gym_tpu.train import evaluate as JE
from balatro_gym_tpu.train import ppo as JP
from balatro_gym_tpu_torch.engine import sim_env
from balatro_gym_tpu_torch.ops import fused_policy_rollout as FP
from balatro_gym_tpu_torch.train import evaluate as TE
from balatro_gym_tpu_torch.train import ppo as TP
from balatro_gym_tpu_torch.train.networks import ActorCritic, load_flax_params
from balatro_gym_tpu_torch.train.normalize import RunningStats

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EPISODES, MAX_STEPS = 64, 32
HIDDEN = (32,)
FULL_SEED = 5
REWARD_ATOL = 1e-4
EXACT = ("episodes", "mean_length", "mean_ante", "max_ante")


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """This module's torch ops are many and small: one intra-op thread per
    test worker keeps parallel workers from oversubscribing the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def policy(p, obs, mask):
    return p(obs, mask)


def assert_stats(got, want, what):
    assert set(got) == set(want), what
    for k in want:
        if k in EXACT:
            assert got[k] == want[k], (what, k, got[k], want[k])
        else:
            assert abs(got[k] - float(want[k])) <= REWARD_ATOL, (what, k, got[k], want[k])


# ---------------------------------------------------------------------------
# The flagship env, out of process
# ---------------------------------------------------------------------------


def _mint(path):
    sys.path.insert(0, REPO)
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", False)
    import jax.numpy as jnp

    from balatro_gym_tpu.train.normalize import RunningStats as JStats

    cfg = JP.PPOConfig(n_envs=8, hidden=HIDDEN)
    _, _, policy_fn = JP.make_ppo(JP.full_env_hooks(), cfg)
    params = JP.make_ppo(JP.full_env_hooks(), cfg)[0](jax.random.key(1)).params
    rng = np.random.default_rng(2)
    mean = rng.normal(0, 0.2, FP.OBS_DIM).astype(np.float32)
    var = rng.uniform(0.3, 2.0, FP.OBS_DIM).astype(np.float32)
    stats = JStats(mean=jnp.asarray(mean), var=jnp.asarray(var), count=jnp.float32(100.0))
    got = JE.evaluate_policy(policy_fn, params, JP.full_env_hooks(), EPISODES, MAX_STEPS,
                             seed=FULL_SEED, obs_stats=stats)
    out = {"mean": mean, "var": var, "stats_keys": np.array(sorted(got)),
           **{f"stat_{k}": np.asarray(v) for k, v in got.items()}}
    for name, layer in params["params"].items():
        for k, v in layer.items():
            out[f"param_{name}_{k}"] = np.asarray(v)
    np.savez(path, **out)


@pytest.fixture(scope="module", autouse=True)
def mint_process(tmp_path_factory):
    """Starts the JAX side with the module, so that it runs beside the
    in-process sim tests, which come first in this file."""
    path = str(tmp_path_factory.mktemp("mint") / "evaluate.npz")
    env = dict(os.environ)
    env.pop("JAX_PLATFORMS", None)
    env["PYTHONPATH"] = os.pathsep.join(filter(None, [REPO, env.get("PYTHONPATH")]))
    proc = subprocess.Popen([sys.executable, os.path.abspath(__file__), "--mint", path],
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                            env=env, cwd=REPO)
    yield path, proc
    if proc.poll() is None:
        proc.kill()
        proc.communicate()


@pytest.fixture(scope="module")
def minted(mint_process):
    path, proc = mint_process
    out, _ = proc.communicate(timeout=900)
    assert proc.returncode == 0, out[-4000:]
    return dict(np.load(path))


# ---------------------------------------------------------------------------
# The sim env, in process
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def sim_policy():
    cfg = JP.PPOConfig(n_envs=8, hidden=HIDDEN)
    init_fn, _, policy_fn = JP.make_ppo(JP.sim_env_hooks(), cfg)
    params = init_fn(jax.random.key(0)).params
    net = load_flax_params(ActorCritic(10, sim_env.OBS_DIM, HIDDEN),
                           jax.tree.map(np.asarray, params))
    return policy_fn, params, net


@pytest.mark.parametrize("greedy,temperature", [(True, 1.0), (False, 0.5)])
def test_sim_evaluate_matches_reference(sim_policy, greedy, temperature):
    policy_fn, params, net = sim_policy
    kw = dict(n_episodes=EPISODES, max_steps=MAX_STEPS, seed=3, greedy=greedy,
              temperature=temperature)
    want = JE.evaluate_policy(policy_fn, params, JP.sim_env_hooks(), **kw)
    got = TE.evaluate_policy(policy, net, TP.sim_env_hooks(), **kw, device="cpu")
    print(greedy, temperature, got)
    assert_stats(got, want, f"sim greedy={greedy}")
    assert 0 < got["episodes"] <= EPISODES


def test_evaluate_device_rules(sim_policy, monkeypatch):
    _, _, net = sim_policy
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        TE.evaluate_policy(policy, net, TP.sim_env_hooks(), 4, 2)


def test_transcript_episode():
    """The transcript of one shell episode: a line a step, and the total."""
    class Shell:
        def __init__(self):
            self.t = 0

        def reset(self):
            self.t = 0
            return {"phase": np.int8(2), "ante": np.int16(1)}, {}

        def step(self, action):
            self.t += 1
            return ({"phase": np.int8(0), "ante": np.int16(1)}, 1.5, self.t == 3, False, {})

    lines = TE.transcript_episode(Shell(), lambda obs: 7, max_steps=10)
    assert lines == ["t=0 a=7 r=+1.50 phase=0 ante=1", "t=1 a=7 r=+1.50 phase=0 ante=1",
                     "t=2 a=7 r=+1.50 phase=0 ante=1", "episode done: total reward 4.50"]


# ---------------------------------------------------------------------------
# The flagship env against the minted run
# ---------------------------------------------------------------------------


def test_full_evaluate_matches_reference(minted):
    net = ActorCritic(FP.N_ACTIONS, FP.OBS_DIM, HIDDEN)
    tree = {"params": {}}
    for k, v in minted.items():
        if k.startswith("param_"):
            layer, leaf = k[len("param_"):].rsplit("_", 1)
            tree["params"].setdefault(layer, {})[leaf] = v
    load_flax_params(net, tree)
    stats = RunningStats(torch.as_tensor(minted["mean"]), torch.as_tensor(minted["var"]),
                         torch.tensor(100.0))
    n0 = FP.env_step_fused.launches
    got = TE.evaluate_policy(policy, net, TP.full_env_hooks(), EPISODES, MAX_STEPS,
                             seed=FULL_SEED, obs_stats=stats, device="cpu")
    assert FP.env_step_fused.launches == n0
    want = {str(k): minted[f"stat_{k}"].item() for k in minted["stats_keys"]}
    print(got)
    assert_stats(got, want, "full")
    assert "max_ante" in got


if __name__ == "__main__" and len(sys.argv) == 3 and sys.argv[1] == "--mint":
    _mint(sys.argv[2])
