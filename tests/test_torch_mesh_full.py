"""The port's data-parallel PPO on the flagship env, on the CPU.

(a) The generic update (the engine's ``step_autoreset``, ``observe_vector``
    and ``action_mask``: the plain versions on the CPU) against the
    reference's, minted out of process with x64 off (the production
    configuration; tests/conftest.py turns x64 on): this file re-invokes
    itself with ``--mint <pkl>``, which runs the reference's
    ``make_distributed_ppo(full_env_hooks(), PPOConfig(n_envs=16,
    rollout_len=2, epochs=1, minibatches=2, hidden=(16,)), make_mesh(2))``
    on 2 virtual CPU devices for 2 jitted updates from ``init_fn(key(0))``.
    The port's 2 gloo ranks (tests/test_torch_mesh_ranks.py) each load
    their shard of the reference's state before each update and take one;
    each rank's env states equal the reference's shard bit for bit, the
    rest is held as in tests/test_torch_mesh_ppo.py.
(b) The fused update (the collection's plain versions on the CPU: K3b, the
    sampler and K3a's) with bf16 and env_shuffle on 2 ranks from
    ``init_fn``: every action legal under its mask, the ranks' parameters
    equal bit for bit after every update, the metrics equal on both ranks
    and ``episodes`` the sum of the ranks' own counts.
"""
import os
import pickle
import subprocess
import sys

if __name__ == "__main__":          # the mint: JAX's devices and x64 before any import uses it
    import jax
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_num_cpu_devices", 2)
    jax.config.update("jax_enable_x64", False)

import numpy as np
import pytest
import torch

from balatro_gym_tpu_torch.train import ppo as TP
from tests.test_torch_mesh_ppo import (RANKS, assert_metrics, assert_state, expected,
                                       rank_starts)
from tests.test_torch_mesh_ranks import run_ranks

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GENERIC = dict(n_envs=16, rollout_len=2, epochs=1, minibatches=2, hidden=(16,))
UPDATES = 2
FUSED = dict(n_envs=64, rollout_len=4, epochs=1, minibatches=2, hidden=(16,),
             fused_rollout=True, bf16_compute=True, env_shuffle=True)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _mint(path):
    from balatro_gym_tpu.train import ppo as JP
    from tests.test_torch_mesh_ppo import reference_run

    out = reference_run(JP.full_env_hooks(), JP.PPOConfig(**GENERIC), RANKS, UPDATES,
                        packed=True)
    with open(path, "wb") as f:
        pickle.dump(out, f)


@pytest.fixture(scope="module", autouse=True)
def mint_process(tmp_path_factory):
    """Starts the reference's side with the module, so that it runs beside
    the fused ranks' test."""
    env = dict(os.environ)
    env.pop("JAX_PLATFORMS", None)
    env["PYTHONPATH"] = os.pathsep.join(filter(None, [REPO, env.get("PYTHONPATH")]))
    path = str(tmp_path_factory.mktemp("mint") / "full_mesh.pkl")
    proc = subprocess.Popen([sys.executable, os.path.abspath(__file__), "--mint", path],
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                            env=env, cwd=REPO)
    yield path, proc
    if proc.poll() is None:
        proc.kill()
        proc.communicate()


def test_fused_update_over_two_ranks():
    res = run_ranks("ppo", RANKS, {"env": "full", "runs": [
        {"cfg": FUSED, "updates": UPDATES, "seed": 0}]})
    outs = [r["result"][0] for r in res]
    for u in range(UPDATES):
        a, b = outs[0][u], outs[1][u]
        assert a["illegal"] == b["illegal"] == 0, u
        assert a["digest"] == b["digest"], f"update {u}: the ranks' parameters differ"
        assert a["metrics"] == b["metrics"], u
        assert all(np.isfinite(v) for v in a["metrics"].values()), a["metrics"]
        assert a["local_episodes"] + b["local_episodes"] == a["metrics"]["episodes"], u
        for k in a["state"]:                        # each rank keeps its own envs
            if k.startswith("envp/"):
                assert a["state"][k].shape[-1] == FUSED["n_envs"] // RANKS
    assert any(not np.array_equal(outs[0][0]["state"][k], outs[1][0]["state"][k])
               for k in outs[0][0]["state"] if k.startswith("envp/"))


def test_generic_update_matches_reference_mesh(mint_process):
    path, proc = mint_process
    log, _ = proc.communicate(timeout=900)
    assert proc.returncode == 0, log[-4000:]
    with open(path, "rb") as f:
        states, metrics = pickle.load(f)
    cfg = TP.PPOConfig(**GENERIC)
    hooks, n = TP.full_env_hooks(), GENERIC["n_envs"] // RANKS
    res = run_ranks("ppo", RANKS, {"env": "full", "runs": [
        {"cfg": GENERIC, "updates": UPDATES,
         "starts": rank_starts(states, GENERIC["n_envs"], packed=True)}]})
    for u in range(UPDATES):
        outs = [r["result"][0][u] for r in res]
        assert outs[0]["digest"] == outs[1]["digest"], f"update {u}: params differ"
        for r, out in enumerate(outs):
            what = f"full generic update {u} rank {r}"
            assert_state(out["state"], expected(hooks, cfg, states[u + 1], r * n, n, True), what)
            assert_metrics(out["metrics"], metrics[u], what)
            assert out["illegal"] == 0


if __name__ == "__main__":
    _mint(sys.argv[2])
