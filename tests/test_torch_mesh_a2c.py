"""The port's data-parallel A2C (``train.a2c.make_a2c(..., mesh=)``) against
the reference's ``update_fn(ts, axis_name)`` under ``shard_map``, on the
CPU: the sim env, in process with x64 (as tests/test_torch_a2c.py runs
it).

The reference has no distributed A2C driver; its ``axis_name`` path is run
here as ``make_distributed_ppo`` runs PPO's: ``shard_map`` over 2 of the
conftest's virtual CPU devices, env states sharded, the rest replicated,
each shard's metrics kept (A2C reduces none). The port runs as 2 gloo
ranks (tests/test_torch_mesh_ranks.py), each loading its shard of the
reference's state before each of 2 updates. Each rank's env states equal
the reference's shard bit for bit; parameters, RMSprop's ``nu`` and the
statistics are within tests/test_torch_a2c.py's tolerances and equal
across ranks; each rank's metrics are its own shard's, within
tests/test_torch_a2c.py's metric tolerance.
"""
import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, PartitionSpec as P

from balatro_gym_tpu.train import a2c as JA
from balatro_gym_tpu.train import ppo as JP
from balatro_gym_tpu_torch.train import a2c as TA
from balatro_gym_tpu_torch.train import ppo as TP
from tests.test_torch_a2c import METRIC_TOL, METRICS, TINY, ref_state
from tests.test_torch_mesh_ppo import RANKS, assert_state
from tests.test_torch_mesh_ranks import run_ranks, slice_reference, state_arrays

UPDATES = 2


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def sharded_update(update_fn, ts, mesh):
    """The reference's ``update_fn(ts, axis_name="dp")`` under shard_map,
    each shard's metrics stacked ``[RANKS]``."""
    rep = lambda tree: jax.tree.map(lambda _: P(), tree)       # noqa: E731
    specs = ts.replace(params=rep(ts.params), opt_state=rep(ts.opt_state),
                       env_states=jax.tree.map(lambda _: P("dp"), ts.env_states), key=P(),
                       obs_stats=rep(ts.obs_stats), update_idx=P())

    def body(t):
        out, m = update_fn(t, axis_name="dp")
        return out, {k: v[None] for k, v in m.items()}

    return jax.jit(jax.shard_map(body, mesh=mesh, in_specs=(specs,),
                                 out_specs=(specs, {k: P("dp") for k in METRICS}),
                                 check_vma=False))


def test_sim_update_matches_reference_mesh():
    init_fn, update_fn = JA.make_a2c(JP.sim_env_hooks(), JA.A2CConfig(**TINY))
    mesh = Mesh(np.asarray(jax.devices()[:RANKS]), ("dp",))
    ts = init_fn(jax.random.key(0))
    step = sharded_update(update_fn, ts, mesh)
    states, metrics = [jax.tree.map(np.array, ref_state(ts, False))], []
    for _ in range(UPDATES):
        ts, m = step(ts)
        states.append(jax.tree.map(np.array, ref_state(ts, False)))
        metrics.append({k: np.asarray(v) for k, v in m.items()})
    n = TINY["n_envs"] // RANKS
    res = run_ranks("a2c", RANKS, {"env": "sim", "runs": [{"cfg": TINY, "starts": [
        [slice_reference(s, r * n, n, False) for r in range(RANKS)] for s in states[:-1]]}]})
    cfg, hooks = TA.A2CConfig(**TINY), TP.sim_env_hooks()
    for u in range(UPDATES):
        outs = [r["result"][0][u] for r in res]
        assert outs[0]["digest"] == outs[1]["digest"], f"update {u}: params differ"
        for r, out in enumerate(outs):
            what = f"a2c update {u} rank {r}"
            want = state_arrays(TA.load_reference_a2c_state(
                hooks, cfg, slice_reference(states[u + 1], r * n, n, False), device="cpu"))
            assert_state(out["state"], want, what)
            assert set(out["metrics"]) == set(METRICS)
            for k in METRICS:
                np.testing.assert_allclose(out["metrics"][k], metrics[u][k][r], rtol=METRIC_TOL,
                                           atol=METRIC_TOL, err_msg=f"{what}: {k}")
    # the metrics are each rank's own: the shards' rewards differ
    assert any(metrics[u]["mean_reward"][0] != metrics[u]["mean_reward"][1]
               for u in range(UPDATES))
