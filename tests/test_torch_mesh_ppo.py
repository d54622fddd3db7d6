"""The port's data-parallel PPO (``parallel.mesh.make_distributed_ppo``)
against the reference's, on the CPU: the sim env.

The reference runs in process (x64, as tests/conftest.py sets it and as
tests/test_torch_ppo.py runs it): ``make_distributed_ppo(sim_env_hooks(),
PPOConfig(**TINY, **case), make_mesh(2))`` from ``init_fn(key(0))``, two
updates on the conftest's virtual CPU devices, for every case of
tests/test_torch_ppo.py and one without the gradient clip. The port runs as 2 gloo ranks
(tests/test_torch_mesh_ranks.py): before each update, rank ``r`` loads
shard ``r`` of the reference's state (its envs and return carry; the rest
replicated) and takes one update. Rank ``r``'s env states equal the
reference's shard ``r`` bit for bit after each update (so its actions,
keys folded with the rank and shard-local resets were the reference's);
parameters, Adam moments, statistics, the return carry and the metrics are
within tests/test_torch_ppo.py's tolerances (``assert_learner``'s), and the
ranks' parameters are equal bit for bit. A mesh of one rank, without a
process group, against the reference's 1-device mesh, in process.

The parameters' tolerance grows with the learning rate: Adam's first steps
move a parameter by ``lr * g / (|g| + 1e-5)``, so where a gradient cancels
to near zero a float-order difference ``dg`` of it (the ranks' gradients
are summed in another order in XLA and in torch) moves the parameter by up
to ``lr * dg / 1e-5``. At the default lr (3e-4) the bound is
tests/test_torch_ppo.py's ``PARAM_ATOL`` (1e-6); it scales with ``lr /
3e-4`` above it. The largest difference measured was 2.0e-6, in the
``kl_target`` case (lr 3e-3), on a weight whose gradient was -3.7e-7 and
whose gradients differed by 1.2e-8 (Adam's ``mu`` by 1.2e-9).
"""
import jax
import numpy as np
import pytest
import torch

from balatro_gym_tpu.parallel import mesh as JM
from balatro_gym_tpu.train import ppo as JP
from balatro_gym_tpu_torch.parallel import mesh as PM
from balatro_gym_tpu_torch.train import ppo as TP
from tests.test_torch_mesh_ranks import run_ranks, slice_reference, state_arrays
from tests.test_torch_ppo import (ATOL, CASES, METRICS, PARAM_ATOL, RTOL, STATS_ATOL, TINY,
                                  ref_state)

UPDATES = 2
RANKS = 2
# tests/test_torch_ppo.py's cases, and one without the gradient clip: the
# clip rescales the gradients to a fixed norm, so only unclipped gradients
# (Adam's moments) show that the ranks' gradients are averaged, not summed
MESH_CASES = {**CASES, "unclipped": {"max_grad_norm": 1e9}}


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def snapshot(ts, packed=False):
    """The reference's state in ``load_reference_state``'s form, copied
    (the distributed step donates its input)."""
    return jax.tree.map(np.array, ref_state(ts, packed))


def reference_run(hooks, cfg, n_devices, updates=UPDATES, packed=False):
    """(states before and after each update, metrics of each) of the
    reference's distributed learner over ``make_mesh(n_devices)``; the
    flagship env's states ``packed``."""
    init_fn, step_fn, _ = JM.make_distributed_ppo(hooks, cfg, JM.make_mesh(n_devices))
    ts = init_fn(jax.random.key(0))
    states, metrics = [snapshot(ts, packed)], []
    for _ in range(updates):
        ts, m = step_fn(ts)
        states.append(snapshot(ts, packed))
        metrics.append({k: float(v) for k, v in m.items()})
    return states, metrics


def assert_close(got, want, what, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(np.asarray(got, np.float64), np.asarray(want, np.float64),
                               rtol=rtol, atol=atol, err_msg=what)


def param_atol(lr: float) -> float:
    """The parameters' tolerance at learning rate ``lr`` (module docstring)."""
    return PARAM_ATOL * max(1.0, lr / 3e-4)


def assert_state(got: dict, want: dict, what: str, lr: float = 3e-4):
    """A rank's state (``state_arrays``) against the reference's shard in
    the same form: env states, counts and keys exact, the rest within
    ``assert_learner``'s tolerances (the parameters' at ``lr``)."""
    assert set(got) == set(want), (what, set(got) ^ set(want))
    for k, w in want.items():
        g = got[k]
        if k.startswith("params/"):
            assert_close(g, w, f"{what}: {k}", rtol=0, atol=param_atol(lr))
        elif k.startswith(("mu/", "nu/")):
            assert_close(g, w, f"{what}: {k}", rtol=0, atol=PARAM_ATOL)
        elif k.startswith(("obs_stats/", "ret_stats/")):
            assert_close(g, w, f"{what}: {k}", atol=STATS_ATOL)
        elif k == "ret_carry":
            assert_close(g, w, f"{what}: {k}")
        else:
            np.testing.assert_array_equal(g, w, err_msg=f"{what}: {k}")


def assert_metrics(got: dict, want: dict, what: str, keys=METRICS):
    assert set(got) == set(want) == set(keys), what
    for k in keys:
        assert_close(got[k], want[k], f"{what}: metric {k}")


def rank_starts(states, n_envs, packed=False):
    """For each update, each rank's slice of the reference's state before it."""
    n = n_envs // RANKS
    return [[slice_reference(s, r * n, n, packed) for r in range(RANKS)] for s in states[:-1]]


def expected(hooks, cfg, state, lo, n, packed=False):
    """The reference's state, shard ``lo .. lo + n - 1``, as a rank's
    ``state_arrays``."""
    return state_arrays(TP.load_reference_state(
        hooks, cfg, slice_reference(state, lo, n, packed), device="cpu"))


@pytest.fixture(scope="module")
def reference():
    return {case: reference_run(JP.sim_env_hooks(), JP.PPOConfig(**TINY, **MESH_CASES[case]),
                                RANKS) for case in MESH_CASES}


@pytest.fixture(scope="module")
def ranks(reference):
    runs = [{"cfg": {**TINY, **MESH_CASES[case]}, "updates": UPDATES,
             "starts": rank_starts(reference[case][0], TINY["n_envs"])}
            for case in MESH_CASES]
    res = run_ranks("ppo", RANKS, {"env": "sim", "runs": runs})
    assert [r["rank"] for r in res] == list(range(RANKS)) and all(r["backend"] == "gloo"
                                                                 for r in res)
    return {case: [r["result"][i] for r in res] for i, case in enumerate(MESH_CASES)}


@pytest.mark.parametrize("case", list(MESH_CASES))
def test_sim_update_matches_reference_mesh(case, reference, ranks):
    states, metrics = reference[case]
    cfg = TP.PPOConfig(**TINY, **MESH_CASES[case])
    hooks, n = TP.sim_env_hooks(), TINY["n_envs"] // RANKS
    for u in range(UPDATES):
        outs = [ranks[case][r][u] for r in range(RANKS)]
        assert outs[0]["digest"] == outs[1]["digest"], f"{case} update {u}: params differ"
        assert outs[0]["metrics"] == outs[1]["metrics"], f"{case} update {u}"
        for r, out in enumerate(outs):
            what = f"{case} update {u} rank {r}"
            assert_state(out["state"], expected(hooks, cfg, states[u + 1], r * n, n), what,
                         cfg.lr)
            assert_metrics(out["metrics"], metrics[u], what)
        assert sum(o["local_episodes"] for o in outs) == outs[0]["metrics"]["episodes"]
    if case == "kl_target":         # the reduced KL stopped the update part-way
        assert 0 < metrics[0]["kl_skipped"] < 1, metrics


def test_mesh_of_one_matches_reference_one_device_mesh():
    """A mesh of one rank (no process group) against the reference's
    1-device mesh: the same update as the single-device learner's, with
    the rank (0) folded into the keys."""
    cfg = TP.PPOConfig(**TINY, env_shuffle=True)
    states, metrics = reference_run(JP.sim_env_hooks(), JP.PPOConfig(**TINY, env_shuffle=True), 1)
    hooks = TP.sim_env_hooks()
    mesh = PM.make_mesh(device="cpu")
    _, step_fn, _ = PM.make_distributed_ppo(hooks, cfg, mesh)
    for u in range(UPDATES):
        ts = TP.load_reference_state(hooks, cfg, states[u], device="cpu")
        ts, m = step_fn(ts)
        what = f"mesh of one, update {u}"
        assert_state(state_arrays(ts), expected(hooks, cfg, states[u + 1], 0, TINY["n_envs"]),
                     what)
        assert_metrics({k: float(v) for k, v in m.items()}, metrics[u], what)


def test_mesh_size_must_divide_the_envs():
    mesh = PM.Mesh(None, 0, 3, torch.device("cpu"))
    with pytest.raises(ValueError, match="not divisible by mesh size 3"):
        PM.make_distributed_ppo(TP.sim_env_hooks(), TP.PPOConfig(**TINY), mesh)
    with pytest.raises(ValueError, match="env_shuffle"):     # 8 envs a rank % 3 minibatches
        PM.make_distributed_ppo(TP.sim_env_hooks(), TP.PPOConfig(
            **{**TINY, "minibatches": 3}, env_shuffle=True), PM.Mesh(None, 0, 2, torch.device(
                "cpu")))


def test_train_distributed_is_the_update_loop():
    """``train_distributed`` (the reference's driver) runs ``init_fn(key(seed))``
    and the distributed updates: the same parameters and metrics as the
    loop written out."""
    cfg, mesh = TP.PPOConfig(**TINY), PM.make_mesh(device="cpu")
    ts, metrics = PM.train_distributed(2, cfg, mesh, seed=3, hooks=TP.sim_env_hooks())
    init_fn, step_fn, _ = PM.make_distributed_ppo(TP.sim_env_hooks(), cfg, mesh)
    want = init_fn([0, 3])
    for _ in range(2):
        want, m = step_fn(want)
    assert ts.update_idx == 2 and {k: float(v) for k, v in metrics.items()} == {
        k: float(v) for k, v in m.items()}
    for a, b in zip(TP.param_list(ts.params), TP.param_list(want.params)):
        assert torch.equal(a, b)
