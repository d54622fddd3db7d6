"""The port's sharded whole-rollout kernels (``parallel.mesh.
rollout_fused_sharded``, K4, and ``rollout_full_sharded``, K2) on the CPU,
over 2 gloo ranks (tests/test_torch_mesh_ranks.py; the kernels' plain
versions run on the CPU).

* The sim rollout, fed, at 2 x 2048 envs x 4 steps over the six joker sets
  of tests/test_fused_rollout.py: each rank's shard equals the reference's
  ``rollout_fused_sharded(..., interpret=True)`` on a 2-device mesh, minted
  out of process with x64 off (the production configuration), and the
  port's one-process call: bit for bit but the reference's reward totals,
  which are within one float32 ulp a step (the interpret-mode kernel on
  XLA:CPU rounds about 10% of the totals the other way, with x64 on or off,
  by at most 2 ulp in 4 steps; tests/test_torch_fused_rollout.py holds the
  plain version's totals to the engine's within 2e-3). Sampled: each rank equals
  ``rollout_fused(seed + rank * n_local_tiles, 2048, ...)`` (one 2048-env
  tile a rank).
* The flagship rollout at 2 x 1024 envs x 4 steps from the default reset:
  fed, each rank equals the port's one-process call over all 2048 envs,
  sliced; sampled, each rank equals ``rollout_full_fused(seed + rank, 1024,
  ...)`` from its slice of the reference's ``_default_reset(seed, 2048)``,
  minted out of process with x64 off, which the port's ``default_reset(seed,
  1024, first=rank * 1024)`` also equals.
"""
import os
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

from balatro_gym_tpu_torch.ops import fused_full_rollout as FF
from balatro_gym_tpu_torch.ops import fused_rollout as FR
from balatro_gym_tpu_torch.parallel import mesh as PM
from tests.test_torch_mesh_ranks import run_ranks

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RANKS = 2
SIM_ENVS, FULL_ENVS, STEPS = RANKS * PM.FUSED_TILE, RANKS * PM.FULL_TILE, 4
JOKER_SETS = np.asarray((
    (0, 0, 0, 0, 0), (1, 31, 34, 48, 72), (6, 7, 131, 135, 0), (18, 69, 16, 23, 108),
    (116, 118, 119, 2, 3), (147, 140, 128, 122, 61)), np.int32)   # tests/test_fused_rollout.py
BENCH_JOKERS = (1, 31, 34, 48, 72)
SIM_FIELDS = ("hand_rank", "hand_suit", "deck_n", "money", "hands_left", "discards_left",
              "score", "episodes", "total_reward")
SEED = 5


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def make_script():
    rng = np.random.default_rng(5)
    return {"jokers": JOKER_SETS[np.arange(SIM_ENVS) % len(JOKER_SETS)],
            "sim_actions": rng.integers(0, 5, (STEPS, SIM_ENVS)).astype(np.int32),
            "full_actions": rng.integers(0, 60, (STEPS, FULL_ENVS)).astype(np.int32)}


def _mint(path):
    from balatro_gym_tpu.ops import fused_full_rollout as JFF
    from balatro_gym_tpu.parallel import mesh as JM
    sc = make_script()
    out = {f"reset/{k}": np.asarray(v) for k, v in JFF.pack_full_state(
        JFF._default_reset(SEED, FULL_ENVS)).items()}
    sim = JM.rollout_fused_sharded(0, SIM_ENVS, STEPS, sc["jokers"], mesh=JM.make_mesh(RANKS),
                                   actions=sc["sim_actions"], interpret=True)
    out.update({f"sim/{k}": np.asarray(v) for k, v in sim.items()})
    np.savez(path, **out)


@pytest.fixture(scope="module", autouse=True)
def mint_process(tmp_path_factory):
    """Starts the reference's side with the module."""
    env = dict(os.environ)
    env.pop("JAX_PLATFORMS", None)
    env["PYTHONPATH"] = os.pathsep.join(filter(None, [REPO, env.get("PYTHONPATH")]))
    path = str(tmp_path_factory.mktemp("mint") / "rollouts.npz")
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
    log, _ = proc.communicate(timeout=900)
    assert proc.returncode == 0, log[-4000:]
    return dict(np.load(path))


@pytest.fixture(scope="module")
def reference_reset(minted):
    """The reference's packed reset rows, its uint32 rng words as the port's
    int32 bit patterns."""
    rows = {k[len("reset/"):]: v for k, v in minted.items() if k.startswith("reset/")}
    return dict(rows, rng=rows["rng"].astype(np.uint32).view(np.int32))


def packed(state):
    return {k: v.numpy() for k, v in FF.pack_full_state(state).items()}


@pytest.fixture(scope="module")
def script():
    return make_script()


@pytest.fixture(scope="module")
def ranks(script):
    """The ranks' runs; the given-init run starts from the port's default
    reset, which test_full_sharded_default_reset_is_the_reference_slice
    holds against the reference's."""
    init = packed(FF.default_reset(SEED, FULL_ENVS, "cpu"))
    spec = {
        "fused": {
            "fed": dict(seed=0, n_envs=SIM_ENVS, n_steps=STEPS, jokers=script["jokers"],
                        actions=script["sim_actions"]),
            "sampled": dict(seed=SEED, n_envs=SIM_ENVS, n_steps=STEPS, jokers=BENCH_JOKERS)},
        "full": {
            "fed": dict(seed=SEED, n_envs=FULL_ENVS, n_steps=STEPS,
                        actions=script["full_actions"]),
            "sampled": dict(seed=SEED, n_envs=FULL_ENVS, n_steps=STEPS),
            "sampled_given_init": dict(seed=SEED, n_envs=FULL_ENVS, n_steps=STEPS,
                                       init_state=init)}}
    res = run_ranks("rollouts", RANKS, spec)
    assert [r["rank"] for r in res] == list(range(RANKS))
    return [r["result"] for r in res]


def test_fused_sharded_fed_matches_reference_and_one_process(script, ranks, minted):
    ref = {k[len("sim/"):]: v for k, v in minted.items() if k.startswith("sim/")}
    one = FR.rollout_fused(0, SIM_ENVS, STEPS, script["jokers"], actions=script["sim_actions"],
                           device="cpu")
    n = PM.FUSED_TILE
    for r in range(RANKS):
        got = ranks[r]["fused fed"]
        for k in SIM_FIELDS:
            want = ref[k][r * n:(r + 1) * n]
            if k == "total_reward":
                np.testing.assert_array_max_ulp(got[k], want, maxulp=STEPS)
            else:
                np.testing.assert_array_equal(got[k], want,
                                              err_msg=f"rank {r}: {k} vs the reference")
            np.testing.assert_array_equal(got[k], one[k].numpy()[r * n:(r + 1) * n],
                                          err_msg=f"rank {r}: {k} vs one process")
    assert one["episodes"].sum() > 0


def test_fused_sharded_sampled_strides_the_seed(ranks):
    n = PM.FUSED_TILE
    for r in range(RANKS):
        want = FR.rollout_fused(SEED + r * (n // PM.FUSED_TILE), n, STEPS, BENCH_JOKERS,
                                device="cpu")
        for k in SIM_FIELDS:
            np.testing.assert_array_equal(ranks[r]["fused sampled"][k], want[k].numpy(),
                                          err_msg=f"rank {r}: {k}")
    assert not np.array_equal(ranks[0]["fused sampled"]["total_reward"],
                              ranks[1]["fused sampled"]["total_reward"])


def test_full_sharded_fed_matches_one_process(script, ranks):
    one = FF.rollout_full_fused(SEED, FULL_ENVS, STEPS, actions=script["full_actions"],
                                device="cpu")
    want = {"total_reward": one["total_reward"].numpy(), "episodes": one["episodes"].numpy(),
            **{f"packed/{k}": v for k, v in packed(one["state"]).items()}}
    n = PM.FULL_TILE
    for r in range(RANKS):
        for k, v in want.items():
            np.testing.assert_array_equal(ranks[r]["full fed"][k], v[..., r * n:(r + 1) * n],
                                          err_msg=f"rank {r}: {k}")


def test_full_sharded_default_reset_is_the_reference_slice(ranks, reference_reset):
    n = PM.FULL_TILE
    for r in range(RANKS):
        mine = packed(FF.default_reset(SEED, n, "cpu", first=r * n))
        for k, v in reference_reset.items():
            np.testing.assert_array_equal(mine[k], v[..., r * n:(r + 1) * n],
                                          err_msg=f"rank {r}: default reset {k}")
        init = FF.unpack_full_state({k: torch.as_tensor(v[..., r * n:(r + 1) * n].copy())
                                     for k, v in reference_reset.items()})
        one = FF.rollout_full_fused(SEED + r * (n // PM.FULL_TILE), n, STEPS, init_state=init,
                                    device="cpu")
        want = {"total_reward": one["total_reward"].numpy(), "episodes": one["episodes"].numpy(),
                **{f"packed/{k}": v for k, v in packed(one["state"]).items()}}
        for name in ("full sampled", "full sampled_given_init"):
            for k, v in want.items():
                np.testing.assert_array_equal(ranks[r][name][k], v,
                                              err_msg=f"rank {r} {name}: {k}")


def test_full_sharded_needs_whole_tiles():
    mesh = PM.Mesh(None, 0, 2, torch.device("cpu"))
    with pytest.raises(ValueError, match="multiple of the kernel tile"):
        PM.rollout_full_sharded(SEED, 2 * 512, 1, mesh=mesh)
    with pytest.raises(ValueError, match="not divisible"):
        PM.rollout_fused_sharded(SEED, 2049, 1, BENCH_JOKERS, mesh=mesh)


if __name__ == "__main__":
    _mint(sys.argv[2])
