"""The rank programs of the port's data-parallel tests, and the tests that
need no reference: the collectives an update calls, the launcher, the
scaling benchmark.

The mesh tests (tests/test_torch_mesh_*.py) start their ranks with
:func:`run_ranks`: ``python tests/test_torch_mesh_ranks.py <job> <dir>``
as gloo subprocesses on the CPU (``parallel.mesh.launch``, torchrun's
environment, ``PYTHONPATH=<repo>``), each reading ``<dir>/job.pkl`` and
writing ``<dir>/rank<r>.pkl``. This file imports torch, numpy and the port
only, so that a rank starts without JAX.

Jobs:

* ``ppo``: for each run, ``make_distributed_ppo(hooks, cfg, make_mesh())``
  and, from the rank's slice of a given reference state (or from
  ``init_fn(key(seed))``), ``updates`` updates; each update's state, metrics
  and parameter digest, the rollout's illegal-action count and local
  episodes;
* ``a2c``: the same for ``make_a2c(..., mesh=)``;
* ``collectives``: one update with every ``torch.distributed`` collective
  wrapped in a counter;
* ``rollouts``: ``rollout_fused_sharded`` and ``rollout_full_sharded``, fed
  and sampled.
"""
import hashlib
import os
import pickle
import subprocess
import sys
import tempfile

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:            # run as a script: the rank programs below
    sys.path.insert(0, REPO)

from balatro_gym_tpu_torch.parallel import mesh as PM      # noqa: E402
from balatro_gym_tpu_torch.parallel import scaling_bench as SB  # noqa: E402

RANK_TIMEOUT = 240      # seconds a group of ranks may take, start-up included
COLLECTIVES = ("all_reduce", "all_gather", "all_gather_into_tensor", "all_gather_object",
               "all_to_all", "all_to_all_single", "broadcast", "broadcast_object_list",
               "reduce", "reduce_scatter", "reduce_scatter_tensor", "gather", "scatter",
               "send", "recv", "isend", "irecv", "batch_isend_irecv", "barrier")


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def run_ranks(job: str, nprocs: int, spec: dict, timeout: float = RANK_TIMEOUT) -> list:
    """Run ``job`` on ``nprocs`` gloo ranks on the CPU with ``spec``; each
    rank's result."""
    with tempfile.TemporaryDirectory() as tmp:
        with open(os.path.join(tmp, "job.pkl"), "wb") as f:
            pickle.dump(spec, f)
        env = dict(os.environ, PYTHONPATH=os.pathsep.join(
            filter(None, [REPO, os.environ.get("PYTHONPATH")])))
        env.pop("JAX_PLATFORMS", None)
        PM.launch([sys.executable, os.path.abspath(__file__), job, tmp], nprocs,
                  timeout=timeout, env=env, cwd=REPO)
        out = []
        for r in range(nprocs):
            with open(os.path.join(tmp, f"rank{r}.pkl"), "rb") as f:
                out.append(pickle.load(f))
        return out


# ---------------------------------------------------------------------------
# A learner's state as numpy arrays
# ---------------------------------------------------------------------------


def env_arrays(env_states) -> dict:
    """A batched env state as numpy arrays: packed rows (``envp/``, envs on
    the last axis) or a dataclass's fields (``envd/``, envs on the first)."""
    if isinstance(env_states, dict):
        return {f"envp/{k}": v.cpu().numpy() for k, v in env_states.items()}
    return {f"envd/{k}": v.cpu().numpy() for k, v in vars(env_states).items()}


def state_arrays(ts) -> dict:
    """A PPO or A2C state as flat numpy arrays."""
    from balatro_gym_tpu_torch.train.ppo import param_list
    out = {f"params/{i}": p.detach().cpu().numpy() for i, p in enumerate(param_list(ts.params))}
    opt = ts.opt_state
    for name in ("mu", "nu"):
        for i, t in enumerate(getattr(opt, name, ())):
            out[f"{name}/{i}"] = t.cpu().numpy()
    if hasattr(opt, "count"):
        out["count"] = np.asarray(opt.count)
    for name in ("obs_stats", "ret_stats"):
        if hasattr(ts, name):
            for k, v in vars(getattr(ts, name)).items():
                out[f"{name}/{k}"] = v.cpu().numpy()
    if hasattr(ts, "ret_carry"):
        out["ret_carry"] = ts.ret_carry.cpu().numpy()
    out["key"] = np.asarray(ts.key, np.int64)
    out["update_idx"] = np.asarray(ts.update_idx)
    out.update(env_arrays(ts.env_states))
    return out


def digest(net) -> str:
    from balatro_gym_tpu_torch.train.ppo import param_list
    h = hashlib.sha256()
    for p in param_list(net):
        h.update(p.detach().cpu().numpy().tobytes())
    return h.hexdigest()


def slice_reference(ref: dict, lo: int, n: int, packed: bool) -> dict:
    """Rank's slice of a reference state (``load_reference_state``'s form):
    its envs and return carry."""
    env = ref["env_states"]
    env = ({k: np.asarray(v)[..., lo:lo + n] for k, v in env.items()} if packed
           else {k: np.asarray(v)[lo:lo + n] for k, v in env.items()})
    out = dict(ref, env_states=env)
    if "ret_carry" in ref:
        out["ret_carry"] = np.asarray(ref["ret_carry"])[lo:lo + n]
    return out


# ---------------------------------------------------------------------------
# The rank programs
# ---------------------------------------------------------------------------


def _hooks(spec):
    from balatro_gym_tpu_torch.train import ppo as TP
    return TP.sim_env_hooks() if spec["env"] == "sim" else TP.full_env_hooks()


def _illegal(traj):
    ok = traj.mask.gather(2, traj.action.long()[..., None])[..., 0] | ~traj.mask.any(2)
    return int((~ok).sum())


def job_ppo(spec, mesh):
    from balatro_gym_tpu_torch.ops import kernel_rng as KR
    from balatro_gym_tpu_torch.train import ppo as TP
    hooks, results = _hooks(spec), []
    for run in spec["runs"]:
        cfg = TP.PPOConfig(**run["cfg"])
        init_fn, step_fn, _ = PM.make_distributed_ppo(hooks, cfg, mesh)
        starts = run.get("starts")
        if starts is None:
            states = [init_fn([int(w) for w in KR.seed_key(run["seed"], device="cpu")])]
        else:
            states = [TP.load_reference_state(hooks, cfg, s[mesh.rank], device="cpu")
                      for s in starts]
        out = []
        ts = states[0]
        for u in range(run["updates"]):
            if starts is not None:
                ts = states[u]
            rec = {}
            ts, m = step_fn(ts, record=rec)
            out.append({"state": state_arrays(ts), "digest": digest(ts.params),
                        "metrics": {k: float(v) for k, v in m.items()},
                        "illegal": _illegal(rec["traj"]),
                        "local_episodes": int(rec["traj"].done.sum())})
        results.append(out)
    return results


def job_a2c(spec, mesh):
    from balatro_gym_tpu_torch.train import a2c as TA
    hooks, results = _hooks(spec), []
    for run in spec["runs"]:
        cfg = TA.A2CConfig(**run["cfg"])
        _, update_fn = TA.make_a2c(hooks, cfg, device="cpu", mesh=mesh)
        out = []
        for s in run["starts"]:
            ts = TA.load_reference_a2c_state(hooks, cfg, s[mesh.rank], device="cpu")
            ts, m = update_fn(ts)
            out.append({"state": state_arrays(ts), "digest": digest(ts.params),
                        "metrics": {k: float(v) for k, v in m.items()}})
        results.append(out)
    return results


def job_collectives(spec, mesh):
    """Counts of every collective one update calls, by name."""
    import torch.distributed as dist
    from balatro_gym_tpu_torch.ops import kernel_rng as KR
    from balatro_gym_tpu_torch.train import ppo as TP
    cfg = TP.PPOConfig(**spec["cfg"])
    init_fn, step_fn, _ = PM.make_distributed_ppo(_hooks(spec), cfg, mesh)
    ts = init_fn([int(w) for w in KR.seed_key(0, device="cpu")])
    counts = {}

    def counting(name, fn):
        def call(*args, **kw):
            counts[name] = counts.get(name, 0) + 1
            return fn(*args, **kw)
        return call

    saved = {n: getattr(dist, n) for n in COLLECTIVES if hasattr(dist, n)}
    for n, fn in saved.items():
        setattr(dist, n, counting(n, fn))
    try:
        ts, m = step_fn(ts)
    finally:
        for n, fn in saved.items():
            setattr(dist, n, fn)
    return {"counts": counts, "digest": digest(ts.params),
            "metrics": {k: float(v) for k, v in m.items()}}


def job_rollouts(spec, mesh):
    from balatro_gym_tpu_torch.ops import fused_full_rollout as FF
    out = {}
    for name, kw in spec["fused"].items():
        res = PM.rollout_fused_sharded(kw["seed"], kw["n_envs"], kw["n_steps"], kw["jokers"],
                                       mesh=mesh, actions=kw.get("actions"))
        out[f"fused {name}"] = {k: v.numpy() for k, v in res.items()}
    for name, kw in spec["full"].items():
        init = kw.get("init_state")
        res = PM.rollout_full_sharded(
            kw["seed"], kw["n_envs"], kw["n_steps"], mesh=mesh, actions=kw.get("actions"),
            init_state=None if init is None else FF.unpack_full_state(
                {k: torch.as_tensor(v) for k, v in init.items()}))
        out[f"full {name}"] = {"total_reward": res["total_reward"].numpy(),
                              "episodes": res["episodes"].numpy(),
                              **{f"packed/{k}": v.numpy()
                                 for k, v in FF.pack_full_state(res["state"]).items()}}
    return out


JOBS = {"ppo": job_ppo, "a2c": job_a2c, "collectives": job_collectives,
        "rollouts": job_rollouts}


def rank_main(job, tmp):
    torch.set_num_threads(1)
    with open(os.path.join(tmp, "job.pkl"), "rb") as f:
        spec = pickle.load(f)
    PM.init_distributed(device="cpu")
    try:
        mesh = PM.make_mesh(device="cpu")
        result = {"rank": mesh.rank, "size": mesh.size, "backend": (
            torch.distributed.get_backend() if torch.distributed.is_initialized() else None),
            "result": JOBS[job](spec, mesh)}
    finally:
        PM.destroy()
    with open(os.path.join(tmp, f"rank{mesh.rank}.pkl"), "wb") as f:
        pickle.dump(result, f)


# ---------------------------------------------------------------------------
# Tests
# ---------------------------------------------------------------------------

TINY = dict(n_envs=16, rollout_len=4, epochs=2, minibatches=2, hidden=(32,))


@pytest.mark.parametrize("env_name,extra", [
    ("sim", {}), ("sim", {"normalize_obs": False}),
    ("full", {"n_envs": 32, "rollout_len": 2, "fused_rollout": True})],
    ids=["sim", "sim-no-obs-norm", "full-fused"])
def test_update_calls_only_all_reduce(env_name, extra):
    """The counterpart of tests/test_checkpoint_scaling.py's collectives
    test: one distributed update over 2 ranks calls ``all_reduce`` and no
    other collective, once a minibatch (gradients and approx-KL in one
    buffer), twice for each running statistic and once for the metrics."""
    cfg = {**TINY, **extra}
    res = run_ranks("collectives", 2, {"env": env_name, "cfg": cfg})
    stats = 2 * (cfg.get("normalize_obs", True) + cfg.get("normalize_reward", True))
    want = {"all_reduce": cfg["epochs"] * cfg["minibatches"] + stats + 1}
    for r in res:
        assert r["backend"] == "gloo" and r["size"] == 2
        assert r["result"]["counts"] == want, (r["rank"], r["result"]["counts"], want)
        assert all(np.isfinite(v) for v in r["result"]["metrics"].values())
    assert res[0]["result"]["digest"] == res[1]["result"]["digest"]
    assert res[0]["result"]["metrics"] == res[1]["result"]["metrics"]


def test_launch_raises_for_a_failing_rank_and_kills_the_rest():
    """A rank that fails makes ``launch`` raise with its output at once,
    and a rank left waiting is killed rather than hanging the caller."""
    code = ("import os, sys, time\n"
            "if os.environ['RANK'] == '1': sys.exit('rank 1 gives up')\n"
            "time.sleep(600)\n")
    with pytest.raises(RuntimeError, match="rank 1 gives up"):
        PM.launch([sys.executable, "-c", code], 2, timeout=120)
    with pytest.raises(TimeoutError):
        PM.launch([sys.executable, "-c", "import time; time.sleep(600)"], 2, timeout=3)


RENDEZVOUS = r"""
import sys
import torch
from balatro_gym_tpu_torch.parallel import mesh as PM

pid, port = int(sys.argv[1]), sys.argv[2]
assert PM.init_distributed(f"127.0.0.1:{port}", 2, pid, device="cpu")
assert torch.distributed.get_backend() == "gloo"
mesh = PM.make_mesh(device="cpu")
t = torch.tensor([float(pid + 1)])
mesh.mean_(t)
sub = PM.make_mesh(1, device="cpu")           # every rank makes the sub-group
print("RESULT", mesh.rank, mesh.size, float(t), None if sub is None else (sub.rank, sub.size))
PM.destroy()
"""


def test_explicit_rendezvous_and_a_sub_mesh():
    """``init_distributed(coordinator, 2, pid)`` joins two processes over
    tcp (the reference's ``jax.distributed.initialize`` arguments); the
    mean over the mesh is the same on both; ``make_mesh(1)`` is rank 0's
    mesh of one and None on rank 1."""
    port = PM.free_port()
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        filter(None, [REPO, os.environ.get("PYTHONPATH")])))
    for k in ("WORLD_SIZE", "RANK", "MASTER_ADDR", "MASTER_PORT"):
        env.pop(k, None)
    procs = [subprocess.Popen([sys.executable, "-c", RENDEZVOUS, str(i), str(port)],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                              env=env, cwd=REPO) for i in range(2)]
    try:
        outs = [p.communicate(timeout=RANK_TIMEOUT)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    lines = []
    for p, out in zip(procs, outs):
        assert p.returncode == 0, out[-3000:]
        lines.append([ln for ln in out.splitlines() if ln.startswith("RESULT")][0])
    assert lines == ["RESULT 0 2 1.5 (0, 1)", "RESULT 1 2 1.5 None"], lines


def test_mesh_of_one_without_a_process_group():
    """With no process group ``make_mesh`` is a mesh of one that reduces
    nothing, ``n_devices`` beyond it raises, and ``init_distributed``
    without a launcher does nothing (as the reference's on one host)."""
    assert not PM.init_distributed(num_processes=1)
    mesh = PM.make_mesh(device="cpu")
    assert (mesh.group, mesh.rank, mesh.size, mesh.device.type, mesh.axis) == (
        None, 0, 1, "cpu", PM.DATA_AXIS)
    t = torch.arange(3.0)
    assert mesh.mean_(t) is t and torch.equal(t, torch.arange(3.0))
    with pytest.raises(ValueError, match="no process group"):
        PM.make_mesh(2, device="cpu")
    assert PM.default_backend(2, "cpu") == "gloo"


def test_entry_points_default_to_the_card(monkeypatch):
    """With no card, the mesh, the sharded rollouts, the distributed CLI
    and the scaling benchmark raise unless asked for the CPU."""
    from balatro_gym_tpu_torch.train import cli as TCLI
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for call in (PM.make_mesh,
                 lambda: PM.rollout_fused_sharded(0, 2048, 1, (1, 31, 34, 48, 72)),
                 lambda: PM.rollout_full_sharded(0, 1024, 1),
                 lambda: TCLI.main(["--distributed", "--updates", "1", "--summary", ""])):
        with pytest.raises(RuntimeError, match="no CUDA card"):
            call()
    with pytest.raises(SystemExit, match="no CUDA card"):
        SB.main([])
    assert PM.make_mesh(device="cpu").device.type == "cpu"


def test_scaling_bench_measures_and_prints_the_reference_keys(capsys):
    """``measure`` over 1 and 2 gloo ranks gives finite positive rates, and
    ``main`` prints the reference's keys (the efficiency of ranks sharing
    this host's cores says nothing about cards)."""
    t1 = SB.measure(1, envs_per_dev=16, rollout=4, updates=2, device="cpu")
    t2 = SB.measure(2, envs_per_dev=16, rollout=4, updates=2, device="cpu")
    assert np.isfinite(t1) and np.isfinite(t2) and t1 > 0 and t2 > 0
    out = SB.main(["--device", "cpu", "--nproc", "2", "--envs-per-dev", "16", "--rollout", "4",
                   "--updates", "1"])
    printed = [ln for ln in capsys.readouterr().out.splitlines() if ln.startswith("{")]
    assert len(printed) == 1 and set(out) == {
        "metric", "env", "n_devices", "steps_per_sec_1dev", "steps_per_sec_ndev", "value",
        "unit", "vs_baseline"}
    assert out["n_devices"] == 2 and out["metric"] == "dp_scaling_efficiency"
    assert out["steps_per_sec_1dev"] > 0 and out["steps_per_sec_ndev"] > 0


if __name__ == "__main__":
    rank_main(sys.argv[1], sys.argv[2])
