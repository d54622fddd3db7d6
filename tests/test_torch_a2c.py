"""The port's A2C learner (``train/a2c.py``) against the reference's, on the
CPU.

(a) The sim-env learner, in process (x64, as tests/conftest.py sets it and
    as the port's sim engine computes): the reference's
    ``make_a2c(sim_env_hooks(), A2CConfig(n_envs=16, rollout_len=4,
    hidden=(32,)))`` from ``init_fn(key(0))``; its state is carried into
    the port (``load_reference_a2c_state``) before each of two updates, and
    both sides run one update. The reference's actions are recorded from
    inside its jitted update; its rewards and dones come from replaying
    them through its own env.
(b) The flagship env's learner, out of process with x64 off (the
    production configuration): this file re-invokes itself with ``--mint
    <npz>``; that process runs two jitted updates of the same config on
    ``full_env_hooks()`` from ``init_fn(key(0))`` with seeded non-trivial
    observation statistics, and saves the state before and after each,
    the metrics, the recorded actions and their replayed rewards and dones.
(c) The optimizer against optax, the port of tests/test_a2c_dqn.py's
    A2C case, a learning test and the device rule.

Tolerances. Env states, actions, rewards and dones are exact; an action
may differ only where the two largest Gumbel-perturbed logits lie within
1e-5 (the seeded data has none). Parameters and RMSprop's ``nu`` agree
within 1e-6 absolute after an update; the metrics within 1e-6 relative
plus 1e-6 absolute (the value loss of the sim env is O(1e3)); the running
statistics within 1e-5 relative plus 1e-6 absolute, as in
tests/test_torch_ppo.py (means of normalised observations).
"""
import dataclasses
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from balatro_gym_tpu.engine import sim_env as JSIM
from balatro_gym_tpu.train import a2c as JA
from balatro_gym_tpu.train import ppo as JP
from balatro_gym_tpu_torch.ops import fused_full_rollout as TFF
from balatro_gym_tpu_torch.ops import fused_policy_rollout as FP
from balatro_gym_tpu_torch.ops import kernel_rng as KR
from balatro_gym_tpu_torch.train import a2c as TA
from balatro_gym_tpu_torch.train import ppo as TP

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = dict(n_envs=16, rollout_len=4, hidden=(32,))
UPDATES = 2
PARAM_ATOL = 1e-6
METRIC_TOL = 1e-6
STATS_RTOL, STATS_ATOL = 1e-5, 1e-6
METRICS = ("loss", "pg_loss", "vf_loss", "entropy", "mean_reward", "episodes")
TINYF = float(np.finfo(np.float32).tiny)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def ref_state(ts, full):
    """The reference's A2CState in ``load_reference_a2c_state``'s form."""
    from balatro_gym_tpu.ops import fused_full_rollout as JFF
    if full:
        env = {k: np.asarray(v) for k, v in JFF.pack_full_state(ts.env_states).items()}
    else:
        env = {f.name: np.asarray(jax.random.key_data(v) if f.name == "key" else v)
               for f in dataclasses.fields(ts.env_states)
               for v in [getattr(ts.env_states, f.name)]}
    return {"params": jax.tree.map(np.asarray, ts.params),
            "nu": jax.tree.map(np.asarray, ts.opt_state[1][0].nu),
            "obs_stats": tuple(np.asarray(x) for x in (ts.obs_stats.mean, ts.obs_stats.var,
                                                       ts.obs_stats.count)),
            "key": np.asarray(jax.random.key_data(ts.key)),
            "update_idx": int(ts.update_idx), "env_states": env}


def near_ties(key, logits, tol=1e-5):
    """[B] bool: envs whose two largest Gumbel-perturbed logits (draw
    ``b * A + a`` of ``key``) lie within ``tol``."""
    n, a = logits.shape
    u = KR.uniform_f32(KR.random_bits32(*key, torch.arange(n * a).view(n, a)), TINYF, 1.0)
    top2 = (logits + (-torch.log(-torch.log(u)))).topk(2, 1).values
    return (top2[:, 0] - top2[:, 1]) <= tol


def assert_actions(rec, ref_actions, ts0, key):
    """The port's actions equal the reference's but at near-ties."""
    keys = KR.split_keys(KR.split_keys(key, 2)[1], rec["action"].shape[0])
    for t, want in enumerate(ref_actions):
        same = rec["action"][t].numpy() == np.asarray(want)
        if not same.all():
            with torch.no_grad():
                logits, _ = ts0.params(rec["obs"][t], rec["mask"][t])
            assert near_ties(keys[t], logits).numpy()[~same].all(), t
        assert same.all(), f"step {t}: a near-tie flipped an action"


def assert_learner(port, ref, what, metrics=None, ref_metrics=None):
    got = TP.param_list(port.params)
    for name, leaves, want in (("params", got, TP._flax_leaves(port.params, ref["params"])),
                               ("nu", port.opt_state.nu, TP._flax_leaves(port.params, ref["nu"]))):
        for i, (g, w) in enumerate(zip(leaves, want)):
            np.testing.assert_allclose(g.detach().numpy(), w.numpy(), rtol=0, atol=PARAM_ATOL,
                                       err_msg=f"{what}: {name}[{i}]")
    assert port.key == tuple(int(w) for w in ref["key"]) and port.update_idx == ref["update_idx"]
    for got_s, want_s in zip(vars(port.obs_stats).values(), ref["obs_stats"]):
        np.testing.assert_allclose(got_s.numpy(), want_s, rtol=STATS_RTOL, atol=STATS_ATOL,
                                   err_msg=f"{what}: obs_stats")
    if metrics is not None:
        assert set(metrics) == set(ref_metrics) == set(METRICS)
        for k in METRICS:
            np.testing.assert_allclose(float(metrics[k]), float(ref_metrics[k]),
                                       rtol=METRIC_TOL, atol=METRIC_TOL, err_msg=f"{what}: {k}")


# ---------------------------------------------------------------------------
# (a) the sim-env learner, in process
# ---------------------------------------------------------------------------


@pytest.fixture
def recorded_actions(monkeypatch):
    """The reference's sampled actions, recorded from inside its jitted
    update (``jax.random.categorical`` is looked up while tracing)."""
    got = []
    orig = jax.random.categorical

    def categorical(key, logits, *args, **kw):
        out = orig(key, logits, *args, **kw)
        jax.debug.callback(lambda a: got.append(np.asarray(a)), out, ordered=True)
        return out

    monkeypatch.setattr(jax.random, "categorical", categorical)
    return got


def test_sim_update_matches_reference(recorded_actions):
    cfg = TA.A2CConfig(**TINY)
    init_fn, update_fn = JA.make_a2c(JP.sim_env_hooks(), JA.A2CConfig(**TINY))
    step = jax.jit(lambda ts: update_fn(ts))
    replay = jax.jit(jax.vmap(JSIM.step_autoreset))
    _, t_update = TA.make_a2c(TP.sim_env_hooks(), cfg, device="cpu")
    ts = init_fn(jax.random.key(0))
    for u in range(UPDATES):
        before = ref_state(ts, False)
        port = TA.load_reference_a2c_state(TP.sim_env_hooks(), cfg, before, device="cpu")
        assert_learner(port, before, f"update {u} loaded")
        ts0 = TA.load_reference_a2c_state(TP.sim_env_hooks(), cfg, before, device="cpu")
        n_rec = len(recorded_actions)
        ts_next, metrics = step(ts)
        jax.block_until_ready(ts_next.params)
        acts = recorded_actions[n_rec:]
        assert len(acts) == cfg.rollout_len
        rec = {}
        port, t_metrics = t_update(port, record=rec)
        assert_actions(rec, acts, ts0, before["key"])
        st = ts.env_states
        for t in range(cfg.rollout_len):
            st, reward, done = replay(st, jnp.asarray(acts[t]))
            np.testing.assert_array_equal(rec["reward"][t].numpy(), np.asarray(reward, np.float32))
            np.testing.assert_array_equal(rec["done"][t].numpy(), np.asarray(done))
        want = ref_state(ts_next, False)
        for f in dataclasses.fields(port.env_states):
            np.testing.assert_array_equal(getattr(port.env_states, f.name).numpy().astype(np.int64),
                                          want["env_states"][f.name].astype(np.int64),
                                          err_msg=f"update {u}: {f.name}")
        assert_learner(port, want, f"update {u}", t_metrics, metrics)
        ts = ts_next


def test_init_matches_reference():
    """init_fn's env states, statistics and key are the reference's; the
    weights come from a torch.Generator seeded with the k_net words."""
    ref = ref_state(JA.make_a2c(JP.sim_env_hooks(), JA.A2CConfig(**TINY))[0](
        jax.random.key(0)), False)
    init_fn, _ = TA.make_a2c(TP.sim_env_hooks(), TA.A2CConfig(**TINY), device="cpu")
    ts = init_fn([int(w) for w in KR.seed_key(0, device="cpu")])
    for f in dataclasses.fields(ts.env_states):
        np.testing.assert_array_equal(getattr(ts.env_states, f.name).numpy().astype(np.int64),
                                      ref["env_states"][f.name].astype(np.int64), err_msg=f.name)
    assert ts.key == tuple(int(w) for w in ref["key"]) and ts.update_idx == 0
    assert not any(v.any() for v in ts.opt_state.nu)
    for got, want in zip(vars(ts.obs_stats).values(), ref["obs_stats"]):
        np.testing.assert_array_equal(got.numpy(), want)


# ---------------------------------------------------------------------------
# (b) the flagship env's learner, out of process
# ---------------------------------------------------------------------------


def _mint(path):
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", False)
    from balatro_gym_tpu.engine import full_env as fe
    from balatro_gym_tpu.ops import fused_policy_rollout as JFP
    from balatro_gym_tpu.train import normalize as JN

    got, out = [], {}
    orig = jax.random.categorical

    def categorical(key, logits, *args, **kw):
        res = orig(key, logits, *args, **kw)
        jax.debug.callback(lambda a: got.append(np.asarray(a)), res, ordered=True)
        return res

    jax.random.categorical = categorical
    cfg = JA.A2CConfig(**TINY)
    init_fn, update_fn = JA.make_a2c(JP.full_env_hooks(), cfg)
    rng = np.random.default_rng(4)
    ts = init_fn(jax.random.key(0)).replace(obs_stats=JN.RunningStats(
        mean=jnp.asarray(rng.normal(0, 0.3, JFP.OBS_DIM), jnp.float32),
        var=jnp.asarray(rng.uniform(0.2, 2.0, JFP.OBS_DIM), jnp.float32),
        count=jnp.float32(5000.0)))
    step = jax.jit(lambda ts: update_fn(ts))
    replay = jax.jit(jax.vmap(fe.step_autoreset))
    for u in range(UPDATES):
        _flatten(f"before{u}", ref_state(ts, True), out)
        start = ts.env_states
        got.clear()
        ts, metrics = step(ts)
        jax.block_until_ready(ts.params)
        _flatten(f"after{u}", ref_state(ts, True), out)
        for k, v in metrics.items():
            out[f"metric{u}_{k}"] = np.asarray(v)
        st = start
        for t in range(cfg.rollout_len):
            out[f"action{u}_{t}"] = got[t]
            st, reward, done = replay(st, jnp.asarray(got[t]))
            out[f"reward{u}_{t}"], out[f"done{u}_{t}"] = np.asarray(reward), np.asarray(done)
    np.savez(path, **out)


def _flatten(prefix, tree, out):
    if isinstance(tree, dict):
        for k, v in tree.items():
            _flatten(f"{prefix}/{k}", v, out)
    elif isinstance(tree, tuple):
        for i, v in enumerate(tree):
            _flatten(f"{prefix}/#{i}", v, out)
    else:
        out[prefix] = np.asarray(tree)
    return out


def _unflatten(m, prefix):
    root = {}
    for name, v in m.items():
        if name.startswith(prefix + "/"):
            parts = name[len(prefix) + 1:].split("/")
            d = root
            for p in parts[:-1]:
                d = d.setdefault(p, {})
            d[parts[-1]] = v

    def fix(d):
        if not isinstance(d, dict):
            return d
        if d and all(k.startswith("#") for k in d):
            return tuple(fix(d[f"#{i}"]) for i in range(len(d)))
        return {k: fix(v) for k, v in d.items()}
    return fix(root)


@pytest.fixture(scope="module")
def minted(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("mint") / "a2c.npz")
    env = dict(os.environ)
    env.pop("JAX_PLATFORMS", None)
    env["PYTHONPATH"] = os.pathsep.join(filter(None, [REPO, env.get("PYTHONPATH")]))
    res = subprocess.run([sys.executable, os.path.abspath(__file__), "--mint", path],
                         capture_output=True, text=True, timeout=900, env=env, cwd=REPO)
    assert res.returncode == 0, (res.stdout + res.stderr)[-4000:]
    return dict(np.load(path))


@pytest.mark.parametrize("u", range(UPDATES))
def test_full_update_matches_reference(minted, u):
    """One update on the flagship env over the generic path (the engine's
    step, K3b's observation and mask: their plain versions here)."""
    cfg = TA.A2CConfig(**TINY)
    hooks = TP.full_env_hooks()
    before = _unflatten(minted, f"before{u}")
    ts = TA.load_reference_a2c_state(hooks, cfg, before, device="cpu")
    ts0 = TA.load_reference_a2c_state(hooks, cfg, before, device="cpu")
    _, update_fn = TA.make_a2c(hooks, cfg, device="cpu")
    n0 = (FP.observe_fused.launches, FP.env_step_fused.launches)
    rec = {}
    out, metrics = update_fn(ts, record=rec)
    assert (FP.observe_fused.launches, FP.env_step_fused.launches) == n0   # no kernel on the CPU
    assert_actions(rec, [minted[f"action{u}_{t}"] for t in range(cfg.rollout_len)], ts0,
                   before["key"])
    for t in range(cfg.rollout_len):
        np.testing.assert_array_equal(rec["reward"][t].numpy(), minted[f"reward{u}_{t}"])
        np.testing.assert_array_equal(rec["done"][t].numpy(), minted[f"done{u}_{t}"])
    want = _unflatten(minted, f"after{u}")
    packed = TFF.pack_full_state(out.env_states)
    for k in ("cards", "ints", "rng"):
        w = want["env_states"][k]
        w = w.astype(np.uint32).view(np.int32) if k == "rng" else w
        np.testing.assert_array_equal(packed[k].numpy(), w, err_msg=k)
    assert_learner(out, want, f"full update {u}", metrics,
                   {k: minted[f"metric{u}_{k}"] for k in METRICS})


# ---------------------------------------------------------------------------
# (c) the optimizer, the reference's smoke test, learning, the device rule
# ---------------------------------------------------------------------------


def test_rmsprop_is_optax_rmsprop():
    """Three steps of ``rmsprop_update`` against optax's ``chain(
    clip_by_global_norm(0.5), rmsprop(lr, decay=0.99, eps=1e-5))`` from the
    same gradients, one of them above the clip."""
    import optax
    rng = np.random.default_rng(0)
    shapes = [(5, 3), (3,)]
    p0 = [rng.normal(size=s).astype(np.float32) for s in shapes]
    grads = [[(rng.normal(size=s) * scale).astype(np.float32) for s in shapes]
             for scale in (0.05, 3.0, 0.1)]
    tx = optax.chain(optax.clip_by_global_norm(0.5), optax.rmsprop(7e-4, decay=0.99, eps=1e-5))
    jp = [jnp.asarray(x) for x in p0]
    js = tx.init(jp)
    tp = [torch.tensor(x) for x in p0]
    ts = TP.rmsprop_init(tp)
    for g in grads:
        upd, js = tx.update([jnp.asarray(x) for x in g], js, jp)
        jp = optax.apply_updates(jp, upd)
        ts = TP.rmsprop_update(tp, [torch.tensor(x) for x in g], ts, 7e-4, 0.5)
    for a, b, n, m in zip(tp, jp, ts.nu, js[1][0].nu):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0, atol=1e-7)
        np.testing.assert_allclose(n.numpy(), np.asarray(m), rtol=1e-6, atol=0)


def test_a2c_update_moves_params():
    """tests/test_a2c_dqn.py's A2C case on the port."""
    init_fn, update_fn = TA.make_a2c(TP.sim_env_hooks(), TA.A2CConfig(n_envs=16, rollout_len=4,
                                                                      hidden=(16,)),
                                     device="cpu")
    ts = init_fn([0, 0])
    p0 = TP.param_list(ts.params)[0].detach().clone()
    ts, m = update_fn(ts)
    assert np.isfinite(float(m["loss"]))
    assert not torch.equal(p0, TP.param_list(ts.params)[0])


def test_a2c_learns_on_the_sim_env():
    """A learning test, not a running one: A2C's defaults at 64 envs on the
    sim env from seed 0; the mean reward of the last 10 of 60 updates beats
    that of the first 10 (measured: 15.5 -> 108.2, ~4 s)."""
    init_fn, update_fn = TA.make_a2c(TP.sim_env_hooks(), TA.A2CConfig(n_envs=64),
                                     device="cpu")
    ts = init_fn([int(w) for w in KR.seed_key(0, device="cpu")])
    rewards = []
    for _ in range(60):
        ts, m = update_fn(ts)
        rewards.append(float(m["mean_reward"]))
    assert np.mean(rewards[-10:]) > np.mean(rewards[:10]), rewards


def test_no_device_means_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for call in (lambda: TA.make_a2c(TP.sim_env_hooks(), TA.A2CConfig(**TINY)),
                 lambda: TA.train(1, TA.A2CConfig(**TINY))):
        with pytest.raises(RuntimeError, match="no CUDA card"):
            call()


if __name__ == "__main__" and len(sys.argv) == 3 and sys.argv[1] == "--mint":
    _mint(sys.argv[2])
