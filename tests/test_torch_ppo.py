"""The port's PPO learner against the reference's, on the CPU.

(a) The sim-env learner, in process (x64, as tests/conftest.py sets it and
    as tests/test_train.py runs the reference): the reference's
    ``make_ppo(sim_env_hooks(), PPOConfig(n_envs=16, rollout_len=4,
    epochs=2, minibatches=2, hidden=(32,)))`` starts from ``init_fn(key(0))``;
    its state is carried into the port (``load_reference_state``) before
    each of two updates, and both sides run one ``update_fn``. The
    reference's actions are recorded from inside its jitted update, and its
    rewards and dones come from replaying them through its own env.
(b) The flagship env's fused learner, out of process with x64 off (the
    production configuration): this file re-invokes itself with ``--mint
    <npz>``; that process binds the reference's ``step_tiles`` and
    ``observe_tiles`` to their plain twins ``step_tiles_rows`` and
    ``observe_tiles_rows`` (module attributes set in that process; the JAX
    package is not edited), and runs one update of ``PPOConfig(n_envs=1024,
    rollout_len=2, epochs=2, minibatches=2, fused_rollout=True)`` under
    ``jax.disable_jit()`` (op by op, as the port computes), with and without
    ``env_shuffle``, from ``init_fn(key(0))`` with seeded non-trivial
    observation and return statistics, recording every step's action,
    log-prob, value, reward and done.
(c) GAE against a numpy loop; (d) ``permutation`` against
    ``jax.random.permutation`` at one- and two-round sizes; (e) the CLI;
    (f) the entry points' device rule.

Tolerances (measured here, then set with margin). Env states, actions,
raw rewards and dones are exact. An action may differ only where the two
largest Gumbel-perturbed logits lie within 1e-5, in at most 0.1% of envs
(the fused sampler's rule, tests/test_torch_policy_rollout.py); such envs
are left out of later comparisons (the seeded data has none). Parameters
and Adam moments agree within 1e-6 absolute after one update (the largest
differences measured were 3.3e-7 for the parameters at lr 3e-3, 3e-8 on
the fused path, 1.0e-8 for ``mu`` and 2.2e-11 for ``nu``): matmuls and
reductions sum in another order in XLA and in torch, and the reference's
jit may turn ``x / sqrt(v)`` into a reciprocal multiply. Metrics,
log-probs, values and the return carry agree within 1e-5 relative plus
1e-7 absolute; the running statistics within 1e-5 relative plus 1e-6
absolute (their means are averages of normalised observations that differ
in the last bit; 9.5e-6 was the largest difference measured, on a variance
near 1).
"""
import copy
import dataclasses
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from balatro_gym_tpu.engine import sim_env as JSIM
from balatro_gym_tpu.ops import fused_full_rollout as JFF
from balatro_gym_tpu.ops import fused_policy_rollout as JFP
from balatro_gym_tpu.train import normalize as JN
from balatro_gym_tpu.train import ppo as JP
from balatro_gym_tpu_torch.engine import full_env as TFE
from balatro_gym_tpu_torch.ops import fused_full_rollout as TFF
from balatro_gym_tpu_torch.ops import fused_policy_rollout as FP
from balatro_gym_tpu_torch.ops import kernel_rng as KR
from balatro_gym_tpu_torch.train import cli as TCLI
from balatro_gym_tpu_torch.train import ppo as TP

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PARAM_ATOL = 1e-6
RTOL, ATOL = 1e-5, 1e-7
STATS_ATOL = 1e-6     # means of normalised observations, O(1) values summed
TINY = dict(n_envs=16, rollout_len=4, epochs=2, minibatches=2, hidden=(32,))
FUSED = dict(n_envs=1024, rollout_len=2, epochs=2, minibatches=2, fused_rollout=True)
GENERIC = dict(n_envs=1024, rollout_len=2, epochs=2, minibatches=2)   # FUSED, not fused
TINYF = float(np.finfo(np.float32).tiny)
CASES = {
    "default": {},
    "env_shuffle": {"env_shuffle": True},
    # lr 3e-3 makes the second minibatch's approx-KL ~1e-4, far above the
    # target, and the first one's (params not yet moved) ~1e-9, far below
    "kl_target": {"kl_target": 1e-6, "lr": 3e-3},
    "cycle_penalty": {"cycle_penalty": 0.05},
    "reset_envs_every": {"reset_envs_every": 2},
    "schedules": {"total_updates": 2, "lr_final": 5e-5, "ent_coef_final": 5e-4},
}
METRICS = ("loss", "pg_loss", "vf_loss", "entropy", "mean_reward", "episodes", "approx_kl",
           "kl_skipped")


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """This module's torch ops are many and small: one intra-op thread per
    test worker keeps parallel workers from oversubscribing the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# The reference's state as numpy arrays
# ---------------------------------------------------------------------------


def ref_state(ts, fused):
    """The reference's TrainState in ``load_reference_state``'s form."""
    adam = ts.opt_state[1][0]
    if fused:
        env = {k: np.asarray(v) for k, v in JFF.pack_full_state(ts.env_states).items()}
    else:
        env = {f.name: np.asarray(jax.random.key_data(v) if f.name == "key" else v)
               for f in dataclasses.fields(ts.env_states)
               for v in [getattr(ts.env_states, f.name)]}
    return {"params": jax.tree.map(np.asarray, ts.params),
            "mu": jax.tree.map(np.asarray, adam.mu), "nu": jax.tree.map(np.asarray, adam.nu),
            "count": int(adam.count),
            "obs_stats": tuple(np.asarray(x) for x in (ts.obs_stats.mean, ts.obs_stats.var,
                                                       ts.obs_stats.count)),
            "ret_stats": tuple(np.asarray(x) for x in (ts.ret_stats.mean, ts.ret_stats.var,
                                                       ts.ret_stats.count)),
            "ret_carry": np.asarray(ts.ret_carry),
            "key": np.asarray(jax.random.key_data(ts.key)),
            "update_idx": int(ts.update_idx), "env_states": env}


def flatten(prefix, tree, out):
    """A nested dict/tuple of arrays as flat ``prefix/...`` npz entries."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            flatten(f"{prefix}/{k}", v, out)
    elif isinstance(tree, tuple):
        for i, v in enumerate(tree):
            flatten(f"{prefix}/#{i}", v, out)
    else:
        out[prefix] = np.asarray(tree)
    return out


def unflatten(m, prefix):
    root = {}
    for name, v in m.items():
        if not name.startswith(prefix + "/"):
            continue
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


def assert_close(got, want, what, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(np.asarray(got, np.float64), np.asarray(want, np.float64),
                               rtol=rtol, atol=atol, err_msg=what)


def assert_learner(port, ref, what, metrics=None, ref_metrics=None):
    """Parameters, moments, counts, statistics, carry and key of the port's
    state against the reference's (``ref_state`` form)."""
    leaves = TP.param_list(port.params)
    for name, got, want in (
            ("params", leaves, TP._flax_leaves(port.params, ref["params"])),
            ("mu", port.opt_state.mu, TP._flax_leaves(port.params, ref["mu"])),
            ("nu", port.opt_state.nu, TP._flax_leaves(port.params, ref["nu"]))):
        for i, (g, w) in enumerate(zip(got, want)):
            assert_close(g.detach(), w, f"{what}: {name}[{i}]", rtol=0, atol=PARAM_ATOL)
    assert port.opt_state.count == ref["count"], what
    assert port.update_idx == ref["update_idx"] and port.key == tuple(int(w) for w in ref["key"])
    for name in ("obs_stats", "ret_stats"):
        for got, want in zip(vars(getattr(port, name)).values(), ref[name]):
            assert_close(got, want, f"{what}: {name}", atol=STATS_ATOL)
    assert_close(port.ret_carry, ref["ret_carry"], f"{what}: ret_carry")
    if metrics is not None:
        assert set(metrics) == set(ref_metrics) == set(METRICS)
        for k in METRICS:
            assert_close(metrics[k], ref_metrics[k], f"{what}: metric {k}")


def near_ties(key, logits, idx, tol=1e-5):
    """[B] bool: envs whose two largest Gumbel-perturbed logits lie within
    ``tol`` (draw ``idx`` [B, A] of ``key``)."""
    u = KR.uniform_f32(KR.random_bits32(*key, idx), TINYF, 1.0)
    top2 = (logits + (-torch.log(-torch.log(u)))).topk(2, 1).values
    return (top2[:, 0] - top2[:, 1]) <= tol


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


def rollout_start(ts, cfg):
    """The env states the reference's rollout starts from: its staggered
    reset (ppo.py:405-420) applied to ``ts.env_states``."""
    if not cfg.reset_envs_every:
        return ts.env_states
    k_reset = jax.random.split(ts.key, 4)[3]
    n = cfg.n_envs
    lanes = ((ts.update_idx + jnp.arange(n)) % cfg.reset_envs_every) == 0
    fresh = jax.vmap(JSIM.reset)(jax.random.split(k_reset, n))
    return jax.tree.map(lambda a, b: jnp.where(lanes.reshape((-1,) + (1,) * (a.ndim - 1)), a, b),
                        fresh, ts.env_states)


def assert_sim_states(port, ref_env, what):
    for f in dataclasses.fields(port):
        got = getattr(port, f.name).numpy().astype(np.int64)
        want = np.asarray(ref_env[f.name]).astype(np.int64)
        np.testing.assert_array_equal(got, want, err_msg=f"{what}: {f.name}")


@pytest.mark.parametrize("case", list(CASES))
def test_sim_update_matches_reference(case, recorded_actions):
    jcfg = JP.PPOConfig(**TINY, **CASES[case])
    tcfg = TP.PPOConfig(**TINY, **CASES[case])
    init_fn, update_fn, _ = JP.make_ppo(JP.sim_env_hooks(), jcfg)
    step = jax.jit(update_fn)
    replay = jax.jit(jax.vmap(JSIM.step_autoreset))
    _, t_update, _ = TP.make_ppo(TP.sim_env_hooks(), tcfg, device="cpu")
    ts = init_fn(jax.random.key(0))
    skipped = []
    for u in range(2):
        port = TP.load_reference_state(TP.sim_env_hooks(), tcfg, ref_state(ts, False),
                                       device="cpu")
        assert_learner(port, ref_state(ts, False), f"update {u} loaded")
        start = rollout_start(ts, jcfg)
        n_rec = len(recorded_actions)
        ts_next, metrics = step(ts)
        jax.block_until_ready(ts_next.params)
        acts = recorded_actions[n_rec:]
        assert len(acts) == jcfg.rollout_len
        rec = {}
        port, t_metrics = t_update(port, record=rec)
        traj = rec["traj"]
        np.testing.assert_array_equal(traj.action.numpy(), np.stack(acts))
        st = start
        for t in range(jcfg.rollout_len):
            st, reward, done = replay(st, jnp.asarray(acts[t]))
            np.testing.assert_array_equal(rec["raw"][t].numpy(), np.asarray(reward, np.float32))
            np.testing.assert_array_equal(traj.done[t].numpy(), np.asarray(done))
        want = ref_state(ts_next, False)
        for k in want["env_states"]:                      # the replay ends where the update did
            np.testing.assert_array_equal(
                np.asarray(jax.random.key_data(st.key) if k == "key" else getattr(st, k)),
                want["env_states"][k])
        assert_sim_states(port.env_states, want["env_states"], f"{case} update {u}")
        assert_learner(port, want, f"{case} update {u}", t_metrics, metrics)
        skipped.append(float(t_metrics["kl_skipped"]))
        ts = ts_next
    if case == "kl_target":
        assert 0 < skipped[0] < 1, skipped


def test_init_matches_reference():
    """init_fn's env states, statistics and key are the reference's; the
    weights are drawn from a torch.Generator seeded with the k_net words."""
    cfg = TP.PPOConfig(**TINY)
    ref = ref_state(JP.make_ppo(JP.sim_env_hooks(), JP.PPOConfig(**TINY))[0](
        jax.random.key(0)), False)
    init_fn = TP.make_ppo(TP.sim_env_hooks(), cfg, device="cpu")[0]
    ts = init_fn([int(w) for w in KR.seed_key(0, device="cpu")])
    assert_sim_states(ts.env_states, ref["env_states"], "init")
    assert ts.key == tuple(int(w) for w in ref["key"]) and ts.update_idx == 0
    assert ts.opt_state.count == 0 and not any(m.any() for m in ts.opt_state.mu)
    for name in ("obs_stats", "ret_stats"):
        for got, want in zip(vars(getattr(ts, name)).values(), ref[name]):
            np.testing.assert_array_equal(got.numpy(), want)
    assert not ts.ret_carry.any()
    again = init_fn([int(w) for w in KR.seed_key(0, device="cpu")])
    for a, b in zip(TP.param_list(ts.params), TP.param_list(again.params)):
        assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# (b) the fused flagship learner, out of process
# ---------------------------------------------------------------------------


def _mint(path):
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", False)
    out, log, replayed = {}, [], {}

    def recording(name, fn):
        def run(*args, **kw):
            res = fn(*args, **kw)
            log.append((name, res))
            return res
        return run

    def replaying(name, fn, n_in):
        """The rows twin, or, in the second update, the first update's
        output for the same inputs (the rollouts are the same)."""
        def run(*args, interpret=False):
            i = sum(1 for n, _ in log if n == name)
            prev = replayed.get((name, i))
            if prev is not None and all(np.array_equal(a, b) for a, b in zip(args, prev[0])):
                res = prev[1]
            else:
                res = fn(*args)
            replayed[(name, i)] = (tuple(np.asarray(a) for a in args[:n_in]), res)
            log.append((name, res))
            return res
        return run

    JFP.step_tiles = replaying("step", JFP.step_tiles_rows, 4)
    JFP.observe_tiles = replaying("observe", JFP.observe_tiles_rows, 3)
    JFP.sample_fm = recording("sample", JFP.sample_fm)
    JFP.policy_apply_fm = recording("policy", JFP.policy_apply_fm)

    base = JP.PPOConfig(**FUSED)
    ts = JP.make_ppo(JP.full_env_hooks(), base)[0](jax.random.key(0))
    rng = np.random.default_rng(3)
    ts = ts.replace(
        obs_stats=JN.RunningStats(
            mean=jnp.asarray(rng.normal(0, 0.3, JFP.OBS_DIM), jnp.float32),
            var=jnp.asarray(rng.uniform(0.2, 2.0, JFP.OBS_DIM), jnp.float32),
            count=jnp.float32(5000.0)),
        ret_stats=JN.RunningStats(mean=jnp.float32(0.3), var=jnp.float32(2.5),
                                  count=jnp.float32(5000.0)),
        ret_carry=jnp.asarray(rng.normal(0, 1, base.n_envs), jnp.float32))
    flatten("before", ref_state(ts, True), out)
    for shuffle in (False, True):
        _, update_fn, _ = JP.make_ppo(JP.full_env_hooks(), base.replace(env_shuffle=shuffle))
        log.clear()
        with jax.disable_jit():
            ts1, metrics = update_fn(ts)
        tag = f"shuffle{int(shuffle)}"
        flatten(tag, ref_state(ts1, True), out)
        for k, v in metrics.items():
            out[f"{tag}_metric_{k}"] = np.asarray(v)
        steps = [r for n, r in log if n == "step"]
        samples = [r for n, r in log if n == "sample"]
        values = [r[1] for n, r in log if n == "policy"]
        for t in range(base.rollout_len):
            out[f"{tag}_action_{t}"] = np.asarray(samples[t][0])
            out[f"{tag}_log_prob_{t}"] = np.asarray(samples[t][1])
            out[f"{tag}_value_{t}"] = np.asarray(values[t])
            out[f"{tag}_reward_{t}"] = np.asarray(JFP.flat_fm(steps[t][3])[0])
            out[f"{tag}_done_{t}"] = np.asarray(JFP.flat_fm(steps[t][4])[0]) != 0
    np.savez(path, **out)


def _mint_generic(path):
    """The flagship env's generic (non-fused) update: the reference's own
    ``vmap(step_autoreset)``, ``observe_vector`` and ``action_mask`` in its
    jitted update, its actions recorded from inside it, and its rewards and
    dones from replaying them through the same jitted step."""
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", False)
    from balatro_gym_tpu.engine import full_env as fe

    got, out = [], {}
    orig = jax.random.categorical

    def categorical(key, logits, *args, **kw):
        res = orig(key, logits, *args, **kw)
        jax.debug.callback(lambda a: got.append(np.asarray(a)), res, ordered=True)
        return res

    jax.random.categorical = categorical
    cfg = JP.PPOConfig(**GENERIC)
    init_fn, update_fn, _ = JP.make_ppo(JP.full_env_hooks(), cfg)
    rng = np.random.default_rng(5)
    ts = init_fn(jax.random.key(0)).replace(
        obs_stats=JN.RunningStats(
            mean=jnp.asarray(rng.normal(0, 0.3, JFP.OBS_DIM), jnp.float32),
            var=jnp.asarray(rng.uniform(0.2, 2.0, JFP.OBS_DIM), jnp.float32),
            count=jnp.float32(5000.0)),
        ret_stats=JN.RunningStats(mean=jnp.float32(0.3), var=jnp.float32(2.5),
                                  count=jnp.float32(5000.0)),
        ret_carry=jnp.asarray(rng.normal(0, 1, cfg.n_envs), jnp.float32))
    flatten("before", ref_state(ts, True), out)
    ts1, metrics = jax.jit(update_fn)(ts)
    jax.block_until_ready(ts1.params)
    flatten("after", ref_state(ts1, True), out)
    for k, v in metrics.items():
        out[f"metric_{k}"] = np.asarray(v)
    replay = jax.jit(jax.vmap(fe.step_autoreset))
    st = ts.env_states
    for t in range(cfg.rollout_len):
        out[f"action_{t}"] = got[t]
        st, reward, done = replay(st, jnp.asarray(got[t]))
        out[f"reward_{t}"], out[f"done_{t}"] = np.asarray(reward), np.asarray(done)
    np.savez(path, **out)


@pytest.fixture(scope="module", autouse=True)
def mint_process(tmp_path_factory):
    """Starts the JAX side with the module, so that it runs beside the
    in-process tests, which come first in this file: the fused update's
    mint and the generic update's, in two processes."""
    env = dict(os.environ)
    env.pop("JAX_PLATFORMS", None)
    env["PYTHONPATH"] = os.pathsep.join(filter(None, [REPO, env.get("PYTHONPATH")]))
    procs = {}
    for flag in ("--mint", "--mint-generic"):
        path = str(tmp_path_factory.mktemp("mint") / "ppo.npz")
        procs[flag] = (path, subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), flag, path], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True, env=env, cwd=REPO))
    yield procs
    for _, proc in procs.values():
        if proc.poll() is None:
            proc.kill()
            proc.communicate()


def _minted(procs, flag):
    path, proc = procs[flag]
    out, _ = proc.communicate(timeout=900)
    assert proc.returncode == 0, out[-4000:]
    return dict(np.load(path))


@pytest.fixture(scope="module")
def minted(mint_process):
    return _minted(mint_process, "--mint")


@pytest.fixture(scope="module")
def minted_generic(mint_process):
    return _minted(mint_process, "--mint-generic")


@pytest.mark.parametrize("shuffle", [False, True])
def test_fused_update_matches_reference(minted, shuffle):
    tag = f"shuffle{int(shuffle)}"
    cfg = TP.PPOConfig(**FUSED, env_shuffle=shuffle)
    hooks = TP.full_env_hooks()
    ts = TP.load_reference_state(hooks, cfg, unflatten(minted, "before"), device="cpu")
    ts0 = copy.deepcopy(ts)                     # the update changes ts's parameters
    _, update_fn, _ = TP.make_ppo(hooks, cfg, device="cpu")
    n0 = (FP.observe_fused.launches, FP.step_fused.launches, FP.sample_fused.launches)
    rec = {}
    out, metrics = update_fn(ts, record=rec)
    assert (FP.observe_fused.launches, FP.step_fused.launches,
            FP.sample_fused.launches) == n0                    # the CPU runs no kernel
    traj, n = rec["traj"], cfg.n_envs
    live = np.ones(n, bool)
    keys = KR.split_keys(KR.split_keys(unflatten(minted, "before")["key"], 4)[1], cfg.rollout_len)
    for t in range(cfg.rollout_len):
        same = traj.action[t].numpy() == minted[f"{tag}_action_{t}"]
        if not same[live].all():     # a flip needs a near-tie of the rollout's own logits
            with torch.no_grad():
                logits, _ = ts0.params(traj.obs[t], traj.mask[t])
            ties = near_ties(keys[t], logits, torch.arange(60 * n).view(60, n).T).numpy()
            assert ties[live & ~same].all(), t
        live &= same
        for name in ("log_prob", "value"):
            assert_close(getattr(traj, name)[t].numpy()[live], minted[f"{tag}_{name}_{t}"][live],
                         f"step {t} {name}")
        np.testing.assert_array_equal(rec["raw"][t].numpy()[live],
                                      minted[f"{tag}_reward_{t}"][live])
        np.testing.assert_array_equal(traj.done[t].numpy()[live], minted[f"{tag}_done_{t}"][live])
    assert (~live).sum() == 0, "a near-tie flipped an action: the learner's inputs differ"
    want = unflatten(minted, tag)
    for k in ("cards", "ints", "rng"):
        got = out.env_states[k].numpy()
        w = want["env_states"][k]
        w = w.astype(np.uint32).view(np.int32) if k == "rng" else w
        np.testing.assert_array_equal(got, w, err_msg=k)
    ref_metrics = {k: minted[f"{tag}_metric_{k}"] for k in METRICS}
    assert_learner(out, want, tag, metrics, ref_metrics)


def test_generic_update_matches_reference(minted_generic):
    """The flagship env's update over the generic rollout (the engine's
    step, observation and mask; ``categorical``) against the reference's
    jitted one. Tolerances as the fused update's, but raw rewards within
    PARITY #B11's 1e-4 (the reference's jit contracts the reward's
    multiply-adds into FMAs) and the observations the reference's jit made
    with reciprocal multiplies, 1 ulp from the port's divisions."""
    m = minted_generic
    cfg = TP.PPOConfig(**GENERIC)
    hooks = TP.full_env_hooks()
    before = unflatten(m, "before")
    ts = TP.load_reference_state(hooks, cfg, before, device="cpu")
    assert isinstance(ts.env_states, TFE.FullEnvState)
    ts0 = copy.deepcopy(ts)
    _, update_fn, _ = TP.make_ppo(hooks, cfg, device="cpu")
    n0 = (FP.observe_fused.launches, FP.env_step_fused.launches)
    rec = {}
    out, metrics = update_fn(ts, record=rec)
    assert (FP.observe_fused.launches, FP.env_step_fused.launches) == n0
    traj, n = rec["traj"], cfg.n_envs
    keys = [KR.split_keys(k, 1)[0] for k in KR.split_keys(KR.split_keys(before["key"], 4)[1],
                                                           cfg.rollout_len)]
    for t in range(cfg.rollout_len):
        same = traj.action[t].numpy() == m[f"action_{t}"]
        if not same.all():           # a flip needs a near-tie of the rollout's own logits
            with torch.no_grad():
                logits, _ = ts0.params(traj.obs[t], traj.mask[t])
            ties = near_ties(keys[t], logits, torch.arange(n * 60).view(n, 60)).numpy()
            assert ties[~same].all(), t
        assert same.all(), f"step {t}: a near-tie flipped an action"
        np.testing.assert_allclose(rec["raw"][t].numpy(), m[f"reward_{t}"], rtol=0, atol=1e-4)
        np.testing.assert_array_equal(traj.done[t].numpy(), m[f"done_{t}"])
    want = unflatten(m, "after")
    packed = TFF.pack_full_state(out.env_states)
    for k in ("cards", "ints", "rng"):
        w = want["env_states"][k]
        w = w.astype(np.uint32).view(np.int32) if k == "rng" else w
        np.testing.assert_array_equal(packed[k].numpy(), w, err_msg=k)
    assert_learner(out, want, "generic", metrics, {k: m[f"metric_{k}"] for k in METRICS})


# ---------------------------------------------------------------------------
# (c) GAE, (d) permutation
# ---------------------------------------------------------------------------


def test_gae_matches_numpy_loop():
    rng = np.random.default_rng(8)
    T, E, gamma, lam = 7, 33, 0.99, 0.95
    reward = rng.normal(size=(T, E)).astype(np.float32)
    value = rng.normal(size=(T, E)).astype(np.float32)
    done = rng.random((T, E)) < 0.2
    last = rng.normal(size=E).astype(np.float32)
    want = np.zeros((T, E))
    acc, nxt = np.zeros(E), last.astype(np.float64)
    for t in reversed(range(T)):
        nonterm = 1.0 - done[t]
        acc = reward[t] + gamma * nxt * nonterm - value[t] + gamma * lam * nonterm * acc
        want[t] = acc
        nxt = value[t]
    z = torch.zeros(T, E)
    traj = TP.Transition(z, z, z, z, torch.as_tensor(value), torch.as_tensor(reward),
                         torch.as_tensor(done))
    adv, ret = TP.gae(traj, torch.as_tensor(last), gamma, lam)
    np.testing.assert_allclose(adv.numpy(), want, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(ret.numpy(), want + value, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("n", [1625, 1626, 8192, 16384, 1048576])
def test_permutation_matches_jax(n):
    """1625 takes one shuffle round, the others two."""
    for seed in (0, 7):
        key = jax.random.fold_in(jax.random.key(11), seed)
        k1, k2 = (torch.tensor(int(w)) for w in np.asarray(jax.random.key_data(key)))
        np.testing.assert_array_equal(KR.permutation(k1, k2, n).numpy(),
                                      np.asarray(jax.random.permutation(key, n)))


def test_split_keys_match_jax():
    key = jax.random.fold_in(jax.random.key(3), 9)
    words = [int(w) for w in np.asarray(jax.random.key_data(key))]
    want = np.asarray(jax.vmap(jax.random.key_data)(jax.random.split(key, 5)))
    assert KR.split_keys(words, 5) == [tuple(int(w) for w in r) for r in want]


# ---------------------------------------------------------------------------
# (e) the CLI, (f) the device rule
# ---------------------------------------------------------------------------


def test_cli_trains_and_writes_the_summary(tmp_path):
    summary = tmp_path / "summary.json"
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run(
        [sys.executable, "-m", "balatro_gym_tpu_torch.train.cli", "--env", "sim", "--updates",
         "2", "--n-envs", "16", "--rollout", "4", "--epochs", "2", "--minibatches", "2",
         "--hidden", "32", "--log-every", "1", "--device", "cpu", "--summary", str(summary)],
        capture_output=True, text=True, cwd=REPO, env=env, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    got = json.loads(summary.read_text())
    assert set(got) == SUMMARY_KEYS
    assert got["total_env_steps"] == 2 * 16 * 4 and got["updates"] == 2
    assert set(got["final_metrics"]) == set(METRICS)
    assert all(np.isfinite(v) for v in got["final_metrics"].values())
    lines = [json.loads(ln) for ln in proc.stdout.splitlines() if ln.startswith("{")]
    assert [ln.get("update") for ln in lines[:2]] == [1, 2]


TINY_ARGV = ["--env", "sim", "--updates", "2", "--n-envs", "16", "--rollout", "4", "--epochs",
             "2", "--minibatches", "2", "--hidden", "32", "--device", "cpu"]


def test_cli_distributed_alone_trains_as_a_mesh_of_one(tmp_path):
    """``--distributed`` with no launcher trains through
    ``make_distributed_ppo`` over a mesh of one rank."""
    summary = tmp_path / "summary.json"
    got = TCLI.main(TINY_ARGV + ["--distributed", "--summary", str(summary)])
    assert set(got) == SUMMARY_KEYS and json.loads(summary.read_text()) == got
    assert got["n_devices"] == 1 and got["total_env_steps"] == 2 * 16 * 4
    assert all(np.isfinite(v) for v in got["final_metrics"].values())


def _torchrun(argv, tmp_path):
    env = dict(os.environ, PYTHONPATH=REPO)
    env.pop("WORLD_SIZE", None)
    return subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc-per-node", "2",
         "-m", "balatro_gym_tpu_torch.train.cli", *argv], capture_output=True, text=True,
        cwd=tmp_path, env=env, timeout=300)


def test_cli_distributed_trains_over_two_launched_ranks(tmp_path):
    """Two ranks under torchrun train one learner over gloo; only rank 0
    prints and writes the summary, whose ``n_devices`` is the world size."""
    summary = tmp_path / "summary.json"
    proc = _torchrun(TINY_ARGV + ["--distributed", "--log-every", "1", "--summary",
                                  str(summary)], tmp_path)
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-3000:]
    got = json.loads(summary.read_text())
    assert set(got) == SUMMARY_KEYS and got["n_devices"] == 2
    assert got["total_env_steps"] == 2 * 16 * 4
    assert all(np.isfinite(v) for v in got["final_metrics"].values())
    lines = [json.loads(ln) for ln in proc.stdout.splitlines() if ln.startswith("{")]
    assert [ln.get("update") for ln in lines] == [1, 2, None]       # one rank printed
    assert lines[-1] == got


def test_cli_single_device_learner_refuses_launched_ranks(tmp_path):
    """``--algorithm a2c`` trains alone (as in the reference), so under a
    launcher of two ranks it exits non-zero instead of training two
    separate learners."""
    proc = _torchrun(TINY_ARGV + ["--algorithm", "a2c", "--distributed", "--summary", ""],
                     tmp_path)
    assert proc.returncode != 0
    assert "only --distributed PPO trains over ranks" in proc.stdout + proc.stderr


def test_cli_full_env_trains_without_the_fused_rollout():
    """``--env full`` alone trains over the generic rollout: one tiny update
    on the CPU, with the reference's summary keys."""
    got = TCLI.main(["--env", "full", "--updates", "1", "--n-envs", "16", "--rollout", "4",
                     "--hidden", "32", "--device", "cpu", "--summary", ""])
    assert set(got) == SUMMARY_KEYS and got["env"] == "full"
    assert got["total_env_steps"] == 16 * 4 and set(got["final_metrics"]) == set(METRICS)
    assert all(np.isfinite(v) for v in got["final_metrics"].values())


@pytest.mark.parametrize("algorithm", ["a2c", "dqn"])
@pytest.mark.parametrize("env_name", ["sim", "full"])
def test_cli_other_learners_train(algorithm, env_name, tmp_path, capsys):
    """``--algorithm a2c|dqn`` trains on either env (the learners' own
    defaults, as the reference's CLI builds them) and writes the
    reference's summary keys and metric lines, the rate counted from
    ``n_envs * rollout``."""
    summary = tmp_path / "summary.json"
    got = TCLI.main(["--algorithm", algorithm, "--env", env_name, "--updates", "2",
                     "--n-envs", "16", "--rollout", "3", "--log-every", "1", "--device", "cpu",
                     "--summary", str(summary)])
    assert set(got) == SUMMARY_KEYS and json.loads(summary.read_text()) == got
    assert (got["algorithm"], got["env"]) == (algorithm, env_name)
    assert got["total_env_steps"] == 2 * 16 * 3 and got["n_devices"] == 1
    want = ({"loss", "pg_loss", "vf_loss", "entropy", "mean_reward", "episodes"}
            if algorithm == "a2c" else {"loss", "epsilon", "buffer", "mean_reward", "episodes"})
    assert set(got["final_metrics"]) == want
    assert all(np.isfinite(v) for v in got["final_metrics"].values())
    lines = [json.loads(ln) for ln in capsys.readouterr().out.splitlines() if ln.startswith("{")]
    assert [ln.get("update") for ln in lines[:2]] == [1, 2]
    if algorithm == "dqn":
        assert got["final_metrics"]["buffer"] == 2 * 3 * 16


SUMMARY_KEYS = {"algorithm", "env", "total_env_steps", "wall_seconds", "steps_per_second",
                "updates", "final_metrics", "n_devices"}
TINY_CLI = ["--env", "sim", "--updates", "1", "--n-envs", "16", "--rollout", "4", "--epochs",
            "2", "--minibatches", "2", "--hidden", "32", "--log-every", "1", "--device", "cpu"]


def test_cli_wandb_trains_without_the_package(tmp_path, monkeypatch):
    """As the reference: a wandb that fails to start leaves the run
    training without logging (a stub whose init raises stands in, so the
    guarded path runs whether or not wandb is installed)."""
    class Wandb:
        @staticmethod
        def init(**kwargs):
            raise RuntimeError("offline")

    monkeypatch.setitem(sys.modules, "wandb", Wandb)
    summary = tmp_path / "summary.json"
    got = TCLI.main(TINY_CLI + ["--wandb", "--summary", str(summary)])
    assert set(got) == SUMMARY_KEYS and json.loads(summary.read_text()) == got
    assert got["updates"] == 1 and set(got["final_metrics"]) == set(METRICS)


def test_cli_checkpoint_every_alone_trains(tmp_path):
    """As the reference: --checkpoint-every saves only beside
    --checkpoint-dir, so alone it trains."""
    summary = tmp_path / "summary.json"
    got = TCLI.main(TINY_CLI + ["--checkpoint-every", "5", "--summary", str(summary)])
    assert set(got) == SUMMARY_KEYS and json.loads(summary.read_text()) == got
    assert got["total_env_steps"] == 16 * 4 and set(got["final_metrics"]) == set(METRICS)


def test_entry_points_default_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = TP.PPOConfig(**TINY)
    for call in (lambda: TP.make_ppo(TP.sim_env_hooks(), cfg),
                 lambda: TP.train(1, cfg),
                 lambda: TCLI.main(["--updates", "1", "--summary", ""]),
                 lambda: TCLI.main(["--env", "full", "--fused-rollout", "--updates", "1",
                                    "--summary", ""])):
        with pytest.raises(RuntimeError, match="no CUDA card"):
            call()
    ts, metrics = TP.train(1, cfg, device="cpu")
    assert ts.ret_carry.device.type == "cpu" and set(metrics) == set(METRICS)


def test_full_env_needs_the_fused_rollout():
    """The flagship env no longer needs it: its hooks carry the engine's
    ``step`` and ``step_autoreset``, and it trains over the generic
    rollout too. The fused rollout is still the flagship env's only."""
    hooks = TP.full_env_hooks()
    assert hooks.step is TFE.step and hooks.step_autoreset is TFE.step_autoreset
    assert TP.sim_env_hooks().step is not None
    TP.make_ppo(hooks, TP.PPOConfig(**TINY), device="cpu")
    with pytest.raises(ValueError, match="flagship"):
        TP.make_ppo(TP.sim_env_hooks(), TP.PPOConfig(**TINY, fused_rollout=True), device="cpu")


def test_fused_collection_runs_the_hooks_ops():
    calls = []

    def counted(f):
        def call(*args):
            calls.append(f.__name__)
            return f(*args)
        return call

    ops = tuple(counted(f) for f in (FP.observe_rows_reference, FP.sample,
                                     FP.step_rows_reference))
    cfg = TP.PPOConfig(n_envs=256, rollout_len=2, epochs=1, minibatches=2, hidden=(32,),
                       fused_rollout=True)
    hooks = TP.full_env_hooks()
    init_fn, update, _ = TP.make_ppo(hooks, cfg, device="cpu")
    _, update_ops, _ = TP.make_ppo(hooks._replace(fused_ops=ops), cfg, device="cpu")
    ts = init_fn([int(w) for w in KR.seed_key(3, device="cpu")])
    tp = copy.deepcopy(ts)
    ts, m = update(ts)
    tp, mp = update_ops(tp)
    assert calls == ["observe_rows_reference"] + ["sample", "step_rows_reference"] * 2
    for k in ("cards", "ints", "rng"):
        assert torch.equal(ts.env_states[k], tp.env_states[k]), k
    for p, q in zip(TP.param_list(ts.params), TP.param_list(tp.params)):
        assert torch.equal(p, q)
    assert all(torch.equal(m[k], mp[k]) for k in METRICS)


if __name__ == "__main__" and len(sys.argv) == 3 and sys.argv[1] == "--mint":
    _mint(sys.argv[2])
if __name__ == "__main__" and len(sys.argv) == 3 and sys.argv[1] == "--mint-generic":
    _mint_generic(sys.argv[2])
