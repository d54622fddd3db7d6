"""The port's DQN learner (``train/dqn.py``) against the reference's, on the
CPU.

The reference runs in its production configuration (x64 off: 32-bit
exploration and sample draws) out of process: this file re-invokes itself
with ``--mint <npz>``; that process runs 5 jitted updates of
``make_dqn(full_env_hooks(), DQNConfig(n_envs=8, steps_per_update=2,
batch_size=16, learning_starts=32, target_update_every=2,
eps_decay_updates=10, hidden=(32,)))`` from ``init_fn(key(0))`` with a
512-transition buffer and with a 48-transition one (which wraps in the
third update), and saves the whole state before and after each update
and its metrics. The port starts each update from the reference's state
(``load_reference_dqn_state``).

Tolerances. The ring (actions, rewards, dones, next masks, ``ptr`` and
``len``), the env states, the key, epsilon, whether an update learns and
the target syncs are exact. The stored observations agree within 1 ulp:
the reference's jit turns ``observe_vector``'s divisions by constants
(shop costs, money and the like) into float32 reciprocal multiplies, as
tests/test_torch_ppo.py's generic update notes, and its ``log1p`` may
differ in the last bit; K3b's rows and their plain version divide.
Parameters, target parameters and Adam's moments within 1e-6 absolute; the
loss within 1e-6 relative plus 1e-6 absolute.
"""
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from balatro_gym_tpu.train import dqn as JD
from balatro_gym_tpu.train import ppo as JP
from balatro_gym_tpu_torch.ops import fused_full_rollout as TFF
from balatro_gym_tpu_torch.ops import fused_policy_rollout as FP
from balatro_gym_tpu_torch.ops import kernel_rng as KR
from balatro_gym_tpu_torch.train import dqn as TD
from balatro_gym_tpu_torch.train import ppo as TP

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BASE = dict(n_envs=8, steps_per_update=2, batch_size=16, learning_starts=32,
            target_update_every=2, eps_decay_updates=10, hidden=(32,))
CASES = {"base": dict(BASE, buffer_size=512), "wrap": dict(BASE, buffer_size=48)}
UPDATES = 5
ATOL = 1e-6
BUFFERS = ("buf_obs", "buf_action", "buf_reward", "buf_next_obs", "buf_next_mask", "buf_done")


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def ref_state(ts):
    """The reference's DQNState in ``load_reference_dqn_state``'s form."""
    from balatro_gym_tpu.ops import fused_full_rollout as JFF
    adam = ts.opt_state[0]
    out = {"params": jax.tree.map(np.asarray, ts.params),
           "target_params": jax.tree.map(np.asarray, ts.target_params),
           "mu": jax.tree.map(np.asarray, adam.mu), "nu": jax.tree.map(np.asarray, adam.nu),
           "count": np.asarray(adam.count), "key": np.asarray(jax.random.key_data(ts.key)),
           "update_idx": np.asarray(ts.update_idx),
           "env_states": {k: np.asarray(v) for k, v in
                          JFF.pack_full_state(ts.env_states).items()}}
    for name in (*BUFFERS, "buf_ptr", "buf_len"):
        out[name] = np.asarray(getattr(ts, name))
    return out


def _flatten(prefix, tree, out):
    if isinstance(tree, dict):
        for k, v in tree.items():
            _flatten(f"{prefix}/{k}", v, out)
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
    return root


def _mint(path):
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", False)
    out = {}
    for case, kw in CASES.items():
        init_fn, update_fn = JD.make_dqn(JP.full_env_hooks(), JD.DQNConfig(**kw))
        step = jax.jit(update_fn)
        ts = init_fn(jax.random.key(0))
        for u in range(UPDATES):
            _flatten(f"{case}{u}_before", ref_state(ts), out)
            ts, metrics = step(ts)
            jax.block_until_ready(ts.params)
            _flatten(f"{case}{u}_after", ref_state(ts), out)
            for k, v in metrics.items():
                out[f"{case}{u}_metric_{k}"] = np.asarray(v)
    np.savez(path, **out)


@pytest.fixture(scope="module")
def minted(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("mint") / "dqn.npz")
    env = dict(os.environ)
    env.pop("JAX_PLATFORMS", None)
    env["PYTHONPATH"] = os.pathsep.join(filter(None, [REPO, env.get("PYTHONPATH")]))
    res = subprocess.run([sys.executable, os.path.abspath(__file__), "--mint", path],
                         capture_output=True, text=True, timeout=900, env=env, cwd=REPO)
    assert res.returncode == 0, (res.stdout + res.stderr)[-4000:]
    return dict(np.load(path))


def assert_obs_rows(got, want, what):
    """Every entry within 1 ulp: the reference's jitted ``observe_vector``
    multiplies by float32 reciprocals where K3b's rows (and their plain
    version) divide, and its ``log1p`` may differ in the last bit."""
    ulp = np.abs(got.view(np.int32).astype(np.int64) - want.view(np.int32))
    assert ulp.max() <= 1, f"{what}: off by {ulp.max()} ulp"


def assert_nets(got, want_tree, what):
    for i, (g, w) in enumerate(zip(TP.param_list(got), TP._flax_leaves(got, want_tree))):
        np.testing.assert_allclose(g.detach().numpy(), w.numpy(), rtol=0, atol=ATOL,
                                   err_msg=f"{what}[{i}]")


@pytest.mark.parametrize("case", list(CASES))
def test_updates_match_reference(minted, case):
    cfg = TD.DQNConfig(**CASES[case])
    hooks = TP.full_env_hooks()
    _, update_fn = TD.make_dqn(hooks, cfg, device="cpu")
    wrapped = False
    for u in range(UPDATES):
        before = _unflatten(minted, f"{case}{u}_before")
        ts = TD.load_reference_dqn_state(hooks, cfg, before, device="cpu")
        n0 = (FP.observe_fused.launches, FP.env_step_fused.launches)
        rec = {}
        out, metrics = update_fn(ts, record=rec)
        assert (FP.observe_fused.launches, FP.env_step_fused.launches) == n0
        want = _unflatten(minted, f"{case}{u}_after")
        what = f"{case} update {u}"
        assert (out.buf_ptr, out.buf_len) == (int(want["buf_ptr"]), int(want["buf_len"])), what
        wrapped |= out.buf_ptr < ts.buf_ptr
        for name in ("buf_obs", "buf_next_obs"):
            assert_obs_rows(getattr(out, name).numpy(), want[name], f"{what}: {name}")
        for name in ("buf_action", "buf_reward", "buf_next_mask", "buf_done"):
            np.testing.assert_array_equal(getattr(out, name).numpy(),
                                          want[name].astype(getattr(out, name).numpy().dtype),
                                          err_msg=f"{what}: {name}")
        packed = TFF.pack_full_state(out.env_states)
        for k in ("cards", "ints", "rng"):
            w = want["env_states"][k]
            w = w.astype(np.uint32).view(np.int32) if k == "rng" else w
            np.testing.assert_array_equal(packed[k].numpy(), w, err_msg=f"{what}: {k}")
        assert out.key == tuple(int(w) for w in want["key"]) and out.update_idx == u + 1
        assert rec["ready"] == (int(want["buf_len"]) >= cfg.learning_starts), what
        assert out.opt_state.count == int(want["count"]), what
        assert_nets(out.params, want["params"], f"{what}: params")
        assert_nets(out.target_params, want["target_params"], f"{what}: target")
        for name, got_l in (("mu", out.opt_state.mu), ("nu", out.opt_state.nu)):
            for i, (g, w) in enumerate(zip(got_l, TP._flax_leaves(out.params, want[name]))):
                np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=0, atol=ATOL,
                                           err_msg=f"{what}: {name}[{i}]")
        synced = (u + 1) % cfg.target_update_every == 0
        assert all(torch.equal(a, b) for a, b in zip(TP.param_list(out.params),
                                                     TP.param_list(out.target_params))) \
            == (synced or not rec["ready"] and u == 0), what
        m = {k: minted[f"{case}{u}_metric_{k}"] for k in ("loss", "epsilon", "buffer",
                                                          "mean_reward", "episodes")}
        assert set(metrics) == set(m)
        assert metrics["epsilon"] == float(m["epsilon"]) and metrics["buffer"] == float(m["buffer"])
        np.testing.assert_allclose(float(metrics["loss"]), float(m["loss"]), rtol=ATOL, atol=ATOL)
        assert float(metrics["mean_reward"]) == float(m["mean_reward"])
        assert int(metrics["episodes"]) == int(m["episodes"])
    assert wrapped == (case == "wrap")


def test_init_matches_reference(minted):
    """init_fn's env states, key, empty ring and equal target; the weights
    come from a torch.Generator seeded with the k_net words."""
    cfg = TD.DQNConfig(**CASES["base"])
    init_fn, _ = TD.make_dqn(TP.full_env_hooks(), cfg, device="cpu")
    ts = init_fn([int(w) for w in KR.seed_key(0, device="cpu")])
    want = _unflatten(minted, "base0_before")
    packed = TFF.pack_full_state(ts.env_states)
    for k in ("cards", "ints"):
        np.testing.assert_array_equal(packed[k].numpy(), want["env_states"][k], err_msg=k)
    assert ts.key == tuple(int(w) for w in want["key"]) and (ts.buf_ptr, ts.buf_len) == (0, 0)
    for name in BUFFERS:
        np.testing.assert_array_equal(getattr(ts, name).numpy(),
                                      want[name].astype(getattr(ts, name).numpy().dtype))
    assert all(torch.equal(a, b) for a, b in zip(TP.param_list(ts.params),
                                                 TP.param_list(ts.target_params)))


def test_randint_with_a_tensor_maxval_is_jax_randint():
    """The TD sample's bound is known only at run time: ``kernel_rng.randint``
    with a tensor maxval against ``jax.random.randint`` with a traced one
    (int32, the production width)."""
    draw = jax.jit(lambda k, hi: jax.random.randint(k, (64,), 0, hi, dtype=jnp.int32))
    for seed, hi in ((0, 1), (1, 16), (2, 48), (3, 1000), (4, 99_999), (5, 100_000)):
        key = jax.random.key(seed)
        want = np.asarray(draw(key, jnp.int32(hi)))
        words = [int(w) for w in np.asarray(jax.random.key_data(key))]
        k1, k2 = (torch.tensor(w) for w in words)
        got = KR.randint(k1, k2, 0, torch.full((64,), hi), torch.arange(64))
        np.testing.assert_array_equal(got.numpy(), want, err_msg=str(hi))


def test_dqn_update_and_buffer():
    """tests/test_a2c_dqn.py's buffer case on the port."""
    cfg = TD.DQNConfig(n_envs=8, buffer_size=512, batch_size=32, learning_starts=16,
                       steps_per_update=2, hidden=(16,), eps_decay_updates=10,
                       target_update_every=2)
    init_fn, update_fn = TD.make_dqn(TP.sim_env_hooks(), cfg, device="cpu")
    ts = init_fn([0, 0])
    for _ in range(5):
        ts, m = update_fn(ts)
    assert int(m["buffer"]) == 5 * 2 * 8
    assert float(m["epsilon"]) < 1.0
    assert np.isfinite(float(m["loss"]))
    assert ts.update_idx == 5


def test_dqn_respects_learning_starts():
    """tests/test_a2c_dqn.py's gating case on the port: below
    learning_starts the parameters and Adam's state, its count included,
    stay as they were."""
    cfg = TD.DQNConfig(n_envs=4, buffer_size=256, batch_size=16, learning_starts=10_000,
                       steps_per_update=1, hidden=(16,))
    init_fn, update_fn = TD.make_dqn(TP.sim_env_hooks(), cfg, device="cpu")
    ts = init_fn([0, 0])
    p0 = [p.detach().clone() for p in TP.param_list(ts.params)]
    ts, _ = update_fn(ts)
    assert all(torch.equal(a, b) for a, b in zip(p0, TP.param_list(ts.params)))
    assert ts.opt_state.count == 0 and not any(m.any() for m in ts.opt_state.mu)


def test_more_envs_than_slots_is_refused():
    with pytest.raises(ValueError, match="buffer_size"):
        TD.make_dqn(TP.sim_env_hooks(), TD.DQNConfig(n_envs=64, buffer_size=32), device="cpu")


def test_td_loss_fits_a_fixed_buffer():
    """A learning test, not a running one: with the target network held
    fixed, 200 full-batch Adam steps (lr 1e-3) on the TD loss of one fixed
    buffer (2,048 transitions of the sim env, seed 0) halve that loss: the
    Q-network fits its targets (measured: 11.25 -> 0.31, ~5 s)."""
    cfg = TD.DQNConfig(n_envs=64, buffer_size=2048, batch_size=512, learning_starts=10 ** 9,
                       target_update_every=10 ** 9, lr=1e-3)
    init_fn, update_fn = TD.make_dqn(TP.sim_env_hooks(), cfg, device="cpu")
    ts = init_fn([int(w) for w in KR.seed_key(0, device="cpu")])
    for _ in range(8):
        ts, _ = update_fn(ts)
    assert ts.buf_len == cfg.buffer_size
    every = torch.arange(ts.buf_len)
    params, opt = TP.param_list(ts.params), TP.adam_init(TP.param_list(ts.params))
    first = float(TD.td_loss(ts.params, ts.target_params, ts, every, cfg.gamma).detach())
    for _ in range(200):
        loss = TD.td_loss(ts.params, ts.target_params, ts, every, cfg.gamma)
        opt = TP.adam_update(params, torch.autograd.grad(loss, params), opt, cfg.lr, None,
                             eps=1e-8)
    last = float(TD.td_loss(ts.params, ts.target_params, ts, every, cfg.gamma).detach())
    assert last <= 0.5 * first, (first, last)


def test_no_device_means_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for call in (lambda: TD.make_dqn(TP.sim_env_hooks(), TD.DQNConfig(n_envs=4)),
                 lambda: TD.train(1, TD.DQNConfig(n_envs=4))):
        with pytest.raises(RuntimeError, match="no CUDA card"):
            call()


if __name__ == "__main__" and len(sys.argv) == 3 and sys.argv[1] == "--mint":
    _mint(sys.argv[2])
