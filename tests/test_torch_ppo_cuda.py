"""The PPO learner on the card: the fused update (K3b, the sampler and K3a)
against the same update over the kernels' plain versions, and the sim
learner on the card against the CPU.

These tests need a card and skip where torch sees none. The machine with
the card has no JAX, and tests/conftest.py imports it, so this file imports
torch and the port only and runs there with

    python -m pytest --noconftest -m cuda tests/test_torch_ppo_cuda.py

Tolerances: on the card the fused and the plain update make the same
trajectories and states bit for bit (the observation's log1p row is within
1 ulp by contract and measured equal on the card), but the sampler's
log-probs, within 1e-6 (a sum of 60 ``expf`` in another order than
torch's ``log_softmax``); the learner then reads ratios that differ in the
last bits, so parameters agree within 1e-6 absolute and metrics within
1e-5 relative (the CPU tests' tolerances). The sim learner on the card and
on the CPU sums its matmuls in another order: env states, actions, rewards
and dones exact, parameters within 1e-6.
"""
import copy

import pytest
import torch

from balatro_gym_tpu_torch.ops import fused_policy_rollout as FP
from balatro_gym_tpu_torch.ops import kernel_rng as KR
from balatro_gym_tpu_torch.train import cli as TCLI
from balatro_gym_tpu_torch.train import ppo as TP

pytestmark = pytest.mark.cuda

SEED = [int(w) for w in KR.seed_key(0, device="cpu")]


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (torch.cuda.is_available() is False)")
    return torch.device("cuda", torch.cuda.current_device())


def _counts():
    return FP.observe_fused.launches, FP.step_fused.launches, FP.sample_fused.launches


def assert_params(a, b, atol=1e-6):
    for p, q in zip(TP.param_list(a.params), TP.param_list(b.params)):
        assert float((p.detach().double() - q.detach().double().to(p.device)).abs().max()) <= atol


def assert_metrics(m, w):
    for k in m:
        assert abs(float(m[k]) - float(w[k])) <= 1e-5 * abs(float(w[k])) + 1e-7, k


@pytest.mark.parametrize("bf16,shuffle", [(True, True), (False, False)])
def test_fused_update_equals_plain_update(dev, bf16, shuffle):
    cfg = TP.PPOConfig(n_envs=1024, rollout_len=8, epochs=2, minibatches=2, fused_rollout=True,
                       bf16_compute=bf16, env_shuffle=shuffle, reset_envs_every=3,
                       cycle_penalty=0.05)
    hooks = TP.full_env_hooks()
    init_fn, fused, _ = TP.make_ppo(hooks, cfg)
    plain_ops = (FP.observe_rows_reference, FP.sample, FP.step_rows_reference)
    _, plain, _ = TP.make_ppo(hooks._replace(fused_ops=plain_ops), cfg)
    ts = init_fn(SEED)
    for _ in range(2):                                     # a mid-game start
        ts, _ = fused(ts)
    ts_p = copy.deepcopy(ts)
    n0 = _counts()
    rec, rec_p = {}, {}
    ts, m = fused(ts, record=rec)
    assert _counts() == (n0[0] + 1, n0[1] + cfg.rollout_len, n0[2] + cfg.rollout_len)
    ts_p, m_p = plain(ts_p, record=rec_p)
    assert _counts() == (n0[0] + 1, n0[1] + cfg.rollout_len, n0[2] + cfg.rollout_len)
    for name in ("action", "reward", "done", "value", "mask", "obs"):
        assert torch.equal(getattr(rec["traj"], name), getattr(rec_p["traj"], name)), name
    assert float((rec["traj"].log_prob - rec_p["traj"].log_prob).abs().max()) <= 1e-6
    assert torch.equal(rec["raw"], rec_p["raw"])
    for k in ("cards", "ints", "rng"):
        assert torch.equal(ts.env_states[k], ts_p.env_states[k]), k
    assert_params(ts, ts_p)
    assert_metrics(m, m_p)
    assert [s for s, _ in rec["events"]] == ["start", "collection", "stats",
                                             "last value + GAE", "shuffle + SGD"]


def test_sim_update_on_the_card_equals_the_cpu(dev):
    cfg = TP.PPOConfig(n_envs=64, rollout_len=8, epochs=2, minibatches=2, hidden=(64,))
    hooks = TP.sim_env_hooks()
    init_c, upd_c, _ = TP.make_ppo(hooks, cfg, device="cpu")
    init_g, upd_g, _ = TP.make_ppo(hooks, cfg)
    ts_c, ts_g = init_c(SEED), init_g(SEED)             # the same weights, resets and key
    assert_params(ts_g, ts_c, atol=0)
    for _ in range(2):
        rc, rg = {}, {}
        ts_c, m_c = upd_c(ts_c, record=rc)
        ts_g, m_g = upd_g(ts_g, record=rg)
        assert torch.equal(rc["traj"].action, rg["traj"].action.cpu())
        assert torch.equal(rc["raw"], rg["raw"].cpu())
        assert torch.equal(rc["traj"].done, rg["traj"].done.cpu())
        for k, v in vars(ts_c.env_states).items():
            assert torch.equal(v, getattr(ts_g.env_states, k).cpu()), k
        assert_params(ts_g, ts_c)


def test_entry_points_default_to_the_card(dev):
    cfg = TP.PPOConfig(n_envs=256, rollout_len=2, epochs=1, minibatches=2, fused_rollout=True)
    init_fn, update_fn, policy_fn = TP.make_ppo(TP.full_env_hooks(), cfg)
    ts = init_fn(SEED)
    assert ts.ret_carry.device == dev and ts.env_states["ints"].device == dev
    n0 = _counts()
    ts, m = update_fn(ts)
    assert _counts() == (n0[0] + 1, n0[1] + 2, n0[2] + 2)
    assert all(torch.isfinite(v.float()) for v in m.values())
    ts, _ = TP.train(1, TP.PPOConfig(n_envs=32, rollout_len=2, epochs=1, minibatches=2,
                                     hidden=(32,)))
    assert ts.ret_carry.device == dev


def test_cli_full_fused_trains_on_the_card(dev, tmp_path):
    """``python -m balatro_gym_tpu_torch.train.cli --env full
    --fused-rollout``, run in process: no ``--device`` means the card, and
    the collection's kernels launch."""
    n0 = _counts()
    summary = TCLI.main(["--env", "full", "--fused-rollout", "--bf16", "--env-shuffle",
                         "--n-envs", "1024", "--rollout", "4", "--epochs", "1",
                         "--minibatches", "2", "--updates", "2", "--log-every", "1",
                         "--summary", str(tmp_path / "summary.json")])
    assert _counts() == (n0[0] + 2, n0[1] + 8, n0[2] + 8)
    assert summary["total_env_steps"] == 2 * 1024 * 4 and summary["n_devices"] == 1
    assert all(v == v for v in summary["final_metrics"].values())          # no NaN
