"""A2C, DQN, tune, the macro env and the shop generators on the card.

These tests need a card and skip where torch sees none. The machine with
the card has no JAX, and tests/conftest.py imports it, so this file imports
torch and the port only and runs there with

    python -m pytest --noconftest -m cuda tests/test_torch_learners_cuda.py

The learners on the flagship env launch K3b (the observation and the mask:
2 a step and 2 for A2C's last value) and ``env_step_kernel`` (1 a step);
each is held against the same updates over the kernels' plain versions on
the card. Tolerances: masks, actions, rewards, dones, env states and the
replay ring bit for bit but the observation's ``log1p`` row (1 ulp raw;
A2C's normalised observation within 1e-5 there, since its running
statistics read that row too); parameters and optimizer moments within
1e-6. The macro env and the generators on the card equal the CPU's
exactly; a snapshot saved on the card restores onto the CPU bit for bit.
"""
import copy
import random
from pathlib import Path

import numpy as np
import pytest
import torch

from balatro_gym_tpu_torch.engine import full_env as FE
from balatro_gym_tpu_torch.engine import shop_logic as SL
from balatro_gym_tpu_torch.envs import BalatroMacroGymEnv
from balatro_gym_tpu_torch.envs import macro_env as ME
from balatro_gym_tpu_torch.ops import fused_full_rollout as FF
from balatro_gym_tpu_torch.ops import fused_policy_rollout as FP
from balatro_gym_tpu_torch.ops import kernel_rng as KR
from balatro_gym_tpu_torch.train import a2c as TA
from balatro_gym_tpu_torch.train import cli as TCLI
from balatro_gym_tpu_torch.train import dqn as TD
from balatro_gym_tpu_torch.train import ppo as TP
from balatro_gym_tpu_torch.train import tune as TT
from balatro_gym_tpu_torch.utils.checkpoint import restore_train_state, save_train_state

pytestmark = pytest.mark.cuda

LOG1P_ROW = FP.OBS_DIM - 6
ATOL = 1e-6


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (torch.cuda.is_available() is False)")
    return torch.device("cuda", torch.cuda.current_device())


def plain_engine_hooks():
    """The flagship env's hooks over the kernels' plain versions."""
    def inputs(st):
        return FP.observe_rows_reference(FF.pack_full_state(st))

    def step_autoreset(st, actions):
        packed, reward, done = FP.env_step_rows_reference(FF.pack_full_state(st),
                                                          actions.to(torch.int32))
        return FE.autoreset(FF.unpack_full_state(packed), done), reward, done

    return TP.full_env_hooks()._replace(observe=lambda st: inputs(st)[0],
                                        action_mask=lambda st: inputs(st)[1],
                                        step_autoreset=step_autoreset)


def assert_raw_obs(got, want):
    other = torch.arange(FP.OBS_DIM, device=got.device) != LOG1P_ROW
    assert torch.equal(got[..., other], want[..., other])
    ulp = (got[..., LOG1P_ROW].view(torch.int32) - want[..., LOG1P_ROW].view(torch.int32)).abs()
    assert int(ulp.max()) <= 1


def assert_close_lists(a, b):
    for x, y in zip(a, b):
        assert float((x.detach() - y.detach()).abs().max()) <= ATOL


def test_a2c_updates_equal_plain(dev):
    cfg = TA.A2CConfig(n_envs=1024, rollout_len=5, hidden=(64, 64))
    init_fn, update_fn = TA.make_a2c(TP.full_env_hooks(), cfg, device=dev)
    _, plain_update = TA.make_a2c(plain_engine_hooks(), cfg, device=dev)
    ts = init_fn((0, 8))
    tp = copy.deepcopy(ts)
    n0 = (FP.observe_fused.launches, FP.env_step_fused.launches)
    for u in range(3):
        rk, rp = {}, {}
        ts, mk = update_fn(ts, record=rk)
        tp, mp = plain_update(tp, record=rp)
        for k in ("mask", "action", "reward", "done"):
            assert torch.equal(rk[k], rp[k]), (u, k)
        other = torch.arange(FP.OBS_DIM, device=dev) != LOG1P_ROW
        assert torch.equal(rk["obs"][..., other], rp["obs"][..., other]), u
        assert float((rk["obs"] - rp["obs"]).abs().max()) <= 1e-5, u
        assert FF.states_equal(ts.env_states, tp.env_states) == []
        assert_close_lists(TP.param_list(ts.params), TP.param_list(tp.params))
        assert_close_lists(ts.opt_state.nu, tp.opt_state.nu)
        assert abs(float(mk["loss"]) - float(mp["loss"])) <= ATOL
    T = cfg.rollout_len
    assert (FP.observe_fused.launches - n0[0], FP.env_step_fused.launches - n0[1]) == \
        (3 * (2 * T + 2), 3 * T)


def _dqn_pair(dev, cfg, updates):
    init_fn, update_fn = TD.make_dqn(TP.full_env_hooks(), cfg, device=dev)
    _, plain_update = TD.make_dqn(plain_engine_hooks(), cfg, device=dev)
    ts = init_fn((0, 9))
    tp = copy.deepcopy(ts)
    n0 = (FP.observe_fused.launches, FP.env_step_fused.launches)
    for u in range(updates):
        rk, rp = {}, {}
        ts, _ = update_fn(ts, record=rk)
        tp, _ = plain_update(tp, record=rp)
        for k in ("action", "reward", "done", "sample"):
            assert torch.equal(rk[k], rp[k]), (u, k)
        assert rk["ready"] == rp["ready"]
        for name in ("buf_obs", "buf_next_obs"):
            assert_raw_obs(getattr(ts, name), getattr(tp, name))
        for name in ("buf_action", "buf_reward", "buf_next_mask", "buf_done"):
            assert torch.equal(getattr(ts, name), getattr(tp, name)), (u, name)
        assert (ts.buf_ptr, ts.buf_len) == (tp.buf_ptr, tp.buf_len)
        assert_close_lists(TP.param_list(ts.params), TP.param_list(tp.params))
        assert_close_lists(TP.param_list(ts.target_params), TP.param_list(tp.target_params))
    S = cfg.steps_per_update
    assert (FP.observe_fused.launches - n0[0], FP.env_step_fused.launches - n0[1]) == \
        (updates * 4 * S, updates * S)
    return ts


def test_dqn_updates_equal_plain(dev):
    cfg = TD.DQNConfig(n_envs=1024, buffer_size=10_000, steps_per_update=2, batch_size=256,
                       learning_starts=1000, target_update_every=2, hidden=(64, 64))
    ts = _dqn_pair(dev, cfg, 3)
    assert (ts.buf_ptr, ts.buf_len) == (6144, 6144) and ts.opt_state.count == 3


def test_dqn_ring_wraps_on_the_card(dev):
    cfg = TD.DQNConfig(n_envs=1024, buffer_size=3000, steps_per_update=2, batch_size=256,
                       learning_starts=1000, hidden=(64,))
    ts = _dqn_pair(dev, cfg, 2)
    assert (ts.buf_ptr, ts.buf_len) == (4096 % 3000, 3000)


def test_macro_engine_on_the_card_equals_the_cpu(dev):
    n = 1024
    keys = torch.stack(KR.split_child(torch.tensor(0), torch.tensor(13), torch.arange(n)), -1)
    sc, sk = ME.reset(keys), ME.reset(keys.to(dev))
    g = torch.Generator().manual_seed(0)
    for t in range(24):
        mask = ME.action_mask(sc)
        assert torch.equal(ME.action_mask(sk).cpu(), mask), t
        a = torch.multinomial(mask.float() + ~mask.any(1, keepdim=True), 1,
                              generator=g)[:, 0].to(torch.int32)
        sc, rc, dc = ME.step(sc, a)
        sk, rk, dk = ME.step(sk, a.to(dev))
        assert torch.equal(rk.cpu(), rc) and torch.equal(dk.cpu(), dc), t
        for k, v in vars(sc).items():
            assert torch.equal(getattr(sk, k).cpu(), v), (t, k)
        for k, v in ME.observe(sc).items():
            assert torch.equal(ME.observe(sk)[k].cpu(), v), (t, k)


def test_macro_shell_on_the_card_equals_the_cpu(dev):
    card, cpu = BalatroMacroGymEnv(seed=4, device=dev), BalatroMacroGymEnv(seed=4, device="cpu")
    (ok, _), (oc, _) = card.reset(), cpu.reset()
    rng = np.random.default_rng(0)
    for t in range(40):
        for k in oc:
            assert np.array_equal(ok[k], oc[k]) and ok[k].dtype == oc[k].dtype, (t, k)
        a = int(rng.choice(np.flatnonzero(oc["action_mask"])))
        ok, rk, dk, _, _ = card.step(a)
        oc, rc, dc, _, _ = cpu.step(a)
        assert (rk, dk) == (rc, dc), t
        if dc:
            (ok, _), (oc, _) = card.reset(), cpu.reset()


def test_generate_inventory_on_the_card_equals_the_cpu(dev):
    rng = np.random.default_rng(1)
    n = 4096
    keys = torch.as_tensor(rng.integers(0, 2 ** 32, (n, 2), dtype=np.uint64).astype(np.int64))
    ante = torch.as_tensor(rng.integers(1, 13, n).astype(np.int32))
    vou = torch.as_tensor(rng.integers(0, 4, n).astype(np.int32))
    owned = torch.as_tensor(rng.integers(0, 151, (n, 5)).astype(np.int32))
    cpu = SL.generate_inventory(keys, ante, owned, vou)
    card = SL.generate_inventory(keys.to(dev), ante.to(dev), owned.to(dev), vou.to(dev))
    for a, b in zip(card, cpu):
        assert a.device.type == "cuda" and torch.equal(a.cpu(), b)


@pytest.mark.parametrize("learner", ["a2c", "dqn"])
def test_snapshot_on_the_card_restores_onto_the_cpu(learner, dev, tmp_path):
    make = {"a2c": lambda d: TA.make_a2c(TP.full_env_hooks(),
                                         TA.A2CConfig(n_envs=256, hidden=(32,)), device=d),
            "dqn": lambda d: TD.make_dqn(TP.full_env_hooks(), TD.DQNConfig(
                n_envs=256, buffer_size=1000, learning_starts=256, hidden=(32,)), device=d)}
    init_card, update_card = make[learner](dev)
    init_cpu, update_cpu = make[learner]("cpu")
    ts, _ = update_card(init_card((0, 3)))
    save_train_state(tmp_path / "card", ts)
    back = restore_train_state(tmp_path / "card", init_cpu((0, 4)))
    save_train_state(tmp_path / "cpu", back)
    a = torch.load(Path(tmp_path / "card" / "state.pt"), map_location="cpu", weights_only=True)
    b = torch.load(Path(tmp_path / "cpu" / "state.pt"), weights_only=True)
    assert a.keys() == b.keys()
    for k in a:
        assert (torch.equal(a[k], b[k]) and b[k].device.type == "cpu"
                if torch.is_tensor(a[k]) else a[k] == b[k]), k
    update_cpu(back)                          # the restored state trains on the CPU


@pytest.mark.parametrize("algorithm", ["a2c", "dqn"])
def test_cli_trains_on_the_card(algorithm, dev):
    got = TCLI.main(["--algorithm", algorithm, "--env", "full", "--updates", "2",
                     "--n-envs", "1024", "--rollout", "4", "--log-every", "1", "--summary", ""])
    assert got["algorithm"] == algorithm and got["total_env_steps"] == 2 * 1024 * 4
    assert all(np.isfinite(v) for v in got["final_metrics"].values())


def test_tune_on_the_card(dev):
    seen = []
    sample = TT._sample
    try:
        TT._sample = lambda rng: seen.append(sample(rng)) or seen[-1]
        out = TT.tune(2, "full", 1, 256)
    finally:
        TT._sample = sample
    rng = random.Random(0)
    assert out["backend"] == "random-search" and seen == [sample(rng) for _ in range(2)]
    assert out["best_params"] in seen and np.isfinite(out["best_value"])
