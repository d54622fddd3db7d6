"""Checkpoint and exact resume of the port's learner
(``utils/checkpoint.py``), and the CLI's ``--checkpoint-dir`` and
``--resume``, on the CPU.

The reference's contract (tests/test_checkpoint_scaling.py): save,
restore, and the next update equals the uninterrupted one bit for bit:
the parameters, Adam's moments, both running statistics, the return carry,
every env state and the key. Held for the three learners: the sim env's,
the flagship env's over the generic rollout (a ``FullEnvState``) and over
the fused collection (packed rows), each at a tiny size; and for A2C and
DQN (RMSprop's moments; the target network and the replay ring with its
pointer and length) on both envs.
"""
import copy
import dataclasses

import numpy as np
import pytest
import torch

from balatro_gym_tpu_torch.ops import kernel_rng as KR
from balatro_gym_tpu_torch.train import a2c as TA
from balatro_gym_tpu_torch.train import cli as TCLI
from balatro_gym_tpu_torch.train import dqn as TD
from balatro_gym_tpu_torch.train import ppo as TP
from balatro_gym_tpu_torch.utils.checkpoint import restore_train_state, save_train_state

LEARNERS = {
    # the lr and entropy schedules read Adam's count and the update index
    "sim": (TP.sim_env_hooks, dict(n_envs=16, rollout_len=4, epochs=2, minibatches=2,
                                   hidden=(32,), total_updates=4, lr_final=1e-5,
                                   ent_coef_final=1e-3, cycle_penalty=0.05)),
    "generic": (TP.full_env_hooks, dict(n_envs=16, rollout_len=3, epochs=1, minibatches=2,
                                        hidden=(32,), reset_envs_every=3)),
    "fused": (TP.full_env_hooks, dict(n_envs=64, rollout_len=2, epochs=1, minibatches=2,
                                      hidden=(32,), fused_rollout=True, env_shuffle=True)),
}


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def snapshot(path):
    return torch.load(path / "state.pt", weights_only=True)


def assert_snapshots_equal(a, b):
    assert a.keys() == b.keys()
    for k in a:
        if torch.is_tensor(a[k]):
            assert a[k].dtype == b[k].dtype and torch.equal(a[k], b[k]), k
        else:
            assert a[k] == b[k], k


@pytest.mark.parametrize("name", list(LEARNERS))
def test_resume_gives_the_uninterrupted_update(name, tmp_path):
    hooks_fn, kw = LEARNERS[name]
    init_fn, update_fn, _ = TP.make_ppo(hooks_fn(), TP.PPOConfig(**kw), device="cpu")
    ts, _ = update_fn(init_fn((0, 5)))
    save_train_state(tmp_path / "saved", ts)
    template = init_fn((0, 6))
    kept = copy.deepcopy(template)
    restored = restore_train_state(tmp_path / "saved", template)
    # the template keeps its own values; the restore holds the saved ones
    save_train_state(tmp_path / "template", template)
    save_train_state(tmp_path / "kept", kept)
    assert_snapshots_equal(snapshot(tmp_path / "template"), snapshot(tmp_path / "kept"))
    save_train_state(tmp_path / "restored", restored)
    assert_snapshots_equal(snapshot(tmp_path / "restored"), snapshot(tmp_path / "saved"))
    assert type(restored.env_states) is type(ts.env_states)
    assert restored.update_idx == 1 and restored.opt_state.count == ts.opt_state.count > 0
    assert isinstance(restored.key, tuple) and restored.key == ts.key

    cont, m_cont = update_fn(ts)
    res, m_res = update_fn(restored)
    save_train_state(tmp_path / "cont", cont)
    save_train_state(tmp_path / "res", res)
    assert_snapshots_equal(snapshot(tmp_path / "cont"), snapshot(tmp_path / "res"))
    for k in m_cont:
        assert torch.equal(m_cont[k], m_res[k]), k
    flat = snapshot(tmp_path / "cont")
    env_keys = {k.split(".")[2] for k in flat if k.startswith("ts.env_states.")}
    want = {"sim": {"deck_n", "hand_rank", "key", "done"}, "generic": {"card_rank", "rng_counters"},
            "fused": {"cards", "ints", "rng"}}[name]
    assert want <= env_keys, env_keys


OTHER = {
    "a2c": lambda hooks: TA.make_a2c(hooks, TA.A2CConfig(n_envs=16, rollout_len=3,
                                                         hidden=(32,)), device="cpu"),
    # the ring wraps in the second update; the target syncs every update
    "dqn": lambda hooks: TD.make_dqn(hooks, TD.DQNConfig(
        n_envs=16, buffer_size=40, batch_size=8, learning_starts=16, steps_per_update=2,
        target_update_every=1, hidden=(32,)), device="cpu"),
}


@pytest.mark.parametrize("env_name", ["sim", "full"])
@pytest.mark.parametrize("learner", list(OTHER))
def test_other_learners_resume_bit_for_bit(learner, env_name, tmp_path):
    hooks = TP.sim_env_hooks() if env_name == "sim" else TP.full_env_hooks()
    init_fn, update_fn = OTHER[learner](hooks)
    ts, _ = update_fn(init_fn((0, 5)))
    save_train_state(tmp_path / "saved", ts)
    restored = restore_train_state(tmp_path / "saved", init_fn((0, 6)))
    save_train_state(tmp_path / "restored", restored)
    assert_snapshots_equal(snapshot(tmp_path / "restored"), snapshot(tmp_path / "saved"))
    assert restored.update_idx == 1 and restored.key == ts.key
    cont, m_cont = update_fn(ts)
    res, m_res = update_fn(restored)
    save_train_state(tmp_path / "cont", cont)
    save_train_state(tmp_path / "res", res)
    assert_snapshots_equal(snapshot(tmp_path / "cont"), snapshot(tmp_path / "res"))
    for k in m_cont:
        assert (torch.equal(m_cont[k], m_res[k]) if torch.is_tensor(m_cont[k])
                else m_cont[k] == m_res[k]), k
    flat = snapshot(tmp_path / "cont")
    if learner == "dqn":
        assert flat["ts.buf_ptr"] == 24 and flat["ts.buf_len"] == 40
        assert {"ts.buf_obs", "ts.buf_next_mask", "ts.buf_done"} <= flat.keys()
        assert any(k.startswith("ts.target_params.") for k in flat)
    else:
        assert {"ts.opt_state.nu.0", "ts.obs_stats.mean"} <= flat.keys()


def test_restore_rejects_another_structure(tmp_path):
    sim_init, sim_update, _ = TP.make_ppo(TP.sim_env_hooks(),
                                          TP.PPOConfig(**LEARNERS["sim"][1]), device="cpu")
    save_train_state(tmp_path / "sim", sim_init((0, 1)))
    fused_init, _, _ = TP.make_ppo(TP.full_env_hooks(), TP.PPOConfig(**LEARNERS["fused"][1]),
                                   device="cpu")
    with pytest.raises(ValueError, match="structure"):
        restore_train_state(tmp_path / "sim", fused_init((0, 1)))
    wide_init, _, _ = TP.make_ppo(TP.sim_env_hooks(), TP.PPOConfig(
        **{**LEARNERS["sim"][1], "hidden": (48,)}), device="cpu")
    with pytest.raises(ValueError):
        restore_train_state(tmp_path / "sim", wide_init((0, 1)))


def test_snapshot_is_plain_tensors_and_scalars(tmp_path):
    """The file unpickles under ``weights_only=True``: a flat dict of
    tensors, ints, floats and strings, keyed by path."""
    init_fn, _, _ = TP.make_ppo(TP.full_env_hooks(), TP.PPOConfig(**LEARNERS["generic"][1]),
                                device="cpu")
    save_train_state(tmp_path / "s", init_fn((0, 2)))
    flat = snapshot(tmp_path / "s")
    assert all(torch.is_tensor(v) or isinstance(v, (int, float, str)) for v in flat.values())
    assert {"ts.update_idx", "ts.key.0", "ts.key.1", "ts.opt_state.count", "ts.ret_carry",
            "ts.obs_stats.mean", "ts.ret_stats.count"} <= flat.keys()
    assert any(k.startswith("ts.params.") for k in flat)


# ---------------------------------------------------------------------------
# The CLI: --checkpoint-dir / --checkpoint-every / --resume
# ---------------------------------------------------------------------------

CLI = {
    "sim": ["--env", "sim", "--n-envs", "16", "--rollout", "4", "--epochs", "2",
            "--minibatches", "2", "--hidden", "32"],
    "full": ["--env", "full", "--n-envs", "16", "--rollout", "3", "--epochs", "1",
             "--minibatches", "2", "--hidden", "32"],
    "fused": ["--env", "full", "--fused-rollout", "--n-envs", "64", "--rollout", "2",
              "--epochs", "1", "--minibatches", "2", "--hidden", "32"],
    "a2c": ["--algorithm", "a2c", "--env", "full", "--n-envs", "16", "--rollout", "3"],
    "dqn": ["--algorithm", "dqn", "--env", "sim", "--n-envs", "16", "--rollout", "2"],
}


@pytest.mark.parametrize("mode", list(CLI))
def test_cli_saves_and_resumes(mode, tmp_path, capsys):
    """Train 2 updates saving every update; resume from ``step_1`` for 1
    update: the same final metrics, and its snapshot equals the
    uninterrupted run's ``step_2`` bit for bit."""
    base = CLI[mode] + ["--device", "cpu", "--summary", "", "--log-every", "1",
                        "--checkpoint-every", "1"]
    full = TCLI.main(base + ["--updates", "2", "--checkpoint-dir", str(tmp_path / "run")])
    assert sorted(p.name for p in (tmp_path / "run").iterdir()) == ["step_1", "step_2"]
    capsys.readouterr()
    resumed = TCLI.main(base + ["--updates", "1", "--checkpoint-dir", str(tmp_path / "again"),
                                "--resume", str(tmp_path / "run" / "step_1")])
    out = capsys.readouterr().out
    assert f"resumed from {tmp_path / 'run' / 'step_1'} at update 1" in out
    assert resumed["final_metrics"] == full["final_metrics"]
    assert_snapshots_equal(snapshot(tmp_path / "again" / "step_1"),
                           snapshot(tmp_path / "run" / "step_2"))
    assert snapshot(tmp_path / "again" / "step_1")["ts.update_idx"] == 2
