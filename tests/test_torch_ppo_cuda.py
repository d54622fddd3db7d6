"""The PPO learner on the card: the fused update (K3b, the sampler and K3a)
against the same update over the kernels' plain versions, and the sim
learner on the card against the CPU.

On the card the fused update's collection is one CUDA graph, captured on
the learner's first update and replayed by every update; the tests below
the first hold its replays against the eager plain path and check that a
state or record an update returns is its own. Shuffle + SGD is a second
graph on the card, on the fused and the generic path alike, wherever no
KL gate reads the card: its replays are held against the eager stage on
the card, which a KL target that no minibatch reaches (``EAGER_KL``) keeps
(the gate then stops nothing, so the steps are the same). The kernels' wrappers count
their launches (``.launches``) in the graph's warm-up and capture, and a
replay launches no wrapper: the counts below are the capture's, beside the
graph's ``replays`` (``chip_smoke.py`` phases 15 and 24 count a replayed
update's kernels by name in a profile of the card).

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
import dataclasses

import pytest
import torch

from balatro_gym_tpu_torch.ops import fused_policy_rollout as FP
from balatro_gym_tpu_torch.ops import kernel_rng as KR
from balatro_gym_tpu_torch.train import cli as TCLI
from balatro_gym_tpu_torch.train import ppo as TP
from balatro_gym_tpu_torch.utils import checkpoint as CK
from balatro_gym_tpu_torch.utils import profiling as P

pytestmark = pytest.mark.cuda

SEED = [int(w) for w in KR.seed_key(0, device="cpu")]
EAGER_KL = 1e30         # a KL gate that never stops: the eager stage, the same steps


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
    for _ in range(2):                      # a mid-game start; the first captures the graph
        ts, _ = fused(ts)
    ts_p = copy.deepcopy(ts)
    n0 = _counts()
    rec, rec_p = {}, {}
    ts, m = fused(ts, record=rec)
    assert _counts() == n0 and fused.collection.replays == 3   # a replay launches no wrapper
    ts_p, m_p = plain(ts_p, record=rec_p)
    assert _counts() == n0
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
    # the collection's graph captured (its warm-up and capture, 2 steps each) and replayed once
    assert _counts() == (n0[0] + 2, n0[1] + 4, n0[2] + 4)
    assert update_fn.collection.replays == 1 and update_fn.sgd.replays == 1
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
    # the collection's graph captured (its warm-up and capture, 4 steps each), then replayed
    assert _counts() == (n0[0] + 2, n0[1] + 8, n0[2] + 8)
    assert summary["total_env_steps"] == 2 * 1024 * 4 and summary["n_devices"] == 1
    assert all(v == v for v in summary["final_metrics"].values())          # no NaN


def test_replayed_updates_equal_plain_updates(dev, tmp_path):
    """Five updates of the graph (its capture on the first), the state
    saved and restored between the second and the third, each held against
    the same update over the kernels' plain versions from the same state."""
    cfg = TP.PPOConfig(n_envs=1024, rollout_len=8, epochs=2, minibatches=2, fused_rollout=True,
                       bf16_compute=True, env_shuffle=True, reset_envs_every=3)
    hooks = TP.full_env_hooks()
    init_fn, fused, _ = TP.make_ppo(hooks, cfg)
    plain_ops = (FP.observe_rows_reference, FP.sample, FP.step_rows_reference)
    _, plain, _ = TP.make_ppo(hooks._replace(fused_ops=plain_ops), cfg)
    ts = init_fn(SEED)
    for i in range(5):
        if i == 2:
            CK.save_train_state(tmp_path / "ts", ts)
            ts = CK.restore_train_state(tmp_path / "ts", ts)
        ts_p = copy.deepcopy(ts)
        n0, T = _counts(), cfg.rollout_len
        rec, rec_p = {}, {}
        ts, m = fused(ts, record=rec)
        # the capture's warm-up and capture launch through the wrappers; a replay launches none
        want = (2, 2 * T, 2 * T) if i == 0 else (0, 0, 0)
        assert _counts() == tuple(a + b for a, b in zip(n0, want))
        assert fused.collection.replays == i + 1
        ts_p, m_p = plain(ts_p, record=rec_p)
        for name in ("action", "reward", "done", "value", "mask", "obs"):
            assert torch.equal(getattr(rec["traj"], name), getattr(rec_p["traj"], name)), (i, name)
        assert float((rec["traj"].log_prob - rec_p["traj"].log_prob).abs().max()) <= 1e-6
        assert torch.equal(rec["raw"], rec_p["raw"]) and torch.equal(rec["rets"], rec_p["rets"])
        for k in ("cards", "ints", "rng"):
            assert torch.equal(ts.env_states[k], ts_p.env_states[k]), (i, k)
        assert torch.equal(ts.ret_carry, ts_p.ret_carry)
        assert_params(ts, ts_p)
        assert_metrics(m, m_p)


def tensors(x):
    """The tensors of a tree of dicts, lists, tuples and dataclasses."""
    if torch.is_tensor(x):
        return [x]
    if isinstance(x, dict):
        x = list(x.values())
    elif dataclasses.is_dataclass(x):
        x = list(vars(x).values())
    return [t for v in x for t in tensors(v)]


def test_an_update_leaves_the_last_state_and_record_alone(dev):
    """The graph's buffers change at every replay; a TrainState or a record
    that an update returned does not."""
    cfg = TP.PPOConfig(n_envs=512, rollout_len=4, epochs=1, minibatches=2, fused_rollout=True,
                       bf16_compute=True)
    init_fn, update_fn, _ = TP.make_ppo(TP.full_env_hooks(), cfg)
    rec = {}
    ts1, _ = update_fn(init_fn(SEED), record=rec)
    held = copy.deepcopy((ts1.env_states, ts1.ret_carry, ts1.obs_stats, ts1.ret_stats,
                          ts1.opt_state.mu, ts1.opt_state.nu, rec["traj"], rec["raw"],
                          rec["rets"]))
    ts2, _ = update_fn(ts1)
    update_fn(ts2)
    now = (ts1.env_states, ts1.ret_carry, ts1.obs_stats, ts1.ret_stats, ts1.opt_state.mu,
           ts1.opt_state.nu, rec["traj"], rec["raw"], rec["rets"])
    a, b = tensors(held), tensors(now)
    assert len(a) == len(b) > 20
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert not torch.equal(ts2.env_states["ints"], ts1.env_states["ints"])


def test_each_update_replays_once_without_host_syncs(dev):
    cfg = TP.PPOConfig(n_envs=512, rollout_len=4, epochs=1, minibatches=2, fused_rollout=True,
                       bf16_compute=True, env_shuffle=True)
    init_fn, update_fn, _ = TP.make_ppo(TP.full_env_hooks(), cfg)
    ts = init_fn(SEED)
    P.reset()
    try:
        for _ in range(3):
            ts, _ = update_fn(ts, record={})
        torch.cuda.synchronize()
        trees = P.trees("ppo.update")
    finally:
        P.reset()
    assert len(trees) == 3 and update_fn.collection.replays == 3
    for i, tree in enumerate(trees):
        names = [s["name"] for s in tree["spans"]]
        collect = next(s["id"] for s in tree["spans"] if s["name"] == "ppo.collect")
        replay = [s for s in tree["spans"] if s["name"] == "ppo.collect.replay"]
        assert len(replay) == 1 and replay[0]["parent"] == collect
        assert names.count("ppo.collect.capture") == (i == 0)
        # the capture's warm-up and capture run the rollout's steps; a replay none
        assert names.count("ppo.collect.policy") == (2 * cfg.rollout_len if i == 0 else 0)
        if i:
            assert tree["syncs"] == 0, tree["syncs"]


@pytest.mark.parametrize("layout", ["policy", "row_major"])
def test_sample_fused_reads_the_key_on_the_card(dev, layout):
    g = torch.Generator(device=dev).manual_seed(3)
    n = 1000
    logits = torch.randn(FP.N_ACTIONS, n, generator=g, device=dev).T * 3
    logits = torch.where(torch.rand(n, FP.N_ACTIONS, generator=g, device=dev) < 0.3, -1e9, logits)
    if layout == "row_major":
        logits = logits.contiguous()
    for key in [(0, 7), (0xFFFFFFFF, 0x80000000), (0x12345678, 0x9ABCDEF0)]:
        rows = FP.step_key_rows(torch.tensor(key, dtype=torch.int64, device=dev), 3)
        for row, words in zip(rows, KR.split_keys(key, 3)):
            a, lp = FP.sample(words, logits)
            b, lq = FP.sample_fused(row, logits)
            assert torch.equal(a, b) and float((lp - lq).abs().max()) <= 1e-6


SGD_CASES = {
    "fused": dict(n_envs=1024, rollout_len=8, fused_rollout=True, bf16_compute=True,
                  env_shuffle=True, reset_envs_every=3),
    "generic": dict(n_envs=256, rollout_len=4),
}


def sgd_learners(case, **extra):
    """(init_fn, the learner whose shuffle + SGD is a graph, the same
    learner with the eager stage) of a case of :data:`SGD_CASES`, on the
    card, with a schedule of lr and entropy so each replay reads new
    numbers."""
    cfg = TP.PPOConfig(epochs=2, minibatches=2, total_updates=6, lr_final=1e-5,
                       ent_coef_final=0.001, **{**SGD_CASES[case], **extra})
    init_fn, graphed, _ = TP.make_ppo(TP.full_env_hooks(), cfg)
    _, eager, _ = TP.make_ppo(TP.full_env_hooks(), dataclasses.replace(cfg, kl_target=EAGER_KL))
    assert isinstance(graphed.sgd, TP.StageGraph) and not isinstance(eager.sgd, TP.StageGraph)
    return cfg, init_fn, graphed, eager


@pytest.mark.parametrize("case", list(SGD_CASES))
def test_replayed_sgd_equals_the_eager_stage(dev, case, tmp_path):
    """Five updates whose shuffle + SGD replays the graph (its capture on
    the first), the state saved and restored between the second and the
    third, each held against the eager stage on the card from the same
    state: the same trajectory, Adam count, parameters, moments and metrics
    bit for bit (the graph multiplies by the reciprocals of the bias
    corrections, as the card divides by the eager stage's python
    numbers)."""
    cfg, init_fn, graphed, eager = sgd_learners(case)
    ts = init_fn(SEED)
    for i in range(5):
        if i == 2:
            CK.save_train_state(tmp_path / "ts", ts)
            ts = CK.restore_train_state(tmp_path / "ts", ts)
        ts_e = copy.deepcopy(ts)
        rec, rec_e = {}, {}
        ts, m = graphed(ts, record=rec)
        ts_e, m_e = eager(ts_e, record=rec_e)
        assert graphed.sgd.replays == i + 1
        for name in TP.Transition._fields:
            assert torch.equal(getattr(rec["traj"], name), getattr(rec_e["traj"], name)), name
        assert ts.opt_state.count == ts_e.opt_state.count == (i + 1) * 4
        assert ts.update_idx == ts_e.update_idx == i + 1
        for a, b in zip(TP.param_list(ts.params) + ts.opt_state.mu + ts.opt_state.nu,
                        TP.param_list(ts_e.params) + ts_e.opt_state.mu + ts_e.opt_state.nu):
            assert torch.equal(a, b)
        assert all(torch.equal(m[k], m_e[k]) for k in m_e), (m, m_e)


@pytest.mark.parametrize("case", list(SGD_CASES))
def test_replays_leave_held_moments_and_metrics_alone(dev, case):
    """The graph's moments and metrics change at every replay; the Adam
    state and the metrics an update returned do not, nor the parameters of
    a copy of its state."""
    _, init_fn, update_fn, _ = sgd_learners(case)
    ts1, m1 = update_fn(init_fn(SEED))
    kept = copy.deepcopy(ts1)
    held = copy.deepcopy((ts1.opt_state.mu, ts1.opt_state.nu, m1, TP.param_list(kept.params)))
    ts2, _ = update_fn(ts1)
    update_fn(ts2)
    now = (ts1.opt_state.mu, ts1.opt_state.nu, m1, TP.param_list(kept.params))
    a, b = tensors(held), tensors(now)
    assert len(a) == len(b) > 20
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert not torch.equal(ts2.opt_state.mu[0], ts1.opt_state.mu[0])
    assert ts2.opt_state.count == 2 * 4 and ts1.opt_state.count == 4


def sgd_syncs(tree) -> int:
    """The host syncs counted in the spans of ``tree`` under its
    ``ppo.sgd``."""
    parent = {s["id"]: s["parent"] for s in tree["spans"]}
    sgd = next(s["id"] for s in tree["spans"] if s["name"] == "ppo.sgd")

    def under(i):
        while i and i != sgd:
            i = parent.get(i, 0)
        return i == sgd
    return sum(s["syncs"] for s in tree["spans"] if under(s["id"]))


@pytest.mark.parametrize("case", list(SGD_CASES))
def test_each_update_replays_sgd_once_without_host_syncs(dev, case):
    """One ``ppo.sgd.replay`` span under ``ppo.sgd`` an update, the
    capture's on the first; no host sync in shuffle + SGD after it (none in
    the whole fused update, whose envs no staggered reset repacks: the
    pack's two syncs are the collection's)."""
    _, init_fn, update_fn, _ = sgd_learners(case, reset_envs_every=0)
    ts = init_fn(SEED)
    P.reset()
    try:
        for _ in range(3):
            ts, _ = update_fn(ts, record={})
        torch.cuda.synchronize()
        trees = P.trees("ppo.update")
    finally:
        P.reset()
    assert len(trees) == 3 and update_fn.sgd.replays == 3
    for i, tree in enumerate(trees):
        names = [s["name"] for s in tree["spans"]]
        sgd = next(s["id"] for s in tree["spans"] if s["name"] == "ppo.sgd")
        replay = [s for s in tree["spans"] if s["name"] == "ppo.sgd.replay"]
        assert len(replay) == 1 and replay[0]["parent"] == sgd
        assert names.count("ppo.sgd.capture") == (i == 0)
        # the capture's warm-up and capture run the stage's minibatches; a replay none
        assert names.count("ppo.sgd.adam") == (2 * 4 if i == 0 else 0)
        if i:
            assert sgd_syncs(tree) == 0
            if case == "fused":
                assert tree["syncs"] == 0, tree["syncs"]
