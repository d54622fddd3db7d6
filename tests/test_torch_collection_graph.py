"""The fused collection's keys on the device and the reader of the CUDA
graph's share, on the CPU: the sampler's key as a tensor against the same
key as two python ints, the rollout's step keys split on the device
against ``split_keys``, a tiny fused learner over tensor keys against the
same learner over python-int keys (3 updates, bit for bit), and
``benchmark/metrics/collect_graph_share.py`` on spans of updates with and
without a replay. The card's side (the graph itself) is in
tests/test_torch_ppo_cuda.py."""
import copy

import pytest
import torch

from balatro_gym_tpu_torch.ops import fused_policy_rollout as FP
from balatro_gym_tpu_torch.ops import kernel_rng as KR
from balatro_gym_tpu_torch.train import ppo as TP
from balatro_gym_tpu_torch.utils import profiling as P
from benchmark.harness import manifest as M

KEYS = [(0, 7), (0xFFFFFFFF, 0x80000000), (0x12345678, 0x9ABCDEF0)]
TRACED = {"spec": {"traffic": {"traced_steps": 2}}}     # the reader's last 2 x 2 + 1 updates


@pytest.fixture(autouse=True)
def fresh_tracer():
    P.reset()
    yield
    P.reset()


def logits_of(seed, n=37):
    g = torch.Generator().manual_seed(seed)
    lg = torch.randn(n, FP.N_ACTIONS, generator=g) * 3
    return torch.where(torch.rand(n, FP.N_ACTIONS, generator=g) < 0.3, -1e9, lg)


@pytest.mark.parametrize("key", KEYS)
def test_sample_takes_the_key_as_a_tensor(key):
    lg = logits_of(sum(key) % 1000)
    words = torch.tensor(key, dtype=torch.int64)
    words = torch.where(words >= 2 ** 31, words - 2 ** 32, words).to(torch.int32)
    a, lp = FP.sample(key, lg)
    b, lq = FP.sample(words, lg)
    c, lr = FP.sample_fused(words, lg, device="cpu")
    assert torch.equal(a, b) and torch.equal(lp, lq)
    assert torch.equal(a, c) and torch.equal(lp, lr)


@pytest.mark.parametrize("n", [1, 4, 128])
@pytest.mark.parametrize("key", KEYS)
def test_step_key_rows_are_split_keys(key, n):
    rows = FP.step_key_rows(torch.tensor(key, dtype=torch.int64), n)
    assert rows.dtype == torch.int32 and rows.shape == (n, 2)
    got = [tuple(w & 0xFFFFFFFF for w in r) for r in rows.tolist()]
    assert got == KR.split_keys(key, n)


@pytest.mark.parametrize("n", [1, 4, 128])
@pytest.mark.parametrize("seed", [0, 7, 2 ** 31 + 5])
def test_seed_key_rows_are_step_keys(seed, n):
    rows = FP.seed_key_rows(seed, n, "cpu")
    assert rows.dtype == torch.int32 and rows.shape == (n, 2)
    assert [tuple(w & 0xFFFFFFFF for w in r) for r in rows.tolist()] == FP.step_keys(seed, n)


def test_fused_learner_over_tensor_keys_equals_int_keys():
    """The CPU's fused learner (plain versions, step keys as device rows)
    against the same learner whose sampler gets each step's key as two
    python ints, as it did when the host split the keys: every trajectory,
    env row, metric and parameter bit for bit over 3 updates, and each
    step's words those of ``split_keys(k_roll, T)``."""
    seen = []

    def int_key_sample(step_key, logits):
        words = tuple(w & 0xFFFFFFFF for w in step_key.tolist())
        seen.append(words)
        return FP.sample(words, logits)

    cfg = TP.PPOConfig(n_envs=32, rollout_len=4, epochs=2, minibatches=2, hidden=(32,),
                       fused_rollout=True, bf16_compute=True, env_shuffle=True,
                       reset_envs_every=3, cycle_penalty=0.05)
    hooks = TP.full_env_hooks()
    init_fn, tensor_keys, _ = TP.make_ppo(hooks, cfg, device="cpu")
    ops = (FP.observe_rows_reference, int_key_sample, FP.step_rows_reference)
    _, int_keys, _ = TP.make_ppo(hooks._replace(fused_ops=ops), cfg, device="cpu")
    ts = init_fn([int(w) for w in KR.seed_key(5, device="cpu")])
    tp = copy.deepcopy(ts)                  # an update changes the weights in place
    for _ in range(3):
        k_roll = KR.split_keys(tp.key, 4)[1]
        del seen[:]
        rec, rec_p = {}, {}
        ts, m = tensor_keys(ts, record=rec)
        tp, mp = int_keys(tp, record=rec_p)
        assert seen == KR.split_keys(k_roll, cfg.rollout_len)
        for name in TP.Transition._fields:
            assert torch.equal(getattr(rec["traj"], name), getattr(rec_p["traj"], name)), name
        assert torch.equal(rec["raw"], rec_p["raw"]) and torch.equal(rec["rets"], rec_p["rets"])
        for k in ts.env_states:
            assert torch.equal(ts.env_states[k], tp.env_states[k]), k
        assert torch.equal(ts.ret_carry, tp.ret_carry)
        for p, q in zip(TP.param_list(ts.params), TP.param_list(tp.params)):
            assert torch.equal(p, q)
        assert all(torch.equal(m[k], mp[k]) for k in m)


def fake_update(where):
    """The span tree of an update whose ``ppo.collect.replay`` lies under
    ``where`` (None: no replay)."""
    with P.span("ppo.update"):
        for stage in ("ppo.collect", "ppo.sgd"):
            with P.span(stage):
                if stage == where:
                    with P.span("ppo.collect.replay"):
                        pass


@pytest.mark.parametrize("where,share", [
    (["ppo.collect"] * 5, 100.0),
    ([None] * 3 + ["ppo.collect"] * 2, 40.0),
    (["ppo.collect"] * 2 + [None] * 5, 0.0),            # only the last 5 updates count
    (["ppo.sgd"] * 5, 0.0)])                            # a replay outside the collection
def test_graph_share_reads_the_updates_that_replayed(where, share):
    with P.recording():
        for w in where:
            fake_update(w)
    assert M.reader("collect_graph_share")(TRACED) == share


def test_graph_share_of_an_eager_learner_is_zero():
    cfg = TP.PPOConfig(n_envs=16, rollout_len=2, epochs=1, minibatches=2, hidden=(32,),
                       fused_rollout=True)
    init_fn, update_fn, _ = TP.make_ppo(TP.full_env_hooks(), cfg, device="cpu")
    ts = init_fn([0, 1])
    for _ in range(2):
        ts, _ = update_fn(ts, record={})
    assert M.reader("collect_graph_share")(TRACED) == 0.0


def test_graph_share_without_spans(monkeypatch):
    assert M.reader("collect_graph_share")(TRACED) is None            # no update kept
    with P.recording():
        fake_update("ppo.collect")
    monkeypatch.setattr(P.TRACER, "dropped", 1)
    assert M.reader("collect_graph_share")(TRACED) is None
    monkeypatch.delattr(P, "trees")
    assert M.reader("collect_graph_share")(TRACED) is None
