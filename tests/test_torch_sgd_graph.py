"""Shuffle + SGD's host numbers as tensors, and the reader of its CUDA
graph's share, on the CPU.

On a card the learner's shuffle + SGD is one CUDA graph
(``train/ppo.py`` ``StageGraph``) whose per-update numbers (the epochs'
key words, the entropy coefficient, each step's lr and the reciprocals of
Adam's bias corrections) are one float64 vector on the card; elsewhere the
same stage runs on python numbers. Here: ``adam_update`` on 0-dim tensors
against python floats, the vector against the schedules and the key split,
the permutation from the vector's key words against the python-int key,
the key words hashed from python ints against the split in tensors, the
stage over the vector against the stage over python numbers, the eager
update's determinism, where the graph engages, and
``benchmark/metrics/sgd_graph_share.py`` on spans of updates with and
without a replay. The card's side (the graph itself) is in
tests/test_torch_ppo_cuda.py."""
import copy

import numpy as np
import pytest
import torch

from balatro_gym_tpu_torch.ops import kernel_rng as KR
from balatro_gym_tpu_torch.train import ppo as TP
from balatro_gym_tpu_torch.utils import profiling as P
from benchmark.harness import manifest as M

TRACED = {"spec": {"traffic": {"traced_steps": 2}}}     # the reader's last 2 x 2 + 1 updates
SCHEDULED = dict(total_updates=5, lr_final=1e-5, ent_coef_final=0.001)
CPU = torch.device("cpu")


@pytest.fixture(autouse=True)
def one_torch_thread():
    """Many small torch ops: one intra-op thread per test worker; and a
    fresh tracer."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    P.reset()
    yield
    P.reset()
    torch.set_num_threads(n)


def ulps(a, b):
    """Elementwise distance of two float32 tensors in units in the last
    place."""
    ia, ib = (x.contiguous().view(torch.int32).to(torch.int64) for x in (a, b))
    ia, ib = (torch.where(i < 0, -(2 ** 31) - i, i) for i in (ia, ib))
    return (ia - ib).abs()


@pytest.mark.parametrize("count", [0, 1, 7, 1000])
@pytest.mark.parametrize("max_norm", [0.5, None])
def test_adam_update_takes_tensor_scalars(count, max_norm):
    g = torch.Generator().manual_seed(count)
    params = [torch.randn(7, 5, generator=g), torch.randn(5, generator=g)]
    grads = [torch.randn(p.shape, generator=g) * 0.3 for p in params]
    st = TP.AdamState(count, [torch.randn(p.shape, generator=g) * 0.01 for p in params],
                      [torch.rand(p.shape, generator=g) * 1e-3 for p in params])
    lr = 3e-4 * (1 + count % 3)
    a, b = [p.clone() for p in params], [p.clone() for p in params]
    sa = TP.adam_update(a, grads, st, lr, max_norm)
    bc = TP.adam_bias_corrections(count + 1)
    sb = TP.adam_update(b, grads, st, torch.tensor(lr), max_norm,
                        inv_bc=tuple(torch.tensor(np.float32(1) / np.float32(x)) for x in bc))
    assert sa.count == sb.count == count + 1
    for x, y in zip(a + sa.mu + sa.nu, b + sb.mu + sb.nu):
        assert int(ulps(x, y).max()) <= 1


@pytest.mark.parametrize("scheduled", [True, False])
def test_the_scalar_vector_follows_the_schedules(scheduled):
    cfg = TP.PPOConfig(epochs=3, minibatches=4, **(SCHEDULED if scheduled else {}))
    lr_at = TP.lr_schedule(cfg)
    k_perm = (0x12345678, 0x9ABCDEF0)
    for update_idx, count in ((0, 0), (2, 24), (7, 84)):
        vec = torch.tensor(TP.sgd_scalars(cfg, k_perm, update_idx, count), dtype=torch.float64)
        assert vec.shape == (2 * cfg.epochs + 1 + 3 * cfg.epochs * cfg.minibatches,)
        keys, ent, sched = TP.read_sgd_scalars(cfg, vec, count)
        assert [tuple(int(w) for w in k) for k in keys] == KR.split_keys(k_perm, cfg.epochs)
        assert all(w.dtype == torch.int64 and w.dim() == 0 for k in keys for w in k)
        assert ent.dtype == torch.float32
        assert float(ent) == TP.ent_coef_at(cfg, update_idx)
        for c in range(count, count + cfg.epochs * cfg.minibatches):
            lr, (inv1, inv2) = sched(c)
            assert lr.dtype == inv1.dtype == inv2.dtype == torch.float32
            assert float(lr) == float(np.float32(lr_at(c)))
            assert (float(inv1), float(inv2)) == tuple(
                float(np.float32(1) / np.float32(bc)) for bc in TP.adam_bias_corrections(c + 1))
    if scheduled:
        assert TP.ent_coef_at(cfg, 0) != TP.ent_coef_at(cfg, 3) and lr_at(0) != lr_at(40)


@pytest.mark.parametrize("n", [8, 1024, 2048])
@pytest.mark.parametrize("key", [(0, 7), (0xFFFFFFFF, 0x80000000), (0x12345678, 0x9ABCDEF0)])
def test_permutation_from_the_vector_is_the_int_keys(key, n):
    cfg = TP.PPOConfig(epochs=2, minibatches=2)
    vec = torch.tensor(TP.sgd_scalars(cfg, key, 0, 0), dtype=torch.float64)
    keys, _, _ = TP.read_sgd_scalars(cfg, vec, 0)
    for words, kt in zip(KR.split_keys(key, cfg.epochs), keys):
        full = [torch.full((), w, dtype=torch.int64) for w in words]
        assert torch.equal(KR.permutation(*kt, n), KR.permutation(*full, n))


@pytest.mark.parametrize("n", [1, 4, 32, 33, 128])
@pytest.mark.parametrize("key", [(0, 7), (0xFFFFFFFF, 0x80000000), (0x12345678, 0x9ABCDEF0)])
def test_split_keys_on_the_host_are_the_tensor_split(key, n):
    """The children hashed from the key's python ints, as the scalar vector
    takes its key words, against ``split_keys`` (the key as tensors): the
    same words, as python ints."""
    got = [KR.split_child(*key, i) for i in range(n)]
    assert got == KR.split_keys(key, n)
    assert all(type(w) is int for k in got for w in k)


def tiny_cfg(**extra):
    base = dict(n_envs=32, rollout_len=4, epochs=2, minibatches=2, hidden=(32,),
                fused_rollout=True, bf16_compute=True, reset_envs_every=3, **SCHEDULED)
    return TP.PPOConfig(**{**base, **extra})


@pytest.mark.parametrize("shuffle", [True, False])
def test_stage_over_the_vector_equals_python_numbers(shuffle):
    """What the graph runs (the stage over the vector's tensors) against
    the same stage on python numbers (the key words as ints, the entropy
    coefficient, each step's lr and reciprocals of the bias corrections as
    floats), from the state and trajectory of the learner's third update:
    the learner's count, and the same parameters, moments and metrics bit
    for bit."""
    cfg = tiny_cfg(env_shuffle=shuffle)
    init_fn, update_fn, _ = TP.make_ppo(TP.full_env_hooks(), cfg, device="cpu")
    ts = init_fn([0, 5])
    for _ in range(2):
        ts, _ = update_fn(ts)
    held = copy.deepcopy(ts)
    rec = {}
    ts, _ = update_fn(ts, record=rec)
    stage = TP.make_sgd(cfg, CPU)
    k_perm = KR.split_keys(held.key, 4)[2]
    count = held.opt_state.count
    vec = torch.tensor(TP.sgd_scalars(cfg, k_perm, held.update_idx, count), dtype=torch.float64)
    traj, adv = rec["traj"], rec["adv"]
    lr_at = TP.lr_schedule(cfg)
    keys = [[torch.full((), w, dtype=torch.int64) for w in k]
            for k in KR.split_keys(k_perm, cfg.epochs)]

    def sched(c):
        return lr_at(c), tuple(float(np.float32(1) / np.float32(bc))
                               for bc in TP.adam_bias_corrections(c + 1))
    runs = []
    for args in (TP.read_sgd_scalars(cfg, vec, count),
                 (keys, TP.ent_coef_at(cfg, held.update_idx), sched)):
        net = copy.deepcopy(held.params)
        opt, means = stage(net, held.opt_state, traj, adv, adv + traj.value, *args)
        runs.append((opt.count, TP.param_list(net) + opt.mu + opt.nu + [means]))
    (n_vec, got), (n_py, want) = runs
    assert n_vec == n_py == ts.opt_state.count == 12
    assert all(torch.equal(x.detach(), y.detach()) for x, y in zip(got, want))


@pytest.mark.parametrize("fused", [True, False], ids=["fused", "generic"])
def test_the_eager_update_is_deterministic(fused):
    """The eager stage on python numbers, run twice from one state: equal
    bits in the parameters, moments and metrics."""
    cfg = tiny_cfg(fused_rollout=fused, bf16_compute=fused)
    init_fn, update_fn, _ = TP.make_ppo(TP.full_env_hooks(), cfg, device="cpu")
    assert not isinstance(update_fn.sgd, TP.StageGraph)
    ts, _ = update_fn(init_fn([0, 9]))
    a, b = copy.deepcopy(ts), copy.deepcopy(ts)
    a, ma = update_fn(a)
    b, mb = update_fn(b)
    for x, y in zip(TP.param_list(a.params) + a.opt_state.mu + a.opt_state.nu,
                    TP.param_list(b.params) + b.opt_state.mu + b.opt_state.nu):
        assert torch.equal(x, y)
    assert all(torch.equal(ma[k], mb[k]) for k in ma)


def test_the_graph_engages_on_a_card_only():
    """A ``StageGraph`` wherever the stage's steps are fixed on the host on a
    card; the CPU, and the KL gate anywhere, keep the eager stage (the card
    side: tests/test_torch_ppo_cuda.py)."""
    for extra in ({}, {"kl_target": 0.01}):
        _, update_fn, _ = TP.make_ppo(TP.full_env_hooks(), tiny_cfg(**extra), device="cpu")
        assert callable(update_fn.sgd) and not isinstance(update_fn.sgd, TP.StageGraph)


def fake_update(where):
    """The span tree of an update whose ``ppo.sgd.replay`` lies under
    ``where`` (None: no replay)."""
    with P.span("ppo.update"):
        for stage in ("ppo.collect", "ppo.sgd"):
            with P.span(stage):
                if stage == where:
                    with P.span("ppo.sgd.replay"):
                        pass


@pytest.mark.parametrize("where,share", [
    (["ppo.sgd"] * 5, 100.0),
    ([None] * 3 + ["ppo.sgd"] * 2, 40.0),
    (["ppo.sgd"] * 2 + [None] * 5, 0.0),                # only the last 5 updates count
    (["ppo.collect"] * 5, 0.0)])                        # a replay outside shuffle + SGD
def test_graph_share_reads_the_updates_that_replayed(where, share):
    with P.recording():
        for w in where:
            fake_update(w)
    assert M.reader("sgd_graph_share")(TRACED) == share


def test_graph_share_of_an_eager_learner_is_zero():
    init_fn, update_fn, _ = TP.make_ppo(TP.full_env_hooks(), tiny_cfg(), device="cpu")
    ts = init_fn([0, 1])
    for _ in range(2):
        ts, _ = update_fn(ts, record={})
    assert M.reader("sgd_graph_share")(TRACED) == 0.0


def test_graph_share_without_spans(monkeypatch):
    assert M.reader("sgd_graph_share")(TRACED) is None                # no update kept
    with P.recording():
        fake_update("ppo.sgd")
    monkeypatch.setattr(P.TRACER, "dropped", 1)
    assert M.reader("sgd_graph_share")(TRACED) is None
    monkeypatch.delattr(P, "trees")
    assert M.reader("sgd_graph_share")(TRACED) is None
