"""The flagship engine's step and reset kernels (``env_step_kernel``,
``env_reset_kernel``) and the paths on them
(``full_env.step``, ``step_autoreset``, ``autoreset``, ``reset``, the policy
inputs, the generic PPO rollout, evaluation, the Gym shell) against their
plain versions and their CPU forms, on the card.

These tests need a card and skip where torch sees none. The machine with
the card has no JAX, and tests/conftest.py imports it, so this file imports
torch and the port only and runs there with

    python -m pytest --noconftest -m cuda tests/test_torch_full_env_cuda.py

Tolerance: none, but the observation's ``log1p(chips_needed) / 10`` row
(the kernel's ``log1pf`` against torch's CUDA ``log1p``), within 1 ulp.
"""
import numpy as np
import pytest
import torch

from balatro_gym_tpu_torch.engine import full_env as FE
from balatro_gym_tpu_torch.envs import BalatroEnvValidator, BalatroGymEnv
from balatro_gym_tpu_torch.ops import fused_full_battery as BAT
from balatro_gym_tpu_torch.ops import fused_full_rollout as F
from balatro_gym_tpu_torch.ops import fused_policy_rollout as FP
from balatro_gym_tpu_torch.ops import kernel_rng as KR
from balatro_gym_tpu_torch.train import evaluate as EV
from balatro_gym_tpu_torch.train import ppo as TP
from balatro_gym_tpu_torch.train.networks import ActorCritic

pytestmark = pytest.mark.cuda

SIZES = (1, 31, 33, 257, 8192, 8193)      # partial blocks of 32 and 64 envs
LOG1P_ROW = FP.OBS_DIM - 6


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (torch.cuda.is_available() is False)")
    return torch.device("cuda", torch.cuda.current_device())


def assert_packed_step(got, want, what):
    for k in ("cards", "ints", "rng"):
        assert torch.equal(got[0][k], want[0][k]), f"{what}: {k}"
    assert torch.equal(got[1], want[1]) and torch.equal(got[2], want[2]), what


def battery(n, dev, seed):
    rng = np.random.default_rng(seed)
    st = BAT.surgery(F.rollout_full_fused(seed, n, 4, device=dev)["state"], rng)
    return st, rng


@pytest.mark.parametrize("n", SIZES)
def test_env_step_kernel_equals_plain(dev, n):
    """12 fed legal steps of a diversified state, and the autoreset batches."""
    st, rng = battery(n, dev, n)
    packed = F.pack_full_state(st)
    n0 = FP.env_step_fused.launches
    for t in range(12):
        a = torch.as_tensor(BAT.sample_legal(F._legal_rows(F._load(packed)).T.cpu().numpy(),
                                             rng), device=dev)
        got = FP.env_step_fused(packed, a, device=dev)
        assert_packed_step(got, FP.env_step_rows_reference(packed, a), f"n={n} step {t}")
        packed = FP.step_rows_reference(packed, a)[0]
    for (p, a), ends in zip(BAT.reset_batches(packed), (False, True)):
        got = FP.env_step_fused(p, a, device=dev)
        assert_packed_step(got, FP.env_step_rows_reference(p, a), f"n={n} ends={ends}")
        assert bool((got[2] == ends).all()) and bool((F._load(got[0])["done"] == ends).all())
    torch.cuda.synchronize()
    assert FP.env_step_fused.launches == n0 + 14


def test_env_step_kernel_shape(dev):
    """The step's 64-env blocks and their shared memory (888 B a State
    slot, a class byte and two 2-byte places an env), at most 72 registers
    and 160 B of stack; K3a's blocks of envs the same with four threads an
    env, its shared memory the same and each of its eight warps' 64 sort
    keys; the reset's 32 warps a block, a State slot and 64 sort keys each."""
    shape = FP.env_step_kernel_shape()
    assert shape["block"] == 64 and shape["shared_bytes"] == 64 * (888 + 5), shape
    assert shape["registers"] <= 72 and shape["stack_bytes"] <= 160, shape
    k3a = FP.step_kernel_shape()
    assert k3a["block"] == 4 * 64 and k3a["shared_bytes"] == 64 * (888 + 5) + 8 * 64 * 8, k3a
    reset = FP.env_reset_kernel_shape()
    assert reset["block"] == 1024 and reset["shared_bytes"] == 32 * (888 + 64 * 8), reset


def single_class_batches(n, dev, seed):
    st, rng = battery(2048, dev, seed)
    pool = []
    for _ in range(8):
        pool.append(F.pack_full_state(st))
        a = torch.as_tensor(BAT.sample_legal(FE.action_mask(st).cpu().numpy(), rng), device=dev)
        st, _, _ = FE.step_autoreset(st, a)
    return BAT.class_batches(pool, n, rng)


@pytest.mark.parametrize("n", (257, 8192))
def test_env_step_on_single_class_batches(dev, n):
    """The kernel on each batch whose envs all take one branch class,
    against the plain no-reset step."""
    batches = single_class_batches(n, dev, n)
    assert set(batches) == {name for name, _, _ in BAT.ACTION_CLASSES}
    for name, (p, a) in batches.items():
        assert_packed_step(FP.env_step_fused(p, a, device=dev), FP.env_step_rows_reference(p, a),
                           name)


def reset_mask(kind, n, dev):
    env = torch.arange(n, device=dev)
    return {"all": env >= 0, "none": env < 0, "alternating": env % 2 == 1,
            "sparse": env % 37 == 5}[kind]


@pytest.mark.parametrize("kind", ("all", "none", "alternating", "sparse"))
@pytest.mark.parametrize("n", (1, 31, 33, 257, 8193))
def test_env_reset_kernel_equals_plain(dev, n, kind):
    """``env_reset_fused`` in both modes (each env's fold_in(key, step
    count); given keys) on a mid-game state, in place, against
    ``env_reset_rows_reference``; one launch each."""
    st, rng = battery(n, dev, n + 1)
    for _ in range(3):
        a = torch.as_tensor(BAT.sample_legal(FE.action_mask(st).cpu().numpy(), rng), device=dev)
        st, _, _ = FE.step(st, a)
    packed, mask = F.pack_full_state(st), reset_mask(kind, n, dev)
    keys = torch.stack(KR.split_child(*KR.seed_key(n, device=dev), torch.arange(n, device=dev)),
                       -1)
    for k in (None, keys):
        rows = {name: v.clone() for name, v in packed.items()}
        n0 = FP.env_reset_fused.launches
        got = FP.env_reset_fused(rows, mask, k, device=dev)
        assert FP.env_reset_fused.launches == n0 + 1
        assert all(got[name] is rows[name] for name in rows)
        want = FP.env_reset_rows_reference(packed, mask, k)
        for name in rows:
            assert torch.equal(rows[name], want[name]), (name, k is None)


def test_engine_step_and_autoreset_on_the_card(dev):
    """``full_env.step`` launches the step kernel and equals the plain
    no-reset step; ``step_autoreset`` launches it and the reset kernel and
    equals the plain step with the engine's torch reset merged; each equals
    its CPU form, as ``autoreset`` and ``reset(keys)`` do."""
    st, rng = battery(1024, dev, 3)
    st.ante = torch.where(torch.arange(1024, device=dev) % 9 == 4, 101, st.ante)
    for t in range(8):
        a = torch.as_tensor(BAT.sample_legal(FE.action_mask(st).cpu().numpy(), rng), device=dev)
        n0 = (FP.env_step_fused.launches, FP.env_reset_fused.launches)
        s1, r1, d1 = FE.step(st, a)
        assert (FP.env_step_fused.launches, FP.env_reset_fused.launches) == (n0[0] + 1, n0[1])
        s, r, d = F._step(F._load(F.pack_full_state(st)), a, autoreset=False)
        assert F.states_equal(s1, F.unpack_full_state(F._store(s))) == []
        assert torch.equal(r1, r) and torch.equal(d1, d)
        s2, r2, d2 = FE.step_autoreset(st, a)
        assert (FP.env_step_fused.launches, FP.env_reset_fused.launches) == (n0[0] + 2, n0[1] + 1)
        k1, k2 = KR.fold_in(s1.key[:, 0], s1.key[:, 1], s1.step_count.to(torch.int64))
        want = FE.where_envs(d1, FE.reset_reference(torch.stack([k1, k2], -1)), s1)
        assert F.states_equal(s2, want) == [] and torch.equal(r2, r1) and torch.equal(d2, d1)
        cpu = FE.step_autoreset(to_cpu(st), a.cpu())
        assert F.states_equal(to_cpu(s2), cpu[0]) == [] and torch.equal(d2.cpu(), cpu[2])
        assert F.states_equal(to_cpu(FE.autoreset(s1, d1)), FE.autoreset(to_cpu(s1), d1.cpu())) == []
        assert int(d1.sum()) > 0 or t > 0
        st = s2
    keys = torch.stack(KR.split_child(*KR.seed_key(5, device=dev), torch.arange(1000, device=dev)),
                       -1)
    n0 = FP.env_reset_fused.launches
    fresh = FE.reset(keys)
    assert FP.env_reset_fused.launches == n0 + 1
    assert F.states_equal(to_cpu(fresh), FE.reset(keys.cpu())) == []


def to_cpu(st):
    return type(st)(**{k: v.cpu() for k, v in vars(st).items()})


def test_policy_inputs_launch_k3b(dev):
    st, _ = battery(777, dev, 4)
    n0 = FP.observe_fused.launches
    obs, mask = FE.observe_vector(st), FE.action_mask(st)
    assert FP.observe_fused.launches == n0 + 2
    p_obs, p_mask = FP.observe_rows_reference(F.pack_full_state(st))
    assert torch.equal(mask, p_mask)
    other = torch.arange(FP.OBS_DIM, device=dev) != LOG1P_ROW
    assert torch.equal(obs[:, other], p_obs[:, other])
    ulp = (obs[:, LOG1P_ROW].view(torch.int32) - p_obs[:, LOG1P_ROW].view(torch.int32)).abs()
    assert int(ulp.max()) <= 1
    got = FE.observe(st)
    assert torch.equal(got["action_mask"], p_mask.to(torch.int32))


def test_generic_update_launches_the_kernels(dev):
    cfg = TP.PPOConfig(n_envs=256, rollout_len=4, epochs=1, minibatches=2, hidden=(64,))
    init_fn, update_fn, _ = TP.make_ppo(TP.full_env_hooks(), cfg, device=dev)
    ts = init_fn([int(w) for w in KR.seed_key(0, device="cpu")])
    n0 = (FP.env_step_fused.launches, FP.observe_fused.launches, FP.env_reset_fused.launches)
    ts, metrics = update_fn(ts)
    torch.cuda.synchronize()
    assert FP.env_step_fused.launches - n0[0] == cfg.rollout_len
    assert FP.observe_fused.launches - n0[1] == 2 * (cfg.rollout_len + 1)
    assert FP.env_reset_fused.launches - n0[2] == cfg.rollout_len
    assert all(np.isfinite(float(v)) for v in metrics.values())


def test_evaluate_and_shell_on_the_card(dev):
    net = ActorCritic(FP.N_ACTIONS, FP.OBS_DIM, (64,),
                      generator=torch.Generator().manual_seed(0)).to(dev)
    n0 = FP.env_step_fused.launches
    stats = EV.evaluate_policy(lambda p, o, m: p(o, m), net, TP.full_env_hooks(), 64, 32)
    assert FP.env_step_fused.launches == n0 + 32
    assert set(stats) == {"episodes", "mean_reward", "mean_length", "max_reward", "mean_ante",
                          "max_ante"}
    assert 0 <= stats["episodes"] <= 64 and 0 < stats["mean_length"] <= 32
    env = BalatroGymEnv(seed=3)
    obs, _ = env.reset()
    assert set(obs) == set(BalatroGymEnv(seed=3, device="cpu").reset()[0])
    assert BalatroEnvValidator.validate_determinism(steps=20)
    assert BalatroEnvValidator.validate_action_masking(steps=10)
