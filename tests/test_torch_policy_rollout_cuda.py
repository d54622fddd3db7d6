"""The CUDA kernels of the port's policy collection (K3a, K3b and the
sampler) against their plain versions, on the card.

These tests need a card and skip where torch sees none. The machine with
the card has no JAX, and tests/conftest.py imports it, so this file imports
torch and the port only and runs there with

    python -m pytest --noconftest -m cuda tests/test_torch_policy_rollout_cuda.py

Tolerance: none, except the observation's ``log1p(chips_needed) / 10`` row
(the kernel's ``log1pf`` against torch's CUDA ``log1p``), within 1 ulp, and
the sampler's log-probability (a sum of 60 ``expf`` in another order than
torch's ``log_softmax``), within 1e-6. Packed states, rewards, dones, masks,
every other observation row and the sampled actions are bit for bit.
"""
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from balatro_gym_tpu_torch.ops import fused_full_battery as BAT
from balatro_gym_tpu_torch.ops import fused_full_rollout as F
from balatro_gym_tpu_torch.ops import fused_policy_rollout as FP
from balatro_gym_tpu_torch.train.networks import ActorCritic

pytestmark = pytest.mark.cuda

SIZES = (1, 31, 33, 257, 1000, 1025, 8192, 8193)  # K3a: 64-env blocks
LOG1P_ROW = FP.OBS_DIM - 6
SOURCE = (Path(FP.__file__).resolve().parents[1] / "csrc" / "fused_policy_rollout.cu").read_text()
STATE_BYTES = 888


def declared(name):
    """An int constant as csrc/fused_policy_rollout.cu declares it."""
    return int(re.search(r"\b%s = (\d+)[,;]" % name, SOURCE).group(1))


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (torch.cuda.is_available() is False)")
    return torch.device("cuda", torch.cuda.current_device())


def _policy(dev, seed=1):
    return ActorCritic(FP.N_ACTIONS, FP.OBS_DIM,
                       generator=torch.Generator().manual_seed(seed)).to(dev)


def assert_obs_mask(got, want, what):
    (g_obs, g_mask), (w_obs, w_mask) = got, want
    assert g_obs.shape == w_obs.shape and g_mask.dtype == torch.bool, what
    assert torch.equal(g_mask, w_mask), what
    other = torch.arange(FP.OBS_DIM, device=g_obs.device) != LOG1P_ROW
    assert torch.equal(g_obs[:, other], w_obs[:, other]), what
    ulp = (g_obs[:, LOG1P_ROW].view(torch.int32) - w_obs[:, LOG1P_ROW].view(torch.int32)).abs()
    assert int(ulp.max()) <= 1, what


def assert_step_equal(got, want, what):
    for k in ("cards", "ints", "rng"):
        assert torch.equal(got[0][k], want[0][k]), f"{what}: {k}"
    assert torch.equal(got[1], want[1]), f"{what}: reward"
    assert torch.equal(got[2], want[2]), f"{what}: done"
    assert_obs_mask(got[3:], want[3:], what)


def _counts():
    return FP.observe_fused.launches, FP.step_fused.launches, FP.sample_fused.launches


@pytest.mark.parametrize("n", SIZES)
def test_kernels_equal_plain_along_a_collection(dev, n):
    """16 steps of a collection from the default reset: K3b once, then the
    sampler and K3a at every step, each against its plain version on the
    same inputs."""
    net = _policy(dev)
    packed = F.pack_full_state(F.default_reset(7, n, dev))
    n0 = _counts()
    obs, mask = FP.observe_fused(packed)
    assert_obs_mask((obs, mask), FP.observe_rows_reference(packed), "observe")
    for t, key in enumerate(FP.seed_key_rows(7, 16, dev)):
        with torch.no_grad():
            logits, _ = net(obs, mask)
        action, log_prob = FP.sample_fused(key, logits)
        a_ref, lp_ref = FP.sample(key, logits)
        assert torch.equal(action, a_ref), f"sample {t}"
        assert float((log_prob - lp_ref).abs().max()) <= 1e-6, f"sample {t}"
        out = FP.step_fused(packed, action)
        assert_step_equal(out, FP.step_rows_reference(packed, action), f"step {t}")
        packed, _, _, obs, mask = out
    torch.cuda.synchronize()
    assert _counts() == (n0[0] + 1, n0[1] + 16, n0[2] + 16)


@pytest.mark.parametrize("n", (1, 31, 33, 257, 1000, 8192, 8193))
def test_step_kernel_equals_plain_on_the_fed_battery(dev, n):
    """K3a along a 24-step coverage-biased legal script from a surgically
    diversified state: every action class, bosses, consumables, jokers; at
    env counts that leave K3a's last block partial too."""
    rng = np.random.default_rng(n)
    st = BAT.surgery(F.rollout_full_rows_reference(1, n, 4, device=dev)["state"], rng)
    packed, script = F.pack_full_state(st), []
    for t in range(24):
        a = BAT.sample_legal(F._legal_rows(F._load(packed)).T.cpu().numpy(), rng)
        script.append(a)
        a = torch.as_tensor(a, dtype=torch.int32, device=dev)
        out = FP.step_fused(packed, a)
        assert_step_equal(out, FP.step_rows_reference(packed, a), f"battery step {t}")
        packed = out[0]
    if n >= 1000:         # a narrower batch reaches not every class in 24 steps
        assert all(v > 0 for v in BAT.coverage(np.stack(script)).values())


def test_step_kernel_equals_plain_on_the_autoreset_batches(dev):
    """K3a with every env resetting (ante 101) and with none (the no-op
    action), the batches K3a's autoreset cost is timed on, against the plain
    step."""
    n = 8192
    packed = F.pack_full_state(F.default_reset(5, n, dev))
    for what, (p, a), ends in zip(("no_reset", "all_reset"), BAT.reset_batches(packed),
                                  (False, True)):
        out = FP.step_fused(p, a)
        assert_step_equal(out, FP.step_rows_reference(p, a), what)
        assert bool((out[2] == ends).all()), what


def test_step_kernel_shape(dev):
    """K3a runs the engine step's blocks of 64 envs and its shared memory
    (888 B a State slot, a class byte and two 2-byte places an env) with four
    threads an env, and each of its eight warps' 64 sort keys of 8 B; its
    stack no larger than the engine step's 160 B."""
    shape = FP.step_kernel_shape()
    assert shape["block"] == 4 * 64, shape
    assert shape["shared_bytes"] == 64 * (STATE_BYTES + 5) + 8 * 64 * 8, shape
    assert shape["stack_bytes"] <= 160, shape


def test_observe_kernel_shape(dev):
    """K3b runs kObserveGroups threads for each of a block's 32 envs, with
    the envs' 888 B States in shared memory, and no stack."""
    shape = FP.observe_kernel_shape()
    envs, groups = declared("kObserveEnvs"), declared("kObserveGroups")
    assert envs == 32 and shape["block"] == envs * groups, shape
    assert shape["shared_bytes"] == envs * STATE_BYTES, shape
    assert shape["stack_bytes"] == 0, shape


def test_sample_kernel_shape(dev):
    """The sampler runs kSampleGroups threads for each of a block's 32 envs,
    with the logits and the noise (60 x 33 floats each) and each thread's
    four partials in shared memory, and no stack."""
    shape = FP.sample_kernel_shape()
    envs, groups = declared("kSampleEnvs"), declared("kSampleGroups")
    assert envs == 32 and shape["block"] == envs * groups, shape
    assert shape["shared_bytes"] == 4 * (2 * FP.N_ACTIONS * (envs + 1) + 4 * groups * envs), shape
    assert shape["stack_bytes"] == 0, shape


@pytest.mark.parametrize("n", (1, 33, 257, 8192))
def test_observe_and_sampler_equal_plain(dev, n):
    """K3b on a diversified state and the sampler on a policy's logits of
    it, in both layouts, against their plain versions; every third env has
    no legal action (its logits all -1e9, so action 0 wins the tie)."""
    rng = np.random.default_rng(n)
    st = BAT.surgery(F.rollout_full_rows_reference(1, n, 4, device=dev)["state"], rng)
    packed = F.pack_full_state(st)
    n0 = _counts()
    obs, mask = FP.observe_fused(packed)
    assert_obs_mask((obs, mask), FP.observe_rows_reference(packed), "observe")
    mask = mask.clone()
    mask[::3] = False
    with torch.no_grad():
        logits, _ = _policy(dev)(obs, mask)
    for t, key in enumerate(FP.seed_key_rows(n, 4, dev)):
        want = FP.sample(key, logits)
        assert bool((want[0][::3] == 0).all())
        for layout in (logits.T.contiguous().T, logits.contiguous()):
            action, log_prob = FP.sample_fused(key, layout)
            assert torch.equal(action, want[0]), f"sample {t}, strides {layout.stride()}"
            assert float((log_prob - want[1]).abs().max()) <= 1e-6, f"sample {t}"
    torch.cuda.synchronize()
    assert _counts() == (n0[0] + 1, n0[1], n0[2] + 8)


def test_collection_equals_plain_and_replays_through_k2(dev):
    """The kernel collection equals the plain one bit for bit, and its
    recorded actions replayed through the whole-rollout kernel give the
    same rewards, dones and final state."""
    n, steps = 2048, 12
    net = _policy(dev)
    st = F.default_reset(3, n, dev)
    n0 = _counts()
    final, traj = FP.collect_policy_fused(net, st, 11, steps)
    assert _counts() == (n0[0] + 1, n0[1] + steps, n0[2] + steps)
    ref_final, ref = FP.collect_policy_reference(net, st, 11, steps)
    for k in ("action", "value", "reward", "done"):
        assert torch.equal(traj[k], ref[k]), k
    assert float((traj["log_prob"] - ref["log_prob"]).abs().max()) <= 1e-6
    assert F.states_equal(final, ref_final) == []
    packed = F.pack_full_state(st)
    for t in range(steps):
        packed, reward, done = F._kernel_packed(packed, traj["action"][t][None].contiguous(), 0, 1)
        assert torch.equal(reward, traj["reward"][t]) and torch.equal(done.bool(), traj["done"][t])
    assert F.states_equal(F.unpack_full_state(packed), final) == []


def test_entry_points_default_to_the_card(dev):
    """No device: host inputs go to the card and the kernels launch."""
    packed = F.pack_full_state(F.default_reset(2, 300, "cpu"))
    n0 = _counts()
    obs, mask = FP.observe_fused(packed)
    assert obs.device == dev and mask.device == dev
    out = FP.step_fused(packed, np.full(300, 45, np.int32))
    assert out[0]["ints"].device == dev
    action, _ = FP.sample_fused(FP.seed_key_rows(9, 1, dev)[0], torch.zeros(300, FP.N_ACTIONS))
    assert action.device == dev
    assert _counts() == (n0[0] + 1, n0[1] + 1, n0[2] + 1)
    final, traj = FP.collect_policy_fused(_policy(dev), F.default_reset(2, 300, "cpu"), 0, 2)
    assert final.ante.device == dev and traj["action"].device == dev
    assert F.default_reset(2, 4).ante.device == dev
    assert F.rollout_full_fused(0, 4, 1)["state"].ante.device == dev


def test_bad_inputs_raise(dev):
    packed = F.pack_full_state(F.default_reset(2, 8, dev))
    with pytest.raises(ValueError):
        FP.observe_fused(packed, device="cpu")             # card data never to the host
    with pytest.raises(ValueError):
        FP.step_fused(packed, torch.zeros(9, dtype=torch.int32, device=dev))
    row = FP.seed_key_rows(1, 1, dev)[0]
    with pytest.raises(ValueError):
        FP.sample_fused(row, torch.zeros(8, FP.N_ACTIONS - 1, device=dev))
    with pytest.raises(ValueError):
        FP.sample_fused((0, 1), torch.zeros(8, FP.N_ACTIONS, device=dev))  # the key as ints
    with pytest.raises(ValueError):
        FP.sample_fused(row.cpu(), torch.zeros(8, FP.N_ACTIONS, device=dev))  # a host row
    with pytest.raises(ValueError):
        FP.collect_policy_fused(_policy(dev).cpu(), F.default_reset(2, 8, dev), 0, 1)
