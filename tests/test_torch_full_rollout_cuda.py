"""The CUDA kernel of the port's flagship-env rollout against its plain
version.

These tests need a card and skip where torch sees none. The machine with
the card has no JAX, and tests/conftest.py imports it, so this file imports
torch and the port only and runs there with

    python -m pytest --noconftest -m cuda tests/test_torch_full_rollout_cuda.py

Tolerance: none. The kernel and the plain version (on the same card, same
inputs) agree on every packed state row, reward and episode count bit for
bit, fed and sampled, for ragged env counts.
"""
import numpy as np
import pytest
import torch

from balatro_gym_tpu_torch.ops import fused_full_battery as BAT
from balatro_gym_tpu_torch.ops import fused_full_rollout as F

pytestmark = pytest.mark.cuda

SIZES = (1, 31, 33, 257, 1000, 1025, 8192)
STEPS = (0, 1, 64)


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (torch.cuda.is_available() is False)")
    return torch.device("cuda", torch.cuda.current_device())


def _assert_equal(k, p, what):
    assert F.states_equal(k["state"], p["state"]) == [], what
    assert torch.equal(k["total_reward"], p["total_reward"]), what
    assert torch.equal(k["episodes"], p["episodes"]), what


def _both(dev, seed, n, steps, **kw):
    n0 = F.rollout_full_fused.launches
    k = F.rollout_full_fused(seed, n, steps, device=dev, **kw)
    torch.cuda.synchronize()
    assert F.rollout_full_fused.launches == n0 + 1
    return k, F.rollout_full_rows_reference(seed, n, steps, device=dev, **kw)


@pytest.fixture(scope="module")
def battery(dev):
    """Per size: a surgically diversified start state and a 64-step
    coverage-biased legal script, made by stepping the plain version."""
    out = {}
    for n in SIZES:
        rng = np.random.default_rng(n)
        st = BAT.surgery(F.rollout_full_rows_reference(1, n, 4, device=dev)["state"], rng)
        s, script = st, []
        for _ in range(max(STEPS)):
            a = BAT.sample_legal(F.legal_mask(s).cpu().numpy(), rng)
            script.append(a)
            s = F.rollout_full_rows_reference(0, n, 1, actions=a[None], init_state=s)["state"]
        out[n] = (st, torch.as_tensor(np.stack(script), device=dev))
    return out


@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("steps", STEPS)
def test_sampled_kernel_equals_plain(dev, n, steps):
    k, p = _both(dev, 11, n, steps)
    _assert_equal(k, p, f"sampled {n}x{steps}")


@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("steps", STEPS)
def test_fed_kernel_equals_plain(dev, battery, n, steps):
    st, script = battery[n]
    k, p = _both(dev, 0, n, steps, actions=script[:steps], init_state=st)
    _assert_equal(k, p, f"fed {n}x{steps}")


def test_fed_battery_covers_every_action_class(battery):
    cov = BAT.coverage(battery[8192][1].cpu().numpy())
    assert all(v > 0 for v in cov.values()), cov


def test_rollout_kernel_shape(dev):
    """K2 runs 64 threads a block with at least 16 blocks an SM, so it has
    at most 64 registers a thread, and each env's 888 B State in local
    memory (no shared memory)."""
    shape = F.rollout_kernel_shape()
    assert shape["block"] == 64 and shape["shared_bytes"] == 0, shape
    assert 0 < shape["registers"] <= 64 and 888 <= shape["stack_bytes"] < 1960, shape


def test_game_over_lane_autoresets(dev):
    """Select a blind, select a card, then play the last hand against an
    unreachable blind: the episode ends and the env starts afresh."""
    st = F.rollout_full_rows_reference(2, 4, 2, actions=[45, 2], device=dev)["state"]
    st.hands_left[:] = 1
    st.chips_needed[:] = 10 ** 9
    k, p = _both(dev, 0, 4, 1, actions=[0], init_state=st)
    _assert_equal(k, p, "game over")
    assert k["episodes"].tolist() == [1, 1, 1, 1]
    s = k["state"]
    assert (s.phase == 2).all() and (s.ante == 1).all() and (s.step_count == 0).all()
    assert (s.card_alive[:, :52]).all() and not s.done.any()


def test_card_inputs_reach_the_kernel(dev):
    st = F.default_reset(4, 300, dev)
    n0 = F.rollout_full_fused.launches
    out = F.rollout_full_fused(4, 300, 3, init_state=st)         # device=None
    assert F.rollout_full_fused.launches == n0 + 1
    assert out["state"].ante.device == st.ante.device
    acts = torch.full((2, 300), 45, dtype=torch.int32, device=dev)
    F.rollout_full_fused(4, 300, 2, actions=acts)
    assert F.rollout_full_fused.launches == n0 + 2


def test_bad_inputs_raise(dev):
    st = F.default_reset(4, 8, dev)
    with pytest.raises(ValueError):
        F.rollout_full_fused(0, 8, 2, init_state=st, device="cpu")
    with pytest.raises(ValueError):
        F.rollout_full_fused(0, 8, 2, actions=torch.zeros(3, 8, device=dev), init_state=st)
    with pytest.raises(ValueError):
        F.rollout_full_fused(0, 9, 2, init_state=st)
    packed = F.pack_full_state(st)
    with pytest.raises(ValueError):
        F._kernel_packed({**packed, "ints": packed["ints"].T.contiguous().T}, None, 0, 1)
    with pytest.raises(ValueError):
        F._kernel_packed({**packed, "rng": packed["rng"].long()}, None, 0, 1)
