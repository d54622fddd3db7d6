"""The CUDA kernel of the port's fused sim rollout against its plain version.

These tests need a card and skip where torch sees none. The machine with
the card has no JAX, and tests/conftest.py imports it, so this file imports
torch and the port only and runs there with

    python -m pytest --noconftest -m cuda tests/test_torch_fused_rollout_cuda.py

Tolerance: none. The kernel and the plain version (on the same card, same
inputs) agree on every output bit for bit, in fed and sampled mode, for
ragged env counts (1, 257, 2048 + 37 and 131072 + 37 envs). The launch
shape is the one the kernel was designed for: 1,024 threads an SM.
"""
import numpy as np
import pytest
import torch

from balatro_gym_tpu_torch.engine import sim_env
from balatro_gym_tpu_torch.ops import fused_rollout as FR
from balatro_gym_tpu_torch.ops import kernel_rng as KR

pytestmark = pytest.mark.cuda

JOKER_SETS = np.asarray((
    (0, 0, 0, 0, 0), (1, 31, 34, 48, 72), (6, 7, 131, 135, 0),
    (18, 69, 16, 23, 108), (116, 118, 119, 2, 3), (147, 140, 128, 122, 61),
    (27, 117, 34, 16, 0), (117, 117, 147, 18, 69),
), np.int32)
N = 2048 + 37      # not a multiple of the block: the last block is ragged
STEPS = 48


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (torch.cuda.is_available() is False)")
    return torch.device("cuda", torch.cuda.current_device())


def _both(dev, seed, n, steps, jok, actions=None):
    n0 = FR.rollout_fused.launches
    k = FR.rollout_fused(seed, n, steps, jok, actions=actions, device=dev)
    torch.cuda.synchronize()
    assert FR.rollout_fused.launches == n0 + 1
    p = FR.rollout_fused_reference(seed, n, steps, jok, actions=actions, device=dev)
    return k, p


def _assert_equal(k, p):
    for f in k:
        assert torch.equal(k[f], p[f]), f


def _legal_script(dev, jok, n, steps, seed):
    """Mask-legal actions, drawn with numpy against the torch sim engine."""
    rng = np.random.default_rng(seed)
    k1, k2 = KR.seed_key(seed, device=dev)
    st = sim_env.reset(torch.stack(KR.split_child(k1, k2, torch.arange(n, device=dev)), -1),
                       torch.as_tensor(jok, device=dev))
    acts = np.zeros((steps, n), np.int32)
    for t in range(steps):
        cum = np.cumsum(sim_env.action_mask(st).cpu().numpy(), axis=1)
        acts[t] = np.argmax(cum > rng.random((n, 1)) * cum[:, -1:], axis=1)
        st, _, _ = sim_env.step_autoreset(st, torch.as_tensor(acts[t], device=dev))
    return acts


@pytest.mark.parametrize("seed", [0, 77])
def test_fed_kernel_equals_plain(dev, seed):
    jok = JOKER_SETS[:6][np.random.default_rng(seed).integers(0, 6, N)]
    acts = _legal_script(dev, jok, N, STEPS, seed)
    _assert_equal(*_both(dev, seed, N, STEPS, jok, acts))


def test_fed_illegal_script_stays_defined(dev):
    """Discards past the limit run the deck dry; the clamped deck slot keeps
    both versions on valid cards, and equal."""
    rng = np.random.default_rng(5)
    jok = JOKER_SETS[rng.integers(0, len(JOKER_SETS), N)]
    acts = rng.integers(0, 10, (STEPS, N)).astype(np.int32)
    k, p = _both(dev, 5, N, STEPS, jok, acts)
    _assert_equal(k, p)
    assert int(k["hand_rank"].min()) >= 2 and int(k["deck_n"].min()) < 0


@pytest.mark.parametrize("jokers", ["bench", "random", "mixed"])
def test_sampled_kernel_equals_plain(dev, jokers):
    rng = np.random.default_rng(1)
    jok = {"bench": np.asarray((1, 31, 34, 48, 72)),
           "random": np.asarray((27, 117, 34, 16, 0)),
           "mixed": np.concatenate([JOKER_SETS[np.arange(N // 2) % len(JOKER_SETS)],
                                    rng.integers(0, 151, (N - N // 2, 5))])}[jokers]
    k, p = _both(dev, 3, N, STEPS, jok)
    _assert_equal(k, p)
    assert int(k["episodes"].sum()) > 0


def test_launch_shape(dev):
    """K4's launch shape: 128-thread blocks, at least 8 an SM (so at most 64
    registers and no stack), each env's 45-word table column, the 45 deck
    windows and the two power tables in static shared memory."""
    shape = FR.rollout_kernel_shape()
    assert shape["block"] == 128 and shape["registers"] <= 64 and shape["stack_bytes"] == 0
    assert shape["shared_bytes"] == 45 * 128 * 4 + 45 * 8 + (13 + 21) * 4


@pytest.mark.parametrize("n", [1, 257, 131072 + 37])
def test_sampled_kernel_equals_plain_at_sizes(dev, n):
    """One env, a partial second block, and the bench shape's 131072 envs
    plus a partial block: 32 sampled steps, mixed jokers below 131072."""
    rng = np.random.default_rng(n)
    jok = (np.asarray((1, 31, 34, 48, 72)) if n > 131072 else
           JOKER_SETS[rng.integers(0, len(JOKER_SETS), n)])
    _assert_equal(*_both(dev, n, n, 32, jok))


def test_one_env_and_zero_steps(dev):
    _assert_equal(*_both(dev, 9, 1, 5, (27, 117, 0, 0, 0)))
    k, p = _both(dev, 9, 130, 0, (1, 0, 0, 0, 0))
    _assert_equal(k, p)
    assert int(k["deck_n"].min()) == 44


@pytest.mark.parametrize("fed", [False, True])
def test_card_inputs_reach_the_kernel_without_a_device(dev, fed):
    """Jokers (and actions) on the card, ``device`` left out: the call runs
    the kernel on that card, and a host ``device`` that disagrees raises."""
    jok = torch.as_tensor(JOKER_SETS[np.arange(N) % 6], device=dev)
    acts = (torch.as_tensor(_legal_script(dev, jok.cpu().numpy(), N, 8, 2), device=dev)
            if fed else None)
    n0 = FR.rollout_fused.launches
    k = FR.rollout_fused(2, N, 8, jok, actions=acts)
    torch.cuda.synchronize()
    assert FR.rollout_fused.launches == n0 + 1 and k["score"].device == dev
    _assert_equal(k, FR.rollout_fused_reference(2, N, 8, jok, actions=acts))
    with pytest.raises(ValueError):
        FR.rollout_fused(2, N, 8, jok, actions=acts, device="cpu")


def test_kernel_rejects_bad_inputs(dev):
    coef = FR.joker_coefficients((1, 0, 0, 0, 0), 64, device=dev)
    with pytest.raises(ValueError):       # non-contiguous coefficient rows
        FR._kernel_rows((coef[0].T.contiguous().T,) + coef[1:], 0, None, 4)
    with pytest.raises(ValueError):       # wrong action dtype
        FR._kernel_rows(coef, 0, torch.zeros(4, 64, dtype=torch.int64, device=dev), 4)
    with pytest.raises(ValueError):       # rows on the host
        FR._kernel_rows(tuple(c.cpu() for c in coef), 0, None, 4)
