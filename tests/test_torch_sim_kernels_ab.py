"""The host side of ``ops/sim_kernels_ab.py``, the card tool that compares
builds of the sim rollout kernel (K4) and the hand histograms (K5), on the
CPU: its inputs reach the paths they are meant to, and the plain versions
it holds each build against run on them."""
import numpy as np
import pytest
import torch

from balatro_gym_tpu_torch.ops import fused_rollout as FR
from balatro_gym_tpu_torch.ops import hand_histograms as HH
from balatro_gym_tpu_torch.ops import sim_kernels_ab as AB


def test_mixed_jokers_reach_every_coefficient_path():
    """The 257-env check batch holds Four Fingers, Shortcut, Misprint and
    Bloodstone envs beside envs without them."""
    jok = AB.mixed_jokers(257)
    assert jok.shape == (257, 5)
    scal = FR.joker_coefficients(jok, 257)[0]
    for row in (FR.S_FF, FR.S_SHORTCUT, FR.S_MISPRINT, FR.S_BLOOD):
        assert 0 < int((scal[row] > 0).sum()) < 257
    assert np.array_equal(jok, AB.mixed_jokers(257))                  # seeded


def test_hist_inputs_hold_cards_outside_every_bin():
    ranks, suits, mask = AB.hist_inputs(512, torch.device("cpu"))
    assert ranks.dtype == suits.dtype == torch.int32 and mask.dtype == torch.bool
    assert bool(((ranks < 0) | (ranks > 15)).any()) and bool(((suits < 0) | (suits > 7)).any())
    rh, sh, chips = HH.hand_histograms_reference(ranks, suits, mask)
    assert float(rh.sum()) < float(mask.sum())                        # some cards in no bin
    assert torch.equal(AB.hist_inputs(512, torch.device("cpu"))[0], ranks)


def test_needs_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="no CUDA card"):
        AB.main(["tree=balatro_gym_tpu_torch/csrc"])
