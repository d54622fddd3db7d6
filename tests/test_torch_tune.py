"""The port's hyperparameter search (``train/tune.py``) against the
reference's, on the CPU: the same search space and trial parameters, and a
2-trial x 1-update random search at 16 envs (Optuna is not installed, so
the reference's fallback is what runs)."""
import json
import random

import pytest
import torch

from balatro_gym_tpu.train import tune as JT
from balatro_gym_tpu_torch.train import tune as TT


def test_search_space_is_the_reference():
    assert TT.SEARCH_SPACE == JT.SEARCH_SPACE


@pytest.mark.parametrize("seed", [0, 1, 12345])
def test_trial_params_are_the_reference(seed):
    a, b = random.Random(seed), random.Random(seed)
    for _ in range(5):
        assert TT._sample(a) == JT._sample(b)


def test_random_search_runs(capsys):
    out = TT.main(["--trials", "2", "--updates", "1", "--n-envs", "16", "--env", "sim",
                   "--device", "cpu"])
    line, = capsys.readouterr().out.strip().splitlines()
    assert json.loads(line) == out
    assert out["backend"] == "random-search" and out["trials"] == 2
    rng = random.Random(0)
    assert out["best_params"] in [TT._sample(rng) for _ in range(2)]
    assert isinstance(out["best_value"], float)


def test_no_device_means_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        TT.tune(1, updates=1, n_envs=4)
