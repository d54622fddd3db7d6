"""The port's sim rollout (``ops/fused_rollout.py:rollout_fused``, its plain
version on the CPU) against the benchmark's frozen reference
(``benchmark/reference/sim_rollout.py``), bit for bit at 64 envs x 16
steps: the final hands, counters, episode counts and reward totals, for the
benchmark configuration's jokers, a set with Misprint and Bloodstone, jokers
that differ env by env and fed actions; and a sample of env indices,
computed alone by the reference, against the same indices of the port's
whole batch."""
import json
from pathlib import Path

import pytest
import torch

from balatro_gym_tpu_torch.ops import fused_rollout as FR
from benchmark.reference import sim_rollout as RS

ROOT = Path(__file__).resolve().parents[1]
B, T = 64, 16
SEED = 3_000_000_019
CONFIG_JOKERS = tuple(json.loads((ROOT / "benchmark/configs/sim-random.json")
                                 .read_text())["jokers"])
COUNTERS = ("deck_n", "money", "hands_left", "discards_left", "score")


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def per_env_jokers():
    g = torch.Generator().manual_seed(11)
    jok = torch.randint(0, 151, (B, 5), generator=g)
    jok[::4] = torch.tensor([27, 117, 18, 69, 147])    # Misprint, Bloodstone, Four Fingers,
    return jok                                          # Shortcut, Triboulet


def fed_actions():
    """Legal scripts: a discard at every fourth step, a play otherwise. An
    episode ends by its fourth play, so it sees at most two of its three
    discards."""
    g = torch.Generator().manual_seed(5)
    plays = torch.randint(0, 5, (T, B), generator=g)
    discards = torch.randint(5, 10, (T, B), generator=g)
    at = (torch.arange(T) % 4 == 1)[:, None]
    return torch.where(at, discards, plays).to(torch.int32)


def seeds(n, seed=SEED):
    return torch.full((n,), seed & 0xFFFFFFFF)


def port_rows(out, idx=None):
    idx = torch.arange(out["episodes"].shape[0]) if idx is None else idx
    return ({"rank": out["hand_rank"][idx].T, "suit": out["hand_suit"][idx].T,
             "counters": torch.stack([out[k][idx] for k in COUNTERS])},
            out["episodes"][idx], out["total_reward"][idx])


def sampled(jokers):
    out = FR.rollout_fused(SEED, B, T, jokers, device="cpu")
    jok = jokers if torch.is_tensor(jokers) else torch.tensor(jokers)
    return out, RS.sampled_rollout(seeds(B), torch.arange(B), T, jok), None


def fed():
    # Misprint and Bloodstone do not fire in fed mode, in both
    acts, jok = fed_actions(), (27, 117, 31, 72, 0)
    out = FR.rollout_fused(SEED, B, T, jok, actions=acts, device="cpu")
    return out, RS.sampled_rollout(seeds(B), torch.arange(B), T, torch.tensor(jok),
                                   actions=acts), None


def sample_alone():
    idx = torch.tensor([0, 5, 17, 31, 32, 50, 63])
    out = FR.rollout_fused(SEED, B, T, CONFIG_JOKERS, device="cpu")
    return out, RS.sampled_rollout(seeds(len(idx)), idx, T, torch.tensor(CONFIG_JOKERS)), idx


CASES = {
    "config-jokers": lambda: sampled(CONFIG_JOKERS),
    "misprint-bloodstone": lambda: sampled((27, 117, 1, 72, 0)),
    "per-env-jokers": lambda: sampled(per_env_jokers()),
    "fed-actions": fed,
    "sample-alone": sample_alone,
}


@pytest.mark.parametrize("case", list(CASES))
def test_port_equals_reference(case):
    out, ref, idx = CASES[case]()
    rows, epi, tot = port_rows(out, idx)
    for k, v in ref["rows"].items():
        assert torch.equal(rows[k], v), k
    assert torch.equal(epi, ref["episodes"])
    assert torch.equal(tot, ref["total_reward"])         # bit for bit, float32
    assert int(ref["episodes"].sum()) > 0                 # autoreset was reached


def test_sample_mixes_calls():
    """A sample of envs from two calls' seeds, as the benchmark's check
    draws it, run as one batch."""
    a = FR.rollout_fused(SEED + 1, B, T, CONFIG_JOKERS, device="cpu")
    b = FR.rollout_fused(SEED + 2, B, T, CONFIG_JOKERS, device="cpu")
    mixed = RS.sampled_rollout(torch.tensor([SEED + 1, SEED + 2, SEED + 1]),
                               torch.tensor([5, 5, 63]), T, torch.tensor(CONFIG_JOKERS))
    want = torch.stack([a["total_reward"][5], b["total_reward"][5], a["total_reward"][63]])
    assert torch.equal(mixed["total_reward"], want)


def test_bf16_sum_departs():
    """The control: reward totals summed in bfloat16 differ from the port's."""
    out = FR.rollout_fused(SEED, B, T, CONFIG_JOKERS, device="cpu")
    ref = RS.sampled_rollout(seeds(B), torch.arange(B), T, torch.tensor(CONFIG_JOKERS),
                             reward_dtype=torch.bfloat16)
    assert float((out["total_reward"] - ref["total_reward"]).abs().max()) > 0
