"""The host side of ``ops/policy_kernels_ab.py``, the card tool that compares
builds of the policy-collection kernels, on the CPU: its inputs, and the
contract by which it holds each build's outputs against the plain versions
(K3b bit for bit but the log1p row within 1 ulp, the sampler's actions bit
for bit and log-probs within 1e-6, K3a bit for bit but that row, the
engine's reset bit for bit)."""
import pytest
import torch

from balatro_gym_tpu_torch.ops import fused_full_battery as BAT
from balatro_gym_tpu_torch.ops import fused_full_rollout as FF
from balatro_gym_tpu_torch.ops import fused_policy_rollout as FP
from balatro_gym_tpu_torch.ops import policy_kernels_ab as AB

N = 40


@pytest.fixture(scope="module")
def plain():
    """The tool's inputs at N envs and the plain version's outputs (one
    intra-op thread, so parallel test workers do not oversubscribe)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    inp = AB.inputs(N, "cpu")
    out = {("observe", "mid"): FP.observe_rows_reference(inp["packed"])}
    for name, logits in inp["logits"].items():
        out["sample", name] = FP.sample(inp["key"], logits)
    for name, (p, a) in inp["step"].items():
        out["step", name] = FP.step_rows_reference(p, a)
    for name, (p, m, keys) in inp["reset"].items():
        out["reset", name] = FP.env_reset_rows_reference(p, m, keys)
    torch.set_num_threads(threads)
    return inp, out


def test_inputs(plain):
    """Mid-game envs, logits in both layouts and the trainer's, and the
    three K3a batches (the autoreset ones end every env, or none)."""
    inp, out = plain
    logits = inp["logits"]
    assert logits["policy"].stride() == (1, N) and logits["row_major"].stride() == (60, 1)
    assert torch.equal(logits["policy"], logits["row_major"])
    assert logits["trainer"].shape == (N, 60) and logits["trainer"].dtype == torch.float32
    assert bool((FF._load(inp["packed"])["phase"] == 0).any())             # some envs in play
    assert not bool(out["step", "no_reset"][2].any()) and bool(out["step", "all_reset"][2].all())
    (p, sparse, none), (zeros, every, keys) = inp["reset"]["autoreset"], inp["reset"]["fresh"]
    assert p is inp["packed"] and none is None and sparse.tolist() == [i % 63 == 5 for i in range(N)]
    assert bool(every.all()) and keys.shape == (N, 2) and not any(bool(v.any()) for v in zeros.values())
    fresh = out["reset", "fresh"]
    assert bool((fresh["ints"][FF.S_STEPC] == 0).all()) and not torch.equal(fresh["cards"],
                                                                          zeros["cards"])


@pytest.mark.parametrize("kernel,name", [("observe", "mid"), ("sample", "policy"),
                                         ("step", "mid"), ("reset", "autoreset"),
                                         ("reset", "fresh")])
def test_agrees_holds_the_contract(plain, kernel, name):
    """The plain outputs agree with themselves; one entry off (a log-prob by
    2e-6, any other entry by one) does not, but the log1p row by 1 ulp."""
    want = plain[1][kernel, name]
    assert AB.agrees(kernel, want, want)
    if kernel == "sample":
        assert AB.agrees(kernel, want, (want[0], want[1] + 5e-7))
        bad = [(want[0] + 1, want[1]), (want[0], want[1] + 2e-6)]
    elif kernel == "reset":
        bad = []
        for k in want:
            off = {j: v.clone() for j, v in want.items()}
            off[k].view(-1)[-1] += 1
            bad.append(off)
    else:
        obs = 0 if kernel == "observe" else 3
        ulp = [w.clone() if torch.is_tensor(w) else w for w in want]
        ulp[obs][:, AB.LOG1P_ROW] = torch.nextafter(ulp[obs][:, AB.LOG1P_ROW],
                                                    torch.tensor(2.0))
        assert AB.agrees(kernel, ulp, want)
        off = [w.clone() if torch.is_tensor(w) else w for w in want]
        off[obs][0, 0] += 1
        bad = [off]
    for got in bad:
        assert not AB.agrees(kernel, got, want)


def test_summary():
    s = AB.summary([4.0, 1.0, 3.0, 2.0, 5.0])
    assert (s["median_us"], s["iqr_us"]) == (3.0, 3.0)
    assert s["samples_us"] == [4.0, 1.0, 3.0, 2.0, 5.0]


def test_step_mix(plain):
    """Each K3a input's mix: group shares summing to 1, by the battery's
    branch classes; the no-autoreset input resets no env, the all-autoreset
    one every env, each of them idle (over), so in the group of the rest."""
    inp, out = plain
    mix = {name: AB.step_mix(p, a) for name, (p, a) in inp["step"].items()}
    for name, m in mix.items():
        assert set(m) == {*AB.GROUPS, "reset"}, name
        assert abs(sum(m[g] for g in AB.GROUPS) - 1) < 1e-12, name
        assert m["reset"] == float(out["step", name][2].double().mean()), name
    assert mix["no_reset"]["reset"] == 0 and mix["all_reset"]["reset"] == 1
    assert mix["all_reset"]["rest"] == 1
    p, a = inp["step"]["mid"]
    hist = BAT.class_histogram(p, a)
    assert mix["mid"]["play"] == hist.get("play", 0) / N
    assert mix["mid"]["shop_gen"] == (hist.get("reroll", 0) + hist.get("skip", 0)) / N
