"""The port's tracer (``utils/profiling.py``) on the CPU, at 16 envs x 4
steps: what it records when off and on, the span tree of a PPO update and
of a K2 call, its Chrome-trace export on the profiler's clock, and the
benchmark's gap labeller naming a program span."""
import collections
import copy
import json
import time

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from balatro_gym_tpu_torch.ops import fused_full_rollout as FF
from balatro_gym_tpu_torch.train import cli as TCLI
from balatro_gym_tpu_torch.train import ppo as TP
from balatro_gym_tpu_torch.utils import profiling as P
from benchmark.harness import trace as BT

T_STEPS, N_ENVS = 4, 16
STAGES = ["ppo.collect", "ppo.stats", "ppo.gae", "ppo.sgd"]
STEP_SPANS = ["ppo.collect.policy", "ppo.collect.sample", "ppo.collect.env",
              "ppo.collect.store"]


def learner(fused: bool):
    cfg = TP.PPOConfig(n_envs=N_ENVS, rollout_len=T_STEPS, epochs=1, minibatches=2,
                       hidden=(32,), fused_rollout=fused, env_shuffle=True)
    init_fn, update_fn, _ = TP.make_ppo(TP.full_env_hooks(), cfg, device="cpu")
    return init_fn([0, 11]), update_fn


@pytest.fixture(autouse=True)
def fresh_tracer():
    P.reset()
    yield
    P.reset()


def flat(ts, metrics):
    stats = [getattr(s, k) for s in (ts.obs_stats, ts.ret_stats)
             for k in ("mean", "var", "count")]
    return ([p.detach() for p in TP.param_list(ts.params)] + ts.opt_state.mu + ts.opt_state.nu
            + list(ts.env_states.values()) + [ts.ret_carry] + stats + list(metrics.values()))


def test_off_records_nothing_and_changes_no_bit():
    ts, update_fn = learner(fused=True)
    ts_on = copy.deepcopy(ts)
    off = update_fn(ts)
    assert P.spans() == [] and P.TRACER.dropped == 0
    rec = {}
    on = update_fn(ts_on, record=rec)
    assert P.spans() and rec["events"] == []            # no card: no CUDA events
    for a, b in zip(flat(*off), flat(*on), strict=True):
        assert torch.equal(a, b)
    assert P.span("x") is P.span("y")                   # off again: the shared no-op


@pytest.mark.parametrize("fused", [True, False], ids=["fused", "generic"])
def test_update_span_tree(fused):
    ts, update_fn = learner(fused)
    update_fn(ts, record={})
    spans = P.spans()
    by_id = {s["id"]: s for s in spans}
    root = spans[0]
    assert root["name"] == "ppo.update" and root["parent"] == 0
    assert {s["root"] for s in spans} == {root["id"]}
    for s in spans[1:]:                                  # each inside its parent
        up = by_id[s["parent"]]
        assert up["start_ns"] <= s["start_ns"] <= s["end_ns"] <= up["end_ns"]
    assert [s["name"] for s in spans if s["parent"] == root["id"]] == STAGES
    stages = [s for s in spans if s["parent"] == root["id"]]
    assert all(a["end_ns"] <= b["start_ns"] for a, b in zip(stages, stages[1:]))
    n = collections.Counter(s["name"] for s in spans)
    assert all(n[name] == T_STEPS for name in STEP_SPANS)
    assert n["ppo.collect.observe"] == (1 if fused else T_STEPS + 1)
    assert n["ppo.sgd.loss"] == n["ppo.sgd.backward"] == n["ppo.sgd.adam"] == 2
    assert all(s["profiled"] is False and s["syncs"] is None for s in spans)
    tree, = P.trees("ppo.update")
    assert tree["span"] == root and tree["syncs"] is None
    assert tree["host_ms"]["ppo.update"] >= tree["host_ms"]["ppo.collect"] > 0


def test_generic_path_packs_three_times_a_step():
    ts, update_fn = learner(fused=False)
    update_fn(ts, record={})
    n = collections.Counter(s["name"] for s in P.spans())
    # a step: observe and mask (one pack each), then step_autoreset's pack
    # and unpack; after the last step the observation and mask once more
    assert n["engine.pack"] == n["pack.scalars"] == 3 * T_STEPS + 2
    assert n["engine.unpack"] == n["unpack.rows"] == n["unpack.scalars"] == T_STEPS
    assert n["sample.bits"] == n["sample.draw"] == T_STEPS
    assert n["engine.observe"] == 2 * T_STEPS + 2 and n["engine.step_autoreset"] == T_STEPS
    s = P.summary()
    assert s["engine.pack"]["count"] == 3 * T_STEPS + 2
    assert s["ppo.update"]["self_ms"] < s["ppo.update"]["total_ms"]


def test_rollout_call_spans_under_a_profile():
    FF.rollout_full_fused(3, 8, 2, device="cpu")
    assert P.spans() == []                               # no profile, not enabled
    with profile(activities=[ProfilerActivity.CPU]):
        FF.rollout_full_fused(3, 8, 2, device="cpu")
    spans = P.spans()
    assert [s["name"] for s in spans] == [
        "rollout.call", "rollout.reset", "engine.reset", "rollout.pack", "pack.scalars",
        "rollout.launch", "rollout.unpack", "unpack.rows", "unpack.scalars"]
    assert all(s["profiled"] for s in spans)
    call, = P.trees("rollout.call")
    assert set(call["host_ms"]) == {s["name"] for s in spans}


def test_export_is_on_the_profilers_clock(tmp_path):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with P.span("outer"):
            with P.span("inner"):
                torch.ones(64).sum()
    prof.export_chrome_trace(str(tmp_path / "prof.json"))
    got = json.loads((tmp_path / "prof.json").read_text())
    base = got["baseTimeNanoseconds"]
    mine = json.loads(P.export(tmp_path / "spans.json", base_ns=base).read_text())
    assert mine["baseTimeNanoseconds"] == base
    theirs = {e["name"]: e for e in got["traceEvents"] if e.get("name") in ("outer", "inner")}
    for e in mine["traceEvents"]:
        assert e["ph"] == "X" and e["cat"] == "program_span"
        p = theirs[e["name"]]                            # the same span, as the profiler saw it
        assert abs(e["ts"] - p["ts"]) < 50 and abs(e["ts"] + e["dur"] - p["ts"] - p["dur"]) < 50
    own = json.loads(P.export(tmp_path / "own.json").read_text())
    now = time.time_ns()
    for e in own["traceEvents"]:                         # base + ts: the Unix clock
        assert 0 < now - (own["baseTimeNanoseconds"] + e["ts"] * 1e3) < 60e9


def test_gap_inside_a_span_takes_its_name(monkeypatch):
    """A host gap planted inside ``ppo.collect.policy`` (the card idle while
    the host computes in Python), between two device events added to a
    CPU-traced profile, is labelled with that span by the benchmark's
    ``reduce``."""
    ts, update_fn = learner(fused=True)
    planted = []
    normalize = TP.normalize

    def slow(stats, obs):
        if not planted:
            t0 = time.time_ns()
            while time.time_ns() - t0 < 20e6:
                pass
            planted.append((t0, time.time_ns()))
        return normalize(stats, obs)
    monkeypatch.setattr(TP, "normalize", slow)
    with BT.profiled(lambda: None, cpu=True) as got:
        update_fn(ts)
    real = got["prof"]

    class WithKernels:
        """The profile, with the card busy everywhere but the planted gap."""

        def export_chrome_trace(self, path):
            real.export_chrome_trace(path)
            with open(path) as f:
                tr = json.load(f)
            base = tr["baseTimeNanoseconds"]
            win = next(e for e in tr["traceEvents"] if e.get("name") == BT.WINDOW)
            (g0, g1), = planted
            g0, g1 = (g0 - base) / 1e3, (g1 - base) / 1e3
            tr["traceEvents"] += [
                {"ph": "X", "cat": "kernel", "name": "k", "ts": win["ts"], "dur": g0 - win["ts"]},
                {"ph": "X", "cat": "kernel", "name": "k", "ts": g1,
                 "dur": win["ts"] + win["dur"] - g1}]
            with open(path, "w") as f:
                json.dump(tr, f)
    out = BT.reduce({"prof": WithKernels(), "window_s": got["window_s"]})
    label, seconds = out["idle_gaps"][0]
    assert label == "ppo.collect.policy" and 0.015 < seconds < 0.5


def test_cli_trace_writes_the_profile_and_the_spans(tmp_path):
    TCLI.main(["--env", "sim", "--updates", "5", "--n-envs", "16", "--rollout", "4",
               "--epochs", "1", "--minibatches", "2", "--hidden", "16", "--device", "cpu",
               "--log-every", "0", "--summary", "", "--trace", str(tmp_path / "tr")])
    got = json.loads((tmp_path / "tr" / "spans.json").read_text())
    spans = got["by_name"]
    assert got["dropped"] == 0
    assert spans["ppo.update"]["count"] == 3                # updates 2-4
    assert spans["ppo.collect.policy"]["count"] == 3 * 4
    assert set(spans["ppo.sgd"]) == {"count", "total_ms", "self_ms", "syncs"}
    names = {e.get("name") for e in
             json.loads((tmp_path / "tr" / "trace.json").read_text())["traceEvents"]}
    assert {"ppo.update", "ppo.collect.env", "ppo.sgd.adam"} <= names
    assert P.span("z") is P.span("w")                     # the profile has ended: off


def test_full_store_drops_the_oldest_and_counts_them():
    tr = P.Tracer(capacity=3)
    tr.enable()
    for i in range(5):
        with tr.span(f"s{i}"):
            pass
    tr.disable()
    assert [s["name"] for s in tr.spans()] == ["s2", "s3", "s4"] and tr.dropped == 2
    tr.reset()
    assert tr.spans() == [] and tr.dropped == 0
