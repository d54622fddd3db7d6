"""The port's tracer (``utils/profiling.py``) on the card: a span on the
profiler's clock holds the kernels it launched, spans are kept under a
profile that traces the card alone, host syncs are counted by the span
they happen in and the sync debug mode is restored, and a PPO update's
``record=`` events keep their four stages.

These tests need a card and skip where torch sees none. The machine with
the card has no JAX, and tests/conftest.py imports it, so this file imports
torch and the port only and runs there with

    python -m pytest --noconftest -m cuda tests/test_torch_tracing_cuda.py
"""
import collections
import json
import warnings

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from balatro_gym_tpu_torch.train import ppo as TP
from balatro_gym_tpu_torch.utils import profiling as P

pytestmark = pytest.mark.cuda

CLOCK_SLACK_US = 50
STAGE_EVENTS = ["start", "collection", "stats", "last value + GAE", "shuffle + SGD"]


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (torch.cuda.is_available() is False)")
    d = torch.device("cuda", torch.cuda.current_device())
    torch.ones(1, device=d)                     # the CUDA context exists
    P.reset()
    yield d
    P.reset()


def test_span_holds_its_kernels_on_the_profilers_clock(dev, tmp_path):
    x = torch.randn(4096, 4096, device=dev)
    x @ x
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        with P.span("card.matmul"):
            x @ x
            torch.cuda.synchronize()
    prof.export_chrome_trace(str(tmp_path / "prof.json"))
    tr = json.loads((tmp_path / "prof.json").read_text())
    kernels = [e for e in tr["traceEvents"] if e.get("cat") == "kernel"]
    assert kernels
    k0 = min(float(e["ts"]) for e in kernels)
    k1 = max(float(e["ts"]) + float(e["dur"]) for e in kernels)
    out = P.export(tmp_path / "spans.json", base_ns=tr["baseTimeNanoseconds"])
    span, = json.loads(out.read_text())["traceEvents"]
    assert span["args"]["profiled"]             # kept under a profile of the card alone
    s0, s1 = span["ts"], span["ts"] + span["dur"]
    print(f"span {s0:.1f}-{s1:.1f} us, kernels {k0:.1f}-{k1:.1f} us: "
          f"{k0 - s0:.1f} us after its start, {s1 - k1:.1f} us before its end")
    assert s0 - CLOCK_SLACK_US <= k0 and k1 <= s1 + CLOCK_SLACK_US


def test_host_syncs_counted_by_span(dev):
    y = torch.ones(8, device=dev)
    mode, filters = torch.cuda.get_sync_debug_mode(), list(warnings.filters)
    P.enable()
    try:
        with P.span("copy"):
            torch.as_tensor(5, device=dev)
        with P.span("item"):
            y.sum().item()
        with P.span("launch"):
            y * 2
    finally:
        P.disable()
    assert {s["name"]: s["syncs"] for s in P.spans()} == {"copy": 1, "item": 1, "launch": 0}
    assert torch.cuda.get_sync_debug_mode() == mode == 0
    assert list(warnings.filters) == filters
    torch.as_tensor(5, device=dev)              # off: nothing counted, nothing kept
    assert sum(s["syncs"] for s in P.spans()) == 2


@pytest.mark.parametrize("fused", [True, False], ids=["fused", "generic"])
def test_update_keeps_its_stage_events(dev, fused):
    T = 4
    cfg = TP.PPOConfig(n_envs=64, rollout_len=T, epochs=1, minibatches=2, hidden=(32,),
                       fused_rollout=fused, env_shuffle=True)
    init_fn, update_fn, _ = TP.make_ppo(TP.full_env_hooks(), cfg, device=dev)
    ts, _ = update_fn(init_fn([0, 3]))
    assert P.spans() == []
    rec = {}
    update_fn(ts, record=rec)
    torch.cuda.synchronize()
    assert [name for name, _ in rec["events"]] == STAGE_EVENTS
    ev = [e for _, e in rec["events"]]
    ms = [a.elapsed_time(b) for a, b in zip(ev, ev[1:])]
    assert all(m >= 0 for m in ms)
    tree, = P.trees("ppo.update")
    stages = [s for s in tree["spans"] if s["parent"] == tree["span"]["id"]]
    # the collection's pair is the first two events; each later stage's
    # pair starts after the previous stage's end
    assert stages[0]["device_ms"] == ms[0]
    assert all(0 <= s["device_ms"] <= m for s, m in zip(stages[1:], ms[1:]))
    assert tree["syncs"] is not None and torch.cuda.get_sync_debug_mode() == 0
    n = collections.Counter(s["name"] for s in tree["spans"])
    if not fused:
        assert n["engine.pack"] == 3 * T + 2 and n["engine.unpack"] == T
