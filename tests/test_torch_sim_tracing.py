"""The sim rollout's spans (``ops/fused_rollout.py:rollout_fused``, the
tracer of ``utils/profiling.py``): one ``sim.call`` tree a call, holding
``sim.coef`` and then ``sim.launch``; with the tracer off nothing is kept
and no bit of the result moves; on a card, the host syncs of a call are
counted inside its tree.

The card case skips itself where torch sees no card. The machine with the
card has no JAX, and tests/conftest.py imports it, so this file imports
torch and the port only and runs there with

    python -m pytest --noconftest -m cuda tests/test_torch_sim_tracing.py
"""
import pytest
import torch

from balatro_gym_tpu_torch.ops import fused_rollout as FR
from balatro_gym_tpu_torch.utils import profiling as P

JOKERS = (1, 31, 34, 48, 72)


@pytest.fixture(autouse=True)
def fresh_tracer():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    P.reset()
    yield
    P.reset()
    torch.set_num_threads(n)


def call(device="cpu", n_envs=32, n_steps=6):
    return FR.rollout_fused(7, n_envs, n_steps, JOKERS, device=device)


def test_call_is_one_tree_of_coef_then_launch():
    with P.recording(True):
        call()
    spans = P.spans()
    assert [s["name"] for s in spans] == ["sim.call", "sim.coef", "sim.launch"]
    root, coef, launch = spans
    assert root["parent"] == 0 and coef["parent"] == launch["parent"] == root["id"]
    assert {s["root"] for s in spans} == {root["id"]}
    assert root["start_ns"] <= coef["start_ns"] <= coef["end_ns"] <= launch["start_ns"]
    assert launch["end_ns"] <= root["end_ns"]
    tree, = P.trees("sim.call")
    assert tree["syncs"] is None                         # no card: nothing counted
    assert tree["host_ms"]["sim.call"] >= tree["host_ms"]["sim.launch"] > 0


def test_off_keeps_nothing_and_changes_no_bit():
    off = call()
    assert P.spans() == [] and P.TRACER.dropped == 0
    with P.recording(True):
        on = call()
    assert len(P.trees("sim.call")) == 1
    assert set(off) == set(on)
    for k in off:
        assert torch.equal(off[k], on[k]), k
    assert P.span("x") is P.span("y")                   # off again: the shared no-op


def test_call_under_a_profile_keeps_its_spans():
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU]):
        call()
    spans = P.spans()
    assert [s["name"] for s in spans] == ["sim.call", "sim.coef", "sim.launch"]
    assert all(s["profiled"] for s in spans)


@pytest.mark.cuda
def test_host_syncs_counted_inside_the_call():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (torch.cuda.is_available() is False)")
    dev = torch.device("cuda", torch.cuda.current_device())
    call(dev, 1024, 8)                               # build K4, the CUDA context exists
    torch.cuda.synchronize()
    mode = torch.cuda.get_sync_debug_mode()
    with P.recording(True):
        out = call(dev, 1024, 8)
    torch.cuda.synchronize()
    tree, = P.trees("sim.call")
    assert tree["syncs"] is not None and tree["syncs"] >= 0
    assert all(s["syncs"] is not None for s in tree["spans"])
    assert torch.cuda.get_sync_debug_mode() == mode
    ref = FR.rollout_fused_reference(7, 1024, 8, JOKERS, device=dev)
    for k in out:
        assert torch.equal(out[k], ref[k]), k
    print("sim.call host syncs by span:", {s["name"]: s["syncs"] for s in tree["spans"]})
