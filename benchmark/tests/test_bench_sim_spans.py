"""The sim cell's readers: the program's ``sim.call`` spans and host-sync
counter (``ops/fused_rollout.py``) on a tiny traced run on the CPU, None
against a program that keeps no spans or whose full store dropped some, and
K4's roofline arithmetic (``harness/int_yardstick.py``)."""
import time

import pytest
import torch

from balatro_gym_tpu_torch.utils import profiling as P
from benchmark.harness import int_yardstick as IY
from benchmark.harness import manifest as M
from benchmark.harness import runner
from benchmark.tests import tiny

CELL = "sim-random.rollout-k4"
READERS = ("sim_prepare_host_ms", "host_syncs.sim")


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_tiny_traced_run_reads_the_spans():
    spec = tiny.spec(CELL)
    assert set(READERS) <= {m["name"] for m in spec["per_layer"]}
    P.reset()
    r = runner.run_spec(spec, 2 ** 31 + 17, 0.0, True, tiny.CPU, time.perf_counter())
    assert r["correct"]
    assert r["metrics"]["sim_prepare_host_ms"]["value"] > 0
    assert "host_syncs.sim" not in r["metrics"]              # no card: no syncs counted
    assert "k4_roofline" not in r["metrics"]                 # no kernel ran: nothing to read
    assert r["metrics"]["idle_share.rollout"]["value"] == 100.0
    n = spec["traffic"]["traced_steps"]
    assert len(P.trees("sim.call")) == n + runner.LABELLED_STEPS     # the profiled passes


@pytest.mark.parametrize("name", READERS)
def test_readers_without_spans(name, monkeypatch):
    monkeypatch.delattr(P, "trees")                          # a program that keeps no spans
    assert M.reader(name)({"spec": tiny.spec(CELL)}) is None


@pytest.mark.parametrize("name", READERS)
def test_readers_after_dropped_spans(name, monkeypatch):
    monkeypatch.setattr(P.TRACER, "dropped", 1)              # the oldest calls' spans lost
    assert M.reader(name)({"spec": tiny.spec(CELL)}) is None


@pytest.mark.parametrize("name", READERS)
def test_readers_without_sim_calls(name):
    P.reset()                                                # a program with no sim.call span
    with P.recording(True):
        with P.span("rollout.call"):
            pass
    assert M.reader(name)({"spec": tiny.spec(CELL)}) is None
    P.reset()


def test_k4_work_and_roofline():
    assert IY.STEP_OPS == 520
    assert IY.K4_BYTES == 676
    assert IY.k4_ops(131072, 256) == 131072 * (256 * 520 + 75)
    t = IY.k4_ops(131072, 256) / IY.INT32_OPS                # operations bind: ~472 us
    assert t > 131072 * IY.K4_BYTES / IY.HBM_BYTES
    assert IY.k4_roofline_pct(131072, 256, 2 * t) == pytest.approx(50.0)
    assert IY.k4_roofline_pct(131072, 256, None) is None
    kernel = {"kernels": {"fused_rollout_kernel(float const*, float const*)": [t, t, 3 * t],
                          "fused_full_rollout_kernel(int*)": [1.0]}}
    got = M.reader("k4_roofline")({"trace": kernel, "n_envs": 131072, "n_steps": 256})
    assert got == pytest.approx(100.0)
