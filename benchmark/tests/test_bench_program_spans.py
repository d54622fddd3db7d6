"""The readers of the program's spans and host-sync counters
(``utils/profiling.py``) on each cell's tiny traced run on the CPU: a
number where the cell's traced run keeps spans, None for the host syncs
(no card counts none), and None against a program that keeps no spans or
whose full store dropped some."""
import time

import pytest
import torch

from balatro_gym_tpu_torch.utils import profiling as P
from benchmark.harness import manifest as M
from benchmark.harness import runner
from benchmark.tests import tiny

SPANS = {"collect_host_ms", "sgd_host_ms", "engine_pack_host_ms", "rollout_prepare_host_ms"}
SYNCS = {"host_syncs.train", "host_syncs.rollout"}


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("cell", tiny.CELLS)
def test_readers_on_a_tiny_traced_run(cell):
    spec = tiny.spec(cell)
    mine = {m["name"] for m in spec["per_layer"]} & (SPANS | SYNCS)
    assert mine
    r = runner.run_spec(spec, 2 ** 31 + 17, 0.0, True, tiny.CPU, time.perf_counter())
    assert r["correct"]
    for name in mine & SPANS:
        assert r["metrics"][name]["value"] > 0, name
    assert not mine & SYNCS & set(r["metrics"])          # no card: no syncs counted


@pytest.mark.parametrize("name", sorted(SPANS | SYNCS))
def test_readers_without_spans(name, monkeypatch):
    monkeypatch.delattr(P, "trees")                      # a program that keeps no spans
    spec = tiny.spec(next(c for c in tiny.CELLS
                          if name in {m["name"] for m in tiny.spec(c)["per_layer"]}))
    assert M.reader(name)({"spec": spec}) is None


@pytest.mark.parametrize("name", sorted(SPANS | SYNCS))
def test_readers_after_dropped_spans(name, monkeypatch):
    monkeypatch.setattr(P.TRACER, "dropped", 1)          # the oldest updates' spans lost
    spec = tiny.spec(next(c for c in tiny.CELLS
                          if name in {m["name"] for m in tiny.spec(c)["per_layer"]}))
    assert M.reader(name)({"spec": spec}) is None
