"""Each cell's driver and its reference, at a tiny size on the CPU (where
the port runs its plain versions), agree; a traced run reads the trace; the
command refuses to run without a card."""
import json
import subprocess
import sys
import time

import pytest
import torch

from benchmark.harness import manifest as M
from benchmark.harness import runner
from benchmark.harness import trace as T
from benchmark.tests import tiny


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("cell", tiny.CELLS)
def test_cell_agrees_with_reference(cell):
    spec = tiny.spec(cell)
    r = runner.run_spec(spec, 3_000_000_019, 0.5, False, tiny.CPU, time.perf_counter())
    assert r["correct"], r["checks"]
    assert set(r["checks"]) == set(spec["limits"])
    assert all(v["value"] == 0 for v in r["checks"].values())
    assert list(r)[-1] == "checks"
    assert json.loads(json.dumps(r)) == r          # the result line is plain JSON
    assert {m["name"] for m in spec["end_to_end"]} == set(r["metrics"])
    assert r["attempted"] >= 1 and all(m["value"] > 0 for m in r["metrics"].values())


def test_traced_run_reads_its_window():
    spec = tiny.spec("full-ac256.ppo-generic")
    r = runner.run_spec(spec, 77, 0.0, True, tiny.CPU, time.perf_counter())
    assert r["correct"]
    d = r["device"]
    assert d["window_s"] > 0 and d["busy_s"] == 0.0       # no card: nothing ran on a device
    assert r["metrics"]["engine_step_host_ms"]["value"] > 0
    assert r["metrics"]["idle_share.train"]["value"] == 100.0
    assert "k3a_roofline" not in r["metrics"]                # no kernel ran: nothing to read
    assert set(r["breakdown"]) == {"device_ops", "idle_gaps"}
    json.dumps(r)


def test_union_and_kernel_median():
    assert T._union([(0, 2), (1, 3), (5, 6)]) == [[0, 3], [5, 6]]
    tr = {"kernels": {"policy_step_kernel(int const*)": [1.0, 3.0, 2.0], "other": [9.0]}}
    assert T.kernel_median_s(tr, "policy_step_kernel") == 2.0
    assert T.kernel_median_s(tr, "env_step_kernel") is None


def test_same_seed_same_inputs():
    from benchmark.drivers import ppo_update as P
    spec = tiny.spec("full-ac256.ppo-fused")
    a, b = (P.make_weights(spec, 2 ** 31 + 5, tiny.CPU) for _ in range(2))
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert P.seed_key(2 ** 32 + 7) == [1, 7]


def test_command_refuses_without_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    p = subprocess.run([sys.executable, str(M.BENCH / "run.py"), "--workload",
                        "full-random.rollout", "--seed", "1", "--seconds", "1"],
                       capture_output=True, text=True, timeout=120, cwd=M.ROOT)
    assert p.returncode != 0 and not p.stdout.strip()


@pytest.mark.cuda
def test_command_on_card(tmp_path):
    """One short run of the rollout cell on the card: the contract's last line."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    p = subprocess.run([sys.executable, str(M.BENCH / "run.py"), "--workload",
                        "full-random.rollout", "--seed", "5", "--seconds", "2"],
                       capture_output=True, text=True, timeout=900, cwd=M.ROOT)
    assert p.returncode == 0, p.stderr[-2000:]
    r = json.loads(p.stdout.strip().splitlines()[-1])
    assert r["correct"] and r["device"]["platform"] == "gpu"
    assert set(r["metrics"]) == {"rollout_env_steps_per_s", "setup_s"}
