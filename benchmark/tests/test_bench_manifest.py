"""BENCHMARK.json against the contract's rules, the files it names, and the
yardstick's arithmetic tied to the shapes."""
import json

import pytest

from benchmark.harness import manifest as M
from benchmark.harness import yardstick as Y

MAN = M.load()
CELLS = [w["name"] for w in MAN["workloads"]]
METRICS = MAN["end_to_end"] + MAN["per_layer"]


def test_top_level_keys():
    assert set(MAN) == {"command", "paths", "run_seconds", "configs", "workloads",
                        "end_to_end", "per_layer"}
    assert MAN["command"] == ["python3", "benchmark/run.py"]
    assert MAN["paths"] == ["benchmark"]
    assert 1 <= MAN["run_seconds"] <= 51
    assert len((M.ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_run_seconds_fit_a_full_check():
    runs = 2 + 14 * 24
    assert runs * (MAN["run_seconds"] + 60) + 24 * 2 * 90 + 1200 <= 43200


@pytest.mark.parametrize("entry", MAN["configs"] + MAN["workloads"] + METRICS,
                         ids=lambda e: e["name"])
def test_names_and_units(entry):
    assert M.NAME.match(entry["name"])
    if "unit" in entry:
        assert M.UNIT.match(entry["unit"])
        assert entry["better"] in ("lower", "higher")
        assert entry["source"] in M.SOURCES
    texts = [entry[k] for k in ("why", "layer") if k in entry]
    if "file" in entry:
        texts.append(entry["source"])
    for v in texts:
        assert 1 <= len(v) <= 200 and "\n" not in v and "\t" not in v


def test_names_unique():
    for group in (MAN["configs"], MAN["workloads"], METRICS):
        names = [e["name"] for e in group]
        assert len(names) == len(set(names))


@pytest.mark.parametrize("cell", CELLS)
def test_cell_files_and_metrics(cell):
    spec = M.cell(MAN, cell)
    w = spec["workload"]
    assert set(w) == {"name", "config", "traffic", "chips", "why"} and w["chips"] == 1
    assert w["name"] == f"{w['config']}.{w['traffic']}"
    drv = M.driver(spec["traffic"]["driver"])
    for part in ("setup", "window", "traced", "release", "reference_record", "numbers",
                 "CONTROL", "FAULTS", "patches", "TINY"):
        assert hasattr(drv, part), part
    names = [m["name"] for m in spec["end_to_end"]]
    assert "setup_s" in names and len(names) >= 2
    assert spec["per_layer"]
    for m in spec["per_layer"]:
        assert m["moves"] in names
        assert callable(M.reader(m["name"]))


def test_bounds():
    for m in MAN["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    assert {m["name"]: m["bound"] for m in MAN["end_to_end"]}["setup_s"] == 0.25


def test_configs_own_files():
    files = [c["file"] for c in MAN["configs"]]
    assert len(files) == len(set(files))
    for c in MAN["configs"]:
        assert c["file"].startswith("benchmark/") and c["reduced"] == []
        assert json.loads((M.ROOT / c["file"]).read_text())["name"] == c["name"]


def test_layers_one_line():
    for m in MAN["per_layer"]:
        assert "\n" not in m["layer"] and set(m) == {"name", "unit", "better", "source",
                                                      "layer", "moves", "workloads"}


def test_flops_from_widths():
    assert Y.dense_widths(189, (256, 256), 60) == [(189, 256), (256, 256), (256, 60), (256, 1)]
    assert Y.forward_flops(189, (256, 256), 60) == 259_072
    assert Y.sgd_flops(189, (256, 256), 60) == 680_448
    per = 8192 * 128 * 259_072 + 8192 * 259_072 + 8192 * 128 * 680_448
    assert Y.ppo_update_flops(189, (256, 256), 60, 8192, 128, 1) == per


def test_bytes_from_layout():
    assert Y.STATE_BYTES == 2_136
    assert Y.K3A_BYTES == 2 * 2_136 + 4 + 4 + 1 + 189 * 4 + 60
    assert Y.ENV_STEP_BYTES == 2 * 2_136 + 9
    assert Y.K2_BYTES == 2 * 2_136 + 8
    assert Y.roofline_pct(Y.HBM_BYTES, 2.0) == pytest.approx(50.0)
    assert Y.roofline_pct(1.0, None) is None
