"""``BENCHMARK.json`` and the files it names, found by name.

A cell (an entry of ``workloads``) names a configuration and a traffic
mix. Each is a JSON file of its own: ``configs/<config>.json`` (the entry's
``file``), ``traffic/<traffic>.json`` (its driver and parameters) and
``limits/<cell>.json`` (the limits of the numbers its correctness check
compares). A per-layer metric is ``metrics/<name>.py`` and lists the cells
it is read in under ``workloads``. A later cell, mix,
configuration or metric is new files and new manifest entries; nothing here
changes.
"""
from __future__ import annotations

import importlib.util
import json
import re
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


def load(root: Path = ROOT) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def _json(path: Path) -> dict:
    return json.loads(path.read_text())


def cell(manifest: dict, name: str, root: Path = ROOT) -> dict:
    """Everything one cell needs: its manifest entry (``workload``), its
    configuration, its traffic, its limits, and the metrics it reports
    (``end_to_end``, ``per_layer``: manifest entries)."""
    work = {w["name"]: w for w in manifest["workloads"]}
    if name not in work:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json; have {sorted(work)}")
    w = work[name]
    conf = {c["name"]: c for c in manifest["configs"]}[w["config"]]
    e2e = [m for m in manifest["end_to_end"] if name in m.get("workloads", [name])]
    layer = [m for m in manifest["per_layer"] if name in m["workloads"]]
    return {"workload": w, "config": _json(root / conf["file"]),
            "traffic": _json(BENCH / "traffic" / f"{w['traffic']}.json"),
            "limits": _json(BENCH / "limits" / f"{name}.json"),
            "end_to_end": e2e, "per_layer": layer}


def _module(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def driver(name: str):
    """The driver module ``drivers/<name>.py``."""
    return _module(BENCH / "drivers" / f"{name}.py", f"benchmark_driver_{name}")


def reader(name: str):
    """The reader of per-layer metric ``name``: ``metrics/<name>.py``'s
    ``read(ctx)``, which returns a number or None."""
    return _module(BENCH / "metrics" / f"{name}.py",
                   "benchmark_metric_" + name.replace(".", "_").replace("-", "_")).read
