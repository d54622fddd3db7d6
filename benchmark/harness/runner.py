"""One run of one cell: set-up, the measured or the traced window, the
memory peak, then the check against the reference.

A traced run runs the traffic's ``traced_steps`` steps untraced (the
program's spans and counters and the steps' host time: the profiler slows
a host-bound step several times), then as many with the card alone traced
(kernel times, the device's busy time, the device ops), then
:data:`LABELLED_STEPS` more with the host traced too, which labels the idle
gaps. The result's ``device`` block gives the card-traced busy time and the
untraced host time of the same steps (``busy_s``, ``window_s``): the pair
the idle-share readers read.

A driver (``drivers/<traffic's driver>.py``) gives ``setup(spec, seed,
dev, trace)``, ``window(run, seconds)`` (the end-to-end numbers it takes,
``attempted`` and a ``spread`` of its steps), ``traced(run, n)`` (n steps;
the readers' context), ``release(run)`` (frees the program's state and keeps what is
judged in ``run["record"]``), ``reference_record(run, **control)``,
``numbers(prog, ref)`` and ``CONTROL``; for the benchmark's own checks also
``FAULTS``, ``patches(fault)`` (``benchmark/faults.py``) and ``TINY`` (the
CPU tests' size, merged into the traffic).
"""
from __future__ import annotations

import gc
import subprocess
import time

import torch

from benchmark.harness import manifest as M
from benchmark.harness import timing
from benchmark.harness import trace as T

LABELLED_STEPS = 1
CARD_STATE = "clocks.sm,clocks.max.sm,temperature.gpu,power.draw"


def run_device_info(dev, spec) -> dict:
    count = spec["workload"]["chips"]
    if torch.device(dev).type == "cuda":
        return {"platform": "gpu", "kind": torch.cuda.get_device_name(dev), "count": count,
                "memory_peak_bytes": 0}
    return {"platform": "cpu", "kind": "cpu", "count": count, "memory_peak_bytes": 0}


def card_state(dev) -> str:
    """The card's SM clock, its maximum, temperature and power draw, read
    by ``nvidia-smi`` as the window closes."""
    if torch.device(dev).type != "cuda":
        return "no card"
    try:
        return subprocess.run(["nvidia-smi", f"--query-gpu={CARD_STATE}", "--format=csv,noheader",
                               "-i", str(torch.device(dev).index or 0)], capture_output=True,
                              text=True, timeout=20).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return "not read"


def read_layers(spec, ctx: dict) -> dict:
    """Each per-layer metric of the cell whose reader finds something."""
    out = {}
    for m in spec["per_layer"]:
        v = M.reader(m["name"])(ctx)
        if v is not None:
            out[m["name"]] = {"value": v, "unit": m["unit"]}
    return out


def traced_run(drv, run, spec, dev) -> dict:
    """The traced run's passes, each over the traffic's steps: untraced
    (the program's spans and counters, the host time of the steps), the
    card traced (kernel times, busy time, device ops), the host traced too
    (:data:`LABELLED_STEPS`: the idle gaps' labels)."""
    sync = lambda: timing.sync(dev)                                  # noqa: E731
    n, n_lab = spec["traffic"]["traced_steps"], LABELLED_STEPS
    sync()
    t0 = time.perf_counter()
    ctx = drv.traced(run, n)
    sync()
    ctx["window_s"] = time.perf_counter() - t0
    with T.profiled(sync, cpu=False) as got:
        drv.traced(run, n)
    tr = T.reduce(got)
    ctx.update(trace=tr, spec=spec)
    with T.profiled(sync, cpu=True) as got:
        drv.traced(run, n_lab)
    labelled = T.reduce(got)
    return {"metrics": read_layers(spec, ctx), "attempted": 2 * n + n_lab,
            "device": {**run_device_info(dev, spec), "busy_s": tr["busy_s"],
                       "window_s": ctx["window_s"]},
            "breakdown": {"device_ops": tr["device_ops"], "idle_gaps": labelled["idle_gaps"]},
            "traced": {"steps": n, "untraced_step_ms": 1e3 * ctx["window_s"] / n,
                       "traced_step_ms": 1e3 * tr["window_s"] / n,
                       "host_traced_step_ms": 1e3 * labelled["window_s"] / n_lab}}


def run_cell(name: str, seed: int, seconds: float, trace: bool, dev, t_start: float,
             root=M.ROOT) -> dict:
    """The result of one run of the manifest's cell ``name``."""
    return run_spec(M.cell(M.load(root), name, root), seed, seconds, trace, dev, t_start)


def run_spec(spec: dict, seed: int, seconds: float, trace: bool, dev, t_start: float) -> dict:
    """The result of one run of a cell (the contract's keys, ``spread`` and
    ``checks`` last)."""
    drv = M.driver(spec["traffic"]["driver"])
    cuda = torch.device(dev).type == "cuda"
    if cuda:
        torch.cuda.set_device(dev)
        torch.cuda.init()
        torch.cuda.reset_peak_memory_stats(dev)
    run = drv.setup(spec, seed, dev, trace)
    timing.sync(dev)
    gc.collect()
    gc.freeze()         # the window's collections need not walk set-up's objects
    setup_s = time.perf_counter() - t_start
    result = {"correct": False, "attempted": 0, "failed": 0, "metrics": {},
              "device": run_device_info(dev, spec)}
    if trace:
        result.update(traced_run(drv, run, spec, dev))
    else:
        got = drv.window(run, seconds)
        got["setup_s"] = setup_s
        result["metrics"] = {m["name"]: {"value": got[m["name"]], "unit": m["unit"]}
                             for m in spec["end_to_end"]}
        result["attempted"] = got["attempted"]
        result["spread"] = {**got["spread"], "card": card_state(dev)}
    if cuda:
        result["device"]["memory_peak_bytes"] = torch.cuda.max_memory_allocated(dev)
    drv.release(run)
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    numbers = drv.numbers(run["record"], drv.reference_record(run))
    limits = spec["limits"]
    result["check_s"] = time.perf_counter() - t0
    result["correct"] = all(numbers[k] <= limits[k] for k in limits)
    result["checks"] = {k: {"value": numbers[k], "limit": limits[k]} for k in limits}
    return result
