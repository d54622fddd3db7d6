"""The traced window: ``torch.profiler`` over a few steps of the cell's
work, reduced to what the per-layer readers and the result line need.

The window is the host interval of the ``bench.window`` annotation, which
the harness opens after a synchronise and closes after another. Device
events are the profiler's kernels, copies and sets; the card is busy where
any of them runs, so overlapping events count once (the union of their
intervals), clipped to the window. An idle gap is an interval of the window
in which no device event runs; it is labelled with the innermost host
operation or annotation open at its start ("python" where the host is
between operations). The profile is read from its Chrome trace, written
under ``TMPDIR`` and deleted once read.
"""
from __future__ import annotations

import bisect
import collections
import contextlib
import json
import os
import statistics
import tempfile
import time

WINDOW = "bench.window"
_DEVICE_KINDS = {"kernel", "gpu_memcpy", "gpu_memset"}
_HOST_KINDS = {"cpu_op", "user_annotation", "python_function"}


@contextlib.contextmanager
def profiled(sync, cpu: bool):
    """Profile the body as a traced window; yields a dict that holds, once
    the body has ended, the profiler (``["prof"]``) and the host seconds
    from the synchronise before the body to the one after it
    (``["window_s"]``). ``cpu=False`` traces the card alone, which costs
    the host little; ``cpu=True`` also records every host op, which slows
    a host-bound step several times, and marks the window with the
    ``bench.window`` annotation."""
    from torch.profiler import ProfilerActivity, profile, record_function
    out = {}
    import torch
    acts = [ProfilerActivity.CUDA] if torch.cuda.is_available() else []
    if cpu or not acts:             # a run without a card traces the host
        acts.append(ProfilerActivity.CPU)
    with profile(activities=acts) as prof:
        with record_function(WINDOW) if cpu else contextlib.nullcontext():
            sync()
            t0 = time.perf_counter()
            yield out
            sync()
            out["window_s"] = time.perf_counter() - t0
    out["prof"] = prof


def _union(intervals):
    merged = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return merged


def _events(prof) -> list:
    """The profile's complete events, as its Chrome trace has them (the
    trace is written under ``TMPDIR`` and deleted once read)."""
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            return [e for e in json.load(f)["traceEvents"] if e.get("ph") == "X"]
    finally:
        os.unlink(path)


def reduce(got) -> dict:
    """{"window_s", "busy_s", "kernels": {name: [seconds of each launch]},
    "device_ops": [[name, seconds]] (top 10 by total), "idle_gaps":
    [[host label, seconds]] (top 10 labels by total idle; empty without
    host ops)} from what :func:`profiled` yields. The window is the
    ``bench.window`` annotation where the host was traced, else the host
    seconds between the two synchronises, inside which every device event
    of the profile lies."""
    events = _events(got["prof"])

    def span(e):
        s = int(round(float(e["ts"]) * 1e3))
        return s, s + int(round(float(e.get("dur", 0)) * 1e3))

    win = [span(e) for e in events if e["name"] == WINDOW and e.get("cat") == "user_annotation"]
    w0, w1 = win[0] if win else (-2 ** 62, 2 ** 62)
    dev, host, kernels = [], [], collections.defaultdict(list)
    for e in events:
        kind = e.get("cat")
        s, t = span(e)
        if kind in _DEVICE_KINDS:
            if t <= w0 or s >= w1:
                continue
            dev.append((max(s, w0), min(t, w1)))
            kernels[e["name"]].append((t - s) * 1e-9)
        elif kind in _HOST_KINDS and e["name"] != WINDOW:
            host.append((s, t, e["name"]))
    if not win:
        w0, w1 = 0, int(got["window_s"] * 1e9)
        if dev:
            w0 = min(s for s, _ in dev)
            w1 = w0 + int(got["window_s"] * 1e9)
    busy = _union(dev)
    busy_ns = sum(e - s for s, e in busy)
    gaps, prev = [], w0
    for s, e in busy:
        if s > prev:
            gaps.append((prev, s))
        prev = max(prev, e)
    if w1 > prev:
        gaps.append((prev, w1))
    host.sort()
    starts = [h[0] for h in host]
    idle = collections.Counter()
    for s, e in gaps if host else ():
        idle[_open_at(host, starts, s)] += (e - s) * 1e-9
    totals = sorted(((n, sum(v)) for n, v in kernels.items()), key=lambda x: -x[1])
    return {"window_s": (w1 - w0) * 1e-9, "busy_s": busy_ns * 1e-9,
            "kernels": dict(kernels),
            "device_ops": [[n, s] for n, s in totals[:10]],
            "idle_gaps": [[n, s] for n, s in idle.most_common(10)]}


def _open_at(host, starts, t, reach=256):
    """The innermost host op open at ``t``: the latest-starting one that
    has not ended, looked for among the ``reach`` ops that started last
    before ``t``; "python" where none is open (the host is between ops)."""
    i = bisect.bisect_right(starts, t)
    for hs, he, name in reversed(host[max(0, i - reach):i]):
        if he >= t:
            return name
    return "python"


def kernel_name(traced: str) -> str:
    """A kernel's bare name from the profiler's signature:
    ``(anonymous namespace)::env_step_kernel(int const*, ...)`` ->
    ``env_step_kernel``."""
    head = traced.replace("(anonymous namespace)::", "").split("(")[0]
    return head.split()[-1].split("::")[-1] if head.strip() else traced


def kernel_median_s(trace: dict, name: str) -> float | None:
    """The median time of the launches of the kernel whose name starts
    with ``name``; None where none ran."""
    times = [t for k, v in trace["kernels"].items() if kernel_name(k) == name for t in v]
    return statistics.median(times) if times else None
