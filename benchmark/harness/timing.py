"""Stamps on the device's timeline (CUDA events on a card, the host clock
on the CPU, where the benchmark's tests run a cell) and the closed loop
that a window runs."""
from __future__ import annotations

import gc
import time

import numpy as np
import torch

QUEUED = 2      # steps a window lets queue on the card beyond the one it runs


class Stamp:
    """A point in the device's stream, recorded when made."""

    def __init__(self, dev):
        self.ev = None
        if torch.device(dev).type == "cuda":
            self.ev = torch.cuda.Event(enable_timing=True)
            self.ev.record()
        else:
            self.t = time.perf_counter()

    def wait(self) -> None:
        if self.ev is not None:
            self.ev.synchronize()

    def ms_to(self, later: "Stamp") -> float:
        if self.ev is not None:
            return self.ev.elapsed_time(later.ev)
        return (later.t - self.t) * 1e3


def sync(dev) -> None:
    if torch.device(dev).type == "cuda":
        torch.cuda.synchronize(dev)


def _allocator(dev) -> dict:
    """The caching allocator's counts of device allocations, frees and
    retries (a retry frees the cache after a synchronise)."""
    if torch.device(dev).type != "cuda":
        return {}
    st = torch.cuda.memory_stats(dev)
    return {k: st.get(k, 0) for k in ("num_device_alloc", "num_device_free", "num_alloc_retries")}


def closed_loop(step, seconds: float, dev) -> dict:
    """Call ``step()`` until ``seconds`` of host time have passed, each
    call enqueued as soon as the last one is, at most :data:`QUEUED`
    queued on the card beyond the one it runs. Returns ``n`` (calls),
    ``wall`` (host seconds to the synchronise after the last), ``ms`` (each
    call's time between device stamps), ``q`` (its 25th, 50th, 75th and
    95th percentiles), ``host_ms`` (each call's host time to enqueue),
    ``gc_ms`` (each of the interpreter's collections in the window) and
    ``allocator`` (the caching allocator's counts that changed in it)."""
    gc_ms, t_gc = [], [0.0]

    def on_gc(phase, info):
        if phase == "start":
            t_gc[0] = time.perf_counter()
        else:
            gc_ms.append(1e3 * (time.perf_counter() - t_gc[0]))
    before = _allocator(dev)
    host_ms = []
    gc.callbacks.append(on_gc)
    try:
        t0 = time.perf_counter()
        marks = [Stamp(dev)]
        while time.perf_counter() - t0 < seconds:
            h = time.perf_counter()
            step()
            host_ms.append(1e3 * (time.perf_counter() - h))
            marks.append(Stamp(dev))
            if len(marks) > QUEUED + 1:
                marks[-QUEUED - 1].wait()
        sync(dev)
        wall = time.perf_counter() - t0
    finally:
        gc.callbacks.remove(on_gc)
    after = _allocator(dev)
    ms = [a.ms_to(b) for a, b in zip(marks, marks[1:])]
    return {"n": len(ms), "wall": wall, "ms": ms, "host_ms": host_ms, "gc_ms": gc_ms,
            "allocator": {k: after[k] - before[k] for k in after if after[k] != before[k]},
            "q": [float(x) for x in np.percentile(ms, [25, 50, 75, 95])]}


def spread(loop: dict, what: str) -> dict:
    """The window's step times, for the result line; ``{what}_slow`` gives
    each step over twice the median as [index, device ms, the longest host
    enqueue of it and the :data:`QUEUED` steps before it]."""
    q, ms, host = loop["q"], loop["ms"], loop["host_ms"]
    slow = [[i, m, max(host[max(0, i - QUEUED):i + 1])] for i, m in enumerate(ms)
            if m > 2 * q[1]]
    return {what: loop["n"], f"{what}_ms_q1": q[0], f"{what}_ms_median": q[1],
            f"{what}_ms_q3": q[2], f"{what}_ms_max": float(max(ms)),
            f"{what}_over_2x_median": len(slow), f"{what}_slow": slow[:10],
            f"{what}_host_ms_median": float(np.median(host)),
            f"{what}_host_ms_max": float(max(host)),
            "gc": [len(loop["gc_ms"]), float(max(loop["gc_ms"], default=0.0))],
            "allocator": loop["allocator"], "window_s": loop["wall"]}
