"""Profiling and metrics utilities.

Port of ``balatro_gym_tpu/utils/profiling.py``: a profiler trace around any
block, a timer that separates the first call (warm-up, kernel builds) from
the steady state, an operation count, and a metrics accumulator that reads
its device sums back only every N calls.

Beside them, the port's own tracer: named host spans at the program's layer
boundaries (the trainer's stages, the engine's packs, a K2 call) and the
host's synchronising CUDA calls counted by the span they happen in.

* ``span(name)`` is a context manager. It records only while the tracer is
  on: after :func:`enable` (until :func:`disable`), inside
  ``recording(True)``, or while a ``torch.profiler`` profile runs. Off, it
  returns one shared no-op object: no allocation, no clock read.
* A span records its name, id, parent's id, the id of the outermost span
  open around it (``root``: the update or call it belongs to), start and
  end on ``time.perf_counter_ns()``, whether a profiler ran when it opened
  (``profiled``), and the host syncs counted while it was the innermost
  span. Under a profiler it is also a profiler range (what
  ``record_function`` opens, from C++), so it lies on the profiler's
  timeline and labels the host time inside it. ``span(name,
  events=True)`` also records a CUDA event at each end (the stage's device
  time).
* On a card (a process whose CUDA context exists), while the tracer is on,
  ``torch.cuda.set_sync_debug_mode("warn")`` flags each synchronising call
  (a blocking copy between host and card, ``.item()``, ``bool`` or
  ``.cpu()`` of a card tensor) and the tracer counts its warning instead of
  showing it. The previous mode and warning filters return when the tracer
  turns off. Without a card the counts are None; a sync with no span open
  is not counted.
* :func:`spans` and :func:`trees` read the kept spans (at most
  :data:`CAPACITY`; the oldest go first, counted in ``TRACER.dropped``),
  :func:`summary` sums them by name, :func:`export` writes them as a Chrome
  trace on the profiler's clock (the Unix clock: the offset from
  ``perf_counter_ns`` is read as the tracer turns on) and :func:`reset`
  clears them.
"""
from __future__ import annotations

import collections
import contextlib
import json
import os
import threading
import time
import warnings
from pathlib import Path
from typing import Callable

import torch
import torch.autograd.profiler as _AP

CAPACITY = 1 << 16
SYNC_WARNING = "called a synchronizing CUDA operation"
# A profiler range opened from C++: several times cheaper than
# record_function, whose cost a profile of the card alone pays on every span.
_RANGE = torch._C._profiler._RecordFunctionFast


class _NoSpan:
    """What ``span`` returns while the tracer is off."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NO_SPAN = _NoSpan()


class _Span:
    __slots__ = ("tracer", "name", "id", "parent", "root", "t0", "t1", "profiled", "syncs",
                 "events", "_rf")

    def __init__(self, tracer, name, events):
        self.tracer, self.name = tracer, name
        self.events = [] if events else None

    def __enter__(self):
        tr = self.tracer
        stack = tr._stack
        if not stack and not tr._on:
            tr._start()
        tr.last_id += 1
        self.id = tr.last_id
        self.parent = stack[-1].id if stack else 0
        self.root = stack[0].id if stack else self.id
        self.syncs = None if tr._watch is None else 0
        self.profiled = _AP._is_profiler_enabled
        self._rf = None
        if self.profiled:
            self._rf = _RANGE(self.name)
            self._rf.__enter__()
        if self.events is not None:
            self._event()
        stack.append(self)
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        self.t1 = time.perf_counter_ns()
        tr = self.tracer
        if self.events is not None:
            self._event()
        if self._rf is not None:
            self._rf.__exit__(None, None, None)
            self._rf = None
        tr._stack.pop()
        if len(tr._kept) == tr._kept.maxlen:
            tr.dropped += 1
        tr._kept.append(self)
        if not tr._stack and not tr._on:
            tr._stop()
        return False

    def _event(self):
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        self.events.append(ev)

    def as_dict(self) -> dict:
        ms = None
        if self.events:
            self.events[1].synchronize()
            ms = self.events[0].elapsed_time(self.events[1])
        return {"name": self.name, "id": self.id, "parent": self.parent, "root": self.root,
                "start_ns": self.t0, "end_ns": self.t1, "profiled": self.profiled,
                "syncs": self.syncs, "device_ms": ms}


class Tracer:
    """The spans and host-sync counts of one process (the module's
    functions are those of one shared :data:`TRACER`), at most
    ``capacity`` spans kept."""

    def __init__(self, capacity: int = CAPACITY):
        self._on = 0                # enable() depth
        self._stack = []            # the open spans, outermost first
        self._kept = collections.deque(maxlen=capacity)
        self.last_id = 0            # the newest span's id: later spans have higher ones
        self.dropped = 0            # spans pushed out of the full store since reset()
        self.offset_ns = time.time_ns() - time.perf_counter_ns()
        self._watch = None          # (warnings catcher, previous sync mode) while counting

    def span(self, name: str, events: bool = False):
        """A span named ``name`` if the tracer is on, else a shared no-op;
        ``events``: also a CUDA event at each end."""
        if self._on or _AP._is_profiler_enabled:
            return _Span(self, name, events)
        return _NO_SPAN

    def enable(self) -> None:
        """Record spans until the matching :meth:`disable`."""
        if not self._on and not self._stack:
            self._start()
        self._on += 1

    def disable(self) -> None:
        self._on -= 1
        if not self._on and not self._stack:
            self._stop()

    @contextlib.contextmanager
    def _recording(self):
        self.enable()
        try:
            yield
        finally:
            self.disable()

    def recording(self, on: bool = True):
        """The tracer on for the block where ``on``; a no-op where not."""
        return self._recording() if on else _NO_SPAN

    def _start(self):
        self.offset_ns = time.time_ns() - time.perf_counter_ns()
        if not (torch.cuda.is_available() and torch.cuda.is_initialized()):
            return
        mode = torch.cuda.get_sync_debug_mode()
        if mode > 1:                # syncs raise already: nothing to count
            return
        catch = warnings.catch_warnings()
        catch.__enter__()
        warnings.filterwarnings("always", message=SYNC_WARNING)
        warnings.filterwarnings("ignore", message="Synchronization debug mode is a prototype")
        shown = warnings.showwarning

        def showwarning(message, category, filename, lineno, file=None, line=None):
            if str(message).startswith(SYNC_WARNING):
                self._count_sync()
            else:
                shown(message, category, filename, lineno, file, line)
        warnings.showwarning = showwarning
        torch.cuda.set_sync_debug_mode(1)
        self._watch = (catch, mode)

    def _stop(self):
        if self._watch is None:
            return
        catch, mode = self._watch
        self._watch = None
        torch.cuda.set_sync_debug_mode(mode)
        catch.__exit__(None, None, None)

    def _count_sync(self):
        if self._stack:
            self._stack[-1].syncs += 1

    def reset(self) -> None:
        """Forget the kept spans and the dropped count."""
        self._kept.clear()
        self.dropped = 0

    def spans(self, since: int = 0) -> list:
        """The kept spans whose id is above ``since``, as dicts (``name``,
        ``id``, ``parent``, ``root``, ``start_ns``, ``end_ns``,
        ``profiled``, ``syncs``, ``device_ms``: the CUDA events' ms of a
        span opened with ``events``, else None), in the order they
        opened."""
        return sorted((s.as_dict() for s in list(self._kept) if s.id > since),
                      key=lambda r: r["id"])

    def trees(self, name: str) -> list:
        """For each kept outermost span called ``name``, in order: {"span":
        its dict, "spans": the dicts of its tree, "host_ms": {span name:
        summed host ms in the tree}, "syncs": the tree's host syncs (None
        where none were counted)}."""
        by_root = collections.defaultdict(list)
        for r in self.spans():
            by_root[r["root"]].append(r)
        out = []
        for root, rs in by_root.items():
            top = next((r for r in rs if r["id"] == root), None)
            if top is None or top["name"] != name:
                continue
            host = collections.defaultdict(float)
            for r in rs:
                host[r["name"]] += (r["end_ns"] - r["start_ns"]) * 1e-6
            syncs = [r["syncs"] for r in rs if r["syncs"] is not None]
            out.append({"span": top, "spans": rs, "host_ms": dict(host),
                        "syncs": sum(syncs) if syncs else None})
        return out

    def summary(self, since: int = 0) -> dict:
        """By span name: {"count", "total_ms", "self_ms" (less the time of
        its child spans), "syncs"} of the kept spans above ``since``."""
        rs = self.spans(since)
        child = collections.defaultdict(int)
        for r in rs:
            child[r["parent"]] += r["end_ns"] - r["start_ns"]
        out = {}
        for r in rs:
            d = out.setdefault(r["name"], {"count": 0, "total_ms": 0.0, "self_ms": 0.0,
                                           "syncs": None})
            dur = r["end_ns"] - r["start_ns"]
            d["count"] += 1
            d["total_ms"] += dur * 1e-6
            d["self_ms"] += (dur - child[r["id"]]) * 1e-6
            if r["syncs"] is not None:
                d["syncs"] = (d["syncs"] or 0) + r["syncs"]
        return out

    def export(self, path, base_ns: int | None = None) -> Path:
        """Write the kept spans as a Chrome trace: complete events at
        ``baseTimeNanoseconds + ts`` on the Unix clock, as a
        ``torch.profiler`` trace of this process places its events
        (``base_ns``: that trace's base, so the events can join it)."""
        rs = self.spans()
        off = self.offset_ns
        if base_ns is None:
            base_ns = min((r["start_ns"] for r in rs), default=0) + off
        pid, tid = os.getpid(), threading.get_native_id()
        events = [{"ph": "X", "cat": "program_span", "name": r["name"], "pid": pid,
                   "tid": tid, "ts": (r["start_ns"] + off - base_ns) / 1e3,
                   "dur": (r["end_ns"] - r["start_ns"]) / 1e3,
                   "args": {k: r[k] for k in ("id", "parent", "root", "profiled", "syncs",
                                              "device_ms")}} for r in rs]
        path = Path(path)
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(json.dumps({"traceEvents": events, "baseTimeNanoseconds": base_ns,
                                    "displayTimeUnit": "ms"}))
        return path


TRACER = Tracer()
span, enable, disable, recording = TRACER.span, TRACER.enable, TRACER.disable, TRACER.recording
spans, trees, summary = TRACER.spans, TRACER.trees, TRACER.summary
export, reset = TRACER.export, TRACER.reset


@contextlib.contextmanager
def trace(logdir: str | Path = "torch-trace"):
    """Profile the block with ``torch.profiler`` (the CPU, and the card
    where torch sees one) and write a Chrome trace, ``trace.json``, into
    ``logdir``, with the program's spans among its host events, and
    ``spans.json``: {"by_name": the block's spans by name (:func:`summary`),
    "dropped": the spans the full store pushed out meanwhile, which
    ``by_name`` lacks}. Yields the profiler."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    logdir = Path(logdir)
    logdir.mkdir(parents=True, exist_ok=True)
    first, dropped = TRACER.last_id, TRACER.dropped
    with torch.profiler.profile(activities=acts) as prof:
        yield prof
    prof.export_chrome_trace(str(logdir / "trace.json"))
    (logdir / "spans.json").write_text(json.dumps(
        {"by_name": summary(since=first), "dropped": TRACER.dropped - dropped}, indent=1))


def _sync(out) -> None:
    """Wait for the card if any tensor in ``out`` lies on one."""
    stack = [out]
    while stack:
        x = stack.pop()
        if torch.is_tensor(x):
            if x.device.type == "cuda":
                torch.cuda.synchronize(x.device)
                return
        elif isinstance(x, dict):
            stack.extend(x.values())
        elif isinstance(x, (list, tuple)):
            stack.extend(x)


def time_compiled(fn: Callable, *args, iters: int = 3):
    """Run ``fn`` once (its first call, which builds kernels and warms
    caches), then ``iters`` timed calls. Returns (mean_seconds,
    first_call_seconds)."""
    t0 = time.perf_counter()
    out = fn(*args)
    _sync(out)
    first_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    for _ in range(iters):
        out = fn(*args)
    _sync(out)
    return (time.perf_counter() - t0) / iters, first_s


def cost_analysis(fn: Callable, *args) -> dict:
    """The floating-point operations of one call of ``fn``, as counted by
    ``torch.utils.flop_counter.FlopCounterMode`` (matmuls, convolutions and
    attention). PyTorch counts no bytes, so unlike the reference's XLA cost
    analysis there is no ``bytes accessed`` entry."""
    from torch.utils.flop_counter import FlopCounterMode

    with FlopCounterMode(display=False) as counter:
        fn(*args)
    return {"flops": float(counter.get_total_flops())}


class MetricsAccumulator:
    """Accumulate scalar metrics on the device; read them back every N
    calls."""

    def __init__(self, flush_every: int = 50):
        self.flush_every = flush_every
        self._sums: dict = {}
        self._count = 0
        self.history: list[dict] = []

    def add(self, metrics: dict) -> dict | None:
        for k, v in metrics.items():
            self._sums[k] = self._sums.get(k, 0.0) + v
        self._count += 1
        if self._count >= self.flush_every:
            out = {k: float(v) / self._count for k, v in self._sums.items()}
            self.history.append(out)
            self._sums = {}
            self._count = 0
            return out
        return None
