"""Synchronising CUDA calls a K4 call (``utils/profiling.py``: the host
syncs counted in the spans of ``sim.call``), the mean over the traced run's
calls; None where none were counted (no card) or the program keeps no such
spans or its full store dropped any."""
import statistics

from balatro_gym_tpu_torch.utils import profiling as P
from benchmark.harness.runner import LABELLED_STEPS


def read(ctx):
    if not hasattr(P, "trees") or P.TRACER.dropped:    # no spans, or some lost
        return None
    n = ctx["spec"]["traffic"]["traced_steps"]
    counts = [t["syncs"] for t in P.trees("sim.call")[-(2 * n + LABELLED_STEPS):]
              if t["syncs"] is not None]
    return statistics.fmean(counts) if counts else None
