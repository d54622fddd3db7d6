"""Synchronising CUDA calls an update (``utils/profiling.py``: the host
syncs counted in the spans of ``ppo.update``), the mean over the traced
run's unprofiled updates; None where none were counted (no card) or the
program keeps no spans or its full store dropped any."""
import statistics

from balatro_gym_tpu_torch.utils import profiling as P
from benchmark.harness.runner import LABELLED_STEPS


def read(ctx):
    if not hasattr(P, "trees") or P.TRACER.dropped:    # no spans, or some lost
        return None
    n = ctx["spec"]["traffic"]["traced_steps"]
    ups = [t for t in P.trees("ppo.update")[-(2 * n + LABELLED_STEPS):]
           if not t["span"]["profiled"]]
    counts = [t["syncs"] for t in ups if t["syncs"] is not None]
    return statistics.fmean(counts) if counts else None
