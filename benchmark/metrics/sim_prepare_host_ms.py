"""Host ms of a K4 call until the kernel is enqueued
(``ops/fused_rollout.py``: from the start of the ``sim.call`` span to the
end of its ``sim.launch``: the joker coefficients, the outputs' allocation
and the launch), the median over the traced run's calls (all profiled: a
sim call keeps spans only under the profiler); None where the program keeps
no such spans or its full store dropped any."""
import statistics

from balatro_gym_tpu_torch.utils import profiling as P
from benchmark.harness.runner import LABELLED_STEPS


def read(ctx):
    if not hasattr(P, "trees") or P.TRACER.dropped:    # no spans, or some lost
        return None
    n = ctx["spec"]["traffic"]["traced_steps"]
    ms = []
    for t in P.trees("sim.call")[-(2 * n + LABELLED_STEPS):]:
        ends = [s["end_ns"] for s in t["spans"] if s["name"] == "sim.launch"]
        if ends:
            ms.append((ends[-1] - t["span"]["start_ns"]) * 1e-6)
    return statistics.median(ms) if ms else None
