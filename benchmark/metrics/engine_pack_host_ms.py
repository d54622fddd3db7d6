"""Host ms an update in the engine's packed-row conversions
(``engine/full_env.py``'s ``engine.pack`` and ``engine.unpack`` spans,
around the observation's K3b and the step's kernels), the mean over the
traced run's unprofiled updates; None where the program keeps no spans
or its full store dropped any."""
import statistics

from balatro_gym_tpu_torch.utils import profiling as P
from benchmark.harness.runner import LABELLED_STEPS


def read(ctx):
    if not hasattr(P, "trees") or P.TRACER.dropped:    # no spans, or some lost
        return None
    n = ctx["spec"]["traffic"]["traced_steps"]
    ups = [t for t in P.trees("ppo.update")[-(2 * n + LABELLED_STEPS):]
           if not t["span"]["profiled"]]
    ms = [t["host_ms"].get("engine.pack", 0.0) + t["host_ms"].get("engine.unpack", 0.0)
          for t in ups if "engine.pack" in t["host_ms"]]
    return statistics.fmean(ms) if ms else None
