"""Host ms an update in the collection (``train/ppo.py``'s ``ppo.collect``
span: the key split, the rollout's enqueue, the stores), the mean over the
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
    ms = [t["host_ms"]["ppo.collect"] for t in ups if "ppo.collect" in t["host_ms"]]
    return statistics.fmean(ms) if ms else None
