"""Share of the traced run's unprofiled updates (%) whose collection
(``train/ppo.py``'s ``ppo.collect`` span) replayed the fused collection's
CUDA graph: a ``ppo.collect.replay`` span inside it. None where the program
keeps no spans or its full store dropped any."""
from balatro_gym_tpu_torch.utils import profiling as P
from benchmark.harness.runner import LABELLED_STEPS


def _replayed(tree) -> bool:
    collect = {s["id"] for s in tree["spans"] if s["name"] == "ppo.collect"}
    return any(s["name"] == "ppo.collect.replay" and s["parent"] in collect
               for s in tree["spans"])


def read(ctx):
    if not hasattr(P, "trees") or P.TRACER.dropped:    # no spans, or some lost
        return None
    n = ctx["spec"]["traffic"]["traced_steps"]
    ups = [t for t in P.trees("ppo.update")[-(2 * n + LABELLED_STEPS):]
           if not t["span"]["profiled"]]
    return 100.0 * sum(map(_replayed, ups)) / len(ups) if ups else None
