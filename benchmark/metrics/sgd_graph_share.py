"""Share of the traced run's unprofiled updates (%) whose shuffle + SGD
(``train/ppo.py``'s ``ppo.sgd`` span) replayed the stage's CUDA graph: a
``ppo.sgd.replay`` span inside it. None where the program keeps no spans or
its full store dropped any."""
from balatro_gym_tpu_torch.utils import profiling as P
from benchmark.harness.runner import LABELLED_STEPS


def _replayed(tree) -> bool:
    sgd = {s["id"] for s in tree["spans"] if s["name"] == "ppo.sgd"}
    return any(s["name"] == "ppo.sgd.replay" and s["parent"] in sgd for s in tree["spans"])


def read(ctx):
    if not hasattr(P, "trees") or P.TRACER.dropped:    # no spans, or some lost
        return None
    n = ctx["spec"]["traffic"]["traced_steps"]
    ups = [t for t in P.trees("ppo.update")[-(2 * n + LABELLED_STEPS):]
           if not t["span"]["profiled"]]
    return 100.0 * sum(map(_replayed, ups)) / len(ups) if ups else None
