"""Ms an update in the fused collection (``train/ppo.py`` ``rollout``: K3b,
policy, sampler, K3a, stores): the learner's "collection" stage event."""
import statistics


def read(ctx):
    ms = ctx["spans"]()["collection"]
    return statistics.fmean(ms) if ms else None
