"""Ms an update in shuffle + SGD (``train/ppo.py`` ``update_fn``): the
learner's "shuffle + SGD" stage event."""
import statistics


def read(ctx):
    ms = ctx["spans"]()["shuffle + SGD"]
    return statistics.fmean(ms) if ms else None
