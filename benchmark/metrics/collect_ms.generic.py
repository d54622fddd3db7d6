"""Ms an update in the generic collection (``observe_vector``,
``action_mask``, policy, ``categorical``, ``step_autoreset``): the
learner's "collection" stage event."""
import statistics


def read(ctx):
    ms = ctx["spans"]()["collection"]
    return statistics.fmean(ms) if ms else None
