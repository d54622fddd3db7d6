"""The card's idle share of a rollout cell's steps, in %: 1 - the union of
device-busy intervals of the card-traced steps over the host time of as
many untraced steps (the profiler slows a host-bound step, not the card's
work); the same pair the result's ``device`` block gives."""


def read(ctx):
    return 100.0 * (1.0 - ctx["trace"]["busy_s"] / ctx["window_s"])
