"""The whole update's share of the card's bf16 peak, in %: the policy
net's FLOP of the traced run's untraced updates (counted from its widths)
over their host time times the peak."""
from benchmark.harness import yardstick as Y


def read(ctx):
    return 100.0 * ctx["flops"] / (ctx["window_s"] * Y.BF16_FLOPS)
