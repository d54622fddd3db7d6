"""K4 (``fused_rollout_kernel``): its bound (``harness/int_yardstick.py``:
integer ops over K6's measured INT32 rate, which binds, or bytes over the
HBM rate) over its median profiled time, in %."""
from benchmark.harness import int_yardstick as IY
from benchmark.harness import trace as T


def read(ctx):
    t = T.kernel_median_s(ctx["trace"], "fused_rollout_kernel")
    return IY.k4_roofline_pct(ctx["n_envs"], ctx["n_steps"], t)
