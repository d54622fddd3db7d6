"""K3a (``policy_step_kernel``): its byte bound over its median profiled
time, in %."""
from benchmark.harness import trace as T
from benchmark.harness import yardstick as Y


def read(ctx):
    t = T.kernel_median_s(ctx["trace"], "policy_step_kernel")
    return Y.roofline_pct(Y.K3A_BYTES * ctx["n_envs"], t)
