"""Host ms a call of the engine's ``step_autoreset`` (``engine/full_env.py``),
from the wrapper the benchmark passes in through the env hooks."""


def read(ctx):
    c = ctx["counters"]
    n = c["step_autoreset_calls"]
    return 1e3 * c["step_autoreset_host_s"] / n if n else None
