"""Client steps (``core/ccl.py``: the stacked CCL and AMT steps of every
cohort): ms a step, mean over the traced window, each step bracketed by
``synchronize``."""
from bench.tracing import span_seconds


def read(ctx):
    s = span_seconds(ctx, "client_step")
    return 1e3 * sum(s) / len(s) if s else None
