"""Server step (``FederatedRunner._make_seccl_step``: SE-CCL on the
server SLM and LLM): ms a step, mean over the traced window."""
from bench.tracing import span_seconds


def read(ctx):
    s = span_seconds(ctx, "server_step")
    return 1e3 * sum(s) / len(s) if s else None
