"""Round loop (``core/federated.py``: anchors, MMA, the wire, the
delivery, Python): each traced round's span less the step spans inside
it, mean ms a round."""
from bench.tracing import round_rest_seconds


def read(ctx):
    rest = round_rest_seconds(ctx)
    return 1e3 * sum(rest) / len(rest) if rest else None
