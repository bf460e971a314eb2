"""Whole round (``FederatedRunner.run_round``): the traced window's wall
seconds on the host's clock over the whole rounds it held, the steps
bracketed by ``synchronize``.  The round is bound by the host's dispatch,
so this follows the host's speed, which drifts from run to run."""


def read(ctx):
    if not ctx["rounds"] or not ctx["window_s"]:
        return None
    return ctx["window_s"] / ctx["rounds"]
