"""Device: the share of the traced window in which no kernel, memcpy or
memset ran (1 - the union of their intervals / the window)."""


def read(ctx):
    if not ctx["busy_s"] or not ctx["window_s"]:
        return None
    return 1.0 - ctx["busy_s"] / ctx["window_s"]
