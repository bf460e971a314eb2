"""Device, whole round: the round's model FLOPs (``bench/ops.py``:
forward and backward through the frozen backbones, LoRA's and the
connector's weight gradients, attention's and the SSD's quadratic terms;
no recompute) over the traced rounds' time at the bf16 peak, in %."""
from bench.ops import PEAK_BF16


def read(ctx):
    if not ctx["rounds"] or not ctx["busy_s"]:
        return None
    return 100.0 * ctx["model_flops_round"] * ctx["rounds"] / (
        ctx["window_s"] * PEAK_BF16)
