"""Kernel B′ (``kernels/flash_attention.py``'s backward: one dQ and one
dK / dV kernel a launch, on either route): the bound time of the
launches the traced rounds plan (``bench/ops.py``) over their device
time, in %; None where the trace holds another number of either kernel
than the plan."""
from bench.tracing import planned_roofline


def read(ctx):
    return planned_roofline(ctx, "flash_attention_backward",
                            ("flash_attention_bwd_dq",
                             "flash_attention_bwd_dkv"))
