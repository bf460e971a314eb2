"""Kernel C in its grouped form (``kernels/lora_matmul.py``, one launch
for a cohort: grid z = its clients): the bound time of the launches the
traced rounds plan (``bench/ops.py``) over the device time of C's kernels
launched with more than one group, in %; None where the trace holds
another number of such launches than the plan."""
from bench.tracing import planned_roofline


def read(ctx):
    return planned_roofline(ctx, "lora_matmul_grouped",
                            ("lora_matmul_kernel",), grid_z_over=1)
