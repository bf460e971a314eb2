"""What the kernels with a tensor-core route and an FMA route share: the
16-byte alignment their tensor-core copies need, and the rule for a
route asked for by the caller."""
from __future__ import annotations


def aligned16(t) -> bool:
    """Whether the tensor's first element lies at a 16-byte aligned offset
    of its storage (reads only metadata: CPU or meta tensors do)."""
    return t.storage_offset() * t.element_size() % 16 == 0


def pick(chosen: str, route: str | None) -> str:
    """``route`` if given, else the route function's ``chosen`` one.
    "fma" takes every input; a tensor-core route only the inputs its
    route function gives it: anything else raises before any launch."""
    if route not in (None, "fma", chosen):
        raise ValueError(f"route {route!r} cannot take these inputs")
    return route or chosen
