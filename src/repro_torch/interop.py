"""Carries parameters between the reference and the port through numpy.

The exchange format is a flat ``{path: np.ndarray}`` dict keyed by the
'/'-joined paths of the reference's ``core/lora.py:path_str``
(``layers/attn/wq``), leaves in the reference's layout ((in, out) weights,
layers stacked on axis 0).  bfloat16 travels as its ``uint16`` bit pattern
and is reinterpreted with ``.view``, never through a float round trip.

Every floating leaf has the tree's dtype, with one named exception: the
SSM's ``A_log``, ``dt_bias`` and ``D_skip`` stay float32 inside a bf16
model (``repro.models.ssm.init_ssm`` keeps them so on purpose).
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from repro_torch.core.lora import flatten, unflatten

# leaves (by the last component of their path) that stay float32 in a tree
# of any dtype: the SSM's decay, step bias and skip
F32_LEAVES = ("A_log", "dt_bias", "D_skip")


def params_from_numpy(flat: Dict[str, np.ndarray], device="cuda",
                      dtype: torch.dtype = torch.bfloat16) -> dict:
    """Flat numpy leaves -> nested dict of tensors on ``device``.

    ``dtype`` is the parameter dtype of the tree: a ``uint16`` leaf is a
    bfloat16 bit pattern when ``dtype`` is bfloat16; every floating leaf
    must already be in ``dtype`` (no silent casts), except a float32 leaf
    named in :data:`F32_LEAVES`."""
    return unflatten(leaves_from_numpy(flat, device, dtype))


def leaves_from_numpy(flat: Dict[str, np.ndarray], device="cuda",
                      dtype: torch.dtype = torch.bfloat16
                      ) -> Dict[str, torch.Tensor]:
    """:func:`params_from_numpy` without the nesting: a flat dict of
    tensors, keyed as given."""
    out = {}
    for path, arr in flat.items():
        arr = np.array(arr)          # a writable copy the tensor owns
        if arr.dtype == np.uint16 and dtype == torch.bfloat16:
            t = torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
        else:
            t = torch.from_numpy(arr)
            if t.is_floating_point() and t.dtype != dtype and not (
                    t.dtype == torch.float32
                    and path.rsplit("/", 1)[-1] in F32_LEAVES):
                raise TypeError(f"{path}: {t.dtype} leaf in a {dtype} tree")
        out[path] = t.to(device)
    return out


def params_to_numpy(params: dict) -> Dict[str, np.ndarray]:
    """Nested dict of tensors -> flat numpy leaves (bfloat16 as uint16)."""
    out = {}
    for path, t in flatten(params).items():
        t = t.detach().cpu().contiguous()
        if t.dtype == torch.bfloat16:
            out[path] = t.view(torch.int16).numpy().view(np.uint16)
        else:
            out[path] = t.numpy()
    return out
