"""LoRA parameter handling (port of the serving part of ``repro.core.lora``).

Params are nested dicts of tensors.  Their flat form is keyed by the
'/'-joined paths of the reference's ``path_str`` (``layers/attn/wq``), the
key space :mod:`repro_torch.interop` carries weights across in.
"""
from __future__ import annotations

from typing import Dict, Sequence

import torch


def path_str(path: Sequence) -> str:
    """'/'-join a sequence of dict keys (the reference's path format)."""
    return "/".join(str(p) for p in path)


def flatten(tree: dict, prefix: Sequence = ()) -> Dict[str, torch.Tensor]:
    """Nested dict of tensors -> {path_str: tensor}."""
    out: Dict[str, torch.Tensor] = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(flatten(v, (*prefix, k)))
        else:
            out[path_str((*prefix, k))] = v
    return out


def unflatten(flat: Dict[str, torch.Tensor]) -> dict:
    """Inverse of :func:`flatten`."""
    tree: dict = {}
    for path, leaf in flat.items():
        *parents, last = path.split("/")
        node = tree
        for p in parents:
            node = node.setdefault(p, {})
        node[last] = leaf
    return tree


def is_lora_leaf(path: str) -> bool:
    """True for LoRA adapter leaves (``*_lora_a`` / ``*_lora_b``)."""
    return "_lora_a" in path or "_lora_b" in path


def merge_lora(params: dict, cfg) -> dict:
    """Fold LoRA updates into the frozen weights (W' = W + (α/r) A B),
    summed in float32 and cast back, so decode pays no adapter cost.

    The adapter leaves are dropped from the result.  The reference keeps
    them, and its ``proj`` then adds (α/r) A B a second time on top of the
    merged weight (ROADMAP, faults found against the reference); without
    them ``proj`` computes exactly W' x."""
    flat = flatten(params)
    scale = cfg.lora_alpha / cfg.lora_rank
    new = {}
    for s, leaf in flat.items():
        if is_lora_leaf(s):
            continue
        a = flat.get(s + "_lora_a")
        if a is not None:
            b = flat[s + "_lora_b"]
            leaf = (leaf.float() + scale * (a.float() @ b.float())
                    ).to(leaf.dtype)
        new[s] = leaf
    return unflatten(new)
