"""The federation's initial weights, drawn from the run's seed on the
device with one ``torch.Generator``, one call per stacked leaf, in the
dtype they are served in.

Both sides get the same draw: the program as its ``init_state`` (flat
numpy leaves, bf16 as uint16 bit patterns), the reference as tensors,
drawn again after the program has been freed.  Every cohort has one
frozen backbone; every client its own LoRA and connector leaves (LoRA B
zero); the server SLM and LLM are draws of their own.
"""
from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from bench.reference.model import is_trainable, param_layout, ssm_heads

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def _draw(gen, kind, shape, std, dtype, m, lead=()):
    dev = gen.device
    shape = (*lead, *shape)
    if kind == "normal":
        t = torch.randn(shape, generator=gen, device=dev, dtype=dtype)
        return t.mul_(std)
    if kind == "zeros":
        return torch.zeros(shape, dtype=dtype, device=dev)
    if kind == "ones":
        return torch.ones(shape, dtype=dtype, device=dev)
    if kind == "zeros32":
        return torch.zeros(shape, dtype=torch.float32, device=dev)
    if kind == "ones32":
        return torch.ones(shape, dtype=torch.float32, device=dev)
    if kind == "a_log":
        row = torch.log(torch.linspace(1.0, 16.0, ssm_heads(m),
                                       dtype=torch.float32, device=dev))
        return row.expand(shape).contiguous()
    raise ValueError(f"unknown init {kind!r}")


def _model(gen, m: Dict, keys=None, lead=()) -> Dict[str, torch.Tensor]:
    dtype = _DTYPES[m["dtype"]]
    layout = param_layout(m)
    return {k: _draw(gen, *layout[k], dtype, m, lead)
            for k in sorted(layout) if keys is None or keys(k)}


def draw(seed: int, models: Dict, cohort_sizes: List[int], device
         ) -> Dict:
    """{"cohort_bases": [flat per cohort], "personal_stacks": [per cohort
    {key: (n_clients, ...)}], "server_slm": flat, "server_llm": flat}: the
    backbone of each cohort (its trainable leaves those of its first
    client), its clients' trainable leaves (one draw a leaf for the
    cohort), then the server SLM and LLM, in that order from one
    generator seeded with ``seed``."""
    gen = torch.Generator(device=device).manual_seed(int(seed))
    bases, personal = [], []
    for m, n in zip(models["edge"], cohort_sizes):
        base = _model(gen, m, lambda k: not is_trainable(k))
        stacked = _model(gen, m, is_trainable, lead=(n,))
        base.update({k: v[0] for k, v in stacked.items()})
        bases.append(base)
        personal.append(stacked)
    return {"cohort_bases": bases, "personal_stacks": personal,
            "server_slm": _model(gen, models["server_slm"]),
            "server_llm": _model(gen, models["server_llm"])}


def to_numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach().contiguous().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16)
    return t.numpy()


def init_state(w: Dict) -> Dict:
    """The draw as the program's ``init_state``: flat numpy trees (each
    cohort's stacks copied to the host once, a client's leaves views of
    them)."""
    def flat(tree):
        return {k: to_numpy(v) for k, v in tree.items()}
    clients = []
    for st in w["personal_stacks"]:
        host = flat(st)
        n = next(iter(host.values())).shape[0]
        clients += [{k: v[i] for k, v in host.items()} for i in range(n)]
    return {"cohort_bases": [flat(b) for b in w["cohort_bases"]],
            "personal": clients,
            "server_slm": flat(w["server_slm"]),
            "server_llm": flat(w["server_llm"])}
