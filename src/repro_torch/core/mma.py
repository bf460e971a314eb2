"""MMA — modality-aware model aggregation (§3.3, Eq. 13), mean path (port
of the plain parts of ``repro.core.mma``).

Sums run in float32, left to right over the clients, as the reference's
scan does; the result is cast to the upload dtype once."""
from __future__ import annotations

from typing import Dict, List, Sequence

import torch


def aggregation_weights(n_modalities: Sequence[int],
                        device="cpu") -> torch.Tensor:
    """w_j = |M_j| / sum_i |M_i|  (Eq. 13)."""
    m = torch.as_tensor(list(n_modalities), dtype=torch.float32,
                        device=device)
    return m / torch.clamp(torch.sum(m), min=1.0)


def aggregate(uploads: List[Dict[str, torch.Tensor]],
              weights) -> Dict[str, torch.Tensor]:
    """Weighted average of client flat dicts (f32 sum, cast once)."""
    acc = partial_aggregate_stacked(
        {k: torch.stack([u[k] for u in uploads]) for k in uploads[0]},
        weights)
    return {k: acc[k].to(uploads[0][k].dtype) for k in acc}


def partial_aggregate_stacked(uploads: Dict[str, torch.Tensor],
                              weights) -> Dict[str, torch.Tensor]:
    """Unnormalized f32 sums Σ_j w_j · u_j[k] over the leading client axis,
    left to right from zero, without the final cast."""
    first = next(iter(uploads.values()))
    w = torch.as_tensor(weights, dtype=torch.float32, device=first.device)
    if w.shape[0] != first.shape[0]:
        raise ValueError(f"{w.shape[0]} weights for {first.shape[0]} clients")
    out = {}
    for k, v in uploads.items():
        acc = torch.zeros(v.shape[1:], dtype=torch.float32, device=v.device)
        for j in range(v.shape[0]):
            acc = acc + w[j] * v[j].float()
        out[k] = acc
    return out


def aggregate_stacked(uploads: Dict[str, torch.Tensor], weights,
                      robust: str = "mean") -> Dict[str, torch.Tensor]:
    """Eq. 13 over client-stacked uploads ``{path: (N, ...)}``: the f32
    partial sums cast to the upload dtype.  Only ``robust="mean"`` is
    ported."""
    if robust != "mean":
        raise NotImplementedError(
            f"robust={robust!r} aggregation is not ported (mean only)")
    acc = partial_aggregate_stacked(uploads, weights)
    return {k: acc[k].to(uploads[k].dtype) for k in uploads}
