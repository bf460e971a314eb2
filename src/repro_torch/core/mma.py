"""MMA — modality-aware model aggregation (§3.3, Eq. 13): port of
``repro.core.mma`` (the host and cohort forms).

Sums run in float32, left to right over the clients, as the reference's
scan does; the result is cast to the upload dtype once.  Every reduction
takes an optional ``present`` survivor mask: absent clients weigh exactly
0 and the mass renormalizes over the survivors.  ``robust`` selects the
reduction: ``"mean"`` (Eq. 13), ``"trimmed_mean"`` (coordinate-wise
masked trimming, then the Eq. 13 weights renormalized over the kept mass)
or ``"norm_clip"`` (each survivor's global L2 norm clipped to the masked
lower median).  Across cohorts, :func:`combine_cohort_partials` sums the
cohorts' f32 partials per shared key in cohort order, and
:func:`robust_combine_cohorts` concatenates their raw uploads per shared
key (order statistics cannot be taken over partial sums).
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.core.spec import ROBUST


def _bcast(m: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Reshape a per-client (N,) vector to broadcast over leaf ``v``."""
    return m.reshape(m.shape[:1] + (1,) * (v.dim() - 1))


def _f32(x, device=None) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.to(device=device or x.device, dtype=torch.float32)
    return torch.as_tensor(np.array(x, np.float32), device=device)


def aggregation_weights(n_modalities: Sequence[int], present=None,
                        device="cpu") -> torch.Tensor:
    """w_j = |M_j| / sum_i |M_i|  (Eq. 13); with ``present`` the mass is
    restricted to the surviving clients."""
    m = torch.as_tensor(list(n_modalities), dtype=torch.float32,
                        device=device)
    if present is not None:
        m = m * _f32(present, m.device)
    return m / torch.clamp(torch.sum(m), min=1.0)


def sampled_weights(n_modalities: Sequence[int], sampled: Sequence[int],
                    present=None, device="cpu") -> torch.Tensor:
    """Eq. 13 weights renormalized over a sampled participant subset:
    ``m_j / Σ_{i in sampled} m_i`` over the global ids ``sampled`` (the
    working set's order), with ``present`` (over the sampled positions)
    composing the survivor renormalization on top.  With the whole
    population sampled in id order this is :func:`aggregation_weights`
    bit for bit."""
    m = np.asarray(n_modalities)[np.asarray(sampled, np.int64)]
    return aggregation_weights(m.tolist(), present, device)


def renormalize(weights, present) -> torch.Tensor:
    """``w*present / Σ(w*present)`` (all zeros, not NaN, when the
    surviving mass is 0)."""
    w = _f32(weights)
    w = w * _f32(present, w.device)
    return w / torch.clamp(torch.sum(w), min=1e-12)


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
    w = _f32(weights, first.device)
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
                      robust: str = "mean", present=None,
                      trim_frac: float = 0.2, clip: Optional[float] = None
                      ) -> Dict[str, torch.Tensor]:
    """Eq. 13 over client-stacked uploads ``{path: (N, ...)}``, cast to
    the upload dtype.  ``present`` masks out absent clients (mass
    renormalized over the survivors); ``robust`` picks the reduction:

    * ``"mean"`` — the weighted f32 sum (``present=None`` is the legacy
      path bit for bit);
    * ``"trimmed_mean"`` — ``k = min(⌊trim_frac·m⌋, ⌊(m−1)/2⌋)`` values
      dropped from each end of the m survivors per coordinate, then the
      weights renormalized over the kept mass;
    * ``"norm_clip"`` — weights ``w_j·min(1, τ/‖u_j‖)`` with τ the masked
      lower median of the survivors' global norms (or ``clip``).
    """
    if robust == "mean":
        if present is not None:
            weights = renormalize(weights, present)
        acc = partial_aggregate_stacked(uploads, weights)
        return {k: acc[k].to(uploads[k].dtype) for k in uploads}
    first = next(iter(uploads.values()))
    n, dev = first.shape[0], first.device
    pres = (torch.ones((n,), dtype=torch.float32, device=dev)
            if present is None else _f32(present, dev))
    w = _f32(weights, dev) * pres
    if robust == "trimmed_mean":
        return {k: _masked_trimmed_mean(v, w, pres, trim_frac).to(v.dtype)
                for k, v in uploads.items()}
    if robust == "norm_clip":
        scales = _clip_scales(uploads, pres, clip)
        acc = partial_aggregate_stacked(uploads,
                                        renormalize(w, pres) * scales)
        return {k: acc[k].to(uploads[k].dtype) for k in uploads}
    raise ValueError(f"unknown robust {robust!r}; expected one of {ROBUST}")


def _masked_trimmed_mean(v: torch.Tensor, w: torch.Tensor,
                         pres: torch.Tensor, trim_frac: float
                         ) -> torch.Tensor:
    """Coordinate-wise masked trimmed mean over the leading client axis:
    absent clients sort to +inf (a stable sort: deterministic ties) and
    never enter the kept band ``k <= rank < m-k``; the kept values average
    under the weights renormalized per coordinate by the kept mass."""
    x = v.float()
    pb = _bcast(pres, x) > 0
    m = torch.sum(pres)
    k = torch.minimum(torch.floor(trim_frac * m), torch.floor((m - 1.0) / 2.0))
    order = torch.argsort(torch.where(pb, x, torch.inf), dim=0, stable=True)
    ranks = torch.argsort(order, dim=0, stable=True).float()
    keep = (ranks >= k) & (ranks < m - k) & pb
    wk = _bcast(w, x) * keep
    return torch.sum(x * wk, dim=0) / torch.clamp(torch.sum(wk, dim=0),
                                                  min=1e-12)


def _clip_scales(flat: Dict[str, torch.Tensor], pres: torch.Tensor,
                 clip: Optional[float]) -> torch.Tensor:
    """Per-client factors ``min(1, τ/‖u_j‖)`` over the global L2 norm of
    each client's whole upload, τ the masked lower median of the
    survivors' norms unless ``clip`` is given."""
    sq = None
    for v in flat.values():
        x = v.float()
        s = torch.sum(x * x, dim=tuple(range(1, x.dim())))
        sq = s if sq is None else sq + s
    norms = torch.sqrt(sq)
    if clip is None:
        m = int(torch.sum(pres).item())
        srt = torch.sort(torch.where(pres > 0, norms, torch.inf)).values
        tau = srt[max((m - 1) // 2, 0)]
    else:
        tau = torch.tensor(clip, dtype=torch.float32, device=norms.device)
    return torch.clamp(tau / torch.clamp(norms, min=1e-12), max=1.0)


def _participants(shared_keys: Sequence[Sequence[str]]) -> Dict[str, list]:
    """Per key, the cohorts (in order) that share it."""
    out: Dict[str, list] = {}
    for c, ks in enumerate(shared_keys):
        for k in ks:
            out.setdefault(k, []).append(c)
    return out


def combine_cohort_partials(partials: Sequence[Dict[str, torch.Tensor]],
                            shared_keys: Sequence[Sequence[str]],
                            w_totals: Sequence[float],
                            out_dtypes: Dict) -> Dict[str, torch.Tensor]:
    """Cross-cohort Eq. 13 on the shared-shape key subset:

        agg[k] = ( Σ_{c: k shared} P_c[k] ) / ( Σ_{c: k shared} W_c )

    partials summed in cohort order; ``w_totals`` are the cohorts' (fault-
    masked) weight masses.  A key whose participating mass is 0 this round
    is omitted (the server keeps its value)."""
    out = {}
    for k, cs in sorted(_participants(shared_keys).items()):
        mass = np.float32(sum(float(w_totals[c]) for c in cs))
        if not mass > 0.0:
            continue
        acc = partials[cs[0]][k]
        for c in cs[1:]:
            acc = acc + partials[c][k]
        out[k] = (acc / float(mass)).to(out_dtypes[k])
    return out


def robust_combine_cohorts(uploads: Sequence[Dict[str, torch.Tensor]],
                           weights: Sequence, shared_keys:
                           Sequence[Sequence[str]], out_dtypes: Dict,
                           robust: str, present: Optional[Sequence] = None,
                           trim_frac: float = 0.2,
                           clip: Optional[float] = None
                           ) -> Dict[str, torch.Tensor]:
    """The robust counterpart of :func:`combine_cohort_partials`: per
    shared key, the participating cohorts' RAW stacked uploads are
    concatenated on the client axis (cohort order) and reduced by
    :func:`aggregate_stacked` under their concatenated (globally
    normalized, fault-masked) weights and presence.  ``norm_clip`` clips
    per key here.  Zero-mass keys are omitted."""
    pres = list(present) if present is not None else [None] * len(uploads)
    out = {}
    for k, cs in sorted(_participants(shared_keys).items()):
        cat = torch.cat([uploads[c][k] for c in cs], dim=0)
        wcat = np.concatenate([np.asarray(weights[c], np.float32)
                               for c in cs])
        pcat = np.concatenate([
            np.ones(len(np.asarray(weights[c])), np.float32)
            if pres[c] is None else np.asarray(pres[c], np.float32)
            for c in cs])
        if not float((wcat * pcat).sum()) > 0.0:
            continue
        out[k] = aggregate_stacked(
            {k: cat}, wcat, robust=robust, present=pcat,
            trim_frac=trim_frac, clip=clip)[k].to(out_dtypes[k])
    return out


def mma_psum_weights(modality_counts: torch.Tensor, group=None
                     ) -> torch.Tensor:
    """SPMD weighting: this shard's share of the modality counts across
    the data shards, so that a weighted sum of the shards' gradients is
    Eq. 13 exactly.  ``modality_counts``: (local_batch,) |M_j| of the
    examples this rank owns; ``group`` the data axes' process group (an
    ``all_reduce`` sums the shards' counts), None for one shard.  Returns
    the f32 scalar local / max(total, 1)."""
    local = torch.sum(modality_counts.to(torch.float32))
    total = local
    if group is not None:
        total = local.clone()
        dist.all_reduce(total, group=group)
    return local / torch.clamp(total, min=1.0)
