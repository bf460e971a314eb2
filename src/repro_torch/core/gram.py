"""Gram-matrix vector volume and the cross-modal contrastive losses (port
of ``repro.core.gram``; paper Eq. 5-8, 11).

``V({v_i}) = sqrt(det(G))`` with ``G`` the Gram of the normalized rows.
Missing modalities are masked exactly: absent rows and columns of G become
identity, so the volume is that of the present subset.  :func:`log_volume`
goes through ``ops.gram_log_volume`` (kernel D on the card), and
:func:`contrastive_loss` stacks all 2*(1+U) candidate sets of one call
on the batch axis, so the kernel launches once per call (forward) and once
in the backward.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import ops
from repro_torch.kernels.gram_volume import gram_log_volume_plain


def gram_matrix(vs, mask: Optional[torch.Tensor] = None):
    """vs: (..., k, d) -> masked Gram (..., k, k) in f32."""
    v = vs.float()
    v = v * torch.rsqrt(torch.sum(v * v, dim=-1, keepdim=True) + 1e-12)
    g = torch.einsum("...kd,...ld->...kl", v, v)
    if mask is not None:
        eye = torch.eye(vs.shape[-2], dtype=torch.float32, device=vs.device)
        g = torch.where(mask[..., :, None] & mask[..., None, :], g, eye)
    return g


def log_volume(vs, mask: Optional[torch.Tensor] = None, eps: float = 1e-5):
    """log V = 0.5 * logdet(G + eps I).  vs (B, k, d) -> (B,) f32 through
    the kernel's wrapper; other ranks take the plain formula."""
    if mask is None:
        mask = torch.ones(vs.shape[:-1], dtype=torch.bool, device=vs.device)
    if vs.dim() != 3:
        return gram_log_volume_plain(vs, mask, eps)
    return ops.gram_log_volume(vs.contiguous(), mask.contiguous(), eps)


def _candidate_sets(anchor, mods, mask, n_negatives: int, roll_target: str):
    """The positive set and U in-batch negative sets, each
    (vs (B, 1+M, d), mask (B, 1+M)); column 0 of the volumes is the
    positive.  ``roll_target`` "mods" (O2A, Eq. 7) replaces the modality
    set by other samples', "anchor" (A2O, Eq. 8) the anchor."""
    B = anchor.shape[0]
    U = max(1, min(n_negatives, B - 1))
    ones = torch.ones((B, 1), dtype=torch.bool, device=anchor.device)

    def one(a, m, mk):
        return (torch.cat([a[:, None, :], m], dim=1),
                torch.cat([ones, mk], dim=1))

    sets = [one(anchor, mods, mask)]
    for u in range(1, U + 1):
        if roll_target == "mods":
            sets.append(one(anchor, torch.roll(mods, u, 0),
                            torch.roll(mask, u, 0)))
        else:
            sets.append(one(torch.roll(anchor, u, 0), mods, mask))
    return sets


def _candidate_volumes(anchor, mods, mask, n_negatives: int,
                       roll_target: str):
    """Volumes (B, 1 + U) of :func:`_candidate_sets`, one call each."""
    return torch.stack([log_volume(v, m) for v, m in _candidate_sets(
        anchor, mods, mask, n_negatives, roll_target)], dim=-1)


def contrastive_loss(anchor, mods, mask, n_negatives: int = 8):
    """Symmetric CCL loss ½(L^O2A + L^A2O) (Eq. 11's contrastive term):
    InfoNCE over negated volumes.  anchor (B, d), mods (B, M, d), mask
    (B, M) bool.  Both sides' 2*(1+U) candidate sets go through ONE
    log-volume call."""
    B = anchor.shape[0]
    sets = (_candidate_sets(anchor, mods, mask, n_negatives, "mods")
            + _candidate_sets(anchor, mods, mask, n_negatives, "anchor"))
    vs = torch.cat([v for v, _ in sets], dim=0)
    mk = torch.cat([m for _, m in sets], dim=0)
    lv = log_volume(vs, mk).reshape(len(sets), B)       # (2(1+U), B)
    n = len(sets) // 2
    losses = []
    for side in (lv[:n], lv[n:]):
        logits = -side.t()                               # (B, 1+U)
        losses.append(-torch.log_softmax(logits, dim=-1)[:, 0])
    return 0.5 * (torch.mean(losses[0]) + torch.mean(losses[1]))


def pairwise_cosine_loss(anchor, mods, mask, n_negatives: int = 8,
                         temperature: float = 0.1):
    """The prior-work alternative (§3.1): mean per-modality pairwise cosine
    InfoNCE against the anchor (the ``ccl_score="cosine"`` ablation)."""
    B, M, _ = mods.shape
    U = max(1, min(n_negatives, B - 1))

    def norm(v):
        return v * torch.rsqrt(torch.sum(v * v, -1, keepdim=True) + 1e-12)

    a = norm(anchor.float())
    h = norm(mods.float())
    sims = [torch.einsum("bd,bmd->bm", a, h)]
    for u in range(1, U + 1):
        sims.append(torch.einsum("bd,bmd->bm", a, torch.roll(h, u, 0)))
    logits = torch.stack(sims, dim=-1) / temperature
    nll = -torch.log_softmax(logits, dim=-1)[..., 0]
    w = mask.float()
    return torch.sum(nll * w) / torch.clamp(torch.sum(w), min=1.0)
