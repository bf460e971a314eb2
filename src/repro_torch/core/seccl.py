"""SE-CCL — SLM-enhanced cross-modal contrastive learning (§3.4), and the
evaluation of a unified model (port of ``repro.core.seccl``).

Bidirectional knowledge transfer between the server SLM and LLM through a
pooled KL on output logits (Eq. 14): sequence and vocab axes are
average-pooled to the smaller of the two, softmaxes are temperature-
smoothed and f32.
"""
from __future__ import annotations

from typing import Dict

import torch

from repro_torch.core.connector import connector_prefix


def _pool_axis(x, target: int, axis: int):
    """Average-pool dimension ``axis`` down to exactly ``target`` bins
    (crop to a multiple of ``target``, then mean)."""
    n = x.shape[axis]
    if n == target:
        return x
    if n < target:
        raise ValueError(f"cannot pool {n} bins up to {target}")
    crop = (n // target) * target
    x = x.narrow(axis, 0, crop)
    shape = list(x.shape)
    shape[axis:axis + 1] = [target, crop // target]
    return torch.mean(x.reshape(shape), dim=axis + 1)


def pooled_kl(student_logits, teacher_logits, temperature: float = 2.0):
    """Eq. 14: sum over pooled positions of KL(teacher || student), mean
    over the batch.  logits (B, S, V) with possibly different S and V."""
    S = min(student_logits.shape[1], teacher_logits.shape[1])
    V = min(student_logits.shape[2], teacher_logits.shape[2])
    s = _pool_axis(_pool_axis(student_logits.float(), S, 1), V, 2)
    t = _pool_axis(_pool_axis(teacher_logits.float(), S, 1), V, 2)
    s = s / temperature
    t = t / temperature
    logp_s = torch.log_softmax(s, dim=-1)
    p_t = torch.softmax(t, dim=-1)
    logp_t = torch.log_softmax(t, dim=-1)
    kl = torch.sum(p_t * (logp_t - logp_s), dim=-1)        # (B, S)
    return torch.mean(torch.sum(kl, dim=-1))


def kt_loss(y_student, y_teacher, temperature: float = 2.0):
    """KT with the teacher detached (each model's loss treats the other as
    fixed within the step, per Eq. 15/16)."""
    return pooled_kl(y_student, y_teacher.detach(), temperature)


# ---------------------------------------------------------------------------
# evaluation (test CE + template accuracy) of a unified model

EVAL_SUM_KEYS = ("ce_sum", "hits", "weight")


def make_eval_step(bundle):
    """``step(params, batch) -> {ce_sum, hits, weight}``: the masked sums of
    one eval batch (``row_valid`` weighs each row, so padding rows add
    exactly zero), f32 scalars, in one forward pass without autograd."""
    cfg = bundle.cfg

    @torch.no_grad()
    def step(params, batch: Dict) -> Dict[str, torch.Tensor]:
        b = dict(batch)
        row_valid = b.pop("row_valid", None)
        if cfg.n_modalities > 0 and "modality_feats" in b:
            soft, _, _ = connector_prefix(params["connector"], cfg,
                                          b["modality_feats"],
                                          b["modality_mask"])
            b["prefix_embeds"] = soft
        logits, _ = bundle.logits(params, b)
        tokens = b["tokens"]
        S = tokens.shape[1]
        P = logits.shape[1] - S
        pred = logits[:, P:P + S - 1].float()
        targets = tokens[:, 1:].long()
        logp = torch.log_softmax(pred, dim=-1)
        nll = -torch.gather(logp, -1, targets[..., None])[..., 0]
        w = b["loss_mask"][:, 1:].float()
        if row_valid is not None:
            w = w * row_valid.float()[:, None]
        hit = (torch.argmax(pred, dim=-1) == targets).float()
        return {"ce_sum": torch.sum(nll * w), "hits": torch.sum(hit * w),
                "weight": torch.sum(w)}

    return step


def metrics_from_sums(sums: Dict) -> Dict[str, float]:
    """``ce`` (mean token NLL over valid positions) and ``acc`` (template
    accuracy over the same positions) from one model's eval sums."""
    w = max(float(sums["weight"]), 1.0)
    return {"ce": float(sums["ce_sum"]) / w, "acc": float(sums["hits"]) / w}
