"""CCL (cross-modal contrastive learning, §3.1) and AMT (adaptive
multimodal tuning, §3.2) losses and the device-side local step (port of
``repro.core.ccl``).

f_ccl (Eq. 11): L = L_lb(D') + ½(L^A2O + L^O2A)  — public data, with anchor
f_amt (Eq. 12): L = L_lb(D)                      — private data
"""
from __future__ import annotations

from typing import Callable, Dict, Optional

import torch

from repro_torch.core import connector as conn
from repro_torch.core import lora
from repro_torch.core.connector import init_unified
from repro_torch.core.gram import contrastive_loss, pairwise_cosine_loss
from repro_torch.optim.adamw import Optimizer, apply_updates

__all__ = ["init_unified", "mlecs_loss", "make_local_step", "server_anchors",
           "grads_of"]


def mlecs_loss(params, bundle, batch: Dict,
               anchor: Optional[torch.Tensor] = None,
               ccl_weight: float = 0.5, n_negatives: int = 8,
               ccl_score: str = "volume"):
    """The paper's device loss: f_ccl with ``anchor`` (server-fused
    omni-modal reps), f_amt with ``ccl_weight=0``.  Without an anchor the
    model's own fused representation anchors.  Returns
    (loss, (metrics, fused))."""
    cfg = bundle.cfg
    fused = None
    if cfg.n_modalities > 0 and "modality_feats" in batch:
        soft, mods, fused = conn.connector_prefix(
            params["connector"], cfg, batch["modality_feats"],
            batch["modality_mask"])
        batch = dict(batch, prefix_embeds=soft)
        loss, metrics = bundle.lm_loss(params, batch)
        if ccl_weight > 0.0:
            anc = anchor if anchor is not None else fused
            score = (pairwise_cosine_loss if ccl_score == "cosine"
                     else contrastive_loss)
            cl = score(anc, mods, batch["modality_mask"], n_negatives)
            loss = loss + ccl_weight * 2.0 * cl * 0.5   # ½(O2A+A2O) inside
            metrics = dict(metrics, ccl=cl)
    else:
        loss, metrics = bundle.lm_loss(params, batch)
    metrics = dict(metrics, loss=loss)
    return loss, (metrics, fused)


def grads_of(loss, train: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """d loss / d train as a flat dict (zeros for leaves the loss does not
    reach, as ``jax.grad`` gives)."""
    keys = list(train)
    got = torch.autograd.grad(loss, [train[k] for k in keys],
                              allow_unused=True)
    return {k: torch.zeros_like(train[k]) if g is None else g
            for k, g in zip(keys, got)}


def make_local_step(bundle, optimizer: Optimizer,
                    trainable: Callable[[str], bool] = lora.default_trainable,
                    ccl_weight: float = 0.5, n_negatives: int = 8,
                    with_anchor: bool = True, prox_weight: float = 0.0,
                    ccl_score: str = "volume"):
    """One device-side step over the trainable subset only: gradients of
    the loss with respect to the flat trainable dict (LoRA + connector)
    through ``torch.autograd.grad``, then AdamW on that dict.  The frozen
    leaves are shared with the input tree and never written.

    ``prox_weight`` adds μ/2·||t - t_global||² toward ``global_ref`` (the
    last distributed global parameters; FedProx-style)."""

    def step(params, opt_state, batch, anchor=None, global_ref=None):
        train = {k: v.detach().requires_grad_(True)
                 for k, v in lora.partition(params, trainable).items()}
        full = lora.combine(params, train)
        loss, (metrics, _) = mlecs_loss(
            full, bundle, batch, anchor=anchor if with_anchor else None,
            ccl_weight=ccl_weight, n_negatives=n_negatives,
            ccl_score=ccl_score)
        if prox_weight > 0.0 and global_ref is not None:
            prox = sum(torch.sum((a.float() - global_ref[k].float()) ** 2)
                       for k, a in train.items() if k in global_ref)
            loss = loss + 0.5 * prox_weight * prox
        grads = grads_of(loss, train)
        train = {k: v.detach() for k, v in train.items()}
        updates, opt_state = optimizer.update(grads, opt_state, train)
        params = lora.combine(params, apply_updates(train, updates))
        return params, opt_state, {k: v.detach() for k, v in metrics.items()}

    return step


def server_anchors(params, bundle, batch: Dict):
    """Fused omni-modal representations s' from the server's unified model
    (Alg. 1 line 3), distributed to devices as CCL anchors."""
    cfg = bundle.cfg
    h = conn.project_modalities(params["connector"], cfg,
                                batch["modality_feats"],
                                batch["modality_mask"])
    return conn.fuse(params["connector"], cfg, h, batch["modality_mask"])
