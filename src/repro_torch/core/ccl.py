"""CCL (cross-modal contrastive learning, §3.1) and AMT (adaptive
multimodal tuning, §3.2) losses and the device-side local step (port of
``repro.core.ccl``).

f_ccl (Eq. 11): L = L_lb(D') + ½(L^A2O + L^O2A)  — public data, with anchor
f_amt (Eq. 12): L = L_lb(D)                      — private data

:func:`make_stacked_step` is the step of the vectorized engine: the G
clients of a cohort in one pass over one frozen backbone, their personal
leaves stacked on a leading client axis (what ``vmap`` of the reference's
step computes).
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
           "grads_of", "make_stacked_step", "stacked_server_anchors"]


def mlecs_loss(params, bundle, batch: Dict,
               anchor: Optional[torch.Tensor] = None,
               ccl_weight: float = 0.5, n_negatives: int = 8,
               ccl_score: str = "volume", stacked: bool = False):
    """The paper's device loss: f_ccl with ``anchor`` (server-fused
    omni-modal reps), f_amt with ``ccl_weight=0``.  Without an anchor the
    model's own fused representation anchors.  With ``stacked`` the
    personal leaves and the batch carry a leading client axis and the loss
    is one value per client, (G,).  The encdec family takes no soft
    prompt (:func:`soft_prompt_batch`).  Returns (loss, (metrics,
    fused))."""
    cfg = bundle.cfg
    lm_loss = bundle.lm_loss_stacked if stacked else bundle.lm_loss
    fused = None
    if cfg.n_modalities > 0 and "modality_feats" in batch:
        soft, mods, fused = conn.connector_prefix(
            params["connector"], cfg, batch["modality_feats"],
            batch["modality_mask"])
        batch = soft_prompt_batch(cfg, batch, soft)
        loss, metrics = lm_loss(params, batch)
        if ccl_weight > 0.0:
            anc = anchor if anchor is not None else fused
            score = (pairwise_cosine_loss if ccl_score == "cosine"
                     else contrastive_loss)
            cl = score(anc, mods, batch["modality_mask"], n_negatives)
            loss = loss + ccl_weight * 2.0 * cl * 0.5   # ½(O2A+A2O) inside
            metrics = dict(metrics, ccl=cl)
    else:
        loss, metrics = lm_loss(params, batch)
    metrics = dict(metrics, loss=loss)
    return loss, (metrics, fused)


def soft_prompt_batch(cfg, batch: Dict, soft) -> Dict:
    """``batch`` with the connector's soft prompt as its 'prefix_embeds',
    but for the encdec family, whose bundle takes none: the reference's
    drops it unread, so its soft-prompt leaves get no gradient and
    only the modality reps and the fused anchor feed CCL."""
    return batch if cfg.family == "encdec" else dict(batch,
                                                     prefix_embeds=soft)


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
    return _make_step(bundle, optimizer, trainable, ccl_weight, n_negatives,
                      with_anchor, prox_weight, ccl_score, stacked=False)


def make_stacked_step(bundle, optimizer: Optimizer,
                      trainable: Callable[[str], bool] = lora.default_trainable,
                      ccl_weight: float = 0.5, n_negatives: int = 8,
                      with_anchor: bool = True, prox_weight: float = 0.0,
                      ccl_score: str = "volume"):
    """One local step of all G clients of a cohort at once (the
    reference's ``vmap`` of :func:`make_local_step`).

    ``params`` is the cohort's stacked tree: the frozen backbone once, the
    trainable leaves (LoRA + connector) stacked (G, ...); ``opt_state`` is
    the stacked AdamW state (``step`` (G,)); ``batch`` leaves are (G, B,
    ...) and ``anchor`` (G, B, c); ``global_ref`` (the FedProx pull) is
    shared.  One backward of the SUM of the per-client losses gives each
    client exactly its own gradient (the clients' leaves are disjoint);
    AdamW then clips and counts per client.  Every kernel of the pass
    launches once for the cohort.  Returns (params, opt_state, metrics of
    (G,) values)."""
    return _make_step(bundle, optimizer, trainable, ccl_weight, n_negatives,
                      with_anchor, prox_weight, ccl_score, stacked=True)


def _make_step(bundle, optimizer, trainable, ccl_weight, n_negatives,
               with_anchor, prox_weight, ccl_score, stacked: bool):
    """The step of :func:`make_local_step` (one client) or of
    :func:`make_stacked_step` (G clients on a leading axis: per-client
    losses and prox terms, their sum differentiated once, AdamW per
    client)."""
    update = optimizer.update_stacked if stacked else optimizer.update

    def step(params, opt_state, batch, anchor=None, global_ref=None):
        train = {k: v.detach().requires_grad_(True)
                 for k, v in lora.partition(params, trainable).items()}
        full = lora.combine(params, train)
        loss, (metrics, _) = mlecs_loss(
            full, bundle, batch, anchor=anchor if with_anchor else None,
            ccl_weight=ccl_weight, n_negatives=n_negatives,
            ccl_score=ccl_score, stacked=stacked)
        if prox_weight > 0.0 and global_ref is not None:
            def sq(x):          # per client when stacked
                return torch.sum(x, dim=tuple(range(1, x.dim()))) \
                    if stacked else torch.sum(x)
            prox = sum(sq((a.float() - global_ref[k].float()) ** 2)
                       for k, a in train.items() if k in global_ref)
            loss = loss + 0.5 * prox_weight * prox
        grads = grads_of(torch.sum(loss) if stacked else loss, train)
        train = {k: v.detach() for k, v in train.items()}
        updates, opt_state = update(grads, opt_state, train)
        params = lora.combine(params, apply_updates(train, updates))
        return params, opt_state, {k: v.detach() for k, v in metrics.items()}

    return step


def stacked_server_anchors(params, bundle, batch: Dict):
    """The server LLM's anchors for G clients' public batches at once:
    batch leaves (G, B, ...), one shared server connector; returns (G, B,
    c)."""
    G, B = batch["modality_feats"].shape[:2]
    flat = {k: batch[k].reshape(G * B, *batch[k].shape[2:])
            for k in ("modality_feats", "modality_mask")}
    return server_anchors(params, bundle, flat).reshape(G, B, -1)


def server_anchors(params, bundle, batch: Dict):
    """Fused omni-modal representations s' from the server's unified model
    (Alg. 1 line 3), distributed to devices as CCL anchors."""
    cfg = bundle.cfg
    h = conn.project_modalities(params["connector"], cfg,
                                batch["modality_feats"],
                                batch["modality_mask"])
    return conn.fuse(params["connector"], cfg, h, batch["modality_mask"])
