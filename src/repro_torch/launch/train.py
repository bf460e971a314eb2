"""The trainer (port of ``repro.launch.train``): the paper's technique as
one training step over a global batch, for any config of the registry.

  * trainable set = LoRA adapters + the multimodal connector (+ the
    frontend projector), so the gradient covers only the paper's
    communicated volume;
  * loss = per-example CE weighted by MMA modality counts (Eq. 13) + the
    gram-volume CCL contrastive term against the server anchor (Eq. 11);
  * ``full_finetune=True`` trains every leaf (the Multi-FedAvg baseline,
    the paper's main comparison).

``cfg.loss_impl == "chunked"`` computes the CE over sequence chunks of
the final hidden states, each chunk's logits recomputed in the backward,
so a 256k-vocabulary model never holds its (B, S, V) float32 logits.
The encdec family has no ``hidden`` and takes the full CE, as in the
reference.

``run_training`` is the host loop (``examples/train_edge_slm.py`` drives
the reference's).  Entry points run on ``device="cuda"`` unless the
caller asks for the CPU.
"""
from __future__ import annotations

from typing import Callable, Dict, Optional

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.core import ccl as ccl_lib
from repro_torch.core import connector as conn
from repro_torch.core import lora
from repro_torch.core.gram import contrastive_loss
from repro_torch.data.pipeline import to_tensors
from repro_torch.models.layers import unembed
from repro_torch.optim.adamw import Optimizer, adamw, apply_updates

# The reference also imports its sharding hook (``constrain``) here and
# never calls it in this file; the port's calls sit in the model modules.


def _nll(logits, tgt):
    """-log p(tgt) of f32 logits (..., V) at int targets (...)."""
    logp = torch.log_softmax(logits, dim=-1)
    return -torch.gather(logp, -1, tgt.long()[..., None])[..., 0]


def per_example_ce(logits, tokens, loss_mask):
    """(B,) per-example mean CE of logits (B, P+S, V) predicting
    tokens[:, 1:] where ``loss_mask`` is set (needed for the MMA
    per-example weights)."""
    S = tokens.shape[1]
    P = logits.shape[1] - S
    pred = logits[:, P:P + S - 1].float()
    m = loss_mask[:, 1:].float()
    nll = _nll(pred, tokens[:, 1:])
    return torch.sum(nll * m, dim=1) / torch.clamp(torch.sum(m, dim=1),
                                                   min=1.0)


def _chunk_sums(tok, cfg, hb, tb, mb):
    """One chunk's (B,) masked NLL sum and mask sum: its logits exist only
    here (recomputed in the backward under ``checkpoint``)."""
    nll = _nll(unembed(tok, cfg, hb).float(), tb)
    return torch.sum(nll * mb, dim=1), torch.sum(mb, dim=1)


def per_example_ce_chunked(params, bundle, hidden, tokens, loss_mask):
    """(B,) per-example CE of :func:`per_example_ce` from the final hidden
    states (B, P+S, d), over sequence chunks of ``cfg.loss_chunk``
    positions (padded, as the reference pads its scan): each chunk's
    logits are unembedded, reduced and dropped, and recomputed in the
    backward, so the (B, S, V) float32 logits never exist.  The chunks'
    sums add in order, in float32."""
    cfg = bundle.cfg
    B, S = tokens.shape
    P = hidden.shape[1] - S
    h = hidden[:, P:P + S - 1]                      # predicts tokens[1:]
    tgt = tokens[:, 1:]
    m = loss_mask[:, 1:].float()
    n = S - 1
    c = min(cfg.loss_chunk, n)
    nc = -(-n // c)
    pad = nc * c - n
    if pad:
        h = torch.nn.functional.pad(h, (0, 0, 0, pad))
        tgt = torch.nn.functional.pad(tgt, (0, pad))
        m = torch.nn.functional.pad(m, (0, pad))
    nll_sum = torch.zeros((B,), dtype=torch.float32, device=hidden.device)
    m_sum = torch.zeros_like(nll_sum)
    for i in range(nc):
        blk = slice(i * c, (i + 1) * c)
        nll_c, m_c = checkpoint(_chunk_sums, params["tok"], cfg, h[:, blk],
                                tgt[:, blk], m[:, blk], use_reentrant=False)
        nll_sum = nll_sum + nll_c
        m_sum = m_sum + m_c
    return nll_sum / torch.clamp(m_sum, min=1.0)


def mlecs_train_loss(params, bundle, batch: Dict, ccl_weight: float = 0.5,
                     n_negatives: int = 8, use_mma_weights: bool = True):
    """Scalar loss of one step over the global batch: the (MMA-weighted)
    CE, + router_aux_weight * aux, + ccl_weight * the contrastive loss of
    the anchor (``batch['anchor']``, else the model's own fused
    representation) against the modality reps.  Returns (loss, metrics:
    ``ce``, ``aux``, ``ccl`` where computed, ``loss``)."""
    cfg = bundle.cfg
    b = dict(batch)
    mods = None
    if cfg.n_modalities > 0 and "modality_feats" in b:
        soft, mods, fused = conn.connector_prefix(
            params["connector"], cfg, b["modality_feats"], b["modality_mask"])
        b = ccl_lib.soft_prompt_batch(cfg, b, soft)
    if cfg.loss_impl == "chunked" and bundle.hidden is not None:
        hid, aux = bundle.hidden(params, b)
        ce_i = per_example_ce_chunked(params, bundle, hid, b["tokens"],
                                      b["loss_mask"])
    else:
        logits, aux = bundle.logits(params, b)
        ce_i = per_example_ce(logits, b["tokens"], b["loss_mask"])

    if use_mma_weights and mods is not None:
        # MMA (Eq. 13): examples from modality-richer clients weigh more
        w = torch.sum(b["modality_mask"].float(), dim=1)
        w = w / torch.clamp(torch.sum(w), min=1.0)
        ce = torch.sum(ce_i * w)
    else:
        ce = torch.mean(ce_i)

    loss = ce + cfg.router_aux_weight * aux
    metrics = {"ce": ce, "aux": aux}
    if mods is not None and ccl_weight > 0.0:
        anchor = b.get("anchor")
        anchor = fused if anchor is None else anchor
        cl = contrastive_loss(anchor, mods, b["modality_mask"], n_negatives)
        loss = loss + ccl_weight * cl
        metrics["ccl"] = cl
    metrics["loss"] = loss
    return loss, metrics


def _trainable(full_finetune: bool) -> Callable[[str], bool]:
    return lora.all_trainable if full_finetune else lora.default_trainable


def make_train_step(bundle, optimizer: Optimizer, full_finetune: bool = False,
                    ccl_weight: float = 0.5, n_negatives: int = 8,
                    use_mma_weights: bool = True) -> Callable:
    """step(params, opt_state, batch) -> (params, opt_state, metrics):
    the gradient of :func:`mlecs_train_loss` over the trainable partition
    only (LoRA + connector + frontend, or every leaf with
    ``full_finetune``), then the optimizer on it.  Leaves outside the
    partition are the same tensors afterwards; metrics are detached."""
    predicate = _trainable(full_finetune)

    def step(params, opt_state, batch):
        train = {k: v.detach().requires_grad_(True)
                 for k, v in lora.partition(params, predicate).items()}
        loss, metrics = mlecs_train_loss(
            lora.combine(params, train), bundle, batch, ccl_weight,
            n_negatives, use_mma_weights)
        grads = ccl_lib.grads_of(loss, train)
        train = {k: v.detach() for k, v in train.items()}
        updates, opt_state = optimizer.update(grads, opt_state, train)
        params = lora.combine(params, apply_updates(train, updates))
        return params, opt_state, {k: v.detach() for k, v in metrics.items()}

    return step


def init_train_state(bundle, optimizer: Optimizer, gen: torch.Generator,
                     full_finetune: bool = False):
    """The unified model's params drawn from ``gen`` (on its device) and
    the optimizer's state over the trainable partition."""
    params = ccl_lib.init_unified(gen, bundle)
    opt_state = optimizer.init(lora.partition(params,
                                              _trainable(full_finetune)))
    return params, opt_state


def _on(batch: Dict, device) -> Dict[str, torch.Tensor]:
    """A batch of numpy arrays and / or tensors as tensors on
    ``device``."""
    host = {k: v for k, v in batch.items() if not torch.is_tensor(v)}
    return {**{k: v.to(device) for k, v in batch.items() if k not in host},
            **to_tensors(host, device)}


def run_training(bundle, data_iter, steps: int, lr: float = 1e-3,
                 log_every: int = 20, seed: int = 0,
                 full_finetune: bool = False, ccl_weight: float = 0.5,
                 checkpoint_dir: Optional[str] = None, device="cuda"):
    """The host loop: AdamW(lr) from params drawn on ``device`` from
    ``seed`` (torch's generator: they differ from the reference's at the
    same seed), ``steps`` steps over ``data_iter``'s batches (numpy or
    tensors, moved to ``device``), a ``step {i:5d}  k=v`` line (keys
    sorted, as the reference's jitted metrics come) and a history row at
    every ``log_every``-th step and the last; with ``checkpoint_dir`` the
    final params saved at step ``steps``.  Returns (params, history)."""
    opt = adamw(lr)
    gen = torch.Generator(device=device).manual_seed(seed)
    params, opt_state = init_train_state(bundle, opt, gen, full_finetune)
    step_fn = make_train_step(bundle, opt, full_finetune, ccl_weight)
    history = []
    for i in range(steps):
        params, opt_state, metrics = step_fn(params, opt_state,
                                             _on(next(data_iter), device))
        if i % log_every == 0 or i == steps - 1:
            m = {k: float(metrics[k]) for k in sorted(metrics)}  # jit's order
            history.append({"step": i, **m})
            print(f"step {i:5d}  " +
                  "  ".join(f"{k}={v:.4f}" for k, v in m.items()))
    if checkpoint_dir:
        from repro_torch.checkpointing import CheckpointManager
        CheckpointManager(checkpoint_dir).save(steps, params)
    return params, history
