"""Model factory (port of ``repro.models.model``): config -> ModelBundle,
for the dense, ssm (mamba2) and hybrid (hymba) families.

  bundle.init(gen)                                      -> params
  bundle.logits(params, batch)                          -> (logits, aux)
  bundle.hidden(params, batch)                          -> (hidden, aux)
  bundle.lm_loss(params, batch)                         -> (loss, metrics)
  bundle.init_paged(n_slots, n_pages, page_size, device)-> pstate
  bundle.prefill_paged(params, batch, true_len)         -> (last, pack, kv_len)
  bundle.insert_paged(pstate, pack, slot, page_ids)     -> pstate
  bundle.decode_paged(params, pstate, block_tables,
                      seq_lens, tokens, active)         -> (logits, pstate)

``batch`` is a dict with 'tokens' (B, S) and optionally 'prefix_embeds'
(B, P, d), the ML-ECS soft prompt.
"""
from __future__ import annotations

import functools
from typing import Any, Callable, Dict, NamedTuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import paged, ssm, transformer
from repro_torch.models.layers import padded_vocab


class ModelBundle(NamedTuple):
    """The model's entry points, closed over its config."""
    cfg: ModelConfig
    init: Callable
    logits: Callable
    lm_loss: Callable
    init_paged: Callable
    prefill_paged: Callable
    insert_paged: Callable
    decode_paged: Callable
    hidden: Callable      # (params, batch) -> final-norm states (B, P+S, d)


def _prefix(params, cfg: ModelConfig, batch: Dict[str, Any]):
    """The embedding prefix: the ML-ECS soft prompt, if present."""
    return batch.get("prefix_embeds")


def cross_entropy(logits, targets, mask, vocab_size: int):
    """Token-level CE in f32 over the padded vocab, averaged over the
    positions where ``mask`` is set (at least 1)."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    nll = -torch.gather(logp, -1, targets.long()[..., None])[..., 0]
    mask = mask.float()
    return torch.sum(nll * mask) / torch.clamp(torch.sum(mask), min=1.0)


def build_model(cfg: ModelConfig) -> ModelBundle:
    """The bundle for a dense, ssm or hybrid config; other families raise
    ``NotImplementedError``."""
    transformer.require_ported(cfg)
    trunk = ssm if cfg.family == "ssm" else transformer

    def init(gen):
        return trunk.init_params(gen, cfg)

    def logits_fn(params, batch):
        out, aux, _ = trunk.forward(params, cfg, batch["tokens"],
                                    _prefix(params, cfg, batch))
        return out, aux

    def hidden_fn(params, batch):
        h, aux, _ = trunk.forward(params, cfg, batch["tokens"],
                                  _prefix(params, cfg, batch),
                                  return_hidden=True)
        return h, aux

    def lm_loss(params, batch):
        logits, aux = logits_fn(params, batch)
        tokens = batch["tokens"]
        S = tokens.shape[1]
        P = logits.shape[1] - S               # prefix length
        targets = tokens[:, 1:]
        pred = logits[:, P:P + S - 1]
        mask = batch.get("loss_mask")
        mask = torch.ones(targets.shape, dtype=torch.float32,
                          device=targets.device) if mask is None \
            else mask[:, 1:]
        ce = cross_entropy(pred, targets, mask, padded_vocab(cfg))
        loss = ce + cfg.router_aux_weight * aux
        return loss, {"ce": ce, "aux": aux}

    def prefill_paged_fn(params, batch, true_len):
        return paged.prefill_paged(params, cfg, batch, true_len)

    def decode_paged_fn(params, pstate, block_tables, seq_lens, tokens,
                        active):
        return paged.decode_paged(params, cfg, pstate, block_tables,
                                  seq_lens, tokens, active)

    return ModelBundle(cfg, init, logits_fn, lm_loss,
                       functools.partial(paged.init_paged, cfg),
                       prefill_paged_fn,
                       functools.partial(paged.insert_paged, cfg),
                       decode_paged_fn, hidden_fn)
