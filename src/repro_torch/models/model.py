"""Model factory (port of ``repro.models.model``): config -> ModelBundle,
dense family.

  bundle.init(gen)                                      -> params
  bundle.logits(params, batch)                          -> (logits, aux)
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

from repro_torch.configs.base import ModelConfig
from repro_torch.models import paged, transformer


class ModelBundle(NamedTuple):
    """The model's entry points, closed over its config."""
    cfg: ModelConfig
    init: Callable
    logits: Callable
    init_paged: Callable
    prefill_paged: Callable
    insert_paged: Callable
    decode_paged: Callable


def _prefix(params, cfg: ModelConfig, batch: Dict[str, Any]):
    """The embedding prefix: the ML-ECS soft prompt, if present."""
    return batch.get("prefix_embeds")


def build_model(cfg: ModelConfig) -> ModelBundle:
    """The bundle for a dense-family config; other families raise."""
    transformer.require_dense(cfg)

    def init(gen):
        return transformer.init_params(gen, cfg)

    def logits_fn(params, batch):
        out, aux, _ = transformer.forward(params, cfg, batch["tokens"],
                                          _prefix(params, cfg, batch))
        return out, aux

    def prefill_paged_fn(params, batch, true_len):
        return paged.prefill_paged(params, cfg, batch, true_len)

    def decode_paged_fn(params, pstate, block_tables, seq_lens, tokens,
                        active):
        return paged.decode_paged(params, cfg, pstate, block_tables,
                                  seq_lens, tokens, active)

    return ModelBundle(cfg, init, logits_fn,
                       functools.partial(paged.init_paged, cfg),
                       prefill_paged_fn,
                       functools.partial(paged.insert_paged, cfg),
                       decode_paged_fn)
