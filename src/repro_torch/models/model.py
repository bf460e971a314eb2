"""Model factory (port of ``repro.models.model``): config -> ModelBundle,
for all six families: dense, moe, vlm, ssm (mamba2), hybrid (hymba) and
encdec (whisper).

  bundle.init(gen)                                      -> params
  bundle.logits(params, batch)                          -> (logits, aux)
  bundle.prefill(params, batch)                         -> (last_logits, cache)
  bundle.decode_step(params, cache, tokens, pos)        -> (logits, cache)
  bundle.init_cache(batch_size, seq_len, device)        -> cache
  bundle.hidden(params, batch)                          -> (hidden, aux)
  bundle.lm_loss(params, batch)                         -> (loss, metrics)
  bundle.logits_stacked(params, batch)                  -> (logits (G, B, ...), aux)
  bundle.lm_loss_stacked(params, batch)                 -> (loss (G,), metrics)
  bundle.init_paged(n_slots, n_pages, page_size, device)-> pstate
  bundle.prefill_paged(params, batch, true_len)         -> (last, pack, kv_len)
  bundle.insert_paged(pstate, pack, slot, page_ids)     -> pstate
  bundle.decode_paged(params, pstate, block_tables,
                      seq_lens, tokens, active)         -> (logits, pstate)

``batch`` is a dict with 'tokens' (B, S) and optionally 'prefix_embeds'
(B, P, d), the ML-ECS soft prompt, and 'frontend_embeds' (B, T,
frontend_dim), the vlm family's stubbed vision features or the encdec
family's audio frames (required there).  The encdec family feeds its
frames to the encoder, has no prefix and refuses a soft prompt; its
``hidden`` is None (as the reference's).  The stacked forms
(``logits_stacked``, ``lm_loss_stacked``) take every family.  The ring
cache (``prefill`` / ``decode_step``) is written in place.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Any, Callable, Dict, NamedTuple, Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import encdec, paged, ssm, transformer
from repro_torch.models.layers import padded_vocab


class ModelBundle(NamedTuple):
    """The model's entry points, closed over its config."""
    cfg: ModelConfig
    init: Callable
    logits: Callable
    lm_loss: Callable
    prefill: Callable
    decode_step: Callable
    init_cache: Callable
    hidden: Optional[Callable]  # (params, batch) -> final-norm states
                                # (B, P+S, d); None for encdec
    init_paged: Callable
    prefill_paged: Callable
    insert_paged: Callable
    decode_paged: Callable
    logits_stacked: Callable    # G clients' (G, B, ...) batch at once
    lm_loss_stacked: Callable   # the same -> (G,) losses


def frontend_prefix_len(cfg: ModelConfig) -> int:
    """Cache entries the frontend puts ahead of the prompt: the vlm
    family's projected features; the encdec family's frames feed its
    encoder, not the decoder's cache."""
    return cfg.frontend_tokens if cfg.frontend and cfg.family != "encdec" \
        else 0


def _prefix(params, cfg: ModelConfig, batch: Dict[str, Any]):
    """The embedding prefix: the projected frontend (vlm), then the ML-ECS
    soft prompt, each if present."""
    parts = []
    if cfg.frontend:
        if batch.get("frontend_embeds") is None:
            raise ValueError(f"{cfg.name}: a {cfg.frontend} frontend needs "
                             "batch['frontend_embeds']")
        parts.append(transformer.frontend_prefix(params, cfg,
                                                 batch["frontend_embeds"]))
    if batch.get("prefix_embeds") is not None:
        parts.append(batch["prefix_embeds"].to(cfg.torch_dtype))
    if not parts:
        return None
    return parts[0] if len(parts) == 1 else torch.cat(parts, dim=1)


def encdec_frames(cfg: ModelConfig, batch: Dict[str, Any]):
    """The encdec family's encoder input, ``batch['frontend_embeds']``
    (B, T, frontend_dim), required.  A soft prompt has no place in this
    family: the reference's bundle drops 'prefix_embeds' unread, the port
    refuses it."""
    if batch.get("prefix_embeds") is not None:
        raise ValueError(f"{cfg.name}: the encdec family takes no soft "
                         "prompt (batch['prefix_embeds'])")
    if batch.get("frontend_embeds") is None:
        raise ValueError(f"{cfg.name}: the encoder needs "
                         "batch['frontend_embeds']")
    return batch["frontend_embeds"]


def cross_entropy(logits, targets, mask, vocab_size: int, dims=None):
    """Token-level CE in f32 over the padded vocab, averaged over the
    positions where ``mask`` is set (at least 1): over all of them, or
    over ``dims`` only (one mean per remaining index)."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    nll = -torch.gather(logp, -1, targets.long()[..., None])[..., 0]
    mask = mask.float()
    if dims is None:
        return torch.sum(nll * mask) / torch.clamp(torch.sum(mask), min=1.0)
    return torch.sum(nll * mask, dim=dims) / torch.clamp(
        torch.sum(mask, dim=dims), min=1.0)


def build_model(cfg: ModelConfig) -> ModelBundle:
    """The bundle for a config of any family."""
    fam = cfg.family
    trunk = {"ssm": ssm, "encdec": encdec}.get(fam, transformer)

    def init(gen):
        return trunk.init_params(gen, cfg)

    def inputs(params, batch):
        """The trunk's second input: the encoder's frames, or the
        prefix."""
        if fam == "encdec":
            return encdec_frames(cfg, batch)
        return _prefix(params, cfg, batch)

    def logits_fn(params, batch):
        out, aux, _ = trunk.forward(params, cfg, batch["tokens"],
                                    inputs(params, batch))
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

    def logits_stacked(params, batch):
        """G clients at once: ``params`` carries the personal leaves (LoRA,
        frontend projector) stacked (G, ...) over one backbone; ``batch``
        leaves are (G, B, ...).  The clients' rows go through the trunk
        (``transformer``, ``ssm`` or ``encdec.forward`` with
        ``clients=True``) as one batch of G·B rows (every kernel launches
        once for the G clients; a moe layer routes each client's rows as a
        call of their own).  Returns (logits (G, B, P+S, V) f32, aux: a
        moe trunk's (G,), else the scalar 0.0)."""
        tokens = batch["tokens"]
        G, B, S = tokens.shape
        rows = {k: batch[k].reshape(G * B, *batch[k].shape[2:])
                for k in ("prefix_embeds", "frontend_embeds")
                if batch.get(k) is not None}
        logits, aux, _ = trunk.forward(
            params, cfg, tokens.reshape(G * B, S), inputs(params, rows),
            clients=True)
        return logits.reshape(G, B, *logits.shape[1:]), aux

    def lm_loss_stacked(params, batch):
        """Each client's loss: its own masked mean over its own tokens,
        (G,)."""
        logits, aux = logits_stacked(params, batch)
        tokens = batch["tokens"]
        G, S = tokens.shape[0], tokens.shape[2]
        P = logits.shape[2] - S
        targets = tokens[:, :, 1:]
        pred = logits[:, :, P:P + S - 1]
        mask = batch.get("loss_mask")
        mask = torch.ones(targets.shape, dtype=torch.float32,
                          device=targets.device) if mask is None \
            else mask[:, :, 1:]
        ce = cross_entropy(pred, targets, mask, padded_vocab(cfg),
                           dims=(1, 2))
        if aux.dim() == 0:      # no moe layer: the scalar 0.0
            aux = aux.expand(G)
        loss = ce + cfg.router_aux_weight * aux
        return loss, {"ce": ce, "aux": aux}

    def prefill_fn(params, batch):
        return trunk.prefill(params, cfg, batch["tokens"],
                             inputs(params, batch))

    def decode_fn(params, cache, tokens, pos):
        return trunk.decode_step(params, cfg, cache, tokens, pos)

    def cache_fn(batch_size: int, seq_len: int, device="cuda"):
        return trunk.init_cache(cfg, batch_size, seq_len, device)

    def prefill_paged_fn(params, batch, true_len):
        return paged.prefill_paged(params, cfg, batch, true_len)

    def decode_paged_fn(params, pstate, block_tables, seq_lens, tokens,
                        active):
        return paged.decode_paged(params, cfg, pstate, block_tables,
                                  seq_lens, tokens, active)

    return ModelBundle(
        cfg=cfg, init=init, logits=logits_fn, lm_loss=lm_loss,
        prefill=prefill_fn, decode_step=decode_fn, init_cache=cache_fn,
        hidden=None if fam == "encdec" else hidden_fn,
        init_paged=functools.partial(paged.init_paged, cfg),
        prefill_paged=prefill_paged_fn,
        insert_paged=functools.partial(paged.insert_paged, cfg),
        decode_paged=decode_paged_fn, logits_stacked=logits_stacked,
        lm_loss_stacked=lm_loss_stacked)


def with_overrides(cfg: ModelConfig, **kw) -> ModelConfig:
    """``cfg`` with the given fields replaced."""
    return dataclasses.replace(cfg, **kw)
