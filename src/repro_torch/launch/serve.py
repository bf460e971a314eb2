"""Serving entry points over the ring cache (port of
``repro.launch.serve``): prefill, one-token decode steps and a host-scale
autoregressive loop.

``generate`` keeps every row of a batch at one position: the prompt's
prefix (the vlm family's frontend tokens, then any soft prompt) and its S
tokens are prefilled at once, then each step decodes one token for every
row.  Two departures from the reference, both where it is wrong with a
prefix of P tokens (ROADMAP, faults in the reference): the serving cache
holds P + S + max_new positions (the reference's holds S + max_new, so a
full-attention ring wraps over the prefix), and the first decoded token
sits at position P + S (the reference's at S, over the prompt's own
entries).  Without a prefix both agree with the reference.  The last
token is sampled from the last step's logits without a further decode.

Greedy decoding (temperature 0) takes ``argmax``.  Above temperature 0
tokens are drawn from the caller's ``torch.Generator`` (seeded), as
``ServingEngine`` draws them; they cannot reproduce ``jax.random``'s.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch

from repro_torch.core.lora import merge_lora
from repro_torch.models.model import ModelBundle, frontend_prefix_len


def make_serve_step(bundle: ModelBundle):
    """(params, cache, tokens (B, 1), pos) -> (logits (B, V), cache), the
    cache written in place."""
    def serve_step(params, cache, tokens, pos):
        return bundle.decode_step(params, cache, tokens, pos)
    return serve_step


def make_prefill(bundle: ModelBundle):
    """(params, batch) -> (last-token logits (B, V), prefill cache)."""
    def prefill(params, batch):
        return bundle.prefill(params, batch)
    return prefill


def _prefix_len(cfg, batch: Dict) -> int:
    """Cache entries ahead of the prompt: the frontend's
    (``frontend_prefix_len``) and the soft prompt's."""
    P = frontend_prefix_len(cfg)
    if batch.get("prefix_embeds") is not None:
        P += batch["prefix_embeds"].shape[1]
    return P


@torch.no_grad()
def generate(bundle: ModelBundle, params, prompt_tokens, max_new: int = 32,
             temperature: float = 0.0,
             generator: Optional[torch.Generator] = None,
             batch_extra: Optional[Dict] = None, merge: bool = True):
    """Greedy (or, with ``generator``, temperature) sampling of
    ``max_new`` tokens after each row of ``prompt_tokens`` (B, S), on the
    device the prompt lies on.  ``batch_extra`` may hold
    'frontend_embeds' (B, T, F) (the vlm family's prefix, the encdec
    family's encoder input) and 'prefix_embeds' (B, P, d).  With
    ``merge`` the LoRA adapters are folded into the weights first
    (``merge_lora``, which drops the adapter leaves).  Returns (B,
    max_new) int64 tokens."""
    if temperature > 0 and generator is None:
        raise ValueError("temperature > 0 needs a seeded torch.Generator")
    cfg = bundle.cfg
    if merge:
        params = merge_lora(params, cfg)
    B, S = prompt_tokens.shape
    batch = {"tokens": prompt_tokens, **(batch_extra or {})}
    pos = _prefix_len(cfg, batch) + S
    cache = bundle.init_cache(B, pos + max_new, prompt_tokens.device)
    logits, prefill_cache = bundle.prefill(params, batch)
    cache = _reseat_cache(cache, prefill_cache)
    del prefill_cache
    step = make_serve_step(bundle)
    out = []
    for i in range(max_new):
        if temperature > 0:
            probs = torch.softmax(logits / temperature, dim=-1)
            tok = torch.multinomial(probs, 1, generator=generator)
        else:
            tok = torch.argmax(logits, dim=-1, keepdim=True)
        out.append(tok)
        if i + 1 < max_new:
            logits, cache = step(params, cache, tok, pos)
            pos += 1
    return torch.cat(out, dim=1)


# per-sequence state leaves whose shape never depends on the cache's
# capacity: the recurrent SSM state (hybrid, ssm) and the encoder's cross
# K/V (encdec)
_STATE_KEYS = ("ssm_h", "ssm_conv", "cross_k", "cross_v")


def _reseat_cache(big: Dict, small: Dict) -> Dict:
    """Copy a prefill cache (capacity S) into the serving cache (capacity
    S + max_new) at the front of its slots, in place.

    Every leaf is routed explicitly by name; an unknown leaf raises
    instead of passing through (a pass-through of the wrong shape would
    corrupt the decode cache far from here)."""
    out = dict(big)
    for name, s in small.items():
        if name not in big:
            raise KeyError(
                f"prefill cache leaf {name!r} is absent from the serving "
                f"cache (serving has {sorted(big)})")
        b = big[name]
        if name in ("k", "v", "pos"):
            axis = 2 if name != "pos" else 1
            if b.shape == s.shape:
                out[name] = s
            else:
                b.narrow(axis, 0, s.shape[axis]).copy_(s)
        elif name in _STATE_KEYS:
            if b.shape != s.shape:
                raise ValueError(
                    f"cache leaf {name!r} is per-sequence state and must "
                    f"match exactly: serving {tuple(b.shape)} vs prefill "
                    f"{tuple(s.shape)}")
            out[name] = s
        else:
            raise KeyError(
                f"unknown cache leaf {name!r}: route it explicitly in "
                "_reseat_cache (a silent pass-through corrupts serving "
                "caches)")
    return out
