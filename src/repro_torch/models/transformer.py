"""Decoder-only transformer trunk, dense family (port of
``repro.models.transformer``).

Per-layer params stay stacked on a leading layer axis, as the reference's
``vmap``-ed init leaves them, so carrying weights across is a copy; the
forward is a Python loop over layers that indexes that axis (a view, no
copy).  The per-layer sliding window is a plain int per layer.
"""
from __future__ import annotations

from typing import List, Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L


def require_dense(cfg: ModelConfig) -> None:
    """Raise for what this slice of the port does not cover."""
    if cfg.family != "dense":
        raise NotImplementedError(
            f"model family {cfg.family!r} is not ported yet (dense only)")
    if cfg.attn_impl != "masked":
        raise NotImplementedError(
            f"attn_impl={cfg.attn_impl!r} is not ported yet")
    if cfg.frontend:
        raise NotImplementedError(
            f"frontend={cfg.frontend!r} is not ported yet")


def stack_trees(trees: List[dict]) -> dict:
    """Stack identically-structured dicts of tensors on a new axis 0."""
    first = trees[0]
    return {k: stack_trees([t[k] for t in trees]) if isinstance(v, dict)
            else torch.stack([t[k] for t in trees]) for k, v in first.items()}


def layer_params(layers: dict, i: int) -> dict:
    """The params of layer ``i`` (views into the stacked leaves)."""
    return {k: layer_params(v, i) if isinstance(v, dict) else v[i]
            for k, v in layers.items()}


# ---------------------------------------------------------------------------
# init

def init_layer(gen: torch.Generator, cfg: ModelConfig) -> dict:
    """One dense block: two norms, attention (+LoRA), MLP."""
    d = cfg.d_model
    zeros = dict(dtype=cfg.torch_dtype, device=gen.device)
    return {"ln1": torch.zeros((d,), **zeros),
            "ln2": torch.zeros((d,), **zeros),
            "attn": L.init_attention(gen, cfg),
            "mlp": L.init_mlp(gen, cfg)}


def init_params(gen: torch.Generator, cfg: ModelConfig) -> dict:
    """Backbone params on ``gen``'s device, layers stacked on axis 0."""
    require_dense(cfg)
    tok = L.init_embedding(gen, cfg)
    layers = stack_trees([init_layer(gen, cfg) for _ in range(cfg.n_layers)])
    return {"tok": tok, "layers": layers,
            "final_norm": torch.zeros((cfg.d_model,), dtype=cfg.torch_dtype,
                                      device=gen.device)}


def window_array(cfg: ModelConfig) -> List[int]:
    """Per-layer window as plain ints (BIG_WINDOW = full attention)."""
    return [cfg.window_for_layer(i) or L.BIG_WINDOW
            for i in range(cfg.n_layers)]


# ---------------------------------------------------------------------------
# full-sequence forward (prefill)

def _block(lp, cfg: ModelConfig, x, positions, window: int):
    h = L.rms_norm(x, lp["ln1"], cfg.norm_eps)
    attn_out, kv = L.self_attention(lp["attn"], cfg, h, positions, window)
    x = x + attn_out
    h2 = L.rms_norm(x, lp["ln2"], cfg.norm_eps)
    return x + L.mlp(lp["mlp"], cfg, h2), kv


def forward(params, cfg: ModelConfig, tokens,
            prefix_embeds: Optional[torch.Tensor] = None,
            collect_kv: bool = False, return_hidden: bool = False):
    """tokens: (B, S) int; prefix_embeds: (B, P, d) soft prompt.

    Returns (logits (B, P+S, V) float32, aux (0.0), kv|None) with
    kv = (k, v), each (L, B, P+S, K, hd).  With ``return_hidden`` the
    first element is the final-norm hidden states (B, P+S, d) instead.
    """
    require_dense(cfg)
    x = L.embed(params["tok"], cfg, tokens)
    if prefix_embeds is not None:
        x = torch.cat([prefix_embeds.to(x.dtype), x], dim=1)
    B, S, _ = x.shape
    positions = torch.arange(S, device=x.device).expand(B, S)
    ks, vs = [], []
    for i, w in enumerate(window_array(cfg)):
        x, (k, v) = _block(layer_params(params["layers"], i), cfg, x,
                           positions, w)
        if collect_kv:
            ks.append(k)
            vs.append(v)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    kv = (torch.stack(ks), torch.stack(vs)) if collect_kv else None
    x = L.rms_norm(x, params["final_norm"], cfg.norm_eps)
    if return_hidden:
        return x, aux, kv
    return L.unembed(params["tok"], cfg, x), aux, kv
