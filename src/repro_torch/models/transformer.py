"""Decoder-only transformer trunk, dense and hybrid families (port of
``repro.models.transformer``).

Per-layer params stay stacked on a leading layer axis, as the reference's
``vmap``-ed init leaves them, so carrying weights across is a copy; the
forward is a Python loop over layers that indexes that axis (a view, no
copy).  The per-layer sliding window is a plain int per layer.  A hybrid
layer (hymba) runs attention and an SSD mixer in parallel on the same
normed input and averages them, ``0.5 * (attn + ssm)``.
"""
from __future__ import annotations

from typing import List, Optional

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.core.lora import stack_trees
from repro_torch.models import layers as L
from repro_torch.models import ssm as ssm_lib

PORTED_FAMILIES = ("dense", "ssm", "hybrid")


def require_ported(cfg: ModelConfig) -> None:
    """Raise for what the port does not cover yet: the moe, encdec and vlm
    families, modality frontends and banded attention."""
    if cfg.family not in PORTED_FAMILIES:
        raise NotImplementedError(
            f"model family {cfg.family!r} is not ported yet "
            f"(ported: {', '.join(PORTED_FAMILIES)})")
    if cfg.attn_impl != "masked":
        raise NotImplementedError(
            f"attn_impl={cfg.attn_impl!r} is not ported yet")
    if cfg.frontend:
        raise NotImplementedError(
            f"frontend={cfg.frontend!r} is not ported yet")


# ---------------------------------------------------------------------------
# init

def init_layer(gen: torch.Generator, cfg: ModelConfig) -> dict:
    """One block: two norms, attention (+LoRA), an SSD mixer for the
    hybrid family, MLP."""
    d = cfg.d_model
    zeros = dict(dtype=cfg.torch_dtype, device=gen.device)
    p = {"ln1": torch.zeros((d,), **zeros),
         "ln2": torch.zeros((d,), **zeros),
         "attn": L.init_attention(gen, cfg)}
    if cfg.family == "hybrid":
        p["ssm"] = ssm_lib.init_ssm(gen, cfg)
    p["mlp"] = L.init_mlp(gen, cfg)
    return p


def init_params(gen: torch.Generator, cfg: ModelConfig) -> dict:
    """Backbone params on ``gen``'s device, layers stacked on axis 0."""
    require_ported(cfg)
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
    """One layer.  Returns (x, (k, v), state): for the hybrid family the
    SSD mixer's (h, conv) state, else ()."""
    h = L.rms_norm(x, lp["ln1"], cfg.norm_eps)
    attn_out, kv = L.self_attention(lp["attn"], cfg, h, positions, window)
    state = ()
    if cfg.family == "hybrid":
        ssm_out, st = ssm_lib.ssm_block(lp["ssm"], cfg, h, return_state=True)
        attn_out = 0.5 * (attn_out + ssm_out)
        state = (st["h"], st["conv"])
    x = x + attn_out
    h2 = L.rms_norm(x, lp["ln2"], cfg.norm_eps)
    return x + L.mlp(lp["mlp"], cfg, h2), kv, state


def forward(params, cfg: ModelConfig, tokens,
            prefix_embeds: Optional[torch.Tensor] = None,
            collect_kv: bool = False, return_hidden: bool = False):
    """tokens: (B, S) int; prefix_embeds: (B, P, d) soft prompt.

    Returns (logits (B, P+S, V) float32, aux (0.0), kv|None) with
    kv = (k, v), each (L, B, P+S, K, hd); for the hybrid family kv =
    (k, v, ssm_h (L, B, H, P, N) f32, ssm_conv (L, B, W-1, conv_dim)).
    With ``return_hidden`` the first element is the final-norm hidden
    states (B, P+S, d) instead.
    """
    require_ported(cfg)
    x = L.embed(params["tok"], cfg, tokens)
    if prefix_embeds is not None:
        x = torch.cat([prefix_embeds.to(x.dtype), x], dim=1)
    B, S, _ = x.shape
    positions = torch.arange(S, device=x.device).expand(B, S)
    collected = []
    remat = cfg.remat and torch.is_grad_enabled()
    for i, w in enumerate(window_array(cfg)):
        lp = L.layer_params(params["layers"], i)
        if remat:      # jax.checkpoint of the scanned layer body
            x, kv, state = checkpoint(_block, lp, cfg, x, positions, w,
                                      use_reentrant=False)
        else:
            x, kv, state = _block(lp, cfg, x, positions, w)
        if collect_kv:
            collected.append(kv + state)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    kv = tuple(torch.stack(leaves) for leaves in zip(*collected)) \
        if collect_kv else None
    x = L.rms_norm(x, params["final_norm"], cfg.norm_eps)
    if return_hidden:
        return x, aux, kv
    return L.unembed(params["tok"], cfg, x), aux, kv
