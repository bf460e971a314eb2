"""Mamba2 / SSD blocks and the attention-free stack (port of
``repro.models.ssm``) [arXiv:2405.21060].

The full-sequence block runs the chunked SSD through
:func:`repro_torch.kernels.ops.ssd_chunked` (the SSD chunk kernel on the
card) where the reference calls its jnp ``ssd_reference``; decode is the
O(1) recurrent update per head, plain PyTorch as in the reference.  The
cast points follow the reference: the SSD output is rounded to the model
dtype before the ``D_skip`` term is added, and ``A_log``, ``dt_bias`` and
``D_skip`` stay float32 inside a bf16 model.  One cast point differs: the
depthwise conv sums its taps and bias in float32 and rounds once, in
prefill and in decode alike.  The reference rounds every tap's product
and partial sum to the model dtype in prefill but not in decode, so its
bf16 decode drifts from its own forward; here the two agree (equal at
float32).  Layers stay stacked on a leading axis, as in
:mod:`repro_torch.models.transformer`.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.core.lora import stack_trees
from repro_torch.kernels import ops
from repro_torch.models import layers as L


# ---------------------------------------------------------------------------
# params

def init_ssm(gen: torch.Generator, cfg: ModelConfig, lora: bool = True) -> dict:
    """One SSD mixer: in/out projections (+LoRA on the targets), the
    depthwise conv, and the f32 decay, step bias and skip per head."""
    d, di = cfg.d_model, cfg.d_inner
    N, H, G = cfg.ssm_state, cfg.ssm_heads, cfg.ssm_groups
    conv_dim = di + 2 * G * N
    in_dim = 2 * di + 2 * G * N + H
    dt, dev = cfg.torch_dtype, gen.device
    f32 = dict(dtype=torch.float32, device=dev)
    p = {
        "in_proj": L._dense_init(gen, (d, in_dim), dt),
        "conv_w": L._dense_init(gen, (conv_dim, cfg.ssm_conv), dt, scale=0.5),
        "conv_b": torch.zeros((conv_dim,), dtype=dt, device=dev),
        "A_log": torch.log(torch.linspace(1.0, 16.0, H, **f32)),
        "dt_bias": torch.zeros((H,), **f32),
        "D_skip": torch.ones((H,), **f32),
        "ssm_norm": torch.zeros((di,), dtype=dt, device=dev),
        "out_proj": L._dense_init(gen, (di, d), dt),
    }
    if lora and "in_proj" in cfg.lora_targets:
        L.init_lora(gen, p, "in_proj", d, in_dim, cfg)
    if lora and "out_proj" in cfg.lora_targets:
        L.init_lora(gen, p, "out_proj", di, d, cfg)
    return p


# ---------------------------------------------------------------------------
# causal depthwise conv

def causal_conv(x, w, b):
    """x: (B, S, D) depthwise causal conv with kernel (D, W); the taps and
    the bias summed in float32, rounded once to x's dtype."""
    W = w.shape[-1]
    xp = F.pad(x, (0, 0, W - 1, 0)).float()
    out = sum(xp[:, i:i + x.shape[1], :] * w[:, i].float() for i in range(W))
    return (out + b.float()).to(x.dtype)


# ---------------------------------------------------------------------------
# the full-sequence block

def _split(cfg: ModelConfig, zxbcdt):
    di, N, H, G = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads, cfg.ssm_groups
    return (zxbcdt[..., :di], zxbcdt[..., di:di + di + 2 * G * N],
            zxbcdt[..., -H:].float())


def ssm_block(p, cfg: ModelConfig, x, return_state: bool = False):
    """Full-sequence SSD block.  x: (B,S,d) -> (B,S,d), and with
    ``return_state`` also {"h": (B,H,P,N) f32, "conv": (B,W-1,conv_dim)},
    the state recurrent decode continues from."""
    di, N, H, G, P = (cfg.d_inner, cfg.ssm_state, cfg.ssm_heads,
                      cfg.ssm_groups, cfg.ssm_head_dim)
    Bsz, S, _ = x.shape
    z, xBC_raw, dt = _split(cfg, L.proj(p, "in_proj", x, cfg))
    xBC = F.silu(causal_conv(xBC_raw, p["conv_w"], p["conv_b"]))
    xs = xBC[..., :di].reshape(Bsz, S, H, P)
    B_ = xBC[..., di:di + G * N].reshape(Bsz, S, G, N)
    C_ = xBC[..., di + G * N:].reshape(Bsz, S, G, N)
    dt = F.softplus(dt + p["dt_bias"])
    A = -torch.exp(p["A_log"])
    y, h_last = ops.ssd_chunked(xs, dt, A, B_, C_, cfg.ssm_chunk,
                                return_state=True)
    y = y + p["D_skip"][:, None].to(y.dtype) * xs
    y = y.reshape(Bsz, S, di) * F.silu(z)
    y = L.rms_norm(y, p["ssm_norm"], cfg.norm_eps)
    out = L.proj(p, "out_proj", y, cfg)
    if return_state:
        return out, {"h": h_last, "conv": xBC_raw[:, -(cfg.ssm_conv - 1):, :]}
    return out


# ---------------------------------------------------------------------------
# decode (recurrent, O(1) per token)

def init_ssm_state(cfg: ModelConfig, batch: int, device="cuda") -> dict:
    """Zero recurrent state: h (B,H,P,N) f32 and the conv window
    (B,W-1,conv_dim) in the model dtype."""
    conv_dim = cfg.d_inner + 2 * cfg.ssm_groups * cfg.ssm_state
    return {
        "h": torch.zeros((batch, cfg.ssm_heads, cfg.ssm_head_dim,
                          cfg.ssm_state), dtype=torch.float32, device=device),
        "conv": torch.zeros((batch, cfg.ssm_conv - 1, conv_dim),
                            dtype=cfg.torch_dtype, device=device),
    }


def ssm_decode_step(p, cfg: ModelConfig, state: dict, x):
    """x: (B, 1, d) -> (y (B,1,d), new_state).  ``state`` is not written."""
    di, N, H, G, P = (cfg.d_inner, cfg.ssm_state, cfg.ssm_heads,
                      cfg.ssm_groups, cfg.ssm_head_dim)
    Bsz = x.shape[0]
    z, xBC, dt = _split(cfg, L.proj(p, "in_proj", x[:, 0], cfg))

    # conv over the rolling window [conv_state, x_t]
    window = torch.cat([state["conv"], xBC[:, None, :]], dim=1)
    xBC = F.silu((torch.einsum("bwd,dw->bd", window.float(),
                               p["conv_w"].float())
                  + p["conv_b"].float()).to(window.dtype))
    new_conv = window[:, 1:]

    xs = xBC[..., :di].reshape(Bsz, H, P)
    B_ = xBC[..., di:di + G * N].reshape(Bsz, G, N).repeat_interleave(
        H // G, dim=1)
    C_ = xBC[..., di + G * N:].reshape(Bsz, G, N).repeat_interleave(
        H // G, dim=1)
    dt = F.softplus(dt + p["dt_bias"])                          # (B,H) f32
    A = -torch.exp(p["A_log"])
    decay = torch.exp(dt * A)
    h = state["h"] * decay[:, :, None, None] \
        + (dt[:, :, None] * xs).float()[..., None] * B_.float()[:, :, None, :]
    y = torch.einsum("bhpn,bhn->bhp", h, C_.float())
    y = y.to(x.dtype) + p["D_skip"].to(x.dtype)[:, None] * xs
    y = y.reshape(Bsz, di) * F.silu(z)
    y = L.rms_norm(y, p["ssm_norm"], cfg.norm_eps)
    y = L.proj(p, "out_proj", y, cfg)
    return y[:, None, :], {"h": h, "conv": new_conv}


# ===========================================================================
# the attention-free Mamba2 stack

def init_block(gen: torch.Generator, cfg: ModelConfig) -> dict:
    """One layer: a norm and an SSD mixer."""
    return {"ln1": torch.zeros((cfg.d_model,), dtype=cfg.torch_dtype,
                               device=gen.device),
            "ssm": init_ssm(gen, cfg)}


def init_params(gen: torch.Generator, cfg: ModelConfig) -> dict:
    """Backbone params on ``gen``'s device, layers stacked on axis 0."""
    return {"tok": L.init_embedding(gen, cfg),
            "layers": stack_trees([init_block(gen, cfg)
                                   for _ in range(cfg.n_layers)]),
            "final_norm": torch.zeros((cfg.d_model,), dtype=cfg.torch_dtype,
                                      device=gen.device)}


def _layer(lp, cfg: ModelConfig, x):
    return x + ssm_block(lp["ssm"], cfg, L.rms_norm(x, lp["ln1"], cfg.norm_eps))


def forward(params, cfg: ModelConfig, tokens,
            prefix_embeds: Optional[torch.Tensor] = None,
            collect_state: bool = False, return_hidden: bool = False):
    """tokens: (B, S) int; prefix_embeds: (B, P, d) soft prompt.

    Returns (logits (B, P+S, V) float32, aux (0.0), states|None) with
    states = (h (L,B,H,P,N) f32, conv (L,B,W-1,conv_dim)) when
    ``collect_state``.  With ``return_hidden`` the first element is the
    final-norm hidden states (B, P+S, d) instead."""
    x = L.embed(params["tok"], cfg, tokens)
    if prefix_embeds is not None:
        x = torch.cat([prefix_embeds.to(x.dtype), x], dim=1)
    remat = cfg.remat and torch.is_grad_enabled() and not collect_state
    hs, convs = [], []
    for i in range(cfg.n_layers):
        lp = L.layer_params(params["layers"], i)
        if collect_state:
            h = L.rms_norm(x, lp["ln1"], cfg.norm_eps)
            out, st = ssm_block(lp["ssm"], cfg, h, return_state=True)
            x = x + out
            hs.append(st["h"])
            convs.append(st["conv"])
        elif remat:    # jax.checkpoint of the scanned layer body
            x = checkpoint(_layer, lp, cfg, x, use_reentrant=False)
        else:
            x = _layer(lp, cfg, x)
    x = L.rms_norm(x, params["final_norm"], cfg.norm_eps)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    states = (torch.stack(hs), torch.stack(convs)) if collect_state else None
    out = x if return_hidden else L.unembed(params["tok"], cfg, x)
    return out, aux, states


def decode_step(params, cfg: ModelConfig, cache: dict, tokens):
    """One token for every row.  tokens: (B, 1); cache: {"ssm_h"
    (L,B,H,P,N) f32, "ssm_conv" (L,B,W-1,conv_dim)}, updated in place (a
    new copy of mamba2-2.7b's 16-slot state per token would be 2.7 GB).
    Returns (logits (B, V) float32, cache)."""
    x = L.embed(params["tok"], cfg, tokens)
    for i in range(cfg.n_layers):
        lp = L.layer_params(params["layers"], i)
        h = L.rms_norm(x, lp["ln1"], cfg.norm_eps)
        out, st = ssm_decode_step(lp["ssm"], cfg,
                                  {"h": cache["ssm_h"][i],
                                   "conv": cache["ssm_conv"][i]}, h)
        cache["ssm_h"][i].copy_(st["h"])
        cache["ssm_conv"][i].copy_(st["conv"])
        x = x + out
    x = L.rms_norm(x, params["final_norm"], cfg.norm_eps)
    return L.unembed(params["tok"], cfg, x)[:, 0], cache
