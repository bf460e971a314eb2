"""Shared neural layers (port of ``repro.models.layers``): norms, RoPE,
GQA self-attention through :mod:`repro_torch.kernels.ops`, MLPs,
embeddings.  Params are plain dicts of tensors in the reference's layout:
weights are (in, out) and ``y = x @ W``.

The cast points follow the reference: ``rms_norm`` computes in float32 and
returns the input dtype, the MLP multiplies in the param dtype, and
``unembed`` multiplies in the param dtype, then casts to float32.  An
adapted projection sums in float32 and rounds once (the reference rounds
each of its three products to the param dtype; equal at float32).
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops

BIG_WINDOW = 1 << 30   # stands for "no window" in per-layer window lists


def layer_params(layers: dict, i: int) -> dict:
    """The params of layer ``i`` of a stack (views into the leaves, which
    carry the layers on axis 0)."""
    return {k: layer_params(v, i) if isinstance(v, dict) else v[i]
            for k, v in layers.items()}


# ---------------------------------------------------------------------------
# init helpers

def _dense_init(gen: torch.Generator, shape, dtype,
                scale: Optional[float] = None):
    """Normal(0, std) draw on ``gen``'s device; std = 1/sqrt(shape[0])
    unless ``scale`` is given (the reference's fan-in rule)."""
    fan_in = shape[0] if len(shape) >= 2 else max(shape[-1], 1)
    std = scale if scale is not None else 1.0 / math.sqrt(fan_in)
    return (torch.randn(shape, generator=gen, device=gen.device,
                        dtype=torch.float32) * std).to(dtype)


def init_lora(gen: torch.Generator, p: dict, name: str, in_dim: int,
              out_dim: int, cfg: ModelConfig) -> None:
    """Attach LoRA A/B leaves for target ``name`` to ``p`` (Eq. 1); B
    starts at zero, as in the reference."""
    r = cfg.lora_rank
    p[f"{name}_lora_a"] = _dense_init(gen, (in_dim, r), cfg.torch_dtype)
    p[f"{name}_lora_b"] = torch.zeros((r, out_dim), dtype=cfg.torch_dtype,
                                      device=gen.device)


def proj(p: dict, name: str, x, cfg: ModelConfig):
    """Linear projection with the optional unmerged LoRA update; with
    adapter leaves present it is one fused ``ops.lora_matmul`` (kernel C
    on the card), f32 sums rounded once."""
    w = p[name]
    a = p.get(f"{name}_lora_a")
    if a is None:
        return x @ w
    y = ops.lora_matmul(x.reshape(-1, x.shape[-1]).contiguous(), w, a,
                        p[f"{name}_lora_b"], cfg.lora_alpha / cfg.lora_rank)
    return y.reshape(*x.shape[:-1], w.shape[1])


# ---------------------------------------------------------------------------
# norms and RoPE

def rms_norm(x, scale, eps: float):
    """RMS norm in the ``1 + scale`` form, float32 inside."""
    dt = x.dtype
    xf = x.float()
    xf = xf * torch.rsqrt(torch.mean(xf * xf, dim=-1, keepdim=True) + eps)
    return (xf * (1.0 + scale.float())).to(dt)


def rope(x, positions, theta: float):
    """x: (..., S, H, D) rotated at ``positions`` (..., S)."""
    half = x.shape[-1] // 2
    freqs = torch.exp(-math.log(theta)
                      * torch.arange(half, dtype=torch.float32,
                                     device=x.device) / half)
    ang = positions[..., None].float() * freqs
    cos, sin = torch.cos(ang)[..., None, :], torch.sin(ang)[..., None, :]
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# attention

def init_attention(gen: torch.Generator, cfg: ModelConfig,
                   lora: bool = True) -> dict:
    """Q/K/V/O projections (+ qk-norm scales, + LoRA on the targets)."""
    d, H, K, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    dt = cfg.torch_dtype
    p = {
        "wq": _dense_init(gen, (d, H * hd), dt),
        "wk": _dense_init(gen, (d, K * hd), dt),
        "wv": _dense_init(gen, (d, K * hd), dt),
        "wo": _dense_init(gen, (H * hd, d), dt, scale=1.0 / math.sqrt(H * hd)),
    }
    if cfg.qk_norm:
        p["q_norm"] = torch.zeros((hd,), dtype=dt, device=gen.device)
        p["k_norm"] = torch.zeros((hd,), dtype=dt, device=gen.device)
    if lora:
        dims = {"wq": (d, H * hd), "wk": (d, K * hd), "wv": (d, K * hd),
                "wo": (H * hd, d)}
        for t in cfg.lora_targets:
            if t in dims:
                init_lora(gen, p, t, *dims[t], cfg)
    return p


def _qkv(p, cfg: ModelConfig, xq, xkv, positions_q, positions_kv,
         use_rope: bool = True):
    H, K, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q = proj(p, "wq", xq, cfg).reshape(*xq.shape[:-1], H, hd)
    k = proj(p, "wk", xkv, cfg).reshape(*xkv.shape[:-1], K, hd)
    v = proj(p, "wv", xkv, cfg).reshape(*xkv.shape[:-1], K, hd)
    if cfg.qk_norm:
        q = rms_norm(q, p["q_norm"], cfg.norm_eps)
        k = rms_norm(k, p["k_norm"], cfg.norm_eps)
    if use_rope:
        q = rope(q, positions_q, cfg.rope_theta)
        k = rope(k, positions_kv, cfg.rope_theta)
    return q, k, v


def causal_window_mask(positions_q, positions_kv, window):
    """True where q may attend to k (``window`` = BIG_WINDOW: full)."""
    dq = positions_q[..., :, None]
    dk = positions_kv[..., None, :]
    return (dk <= dq) & (dq - dk < window)


def self_attention(p, cfg: ModelConfig, x, positions, window: int):
    """Causal self-attention over a whole sequence (prefill).  ``positions``
    must be ``arange(S)`` per row (the rope angles; the causal / window
    mask is the kernel's, with queries and keys aligned).  Returns
    (out, (k, v))."""
    q, k, v = _qkv(p, cfg, x, x, positions, positions)
    out = ops.attention(q, k, v, causal=True, window=window)
    return proj(p, "wo", out, cfg), (k, v)


# ---------------------------------------------------------------------------
# MLP

def init_mlp(gen: torch.Generator, cfg: ModelConfig,
             d_ff: Optional[int] = None) -> dict:
    """Up/down (+ gate for silu/geglu) projections."""
    d, f = cfg.d_model, d_ff or cfg.d_ff
    p = {"w_up": _dense_init(gen, (d, f), cfg.torch_dtype),
         "w_down": _dense_init(gen, (f, d), cfg.torch_dtype)}
    if cfg.activation in ("silu", "geglu"):
        p["w_gate"] = _dense_init(gen, (d, f), cfg.torch_dtype)
    return p


def mlp(p, cfg: ModelConfig, x):
    """gelu (tanh form, as ``jax.nn.gelu``) / silu / geglu MLP."""
    up = x @ p["w_up"]
    if cfg.activation == "silu":
        h = F.silu(x @ p["w_gate"]) * up
    elif cfg.activation == "geglu":
        h = F.gelu(x @ p["w_gate"], approximate="tanh") * up
    else:
        h = F.gelu(up, approximate="tanh")
    return h @ p["w_down"]


# ---------------------------------------------------------------------------
# embeddings

def padded_vocab(cfg: ModelConfig) -> int:
    """Vocab rounded up to a multiple of 256 (the reference's padding)."""
    return ((cfg.vocab_size + 255) // 256) * 256


def init_embedding(gen: torch.Generator, cfg: ModelConfig) -> dict:
    """Token embedding over the padded vocab (+ untied unembedding)."""
    v = padded_vocab(cfg)
    p = {"embed": _dense_init(gen, (v, cfg.d_model), cfg.torch_dtype,
                              scale=1.0 / math.sqrt(cfg.d_model))}
    if not cfg.tie_embeddings:
        p["unembed"] = _dense_init(gen, (cfg.d_model, v), cfg.torch_dtype)
    return p


def embed(p, cfg: ModelConfig, tokens):
    """Token ids -> embeddings (gemma models scale by sqrt(d))."""
    x = p["embed"][tokens]
    if cfg.name.startswith("gemma"):
        x = x * torch.tensor(math.sqrt(cfg.d_model), dtype=x.dtype,
                             device=x.device)
    return x


def unembed(p, cfg: ModelConfig, x):
    """Logits in float32 over the padded vocab."""
    w = p["embed"].T if cfg.tie_embeddings else p["unembed"]
    return (x @ w).float()
