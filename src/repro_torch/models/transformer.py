"""Decoder-only transformer trunk, dense, moe, vlm and hybrid families
(port of ``repro.models.transformer``).

Per-layer params stay stacked on a leading layer axis, as the reference's
``vmap``-ed init leaves them, so carrying weights across is a copy; the
forward is a Python loop over layers that indexes that axis (a view, no
copy).  The per-layer sliding window is a plain int per layer.  A hybrid
layer (hymba) runs attention and an SSD mixer in parallel on the same
normed input and averages them, ``0.5 * (attn + ssm)``.  The vlm family is
the dense trunk behind a projected frontend prefix (``frontend_prefix``).
A moe layer (phi3.5-moe, qwen3-moe) takes :func:`repro_torch.models.moe.
moe_mlp` in place of the MLP (``moe_impl="sharded"``: ``moe_mlp_sharded``),
and the forward sums its layers' auxiliary load-balance losses.

``attn_impl="banded"`` computes the same function as ``"masked"``: every
layer's attention goes through ``ops.attention`` with the layer's window,
and kernel B starts each query tile's key walk at the window's first key,
so it does the reference's banded work (``models/banded.py``) and no more;
the five ``constrain`` points of that module have no counterpart here.
The activation constraints (``sharding.partition.constrain``) sit where
the reference's do: the residual stream after the prefix and after each
layer's attention, a decode step's embedding.

Serving from a ring cache (``init_cache``, ``prefill``, ``decode_step``)
keeps the reference's layout: k / v (L, B, S_c, K, hd), pos (L, S_c).
``decode_step`` writes the cache in place.
"""
from __future__ import annotations

from typing import List, Optional

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L
from repro_torch.models import moe as moe_lib
from repro_torch.models import ssm as ssm_lib
from repro_torch.sharding.partition import constrain


# ---------------------------------------------------------------------------
# init

def init_layer(gen: torch.Generator, cfg: ModelConfig) -> dict:
    """One block: two norms, attention (+LoRA), an SSD mixer for the
    hybrid family, the experts (moe) or an MLP."""
    d = cfg.d_model
    zeros = dict(dtype=cfg.torch_dtype, device=gen.device)
    p = {"ln1": torch.zeros((d,), **zeros),
         "ln2": torch.zeros((d,), **zeros),
         "attn": L.init_attention(gen, cfg)}
    if cfg.family == "hybrid":
        p["ssm"] = ssm_lib.init_ssm(gen, cfg)
    if cfg.is_moe:
        p["moe"] = moe_lib.init_moe(gen, cfg)
    else:
        p["mlp"] = L.init_mlp(gen, cfg)
    return p


def init_params(gen: torch.Generator, cfg: ModelConfig) -> dict:
    """Backbone params on ``gen``'s device, layers stacked on axis 0 (and
    the vlm family's frontend projector)."""
    tok = L.init_embedding(gen, cfg)
    layers = L.stack_layers(gen, cfg.n_layers, lambda g: init_layer(g, cfg))
    params = {"tok": tok, "layers": layers,
              "final_norm": torch.zeros((cfg.d_model,), dtype=cfg.torch_dtype,
                                        device=gen.device)}
    if cfg.frontend:            # the vision stub's projector
        params["frontend"] = {
            "fp_w1": L._dense_init(gen, (cfg.frontend_dim, cfg.d_model),
                                   cfg.torch_dtype),
            "fp_w2": L._dense_init(gen, (cfg.d_model, cfg.d_model),
                                   cfg.torch_dtype)}
    return params


def window_array(cfg: ModelConfig) -> List[int]:
    """Per-layer window as plain ints (BIG_WINDOW = full attention)."""
    return [cfg.window_for_layer(i) or L.BIG_WINDOW
            for i in range(cfg.n_layers)]


def frontend_prefix(params, cfg: ModelConfig, frontend_embeds):
    """Project stubbed frontend embeddings (B, T, frontend_dim) into the
    LM space (B, T, d): gelu in its tanh form (as ``jax.nn.gelu``), in the
    param dtype.  A per-client projector (a cohort's stacked leaves,
    fp_w1 (G, F, d)) projects each client's B / G rows, in order, with its
    own leaves."""
    fp = params["frontend"]
    x = frontend_embeds.to(cfg.torch_dtype)
    w1, w2 = fp["fp_w1"], fp["fp_w2"]
    if w1.dim() == 3:
        G = w1.shape[0]
        h = F.gelu(torch.bmm(x.reshape(G, -1, x.shape[-1]), w1),
                   approximate="tanh")
        return torch.bmm(h, w2).reshape(*x.shape[:-1], w2.shape[-1])
    return F.gelu(x @ w1, approximate="tanh") @ w2


def n_clients(layers: dict) -> int:
    """G of a stack whose LoRA leaves carry a leading client axis."""
    for k, v in layers.items():
        if isinstance(v, dict):
            g = n_clients(v)
            if g:
                return g
        elif "_lora_" in k:
            return v.shape[0]
    return 0


def ffn(lp, cfg: ModelConfig, h, clients: int | None = None):
    """The layer's feed-forward on its normed input: (y, aux), aux the
    experts' load-balance loss for a moe layer (``moe_impl="sharded"``:
    :func:`~repro_torch.models.moe.moe_mlp_sharded`, expert-parallel
    inside a sharding context), each of the ``clients``' own, (G,), in a
    stacked call; else None."""
    if cfg.is_moe:
        fn = (moe_lib.moe_mlp_sharded if cfg.moe_impl == "sharded"
              else moe_lib.moe_mlp)
        return fn(lp["moe"], cfg, h, clients)
    return L.mlp(lp["mlp"], cfg, h), None


# ---------------------------------------------------------------------------
# full-sequence forward (prefill)

def _block(lp, cfg: ModelConfig, x, positions, window: int,
           clients: int | None = None):
    """One layer.  Returns (x, (k, v), state, aux): for the hybrid family
    the SSD mixer's (h, conv) state, else (); aux the moe layer's
    load-balance loss (per client, (G,), with ``clients``), else None."""
    h = L.rms_norm(x, lp["ln1"], cfg.norm_eps)
    attn_out, kv = L.self_attention(lp["attn"], cfg, h, positions, window)
    state = ()
    if cfg.family == "hybrid":
        ssm_out, st = ssm_lib.ssm_block(lp["ssm"], cfg, h, return_state=True)
        attn_out = 0.5 * (attn_out + ssm_out)
        state = (st["h"], st["conv"])
    x = constrain(x + attn_out, "batch", "seq", None)
    y, aux = ffn(lp, cfg, L.rms_norm(x, lp["ln2"], cfg.norm_eps), clients)
    return x + y, kv, state, aux


def forward(params, cfg: ModelConfig, tokens,
            prefix_embeds: Optional[torch.Tensor] = None,
            collect_kv: bool = False, return_hidden: bool = False,
            clients: bool = False):
    """tokens: (B, S) int; prefix_embeds: (B, P, d) soft prompt.  With
    ``clients`` the LoRA leaves are stacked over G clients (leading axis)
    and the batch holds the clients' rows in order, B / G each: every
    adapted projection is one grouped launch, and a moe layer routes each
    client's rows as a call of their own.

    Returns (logits (B, P+S, V) float32, aux, kv|None), aux the moe
    layers' summed load-balance losses (a scalar; with ``clients`` one a
    client, (G,)), else the scalar 0.0, with
    kv = (k, v), each (L, B, P+S, K, hd); for the hybrid family kv =
    (k, v, ssm_h (L, B, H, P, N) f32, ssm_conv (L, B, W-1, conv_dim)).
    With ``return_hidden`` the first element is the final-norm hidden
    states (B, P+S, d) instead.
    """
    G = n_clients(params["layers"]) if clients and cfg.is_moe else None
    x = L.embed(params["tok"], cfg, tokens)
    if prefix_embeds is not None:
        x = torch.cat([prefix_embeds.to(x.dtype), x], dim=1)
    x = constrain(x, "batch", "seq", None)
    B, S, _ = x.shape
    positions = torch.arange(S, device=x.device).expand(B, S)
    collected = []
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    remat = cfg.remat and torch.is_grad_enabled()
    for i, w in enumerate(window_array(cfg)):
        lp = L.layer_params(params["layers"], i, clients)
        if remat:      # jax.checkpoint of the scanned layer body
            x, kv, state, a = checkpoint(_block, lp, cfg, x, positions, w,
                                         G, use_reentrant=False)
        else:
            x, kv, state, a = _block(lp, cfg, x, positions, w, G)
        if a is not None:
            aux = aux + a
        if collect_kv:
            collected.append(kv + state)
    kv = tuple(torch.stack(leaves) for leaves in zip(*collected)) \
        if collect_kv else None
    x = L.rms_norm(x, params["final_norm"], cfg.norm_eps)
    if return_hidden:
        return x, aux, kv
    return L.unembed(params["tok"], cfg, x), aux, kv


# ---------------------------------------------------------------------------
# ring KV cache: prefill and one-token decode

def cache_len(cfg: ModelConfig, seq_len: int) -> int:
    """Per-layer cache capacity, one for every layer.  A pure
    sliding-window model ring-buffers to the window; any global layer
    (the gemma3 / hymba pattern, or full attention) needs the whole
    length."""
    if cfg.sliding_window > 0 and cfg.global_every == 0:
        return min(seq_len, cfg.sliding_window)
    return seq_len


def empty_ring(cfg: ModelConfig, batch: int, S_c: int, device) -> dict:
    """An empty ring of S_c slots a layer: k / v (L, B, S_c, K, hd) zeros,
    pos (L, S_c) int32 -1 (the reference's)."""
    shape = (cfg.n_layers, batch, S_c, cfg.n_kv_heads, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=cfg.torch_dtype, device=device),
            "v": torch.zeros(shape, dtype=cfg.torch_dtype, device=device),
            "pos": torch.full((cfg.n_layers, S_c), -1, dtype=torch.int32,
                              device=device)}


def ring_of(k, v, S_c: int) -> dict:
    """The ring of S_c slots a layer that a prefill leaves from its keys
    and values k / v (L, B, S, K, hd): the last S_c positions survive,
    position p in slot p % S_c."""
    S = k.shape[2]
    kept = torch.arange(S - S_c, S, device=k.device)
    slots = kept % S_c
    ring = {"k": torch.empty_like(k[:, :, :S_c]),
            "v": torch.empty_like(v[:, :, :S_c]),
            "pos": torch.empty((k.shape[0], S_c), dtype=torch.int32,
                               device=k.device)}
    ring["k"][:, :, slots] = k[:, :, S - S_c:]
    ring["v"][:, :, slots] = v[:, :, S - S_c:]
    ring["pos"][:, slots] = kept.to(torch.int32)
    return ring


def init_cache(cfg: ModelConfig, batch: int, seq_len: int,
               device="cuda") -> dict:
    """An empty cache for ``batch`` rows of up to ``seq_len`` positions:
    k / v (L, B, S_c, K, hd) zeros, pos (L, S_c) -1; for the hybrid family
    also ssm_h (L, B, H, P, N) f32 and ssm_conv (L, B, W-1, conv_dim)."""
    cache = empty_ring(cfg, batch, cache_len(cfg, seq_len), device)
    if cfg.family == "hybrid":
        cache.update(ssm_lib.init_cache(cfg, batch, seq_len, device))
    return cache


def prefill(params, cfg: ModelConfig, tokens,
            prefix_embeds: Optional[torch.Tensor] = None):
    """One forward over the prompt (and its prefix) that also fills a
    cache ready for decoding at position P + S.  Only the last position
    is unembedded, from the hidden states (gemma3's 262,144-token vocab
    would make a whole prompt's logits gigabytes).  Ring semantics: the
    last S_c positions survive, position p in slot p % S_c.

    Returns (last-token logits (B, V) float32, cache)."""
    h, _, kv = forward(params, cfg, tokens, prefix_embeds, collect_kv=True,
                       return_hidden=True)
    last = L.unembed(params["tok"], cfg, h[:, -1])
    cache = ring_of(kv[0], kv[1], cache_len(cfg, h.shape[1]))
    if cfg.family == "hybrid":
        cache["ssm_h"], cache["ssm_conv"] = kv[2], kv[3]
    return last, cache


def decode_step(params, cfg: ModelConfig, cache: dict, tokens, pos: int):
    """One token for every row at absolute position ``pos`` (an int).
    tokens: (B, 1).  The cache is updated in place (a new copy of it per
    token would cost more than the step) and returned.

    Returns (logits (B, V) float32, cache)."""
    pos = int(pos)
    x = constrain(L.embed(params["tok"], cfg, tokens), "batch", "seq", None)
    hybrid = cfg.family == "hybrid"
    for i, w in enumerate(window_array(cfg)):
        lp = L.layer_params(params["layers"], i)
        h = L.rms_norm(x, lp["ln1"], cfg.norm_eps)
        attn_out = L.decode_attention(lp["attn"], cfg, h, pos, cache["k"][i],
                                      cache["v"][i], cache["pos"][i], w)
        if hybrid:
            ssm_out, st = ssm_lib.ssm_decode_step(
                lp["ssm"], cfg, {"h": cache["ssm_h"][i],
                                 "conv": cache["ssm_conv"][i]}, h)
            cache["ssm_h"][i].copy_(st["h"])
            cache["ssm_conv"][i].copy_(st["conv"])
            attn_out = 0.5 * (attn_out + ssm_out)
        y = x + attn_out
        x = y + ffn(lp, cfg, L.rms_norm(y, lp["ln2"], cfg.norm_eps))[0]
    x = L.rms_norm(x, params["final_norm"], cfg.norm_eps)
    return L.unembed(params["tok"], cfg, x)[:, 0], cache
