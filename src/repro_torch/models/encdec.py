"""Whisper-style encoder-decoder backbone (port of ``repro.models.encdec``)
[arXiv:2212.04356].

The mel-spectrogram and conv feature extractor is a stub, as in the
reference: ``frontend_embeds`` (B, T, frontend_dim) are precomputed frame
features, and the frontend projector maps them into d_model (gelu in its
tanh form, as ``transformer.frontend_prefix``).  The encoder adds
sinusoidal positions (computed in float32, cast to the param dtype) and
runs bidirectional layers without rope (kernel B with ``causal=False``).
The decoder's self-attention is causal with rope (the reference's
adaptation in place of Whisper's learned positions) within
``cfg.sliding_window`` (0: none), then cross-attends to the encoder output
(kernel B over the whole prompt; at decode one token a row against the
cached cross K/V, through ``layers.cross_attention_decode``), then its
MLP.  ``forward`` returns aux = 0.

Layers stay stacked on a leading axis (``enc_layers``, ``dec_layers``), as
in :mod:`repro_torch.models.transformer`, and each forward loops over
them; under ``cfg.remat`` (grad mode on) each decoder layer is recomputed
in the backward, as the reference checkpoints its decoder scan.

The ring cache holds the decoder's self-attention k / v (L, B, S_c, K,
hd) and pos (L, S_c), as the transformer's, and the encoder's cross K/V
per layer and row, cross_k / cross_v (L, B, T, K, hd).  ``decode_step``
writes the ring in place.  The decoder's positions start at 0 after the
prompt's: the audio frames feed the encoder, not the decoder's cache.
"""
from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L
from repro_torch.models.transformer import empty_ring, frontend_prefix, ring_of


def sinusoid(T: int, d: int, dtype, device="cpu"):
    """(T, d) sinusoidal positions: sin then cos halves, float32, cast to
    ``dtype``."""
    pos = torch.arange(T, dtype=torch.float32, device=device)[:, None]
    i = torch.arange(d // 2, dtype=torch.float32, device=device)[None, :]
    ang = pos / torch.pow(torch.tensor(10000.0, device=device), 2 * i / d)
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1).to(dtype)


# ---------------------------------------------------------------------------
# init

def _init_enc_layer(gen: torch.Generator, cfg: ModelConfig) -> dict:
    zeros = dict(dtype=cfg.torch_dtype, device=gen.device)
    d = cfg.d_model
    return {"ln1": torch.zeros((d,), **zeros),
            "ln2": torch.zeros((d,), **zeros),
            "attn": L.init_attention(gen, cfg),
            "mlp": L.init_mlp(gen, cfg)}


def _init_dec_layer(gen: torch.Generator, cfg: ModelConfig) -> dict:
    zeros = dict(dtype=cfg.torch_dtype, device=gen.device)
    d = cfg.d_model
    return {"ln1": torch.zeros((d,), **zeros),
            "ln_x": torch.zeros((d,), **zeros),
            "ln2": torch.zeros((d,), **zeros),
            "attn": L.init_attention(gen, cfg),
            "xattn": L.init_attention(gen, cfg, lora=False),
            "mlp": L.init_mlp(gen, cfg)}


def init_params(gen: torch.Generator, cfg: ModelConfig) -> dict:
    """Embedding, the frontend projector, ``n_enc_layers`` encoder and
    ``n_layers`` decoder layers (each stacked on axis 0), the encoder's
    and the decoder's final norms, on ``gen``'s device."""
    dt = cfg.torch_dtype
    d = cfg.d_model
    return {
        "tok": L.init_embedding(gen, cfg),
        "frontend": {"fp_w1": L._dense_init(gen, (cfg.frontend_dim, d), dt),
                     "fp_w2": L._dense_init(gen, (d, d), dt)},
        "enc_layers": L.stack_layers(gen, cfg.n_enc_layers,
                                     lambda g: _init_enc_layer(g, cfg)),
        "dec_layers": L.stack_layers(gen, cfg.n_layers,
                                     lambda g: _init_dec_layer(g, cfg)),
        "enc_norm": torch.zeros((d,), dtype=dt, device=gen.device),
        "final_norm": torch.zeros((d,), dtype=dt, device=gen.device)}


# ---------------------------------------------------------------------------
# encoder

def encode(params, cfg: ModelConfig, frontend_embeds, clients: bool = False):
    """frontend_embeds: (B, T, frontend_dim) stub frames -> (B, T, d).
    With ``clients`` the LoRA and projector leaves are stacked over G
    clients and the rows are the clients' in order, B / G each."""
    x = frontend_prefix(params, cfg, frontend_embeds)
    B, T, _ = x.shape
    x = x + sinusoid(T, cfg.d_model, x.dtype, x.device)[None]
    positions = torch.arange(T, device=x.device).expand(B, T)
    for i in range(cfg.n_enc_layers):
        lp = L.layer_params(params["enc_layers"], i, clients)
        h = L.rms_norm(x, lp["ln1"], cfg.norm_eps)
        out, _ = L.self_attention(lp["attn"], cfg, h, positions, 0,
                                  bidirectional=True, use_rope=False)
        y = x + out
        x = y + L.mlp(lp["mlp"], cfg, L.rms_norm(y, lp["ln2"], cfg.norm_eps))
    return L.rms_norm(x, params["enc_norm"], cfg.norm_eps)


def encode_cross_kv(params, cfg: ModelConfig, enc_x):
    """Every decoder layer's cross K/V of enc_x: (L, B, T, K, hd) x2."""
    kvs = [L.encode_kv(L.layer_params(params["dec_layers"], i)["xattn"],
                       cfg, enc_x) for i in range(cfg.n_layers)]
    return tuple(torch.stack(t) for t in zip(*kvs))


# ---------------------------------------------------------------------------
# decoder

def _dec_block(lp, cfg: ModelConfig, x, positions, enc_x):
    """One decoder layer over the whole sequence.  Returns (x, (k, v) of
    its self-attention, (k, v) of its cross-attention)."""
    h = L.rms_norm(x, lp["ln1"], cfg.norm_eps)
    out, kv = L.self_attention(lp["attn"], cfg, h, positions,
                               cfg.sliding_window or L.BIG_WINDOW)
    y = x + out
    xkv = L.encode_kv(lp["xattn"], cfg, enc_x)
    y = y + L.cross_attention(lp["xattn"], cfg,
                              L.rms_norm(y, lp["ln_x"], cfg.norm_eps), *xkv)
    y = y + L.mlp(lp["mlp"], cfg, L.rms_norm(y, lp["ln2"], cfg.norm_eps))
    return y, kv, xkv


def decode_forward(params, cfg: ModelConfig, tokens, enc_x,
                   collect_kv: bool = False, return_hidden: bool = False,
                   clients: bool = False):
    """The teacher-forced decoder over tokens (B, S) against enc_x (B, T,
    d); with ``clients`` the self-attention's adapters are stacked over G
    clients (the cross-attention has none and stays shared).  Returns
    (logits (B, S, V) float32, kv|None) with kv = (k, v, cross_k,
    cross_v): the self-attention's (L, B, S, K, hd) each and the
    cross-attention's (L, B, T, K, hd) each.  With ``return_hidden`` the
    first element is the final-norm hidden states (B, S, d) instead."""
    x = L.embed(params["tok"], cfg, tokens)
    B, S, _ = x.shape
    positions = torch.arange(S, device=x.device).expand(B, S)
    remat = cfg.remat and torch.is_grad_enabled()
    collected = []
    for i in range(cfg.n_layers):
        lp = L.layer_params(params["dec_layers"], i, clients)
        if remat:      # jax.checkpoint of the scanned decoder body
            x, kv, xkv = checkpoint(_dec_block, lp, cfg, x, positions, enc_x,
                                    use_reentrant=False)
        else:
            x, kv, xkv = _dec_block(lp, cfg, x, positions, enc_x)
        if collect_kv:
            collected.append(kv + xkv)
    kv = tuple(torch.stack(t) for t in zip(*collected)) if collect_kv \
        else None
    x = L.rms_norm(x, params["final_norm"], cfg.norm_eps)
    if return_hidden:
        return x, kv
    return L.unembed(params["tok"], cfg, x), kv


def forward(params, cfg: ModelConfig, tokens, frontend_embeds,
            collect_kv: bool = False, clients: bool = False):
    """Encoder then decoder: (logits (B, S, V) float32, aux (0.0), kv|None
    as :func:`decode_forward`'s); ``clients`` as :func:`encode`'s."""
    enc_x = encode(params, cfg, frontend_embeds, clients)
    logits, kv = decode_forward(params, cfg, tokens, enc_x, collect_kv,
                                clients=clients)
    return logits, torch.zeros((), dtype=torch.float32,
                               device=logits.device), kv


# ---------------------------------------------------------------------------
# ring cache: prefill and one-token decode

def cache_len(cfg: ModelConfig, seq_len: int) -> int:
    """The decoder's ring capacity: the window where there is one, else
    the whole length (the reference's encdec rule)."""
    return min(seq_len, cfg.sliding_window) if cfg.sliding_window \
        else seq_len


def init_cross(cfg: ModelConfig, batch: int, device="cuda") -> dict:
    """Zeroed cross K/V for ``batch`` rows (or slots): cross_k / cross_v
    (L, batch, frontend_tokens, K, hd)."""
    shape = (cfg.n_layers, batch, cfg.frontend_tokens, cfg.n_kv_heads,
             cfg.head_dim)
    return {name: torch.zeros(shape, dtype=cfg.torch_dtype, device=device)
            for name in ("cross_k", "cross_v")}


def init_cache(cfg: ModelConfig, batch: int, seq_len: int,
               device="cuda") -> dict:
    """An empty cache: k / v (L, B, S_c, K, hd) zeros, pos (L, S_c) -1,
    cross_k / cross_v (L, B, frontend_tokens, K, hd) zeros."""
    return {**empty_ring(cfg, batch, cache_len(cfg, seq_len), device),
            **init_cross(cfg, batch, device)}


def prefill(params, cfg: ModelConfig, tokens, frontend_embeds):
    """Encode the frames, run the decoder over the prompt, and fill a
    cache ready for decoding at position S (only the last position is
    unembedded).  Returns (last-token logits (B, V) float32, cache)."""
    enc_x = encode(params, cfg, frontend_embeds)
    h, (k, v, xk, xv) = decode_forward(params, cfg, tokens, enc_x,
                                       collect_kv=True, return_hidden=True)
    last = L.unembed(params["tok"], cfg, h[:, -1])
    return last, {**ring_of(k, v, cache_len(cfg, h.shape[1])),
                  "cross_k": xk, "cross_v": xv}


def decode_step(params, cfg: ModelConfig, cache: dict, tokens, pos: int):
    """One token for every row at decoder position ``pos`` (an int):
    self-attention against the ring (written in place), cross-attention
    against the cached cross K/V.  Returns (logits (B, V) float32,
    cache)."""
    pos = int(pos)
    x = L.embed(params["tok"], cfg, tokens)
    window = cfg.sliding_window or L.BIG_WINDOW
    for i in range(cfg.n_layers):
        lp = L.layer_params(params["dec_layers"], i)
        h = L.rms_norm(x, lp["ln1"], cfg.norm_eps)
        y = x + L.decode_attention(lp["attn"], cfg, h, pos, cache["k"][i],
                                   cache["v"][i], cache["pos"][i], window)
        y = y + L.cross_attention_decode(
            lp["xattn"], cfg, L.rms_norm(y, lp["ln_x"], cfg.norm_eps),
            cache["cross_k"][i], cache["cross_v"][i])
        x = y + L.mlp(lp["mlp"], cfg, L.rms_norm(y, lp["ln2"], cfg.norm_eps))
    x = L.rms_norm(x, params["final_norm"], cfg.norm_eps)
    return L.unembed(params["tok"], cfg, x)[:, 0], cache
