"""Paged (blocked) KV-cache serving contract, dense family (port of
``repro.models.paged``).

  k_pages / v_pages : (L, n_pages, page_size, K, hd)   physical pool
  block_tables      : (n_slots, max_pages) int32        logical -> physical

Page 0 is the scratch page: the allocator never hands it out, and idle
slots keep an all-zero block-table row, so the unconditional per-step cache
write of every slot lands on page 0 instead of needing a branch per slot.

Unlike the reference, which returns a new state, the port writes the pool
in place (``insert_paged`` and ``decode_paged`` return the same dict): a
copy of the SLM's 3 GB pool per token would dwarf the step itself.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops
from repro_torch.models import layers as L
from repro_torch.models import transformer


def pages_for(length: int, page_size: int) -> int:
    """Pages needed to hold ``length`` cache entries."""
    return -(-length // page_size)


def init_paged(cfg: ModelConfig, n_slots: int, n_pages: int, page_size: int,
               device="cuda") -> dict:
    """Zeroed K/V page pools (``n_slots`` is part of the contract; the
    dense family keeps no per-slot state)."""
    transformer.require_dense(cfg)
    shape = (cfg.n_layers, n_pages, page_size, cfg.n_kv_heads, cfg.head_dim)
    return {name: torch.zeros(shape, dtype=cfg.torch_dtype, device=device)
            for name in ("k_pages", "v_pages")}


def prefill_paged(params, cfg: ModelConfig, batch: dict, true_len: int):
    """Full forward over a (possibly right-padded) prompt.

    Returns (last_logits (B, V) at the TRUE last position, the pack
    {"k", "v"} of (L, B, P+S_pad, K, hd) cache entries, and
    kv_len = P + true_len, the entries the request owns after insertion).
    """
    tokens = batch["tokens"]
    h, _, kv = transformer.forward(params, cfg, tokens,
                                   batch.get("prefix_embeds"),
                                   collect_kv=True, return_hidden=True)
    P = h.shape[1] - tokens.shape[1]
    last = L.unembed(params["tok"], cfg, h[:, P + true_len - 1])
    return last, {"k": kv[0], "v": kv[1]}, P + true_len


def insert_paged(cfg: ModelConfig, pstate: dict, pack: dict, slot: int,
                 page_ids: torch.Tensor) -> dict:
    """Seat a B=1 prefill pack: its KV scattered into ``page_ids`` (a count
    covering the padded prompt), in place.  ``slot`` is part of the
    contract; the dense family keeps no per-slot leaves."""
    n_used = page_ids.shape[0]
    for src, dst in (("k", "k_pages"), ("v", "v_pages")):
        pool = pstate[dst]
        ps = pool.shape[2]
        t = pack[src][:, 0]                       # (L, S, K, hd)
        pad = n_used * ps - t.shape[1]
        if pad:
            t = F.pad(t, (0, 0, 0, 0, 0, pad))
        pool[:, page_ids] = t.reshape(t.shape[0], n_used, ps,
                                      *t.shape[2:]).to(pool.dtype)
    return pstate


def _paged_decode_attention(ap, cfg: ModelConfig, h, pos_vec, kp, vp,
                            block_tables, lens_incl, window: int):
    """One-token self-attention against one layer's pool.  Writes the new
    K/V at position ``pos_vec[b]`` of slot b's logical sequence (idle slots
    hit scratch page 0 through their zeroed row), then attends."""
    q, k_new, v_new = L._qkv(ap, cfg, h, h, pos_vec[:, None],
                             pos_vec[:, None])
    ps = kp.shape[1]
    blk = (pos_vec // ps).clamp(max=block_tables.shape[1] - 1)
    page = block_tables.gather(1, blk[:, None])[:, 0].long()
    off = pos_vec % ps
    kp[page, off] = k_new[:, 0]
    vp[page, off] = v_new[:, 0]
    out = ops.paged_attention(q, kp, vp, block_tables, lens_incl, window)
    return L.proj(ap, "wo", out, cfg)


def decode_paged(params, cfg: ModelConfig, pstate: dict, block_tables,
                 seq_lens, tokens, active):
    """One token for every slot.  tokens: (n_slots, 1); seq_lens:
    (n_slots,) cached entries per slot (the new token lands at that
    position); active: (n_slots,) bool; block_tables: (n_slots, M) int32.
    Returns (logits (n_slots, V) float32, pstate updated in place)."""
    transformer.require_dense(cfg)
    x = L.embed(params["tok"], cfg, tokens)
    pos_vec = seq_lens.long()
    lens_incl = torch.where(active, seq_lens + 1,
                            torch.zeros_like(seq_lens)).int()
    for i, w in enumerate(transformer.window_array(cfg)):
        lp = transformer.layer_params(params["layers"], i)
        h = L.rms_norm(x, lp["ln1"], cfg.norm_eps)
        y = x + _paged_decode_attention(
            lp["attn"], cfg, h, pos_vec, pstate["k_pages"][i],
            pstate["v_pages"][i], block_tables, lens_incl, w)
        h2 = L.rms_norm(y, lp["ln2"], cfg.norm_eps)
        x = y + L.mlp(lp["mlp"], cfg, h2)
    x = L.rms_norm(x, params["final_norm"], cfg.norm_eps)
    return L.unembed(params["tok"], cfg, x)[:, 0], pstate
