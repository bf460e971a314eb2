"""Paged (blocked) KV-cache serving contract for the dense, ssm and hybrid
families (port of ``repro.models.paged``).

  k_pages / v_pages : (L, n_pages, page_size, K, hd)   physical pool
  block_tables      : (n_slots, max_pages) int32        logical -> physical

Page 0 is the scratch page: the allocator never hands it out, and idle
slots keep an all-zero block-table row, so the unconditional per-step cache
write of every slot lands on page 0 instead of needing a branch per slot.

Per-family state beyond the pages (keyed per slot, not per page):

  hybrid   ssm_h (L, n_slots, H, P, N) f32 + ssm_conv (L, n_slots, W-1, C)
  ssm      the same recurrent state only: no pages, the block table unused

The recurrent families must be prefilled at exact length: padded tokens
would be folded into the SSM state (the serving engine sees to it).

Unlike the reference, which returns a new state, the port writes the pool
and the per-slot state in place (``insert_paged`` and ``decode_paged``
return the same dict): a copy of the SLM's 3 GB pool, or of mamba2-2.7b's
2.7 GB of 16-slot state, per token would dwarf the step itself.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops
from repro_torch.models import layers as L
from repro_torch.models import ssm as ssm_lib
from repro_torch.models import transformer

SLOT_STATE = ("ssm_h", "ssm_conv")


def pages_for(length: int, page_size: int) -> int:
    """Pages needed to hold ``length`` cache entries."""
    return -(-length // page_size)


def init_paged(cfg: ModelConfig, n_slots: int, n_pages: int, page_size: int,
               device="cuda") -> dict:
    """Zeroed K/V page pools (not for the ssm family) and zeroed per-slot
    recurrent state (ssm and hybrid)."""
    transformer.require_ported(cfg)
    pstate = {}
    if cfg.family != "ssm":
        shape = (cfg.n_layers, n_pages, page_size, cfg.n_kv_heads,
                 cfg.head_dim)
        for name in ("k_pages", "v_pages"):
            pstate[name] = torch.zeros(shape, dtype=cfg.torch_dtype,
                                       device=device)
    if cfg.family in ("ssm", "hybrid"):
        st = ssm_lib.init_ssm_state(cfg, n_slots, device)
        pstate["ssm_h"] = st["h"][None].repeat(cfg.n_layers, 1, 1, 1, 1)
        pstate["ssm_conv"] = st["conv"][None].repeat(cfg.n_layers, 1, 1, 1)
    return pstate


def prefill_paged(params, cfg: ModelConfig, batch: dict, true_len: int):
    """Full forward over a prompt (right-padded for the dense family,
    exact for ssm and hybrid).

    Returns (last_logits (B, V) at the TRUE last position, the pack of
    per-request cache leaves: {"k", "v"} of (L, B, P+S_pad, K, hd) entries
    and/or {"ssm_h", "ssm_conv"} per-layer state, and kv_len = P +
    true_len, the entries the request owns after insertion).
    """
    tokens = batch["tokens"]
    prefix = batch.get("prefix_embeds")
    if cfg.family == "ssm":
        h, _, states = ssm_lib.forward(params, cfg, tokens, prefix,
                                       collect_state=True, return_hidden=True)
        pack = {"ssm_h": states[0], "ssm_conv": states[1]}
    else:
        h, _, kv = transformer.forward(params, cfg, tokens, prefix,
                                       collect_kv=True, return_hidden=True)
        pack = dict(zip(("k", "v") + SLOT_STATE, kv))
    P = h.shape[1] - tokens.shape[1]
    last = L.unembed(params["tok"], cfg, h[:, P + true_len - 1])
    return last, pack, P + true_len


def insert_paged(cfg: ModelConfig, pstate: dict, pack: dict, slot: int,
                 page_ids: torch.Tensor) -> dict:
    """Seat a B=1 prefill pack, in place: its KV scattered into
    ``page_ids`` (a count covering the padded prompt), its recurrent state
    written at ``slot``."""
    if "k" in pack:
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
    for name in SLOT_STATE:
        if name in pack:
            pstate[name][:, slot] = pack[name][:, 0].to(pstate[name].dtype)
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
    The recurrent state of every slot, idle ones included, advances (as in
    the reference; insertion overwrites an idle slot's).  Returns (logits
    (n_slots, V) float32, pstate updated in place)."""
    transformer.require_ported(cfg)
    if cfg.family == "ssm":
        return ssm_lib.decode_step(params, cfg, pstate, tokens)
    x = L.embed(params["tok"], cfg, tokens)
    pos_vec = seq_lens.long()
    lens_incl = torch.where(active, seq_lens + 1,
                            torch.zeros_like(seq_lens)).int()
    hybrid = cfg.family == "hybrid"
    for i, w in enumerate(transformer.window_array(cfg)):
        lp = L.layer_params(params["layers"], i)
        h = L.rms_norm(x, lp["ln1"], cfg.norm_eps)
        attn_out = _paged_decode_attention(
            lp["attn"], cfg, h, pos_vec, pstate["k_pages"][i],
            pstate["v_pages"][i], block_tables, lens_incl, w)
        if hybrid:
            ssm_out, st = ssm_lib.ssm_decode_step(
                lp["ssm"], cfg, {"h": pstate["ssm_h"][i],
                                 "conv": pstate["ssm_conv"][i]}, h)
            pstate["ssm_h"][i].copy_(st["h"])
            pstate["ssm_conv"][i].copy_(st["conv"])
            attn_out = 0.5 * (attn_out + ssm_out)
        y = x + attn_out
        h2 = L.rms_norm(y, lp["ln2"], cfg.norm_eps)
        x = y + L.mlp(lp["mlp"], cfg, h2)
    x = L.rms_norm(x, params["final_norm"], cfg.norm_eps)
    return L.unembed(params["tok"], cfg, x)[:, 0], pstate
