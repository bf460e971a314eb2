"""Plain PyTorch oracles for the attention kernels: the same functions as
``repro.kernels.ref.attention_ref`` and ``paged_attention_ref``, in float32.

They copy nothing from the host once called, so a CUDA graph can capture
them (``chip_smoke.py`` times them that way)."""
from __future__ import annotations

import math
from typing import Optional

import torch

NEG_INF = -1e30


def attention_ref(q, k, v, causal: bool = True,
                  window: Optional[int] = None):
    """q: (B,H,Sq,D)  k,v: (B,H,Sk,D) (kv already repeated to H heads).

    Queries align to the end of the KV sequence.  Returns float32
    (B,H,Sq,D)."""
    D = q.shape[-1]
    logits = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) \
        / math.sqrt(D)
    Sq, Sk = q.shape[2], k.shape[2]
    qpos = torch.arange(Sq, device=q.device)[:, None] + (Sk - Sq)
    kpos = torch.arange(Sk, device=q.device)[None, :]
    mask = torch.ones((Sq, Sk), dtype=torch.bool, device=q.device)
    if causal:
        mask &= kpos <= qpos
    if window is not None and window > 0:
        mask &= (qpos - kpos) < window
    logits = logits.masked_fill(~mask[None, None], NEG_INF)
    w = torch.softmax(logits, dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", w, v.float())


def paged_attention_ref(q, k_pages, v_pages, block_tables, lens,
                        window: Optional[int] = None):
    """Decode-mode oracle.  q: (B,1,H,D);  k_pages/v_pages: (P,ps,K,D);
    block_tables: (B,M) page ids;  lens: (B,) valid entries incl. the newest
    token.  KV heads are grouped (GQA); idle slots (len 0) return zeros.
    Returns (B, 1, H, D) in q's dtype."""
    B, _, H, D = q.shape
    ps, K = k_pages.shape[1], k_pages.shape[2]
    M = block_tables.shape[1]
    G = H // K
    bt = block_tables.long()
    k = k_pages[bt].reshape(B, M * ps, K, D).float()
    v = v_pages[bt].reshape(B, M * ps, K, D).float()
    qf = q.float().reshape(B, K, G, D)
    logits = torch.einsum("bkgd,bskd->bkgs", qf, k) / math.sqrt(D)
    qpos = lens.long()[:, None] - 1
    kpos = torch.arange(M * ps, device=q.device)[None, :]
    mask = kpos <= qpos
    if window is not None and window > 0:
        mask &= (qpos - kpos) < window
    logits = logits.masked_fill(~mask[:, None, None], NEG_INF)
    w = torch.softmax(logits, dim=-1)
    w = w.masked_fill((lens <= 0)[:, None, None, None], 0.0)   # idle slots
    out = torch.einsum("bkgs,bskd->bkgd", w, v)
    return out.reshape(B, 1, H, D).to(q.dtype)
