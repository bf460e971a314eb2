"""Public wrappers around the attention kernels.

A tensor on the CPU takes the plain PyTorch version; a tensor on a CUDA
device launches the hand-written kernel, or raises.  There is no switch
and no fallback: the device of the input decides.
"""
from __future__ import annotations

from repro_torch.kernels.flash_attention import (flash_attention_cuda,
                                                 flash_attention_plain)
from repro_torch.kernels.paged_attention import (paged_attention_cuda,
                                                 paged_attention_plain)


def attention(q, k, v, causal: bool = True, window: int = 0):
    """GQA-aware attention in the model layout.  q: (B,Sq,H,D)
    k,v: (B,Sk,K,D); queries aligned to the end of the keys; ``window``
    <= 0 (or ``layers.BIG_WINDOW``) means none.  Returns (B, Sq, H*D) in
    q's dtype."""
    B, Sq, H, D = q.shape
    fn = flash_attention_cuda if q.is_cuda else flash_attention_plain
    return fn(q, k, v, causal=causal, window=window).reshape(B, Sq, H * D)


def paged_attention(q, k_pages, v_pages, block_tables, lens, window: int):
    """Decode-mode (Sq=1) attention over a paged KV cache, GQA-aware.

    q: (B, 1, H, D);  k_pages/v_pages: (P, ps, K, D);  block_tables: (B, M)
    int32 page ids;  lens: (B,) int32 valid entries per slot including the
    newest token (0 = idle slot);  window: a plain int per layer (<= 0 or
    ``layers.BIG_WINDOW`` = none).  Returns (B, 1, H * D)."""
    B, _, H, D = q.shape
    fn = paged_attention_cuda if q.is_cuda else paged_attention_plain
    return fn(q, k_pages, v_pages, block_tables, lens, window).reshape(
        B, 1, H * D)
