"""Public wrappers around the port's kernels.

A tensor on the CPU takes the plain PyTorch version; a tensor on a CUDA
device launches the hand-written kernel, or raises.  There is no switch
and no fallback: the device of the input decides.  The model's wrappers
are differentiable: on the card through the kernels'
``autograd.Function``s, on the CPU through the plain versions' own
autograd.  The wire codec's pair and the SSD scan are forward only (the
SSD kernel raises where a gradient would be needed).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels.flash_attention import (flash_attention_autograd,
                                                 flash_attention_plain)
from repro_torch.kernels.gram_volume import (gram_log_volume_autograd,
                                             gram_log_volume_plain)
from repro_torch.kernels.lora_matmul import (lora_matmul_autograd,
                                             lora_matmul_plain)
from repro_torch.kernels.paged_attention import (paged_attention_cuda,
                                                 paged_attention_plain)
from repro_torch.kernels.quantize import (dequantize_rows_cuda,
                                          dequantize_rows_plain,
                                          quantize_rows_cuda,
                                          quantize_rows_plain)
from repro_torch.kernels.ssd_scan import ssd_chunk_cuda, ssd_chunk_plain


def attention(q, k, v, causal: bool = True, window: int = 0):
    """GQA-aware attention in the model layout.  q: (B,Sq,H,D)
    k,v: (B,Sk,K,D); queries aligned to the end of the keys; ``window``
    <= 0 (or ``layers.BIG_WINDOW``) means none.  Returns (B, Sq, H*D) in
    q's dtype."""
    B, Sq, H, D = q.shape
    fn = flash_attention_autograd if q.is_cuda else flash_attention_plain
    return fn(q, k, v, causal=causal, window=window).reshape(B, Sq, H * D)


def lora_matmul(x, w, a, b, scale: float):
    """y = x @ w + scale * (x @ a) @ b for x (M, K), w (K, N) frozen,
    a (K, r), b (r, N): f32 sums, rounded once to x's dtype."""
    fn = lora_matmul_autograd if x.is_cuda else lora_matmul_plain
    return fn(x, w, a, b, scale)


def gram_log_volume(vs, mask, eps: float = 1e-5):
    """Masked log-volumes (B,) f32 of vs (B, k, d) under mask (B, k) bool
    (``repro.core.gram.log_volume``).  On the card the forward keeps the
    raw dot products, and the backward kernel reads them instead of the
    rows a second time."""
    fn = gram_log_volume_autograd if vs.is_cuda else gram_log_volume_plain
    return fn(vs, mask, eps)


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


def quantize(x, qmax: int = 127):
    """Per-row symmetric abs-max quantization.  x: (R, L), one wire tile
    per row -> (q int8 (R, L), scale f32 (R,))."""
    fn = quantize_rows_cuda if x.is_cuda else quantize_rows_plain
    return fn(x, qmax)


def dequantize(q, scale):
    """Inverse of :func:`quantize`: (R, L) int8 and (R,) f32 -> f32."""
    fn = dequantize_rows_cuda if q.is_cuda else dequantize_rows_plain
    return fn(q, scale)


def ssd_chunked(x, dt, A, B_, C_, chunk: int, return_state: bool = False):
    """Full chunked SSD (the contract of ``repro.models.ssm.ssd_reference``).

    x: (B,S,H,P)  dt: (B,S,H)  A: (H,) negative  B_,C_: (B,S,G,N).  A
    ragged S is padded with zero rows (dt = 0 rows add nothing and keep the
    cumulative decay flat) and trimmed again.  The intra-chunk term and the
    chunk end states of all chunks and heads come from one call of the SSD
    chunk kernel (its plain version on the CPU); the recurrence across
    chunks and its output term are plain PyTorch, as the reference keeps
    them in jnp.  Returns y (B,S,H,P) in x's dtype and, with
    ``return_state``, the final state (B,H,P,N) f32."""
    Bsz, S, H, P = x.shape
    G, N = B_.shape[2], B_.shape[3]
    pad = -S % chunk
    if pad:
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        B_ = F.pad(B_, (0, 0, 0, 0, 0, pad))
        C_ = F.pad(C_, (0, 0, 0, 0, 0, pad))
    Sp = S + pad
    nc, L = Sp // chunk, chunk
    dt = dt.float().contiguous()
    cum = torch.cumsum((dt * A.float()).reshape(Bsz, nc, L, H), dim=2)
    fn = ssd_chunk_cuda if x.is_cuda else ssd_chunk_plain
    y_intra, states = fn(x.contiguous(), dt, cum.reshape(Bsz, Sp, H),
                         B_.contiguous(), C_.contiguous(), chunk)

    # the recurrence across chunks: h_c = exp(total_c) h_{c-1} + states_c
    total = torch.exp(cum[:, :, -1])                             # (B,nc,H)
    h = torch.zeros((Bsz, H, P, N), dtype=torch.float32, device=x.device)
    h_prev = []
    for c in range(nc):
        h_prev.append(h)
        h = total[:, c, :, None, None] * h + states[:, c]
    h_prev = torch.stack(h_prev, dim=1).reshape(Bsz, nc, G, H // G, P, N)
    Cc = C_.float().reshape(Bsz, nc, L, G, N)
    y_inter = torch.einsum("bclgn,bcgrpn->bclgrp", Cc, h_prev).reshape(
        Bsz, nc, L, H, P) * torch.exp(cum)[..., None]
    y = (y_intra.reshape(Bsz, nc, L, H, P) + y_inter).reshape(
        Bsz, Sp, H, P)[:, :S].to(x.dtype)
    return (y, h) if return_state else y
