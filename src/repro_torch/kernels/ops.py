"""Public wrappers around the port's kernels.

A tensor on the CPU takes the plain PyTorch version; a tensor on a CUDA
device launches the hand-written kernel, or raises.  There is no switch
and no fallback: the device of the input decides.  The model's wrappers
are differentiable: on the card through the kernels'
``autograd.Function``s, on the CPU through the plain versions' own
autograd.  The wire codec's pair is forward only.
"""
from __future__ import annotations

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
    (``repro.core.gram.log_volume``)."""
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
