"""Decode-mode (Sq = 1) attention over a paged KV cache: the CUDA kernel
``csrc/paged_attention.cu`` and its plain PyTorch version.

The kernel replaces the TPU kernel ``repro.kernels.paged_attention.
paged_flash_attention``.  :func:`paged_attention_cuda` launches it on
PyTorch's current stream and counts its launches in
``paged_attention_cuda.launches``; :func:`paged_attention_plain` is the
same function in plain PyTorch (the CPU path and the kernel's oracle).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import paged_attention_ref as paged_attention_plain

__all__ = ["paged_attention_cuda", "paged_attention_plain", "SUPPORTED_HEAD_DIMS"]

SUPPORTED_HEAD_DIMS = (32, 64, 128, 256)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


# the C functions of csrc/paged_attention.cu: argument types, return type
C_FUNCTIONS = {
    "paged_attention_launch": (
        [ctypes.c_void_p] * 6 + [ctypes.c_int] * 8 + [ctypes.c_void_p],
        ctypes.c_int),
    "paged_attention_error_string": ([ctypes.c_int], ctypes.c_char_p),
}


def _lib():
    return _build.library("paged_attention", C_FUNCTIONS)


def _check_aligned(name, t):
    if t.data_ptr() % 16:
        raise ValueError(f"{name} must be 16-byte aligned")


def paged_attention_cuda(q, k_pages, v_pages, block_tables, lens,
                         window: int):
    """Launch the paged decode kernel.

    q: (B, 1, H, D);  k_pages/v_pages: (P, ps, K, D) in q's dtype (float32
    or bfloat16);  block_tables: (B, M) int32;  lens: (B,) int32, valid
    entries per slot including the newest token (0 = idle slot, zeros out);
    window: keys with ``len - 1 - kpos >= window`` are masked (<= 0: none).
    All tensors contiguous on one CUDA device.  Returns (B, 1, H, D).
    """
    B, one, H, D = q.shape
    P, ps, K, Dk = k_pages.shape
    if one != 1 or Dk != D or tuple(v_pages.shape) != (P, ps, K, D):
        raise ValueError(f"bad shapes q{tuple(q.shape)} k{tuple(k_pages.shape)} "
                         f"v{tuple(v_pages.shape)}")
    if K == 0 or H % K:
        raise ValueError(f"H={H} is not a multiple of K={K}")
    if D not in SUPPORTED_HEAD_DIMS:
        raise ValueError(f"head_dim {D} not in {SUPPORTED_HEAD_DIMS}")
    if q.dtype not in _DTYPES or k_pages.dtype != q.dtype \
            or v_pages.dtype != q.dtype:
        raise TypeError(f"q/k/v must share one of {list(_DTYPES)}")
    if block_tables.dtype != torch.int32 or lens.dtype != torch.int32:
        raise TypeError("block_tables and lens must be int32")
    if block_tables.dim() != 2 or block_tables.shape[0] != B \
            or tuple(lens.shape) != (B,):
        raise ValueError("block_tables must be (B, M) and lens (B,)")
    tensors = (q, k_pages, v_pages, block_tables, lens)
    if any(t.device != q.device for t in tensors) or q.device.type != "cuda":
        raise ValueError("all inputs must lie on one CUDA device")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("all inputs must be contiguous")
    for name, t in (("q", q), ("k_pages", k_pages), ("v_pages", v_pages)):
        _check_aligned(name, t)
    out = torch.empty_like(q)
    lib = _lib()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = lib.paged_attention_launch(
            q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
            block_tables.data_ptr(), lens.data_ptr(), out.data_ptr(),
            B, H, K, D, ps, block_tables.shape[1], int(window),
            _DTYPES[q.dtype], stream)
    if rc:
        raise RuntimeError("paged_attention launch failed: "
                           + lib.paged_attention_error_string(rc).decode())
    paged_attention_cuda.launches += 1
    return out


paged_attention_cuda.launches = 0
