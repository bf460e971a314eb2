"""Blockwise causal / sliding-window attention (prefill): the CUDA kernel
``csrc/flash_attention.cu`` and its plain PyTorch version.

The kernel replaces the TPU kernel ``repro.kernels.flash_attention.
flash_attention``.  Unlike the TPU wrapper it takes the model layout
(B, S, heads, D) and grouped KV heads directly: no transpose, no repeat,
no padding.  :func:`flash_attention_cuda` counts its launches in
``flash_attention_cuda.launches``.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import attention_ref

__all__ = ["flash_attention_cuda", "flash_attention_plain",
           "SUPPORTED_HEAD_DIMS"]

SUPPORTED_HEAD_DIMS = (32, 64, 128, 256)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _lib():
    lib = _build.library("flash_attention")
    fn = lib.flash_attention_launch
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 9 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        lib.flash_attention_error_string.argtypes = [ctypes.c_int]
        lib.flash_attention_error_string.restype = ctypes.c_char_p
    return lib


def flash_attention_plain(q, k, v, causal: bool = True, window: int = 0):
    """Plain PyTorch version.  q: (B,Sq,H,D)  k,v: (B,Sk,K,D) ->
    (B,Sq,H,D) in q's dtype; f32 softmax, queries end-aligned."""
    H, K = q.shape[2], k.shape[2]
    if K != H:
        k = k.repeat_interleave(H // K, dim=2)
        v = v.repeat_interleave(H // K, dim=2)
    out = attention_ref(q.transpose(1, 2), k.transpose(1, 2),
                        v.transpose(1, 2), causal=causal, window=window)
    return out.transpose(1, 2).to(q.dtype)


def flash_attention_cuda(q, k, v, causal: bool = True, window: int = 0):
    """Launch the prefill attention kernel.

    q: (B, Sq, H, D);  k, v: (B, Sk, K, D) with H a multiple of K, all
    contiguous on one CUDA device in float32 or bfloat16.  Queries are
    aligned to the end of the keys; ``window`` <= 0 means no window.
    Returns (B, Sq, H, D) in q's dtype.
    """
    B, Sq, H, D = q.shape
    Bk, Sk, K, Dk = k.shape
    if Bk != B or Dk != D or tuple(v.shape) != (B, Sk, K, D):
        raise ValueError(f"bad shapes q{tuple(q.shape)} k{tuple(k.shape)} "
                         f"v{tuple(v.shape)}")
    if K == 0 or H % K:
        raise ValueError(f"H={H} is not a multiple of K={K}")
    if D not in SUPPORTED_HEAD_DIMS:
        raise ValueError(f"head_dim {D} not in {SUPPORTED_HEAD_DIMS}")
    if B * H > 65535:
        raise ValueError(f"B*H={B * H} exceeds the grid's y limit 65535")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"q/k/v must share one of {list(_DTYPES)}")
    if any(t.device != q.device for t in (k, v)) or q.device.type != "cuda":
        raise ValueError("all inputs must lie on one CUDA device")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("q, k and v must be contiguous")
    out = torch.empty_like(q)
    lib = _lib()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = lib.flash_attention_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            B, H, K, Sq, Sk, D, int(bool(causal)), int(window),
            _DTYPES[q.dtype], stream)
    if rc:
        raise RuntimeError("flash_attention launch failed: "
                           + lib.flash_attention_error_string(rc).decode())
    flash_attention_cuda.launches += 1
    return out


flash_attention_cuda.launches = 0
