"""Per-row symmetric abs-max quantization and its inverse (the int8/int4
wire codec's tiles): the CUDA kernels in ``csrc/quantize.cu`` and their
plain PyTorch versions.

The kernels replace the TPU kernels ``repro.kernels.quantize.
quantize_rows`` and ``dequantize_rows``.  Each row of x is one wire tile:
``scale = absmax(row) * float32(1/qmax)`` (one multiply, never a divide:
the divide form is one ULP away from itself across lowerings),
``q = clamp(round_half_even(x / safe), -qmax, qmax)`` as int8 with
``safe = scale if scale > 0 else 1``, so an all-zero row gets scale 0
and codes 0; dequantize is ``q * scale`` in f32.  Kernel and plain
version agree bit for bit.  Unlike the TPU wrapper nothing is padded:
any row count and row length is taken as it is.
:func:`quantize_rows_cuda` and :func:`dequantize_rows_cuda` count their
launches in ``.launches``.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from repro_torch.kernels import _build

__all__ = ["quantize_rows_cuda", "quantize_rows_plain",
           "dequantize_rows_cuda", "dequantize_rows_plain"]

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


# the C functions of csrc/quantize.cu: argument types, return type
C_FUNCTIONS = {
    "quantize_rows_launch": (
        [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4 + [ctypes.c_void_p],
        ctypes.c_int),
    "dequantize_rows_launch": (
        [ctypes.c_void_p] * 3 + [ctypes.c_int] * 2 + [ctypes.c_void_p],
        ctypes.c_int),
    "quantize_error_string": ([ctypes.c_int], ctypes.c_char_p),
}


def _lib():
    return _build.library("quantize", C_FUNCTIONS)


def _check_qmax(qmax: int) -> int:
    if not 1 <= int(qmax) <= 127:
        raise ValueError(f"qmax must lie in [1, 127]; got {qmax}")
    return int(qmax)


def quantize_rows_plain(x, qmax: int = 127):
    """Plain PyTorch version.  x: (R, L) floats -> (int8 (R, L), f32
    scales (R,)); the reference's arithmetic, element for element."""
    qmax = _check_qmax(qmax)
    xf = x.float()
    inv = torch.full((), float(np.float32(1.0 / qmax)), dtype=torch.float32,
                     device=x.device)
    scale = xf.abs().amax(dim=-1) * inv
    safe = torch.where(scale > 0, scale, torch.ones_like(scale))
    q = torch.clamp(torch.round(xf / safe[:, None]), -qmax, qmax)
    return q.to(torch.int8), scale


def dequantize_rows_plain(q, scale):
    """Plain PyTorch version: (R, L) int8 and (R,) f32 -> (R, L) f32."""
    return q.float() * scale[:, None]


def quantize_rows_cuda(x, qmax: int = 127):
    """Launch the quantize kernel.  x: (R, L) contiguous float32 or
    bfloat16 on a CUDA device.  Returns (int8 (R, L), f32 scales (R,))."""
    qmax = _check_qmax(qmax)
    if x.dim() != 2:
        raise ValueError(f"x must be (R, L); got {tuple(x.shape)}")
    if x.dtype not in _DTYPES:
        raise TypeError(f"x must be one of {list(_DTYPES)}; got {x.dtype}")
    if x.device.type != "cuda" or not x.is_contiguous():
        raise ValueError("x must be a contiguous CUDA tensor")
    R, L = x.shape
    q = torch.empty((R, L), dtype=torch.int8, device=x.device)
    scale = torch.empty((R,), dtype=torch.float32, device=x.device)
    lib = _lib()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = lib.quantize_rows_launch(x.data_ptr(), q.data_ptr(),
                                      scale.data_ptr(), R, L, qmax,
                                      _DTYPES[x.dtype], stream)
    if rc:
        raise RuntimeError("quantize_rows launch failed: "
                           + lib.quantize_error_string(rc).decode())
    quantize_rows_cuda.launches += 1
    return q, scale


quantize_rows_cuda.launches = 0


def dequantize_rows_cuda(q, scale):
    """Launch the dequantize kernel.  q: (R, L) contiguous int8, scale:
    (R,) contiguous float32, both on one CUDA device.  Returns (R, L) f32."""
    if q.dim() != 2 or tuple(scale.shape) != (q.shape[0],):
        raise ValueError(f"bad shapes q{tuple(q.shape)} "
                         f"scale{tuple(scale.shape)}")
    if q.dtype != torch.int8 or scale.dtype != torch.float32:
        raise TypeError("q must be int8 and scale float32")
    if q.device.type != "cuda" or scale.device != q.device \
            or not (q.is_contiguous() and scale.is_contiguous()):
        raise ValueError("q and scale must be contiguous on one CUDA device")
    R, L = q.shape
    out = torch.empty((R, L), dtype=torch.float32, device=q.device)
    lib = _lib()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = lib.dequantize_rows_launch(q.data_ptr(), scale.data_ptr(),
                                        out.data_ptr(), R, L, stream)
    if rc:
        raise RuntimeError("dequantize_rows launch failed: "
                           + lib.quantize_error_string(rc).decode())
    dequantize_rows_cuda.launches += 1
    return out


dequantize_rows_cuda.launches = 0
