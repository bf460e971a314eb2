"""Fused LoRA projection y = x @ W + scale * (x @ A) @ B: the CUDA kernel
``csrc/lora_matmul.cu``, its autograd wrapper and its plain PyTorch version.

The kernel replaces the TPU kernel ``repro.kernels.lora_matmul.
lora_matmul``.  Unlike the TPU kernel it masks ragged M, N and K, and it
reads W transposed in place for the backward's dx = dy @ W^T +
s * (dy @ B^T) @ A^T.  W is frozen: it gets no gradient.  dA and dB are
rank-r products (no TPU counterpart) computed with ``torch.matmul`` in
float32.

Two routes (``csrc/lora_matmul.cu``): bf16 operands whose K, N and r are
multiples of 8 take the ``"wgmma"`` kernel (TMA-fed tiles, tensor cores);
every other input takes the ``"fma"`` kernel (f32 FMAs).
:func:`lora_matmul_route` picks one from dtypes and shapes before the
launch.  :func:`lora_matmul_cuda` counts its launches in
``lora_matmul_cuda.launches`` and per route in
``lora_matmul_cuda.launches_by_route``.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build, _route

__all__ = ["lora_matmul_cuda", "lora_matmul_plain", "lora_matmul_autograd",
           "lora_matmul_route", "MAX_RANK", "ROUTES"]

MAX_RANK = 32
ROUTES = ("wgmma", "fma")
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


# the C functions of csrc/lora_matmul.cu: argument types, return type
C_FUNCTIONS = {
    "lora_matmul_launch": (
        [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5
        + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p], ctypes.c_int),
    "lora_matmul_wgmma_launch": (
        [ctypes.c_void_p] * 4 + [ctypes.c_longlong] * 2 + [ctypes.c_void_p]
        + [ctypes.c_int] * 5 + [ctypes.c_float, ctypes.c_void_p],
        ctypes.c_int),
    "lora_matmul_error_string": ([ctypes.c_int], ctypes.c_char_p),
}


def _lib():
    return _build.library("lora_matmul", C_FUNCTIONS)


def lora_matmul_plain(x, w, a, b, scale: float):
    """Plain PyTorch version, differentiable by autograd: f32 products,
    rounded once to x's dtype.  x (M,K), w (K,N), a (K,r), b (r,N)."""
    xf = x.float()
    y = xf @ w.float() + scale * ((xf @ a.float()) @ b.float())
    return y.to(x.dtype)


def lora_matmul_route(x, w, a, b, trans_w: bool = False) -> str:
    """The kernel that :func:`lora_matmul_cuda` launches for these inputs:
    ``"wgmma"`` for bf16 x, W, A, B with K, N and r multiples of 8 and x, W
    at 16-byte aligned offsets (what TMA takes), else ``"fma"``.  Reads
    only dtypes, shapes and offsets (CPU or meta tensors do); raises on
    shapes or dtypes no route takes."""
    M, K = x.shape
    N = w.shape[0] if trans_w else w.shape[1]
    wk = w.shape[1] if trans_w else w.shape[0]
    r = a.shape[1]
    if wk != K or tuple(a.shape) != (K, r) or tuple(b.shape) != (r, N):
        raise ValueError(f"bad shapes x{tuple(x.shape)} w{tuple(w.shape)} "
                         f"a{tuple(a.shape)} b{tuple(b.shape)} "
                         f"trans_w={trans_w}")
    if not 1 <= r <= MAX_RANK:
        raise ValueError(f"rank {r} outside [1, {MAX_RANK}]")
    if x.dtype not in _DTYPES or any(t.dtype != x.dtype for t in (w, a, b)):
        raise TypeError(f"x/w/a/b must share one of {list(_DTYPES)}")
    if (x.dtype == torch.bfloat16 and K > 0 and K % 8 == 0 and N % 8 == 0
            and r % 8 == 0 and _route.aligned16(x) and _route.aligned16(w)):
        return "wgmma"
    return "fma"


def lora_matmul_cuda(x, w, a, b, scale: float, trans_w: bool = False,
                     route: str | None = None):
    """Launch the fused LoRA projection kernel of
    :func:`lora_matmul_route`'s choice, or of ``route`` ("fma" takes
    every input; "wgmma" only those the route function gives it).

    x (M, K); w (K, N), or (N, K) read as its transpose when ``trans_w``;
    a (K, r); b (r, N), 1 <= r <= 32; on one CUDA device in float32 or
    bfloat16.  x and w must be contiguous; a and b may be any views (the
    backward passes transposes).  Returns y (M, N) in x's dtype, summed in
    f32 and rounded once.
    """
    route = _route.pick(lora_matmul_route(x, w, a, b, trans_w), route)
    M, K = x.shape
    N = b.shape[1]
    r = a.shape[1]
    if x.device.type != "cuda" or any(t.device != x.device for t in (w, a, b)):
        raise ValueError("all inputs must lie on one CUDA device")
    if not (x.is_contiguous() and w.is_contiguous()):
        raise ValueError("x and w must be contiguous")
    if -(-M // 64) > 65535:
        raise ValueError(f"M={M} exceeds the grid's y limit")
    y = torch.empty((M, N), dtype=x.dtype, device=x.device)
    lib = _lib()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        if route == "wgmma":
            # A^T (r, K) row-major is the K-major operand of t = x @ A;
            # the transpose of the backward's A view is contiguous already
            at = a.t().contiguous()
            if not _route.aligned16(at):
                at = at.clone()
            rc = lib.lora_matmul_wgmma_launch(
                x.data_ptr(), w.data_ptr(), at.data_ptr(), b.data_ptr(),
                b.stride(0), b.stride(1), y.data_ptr(), M, N, K, r,
                int(bool(trans_w)), float(scale), stream)
        else:
            a, b = a.contiguous(), b.contiguous()
            rc = lib.lora_matmul_launch(
                x.data_ptr(), w.data_ptr(), a.data_ptr(), b.data_ptr(),
                y.data_ptr(), M, N, K, r, int(bool(trans_w)), float(scale),
                _DTYPES[x.dtype], stream)
    if rc:
        raise RuntimeError(f"lora_matmul ({route}) launch failed: "
                           + lib.lora_matmul_error_string(rc).decode())
    lora_matmul_cuda.launches += 1
    lora_matmul_cuda.launches_by_route[route] += 1
    return y


lora_matmul_cuda.launches = 0
lora_matmul_cuda.launches_by_route = dict.fromkeys(ROUTES, 0)


class _LoraMatmul(torch.autograd.Function):
    """Forward and dx through the kernel; dA, dB as f32 rank-r products."""

    @staticmethod
    def forward(ctx, x, w, a, b, scale):
        if w.requires_grad:
            raise NotImplementedError("lora_matmul: W is frozen (no dW)")
        ctx.save_for_backward(x, w, a, b)
        ctx.scale = scale
        return lora_matmul_cuda(x, w, a, b, scale)

    @staticmethod
    def backward(ctx, dy):
        x, w, a, b = ctx.saved_tensors
        s = ctx.scale
        dy = dy.contiguous()
        dx = da = db = None
        if ctx.needs_input_grad[0]:
            dx = lora_matmul_cuda(dy, w, b.t(), a.t(), s, trans_w=True)
        if ctx.needs_input_grad[2] or ctx.needs_input_grad[3]:
            xf, dyf = x.float(), dy.float()
            if ctx.needs_input_grad[2]:
                da = (s * (xf.t() @ (dyf @ b.float().t()))).to(a.dtype)
            if ctx.needs_input_grad[3]:
                db = (s * ((xf @ a.float()).t() @ dyf)).to(b.dtype)
        return dx, None, da, db, None


def lora_matmul_autograd(x, w, a, b, scale: float):
    """The kernel with gradients for x, A and B (W frozen)."""
    return _LoraMatmul.apply(x, w, a, b, scale)
