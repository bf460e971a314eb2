"""Blockwise causal / sliding-window attention (prefill) and its gradient:
the CUDA kernels in ``csrc/flash_attention.cu`` and their plain PyTorch
versions.

The forward kernel replaces the TPU kernel ``repro.kernels.flash_attention.
flash_attention``.  Unlike the TPU wrapper it takes the model layout
(B, S, heads, D) and grouped KV heads directly: no transpose, no repeat,
no padding.  The TPU kernel is forward only (JAX differentiates the
attention of ``models/layers.py:mha``); here the backward is a kernel too,
which recomputes the probabilities from the forward's per-row
log-sum-exp.  Forward and backward each have two routes: bf16 with D in
{64, 128, 256} takes the ``"mma"`` kernels (tensor cores), every other
input the ``"fma"`` kernels (f32 FMAs); :func:`flash_attention_route` and
:func:`flash_attention_backward_route` pick one before the launch, and
``route="fma"`` forces the FMA kernels.  :func:`flash_attention_cuda` and
:func:`flash_attention_backward_cuda` count their launches in
``.launches`` and per route in ``.launches_by_route``.
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import _build, _route
from repro_torch.kernels.ref import NEG_INF, attention_ref

__all__ = ["flash_attention_cuda", "flash_attention_plain",
           "flash_attention_backward_cuda", "flash_attention_backward_plain",
           "flash_attention_autograd", "flash_attention_route",
           "flash_attention_backward_route", "SUPPORTED_HEAD_DIMS",
           "MMA_HEAD_DIMS", "ROUTES"]

SUPPORTED_HEAD_DIMS = (32, 64, 128, 256)
MMA_HEAD_DIMS = (64, 128, 256)
ROUTES = ("mma", "fma")
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


# the C functions of csrc/flash_attention.cu: argument types, return type
C_FUNCTIONS = {
    "flash_attention_launch": (
        [ctypes.c_void_p] * 5 + [ctypes.c_int] * 9 + [ctypes.c_void_p],
        ctypes.c_int),
    "flash_attention_mma_launch": (
        [ctypes.c_void_p] * 5 + [ctypes.c_int] * 8 + [ctypes.c_void_p],
        ctypes.c_int),
    "flash_attention_backward_launch": (
        [ctypes.c_void_p] * 10 + [ctypes.c_int] * 9 + [ctypes.c_void_p],
        ctypes.c_int),
    "flash_attention_backward_mma_launch": (
        [ctypes.c_void_p] * 10 + [ctypes.c_int] * 8 + [ctypes.c_void_p],
        ctypes.c_int),
    "flash_attention_error_string": ([ctypes.c_int], ctypes.c_char_p),
}


def _lib():
    return _build.library("flash_attention", C_FUNCTIONS)


def _logits_and_mask(q, k, causal: bool, window: int):
    """Scaled f32 logits (B, K, G, Sq, Sk) of q (B,Sq,H,D) against k
    (B,Sk,K,D), and the (Sq, Sk) mask of visible keys (queries aligned to
    the end of the keys; ``window`` <= 0 means none)."""
    B, Sq, H, D = q.shape
    Sk, K = k.shape[1], k.shape[2]
    qg = q.float().reshape(B, Sq, K, H // K, D)
    s = torch.einsum("bqkgd,bskd->bkgqs", qg, k.float()) / math.sqrt(D)
    qpos = torch.arange(Sq, device=q.device)[:, None] + (Sk - Sq)
    kpos = torch.arange(Sk, device=q.device)[None, :]
    mask = torch.ones((Sq, Sk), dtype=torch.bool, device=q.device)
    if causal:
        mask &= kpos <= qpos
    if window > 0:
        mask &= (qpos - kpos) < window
    return s, mask


def _row_lse(q, k, causal: bool, window: int):
    """Per-row log-sum-exp (B, H, Sq) f32 of the masked scaled logits."""
    B, Sq, H, _ = q.shape
    s, mask = _logits_and_mask(q, k, causal, window)
    lse = torch.logsumexp(s.masked_fill(~mask, NEG_INF), dim=-1)
    return lse.reshape(B, H, Sq)


def flash_attention_plain(q, k, v, causal: bool = True, window: int = 0,
                          with_lse: bool = False):
    """Plain PyTorch version.  q: (B,Sq,H,D)  k,v: (B,Sk,K,D) ->
    (B,Sq,H,D) in q's dtype; f32 softmax, queries end-aligned.  With
    ``with_lse`` also each row's log-sum-exp (B, H, Sq) f32."""
    H, K = q.shape[2], k.shape[2]
    kr, vr = k, v
    if K != H:
        kr = k.repeat_interleave(H // K, dim=2)
        vr = v.repeat_interleave(H // K, dim=2)
    out = attention_ref(q.transpose(1, 2), kr.transpose(1, 2),
                        vr.transpose(1, 2), causal=causal, window=window)
    out = out.transpose(1, 2).to(q.dtype)
    if with_lse:
        return out, _row_lse(q, k, causal, window)
    return out


def flash_attention_backward_plain(q, k, v, o, do, lse, causal: bool = True,
                                   window: int = 0):
    """The function the backward kernel computes, in f32: P = exp(s - lse)
    on the visible keys (0 elsewhere), delta = rowsum(dO * O),
    dS = P (dO V^T - delta), dQ = dS K / sqrt(D), dK = dS^T Q / sqrt(D)
    (summed over each KV head's G query heads), dV = P^T dO.  Returns
    (dq, dk, dv) in q's dtype."""
    B, Sq, H, D = q.shape
    K = k.shape[2]
    G = H // K
    s, mask = _logits_and_mask(q, k, causal, window)
    L = lse.float().reshape(B, K, G, Sq, 1)
    p = torch.where(mask, torch.exp(s - L), torch.zeros((), device=q.device))
    dof = do.float().reshape(B, Sq, K, G, D)
    delta = (dof * o.float().reshape(B, Sq, K, G, D)).sum(-1)   # (B,Sq,K,G)
    dp = torch.einsum("bqkgd,bskd->bkgqs", dof, v.float())
    ds = p * (dp - delta.permute(0, 2, 3, 1)[..., None])
    scale = 1.0 / math.sqrt(D)
    dq = torch.einsum("bkgqs,bskd->bqkgd", ds, k.float()) * scale
    dk = torch.einsum("bkgqs,bqkgd->bskd", ds,
                      q.float().reshape(B, Sq, K, G, D)) * scale
    dv = torch.einsum("bkgqs,bqkgd->bskd", p, dof)
    dt = q.dtype
    return dq.reshape(B, Sq, H, D).to(dt), dk.to(dt), dv.to(dt)


def _check_shapes(q, k, v):
    """Raise on shapes or dtypes that no kernel takes (device unchecked)."""
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


def _check_inputs(q, k, v):
    _check_shapes(q, k, v)
    if any(t.device != q.device for t in (k, v)) or q.device.type != "cuda":
        raise ValueError("all inputs must lie on one CUDA device")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("q, k and v must be contiguous")


def _raise_on(rc: int, lib, what: str) -> None:
    if rc:
        raise RuntimeError(f"{what} launch failed: "
                           + lib.flash_attention_error_string(rc).decode())


def flash_attention_route(q, k, v) -> str:
    """The forward kernel that :func:`flash_attention_cuda` launches for
    these inputs: ``"mma"`` for bf16 with D in ``MMA_HEAD_DIMS`` and q, k,
    v at 16-byte aligned offsets (16-byte copies), else ``"fma"``.  Reads
    only dtypes, shapes and offsets (CPU or meta tensors do); raises on
    inputs no route takes."""
    _check_shapes(q, k, v)
    if (q.dtype == torch.bfloat16 and q.shape[3] in MMA_HEAD_DIMS
            and all(_route.aligned16(t) for t in (q, k, v))):
        return "mma"
    return "fma"


def flash_attention_backward_route(q, k, v) -> str:
    """The backward kernels that :func:`flash_attention_backward_cuda`
    launches for these inputs: the forward's rule
    (:func:`flash_attention_route`)."""
    return flash_attention_route(q, k, v)


def flash_attention_cuda(q, k, v, causal: bool = True, window: int = 0,
                         with_lse: bool = False, route: str | None = None):
    """Launch the prefill attention kernel of :func:`flash_attention_route`'s
    choice, or of ``route``.

    q: (B, Sq, H, D);  k, v: (B, Sk, K, D) with H a multiple of K, all
    contiguous on one CUDA device in float32 or bfloat16.  Queries are
    aligned to the end of the keys; ``window`` <= 0 means no window.
    Returns (B, Sq, H, D) in q's dtype, and with ``with_lse`` also each
    row's log-sum-exp (B, H, Sq) f32 (the backward's input).
    """
    route = _route.pick(flash_attention_route(q, k, v), route)
    _check_inputs(q, k, v)
    B, Sq, H, D = q.shape
    Sk, K = k.shape[1], k.shape[2]
    out = torch.empty_like(q)
    lse = (torch.empty((B, H, Sq), dtype=torch.float32, device=q.device)
           if with_lse else None)
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            lse.data_ptr() if with_lse else None,
            B, H, K, Sq, Sk, D, int(bool(causal)), int(window))
    lib = _lib()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        if route == "mma":
            rc = lib.flash_attention_mma_launch(*args, stream)
        else:
            rc = lib.flash_attention_launch(*args, _DTYPES[q.dtype], stream)
    _raise_on(rc, lib, f"flash_attention ({route})")
    flash_attention_cuda.launches += 1
    flash_attention_cuda.launches_by_route[route] += 1
    return (out, lse) if with_lse else out


flash_attention_cuda.launches = 0
flash_attention_cuda.launches_by_route = dict.fromkeys(ROUTES, 0)


def flash_attention_backward_cuda(q, k, v, o, do, lse, causal: bool = True,
                                  window: int = 0, route: str | None = None):
    """Launch the backward kernels of :func:`flash_attention_backward_route`'s
    choice, or of ``route`` ("fma" takes every input; "mma" only those the
    route function gives it): dQ with delta, then dK/dV, counted as one
    call.  q, o, do: (B, Sq, H, D);  k, v: (B, Sk, K, D);  lse: the
    forward's (B, H, Sq) f32.  All contiguous on one CUDA device, q's dtype
    except lse.  Returns (dq, dk, dv) in q's dtype."""
    route = _route.pick(flash_attention_backward_route(q, k, v), route)
    _check_inputs(q, k, v)
    B, Sq, H, D = q.shape
    Sk, K = k.shape[1], k.shape[2]
    for name, t in (("o", o), ("do", do)):
        if t.shape != q.shape or t.dtype != q.dtype or t.device != q.device \
                or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous tensor like q")
    if tuple(lse.shape) != (B, H, Sq) or lse.dtype != torch.float32 \
            or lse.device != q.device or not lse.is_contiguous():
        raise ValueError("lse must be the forward's contiguous (B, H, Sq) "
                         "float32 log-sum-exp")
    empty = Sq == 0 or Sk == 0
    alloc = torch.zeros_like if empty else torch.empty_like
    dq, dk, dv = alloc(q), alloc(k), alloc(v)
    delta = torch.empty((B, H, Sq), dtype=torch.float32, device=q.device)
    if route == "mma":     # 16-byte copies need aligned rows
        o, do = (t if _route.aligned16(t) else t.clone() for t in (o, do))
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            do.data_ptr(), lse.data_ptr(), delta.data_ptr(), dq.data_ptr(),
            dk.data_ptr(), dv.data_ptr(), B, H, K, Sq, Sk, D,
            int(bool(causal)), int(window))
    lib = _lib()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        if route == "mma":
            rc = lib.flash_attention_backward_mma_launch(*args, stream)
        else:
            rc = lib.flash_attention_backward_launch(*args, _DTYPES[q.dtype],
                                                     stream)
    _raise_on(rc, lib, f"flash_attention_backward ({route})")
    flash_attention_backward_cuda.launches += 1
    flash_attention_backward_cuda.launches_by_route[route] += 1
    return dq, dk, dv


flash_attention_backward_cuda.launches = 0
flash_attention_backward_cuda.launches_by_route = dict.fromkeys(ROUTES, 0)


class _FlashAttention(torch.autograd.Function):
    """Forward and backward through the kernels."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window):
        out, lse = flash_attention_cuda(q, k, v, causal=causal,
                                        window=window, with_lse=True)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal, ctx.window = causal, window
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        grads = flash_attention_backward_cuda(
            q, k, v, out, dout.contiguous(), lse, causal=ctx.causal,
            window=ctx.window)
        return (*(g if n else None
                  for g, n in zip(grads, ctx.needs_input_grad[:3])),
                None, None)


def flash_attention_autograd(q, k, v, causal: bool = True, window: int = 0):
    """The kernel with gradients for q, k and v (the backward kernels)."""
    return _FlashAttention.apply(q, k, v, causal, window)
