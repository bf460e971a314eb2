"""Batched masked Gram log-volume: the CUDA kernels ``csrc/gram_volume.cu``
(forward and a hand-written backward), their autograd wrapper and the
plain PyTorch version.

The kernel replaces the TPU kernel ``repro.kernels.gram_volume.
gram_log_volume`` and computes what ``repro.core.gram.log_volume`` (the
model path) computes: rows normalized by ``rsqrt(|v|^2 + 1e-12)``, masked
rows and columns replaced by identity, ``+ eps I``, Cholesky, sum of log
diagonal.  :func:`gram_log_volume_cuda` and
:func:`gram_log_volume_backward_cuda` count their launches in their
``launches`` attributes.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

__all__ = ["gram_log_volume_cuda", "gram_log_volume_backward_cuda",
           "gram_log_volume_plain", "gram_log_volume_autograd", "MAX_K"]

MAX_K = 8
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


# the C functions of csrc/gram_volume.cu: argument types, return type
C_FUNCTIONS = {
    "gram_log_volume_launch": (
        [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3
        + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p], ctypes.c_int),
    "gram_log_volume_bwd_launch": (
        [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3
        + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p], ctypes.c_int),
    "gram_log_volume_error_string": ([ctypes.c_int], ctypes.c_char_p),
}


def _lib():
    return _build.library("gram_volume", C_FUNCTIONS)


def gram_log_volume_plain(vs, mask, eps: float = 1e-5):
    """Plain PyTorch version (``repro.core.gram.log_volume``), differentiable
    by autograd.  vs (..., k, d); mask (..., k) bool -> (...,) f32."""
    v = vs.float()
    v = v * torch.rsqrt(torch.sum(v * v, dim=-1, keepdim=True) + 1e-12)
    g = torch.einsum("...kd,...ld->...kl", v, v)
    k = vs.shape[-2]
    eye = torch.eye(k, dtype=torch.float32, device=vs.device)
    pair = mask[..., :, None] & mask[..., None, :]
    g = torch.where(pair, g, eye) + eps * eye
    chol = torch.linalg.cholesky_ex(g).L     # no host sync: graph-safe
    return torch.sum(torch.log(torch.diagonal(chol, dim1=-2, dim2=-1)), dim=-1)


def _check(vs, mask):
    B, k, d = vs.shape
    if not 1 <= k <= MAX_K:
        raise ValueError(f"k={k} outside [1, {MAX_K}]")
    if tuple(mask.shape) != (B, k) or mask.dtype != torch.bool:
        raise ValueError(f"mask must be bool ({B}, {k}); got "
                         f"{mask.dtype} {tuple(mask.shape)}")
    if vs.dtype not in _DTYPES:
        raise TypeError(f"vs must be one of {list(_DTYPES)}")
    if vs.device.type != "cuda" or mask.device != vs.device:
        raise ValueError("vs and mask must lie on one CUDA device")
    if not (vs.is_contiguous() and mask.is_contiguous()):
        raise ValueError("vs and mask must be contiguous")
    return B, k, d


def _raise(lib, rc, what):
    if rc:
        raise RuntimeError(f"{what} launch failed: "
                           + lib.gram_log_volume_error_string(rc).decode())


def gram_log_volume_cuda(vs, mask, eps: float = 1e-5):
    """Launch the forward kernel.  vs (B, k, d) f32/bf16, mask (B, k) bool,
    1 <= k <= 8, contiguous on one CUDA device -> log-volumes (B,) f32."""
    B, k, d = _check(vs, mask)
    out = torch.empty((B,), dtype=torch.float32, device=vs.device)
    lib = _lib()
    with torch.cuda.device(vs.device):
        stream = torch.cuda.current_stream(vs.device).cuda_stream
        rc = lib.gram_log_volume_launch(vs.data_ptr(), mask.data_ptr(),
                                        out.data_ptr(), B, k, d, float(eps),
                                        _DTYPES[vs.dtype], stream)
    _raise(lib, rc, "gram_log_volume")
    gram_log_volume_cuda.launches += 1
    return out


def gram_log_volume_backward_cuda(vs, mask, gout, eps: float = 1e-5):
    """Launch the backward kernel: dL/dvs (B, k, d) in vs's dtype from
    gout = dL/dy (B,)."""
    B, k, d = _check(vs, mask)
    gout = gout.float().contiguous()
    if tuple(gout.shape) != (B,) or gout.device != vs.device:
        raise ValueError(f"gout must be ({B},) on {vs.device}")
    dvs = torch.empty_like(vs)
    lib = _lib()
    with torch.cuda.device(vs.device):
        stream = torch.cuda.current_stream(vs.device).cuda_stream
        rc = lib.gram_log_volume_bwd_launch(
            vs.data_ptr(), mask.data_ptr(), gout.data_ptr(), dvs.data_ptr(),
            B, k, d, float(eps), _DTYPES[vs.dtype], stream)
    _raise(lib, rc, "gram_log_volume backward")
    gram_log_volume_backward_cuda.launches += 1
    return dvs


gram_log_volume_cuda.launches = 0
gram_log_volume_backward_cuda.launches = 0


class _GramLogVolume(torch.autograd.Function):
    @staticmethod
    def forward(ctx, vs, mask, eps):
        ctx.save_for_backward(vs, mask)
        ctx.eps = eps
        return gram_log_volume_cuda(vs, mask, eps)

    @staticmethod
    def backward(ctx, gout):
        vs, mask = ctx.saved_tensors
        dvs = None
        if ctx.needs_input_grad[0]:
            dvs = gram_log_volume_backward_cuda(vs, mask, gout, ctx.eps)
        return dvs, None, None


def gram_log_volume_autograd(vs, mask, eps: float = 1e-5):
    """The kernels with the gradient for vs."""
    return _GramLogVolume.apply(vs, mask, eps)
