"""Batched masked Gram log-volume: the CUDA kernels ``csrc/gram_volume.cu``
(forward and a hand-written backward), their autograd wrapper and the
plain PyTorch versions.

The kernels replace the TPU kernel ``repro.kernels.gram_volume.
gram_log_volume`` and compute what ``repro.core.gram.log_volume`` (the
model path) computes: rows normalized by ``rsqrt(|v|^2 + 1e-12)``, masked
rows and columns replaced by identity, ``+ eps I``, Cholesky, sum of log
diagonal.

The forward runs a sample on a thread-block cluster of ``splits``
blocks (:func:`gram_log_volume_splits` picks it from shapes alone; one
block at the round's shape), each summing the raw dot products over its
share of d; rank 0 merges them, writes them (B, k, k) f32 beside y and
runs the Cholesky.  The backward reads those saved dots, builds the k x k
matrix C of dL/dv = C v, and streams C v over (sample, share) blocks.
:func:`gram_log_volume_cuda` and :func:`gram_log_volume_backward_cuda`
count their launches in ``.launches``.

The plain versions: :func:`gram_log_volume_plain` (the formula, and by
autograd its gradient); :func:`gram_dots_plain`,
:func:`gram_dots_split_plain` (the same dots summed over the kernel's
shares), :func:`gram_log_volume_from_dots_plain` and
:func:`gram_log_volume_backward_from_dots_plain` (the closed-form C
backward written out), which the CPU tests hold against the JAX package.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

__all__ = ["gram_log_volume_cuda", "gram_log_volume_backward_cuda",
           "gram_log_volume_plain", "gram_log_volume_autograd",
           "gram_log_volume_splits", "gram_log_volume_empty_cuda",
           "gram_dots_plain", "gram_dots_split_plain",
           "gram_log_volume_from_dots_plain",
           "gram_log_volume_backward_from_dots_plain", "MAX_K", "SPLITS"]

MAX_K = 8
SPLITS = (1, 2, 4, 8)           # cluster sizes (8 is the portable limit)
BLOCK_THREADS = 128             # threads of a block
# the split rules' least share of a rank: the forward's, of each row, the
# bytes its threads hold in flight at once (two 16-byte column steps each);
# the backward's, of the whole sample (k rows), the same number of bytes
SPLIT_ROW_BYTES = 2 * BLOCK_THREADS * 16
SPLIT_SAMPLE_BYTES = SPLIT_ROW_BYTES
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


# the C functions of csrc/gram_volume.cu: argument types, return type
C_FUNCTIONS = {
    "gram_log_volume_launch": (
        [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4
        + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p], ctypes.c_int),
    "gram_log_volume_bwd_launch": (
        [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4
        + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p], ctypes.c_int),
    "gram_log_volume_empty_launch": (
        [ctypes.c_int] * 3 + [ctypes.c_void_p], ctypes.c_int),
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


def gram_dots_plain(vs):
    """The raw dot products v_i . v_j (B, k, k) f32 of vs (B, k, d)."""
    v = vs.float()
    return torch.einsum("bkd,bld->bkl", v, v)


def _shares(d: int, splits: int, width: int):
    """The kernel's shares of d: rank r takes column steps [n r / S,
    n (r + 1) / S) of n = d / width steps, ``width`` values a step."""
    n = d // width
    return [(n * r // splits * width, n * (r + 1) // splits * width)
            for r in range(splits)]


def gram_dots_split_plain(vs, splits: int):
    """The forward kernel's split arithmetic: the raw dots over each of
    ``splits`` shares of d (16-byte steps where d holds a whole number of
    them, single values otherwise), summed in rank order."""
    d = vs.shape[-1]
    n = 16 // vs.element_size()
    width = n if d % n == 0 else 1
    parts = [gram_dots_plain(vs[..., lo:hi])
             for lo, hi in _shares(d, splits, width)]
    total = parts[0]
    for p in parts[1:]:
        total = total + p
    return total


def _masked_gram(dots, mask, eps: float):
    """(rsqrt(|v_i|^2 + 1e-12) (B, k), the masked shifted Gram (B, k, k))
    from the raw dots."""
    k = dots.shape[-1]
    rr = torch.rsqrt(torch.diagonal(dots, dim1=-2, dim2=-1) + 1e-12)
    eye = torch.eye(k, dtype=torch.float32, device=dots.device)
    pair = mask[..., :, None] & mask[..., None, :]
    g = torch.where(pair, dots * rr[..., :, None] * rr[..., None, :], eye)
    return rr, g + eps * eye


def gram_log_volume_from_dots_plain(dots, mask, eps: float = 1e-5):
    """The log-volumes (B,) f32 from the raw dots (B, k, k) f32: what rank
    0 of the forward's cluster computes after the merge."""
    _, g = _masked_gram(dots, mask, eps)
    chol = torch.linalg.cholesky_ex(g).L
    return torch.sum(torch.log(torch.diagonal(chol, dim1=-2, dim2=-1)), dim=-1)


def gram_log_volume_backward_from_dots_plain(vs, dots, mask, gout,
                                             eps: float = 1e-5):
    """dL/dvs (B, k, d) in vs's dtype from the raw dots and gout = dL/dy
    (B,), in closed form: dg = pair (.) (gout / 2) G~^-1, and
    dv_i = sum_j C_ij v_j with C_ij = 2 r_i r_j dg_ij - delta_ij 2 r_i^3
    sum_t dg_it r_t D_it (the backward kernels' C)."""
    rr, g = _masked_gram(dots, mask, eps)
    ginv = torch.cholesky_inverse(torch.linalg.cholesky_ex(g).L)
    pair = mask[..., :, None] & mask[..., None, :]
    dg = torch.where(pair, 0.5 * gout.float()[:, None, None] * ginv,
                     torch.zeros_like(ginv))
    vdot = torch.sum(dg * rr[:, None, :] * dots, dim=-1)
    beta = 2.0 * rr ** 3 * vdot
    C = 2.0 * rr[:, :, None] * rr[:, None, :] * dg - torch.diag_embed(beta)
    return torch.einsum("bij,bjd->bid", C, vs.float()).to(vs.dtype)


def gram_log_volume_splits(B: int, k: int, d: int, itemsize: int = 2,
                           backward: bool = False, n_sm: int = 132) -> int:
    """The blocks S that share each sample's d, from static shapes alone:
    the smallest power of two <= 8 at which B * S blocks cover the SMs,
    or at which halving a rank's share once more would leave it under its
    least share.  The forward (a cluster that merges its ranks' dots)
    keeps ``SPLIT_ROW_BYTES`` of each row: a split that does not shorten
    the threads' two-step load pipeline only adds the merge.  The backward
    (no merge) keeps ``SPLIT_SAMPLE_BYTES`` of the sample's k rows.  On an
    H100 this puts the round's 80 x 4 x 1280 bf16 at S = 1 forward and
    S = 2 backward, the fastest of the four (PERF.md, kernel D)."""
    least = k * d * itemsize if backward else d * itemsize
    floor = SPLIT_SAMPLE_BYTES if backward else SPLIT_ROW_BYTES
    s = 1
    while s < SPLITS[-1] and B * s < n_sm and least // (2 * s) >= floor:
        s *= 2
    return s


def _check(vs, mask, backward):
    """(splits, B, k, d) for these inputs; raises on inputs the kernels do
    not take, checking dtypes and shapes before devices (so meta tensors
    reach only the first checks)."""
    if vs.dim() != 3:
        raise ValueError(f"vs must be (B, k, d); got {tuple(vs.shape)}")
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
    splits = gram_log_volume_splits(B, k, d, vs.element_size(), backward)
    return splits, B, k, d


def _raise(lib, rc, what):
    if rc:
        raise RuntimeError(f"{what} launch failed: "
                           + lib.gram_log_volume_error_string(rc).decode())


def gram_log_volume_cuda(vs, mask, eps: float = 1e-5,
                         return_dots: bool = False):
    """Launch the forward kernel.  vs (B, k, d) f32/bf16, mask (B, k) bool,
    1 <= k <= 8, contiguous on one CUDA device -> log-volumes (B,) f32;
    with ``return_dots`` also the raw dots (B, k, k) f32, which the
    backward reads."""
    splits, B, k, d = _check(vs, mask, False)
    out = torch.empty((B,), dtype=torch.float32, device=vs.device)
    dots = torch.empty((B, k, k), dtype=torch.float32, device=vs.device)
    lib = _lib()
    with torch.cuda.device(vs.device):
        rc = lib.gram_log_volume_launch(
            vs.data_ptr(), mask.data_ptr(), out.data_ptr(), dots.data_ptr(),
            B, k, d, splits, float(eps), _DTYPES[vs.dtype],
            torch.cuda.current_stream(vs.device).cuda_stream)
    _raise(lib, rc, "gram_log_volume")
    gram_log_volume_cuda.launches += 1
    return (out, dots) if return_dots else out


def gram_log_volume_backward_cuda(vs, mask, gout, dots, eps: float = 1e-5):
    """Launch the backward kernel: dL/dvs (B, k, d) in vs's dtype from
    gout = dL/dy (B,) and the forward's raw dots (B, k, k) f32; a sample's
    d is shared by :func:`gram_log_volume_splits`'s backward rule of
    blocks."""
    splits, B, k, d = _check(vs, mask, True)
    gout = gout.float().contiguous()
    if tuple(gout.shape) != (B,) or gout.device != vs.device:
        raise ValueError(f"gout must be ({B},) on {vs.device}")
    if tuple(dots.shape) != (B, k, k) or dots.dtype != torch.float32 \
            or dots.device != vs.device or not dots.is_contiguous():
        raise ValueError(f"dots must be contiguous f32 ({B}, {k}, {k}) "
                         f"on {vs.device}")
    dvs = torch.empty_like(vs)
    lib = _lib()
    with torch.cuda.device(vs.device):
        rc = lib.gram_log_volume_bwd_launch(
            vs.data_ptr(), mask.data_ptr(), dots.data_ptr(), gout.data_ptr(),
            dvs.data_ptr(), B, k, d, splits, float(eps), _DTYPES[vs.dtype],
            torch.cuda.current_stream(vs.device).cuda_stream)
    _raise(lib, rc, "gram_log_volume backward")
    gram_log_volume_backward_cuda.launches += 1
    return dvs


gram_log_volume_cuda.launches = 0
gram_log_volume_backward_cuda.launches = 0


def gram_log_volume_empty_cuda(blocks: int, cluster: int = 0):
    """Launch an empty kernel on the current device as the kernels launch
    (``blocks`` of ``BLOCK_THREADS``, as clusters of ``cluster`` when it is
    > 0, programmatic dependent launch): the launch's own cost.  Not a
    launch of the kernels: no counter moves."""
    lib = _lib()
    rc = lib.gram_log_volume_empty_launch(
        blocks, BLOCK_THREADS, cluster,
        torch.cuda.current_stream().cuda_stream)
    _raise(lib, rc, "empty")


class _GramLogVolume(torch.autograd.Function):
    @staticmethod
    def forward(ctx, vs, mask, eps):
        y, dots = gram_log_volume_cuda(vs, mask, eps, return_dots=True)
        ctx.save_for_backward(vs, mask, dots)
        ctx.eps = eps
        return y

    @staticmethod
    def backward(ctx, gout):
        vs, mask, dots = ctx.saved_tensors
        dvs = None
        if ctx.needs_input_grad[0]:
            dvs = gram_log_volume_backward_cuda(vs, mask, gout, dots,
                                                ctx.eps)
        return dvs, None, None


def gram_log_volume_autograd(vs, mask, eps: float = 1e-5):
    """The kernels with the gradient for vs (the backward reads the
    forward's saved dots)."""
    return _GramLogVolume.apply(vs, mask, eps)
