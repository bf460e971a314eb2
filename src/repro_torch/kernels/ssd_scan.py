"""Mamba2 SSD intra-chunk scan: the CUDA kernel ``csrc/ssd_chunk.cu`` and
its plain PyTorch version.

The kernel replaces the TPU kernel ``repro.kernels.ssd_scan.ssd_chunk``.
Unlike the TPU wrapper it takes the model layout: x (B, S, H, P), B and C
(B, S, G, N) with head h reading group h // (H / G), dt and cum (B, S, H)
f32, S a multiple of the chunk length.  It returns the intra-chunk output
y (B, S, H, P) f32 and every chunk's end state (B, S / chunk, H, P, N) f32
from one launch.  The kernel has two routes: bf16 at the shapes of
:func:`ssd_chunk_route` takes the ``"mma"`` kernel (tensor cores, C.B^T
once per slice of heads, the f32 operands as hi + lo bf16 pairs), every
other input the ``"fma"`` kernel (f32 FMAs); ``route="fma"`` forces the
latter.  :func:`ssd_chunk_cuda` counts its launches in
``ssd_chunk_cuda.launches`` and per route in ``.launches_by_route``;
:func:`ssd_chunk_plain` is the same function in plain PyTorch (the CPU
path and the kernel's oracle).  The kernel has no backward: a call that
would need one raises.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build, _route

__all__ = ["ssd_chunk_cuda", "ssd_chunk_plain", "ssd_chunk_route",
           "MAX_HEAD_DIM", "ROUTES"]

MAX_HEAD_DIM = 128
MMA_MAX_STATE = 128      # the mma route's largest N
MMA_ROWS = 64            # the mma route's tile: L is a multiple of it
ROUTES = ("mma", "fma")
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

# the C functions of csrc/ssd_chunk.cu: argument types, return type
C_FUNCTIONS = {
    "ssd_chunk_launch": (
        [ctypes.c_void_p] * 7 + [ctypes.c_int] * 8 + [ctypes.c_void_p],
        ctypes.c_int),
    "ssd_chunk_mma_launch": (
        [ctypes.c_void_p] * 7 + [ctypes.c_int] * 7 + [ctypes.c_void_p],
        ctypes.c_int),
    "ssd_chunk_error_string": ([ctypes.c_int], ctypes.c_char_p),
}


def _lib():
    return _build.library("ssd_chunk", C_FUNCTIONS)


def _shapes(x, dt, cum, B_, C_, chunk: int):
    """(Bsz, S, H, P, G, N, n_chunks) after checking the shapes agree."""
    Bsz, S, H, P = x.shape
    G, N = B_.shape[2], B_.shape[3]
    if tuple(dt.shape) != (Bsz, S, H) or tuple(cum.shape) != (Bsz, S, H) \
            or tuple(B_.shape) != (Bsz, S, G, N) \
            or tuple(C_.shape) != (Bsz, S, G, N):
        raise ValueError(f"bad shapes x{tuple(x.shape)} dt{tuple(dt.shape)} "
                         f"cum{tuple(cum.shape)} B{tuple(B_.shape)} "
                         f"C{tuple(C_.shape)}")
    if chunk < 1 or S % chunk:
        raise ValueError(f"S={S} is not a multiple of chunk={chunk}")
    if G < 1 or H % G:
        raise ValueError(f"H={H} is not a multiple of G={G}")
    return Bsz, S, H, P, G, N, S // chunk


def ssd_chunk_plain(x, dt, cum, B_, C_, chunk: int):
    """Plain PyTorch version, the same function as the kernel (and as
    ``repro.kernels.ref.ssd_chunk_ref`` for every chunk and head), in f32.

    The decay exp(cum_i - cum_j) is taken of a masked argument: above the
    diagonal the argument is large and positive, its exp inf, and inf * 0
    NaN.  Returns (y (B, S, H, P) f32, states (B, S/chunk, H, P, N) f32)."""
    Bsz, S, H, P, G, N, nc = _shapes(x, dt, cum, B_, C_, chunk)
    L, rep = chunk, H // G
    xc = x.float().reshape(Bsz, nc, L, H, P)
    dth = dt.float().reshape(Bsz, nc, L, H).permute(0, 1, 3, 2)   # (B,nc,H,L)
    cumh = cum.float().reshape(Bsz, nc, L, H).permute(0, 1, 3, 2)
    Bc = B_.float().reshape(Bsz, nc, L, G, N)
    Cc = C_.float().reshape(Bsz, nc, L, G, N)
    cb = torch.einsum("bcign,bcjgn->bcgij", Cc, Bc)
    cb = cb.repeat_interleave(rep, dim=2)                            # (B,nc,H,L,L)
    causal = torch.ones((L, L), dtype=torch.bool, device=x.device).tril()
    diff = (cumh[..., :, None] - cumh[..., None, :]).masked_fill(~causal, 0.0)
    decay = torch.exp(diff).masked_fill(~causal, 0.0)
    att = cb * decay * dth[..., None, :]
    y = torch.einsum("bchij,bcjhp->bcihp", att, xc)
    w = torch.exp(cumh[..., -1:] - cumh) * dth                       # (B,nc,H,L)
    Bh = Bc.repeat_interleave(rep, dim=3)                            # (B,nc,L,H,N)
    states = torch.einsum("bchl,bclhp,bclhn->bchpn", w, xc, Bh)
    return y.reshape(Bsz, S, H, P), states


def ssd_chunk_route(x, dt, cum, B_, C_, chunk: int) -> str:
    """The kernel that :func:`ssd_chunk_cuda` launches for these inputs:
    ``"mma"`` for bf16 x, B, C at 16-byte aligned offsets with P and N
    multiples of 16, P <= 128, N <= 128 and the chunk a multiple of 64
    (mamba2: P 64, N 128, chunk 256; hymba: P 64, N 16), else ``"fma"``.
    Reads only dtypes, shapes and offsets (CPU or meta tensors do); raises
    on inputs no route takes."""
    _, _, _, P, _, N, _ = _shapes(x, dt, cum, B_, C_, chunk)
    if x.dtype not in _DTYPES or B_.dtype != x.dtype or C_.dtype != x.dtype:
        raise TypeError(f"x, B, C must share one of {list(_DTYPES)}")
    if dt.dtype != torch.float32 or cum.dtype != torch.float32:
        raise TypeError("dt and cum must be float32")
    if not 1 <= P <= MAX_HEAD_DIM:
        raise ValueError(f"head dim P={P} not in [1, {MAX_HEAD_DIM}]")
    if (x.dtype == torch.bfloat16 and P % 16 == 0 and N % 16 == 0
            and 16 <= N <= MMA_MAX_STATE and chunk % MMA_ROWS == 0
            and all(_route.aligned16(t) for t in (x, B_, C_))):
        return "mma"
    return "fma"


def ssd_chunk_cuda(x, dt, cum, B_, C_, chunk: int, route: str | None = None):
    """Launch the SSD chunk kernel of :func:`ssd_chunk_route`'s choice, or
    of ``route`` ("fma" takes every input; "mma" only what the route
    function gives it).  Inputs as :func:`ssd_chunk_plain`: x, B_, C_ in
    one of float32 / bfloat16, dt and cum float32, all contiguous on one
    CUDA device; P <= 128.  No autograd: raises if an input requires a
    gradient while grad mode is on."""
    route = _route.pick(ssd_chunk_route(x, dt, cum, B_, C_, chunk), route)
    Bsz, S, H, P, G, N, nc = _shapes(x, dt, cum, B_, C_, chunk)
    tensors = (x, dt, cum, B_, C_)
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise NotImplementedError("the SSD chunk kernel has no backward yet")
    if any(t.device != x.device for t in tensors) or x.device.type != "cuda":
        raise ValueError("all inputs must lie on one CUDA device")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("all inputs must be contiguous")
    if Bsz * S == 0:
        raise ValueError("empty input")
    y = torch.empty((Bsz, S, H, P), dtype=torch.float32, device=x.device)
    states = torch.empty((Bsz, nc, H, P, N), dtype=torch.float32,
                         device=x.device)
    args = (x.data_ptr(), dt.data_ptr(), cum.data_ptr(), B_.data_ptr(),
            C_.data_ptr(), y.data_ptr(), states.data_ptr(),
            Bsz, S, H, G, N, P, chunk)
    lib = _lib()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        if route == "mma":
            rc = lib.ssd_chunk_mma_launch(*args, stream)
        else:
            rc = lib.ssd_chunk_launch(*args, _DTYPES[x.dtype], stream)
    if rc:
        raise RuntimeError(f"ssd_chunk ({route}) launch failed: "
                           + lib.ssd_chunk_error_string(rc).decode())
    ssd_chunk_cuda.launches += 1
    ssd_chunk_cuda.launches_by_route[route] += 1
    return y, states


ssd_chunk_cuda.launches = 0
ssd_chunk_cuda.launches_by_route = dict.fromkeys(ROUTES, 0)
