"""Mamba2 SSD intra-chunk scan: the CUDA kernels ``csrc/ssd_chunk.cu``
(forward G and backward G′) and their plain PyTorch versions.

G replaces the TPU kernel ``repro.kernels.ssd_scan.ssd_chunk``.  Unlike
the TPU wrapper it takes the model layout: x (B, S, H, P), B and C
(B, S, G, N) with head h reading group h // (H / G), dt and cum (B, S, H)
f32, S a multiple of the chunk length.  It returns the intra-chunk output
y (B, S, H, P) f32 and every chunk's end state (B, S / chunk, H, P, N) f32
from one launch.  G has two routes: bf16 at the shapes of
:func:`ssd_chunk_route` takes the ``"mma"`` kernel (tensor cores, C.B^T
once per slice of heads, the f32 operands as hi + lo bf16 pairs), every
other input the ``"fma"`` kernel (f32 FMAs); ``route="fma"`` forces the
latter.  :func:`ssd_chunk_cuda` counts its launches in
``ssd_chunk_cuda.launches`` and per route in ``.launches_by_route``;
:func:`ssd_chunk_plain` is the same function in plain PyTorch (the CPU
path and the kernel's oracle).

G′ (:func:`ssd_chunk_bwd_cuda`) is the gradient of y and the end states
with respect to x, dt, cum, B and C (the TPU takes it with ``jax.grad`` of
the reference's ``ssd_reference``); its oracle and CPU path is
:func:`ssd_chunk_bwd_plain`, the explicit formulas.  G′ has two routes,
picked by :func:`ssd_chunk_bwd_route`: bf16 at G's mma shapes takes the
``"mma"`` kernels (tensor cores; each tile pair's scores formed once, dCB
summed over a slice of heads before its products with B and C, the f32
operands as hi + lo bf16 pairs), every other input the ``"fma"`` kernel
(f32 FMAs); ``route="fma"`` forces the latter.  Both are deterministic
and count their launches in ``ssd_chunk_bwd_cuda.launches_by_route``.
:func:`ssd_chunk_autograd` is G with G′ as its backward (the training
path on the card).  The raw launcher :func:`ssd_chunk_cuda` has no
autograd: it raises where a gradient would be needed.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build, _route

__all__ = ["ssd_chunk_cuda", "ssd_chunk_plain", "ssd_chunk_route",
           "ssd_chunk_bwd_cuda", "ssd_chunk_bwd_plain", "ssd_chunk_bwd_route",
           "ssd_chunk_autograd", "MAX_HEAD_DIM", "ROUTES", "BWD_ROUTES"]

MAX_HEAD_DIM = 128
MMA_MAX_STATE = 128      # the mma route's largest N
MMA_ROWS = 64            # the mma route's tile: L is a multiple of it
BWD_MAX_STATE = 128      # G′'s largest N
ROUTES = ("mma", "fma")
BWD_ROUTES = ("mma", "fma")
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

# the C functions of csrc/ssd_chunk.cu: argument types, return type
C_FUNCTIONS = {
    "ssd_chunk_launch": (
        [ctypes.c_void_p] * 7 + [ctypes.c_int] * 8 + [ctypes.c_void_p],
        ctypes.c_int),
    "ssd_chunk_mma_launch": (
        [ctypes.c_void_p] * 7 + [ctypes.c_int] * 7 + [ctypes.c_void_p],
        ctypes.c_int),
    "ssd_chunk_bwd_workspace_floats": ([ctypes.c_int] * 5, ctypes.c_longlong),
    "ssd_chunk_bwd_launch": (
        [ctypes.c_void_p] * 13 + [ctypes.c_int] * 8 + [ctypes.c_void_p],
        ctypes.c_int),
    "ssd_chunk_bwd_mma_workspace_floats": ([ctypes.c_int] * 7,
                                           ctypes.c_longlong),
    "ssd_chunk_bwd_mma_launch": (
        [ctypes.c_void_p] * 13 + [ctypes.c_int] * 7 + [ctypes.c_void_p],
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
    gradient while grad mode is on (:func:`ssd_chunk_autograd` is the
    training path)."""
    route = _route.pick(ssd_chunk_route(x, dt, cum, B_, C_, chunk), route)
    Bsz, S, H, P, G, N, nc = _shapes(x, dt, cum, B_, C_, chunk)
    tensors = (x, dt, cum, B_, C_)
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise NotImplementedError(
            "ssd_chunk_cuda records no backward: train through "
            "ssd_chunk_autograd, whose backward is G' (ssd_chunk_bwd_cuda)")
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


# ---------------------------------------------------------------------------
# G′: the backward


def _bwd_check(x, dt, cum, B_, C_, dy, dstates, chunk: int):
    """(Bsz, S, H, P, G, N, n_chunks) after checking G′'s inputs: G's,
    plus dy shaped as x and dstates (B, S/chunk, H, P, N) or None, f32."""
    shapes = _shapes(x, dt, cum, B_, C_, chunk)
    Bsz, S, H, P, G, N, nc = shapes
    if tuple(dy.shape) != tuple(x.shape):
        raise ValueError(f"dy{tuple(dy.shape)} is not shaped as "
                         f"x{tuple(x.shape)}")
    if dstates is not None and tuple(dstates.shape) != (Bsz, nc, H, P, N):
        raise ValueError(f"bad dstates shape {tuple(dstates.shape)}")
    if dy.dtype != torch.float32 or (dstates is not None
                                     and dstates.dtype != torch.float32):
        raise TypeError("dy and dstates must be float32")
    return shapes


def ssd_chunk_bwd_plain(x, dt, cum, B_, C_, dy, dstates, chunk: int):
    """G′ in plain PyTorch, the explicit formulas (the kernel's oracle and
    the CPU path).  dy (B, S, H, P) is the gradient of y, dstates (B,
    S/chunk, H, P, N) that of the end states (None: zero).  Per chunk and
    head, with M_ij = (C_i·B_j) e^{cum_i − cum_j} (j ≤ i, else 0), dAtt =
    dy xᵀ and w_j = e^{cum_L − cum_j}:

      dx_j   = dt_j Σ_i M_ij dy_i + dt_j w_j dS B_j
      ddt_j  = Σ_i dAtt_ij M_ij + w_j x_jᵀ dS B_j
      dCB_ij = dAtt_ij dt_j e^{cum_i − cum_j},  dC_i = Σ_j dCB_ij B_j,
      dB_j   = Σ_i dCB_ij C_i + dt_j w_j dSᵀ x_j
      dcum_i = Σ_j T_ij − Σ_k T_ki − s_i  (T_ij = dCB_ij C_i·B_j,
               s_j = dt_j w_j x_jᵀ dS B_j), and the last row + Σ_j s_j;

    dB and dC summed over each group's heads.  The exp is taken of a
    masked argument, as in :func:`ssd_chunk_plain`.  Returns (dx, ddt,
    dcum, dB, dC), all f32."""
    Bsz, S, H, P, G, N, nc = _bwd_check(x, dt, cum, B_, C_, dy, dstates,
                                        chunk)
    L, rep = chunk, H // G
    xc = x.float().reshape(Bsz, nc, L, H, P)
    dyc = dy.float().reshape(Bsz, nc, L, H, P)
    dth = dt.float().reshape(Bsz, nc, L, H).permute(0, 1, 3, 2)   # (B,nc,H,L)
    cumh = cum.float().reshape(Bsz, nc, L, H).permute(0, 1, 3, 2)
    Bh = B_.float().reshape(Bsz, nc, L, G, N).repeat_interleave(rep, dim=3)
    Ch = C_.float().reshape(Bsz, nc, L, G, N).repeat_interleave(rep, dim=3)
    causal = torch.ones((L, L), dtype=torch.bool, device=x.device).tril()
    diff = (cumh[..., :, None] - cumh[..., None, :]).masked_fill(~causal, 0.0)
    decay = torch.exp(diff).masked_fill(~causal, 0.0)           # (B,nc,H,i,j)
    cb = torch.einsum("bcihn,bcjhn->bchij", Ch, Bh)
    m = cb * decay
    datt = torch.einsum("bcihp,bcjhp->bchij", dyc, xc)
    dcb = datt * dth[..., None, :] * decay
    t = dcb * cb
    dx = torch.einsum("bchij,bcihp->bcjhp", m, dyc)             # (B,nc,L,H,P)
    ddt = (datt * m).sum(dim=-2)                                 # (B,nc,H,L)
    dcum = t.sum(dim=-1) - t.sum(dim=-2)
    dC = torch.einsum("bchij,bcjhn->bcihn", dcb, Bh)
    dB = torch.einsum("bchij,bcihn->bcjhn", dcb, Ch)
    if dstates is not None:
        ds = dstates.float()                                      # (B,nc,H,P,N)
        w = torch.exp(cumh[..., -1:] - cumh)                      # (B,nc,H,L)
        u = torch.einsum("bchpn,bclhn->bclhp", ds, Bh)            # dS B_j
        v = torch.einsum("bchpn,bclhp->bclhn", ds, xc)            # dSᵀ x_j
        xu = (xc * u).sum(dim=-1).permute(0, 1, 3, 2)             # (B,nc,H,L)
        wl = w.permute(0, 1, 3, 2)[..., None]                     # (B,nc,L,H,1)
        dx = dx + wl * u
        ddt = ddt + w * xu
        s = dth * w * xu
        dcum = dcum - s
        dcum[..., -1] += s.sum(dim=-1)
        dB = dB + (dth.permute(0, 1, 3, 2)[..., None] * wl) * v
    dx = dx * dth.permute(0, 1, 3, 2)[..., None]

    def heads(a):          # (B,nc,H,L) -> (B,S,H)
        return a.permute(0, 1, 3, 2).reshape(Bsz, S, H)

    def groups(a):         # (B,nc,L,H,N) -> (B,S,G,N), heads summed
        return a.reshape(Bsz, nc, L, G, rep, N).sum(dim=4).reshape(
            Bsz, S, G, N)
    return (dx.reshape(Bsz, S, H, P), heads(ddt), heads(dcum), groups(dB),
            groups(dC))


def ssd_chunk_bwd_route(x, dt, cum, B_, C_, dy, dstates, chunk: int) -> str:
    """The kernel that :func:`ssd_chunk_bwd_cuda` launches for these
    inputs: ``"mma"`` where :func:`ssd_chunk_route` gives G the mma route
    (bf16 x, B, C with P and N multiples of 16, P <= 128, N <= 128, the
    chunk a multiple of 64; mamba2's and hymba's training shapes) and dy
    and dstates also lie at 16-byte aligned offsets, else ``"fma"``.  Reads
    only dtypes, shapes and offsets (CPU or meta tensors do); raises on
    inputs no route takes."""
    _, _, _, _, _, N, _ = _bwd_check(x, dt, cum, B_, C_, dy, dstates, chunk)
    forward = ssd_chunk_route(x, dt, cum, B_, C_, chunk)   # dtypes and P
    if not 1 <= N <= BWD_MAX_STATE:
        raise ValueError(f"state N={N} not in [1, {BWD_MAX_STATE}]")
    if forward == "mma" and all(_route.aligned16(t) for t in (dy, dstates)
                                if t is not None):
        return "mma"
    return "fma"


def ssd_chunk_bwd_cuda(x, dt, cum, B_, C_, dy, dstates, chunk: int,
                       route: str | None = None):
    """Launch G′ on :func:`ssd_chunk_bwd_route`'s choice, or on ``route``
    ("fma" takes every input; "mma" only what the route function gives
    it).  Inputs as :func:`ssd_chunk_bwd_plain`, all contiguous on one CUDA
    device, x, B_, C_ in one of float32 / bfloat16, P <= 128, N <= 128.
    One C call (the mma route's kernels or the FMA route's three) counts
    once in ``ssd_chunk_bwd_cuda.launches`` and ``.launches_by_route``.
    Returns (dx, ddt, dcum, dB, dC), all f32.  Deterministic: no float
    atomics, every sum in a fixed order."""
    route = _route.pick(ssd_chunk_bwd_route(x, dt, cum, B_, C_, dy, dstates,
                                            chunk), route)
    Bsz, S, H, P, G, N, nc = _shapes(x, dt, cum, B_, C_, chunk)
    tensors = [t for t in (x, dt, cum, B_, C_, dy, dstates) if t is not None]
    if any(t.device != x.device for t in tensors) or x.device.type != "cuda":
        raise ValueError("all inputs must lie on one CUDA device")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("all inputs must be contiguous")
    if Bsz * S == 0:
        raise ValueError("empty input")
    lib = _lib()
    f32 = dict(dtype=torch.float32, device=x.device)
    dx = torch.empty((Bsz, S, H, P), **f32)
    ddt = torch.empty((Bsz, S, H), **f32)
    dcum = torch.empty((Bsz, S, H), **f32)
    dB = torch.empty((Bsz, S, G, N), **f32)
    dC = torch.empty((Bsz, S, G, N), **f32)
    if route == "mma":
        n_ws = lib.ssd_chunk_bwd_mma_workspace_floats(
            Bsz, S, H, G, N, chunk, int(dstates is not None))
    else:
        n_ws = lib.ssd_chunk_bwd_workspace_floats(Bsz, S, H, G, N)
    ws = torch.empty((n_ws,), **f32)
    args = (x.data_ptr(), dt.data_ptr(), cum.data_ptr(), B_.data_ptr(),
            C_.data_ptr(), dy.data_ptr(),
            None if dstates is None else dstates.data_ptr(),
            dx.data_ptr(), ddt.data_ptr(), dcum.data_ptr(), dB.data_ptr(),
            dC.data_ptr(), ws.data_ptr(), Bsz, S, H, G, N, P, chunk)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        if route == "mma":
            rc = lib.ssd_chunk_bwd_mma_launch(*args, stream)
        else:
            rc = lib.ssd_chunk_bwd_launch(*args, _DTYPES[x.dtype], stream)
    if rc:
        raise RuntimeError(f"ssd_chunk_bwd ({route}) launch failed: "
                           + lib.ssd_chunk_error_string(rc).decode())
    ssd_chunk_bwd_cuda.launches += 1
    ssd_chunk_bwd_cuda.launches_by_route[route] += 1
    return dx, ddt, dcum, dB, dC


ssd_chunk_bwd_cuda.launches = 0
ssd_chunk_bwd_cuda.launches_by_route = dict.fromkeys(BWD_ROUTES, 0)


class _SSDChunk(torch.autograd.Function):
    """G forward, G′ backward (on :func:`ssd_chunk_bwd_route`'s choice):
    gradients for x, dt, cum, B and C."""

    @staticmethod
    def forward(ctx, x, dt, cum, B_, C_, chunk):
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(x, dt, cum, B_, C_)
        ctx.chunk = chunk
        return ssd_chunk_cuda(x, dt, cum, B_, C_, chunk)

    @staticmethod
    def backward(ctx, dy, dstates):
        x, dt, cum, B_, C_ = ctx.saved_tensors
        dy = torch.zeros(x.shape, dtype=torch.float32, device=x.device) \
            if dy is None else dy.float().contiguous()
        if dstates is not None:
            dstates = dstates.float().contiguous()
        dx, ddt, dcum, dB, dC = ssd_chunk_bwd_cuda(x, dt, cum, B_, C_, dy,
                                                   dstates, ctx.chunk)
        return dx.to(x.dtype), ddt, dcum, dB.to(B_.dtype), dC.to(C_.dtype), \
            None


def ssd_chunk_autograd(x, dt, cum, B_, C_, chunk: int):
    """G with gradients (G′ in the backward): (y, states) as
    :func:`ssd_chunk_cuda`."""
    return _SSDChunk.apply(x, dt, cum, B_, C_, chunk)
