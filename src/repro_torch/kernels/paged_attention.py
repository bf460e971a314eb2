"""Decode-mode (Sq = 1) attention over a paged KV cache: the CUDA kernel
``csrc/paged_attention.cu`` and its plain PyTorch version.

The kernel replaces the TPU kernel ``repro.kernels.paged_attention.
paged_flash_attention``.  :func:`paged_attention_cuda` launches it on
PyTorch's current stream and counts its launches in
``paged_attention_cuda.launches`` and per walk in ``.launches_by_route``
(:func:`paged_attention_route` picks the walk: "mma", mma.sync, for bf16
at D 64 or 128; else "fma", CUDA-core FMAs); :func:`paged_attention_plain`
is the same function in plain PyTorch (the CPU path and the kernel's
oracle).

The kernel splits each slot's key walk across a thread-block cluster of
``splits`` blocks (:func:`paged_attention_splits` picks it from shapes
alone); each block leaves a partial softmax state and the cluster merges
them.  :func:`paged_attention_partials_plain` and
:func:`paged_attention_merge_plain` are that split arithmetic in plain
PyTorch, so the CPU tests hold it against the reference.
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import _build, _route
from repro_torch.kernels.ref import paged_attention_ref as paged_attention_plain
from repro_torch.kernels.ref import paged_rows

__all__ = ["paged_attention_cuda", "paged_attention_plain",
           "paged_attention_route", "paged_attention_splits",
           "paged_attention_key_tile",
           "paged_attention_partials_plain", "paged_attention_merge_plain",
           "ring_table", "SUPPORTED_HEAD_DIMS", "SPLITS"]

SUPPORTED_HEAD_DIMS = (32, 64, 128, 256)
SPLITS = (1, 2, 4, 8)           # cluster sizes (8 is the portable limit)
ROUTES = ("mma", "fma")
MMA_HEAD_DIMS = (64, 128)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
NEG_INF = -1e30
# the split rule: at least this many blocks per SM (tuned on an H100: at
# 2 the SLM's decode takes S = 1 and hymba's S = 4, the fastest of
# {1, 2, 4, 8} at both), and no rank under one tile of SPLIT_TILE keys
BLOCKS_PER_SM = 2
SPLIT_TILE = 32


# the C functions of csrc/paged_attention.cu: argument types, return type
C_FUNCTIONS = {
    "paged_attention_launch": (
        [ctypes.c_void_p] * 6 + [ctypes.c_int] * 10 + [ctypes.c_void_p],
        ctypes.c_int),
    "paged_attention_error_string": ([ctypes.c_int], ctypes.c_char_p),
}


def _lib():
    return _build.library("paged_attention", C_FUNCTIONS)


def _check_aligned(name, t):
    if t.data_ptr() % 16:
        raise ValueError(f"{name} must be 16-byte aligned")


def paged_attention_splits(B: int, K: int, G: int, M: int, ps: int,
                           n_sm: int = 132) -> int:
    """The cluster size S the kernel splits each key walk into, from
    static shapes alone (never a tensor, so no host sync): the smallest
    power of two <= 8 that gives at least ``BLOCKS_PER_SM`` blocks per SM,
    but no more ranks than the longest possible sequence (M * ps) has key
    tiles of ``SPLIT_TILE``."""
    blocks = max(1, B * K * -(-G // 8))      # a block serves <= 8 heads
    tiles = (M * ps) // SPLIT_TILE
    s = 1
    while s < SPLITS[-1] and blocks * s < BLOCKS_PER_SM * n_sm \
            and 2 * s <= tiles:
        s *= 2
    return s


def paged_attention_route(q, k_pages, v_pages) -> str:
    """The walk that :func:`paged_attention_cuda` launches for these
    inputs: ``"mma"`` (mma.sync) for bf16 at D 64 or 128 (the SLM's and
    hymba's heads), else ``"fma"``.  Reads only dtypes and shapes (CPU or
    meta tensors do); raises on inputs neither walk takes."""
    D = q.shape[-1]
    if D not in SUPPORTED_HEAD_DIMS:
        raise ValueError(f"head_dim {D} not in {SUPPORTED_HEAD_DIMS}")
    if q.dtype not in _DTYPES or k_pages.dtype != q.dtype \
            or v_pages.dtype != q.dtype:
        raise TypeError(f"q/k/v must share one of {list(_DTYPES)}")
    if q.dtype == torch.bfloat16 and D in MMA_HEAD_DIMS:
        return "mma"
    return "fma"


def paged_attention_key_tile(D: int, dtype, route: str | None = None) -> int:
    """Keys per tile of the kernel's ring (``Shape::TK`` in the source):
    16 on the mma walk, else a 4 KB stage's worth of K and V rows, at
    most 32.  ``route`` None: the walk the route function picks."""
    if route is None:
        route = "mma" if dtype == torch.bfloat16 and D in MMA_HEAD_DIMS \
            else "fma"
    if route == "mma":
        return 16
    row = D * torch.empty((), dtype=dtype).element_size()
    return min(32, 2048 // row)


def _key_ranges(lens, window: int, n_keys: int, splits: int, tile: int):
    """Each rank's keys [lo, hi) (two (splits, B) tensors): the kept keys
    [max(0, len - window), min(len, n_keys)), cut into contiguous shares
    of whole key tiles as the kernel cuts them."""
    lens = lens.long()
    start = (lens - window).clamp(min=0) if window > 0 \
        else torch.zeros_like(lens)
    end = lens.clamp(max=n_keys)
    tb = start // tile
    n_all = (-(-end // tile) - tb).clamp(min=0)
    r = torch.arange(splits, device=lens.device)[:, None]
    t0 = tb + n_all * r // splits
    t1 = tb + n_all * (r + 1) // splits
    return torch.maximum(start, t0 * tile), torch.minimum(end, t1 * tile)


def paged_attention_partials_plain(q, k_pages, v_pages, block_tables, lens,
                                   window: int, splits: int, tile: int):
    """The kernel's per-rank partial states in plain PyTorch: for each of
    ``splits`` ranks, its running max m (S, B, H), sum l (S, B, H) and
    unnormalised output acc (S, B, H, D), f32, over its share of the keys
    (natural-log logits; ``block_tables`` None: a ring, as
    :func:`paged_attention_plain` reads it).  A rank with no key keeps
    m = NEG_INF, l = 0, acc = 0."""
    B, _, H, D = q.shape
    K = k_pages.shape[2]
    G = H // K
    k, v, n = paged_rows(k_pages, v_pages, block_tables, B)
    k, v = k.float(), v.float()
    logits = torch.einsum("bkgd,bskd->bkgs", q.float().reshape(B, K, G, D),
                          k) / math.sqrt(D)
    lo, hi = _key_ranges(lens, window, n, splits, tile)
    kpos = torch.arange(n, device=q.device)[None, :]
    ms, ls, accs = [], [], []
    for r in range(splits):
        keep = ((kpos >= lo[r][:, None]) & (kpos < hi[r][:, None])
                )[:, None, None]
        s = logits.masked_fill(~keep, NEG_INF)
        m = s.amax(dim=-1)
        p = torch.exp(s - m[..., None]).masked_fill(~keep, 0.0)
        ms.append(m.reshape(B, H))
        ls.append(p.sum(dim=-1).reshape(B, H))
        accs.append(torch.einsum("bkgs,bskd->bkgd", p, v).reshape(B, H, D))
    return torch.stack(ms), torch.stack(ls), torch.stack(accs)


def paged_attention_merge_plain(m, l, acc, dtype):
    """Merge the ranks' partial states as the cluster does: rescale each
    by exp(m_r - max m), sum, divide.  Returns (B, 1, H, D) in ``dtype``;
    a slot no rank saw (an idle slot) gives zeros."""
    mx = m.amax(dim=0)
    c = torch.exp(m - mx)
    lsum = (l * c).sum(dim=0)
    out = (acc * c[..., None]).sum(dim=0) / lsum.clamp_min(1e-30)[..., None]
    B, H, D = out.shape
    return out.reshape(B, 1, H, D).to(dtype)


_RING_TABLES: dict = {}


def ring_table(B: int, device) -> torch.Tensor:
    """The block table of a ring, [[0], [1], ..., [B - 1]] int32 on
    ``device``: made once per (B, device) and kept, so a launch on a ring
    allocates nothing (a CUDA graph captures it once it is made; made
    inside a capture, its values would exist only in the graph, so that
    raises)."""
    key = (B, torch.device(device))
    table = _RING_TABLES.get(key)
    if table is None:
        if key[1].type == "cuda" and torch.cuda.is_current_stream_capturing():
            raise RuntimeError(f"the ring table of {B} rows is made inside "
                               "a CUDA graph capture: launch once before it")
        table = torch.arange(B, dtype=torch.int32, device=device)[:, None]
        _RING_TABLES[key] = table
    return table


def paged_attention_cuda(q, k_pages, v_pages, block_tables, lens,
                         window: int, splits: int | None = None,
                         route: str | None = None):
    """Launch the paged decode kernel.

    q: (B, 1, H, D);  k_pages/v_pages: (P, ps, K, D) in q's dtype (float32
    or bfloat16);  block_tables: (B, M) int32, or None for a ring (P = B,
    row b's only page is page b: the kernel reads :func:`ring_table`);
    lens: (B,) int32, valid entries per slot including the newest token
    (0 = idle slot, zeros out);
    window: keys with ``len - 1 - kpos >= window`` are masked (<= 0: none);
    splits: the cluster size, one of ``SPLITS`` (None: the one
    :func:`paged_attention_splits` gives);  route: the walk ("fma" takes
    every input, "mma" only what :func:`paged_attention_route` gives it;
    None: that function's choice).  All tensors contiguous on one CUDA
    device.  Returns (B, 1, H, D).
    """
    if splits is not None and splits not in SPLITS:
        raise ValueError(f"splits {splits!r} not in {SPLITS}")
    route = _route.pick(paged_attention_route(q, k_pages, v_pages), route)
    B, one, H, D = q.shape
    P, ps, K, Dk = k_pages.shape
    if block_tables is None:
        if P != B:
            raise ValueError(f"a ring needs one page a row: {P} pages, "
                             f"{B} rows")
        block_tables = ring_table(B, q.device)
    if one != 1 or Dk != D or tuple(v_pages.shape) != (P, ps, K, D):
        raise ValueError(f"bad shapes q{tuple(q.shape)} k{tuple(k_pages.shape)} "
                         f"v{tuple(v_pages.shape)}")
    if K == 0 or H % K:
        raise ValueError(f"H={H} is not a multiple of K={K}")
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
    M = block_tables.shape[1]
    if splits is None:
        splits = paged_attention_splits(B, K, H // K, M, ps)
    out = torch.empty_like(q)
    lib = _lib()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = lib.paged_attention_launch(
            q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
            block_tables.data_ptr(), lens.data_ptr(), out.data_ptr(),
            B, H, K, D, ps, M, int(window), splits, int(route == "mma"),
            _DTYPES[q.dtype], stream)
    if rc:
        raise RuntimeError("paged_attention launch failed: "
                           + lib.paged_attention_error_string(rc).decode())
    paged_attention_cuda.launches += 1
    paged_attention_cuda.launches_by_route[route] += 1
    return out


paged_attention_cuda.launches = 0
paged_attention_cuda.launches_by_route = dict.fromkeys(ROUTES, 0)
