"""The port's CUDA kernels against their plain versions, on the card.

Every test here needs an NVIDIA GPU (marker ``cuda``) and skips without
one.  The file imports neither JAX nor the JAX package, so it also runs on
a machine that has only PyTorch; from the root of a checkout:

    python -m pytest -q --noconftest -p no:cacheprovider -m cuda \
        tests/test_torch_cuda.py
"""
import contextlib

import numpy as np
import pytest
import torch

from repro_torch.kernels import _build, ops
from repro_torch.kernels.flash_attention import (
    flash_attention_backward_cuda, flash_attention_backward_plain,
    flash_attention_backward_route, flash_attention_cuda,
    flash_attention_plain, flash_attention_route)
from repro_torch.kernels.gram_volume import (
    gram_dots_plain, gram_log_volume_backward_cuda,
    gram_log_volume_backward_from_dots_plain, gram_log_volume_cuda,
    gram_log_volume_plain, gram_log_volume_splits)
from repro_torch.kernels.lora_matmul import (lora_matmul_cuda,
                                             lora_matmul_plain,
                                             lora_matmul_route)
from repro_torch.kernels.paged_attention import (paged_attention_cuda,
                                                 paged_attention_key_tile,
                                                 paged_attention_plain,
                                                 paged_attention_splits)
from repro_torch.kernels.quantize import (BLOCKS_PER_SM, WARPS_PER_BLOCK,
                                          dequantize_rows_cuda,
                                          dequantize_rows_plain,
                                          quantize_rows_cuda,
                                          quantize_rows_grid,
                                          quantize_rows_plain)
from repro_torch.kernels.ref import ssd_recurrent_ref
from repro_torch.kernels.ssd_scan import (ssd_chunk_cuda, ssd_chunk_plain,
                                          ssd_chunk_route)
from repro_torch.models.layers import BIG_WINDOW

pytestmark = pytest.mark.cuda

TOL = {torch.float32: dict(atol=2e-4, rtol=2e-4),
       # both sides round one f32 result to bf16
       torch.bfloat16: dict(atol=2e-2, rtol=1e-2)}


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernel, no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.Generator(device="cuda").manual_seed(0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,H,K,D,ps,M,window", [
    (5, 4, 2, 32, 8, 6, 0),
    (3, 12, 4, 128, 16, 4, 21),
    (2, 16, 1, 64, 4, 9, 0),        # MQA: G = 16 > 8, two head chunks
])
def test_paged_kernel_matches_plain(gen, dtype, B, H, K, D, ps, M, window):
    P = B * M + 3
    q = torch.randn((B, 1, H, D), generator=gen, device="cuda").to(dtype)
    kp = torch.randn((P, ps, K, D), generator=gen, device="cuda").to(dtype)
    vp = torch.randn((P, ps, K, D), generator=gen, device="cuda").to(dtype)
    bt = (torch.randperm(P - 1, generator=gen, device="cuda")[:B * M] + 1
          ).reshape(B, M).int()
    lens = torch.randint(1, M * ps + 1, (B,), generator=gen, device="cuda")
    lens[0] = 0
    lens = lens.int()
    n = paged_attention_cuda.launches
    got = ops.paged_attention(q, kp, vp, bt, lens, window or BIG_WINDOW)
    assert paged_attention_cuda.launches == n + 1
    want = paged_attention_plain(q, kp, vp, bt, lens, window).reshape(got.shape)
    torch.cuda.synchronize()
    torch.testing.assert_close(got.float(), want.float(), **TOL[dtype])
    assert torch.all(got[0] == 0)


def _paged_inputs(gen, H, K, D, ps, M, dtype, lens):
    """q, scattered pages and a block table for the given slot lengths."""
    B = len(lens)
    P = B * M + 1
    q = torch.randn((B, 1, H, D), generator=gen, device="cuda").to(dtype)
    kp = torch.randn((P, ps, K, D), generator=gen, device="cuda").to(dtype)
    vp = torch.randn((P, ps, K, D), generator=gen, device="cuda").to(dtype)
    bt = (torch.randperm(P - 1, generator=gen, device="cuda")[:B * M] + 1
          ).reshape(B, M).int()
    return q, kp, vp, bt, torch.tensor(lens, dtype=torch.int32, device="cuda")


def _paged_check(args, window, dtype, splits=None, route=None):
    got = paged_attention_cuda(*args, window, splits=splits, route=route)
    want = paged_attention_plain(*args, window)
    torch.cuda.synchronize()
    torch.testing.assert_close(got.float(), want.float(), **TOL[dtype])
    assert torch.all(got[args[-1] == 0] == 0)      # idle slots: exact zeros


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("window", [1024, BIG_WINDOW])
def test_paged_kernel_at_hymba_shape(gen, dtype, window):
    """hymba-1.5b's decode: H 25 in 5 KV groups, D 64, ps 16, M 80, the
    local layers' window 1024 and the global layers' none; lens 1-1280."""
    lens = [0, 1, 15, 16, 17, 300, 1023, 1024, 1025, 1100, 1279, 1280,
            640, 2, 999, 1200]
    args = _paged_inputs(gen, 25, 5, 64, 16, 80, dtype, lens)
    assert paged_attention_splits(16, 5, 5, 80, 16) == 4
    _paged_check(args, window, dtype)
    _paged_check(args, window, dtype, route="fma")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_paged_kernel_one_long_slot(gen, dtype):
    """A single slot with 4,096 keys."""
    args = _paged_inputs(gen, 8, 2, 64, 16, 256, dtype, [4096])
    for splits in (None, 1, 8):
        _paged_check(args, BIG_WINDOW, dtype, splits)


@pytest.mark.parametrize("splits", [1, 2, 4, 8])
@pytest.mark.parametrize("dtype,route", [(torch.float32, None),
                                         (torch.bfloat16, None),
                                         (torch.bfloat16, "fma")])
@pytest.mark.parametrize("window", [0, 5, 100])
def test_paged_kernel_every_split(gen, splits, dtype, route, window):
    """Every cluster size on both walks, with ranks that get no key: len 1,
    an idle slot, a window shorter than a tile, lens ending mid-page and on
    a tile's end."""
    tile = paged_attention_key_tile(64, dtype, route)
    lens = [1, 0, 2 * tile, 3 * tile + 5, 16 * 12 - 3, 7]
    args = _paged_inputs(gen, 20, 20, 64, 16, 12, dtype, lens)
    want_route = route or ("mma" if dtype == torch.bfloat16 else "fma")
    n = paged_attention_cuda.launches_by_route[want_route]
    _paged_check(args, window or BIG_WINDOW, dtype, splits, route)
    assert paged_attention_cuda.launches_by_route[want_route] == n + 1


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("D", [32, 128, 256])
@pytest.mark.parametrize("ps", [4, 8, 16])
def test_paged_kernel_head_dims_and_pages(gen, dtype, D, ps):
    """len 1, lens on a tile's end, ps 4 / 8 / 16, G = 3 (one chunk of 4)."""
    tile = paged_attention_key_tile(D, dtype)
    M = max(-(-4 * tile // ps), 3)
    lens = [1, tile, 4 * tile, 0, M * ps - 1, ps + 1]
    args = _paged_inputs(gen, 6, 2, D, ps, M, dtype, lens)
    for splits in (None, 4):
        _paged_check(args, BIG_WINDOW, dtype, splits)
    _paged_check(args, tile + 3, dtype)


def test_paged_kernel_in_a_cuda_graph(gen):
    """The launch reads no length on the host: a CUDA graph captures it,
    and a replay after the lengths change equals an eager launch."""
    q, kp, vp, bt, ln = _paged_inputs(gen, 20, 20, 64, 16, 32,
                                      torch.bfloat16, [0, 40, 300, 511])
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        paged_attention_cuda(q, kp, vp, bt, ln, BIG_WINDOW)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = paged_attention_cuda(q, kp, vp, bt, ln, BIG_WINDOW)
    for new in ([0, 40, 300, 511], [17, 0, 512, 1]):
        ln.copy_(torch.tensor(new, dtype=torch.int32))
        graph.replay()
        eager = paged_attention_cuda(q, kp, vp, bt, ln, BIG_WINDOW)
        torch.cuda.synchronize()
        assert torch.equal(out, eager)
        torch.testing.assert_close(
            out.float(), paged_attention_plain(q, kp, vp, bt, ln,
                                               BIG_WINDOW).float(),
            **TOL[torch.bfloat16])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,H,K,Sq,Sk,D,window", [
    (2, 4, 2, 1, 1, 32, 0),
    (1, 6, 3, 65, 65, 64, 0),
    (2, 2, 1, 17, 100, 128, 9),
    (1, 2, 2, 97, 97, 256, 40),
])
def test_flash_kernel_matches_plain(gen, dtype, B, H, K, Sq, Sk, D, window):
    q = torch.randn((B, Sq, H, D), generator=gen, device="cuda").to(dtype)
    k = torch.randn((B, Sk, K, D), generator=gen, device="cuda").to(dtype)
    v = torch.randn((B, Sk, K, D), generator=gen, device="cuda").to(dtype)
    n = flash_attention_cuda.launches
    got = ops.attention(q, k, v, causal=True, window=window)
    assert flash_attention_cuda.launches == n + 1
    want = flash_attention_plain(q, k, v, True, window).reshape(got.shape)
    torch.cuda.synchronize()
    torch.testing.assert_close(got.float(), want.float(), **TOL[dtype])


# log-sum-exp: both sides in f32 from the same inputs, summed in other orders
LSE_TOL = dict(atol=1e-4, rtol=1e-5)


@pytest.mark.parametrize("route", ["mma", "fma"])
@pytest.mark.parametrize("B,H,K,Sq,Sk,D,window", [
    (1, 6, 3, 65, 65, 64, 0),
    (2, 2, 1, 17, 100, 128, 9),
    (1, 2, 2, 97, 97, 256, 40),
    (1, 20, 20, 264, 264, 64, 0),      # the SLM's serving prefill
    (8, 16, 16, 136, 136, 256, 0),     # the LLM in the round
])
def test_flash_forward_routes_match_plain(gen, route, B, H, K, Sq, Sk, D,
                                          window):
    """Both routes of B's forward (bf16) against the plain version: the
    output at the bf16 bound, the log-sum-exp at f32's; one launch, on the
    route asked for (``"mma"`` is the route function's own choice)."""
    dt = torch.bfloat16
    q = torch.randn((B, Sq, H, D), generator=gen, device="cuda").to(dt)
    k, v = (torch.randn((B, Sk, K, D), generator=gen, device="cuda").to(dt)
            for _ in range(2))
    assert flash_attention_route(q, k, v) == "mma"
    with _routed(flash_attention_cuda, route):
        got, lse = flash_attention_cuda(q, k, v, True, window, with_lse=True,
                                        route=route)
    want, want_lse = flash_attention_plain(q, k, v, True, window,
                                           with_lse=True)
    torch.cuda.synchronize()
    torch.testing.assert_close(got.float(), want.float(), **TOL[dt])
    torch.testing.assert_close(lse, want_lse, **LSE_TOL)


@pytest.mark.parametrize("route", ["mma", "fma"])
def test_flash_forward_rows_without_keys_write_zeros(gen, route):
    """Sq > Sk: the first Sq - Sk queries (end-aligned) see no key and
    write zeros, never NaN; the others match the plain version."""
    dt, Sq, Sk = torch.bfloat16, 70, 40
    q = torch.randn((2, Sq, 4, 64), generator=gen, device="cuda").to(dt)
    k, v = (torch.randn((2, Sk, 2, 64), generator=gen, device="cuda").to(dt)
            for _ in range(2))
    got = flash_attention_cuda(q, k, v, True, 0, route=route)
    want = flash_attention_plain(q, k, v, True, 0)
    torch.cuda.synchronize()
    assert torch.all(got[:, :Sq - Sk] == 0)
    torch.testing.assert_close(got[:, Sq - Sk:].float(),
                               want[:, Sq - Sk:].float(), **TOL[dt])


def test_flash_forward_fma_route_takes_f32_and_d32(gen):
    for dtype, D in ((torch.float32, 64), (torch.bfloat16, 32)):
        q, k, v = (torch.randn((2, 40, 4, D), generator=gen,
                               device="cuda").to(dtype) for _ in range(3))
        assert flash_attention_route(q, k, v) == "fma"
        with _routed(flash_attention_cuda, "fma"):
            got = ops.attention(q, k, v, causal=True, window=0)
        want = flash_attention_plain(q, k, v, True, 0).reshape(got.shape)
        torch.cuda.synchronize()
        torch.testing.assert_close(got.float(), want.float(), **TOL[dtype])


def test_kernels_reject_what_they_do_not_take(gen):
    q = torch.randn((1, 1, 2, 48), device="cuda")
    with pytest.raises(ValueError, match="head_dim"):
        paged_attention_cuda(q, torch.randn((3, 4, 2, 48), device="cuda"),
                             torch.randn((3, 4, 2, 48), device="cuda"),
                             torch.ones((1, 2), dtype=torch.int32, device="cuda"),
                             torch.ones((1,), dtype=torch.int32, device="cuda"), 0)
    q = torch.randn((1, 8, 2, 64), device="cuda")
    with pytest.raises(TypeError):
        flash_attention_cuda(q, q.half(), q.half())


# ---------------------------------------------------------------------------
# kernel C: fused LoRA projection

def _lora_inputs(gen, M, K, N, r, dtype):
    x = torch.randn((M, K), generator=gen, device="cuda").to(dtype)
    w = (torch.randn((K, N), generator=gen, device="cuda") / K ** 0.5).to(dtype)
    a = (torch.randn((K, r), generator=gen, device="cuda") / K ** 0.5).to(dtype)
    b = (0.1 * torch.randn((r, N), generator=gen, device="cuda")).to(dtype)
    return x, w, a, b


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("M,K,N,r", [
    (64, 64, 64, 8),
    (1088, 128, 192, 8),      # the training M = 8 x (8 + 128)
    (37, 70, 45, 4),          # ragged M, N and K
    (5, 3, 130, 32),          # K shorter than a tile, the largest rank
])
def test_lora_kernel_matches_plain(gen, dtype, M, K, N, r):
    x, w, a, b = _lora_inputs(gen, M, K, N, r, dtype)
    n = lora_matmul_cuda.launches
    got = ops.lora_matmul(x, w, a, b, 2.0)
    assert lora_matmul_cuda.launches == n + 1
    want = lora_matmul_plain(x, w, a, b, 2.0)
    torch.cuda.synchronize()
    torch.testing.assert_close(got.float(), want.float(), **TOL[dtype])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_lora_kernel_transposed_w(gen, dtype):
    """trans_w reads W (N, K) in place as the (K, N) operand."""
    M, K, N, r = 50, 99, 77, 8
    x, _, a, b = _lora_inputs(gen, M, K, N, r, dtype)
    wt = torch.randn((N, K), generator=gen, device="cuda").to(dtype) / K ** 0.5
    got = lora_matmul_cuda(x, wt, a, b, 0.5, trans_w=True)
    want = lora_matmul_plain(x, wt.t(), a, b, 0.5)
    torch.cuda.synchronize()
    torch.testing.assert_close(got.float(), want.float(), **TOL[dtype])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_lora_kernel_gradients_match_plain_autograd(gen, dtype):
    M, K, N, r = 67, 96, 80, 8
    x, w, a, b = _lora_inputs(gen, M, K, N, r, dtype)
    dy = torch.randn((M, N), generator=gen, device="cuda").to(dtype)
    grads = []
    for fn in (ops.lora_matmul, lora_matmul_plain):
        xx, aa, bb = (t.clone().requires_grad_(True) for t in (x, a, b))
        n = lora_matmul_cuda.launches
        fn(xx, w, aa, bb, 2.0).backward(dy)
        if fn is ops.lora_matmul:
            assert lora_matmul_cuda.launches == n + 2     # forward and dx
        grads.append([t.grad.float() for t in (xx, aa, bb)])
    torch.cuda.synchronize()
    tol = TOL[dtype] if dtype == torch.float32 else dict(atol=5e-2, rtol=2e-2)
    for got, want in zip(*grads):
        torch.testing.assert_close(got, want, **tol)


@contextlib.contextmanager
def _routed(fn, route, n=1):
    """Assert that the calls inside the ``with`` launched ``fn`` ``n`` times,
    all on ``route``."""
    before = dict(fn.launches_by_route)
    yield
    moved = {r: c - before[r] for r, c in fn.launches_by_route.items()}
    assert moved == {r: (n if r == route else 0) for r in moved}


@pytest.mark.parametrize("M,K,N,r,trans_w", [
    (1088, 4096, 4096, 8, False),    # the LLM's projection
    (1088, 4096, 4096, 8, True),     # the LLM's dx (W read K-major)
    (1088, 1280, 1280, 8, False),    # the SLM's projection
    (1088, 1280, 1280, 8, True),     # the SLM's dx
    (1900, 136, 1800, 8, False),     # the 192 x 192 tile, ragged everywhere
    (1900, 136, 1800, 8, True),
    (1001, 264, 136, 16, False),     # M, K and N not multiples of a tile
    (77, 200, 72, 32, True),         # the largest rank, ragged everywhere
    (128, 64, 128, 24, False),       # one tile, one stage
])
def test_lora_wgmma_route_matches_plain(gen, M, K, N, r, trans_w):
    """The wgmma route (bf16, K/N/r multiples of 8) against the plain
    version: both W layouts, both tile shapes (192 x 192 where 99 or more
    such tiles fill the card at r = 8, else 128 x 96), ranks 8-32, ragged
    edges; one launch, on the wgmma route."""
    dt = torch.bfloat16
    x, w, a, b = _lora_inputs(gen, M, K, N, r, dt)
    if trans_w:
        w = (torch.randn((N, K), generator=gen, device="cuda") / K ** 0.5
             ).to(dt)
    assert lora_matmul_route(x, w, a, b, trans_w) == "wgmma"
    with _routed(lora_matmul_cuda, "wgmma"):
        got = lora_matmul_cuda(x, w, a, b, 2.0, trans_w=trans_w)
    want = lora_matmul_plain(x, w.t() if trans_w else w, a, b, 2.0)
    torch.cuda.synchronize()
    torch.testing.assert_close(got.float(), want.float(), **TOL[dt])


@pytest.mark.parametrize("M,K,N", [(1088, 1280, 1280), (300, 4096, 520)])
def test_lora_wgmma_route_gradients(gen, M, K, N):
    """Forward and dx on the wgmma route through autograd, against the
    plain version's autograd; each row held relative to its own size."""
    dt = torch.bfloat16
    x, w, a, b = _lora_inputs(gen, M, K, N, 8, dt)
    dy = torch.randn((M, N), generator=gen, device="cuda").to(dt)
    grads = []
    for fn in (ops.lora_matmul, lora_matmul_plain):
        xx, aa, bb = (t.clone().requires_grad_(True) for t in (x, a, b))
        if fn is ops.lora_matmul:
            with _routed(lora_matmul_cuda, "wgmma", n=2):
                fn(xx, w, aa, bb, 2.0).backward(dy)
        else:
            fn(xx, w, aa, bb, 2.0).backward(dy)
        grads.append([t.grad.float() for t in (xx, aa, bb)])
    torch.cuda.synchronize()
    for got, want in zip(*grads):
        scale = want.abs().amax(dim=1, keepdim=True).clamp(min=1e-30)
        torch.testing.assert_close(got / scale, want / scale,
                                   **TOL[torch.bfloat16])


@pytest.mark.parametrize("dtype,K,N,r,route", [
    (torch.float32, 64, 64, 8, "fma"),
    (torch.bfloat16, 70, 64, 8, "fma"),       # K not a multiple of 8
    (torch.bfloat16, 64, 64, 4, "fma"),       # r not a multiple of 8
])
def test_lora_fma_route_matches_plain(gen, dtype, K, N, r, route):
    x, w, a, b = _lora_inputs(gen, 50, K, N, r, dtype)
    assert lora_matmul_route(x, w, a, b) == route
    with _routed(lora_matmul_cuda, route):
        got = lora_matmul_cuda(x, w, a, b, 2.0)
    want = lora_matmul_plain(x, w, a, b, 2.0)
    torch.cuda.synchronize()
    torch.testing.assert_close(got.float(), want.float(), **TOL[dtype])


# ---------------------------------------------------------------------------
# kernel D: masked Gram log-volume, forward and backward

def _gram_inputs(gen, B, k, d, dtype):
    vs = torch.randn((B, k, d), generator=gen, device="cuda")
    mask = torch.rand((B, k), generator=gen, device="cuda") < 0.7
    mask[:, 0] = True
    vs = vs * mask[..., None]          # masked rows are all zero
    vs[1, k - 1] = 0.0                 # an unmasked all-zero row
    mask[1, k - 1] = True
    return vs.to(dtype), mask


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,k,d", [(7, 4, 1280), (130, 8, 1280), (3, 2, 33)])
def test_gram_kernel_matches_plain(gen, dtype, B, k, d):
    vs, mask = _gram_inputs(gen, B, k, d, dtype)
    n = gram_log_volume_cuda.launches
    got = ops.gram_log_volume(vs, mask)
    assert gram_log_volume_cuda.launches == n + 1
    want = gram_log_volume_plain(vs, mask)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, atol=1e-4, rtol=1e-4)


def _gram_grads_close(got, want, dtype, floor=None):
    """Gradients differ by orders of magnitude between samples: divide
    each sample by its own largest |gradient|, so that a kernel that
    writes zeros fails, but by no less than a tenth of the batch's
    largest.  Where a sample's rows are nearly orthogonal its gradient is
    small, while f32 leaves noise of about 1e-6 of the batch's scale (the
    normalization projects out the Gram's diagonal term by cancellation).
    ``floor`` (B,): a further lower bound of each sample's divisor (see
    ``_gram_cancelled_scale``)."""
    got, want = got.float(), want.float()
    scale = torch.maximum(want.abs().amax(dim=(1, 2)),
                          0.1 * want.abs().max())
    if floor is not None:
        scale = torch.maximum(scale, floor.float())
    scale = scale.clamp(min=1e-30)[:, None, None]
    tol = 1e-4 if dtype == torch.float32 else 2e-2
    torch.testing.assert_close(got / scale, want / scale, atol=tol, rtol=tol)


def _gram_cancelled_scale(vs, mask, gout):
    """A tenth of the size, per element, of the terms each sample's
    gradient cancels: |gout| max_i (r_i (G~^-1)_ii) max_i (G~^-1)_ii /
    sqrt(d) (in f64; a row's elements are about |v| / sqrt(d)).  The
    gradient through the normalization subtracts terms of that size; what
    is left can be smaller by the rows' cosine (k = 2, wide d) or by G~'s
    condition (k = d = 8), while in f32 the two sides' dot products differ
    by their summation order (~sqrt(d) 2^-24 relative), which that
    cancellation leaves at the size of these terms, not of the result."""
    dots = gram_dots_plain(vs).double()
    k, d = vs.shape[1], vs.shape[2]
    rr = torch.rsqrt(torch.diagonal(dots, dim1=-2, dim2=-1) + 1e-12)
    eye = torch.eye(k, dtype=torch.float64, device=vs.device)
    pair = mask[..., :, None] & mask[..., None, :]
    g = torch.where(pair, dots * rr[..., :, None] * rr[..., None, :], eye)
    gi = torch.diagonal(torch.linalg.inv(g + 1e-5 * eye), dim1=-2, dim2=-1)
    return 0.1 * gout.abs().double() * (rr * gi * mask).amax(-1) \
        * gi.amax(-1) / d ** 0.5


def _gram_floor(vs, mask, gout):
    """The cancellation floor where f32 showed that noise (k = 2 over a
    wide d, and k = d), else None: bf16, and every other shape, keep the
    per-sample scaling alone."""
    k, d = vs.shape[1], vs.shape[2]
    if vs.dtype != torch.float32 or not ((k == 2 and d >= 1000) or k == d):
        return None
    return _gram_cancelled_scale(vs, mask, gout)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,k,d", [(7, 4, 1280), (130, 8, 1280)])
def test_gram_kernel_backward_matches_plain_autograd(gen, dtype, B, k, d):
    vs, mask = _gram_inputs(gen, B, k, d, dtype)
    gout = torch.randn((B,), generator=gen, device="cuda")
    grads = []
    for fn in (ops.gram_log_volume, gram_log_volume_plain):
        v = vs.clone().requires_grad_(True)
        n = gram_log_volume_backward_cuda.launches
        fn(v, mask).backward(gout)
        if fn is ops.gram_log_volume:
            assert gram_log_volume_backward_cuda.launches == n + 1
        grads.append(v.grad.float())
    torch.cuda.synchronize()
    _gram_grads_close(grads[0], grads[1], dtype)
    masked = ~mask
    assert torch.all(grads[0][masked] == 0)


# (B, d): one sample over the widest d, the CCL loss's 80 candidate sets, a
# batch past two waves, d of one 16-byte step, d no multiple of a vector
GRAM_SHAPES = [(1, 4096), (80, 1280), (257, 1000), (80, 8), (3, 33)]


def _gram_dots_close(got, vs):
    want = gram_dots_plain(vs)
    torch.testing.assert_close(got, want, rtol=1e-4,
                               atol=1e-5 * float(want.abs().max()))


def _gram_case(gen, B, k, d, dtype):
    """Inputs, the kernels' y, dots and dL/dvs (one launch each), and the
    plain forward and autograd gradient on the same inputs."""
    vs, mask = _gram_inputs(gen, B, k, d, dtype) if B > 1 \
        else (torch.randn((B, k, d), generator=gen, device="cuda").to(dtype),
              torch.ones((B, k), dtype=torch.bool, device="cuda"))
    gout = torch.randn((B,), generator=gen, device="cuda")
    n = (gram_log_volume_cuda.launches, gram_log_volume_backward_cuda.launches)
    y, dots = gram_log_volume_cuda(vs, mask, return_dots=True)
    dvs = gram_log_volume_backward_cuda(vs, mask, gout, dots)
    assert (gram_log_volume_cuda.launches,
            gram_log_volume_backward_cuda.launches) == (n[0] + 1, n[1] + 1)
    torch.cuda.synchronize()
    v = vs.clone().requires_grad_(True)
    want = torch.autograd.grad(gram_log_volume_plain(v, mask), v, gout)[0]
    return vs, mask, gout, y, dots, dvs, gram_log_volume_plain(vs, mask), want


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("k", range(1, 9))
@pytest.mark.parametrize("B,d", GRAM_SHAPES)
def test_gram_kernels_match_plain(gen, dtype, k, B, d):
    """Forward and backward (from the forward's saved dots) against the
    plain versions; masked rows get an exactly zero gradient."""
    vs, mask, gout, y, dots, dvs, y_want, want = _gram_case(gen, B, k, d,
                                                            dtype)
    torch.testing.assert_close(y, y_want, atol=1e-4, rtol=1e-4)
    _gram_dots_close(dots, vs)
    if k == 1:
        # one normalized row: y = log sqrt(1 + eps) whatever the row, so the
        # gradient is zero up to f32 noise (~1e-7 / |v|) on both sides
        assert float(dvs.float().abs().max()) < 1e-5
        assert float(want.float().abs().max()) < 1e-5
        return
    floor = _gram_floor(vs, mask, gout)
    _gram_grads_close(dvs, want, dtype, floor)
    assert torch.all(dvs[~mask] == 0)
    # the closed form from the kernel's own dots (C's diagonal is a
    # difference of the same cancelled terms, rounded in another order)
    _gram_grads_close(dvs, gram_log_volume_backward_from_dots_plain(
        vs, dots, mask, gout), dtype, floor)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("k", [2, 4, 8])
@pytest.mark.parametrize("B,d", GRAM_SHAPES)
def test_gram_gradient_check_fails_a_planted_fault(gen, dtype, k, B, d):
    """The gradient check of ``test_gram_kernels_match_plain``, floor
    included, rejects the kernel's gradient scaled by 0.8."""
    vs, mask, gout, _, _, dvs, _, want = _gram_case(gen, B, k, d, dtype)
    with pytest.raises(AssertionError):
        _gram_grads_close(dvs * 0.8, want, dtype,
                          _gram_floor(vs, mask, gout))


# (B, k, d, dtype, S forward, S backward): shapes at which
# gram_log_volume_splits reaches every S of each pass (columns 4 and 5 each
# hold 1, 2, 4 and 8), with 16-byte steps and single values (d = 4099),
# even and uneven shares
GRAM_SPLIT_SHAPES = [
    (80, 4, 1280, torch.bfloat16, 1, 2),   # the round's CCL loss
    (9, 3, 33, torch.float32, 1, 1),
    (2, 4, 2048, torch.float32, 2, 8),
    (3, 2, 2048, torch.float32, 2, 4),
    (5, 8, 4096, torch.float32, 4, 8),
    (1, 3, 4099, torch.float32, 4, 8),
    (1, 2, 8192, torch.float32, 8, 8),
    (1, 8, 16384, torch.bfloat16, 8, 8),
]


@pytest.mark.parametrize("B,k,d,dtype,s_fwd,s_bwd", GRAM_SPLIT_SHAPES)
def test_gram_every_split(gen, B, k, d, dtype, s_fwd, s_bwd):
    isz = torch.finfo(dtype).bits // 8
    assert gram_log_volume_splits(B, k, d, isz) == s_fwd
    assert gram_log_volume_splits(B, k, d, isz, backward=True) == s_bwd
    vs, mask, gout, y, dots, dvs, y_want, want = _gram_case(gen, B, k, d,
                                                            dtype)
    torch.testing.assert_close(y, y_want, atol=1e-4, rtol=1e-4)
    _gram_dots_close(dots, vs)
    _gram_grads_close(dvs, want, dtype, _gram_floor(vs, mask, gout))
    assert torch.all(dvs[~mask] == 0)


def test_gram_takes_a_batch_past_65535_blocks(gen):
    """70,000 samples launch 70,000 blocks (more than a grid's y holds)
    and match the plain versions."""
    vs, mask, gout, y, dots, dvs, y_want, want = _gram_case(
        gen, 70000, 4, 64, torch.float32)
    assert gram_log_volume_splits(70000, 4, 64, 4) == 1
    torch.testing.assert_close(y, y_want, atol=1e-4, rtol=1e-4)
    _gram_dots_close(dots, vs)
    _gram_grads_close(dvs, want, torch.float32)


def test_gram_misaligned_rows(gen):
    """A batch that starts 4 bytes into its storage takes single-element
    loads (no 16-byte vector) and still matches."""
    B, k, d = 6, 4, 1280
    vs, mask = _gram_inputs(gen, B, k, d, torch.float32)
    flat = torch.empty(B * k * d + 1, device="cuda")
    off = flat[1:].view(B, k, d)
    off.copy_(vs)
    gout = torch.randn((B,), generator=gen, device="cuda")
    y, dots = gram_log_volume_cuda(off, mask, return_dots=True)
    dvs = gram_log_volume_backward_cuda(off, mask, gout, dots)
    torch.cuda.synchronize()
    torch.testing.assert_close(y, gram_log_volume_plain(vs, mask),
                               atol=1e-4, rtol=1e-4)
    v = vs.clone().requires_grad_(True)
    want = torch.autograd.grad(gram_log_volume_plain(v, mask), v, gout)[0]
    _gram_grads_close(dvs, want, torch.float32)


def test_gram_autograd_launches_each_kernel_once(gen):
    """``ops.gram_log_volume`` launches the forward and, from its saved
    dots, the backward: once each."""
    vs, mask = _gram_inputs(gen, 80, 4, 1280, torch.bfloat16)
    v = vs.clone().requires_grad_(True)
    n = (gram_log_volume_cuda.launches, gram_log_volume_backward_cuda.launches)
    ops.gram_log_volume(v, mask).sum().backward()
    assert (gram_log_volume_cuda.launches,
            gram_log_volume_backward_cuda.launches) == (n[0] + 1, n[1] + 1)


def test_gram_rejects_what_it_does_not_take(gen):
    vs, mask = _gram_inputs(gen, 4, 4, 64, torch.float32)
    gout = torch.ones((4,), device="cuda")
    n = (gram_log_volume_cuda.launches, gram_log_volume_backward_cuda.launches)
    with pytest.raises(ValueError, match="dots"):
        gram_log_volume_backward_cuda(vs, mask, gout,
                                      torch.zeros((4, 4, 3), device="cuda"))
    with pytest.raises(ValueError, match="dots"):
        gram_log_volume_backward_cuda(vs, mask, gout,
                                      torch.zeros((4, 4, 4), device="cuda",
                                                  dtype=torch.float64))
    with pytest.raises(ValueError, match="k=9"):
        gram_log_volume_cuda(torch.zeros((2, 9, 8), device="cuda"),
                             torch.ones((2, 9), dtype=torch.bool,
                                        device="cuda"))
    assert (gram_log_volume_cuda.launches,
            gram_log_volume_backward_cuda.launches) == n


def test_gram_and_quantize_in_a_cuda_graph(gen):
    """D's forward and backward and E (all launched with programmatic
    dependent launch) capture into one CUDA graph; a replay after the
    inputs change equals eager launches."""
    vs, mask = _gram_inputs(gen, 80, 4, 1280, torch.bfloat16)
    gout = torch.randn((80,), generator=gen, device="cuda")
    x = torch.randn((8640, 128), generator=gen, device="cuda")

    def run():
        y, dots = gram_log_volume_cuda(vs, mask, return_dots=True)
        dvs = gram_log_volume_backward_cuda(vs, mask, gout, dots)
        q, s = quantize_rows_cuda(x)
        return y, dots, dvs, q, s

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        run()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        outs = run()
    for _ in range(2):
        vs.copy_(torch.randn(vs.shape, generator=gen, device="cuda")
                 * mask[..., None])
        gout.copy_(torch.randn((80,), generator=gen, device="cuda"))
        x.copy_(torch.randn(x.shape, generator=gen, device="cuda"))
        graph.replay()
        eager = run()
        torch.cuda.synchronize()
        for a, b in zip(outs, eager):
            assert torch.equal(a, b)
        pq, ps = quantize_rows_plain(x)
        assert torch.equal(outs[3], pq) and torch.equal(_bits(outs[4]),
                                                        _bits(ps))
        torch.testing.assert_close(outs[0], gram_log_volume_plain(vs, mask),
                                   atol=1e-4, rtol=1e-4)


def _row_scaled(got, want):
    """Each (position, head) row of D divided by its own largest |want|,
    so that the tolerance is relative to the row and zeros fail, but by
    no less than a tenth of the tensor's largest: a query that sees one
    key has a dq of exactly zero, where f32 leaves ~1e-7 of noise (dS =
    P (dP - delta) cancels)."""
    D = want.shape[-1]
    want, got = want.float().reshape(-1, D), got.float().reshape(-1, D)
    scale = torch.maximum(want.abs().amax(dim=1, keepdim=True),
                          0.1 * want.abs().max()).clamp(min=1e-30)
    return got / scale, want / scale


def test_flash_attention_gradient_matches_plain_autograd(gen):
    """B's output and its backward kernels against the plain version's
    autograd at an LLM training shape (bf16, each row of D held relative
    to its own size)."""
    q, k, v = (torch.randn((2, 136, 16, 256), generator=gen,
                           device="cuda").to(torch.bfloat16) for _ in range(3))
    do = torch.randn((2, 136, 16 * 256), generator=gen,
                     device="cuda").to(torch.bfloat16)
    outs, grads = [], []
    for fn in ("kernel", "plain"):
        ins = [t.clone().requires_grad_(True) for t in (q, k, v)]
        n = flash_attention_backward_cuda.launches
        if fn == "kernel":
            out = ops.attention(*ins, causal=True, window=BIG_WINDOW)
        else:
            out = flash_attention_plain(*ins, True, 0).reshape(2, 136, -1)
        out.backward(do)
        assert flash_attention_backward_cuda.launches == n + (fn == "kernel")
        outs.append(out.detach().float())
        grads.append([t.grad.float() for t in ins])
    torch.cuda.synchronize()
    torch.testing.assert_close(*outs, **TOL[torch.bfloat16])
    # the kernel forms delta = rowsum(dO * O) from the bf16 output, the
    # plain autograd from the f32 one
    for got, want in zip(*grads):
        torch.testing.assert_close(*_row_scaled(got, want), atol=5e-2,
                                   rtol=2e-2)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,H,K,Sq,Sk,D,window", [
    (8, 20, 20, 136, 136, 64, 0),      # the SLM in the round
    (2, 16, 16, 136, 136, 256, 0),     # the LLM in the round
    (2, 6, 2, 45, 131, 64, 37),        # GQA, a window, Sq < Sk, ragged
    (1, 4, 1, 97, 97, 128, 0),         # MQA
])
def test_flash_backward_kernel_matches_plain(gen, dtype, B, H, K, Sq, Sk, D,
                                             window):
    """The backward kernels against the explicit formulas on the same
    inputs (the kernel's own output and log-sum-exp), row-scaled."""
    q = torch.randn((B, Sq, H, D), generator=gen, device="cuda").to(dtype)
    k, v = (torch.randn((B, Sk, K, D), generator=gen, device="cuda").to(dtype)
            for _ in range(2))
    do = torch.randn((B, Sq, H, D), generator=gen, device="cuda").to(dtype)
    o, lse = flash_attention_cuda(q, k, v, True, window, with_lse=True)
    _, want_lse = flash_attention_plain(q, k, v, True, window, with_lse=True)
    n = flash_attention_backward_cuda.launches
    got = flash_attention_backward_cuda(q, k, v, o, do, lse, True, window)
    assert flash_attention_backward_cuda.launches == n + 1
    want = flash_attention_backward_plain(q, k, v, o, do, lse, True, window)
    torch.cuda.synchronize()
    torch.testing.assert_close(lse, want_lse, atol=1e-4, rtol=1e-5)
    tol = TOL[torch.float32] if dtype == torch.float32 else \
        dict(atol=2e-2, rtol=1e-2)
    for g, w in zip(got, want):
        assert g.dtype == dtype
        torch.testing.assert_close(*_row_scaled(g, w), **tol)


@pytest.mark.parametrize("B,H,K,Sq,Sk,D,window", [
    (8, 20, 20, 136, 136, 64, 0),      # the SLM in the round
    (8, 16, 16, 136, 136, 256, 0),     # the LLM in the round
    (2, 8, 2, 45, 131, 256, 0),        # GQA, Sq < Sk, D 256
    (2, 6, 2, 77, 200, 64, 37),        # GQA, a window, Sq < Sk
    (1, 4, 1, 97, 97, 128, 50),        # MQA, a window, D 128
    (1, 2, 2, 1, 9, 64, 0),            # one query row
])
def test_flash_backward_mma_route_matches_plain(gen, B, H, K, Sq, Sk, D,
                                                window):
    """The tensor-core backward (bf16, D 64/128/256) against the explicit
    formulas on the kernel's own output and log-sum-exp, row-scaled; one
    launch, on the mma route."""
    dt = torch.bfloat16
    q = torch.randn((B, Sq, H, D), generator=gen, device="cuda").to(dt)
    k, v = (torch.randn((B, Sk, K, D), generator=gen, device="cuda").to(dt)
            for _ in range(2))
    do = torch.randn((B, Sq, H, D), generator=gen, device="cuda").to(dt)
    o, lse = flash_attention_cuda(q, k, v, True, window, with_lse=True)
    assert flash_attention_backward_route(q, k, v) == "mma"
    with _routed(flash_attention_backward_cuda, "mma"):
        got = flash_attention_backward_cuda(q, k, v, o, do, lse, True, window)
    want = flash_attention_backward_plain(q, k, v, o, do, lse, True, window)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        torch.testing.assert_close(*_row_scaled(g, w), **TOL[dt])


@pytest.mark.parametrize("B,H,K,S,D,window", [
    (2, 20, 20, 136, 64, 0),           # the SLM in the round
    (2, 8, 2, 131, 128, 45),           # GQA, a window, ragged S
])
def test_flash_autograd_runs_both_passes_on_mma(gen, B, H, K, S, D, window):
    """Through ``flash_attention_autograd`` (``ops.attention``) bf16 takes
    the tensor-core forward and backward; output and gradients against
    the plain version's autograd, each row held relative to its size."""
    dt = torch.bfloat16
    q = torch.randn((B, S, H, D), generator=gen, device="cuda").to(dt)
    k, v = (torch.randn((B, S, K, D), generator=gen, device="cuda").to(dt)
            for _ in range(2))
    do = torch.randn((B, S, H * D), generator=gen, device="cuda").to(dt)
    outs, grads = [], []
    for kernel in (True, False):
        ins = [t.clone().requires_grad_(True) for t in (q, k, v)]
        if kernel:
            with _routed(flash_attention_cuda, "mma"), \
                    _routed(flash_attention_backward_cuda, "mma"):
                out = ops.attention(*ins, causal=True, window=window)
                out.backward(do)
        else:
            out = flash_attention_plain(*ins, True, window).reshape(B, S, -1)
            out.backward(do)
        outs.append(out.detach().float())
        grads.append([t.grad.float() for t in ins])
    torch.cuda.synchronize()
    torch.testing.assert_close(*outs, **TOL[dt])
    # the kernel forms delta = rowsum(dO * O) from the bf16 output, the
    # plain autograd from the f32 one
    for got, want in zip(*grads):
        torch.testing.assert_close(*_row_scaled(got, want), atol=5e-2,
                                   rtol=2e-2)


@pytest.mark.parametrize("dtype,D", [(torch.float32, 64), (torch.bfloat16, 32)])
def test_flash_backward_fma_route(gen, dtype, D):
    """f32, and bf16 at D 32, keep the FMA kernels."""
    q, k, v, do = (torch.randn((2, 40, 4, D), generator=gen,
                               device="cuda").to(dtype) for _ in range(4))
    o, lse = flash_attention_cuda(q, k, v, True, 0, with_lse=True)
    assert flash_attention_backward_route(q, k, v) == "fma"
    with _routed(flash_attention_backward_cuda, "fma"):
        got = flash_attention_backward_cuda(q, k, v, o, do, lse, True, 0)
    want = flash_attention_backward_plain(q, k, v, o, do, lse, True, 0)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        torch.testing.assert_close(*_row_scaled(g, w), **TOL[dtype])


# ---------------------------------------------------------------------------
# kernels E and F: the wire codec's quantize / dequantize pair

def _tile_rows(R, L, qmax, seed):
    """Random rows over six decades, all-zero rows and exact half-way ties
    (absmax = qmax * 2^e makes the scale 2^e exactly)."""
    rng = np.random.RandomState(seed)
    x = rng.randn(R, L) * 10.0 ** rng.uniform(-3, 2, (R, 1))
    x[0] = 0.0
    for i in range(1, R, 5):
        e = 2.0 ** rng.randint(-6, 4)
        x[i] = (rng.randint(1 - qmax, qmax - 1, L) + 0.5) * e
        x[i, rng.randint(L)] = qmax * e
    return torch.from_numpy(x.astype(np.float32))


def _bits(t):
    return t.contiguous().view(torch.int32)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("qmax", [127, 7])
@pytest.mark.parametrize("R,L", [(8640, 128), (2880, 128), (129, 131),
                                 (7, 3), (1, 257)])
def test_quantize_kernels_equal_plain_bitwise(gen, dtype, qmax, R, L):
    x = _tile_rows(R, L, qmax, R + L + qmax).to(dtype)
    xc = x.cuda()
    n = (quantize_rows_cuda.launches, dequantize_rows_cuda.launches)
    q, s = ops.quantize(xc, qmax)
    out = ops.dequantize(q, s)
    assert (quantize_rows_cuda.launches,
            dequantize_rows_cuda.launches) == (n[0] + 1, n[1] + 1)
    for ref_x in (xc, x):                   # plain on the card, on the CPU
        pq, ps = quantize_rows_plain(ref_x, qmax)
        pout = dequantize_rows_plain(pq, ps)
        torch.cuda.synchronize()
        assert torch.equal(q.cpu(), pq.cpu())
        assert torch.equal(_bits(s).cpu(), _bits(ps).cpu())
        assert torch.equal(_bits(out).cpu(), _bits(pout).cpu())
    assert s[0].item() == 0.0 and bool((q[0] == 0).all())


def test_quantize_kernels_reject_what_they_do_not_take(gen):
    with pytest.raises(TypeError):
        quantize_rows_cuda(torch.zeros((4, 8), dtype=torch.float16,
                                       device="cuda"))
    with pytest.raises(ValueError, match="qmax"):
        quantize_rows_cuda(torch.zeros((4, 8), device="cuda"), 200)
    with pytest.raises(ValueError):
        dequantize_rows_cuda(torch.zeros((4, 8), dtype=torch.int8,
                                         device="cuda"),
                             torch.zeros((3,), device="cuda"))


# (R, L): the uplink and downlink leaves (rows in registers), ragged rows,
# rows past 32 vectors (one row per warp, read twice), tiny shapes
QUANT_SHAPES = [(8640, 128), (2880, 128), (129, 131), (7, 3), (1, 257),
                (300, 256), (1000, 512), (50, 2048), (33, 1024)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("qmax", [127, 7])
@pytest.mark.parametrize("R,L", QUANT_SHAPES)
def test_quantize_equals_plain_bitwise(gen, dtype, qmax, R, L):
    x = _tile_rows(R, L, qmax, R + L + qmax).to(dtype).cuda()
    n = quantize_rows_cuda.launches
    q, s = quantize_rows_cuda(x, qmax)
    assert quantize_rows_cuda.launches == n + 1
    pq, ps = quantize_rows_plain(x, qmax)
    torch.cuda.synchronize()
    assert torch.equal(q, pq)
    assert torch.equal(_bits(s), _bits(ps))
    assert s[0].item() == 0.0 and bool((q[0] == 0).all())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_quantize_around_one_wave(gen, dtype):
    """R on either side of the one-wave boundary (where the grid stops
    growing and a warp holds 2 rows) and past two rows a warp (where the
    grid-stride loop takes the rest), bit for bit."""
    L = 128
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    wave = WARPS_PER_BLOCK * BLOCKS_PER_SM * n_sm    # warps of one wave
    for R in (wave - 1, wave, wave + 1, 2 * wave + 3):
        grid, rpw = quantize_rows_grid(R, True, n_sm)
        assert grid == min(-(-R // WARPS_PER_BLOCK), BLOCKS_PER_SM * n_sm)
        assert rpw == (1 if R <= wave else 2)
        x = _tile_rows(R, L, 127, R).to(dtype).cuda()
        q, s = quantize_rows_cuda(x)
        pq, ps = quantize_rows_plain(x)
        torch.cuda.synchronize()
        assert torch.equal(q, pq), R
        assert torch.equal(_bits(s), _bits(ps)), R


def test_quantize_kernel_fits_its_blocks_an_sm(gen):
    """Every instance of the quantize kernel compiles to at most the
    registers that let ``BLOCKS_PER_SM`` blocks of ``WARPS_PER_BLOCK``
    warps share an SM's 65,536 (its launch bounds), so the grid rule's
    one wave is resident at once.  (Under that cap ptxas may spill a few
    bytes around the IEEE division's slow path; chip_smoke.py reports
    them.)"""
    import re
    quantize_rows_cuda(torch.zeros((8, 128), device="cuda"))
    log, entry, seen = _build.build_log("quantize"), None, {}
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            # (not dequantize_rows_kernel: its length prefix differs)
            entry = m.group(1) if re.search(r"\dquantize_rows_kernelI",
                                            m.group(1)) else None
            continue
        hit = entry and re.search(r"Used (\d+) registers", line)
        if hit:
            seen[entry] = int(hit.group(1))
    assert len(seen) == 8       # 2 dtypes x (1, 2 rows in registers, 2 not)
    cap = 65536 // (BLOCKS_PER_SM * WARPS_PER_BLOCK * 32)
    assert max(seen.values()) <= cap, seen


def test_quantize_misaligned_rows(gen):
    """Rows that start 4 bytes into their storage take single-element
    loads and stay bit for bit."""
    R, L = 515, 128
    x = _tile_rows(R, L, 127, 3).cuda()
    off = torch.empty(R * L + 1, device="cuda")[1:].view(R, L)
    off.copy_(x)
    q, s = quantize_rows_cuda(off)
    pq, ps = quantize_rows_plain(x)
    torch.cuda.synchronize()
    assert torch.equal(q, pq) and torch.equal(_bits(s), _bits(ps))


def test_quantize_counts_its_launches(gen):
    x = torch.randn((64, 128), generator=gen, device="cuda")
    n = quantize_rows_cuda.launches
    ops.quantize(x)
    assert quantize_rows_cuda.launches == n + 1


# ---------------------------------------------------------------------------
# kernel G: the SSD chunk scan

def _ssd_inputs(gen, B, S, H, P, G, N, dtype, dt_shift=0.0):
    """Model-like inputs: A = -linspace(1, 16) as the SSM's init gives,
    dt = softplus(N(0, 1) + dt_shift)."""
    def randn(*shape):
        return torch.randn(shape, generator=gen, device="cuda")
    x = (0.5 * randn(B, S, H, P)).to(dtype)
    dt = torch.nn.functional.softplus(randn(B, S, H) + dt_shift)
    A = -torch.linspace(1.0, 16.0, H, device="cuda")
    Bm = (0.5 * randn(B, S, G, N)).to(dtype)
    Cm = (0.5 * randn(B, S, G, N)).to(dtype)
    return x, dt, A, Bm, Cm


def _chunk_cum(dt, A, chunk):
    B, S, H = dt.shape
    return torch.cumsum((dt * A).reshape(B, S // chunk, chunk, H),
                        dim=2).reshape(B, S, H)


# both sides compute in f32 on the same (bf16 or f32) values: f32 bounds
SSD_TOL = dict(atol=2e-4, rtol=2e-4)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,S,H,P,G,N,L", [
    (1, 256, 80, 64, 1, 128, 256),     # mamba2-2.7b, one chunk
    (1, 512, 50, 64, 1, 16, 256),      # hymba-1.5b, two chunks
    (2, 96, 8, 64, 2, 32, 32),         # G = 2, a batch of several chunks
    (1, 16, 4, 16, 1, 8, 8),           # the CPU tests' toy sizes
    (1, 200, 3, 24, 1, 20, 100),       # ragged tiles: L 100, P 24, N 20
])
def test_ssd_chunk_kernel_matches_plain(gen, dtype, B, S, H, P, G, N, L):
    x, dt, A, Bm, Cm = _ssd_inputs(gen, B, S, H, P, G, N, dtype)
    cum = _chunk_cum(dt, A, L)
    n = ssd_chunk_cuda.launches
    y, st = ssd_chunk_cuda(x, dt, cum, Bm, Cm, L)
    assert ssd_chunk_cuda.launches == n + 1
    py, pst = ssd_chunk_plain(x, dt, cum, Bm, Cm, L)
    torch.cuda.synchronize()
    assert y.dtype == st.dtype == torch.float32
    torch.testing.assert_close(y, py, **SSD_TOL)
    torch.testing.assert_close(st, pst, **SSD_TOL)


@pytest.mark.parametrize("S", [200, 256, 300, 700])
def test_ssd_chunked_on_the_card_matches_the_recurrence(gen, S):
    """ops.ssd_chunked on CUDA tensors: one launch of G for all chunks,
    padding, the final state; f32 at tests/test_kernels.py's bound."""
    x, dt, A, Bm, Cm = _ssd_inputs(gen, 1, S, 8, 64, 1, 128, torch.float32)
    A = A / 8.0                      # decays that reach across chunks
    n = ssd_chunk_cuda.launches
    y, h = ops.ssd_chunked(x, dt, A, Bm, Cm, 256, return_state=True)
    assert ssd_chunk_cuda.launches == n + 1
    ry, rh = ssd_recurrent_ref(x, dt, A, Bm, Cm, return_state=True)
    torch.cuda.synchronize()
    torch.testing.assert_close(y, ry, atol=1e-4, rtol=1e-3)
    torch.testing.assert_close(h, rh, atol=1e-4, rtol=1e-3)


def test_ssd_chunk_kernel_large_decay_is_finite(gen):
    """|A| dt up to ~16 * 6 per row: above the diagonal exp(cum_i - cum_j)
    would be inf, and inf * 0 NaN; the kernel never evaluates it."""
    x, dt, A, Bm, Cm = _ssd_inputs(gen, 1, 512, 8, 64, 1, 128,
                                   torch.bfloat16, dt_shift=5.0)
    cum = _chunk_cum(dt, A, 256)
    y, st = ssd_chunk_cuda(x, dt, cum, Bm, Cm, 256)
    py, pst = ssd_chunk_plain(x, dt, cum, Bm, Cm, 256)
    torch.cuda.synchronize()
    assert torch.isfinite(y).all() and torch.isfinite(st).all()
    torch.testing.assert_close(y, py, **SSD_TOL)
    torch.testing.assert_close(st, pst, **SSD_TOL)


SSD_ROUTE_SHAPES = [                   # (B, S, H, P, G, N, L)
    (1, 256, 80, 64, 1, 128, 256),     # mamba2-2.7b, one chunk
    (1, 512, 50, 64, 1, 16, 256),      # hymba-1.5b, two chunks
    (2, 96, 8, 64, 2, 32, 32),         # chunk 32: FMA only
    (1, 16, 4, 16, 1, 8, 8),           # the toy sizes: FMA only
    (1, 200, 3, 24, 1, 20, 100),       # ragged tiles: FMA only
    (2, 256, 8, 64, 2, 64, 128),       # two groups, chunk 128
    (1, 192, 3, 128, 1, 32, 64),       # P 128 (one head a block), 3 heads
    (1, 128, 5, 48, 1, 16, 64),        # P 48: a half state block, 5 heads
]


@pytest.mark.parametrize("route", ["mma", "fma"])
@pytest.mark.parametrize("B,S,H,P,G,N,L", SSD_ROUTE_SHAPES)
def test_ssd_chunk_routes_match_plain(gen, route, B, S, H, P, G, N, L):
    """Both routes of G (bf16) against the plain version at the f32 bound;
    one launch, on the route asked for.  Where the route function refuses
    the mma route, asking for it raises before any launch."""
    x, dt, A, Bm, Cm = _ssd_inputs(gen, B, S, H, P, G, N, torch.bfloat16)
    cum = _chunk_cum(dt, A, L)
    if route == "mma" and ssd_chunk_route(x, dt, cum, Bm, Cm, L) != "mma":
        with _routed(ssd_chunk_cuda, route, n=0), \
                pytest.raises(ValueError, match="route 'mma'"):
            ssd_chunk_cuda(x, dt, cum, Bm, Cm, L, route=route)
        return
    with _routed(ssd_chunk_cuda, route):
        y, st = ssd_chunk_cuda(x, dt, cum, Bm, Cm, L, route=route)
    py, pst = ssd_chunk_plain(x, dt, cum, Bm, Cm, L)
    torch.cuda.synchronize()
    torch.testing.assert_close(y, py, **SSD_TOL)
    torch.testing.assert_close(st, pst, **SSD_TOL)


@pytest.mark.parametrize("route", ["mma", "fma"])
def test_ssd_chunk_routes_large_decay_are_finite(gen, route):
    """The large-|A| dt case of the test above on each route: the mask
    comes before exp on the mma route's diagonal tiles too."""
    x, dt, A, Bm, Cm = _ssd_inputs(gen, 1, 512, 80, 64, 1, 128,
                                   torch.bfloat16, dt_shift=5.0)
    cum = _chunk_cum(dt, A, 256)
    with _routed(ssd_chunk_cuda, route):
        y, st = ssd_chunk_cuda(x, dt, cum, Bm, Cm, 256, route=route)
    py, pst = ssd_chunk_plain(x, dt, cum, Bm, Cm, 256)
    torch.cuda.synchronize()
    assert torch.isfinite(y).all() and torch.isfinite(st).all()
    torch.testing.assert_close(y, py, **SSD_TOL)
    torch.testing.assert_close(st, pst, **SSD_TOL)


def test_ssd_chunk_kernel_rejects_what_it_does_not_take(gen):
    x, dt, A, Bm, Cm = _ssd_inputs(gen, 1, 64, 4, 16, 1, 8, torch.float32)
    cum = _chunk_cum(dt, A, 32)
    with pytest.raises(ValueError, match="multiple"):
        ssd_chunk_cuda(x, dt, cum, Bm, Cm, 48)
    with pytest.raises(TypeError):
        ssd_chunk_cuda(x.half(), dt, cum, Bm.half(), Cm.half(), 32)
    with pytest.raises(ValueError, match="head dim"):
        big = torch.zeros((1, 64, 4, 136), device="cuda")
        ssd_chunk_cuda(big, dt, cum, Bm, Cm, 32)
    with pytest.raises(NotImplementedError, match="backward"):
        ssd_chunk_cuda(x.requires_grad_(True), dt, cum, Bm, Cm, 32)
