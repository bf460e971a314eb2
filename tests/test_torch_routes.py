"""Which kernel route the port's wrappers pick, and the build cache's key.

Kernels C (``lora_matmul``), B (forward and backward), G (``ssd_chunk``)
and its backward G′, and A (``paged_attention``) each have a tensor-core
route and an f32 FMA route.  A pure function of dtypes, shapes and offsets picks one before
the launch; A's and D's (``gram_log_volume``) splits and E's
(``quantize_rows``) grid are pure functions of shapes, and D and E check
their inputs before anything else.  These
tests read only metadata (meta tensors), so they run without a card.  The
CUDA libraries are content-addressed by the source, the headers it
includes and the flags, and every C function is bound with its exact
argument types.
"""
import ctypes

import pytest
import torch

from repro_torch.kernels import _build
from repro_torch.kernels.flash_attention import (
    flash_attention_backward_route, flash_attention_route)
from repro_torch.kernels.lora_matmul import lora_matmul_route
from repro_torch.kernels.paged_attention import (SPLITS, paged_attention_route,
                                                 paged_attention_splits)
from repro_torch.kernels.gram_volume import (SPLITS as GRAM_SPLITS,
                                             gram_log_volume_backward_cuda,
                                             gram_log_volume_cuda,
                                             gram_log_volume_splits)
from repro_torch.kernels.quantize import (BLOCKS_PER_SM, WARPS_PER_BLOCK,
                                          quantize_rows_cuda,
                                          quantize_rows_grid)
from repro_torch.kernels.ssd_scan import (ssd_chunk_bwd_cuda,
                                          ssd_chunk_bwd_route, ssd_chunk_route)

BF16, F32 = torch.bfloat16, torch.float32


def meta(*shape, dtype=BF16):
    return torch.empty(shape, dtype=dtype, device="meta")


def lora_args(M, K, N, r, dtype=BF16, trans_w=False):
    w = meta(N, K, dtype=dtype) if trans_w else meta(K, N, dtype=dtype)
    return meta(M, K, dtype=dtype), w, meta(K, r, dtype=dtype), \
        meta(r, N, dtype=dtype)


@pytest.mark.parametrize("M,K,N,trans_w", [
    (1088, 4096, 4096, False),     # the LLM's projection
    (1088, 4096, 4096, True),      # the LLM's dx
    (1088, 1280, 1280, False),     # the SLM's projection
    (1088, 1280, 1280, True),      # the SLM's dx
    (1001, 264, 136, False),       # ragged M
])
@pytest.mark.parametrize("r", [8, 16, 32])
def test_lora_bf16_aligned_takes_wgmma(M, K, N, trans_w, r):
    assert lora_matmul_route(*lora_args(M, K, N, r, trans_w=trans_w),
                             trans_w=trans_w) == "wgmma"


def test_lora_backward_views_take_wgmma():
    """The backward's dx passes B^T and A^T as views; they take the wgmma
    route like the forward's leaves."""
    M, K, N, r = 1088, 4096, 4096, 8
    dy, w, a, b = meta(M, N), meta(K, N), meta(K, r), meta(r, N)
    assert lora_matmul_route(dy, w, b.t(), a.t(), trans_w=True) == "wgmma"


@pytest.mark.parametrize("M,K,N,r,dtype", [
    (1088, 4096, 4096, 8, F32),    # f32 keeps the FMA kernel
    (37, 70, 48, 8, BF16),         # K not a multiple of 8
    (37, 64, 45, 8, BF16),         # N not a multiple of 8
    (37, 64, 48, 4, BF16),         # r not a multiple of 8
    (5, 3, 130, 32, BF16),         # K shorter than a 16-byte row
    (4, 0, 8, 8, BF16),            # empty K
])
def test_lora_other_inputs_take_fma(M, K, N, r, dtype):
    assert lora_matmul_route(*lora_args(M, K, N, r, dtype)) == "fma"


def test_lora_misaligned_offset_takes_fma():
    x = meta(1089, 64)[1:]         # rows start 128 bytes in: aligned
    assert x.storage_offset() * 2 % 16 == 0
    w, a, b = meta(64, 64), meta(64, 8), meta(8, 64)
    assert lora_matmul_route(x, w, a, b) == "wgmma"
    x = meta(1088 * 64 + 1)[1:].view(1088, 64)   # 2 bytes in
    assert lora_matmul_route(x, w, a, b) == "fma"


@pytest.mark.parametrize("args,err", [
    (lambda: (meta(8, 64), meta(32, 64), meta(64, 8), meta(8, 64)),
     ValueError),                                       # W's K differs
    (lambda: (meta(8, 64), meta(64, 64), meta(64, 8), meta(4, 64)),
     ValueError),                                       # B's rank differs
    (lambda: (meta(8, 64), meta(64, 64), meta(64, 40), meta(40, 64)),
     ValueError),                                       # rank above 32
    (lambda: (meta(8, 64), meta(64, 64, dtype=F32), meta(64, 8),
              meta(8, 64)), TypeError),                 # mixed dtypes
    (lambda: (meta(8, 64, dtype=torch.float16), meta(64, 64, dtype=torch.float16),
              meta(64, 8, dtype=torch.float16), meta(8, 64, dtype=torch.float16)),
     TypeError),                                        # no fp16 kernel
])
def test_lora_route_raises_on_bad_inputs(args, err):
    with pytest.raises(err):
        lora_matmul_route(*args())


def attn_args(B, Sq, Sk, H, K, D, dtype=BF16):
    return meta(B, Sq, H, D, dtype=dtype), meta(B, Sk, K, D, dtype=dtype), \
        meta(B, Sk, K, D, dtype=dtype)


@pytest.mark.parametrize("B,Sq,Sk,H,K,D", [
    (8, 136, 136, 20, 20, 64),     # the SLM in the round
    (8, 136, 136, 16, 16, 256),    # the LLM in the round
    (2, 45, 131, 8, 2, 128),       # GQA, Sq < Sk
    (1, 97, 97, 4, 1, 256),        # MQA
])
def test_flash_backward_bf16_takes_mma(B, Sq, Sk, H, K, D):
    assert flash_attention_backward_route(*attn_args(B, Sq, Sk, H, K, D)) \
        == "mma"


@pytest.mark.parametrize("D,dtype", [(64, F32), (256, F32), (32, BF16)])
def test_flash_backward_other_inputs_take_fma(D, dtype):
    assert flash_attention_backward_route(
        *attn_args(2, 40, 40, 4, 2, D, dtype)) == "fma"


@pytest.mark.parametrize("args,err", [
    (lambda: attn_args(2, 8, 8, 6, 4, 64), ValueError),    # H % K
    (lambda: attn_args(2, 8, 8, 4, 2, 48), ValueError),    # head dim
    (lambda: (meta(2, 8, 4, 64), meta(2, 8, 2, 64), meta(2, 9, 2, 64)),
     ValueError),                                          # v's shape
    (lambda: (meta(2, 8, 4, 64), meta(2, 8, 2, 64, dtype=F32),
              meta(2, 8, 2, 64)), TypeError),              # mixed dtypes
])
def test_flash_backward_route_raises_on_bad_inputs(args, err):
    with pytest.raises(err):
        flash_attention_backward_route(*args())


@pytest.mark.parametrize("B,Sq,Sk,H,K,D", [
    (1, 264, 264, 20, 20, 64),     # the SLM's serving prefill (8 soft + 256)
    (8, 136, 136, 20, 20, 64),     # the SLM in the round
    (8, 136, 136, 16, 16, 256),    # the LLM in the round
    (1, 1208, 1208, 25, 5, 64),    # hymba's longest prefill, GQA
    (2, 45, 131, 8, 2, 128),       # GQA, Sq < Sk
])
def test_flash_forward_bf16_takes_mma(B, Sq, Sk, H, K, D):
    assert flash_attention_route(*attn_args(B, Sq, Sk, H, K, D)) == "mma"


@pytest.mark.parametrize("D,dtype", [(64, F32), (256, F32), (32, BF16),
                                     (32, F32)])
def test_flash_forward_other_inputs_take_fma(D, dtype):
    """f32 (among them the f32 prefill -> decode checks) and D = 32."""
    assert flash_attention_route(*attn_args(2, 40, 40, 4, 2, D, dtype)) \
        == "fma"


def test_flash_forward_misaligned_offset_takes_fma():
    q, k, v = attn_args(1, 8, 8, 2, 2, 64)
    assert flash_attention_route(q, k, v) == "mma"
    qm = meta(8 * 2 * 64 + 1)[1:].view(1, 8, 2, 64)     # 2 bytes in
    assert flash_attention_route(qm, k, v) == "fma"


@pytest.mark.parametrize("args,err", [
    (lambda: attn_args(2, 8, 8, 6, 4, 64), ValueError),    # H % K
    (lambda: attn_args(2, 8, 8, 4, 2, 48), ValueError),    # head dim
    (lambda: (meta(2, 8, 4, 64), meta(2, 8, 2, 64, dtype=F32),
              meta(2, 8, 2, 64)), TypeError),              # mixed dtypes
])
def test_flash_forward_route_raises_on_bad_inputs(args, err):
    with pytest.raises(err):
        flash_attention_route(*args())


def ssd_args(B, S, H, P, G, N, dtype=BF16):
    return (meta(B, S, H, P, dtype=dtype), meta(B, S, H, dtype=F32),
            meta(B, S, H, dtype=F32), meta(B, S, G, N, dtype=dtype),
            meta(B, S, G, N, dtype=dtype))


@pytest.mark.parametrize("B,S,H,P,G,N,chunk", [
    (1, 256, 80, 64, 1, 128, 256),     # mamba2-2.7b, one chunk
    (1, 768, 80, 64, 1, 128, 256),     # mamba2, three chunks
    (1, 256, 50, 64, 1, 16, 256),      # hymba-1.5b
    (1, 256, 8, 64, 2, 64, 256),       # two groups
    (2, 512, 16, 64, 1, 128, 128),     # a batch, chunk 128
    (1, 192, 3, 128, 1, 32, 64),       # P 128, odd heads, chunk 64
])
def test_ssd_bf16_takes_mma(B, S, H, P, G, N, chunk):
    assert ssd_chunk_route(*ssd_args(B, S, H, P, G, N), chunk) == "mma"


@pytest.mark.parametrize("B,S,H,P,G,N,chunk,dtype", [
    (1, 256, 80, 64, 1, 128, 256, F32),    # f32 keeps the FMA kernel
    (1, 16, 4, 16, 1, 8, 8, BF16),         # the toy shapes
    (1, 200, 3, 24, 1, 20, 100, BF16),     # ragged: L 100, P 24, N 20
    (2, 96, 8, 64, 2, 32, 32, BF16),       # chunk 32 < 64
    (1, 256, 4, 64, 1, 256, 256, BF16),    # N above 128
    (1, 256, 4, 40, 1, 64, 256, BF16),     # P not a multiple of 16
])
def test_ssd_other_inputs_take_fma(B, S, H, P, G, N, chunk, dtype):
    assert ssd_chunk_route(*ssd_args(B, S, H, P, G, N, dtype), chunk) == "fma"


def test_ssd_misaligned_offset_takes_fma():
    x, dt, cum, Bm, Cm = ssd_args(1, 256, 4, 64, 1, 128)
    assert ssd_chunk_route(x, dt, cum, Bm, Cm, 256) == "mma"
    xm = meta(256 * 4 * 64 + 1)[1:].view(1, 256, 4, 64)   # 2 bytes in
    assert ssd_chunk_route(xm, dt, cum, Bm, Cm, 256) == "fma"


@pytest.mark.parametrize("args,err", [
    (lambda: (*ssd_args(1, 64, 4, 16, 1, 8), 48), ValueError),  # S % chunk
    (lambda: (*ssd_args(1, 64, 6, 16, 4, 8), 32), ValueError),  # H % G
    (lambda: (*ssd_args(1, 64, 4, 136, 1, 8, F32), 32),
     ValueError),                                               # P > 128
    (lambda: (*ssd_args(1, 64, 4, 16, 1, 8, torch.float16), 32),
     TypeError),                                                # no fp16
])
def test_ssd_route_raises_on_bad_inputs(args, err):
    with pytest.raises(err):
        ssd_chunk_route(*args())


def ssd_bwd_args(B, S, H, P, G, N, chunk, states=False, dtype=BF16):
    """G′'s arguments: G's, dy (f32, shaped as x), dstates (f32) or None,
    and the chunk."""
    dy = meta(B, S, H, P, dtype=F32)
    ds = meta(B, S // chunk, H, P, N, dtype=F32) if states else None
    return (*ssd_args(B, S, H, P, G, N, dtype), dy, ds, chunk)


@pytest.mark.parametrize("states", [False, True])
@pytest.mark.parametrize("B,S,H,P,G,N,chunk", [
    (8, 256, 80, 64, 1, 128, 256),     # mamba2-2.7b's training pass
    (8, 256, 50, 64, 1, 16, 256),      # hymba-1.5b's training pass
    (1, 768, 80, 64, 1, 128, 256),     # mamba2, three chunks
    (2, 256, 8, 64, 2, 64, 128),       # two groups, chunk 128
    (1, 192, 3, 128, 1, 32, 64),       # P 128, odd heads, chunk 64
])
def test_ssd_bwd_bf16_takes_mma(B, S, H, P, G, N, chunk, states):
    assert ssd_chunk_bwd_route(
        *ssd_bwd_args(B, S, H, P, G, N, chunk, states)) == "mma"


@pytest.mark.parametrize("B,S,H,P,G,N,chunk,dtype", [
    (8, 256, 80, 64, 1, 128, 256, F32),    # f32 keeps the FMA kernel
    (1, 256, 4, 64, 1, 24, 256, BF16),     # N not a multiple of 16
    (1, 256, 4, 40, 1, 64, 256, BF16),     # P not a multiple of 16
    (1, 96, 4, 64, 1, 64, 48, BF16),       # a chunk of 48
    (1, 16, 4, 16, 1, 8, 8, BF16),         # the toy shapes
])
def test_ssd_bwd_other_inputs_take_fma(B, S, H, P, G, N, chunk, dtype):
    for states in (False, True):
        args = ssd_bwd_args(B, S, H, P, G, N, chunk, states, dtype)
        assert ssd_chunk_bwd_route(*args) == "fma"


def test_ssd_bwd_misaligned_offsets_take_fma():
    x, dt, cum, Bm, Cm, dy, ds, chunk = ssd_bwd_args(1, 256, 4, 64, 1, 128,
                                                     256, True)
    assert ssd_chunk_bwd_route(x, dt, cum, Bm, Cm, dy, ds, chunk) == "mma"
    xm = meta(256 * 4 * 64 + 1)[1:].view(1, 256, 4, 64)     # 2 bytes in
    dym = meta(256 * 4 * 64 + 1, dtype=F32)[1:].view(1, 256, 4, 64)
    dsm = meta(4 * 64 * 128 + 1, dtype=F32)[1:].view(1, 1, 4, 64, 128)
    for args in ((xm, dt, cum, Bm, Cm, dy, ds), (x, dt, cum, Bm, Cm, dym, ds),
                 (x, dt, cum, Bm, Cm, dy, dsm)):
        assert ssd_chunk_bwd_route(*args, chunk) == "fma"


@pytest.mark.parametrize("args,err,match", [
    (lambda: ssd_bwd_args(1, 64, 4, 16, 1, 16, 48), ValueError,
     "multiple"),                                             # S % chunk
    (lambda: ssd_bwd_args(1, 64, 6, 16, 4, 16, 32), ValueError,
     "multiple"),                                             # H % G
    (lambda: (*ssd_bwd_args(1, 64, 4, 16, 1, 16, 32)[:5],
              meta(1, 64, 4, 32, dtype=F32), None, 32), ValueError,
     "shaped"),                                               # dy's shape
    (lambda: (*ssd_bwd_args(1, 64, 4, 16, 1, 16, 32)[:5],
              meta(1, 64, 4, 16), None, 32), TypeError,
     "float32"),                                              # bf16 dy
    (lambda: (*ssd_bwd_args(1, 64, 4, 16, 1, 16, 32)[:6],
              meta(1, 1, 4, 16, 16, dtype=F32), 32), ValueError,
     "dstates"),                                              # dS's shape
    (lambda: ssd_bwd_args(1, 64, 4, 16, 1, 144, 32), ValueError,
     "state N"),                                              # N > 128
    (lambda: ssd_bwd_args(1, 64, 4, 144, 1, 16, 32, dtype=F32), ValueError,
     "head dim"),                                             # P > 128
    (lambda: ssd_bwd_args(1, 64, 4, 16, 1, 16, 32, dtype=torch.float16),
     TypeError, "share"),                                     # no fp16
])
def test_ssd_bwd_route_raises_on_bad_inputs(args, err, match):
    with pytest.raises(err, match=match):
        ssd_chunk_bwd_route(*args())


@pytest.mark.parametrize("B,S,H,P,G,N,chunk,dtype", [
    (8, 256, 80, 64, 1, 128, 256, F32),    # f32
    (1, 96, 4, 64, 1, 64, 48, BF16),       # a chunk of 48
    (1, 256, 4, 40, 1, 64, 256, BF16),     # P 40
])
def test_ssd_bwd_forced_mma_raises_before_any_launch(B, S, H, P, G, N,
                                                      chunk, dtype):
    """Asking for the mma route on inputs it does not take raises before
    any launch (meta tensors: nothing could launch)."""
    before = (ssd_chunk_bwd_cuda.launches,
              dict(ssd_chunk_bwd_cuda.launches_by_route))
    with pytest.raises(ValueError, match="route 'mma'"):
        ssd_chunk_bwd_cuda(*ssd_bwd_args(B, S, H, P, G, N, chunk, True,
                                         dtype), route="mma")
    assert (ssd_chunk_bwd_cuda.launches,
            ssd_chunk_bwd_cuda.launches_by_route) == before


def paged_args(B, H, K, D, ps=16, M=32, dtype=BF16):
    P = B * M + 1
    return meta(B, 1, H, D, dtype=dtype), meta(P, ps, K, D, dtype=dtype), \
        meta(P, ps, K, D, dtype=dtype)


@pytest.mark.parametrize("B,H,K,D", [
    (16, 20, 20, 64),      # the SLM's decode
    (16, 25, 5, 64),       # hymba's decode, G = 5
    (4, 16, 1, 128),       # MQA, D 128
])
def test_paged_bf16_takes_mma(B, H, K, D):
    assert paged_attention_route(*paged_args(B, H, K, D)) == "mma"


@pytest.mark.parametrize("D,dtype", [(64, F32), (128, F32), (32, BF16),
                                     (256, BF16)])
def test_paged_other_inputs_take_fma(D, dtype):
    assert paged_attention_route(*paged_args(4, 4, 2, D, dtype=dtype)) \
        == "fma"


@pytest.mark.parametrize("args,err", [
    (lambda: paged_args(2, 4, 2, 48), ValueError),          # head dim
    (lambda: (meta(2, 1, 4, 64), meta(9, 16, 2, 64, dtype=F32),
              meta(9, 16, 2, 64)), TypeError),             # mixed dtypes
    (lambda: paged_args(2, 4, 2, 64, dtype=torch.float16),
     TypeError),                                           # no fp16
])
def test_paged_route_raises_on_bad_inputs(args, err):
    with pytest.raises(err):
        paged_attention_route(*args())


@pytest.mark.parametrize("B,K,G,M,ps", [
    (16, 20, 1, 32, 16), (16, 5, 5, 80, 16), (1, 1, 1, 256, 16),
    (64, 32, 4, 128, 16), (2, 8, 16, 6, 4), (3, 2, 3, 7, 8),
])
def test_paged_splits_is_a_power_of_two_up_to_8(B, K, G, M, ps):
    s = paged_attention_splits(B, K, G, M, ps)
    assert s in SPLITS
    assert paged_attention_splits(B, K, G, M, ps) == s      # shapes only


@pytest.mark.parametrize("M,ps", [(1, 16), (3, 16), (7, 8), (15, 4)])
def test_paged_splits_one_where_the_table_is_short(M, ps):
    """Fewer than two 32-key tiles (M * ps < 64): one block a walk, however
    few blocks the grid has."""
    assert M * ps < 64
    assert paged_attention_splits(1, 1, 1, M, ps) == 1


def test_paged_splits_at_the_engine_shapes():
    """The chosen cluster sizes, tuned on an H100 (fastest of {1, 2, 4, 8}
    at both shapes): the SLM's decode (16 slots x 20 KV heads = 320 blocks)
    takes 1, hymba's (16 x 5 = 80) 4, a lone slot of the SLM 8."""
    assert paged_attention_splits(16, 20, 1, 32, 16) == 1
    assert paged_attention_splits(16, 5, 5, 80, 16) == 4
    assert paged_attention_splits(1, 20, 1, 32, 16) == 8


def test_paged_forced_split_and_route_must_take_the_inputs():
    """``splits`` outside {1, 2, 4, 8} and ``route="mma"`` on inputs the
    mma walk does not take raise before any launch."""
    from repro_torch.kernels.paged_attention import paged_attention_cuda
    q, kp, vp = paged_args(2, 4, 2, 64)
    bt, lens = meta(2, 32, dtype=torch.int32), meta(2, dtype=torch.int32)
    n = (paged_attention_cuda.launches,
         dict(paged_attention_cuda.launches_by_route))
    for splits in (0, 3, 16):
        with pytest.raises(ValueError, match="splits"):
            paged_attention_cuda(q, kp, vp, bt, lens, 0, splits=splits)
    for args in (paged_args(2, 4, 2, 64, dtype=F32), paged_args(2, 4, 2, 32)):
        with pytest.raises(ValueError, match="route 'mma'"):
            paged_attention_cuda(*args, bt, lens, 0, route="mma")
    assert (paged_attention_cuda.launches,
            paged_attention_cuda.launches_by_route) == n


@pytest.mark.parametrize("k", range(1, 9))
@pytest.mark.parametrize("dtype", [BF16, F32])
def test_gram_takes_every_k_and_dtype_up_to_the_device(k, dtype):
    """Inputs the kernels take pass every check but the device's."""
    vs, mask = meta(80, k, 1280, dtype=dtype), meta(80, k, dtype=torch.bool)
    with pytest.raises(ValueError, match="CUDA device"):
        gram_log_volume_cuda(vs, mask)
    with pytest.raises(ValueError, match="CUDA device"):
        gram_log_volume_backward_cuda(vs, mask, meta(80, dtype=F32),
                                      meta(80, k, k, dtype=F32))


@pytest.mark.parametrize("args,err", [
    (lambda: (meta(4, 9, 64), meta(4, 9, dtype=torch.bool)), ValueError),
    (lambda: (meta(4, 0, 64), meta(4, 0, dtype=torch.bool)), ValueError),
    (lambda: (meta(4, 4, 64), meta(4, 3, dtype=torch.bool)), ValueError),
    (lambda: (meta(4, 4, 64), meta(4, 4, dtype=torch.uint8)), ValueError),
    (lambda: (meta(4, 64), meta(4, dtype=torch.bool)), ValueError),
    (lambda: (meta(4, 4, 64, dtype=torch.float16),
              meta(4, 4, dtype=torch.bool)), TypeError),
])
def test_gram_raises_on_bad_inputs(args, err):
    n = (gram_log_volume_cuda.launches, gram_log_volume_backward_cuda.launches)
    with pytest.raises(err, match="^(?!.*CUDA device)"):
        gram_log_volume_cuda(*args())
    with pytest.raises(err, match="^(?!.*CUDA device)"):
        gram_log_volume_backward_cuda(*args(), meta(4, dtype=F32),
                                      meta(4, 4, 4, dtype=F32))
    assert (gram_log_volume_cuda.launches,
            gram_log_volume_backward_cuda.launches) == n


@pytest.mark.parametrize("backward", [False, True])
@pytest.mark.parametrize("B,k,d,itemsize", [
    (80, 4, 1280, 2), (1, 8, 4096, 2), (1, 1, 4096, 4), (257, 4, 1280, 2),
    (1, 4, 8, 4), (3, 2, 33, 4), (132, 8, 65536, 2), (16, 3, 1000, 2),
    (0, 4, 1280, 2), (2, 4, 10 ** 6, 4),
])
def test_gram_splits_is_a_power_of_two_up_to_8(B, k, d, itemsize, backward):
    s = gram_log_volume_splits(B, k, d, itemsize, backward)
    assert s in GRAM_SPLITS
    assert gram_log_volume_splits(B, k, d, itemsize, backward) == s
    if s > 1:   # split only while the SMs are not covered, and never below
        # the least share: two 16-byte steps a thread of each row (forward),
        # 4 KB of the sample's rows (backward)
        share = (k if backward else 1) * d * itemsize // s
        assert B * s // 2 < 132 and share >= 2 * 128 * 16


def test_gram_splits_at_the_main_shapes():
    """The round's CCL loss (80 candidate sets of 4 bf16 rows of 1280)
    takes one block a sample forward (a row is 2560 bytes, under one
    block's two steps in flight) and two backward (160 blocks cover the
    132 SMs); one wide sample splits until a rank holds its least share; a
    batch that covers the card never splits."""
    splits = gram_log_volume_splits
    assert splits(80, 4, 1280, 2) == 1
    assert splits(80, 4, 1280, 2, backward=True) == 2
    assert splits(80, 4, 1280, 4) == 1
    assert splits(1, 8, 4096, 2) == 2
    assert splits(1, 8, 4096, 2, backward=True) == 8
    assert splits(1, 8, 4096, 4) == 4
    assert splits(1, 8, 16384, 2) == 8
    assert splits(132, 8, 16384, 2) == 1
    assert splits(132, 8, 16384, 2, backward=True) == 1
    for backward in (False, True):
        assert {splits(1, 1, d, 2, backward) for d in (8, 4096, 8192,
                                                       16384)} \
            == set(GRAM_SPLITS)


@pytest.mark.parametrize("dtype", [BF16, F32])
def test_quantize_takes_both_dtypes_up_to_the_device(dtype):
    """Inputs the kernel takes pass every check but the device's."""
    for x, qmax in ((meta(8640, 128, dtype=dtype), 127),
                    (meta(7, 3, dtype=dtype), 7)):
        with pytest.raises(ValueError, match="CUDA tensor"):
            quantize_rows_cuda(x, qmax)


@pytest.mark.parametrize("args,err", [
    (lambda: (meta(2, 4, 8), 127), ValueError),                 # not 2-D
    (lambda: (meta(4, 8, dtype=torch.float16), 127), TypeError),
    (lambda: (meta(4, 8), 0), ValueError),                      # qmax
    (lambda: (meta(4, 8), 128), ValueError),
])
def test_quantize_raises_on_bad_inputs(args, err):
    n = quantize_rows_cuda.launches
    with pytest.raises(err, match="^(?!.*CUDA tensor)"):
        quantize_rows_cuda(*args())
    assert quantize_rows_cuda.launches == n


@pytest.mark.parametrize("R,in_registers,n_sm,want", [
    (8640, True, 132, (1056, 2)),   # the uplink leaf: a row a warp overflows
    (8640, True, 78, (624, 2)),     # ... on a card with fewer SMs
    (2880, True, 132, (360, 1)),    # the downlink leaf: a row a warp
    (8448, True, 132, (1056, 1)),   # exactly one wave of one row a warp
    (8449, True, 132, (1056, 2)),   # one row past it
    (10 ** 6, True, 132, (1056, 2)),   # past 2 rows a warp: grid-stride
    (10 ** 5, False, 132, (1056, 1)),  # long rows: one row a warp, always
    (1, True, 132, (1, 1)), (0, True, 132, (1, 1)),   # tiny and empty
])
def test_quantize_grid_is_at_most_one_wave(R, in_registers, n_sm, want):
    grid, rpw = quantize_rows_grid(R, in_registers, n_sm)
    assert (grid, rpw) == want
    assert 1 <= grid <= BLOCKS_PER_SM * n_sm and rpw in (1, 2)
    assert rpw == 1 or in_registers
    # one step of the grid covers R, unless the grid is a full wave of
    # warps that hold all the rows they may
    assert grid * WARPS_PER_BLOCK * rpw >= R \
        or (grid == BLOCKS_PER_SM * n_sm and rpw == (2 if in_registers
                                                    else 1))
    # one row a warp where that covers R
    assert rpw == 1 or grid * WARPS_PER_BLOCK < R


def test_quantize_grid_raises_without_sms():
    with pytest.raises(ValueError):
        quantize_rows_grid(100, True, 0)


def test_library_path_follows_included_headers(tmp_path):
    """An edit to a header that a source includes, directly or through
    another header, changes the library's path (so it is rebuilt); an
    edit to a header it does not include does not."""
    (tmp_path / "k.cu").write_text('#include "a.cuh"\nint f() { return A; }\n')
    (tmp_path / "a.cuh").write_text('#include "b.cuh"\n#define A B\n')
    (tmp_path / "b.cuh").write_text("#define B 1\n")
    (tmp_path / "other.cuh").write_text("#define C 1\n")
    src = tmp_path / "k.cu"
    assert [p.name for p in _build.local_includes(src)] == ["a.cuh", "b.cuh"]
    first = _build.library_path(src)
    assert first.name.startswith("k-") and first.suffix == ".so"
    (tmp_path / "other.cuh").write_text("#define C 2\n")
    assert _build.library_path(src) == first
    (tmp_path / "b.cuh").write_text("#define B 2\n")
    second = _build.library_path(src)
    assert second != first
    (tmp_path / "a.cuh").write_text('#include "b.cuh"\n#define A (B + 1)\n')
    assert _build.library_path(src) not in (first, second)


def test_port_sources_hash_their_shared_header():
    """The four tensor-core sources include ``sm90.cuh``."""
    srcs = _build.sources()
    for name in ("lora_matmul", "flash_attention", "ssd_chunk",
                 "paged_attention"):
        assert "sm90.cuh" in [p.name for p in
                              _build.local_includes(srcs[name])]


def test_forced_route_must_take_the_inputs():
    """``route="fma"`` takes every input; the tensor-core routes only what
    their route function gives them (checked before any launch)."""
    from repro_torch.kernels.flash_attention import (
        flash_attention_backward_cuda, flash_attention_cuda)
    from repro_torch.kernels.lora_matmul import lora_matmul_cuda
    from repro_torch.kernels.ssd_scan import ssd_chunk_cuda
    with pytest.raises(ValueError, match="route 'wgmma'"):
        lora_matmul_cuda(*lora_args(8, 64, 64, 8, F32), 1.0, route="wgmma")
    q, k, v = attn_args(1, 8, 8, 2, 2, 32)
    lse = meta(1, 2, 8, dtype=F32)
    with pytest.raises(ValueError, match="route 'mma'"):
        flash_attention_backward_cuda(q, k, v, q, q, lse, route="mma")
    n = (flash_attention_cuda.launches, ssd_chunk_cuda.launches)
    for args in (attn_args(1, 8, 8, 2, 2, 32),
                 attn_args(1, 8, 8, 2, 2, 64, F32)):
        with pytest.raises(ValueError, match="route 'mma'"):
            flash_attention_cuda(*args, route="mma")
    for args, chunk in ((ssd_args(1, 16, 4, 16, 1, 8), 8),
                        (ssd_args(1, 256, 4, 64, 1, 128, F32), 256)):
        with pytest.raises(ValueError, match="route 'mma'"):
            ssd_chunk_cuda(*args, chunk, route="mma")
    assert (flash_attention_cuda.launches, ssd_chunk_cuda.launches) == n


C_TYPES = {"void*": ctypes.c_void_p, "int": ctypes.c_int,
           "float": ctypes.c_float, "long long": ctypes.c_longlong,
           "char*": ctypes.c_char_p}


def c_signatures(src):
    """{name: ([argument ctypes], return ctype)} of every ``extern "C"``
    function in a CUDA source."""
    import re

    def split(decl):       # "const void* x" -> ("void*", "x")
        kind, name = re.match(r"(.*?)(\w+)$", decl.strip(), re.S).groups()
        kind = " ".join(kind.replace("const", " ").split())
        return C_TYPES[kind.replace(" *", "*")], name
    out = {}
    for head, params in re.findall(r'extern "C"\s+([^(]*)\(([^)]*)\)',
                                   src.read_text()):
        ret, name = split(head)
        out[name] = ([split(p)[0] for p in params.split(",")], ret)
    return out


# the wrapper module of each CUDA source, where its name differs
MODULE_OF = {"ssd_chunk": "ssd_scan"}


@pytest.mark.parametrize("source", sorted(_build.sources()))
def test_ctypes_signatures_match_the_c_sources(source):
    """Every C function of every source is bound, through its module's
    ``C_FUNCTIONS`` table, with its exact argument and return types: a
    missing or extra argument type makes ctypes pass a pointer through a
    32-bit slot."""
    import importlib
    mod = importlib.import_module(
        f"repro_torch.kernels.{MODULE_OF.get(source, source)}")
    assert mod.C_FUNCTIONS == c_signatures(_build.sources()[source])
