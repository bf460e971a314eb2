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
                                             lora_matmul_grouped_cuda,
                                             lora_matmul_grouped_plain,
                                             lora_matmul_grouped_route,
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
from repro_torch.kernels.ssd_scan import (ssd_chunk_bwd_cuda,
                                          ssd_chunk_bwd_plain,
                                          ssd_chunk_bwd_route, ssd_chunk_cuda,
                                          ssd_chunk_plain, ssd_chunk_route)
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
    (8, 16, 8, 128, 16, 21, 0),     # qwen3's cohort serving: G = 2, D 128
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


def _ring_attention_ref(q, ck, cv, cache_pos, pos, window):
    """The reference's ring decode (repro/models/layers.py:
    decode_attention): softmax over the slots whose position p has
    0 <= p <= pos and pos - p < window, f32."""
    B, _, H, D = q.shape
    G = H // ck.shape[2]
    k = ck.float().repeat_interleave(G, dim=2)
    v = cv.float().repeat_interleave(G, dim=2)
    s = torch.einsum("bhd,bshd->bhs", q[:, 0].float(), k) / D ** 0.5
    valid = (cache_pos >= 0) & (cache_pos <= pos) & (pos - cache_pos < window)
    s = s.masked_fill(~valid[None, None], float("-inf"))
    return torch.einsum("bhs,bshd->bhd", torch.softmax(s, -1), v)[:, None]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("S_c,pos,window,D", [
    (600, 300, BIG_WINDOW, 64),     # not wrapped, full attention
    (1400, 1299, 1024, 64),         # not wrapped, hymba's window bites
    (600, 577, 512, 256),           # gemma3's local layer (D 256: FMA)
    (32, 100, 32, 128),             # wrapped: S_c = window
    (512, 2047, 512, 64),
])
def test_paged_kernel_on_a_ring(gen, dtype, S_c, pos, window, D):
    """A over a ring cache read as one page per row (``layers.
    decode_attention``): the pool is the (B, S_c, K, D) cache, row b's
    block table [b], lens min(pos + 1, S_c); against the plain version
    and against the reference's mask on the slots' positions, before
    and after the ring wraps."""
    B, H, K = 3, 8, 2
    q = torch.randn((B, 1, H, D), generator=gen, device="cuda").to(dtype)
    ck = torch.randn((B, S_c, K, D), generator=gen, device="cuda").to(dtype)
    cv = torch.randn((B, S_c, K, D), generator=gen, device="cuda").to(dtype)
    first = max(0, pos + 1 - S_c)         # the oldest position kept
    cache_pos = torch.full((S_c,), -1, dtype=torch.long, device="cuda")
    kept = torch.arange(first, pos + 1, device="cuda")
    cache_pos[kept % S_c] = kept
    tables = torch.arange(B, dtype=torch.int32, device="cuda")[:, None]
    lens = torch.full((B,), min(pos + 1, S_c), dtype=torch.int32,
                      device="cuda")
    got = paged_attention_cuda(q, ck, cv, tables, lens, window)
    want = paged_attention_plain(q, ck, cv, tables, lens, window)
    ref = _ring_attention_ref(q, ck, cv, cache_pos, pos, window)
    torch.cuda.synchronize()
    torch.testing.assert_close(got.float(), want.float(), **TOL[dtype])
    torch.testing.assert_close(got.float(), ref.reshape(got.shape),
                               **TOL[dtype])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("S_c,lens,window,D", [
    (288, [288] * 8, BIG_WINDOW, 64),          # the SLM's full ring
    (1536, [1536] * 4, 0, 64),                 # whisper's cross cache
    (600, [600, 0, 17, 599], 512, 256),        # D 256 (FMA), an idle row
])
def test_paged_kernel_ring_form_is_the_table_form(gen, dtype, S_c, lens,
                                                  window, D):
    """``block_tables`` None launches A on the cached ring table: the
    bits of the arange table's launch, one launch each, and no
    allocation on the second call."""
    B, K = len(lens), 2
    q = torch.randn((B, 1, 4 * K, D), generator=gen, device="cuda").to(dtype)
    ck, cv = (torch.randn((B, S_c, K, D), generator=gen,
                          device="cuda").to(dtype) for _ in range(2))
    tables = torch.arange(B, dtype=torch.int32, device="cuda")[:, None]
    lens = torch.tensor(lens, dtype=torch.int32, device="cuda")
    n = paged_attention_cuda.launches
    ring = paged_attention_cuda(q, ck, cv, None, lens, window)
    table = paged_attention_cuda(q, ck, cv, tables, lens, window)
    torch.cuda.synchronize()
    assert paged_attention_cuda.launches == n + 2
    assert torch.equal(ring, table)
    before = torch.cuda.memory_allocated()
    again = paged_attention_cuda(q, ck, cv, None, lens, window)
    assert torch.cuda.memory_allocated() - before == again.nbytes
    torch.testing.assert_close(
        ring.float(), paged_attention_plain(q, ck, cv, None, lens,
                                            window).float(), **TOL[dtype])


@pytest.mark.parametrize("H,window", [(8, BIG_WINDOW), (4, 512)])
def test_paged_kernel_head_dim_256_takes_the_fma_walk(gen, H, window):
    """gemma-2b's (8 heads over 1 KV head of 256) and gemma3-1b's (4
    over 1, window 512) decode in bf16: the mma walk takes D 64 and 128
    only, so A launches its FMA walk."""
    lens = [0, 1, 300, 513, 600, 17, 1100, 64]
    args = _paged_inputs(gen, H, 1, 256, 16, 70, torch.bfloat16, lens)
    n = dict(paged_attention_cuda.launches_by_route)
    _paged_check(args, window, torch.bfloat16)
    assert paged_attention_cuda.launches_by_route["fma"] == n["fma"] + 1
    assert paged_attention_cuda.launches_by_route["mma"] == n["mma"]


@pytest.mark.parametrize("family", ["dense_swa", "hybrid", "vlm"])
def test_generate_on_the_card_matches_the_cpu(gen, family):
    """``generate`` at a toy size in float32 (TF32 off) gives the same
    greedy tokens on the card, through kernels A, B and G, as on the CPU
    through their plain versions; the window-8 ring wraps."""
    from repro_torch.configs.base import ModelConfig
    from repro_torch.core.lora import flatten, unflatten
    from repro_torch.launch.serve import generate
    from repro_torch.models.model import build_model
    kw = {"dense_swa": dict(sliding_window=8),
          "hybrid": dict(family="hybrid", ssm_state=16, ssm_head_dim=16,
                         ssm_chunk=16, sliding_window=8, global_every=2),
          "vlm": dict(family="vlm", frontend="vision", frontend_tokens=8,
                      frontend_dim=24)}[family]
    cfg = ModelConfig(name="t", n_layers=2, d_model=64, n_heads=4,
                      n_kv_heads=2, head_dim=32, d_ff=128, vocab_size=128,
                      lora_rank=4, remat=False, dtype="float32", **kw)
    bundle = build_model(cfg)
    params = bundle.init(torch.Generator().manual_seed(0))
    for k, v in flatten(params).items():
        if k.endswith("_lora_b"):
            v.copy_(torch.randn(v.shape, generator=torch.Generator()
                                .manual_seed(1)) * 0.05)
    on_card = unflatten({k: v.cuda() for k, v in flatten(params).items()})
    toks = torch.randint(0, 128, (2, 12), generator=torch.Generator()
                         .manual_seed(2))
    extra = {}
    if cfg.frontend:
        extra["frontend_embeds"] = torch.randn(
            2, 8, 24, generator=torch.Generator().manual_seed(3))
    want = generate(bundle, params, toks, max_new=10, batch_extra=extra)
    n = {k: f.launches for k, f in (("A", paged_attention_cuda),
                                    ("B", flash_attention_cuda),
                                    ("G", ssd_chunk_cuda))}
    got = generate(bundle, on_card, toks.cuda(), max_new=10,
                   batch_extra={k: v.cuda() for k, v in extra.items()})
    assert got.is_cuda and got.cpu().tolist() == want.tolist()
    assert paged_attention_cuda.launches - n["A"] == 2 * 9
    assert flash_attention_cuda.launches - n["B"] == 2
    assert ssd_chunk_cuda.launches - n["G"] == 2 * (family == "hybrid")


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
    (8, 16, 8, 136, 136, 128, 0),      # qwen3 in the round: G = 2, D 128
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


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("Sq", [1, 64, 128])
def test_flash_kernel_without_a_mask_at_whisper_shapes(gen, dtype, Sq):
    """B with ``causal=False`` at Sq != Sk (whisper-medium's cross- and
    encoder attention: 16 heads of 64 over 1,536 frames) against the plain
    version; one launch."""
    q = torch.randn((2, Sq, 16, 64), generator=gen, device="cuda").to(dtype)
    k, v = (torch.randn((2, 1536, 16, 64), generator=gen,
                        device="cuda").to(dtype) for _ in range(2))
    n = flash_attention_cuda.launches
    got = ops.attention(q, k, v, causal=False)
    assert flash_attention_cuda.launches == n + 1
    want = flash_attention_plain(q, k, v, False, 0).reshape(got.shape)
    torch.cuda.synchronize()
    torch.testing.assert_close(got.float(), want.float(), **TOL[dtype])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_paged_kernel_over_a_cross_cache(gen, dtype):
    """``layers.cross_attention_decode``'s call of A: a (B, 1536, K, D)
    cross cache read as one page a row, every row all 1,536 keys, no
    window, against the plain version and against B at Sq = 1."""
    B, T, H, D = 4, 1536, 16, 64
    q = torch.randn((B, 1, H, D), generator=gen, device="cuda").to(dtype)
    k, v = (torch.randn((B, T, H, D), generator=gen, device="cuda").to(dtype)
            for _ in range(2))
    tables = torch.arange(B, dtype=torch.int32, device="cuda")[:, None]
    lens = torch.full((B,), T, dtype=torch.int32, device="cuda")
    got = paged_attention_cuda(q, k, v, tables, lens, 0)
    want = paged_attention_plain(q, k, v, tables, lens, 0)
    by_b = flash_attention_cuda(q, k, v, causal=False)
    torch.cuda.synchronize()
    torch.testing.assert_close(got.float(), want.float(), **TOL[dtype])
    torch.testing.assert_close(by_b.float(), want.float(), **TOL[dtype])


def test_moe_mlp_on_the_card_matches_the_cpu(gen):
    """``moe.moe_mlp`` (routing, capacity slots, the scatter and gather,
    the expert products) on the card against the same call on the CPU, at
    float32 with TF32 off and a capacity that drops assignments."""
    from repro_torch.configs.base import ModelConfig
    from repro_torch.models import moe
    cfg = ModelConfig(family="moe", d_model=64, n_experts=8, top_k=2,
                      d_ff_expert=96, capacity_factor=0.5, dtype="float32")
    p = moe.init_moe(gen, cfg)
    x = torch.randn((3, 40, 64), generator=gen, device="cuda")
    _, _, idx = moe.route(p, cfg, x.reshape(120, 64))
    assert int((moe.slots(idx, 8) >= moe.capacity(cfg, 120)).sum()) > 0
    y, aux = moe.moe_mlp(p, cfg, x)
    cpu = {k: v.cpu() for k, v in p.items()}
    y_cpu, aux_cpu = moe.moe_mlp(cpu, cfg, x.cpu())
    torch.testing.assert_close(y.cpu(), y_cpu, atol=1e-4, rtol=1e-4)
    torch.testing.assert_close(aux.cpu(), aux_cpu, atol=1e-6, rtol=1e-6)


def test_moe_mlp_per_client_on_the_card_matches_the_cpu(gen):
    """``moe.moe_mlp(clients=3)`` (each client routes its own rows with
    its own capacity, slots and aux; one set of expert products for all)
    on the card against the same call on the CPU, f32, TF32 off, at a
    capacity that drops assignments."""
    from repro_torch.configs.base import ModelConfig
    from repro_torch.models import moe
    cfg = ModelConfig(family="moe", d_model=64, n_experts=8, top_k=2,
                      d_ff_expert=96, capacity_factor=0.5, dtype="float32")
    p = moe.init_moe(gen, cfg)
    x = torch.randn((6, 40, 64), generator=gen, device="cuda")
    _, _, idx = moe.route(p, cfg, x.reshape(3, 80, 64)[0])
    assert int((moe.slots(idx, 8) >= moe.capacity(cfg, 80)).sum()) > 0
    y, aux = moe.moe_mlp(p, cfg, x, clients=3)
    assert aux.shape == (3,)
    cpu = {k: v.cpu() for k, v in p.items()}
    y_cpu, aux_cpu = moe.moe_mlp(cpu, cfg, x.cpu(), clients=3)
    torch.testing.assert_close(y.cpu(), y_cpu, atol=1e-4, rtol=1e-4)
    torch.testing.assert_close(aux.cpu(), aux_cpu, atol=1e-6, rtol=1e-6)


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


@pytest.mark.parametrize("M,K,N", [(67, 96, 80), (2048, 1280, 1280)])
def test_lora_kernel_dw_matches_plain_autograd(gen, M, K, N):
    """A full fine-tune's C: W asks for a gradient too.  bf16 through
    ``ops.lora_matmul`` (forward and dx on the kernel, dW = x^T dy as one
    bf16 ``torch.matmul``) against the plain version's autograd (f32
    products rounded once): every gradient, dW row by row."""
    x, w, a, b = _lora_inputs(gen, M, K, N, 8, torch.bfloat16)
    dy = torch.randn((M, N), generator=gen, device="cuda").to(torch.bfloat16)
    grads = []
    for fn in (ops.lora_matmul, lora_matmul_plain):
        ins = [t.clone().requires_grad_(True) for t in (x, w, a, b)]
        n = lora_matmul_cuda.launches
        fn(*ins, 2.0).backward(dy)
        if fn is ops.lora_matmul:
            assert lora_matmul_cuda.launches == n + 2     # forward and dx
        grads.append([t.grad.float() for t in ins])
    torch.cuda.synchronize()
    for got, want in zip(*grads):
        torch.testing.assert_close(*_row_scaled(got, want), atol=2e-2,
                                   rtol=1e-2)


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
    (1088, 2048, 2048, 8, False),    # qwen3's wq / wo
    (1088, 2048, 1024, 8, False),    # qwen3's wk / wv: N = 1024 (ragged
                                     # on 96-wide tiles)
    (1088, 2048, 2048, 8, True),     # qwen3's dx of wq / wo
    (1088, 1024, 2048, 8, True),     # qwen3's dx of wk / wv
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


@pytest.mark.parametrize("M,K,N", [(1088, 1280, 1280), (300, 4096, 520),
                                   (1088, 2048, 1024)])
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


def _grouped_inputs(gen, G, Mg, K, N, r, dtype, trans_w=False):
    """Grouped C's inputs: G clients' rows, one W, per-client non-zero
    adapters (B differs per client, so a wrong adapter index shows)."""
    x = torch.randn((G * Mg, K), generator=gen, device="cuda").to(dtype)
    wshape = (N, K) if trans_w else (K, N)
    w = (torch.randn(wshape, generator=gen, device="cuda") / K ** 0.5
         ).to(dtype)
    a = (torch.randn((G, K, r), generator=gen, device="cuda") / K ** 0.5
         ).to(dtype)
    b = (0.1 * torch.randn((G, r, N), generator=gen, device="cuda")
         ).to(dtype)
    return x, w, a, b


@pytest.mark.parametrize("G,Mg,K,N,r,trans_w,dtype", [
    (3, 1088, 1280, 1280, 8, False, torch.bfloat16),  # the SLM's round
    (3, 1088, 1280, 1280, 8, True, torch.bfloat16),   # its dx
    (2, 1088, 2048, 1024, 8, False, torch.bfloat16),  # qwen3's wk / wv
    (2, 1088, 1024, 2048, 8, True, torch.bfloat16),   # their dx
    (3, 136, 1280, 1280, 8, False, torch.bfloat16),   # Mg on no tile
    (4, 77, 200, 72, 16, True, torch.bfloat16),       # ragged everywhere
    (3, 136, 48, 40, 4, False, torch.float32),        # the toy configs
    (3, 70, 64, 64, 8, True, torch.float32),
])
def test_lora_grouped_matches_plain_and_ungrouped(gen, G, Mg, K, N, r,
                                                  trans_w, dtype):
    """One grouped launch against the plain grouped version and against G
    ungrouped launches (bit-equal where the grouped launch takes the
    ungrouped tile), on the route the route function names; one launch
    counted."""
    x, w, a, b = _grouped_inputs(gen, G, Mg, K, N, r, dtype, trans_w)
    route = lora_matmul_grouped_route(x, w, a, b, trans_w)
    assert route == ("wgmma" if dtype == torch.bfloat16 else "fma")
    with _routed(lora_matmul_grouped_cuda, route):
        got = lora_matmul_grouped_cuda(x, w, a, b, 2.0, trans_w=trans_w)
    want = lora_matmul_grouped_plain(x, w.t() if trans_w else w, a, b, 2.0)
    solo = torch.cat([lora_matmul_cuda(x[g * Mg:(g + 1) * Mg], w, a[g],
                                       b[g], 2.0, trans_w=trans_w)
                      for g in range(G)])
    torch.cuda.synchronize()
    torch.testing.assert_close(got.float(), want.float(), **TOL[dtype])
    same_tile = route == "fma" or ((G * -(-Mg // 192) * -(-N // 192) >= 99)
                                   == (-(-Mg // 192) * -(-N // 192) >= 99))
    if same_tile:
        assert torch.equal(got, solo)
    else:
        torch.testing.assert_close(got.float(), solo.float(), **TOL[dtype])


def test_lora_grouped_autograd_on_wgmma(gen):
    """Forward and dx of the grouped form through autograd, both on the
    wgmma route (two launches), against the plain grouped version's
    autograd; each row held relative to its own size."""
    dt = torch.bfloat16
    x, w, a, b = _grouped_inputs(gen, 3, 1088, 1280, 1280, 8, dt)
    dy = torch.randn(x.shape[0], 1280, generator=gen, device="cuda").to(dt)
    grads = []
    for fn in (ops.lora_matmul_grouped, lora_matmul_grouped_plain):
        ins = [t.clone().requires_grad_(True) for t in (x, a, b)]
        if fn is ops.lora_matmul_grouped:
            with _routed(lora_matmul_grouped_cuda, "wgmma", n=2):
                fn(ins[0], w, ins[1], ins[2], 2.0).backward(dy)
        else:
            fn(ins[0], w, ins[1], ins[2], 2.0).backward(dy)
        grads.append([t.grad.float() for t in ins])
    torch.cuda.synchronize()
    for got, want in zip(*grads):
        flat, ref = got.reshape(-1, got.shape[-1]), want.reshape(
            -1, want.shape[-1])
        scale = ref.abs().amax(dim=1, keepdim=True).clamp(min=1e-30)
        torch.testing.assert_close(flat / scale, ref / scale,
                                   **TOL[torch.bfloat16])


def test_lora_wgmma_launches_from_a_fresh_thread(gen):
    """A thread whose first CUDA work is a wgmma launch (its tensor maps
    are encoded by cuTensorMapEncodeTiled, which needs a context current
    on the thread), as the autograd engine's thread is when dx is the
    first node of its backward: the launch succeeds and matches the main
    thread's."""
    import threading
    x, w, a, b = _grouped_inputs(gen, 3, 136, 256, 128, 8, torch.bfloat16,
                                 trans_w=True)
    want = lora_matmul_grouped_cuda(x, w, a, b, 2.0, trans_w=True)
    torch.cuda.synchronize()
    got, errors = [], []

    def run():
        try:
            got.append(lora_matmul_grouped_cuda(x, w, a, b, 2.0,
                                                trans_w=True))
            torch.cuda.synchronize()
        except Exception as e:      # noqa: BLE001 — re-raised below
            errors.append(e)
    t = threading.Thread(target=run)
    t.start()
    t.join()
    assert not errors, errors
    assert torch.equal(got[0], want)


def test_lora_grouped_uses_each_clients_adapter(gen):
    """Planted fault: every client on client 0's adapter differs from the
    kernel's output by far more than the tolerance."""
    x, w, a, b = _grouped_inputs(gen, 3, 136, 1280, 1280, 8, torch.bfloat16)
    got = lora_matmul_grouped_cuda(x, w, a, b, 2.0)
    wrong = lora_matmul_grouped_plain(x, w, a[:1].expand_as(a),
                                      b[:1].expand_as(b), 2.0)
    torch.cuda.synchronize()
    assert float((got.float() - wrong.float()).abs().max()) > 0.1


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
    (8, 16, 8, 136, 136, 128, 0),      # qwen3 in the round: G = 2, D 128
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


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,H,K,Sq,Sk,D,causal", [
    (2, 16, 16, 128, 1536, 64, False),   # whisper's cross-attention
    (2, 16, 16, 1536, 1536, 64, False),  # whisper's encoder
    (2, 8, 1, 1032, 1032, 256, True),    # gemma-2b: 8 / 1 heads of 256
])
def test_flash_backward_at_the_trainers_shapes(gen, dtype, B, H, K, Sq, Sk,
                                                D, causal):
    """The backward kernels where the trainer first runs them: without a
    mask at Sq != Sk and Sq = Sk (whisper-medium) and at gemma-2b's GQA 8
    over head_dim 256, against the explicit formulas on the kernel's own
    output and log-sum-exp, row-scaled; one launch (bf16 on the mma
    route)."""
    q = torch.randn((B, Sq, H, D), generator=gen, device="cuda").to(dtype)
    k, v = (torch.randn((B, Sk, K, D), generator=gen, device="cuda").to(dtype)
            for _ in range(2))
    do = torch.randn((B, Sq, H, D), generator=gen, device="cuda").to(dtype)
    o, lse = flash_attention_cuda(q, k, v, causal, 0, with_lse=True)
    _, want_lse = flash_attention_plain(q, k, v, causal, 0, with_lse=True)
    assert flash_attention_backward_route(q, k, v) == (
        "mma" if dtype == torch.bfloat16 else "fma")
    n = flash_attention_backward_cuda.launches
    got = flash_attention_backward_cuda(q, k, v, o, do, lse, causal, 0)
    assert flash_attention_backward_cuda.launches == n + 1
    want = flash_attention_backward_plain(q, k, v, o, do, lse, causal, 0)
    torch.cuda.synchronize()
    torch.testing.assert_close(lse, want_lse, atol=1e-4, rtol=1e-5)
    for g, w in zip(got, want):
        assert g.dtype == dtype
        torch.testing.assert_close(*_row_scaled(g, w), **TOL[dtype])


@pytest.mark.parametrize("B,H,K,S,D,window", [
    (2, 20, 20, 136, 64, 0),           # the SLM in the round
    (2, 8, 2, 131, 128, 45),           # GQA, a window, ragged S
    (8, 16, 8, 136, 128, 0),           # qwen3 in the round
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


# ---------------------------------------------------------------------------
# kernel G′: the SSD chunk scan's backward

def _ssd_cotangents(gen, x, L, N, states=True):
    B, S, H, P = x.shape
    dy = torch.randn((B, S, H, P), generator=gen, device="cuda")
    ds = torch.randn((B, S // L, H, P, N), generator=gen,
                     device="cuda") * 0.5 if states else None
    return dy, ds


def _assert_grad_rows(got, want, name, tol=SSD_TOL):
    """Each row (the last axis) of a gradient against the larger of its own
    largest |value| and a tenth of the tensor's, at ``tol``: a kernel that
    writes zeros fails."""
    w = want.float().reshape(-1, want.shape[-1])
    scale = torch.maximum(w.abs().amax(dim=1, keepdim=True),
                          0.1 * w.abs().max()).clamp(min=1e-30)
    assert torch.isfinite(got).all(), name
    torch.testing.assert_close(got.float().reshape(w.shape) / scale,
                               w / scale, msg=name, **tol)


BWD_NAMES = ("dx", "ddt", "dcum", "dB", "dC")


def _bwd_on(route, args, chunk):
    """G′ on ``route`` (one launch, on that route), or, where the route
    function refuses the mma route, None after checking that asking for
    it raises before any launch."""
    if route == "mma" and ssd_chunk_bwd_route(*args, chunk) != "mma":
        with _routed(ssd_chunk_bwd_cuda, route, n=0), \
                pytest.raises(ValueError, match="route 'mma'"):
            ssd_chunk_bwd_cuda(*args, chunk, route=route)
        return None
    n = ssd_chunk_bwd_cuda.launches
    with _routed(ssd_chunk_bwd_cuda, route):
        got = ssd_chunk_bwd_cuda(*args, chunk, route=route)
    assert ssd_chunk_bwd_cuda.launches == n + 1
    return got


@pytest.mark.parametrize("route", ["mma", "fma"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,S,H,P,G,N,L", [
    (2, 256, 16, 64, 1, 128, 256),     # mamba2's head shape, one chunk
    (1, 768, 8, 64, 1, 128, 256),      # three chunks, the state branch
    (1, 256, 10, 64, 1, 16, 256),      # hymba's N 16, a ragged slice
    (2, 96, 8, 32, 2, 32, 32),         # G = 2
    (1, 40, 3, 24, 1, 20, 40),         # ragged L, P and N
    (2, 256, 8, 64, 2, 64, 128),       # G = 2 at chunk 128 (mma)
    (1, 192, 3, 128, 1, 32, 64),       # P 128, 3 heads, chunk 64 (mma)
    (1, 128, 5, 48, 1, 16, 64),        # P 48, a slice of 1 head (mma)
])
def test_ssd_bwd_kernel_matches_plain(gen, route, dtype, B, S, H, P, G, N,
                                      L):
    x, dt, A, Bm, Cm = _ssd_inputs(gen, B, S, H, P, G, N, dtype)
    cum = _chunk_cum(dt, A, L)
    dy, ds = _ssd_cotangents(gen, x, L, N)
    args = (x, dt, cum, Bm, Cm, dy, ds)
    got = _bwd_on(route, args, L)
    if got is None:
        return
    want = ssd_chunk_bwd_plain(*args, L)
    torch.cuda.synchronize()
    for name, g, w in zip(BWD_NAMES, got, want):
        assert g.dtype == torch.float32 and g.shape == w.shape, name
        _assert_grad_rows(g, w, name)


@pytest.mark.parametrize("route", ["mma", "fma"])
def test_ssd_bwd_kernel_without_state_gradient_and_strong_decay(gen, route):
    """dstates absent (the one-chunk training round), and |A| dt up to 16 x
    6 a row: exp of the unmasked argument would be inf; every output is
    finite and matches the plain version."""
    x, dt, A, Bm, Cm = _ssd_inputs(gen, 1, 512, 8, 64, 1, 128,
                                   torch.bfloat16, dt_shift=5.0)
    cum = _chunk_cum(dt, A, 256)
    dy, _ = _ssd_cotangents(gen, x, 256, 128, states=False)
    with _routed(ssd_chunk_bwd_cuda, route):
        got = ssd_chunk_bwd_cuda(x, dt, cum, Bm, Cm, dy, None, 256,
                                 route=route)
    want = ssd_chunk_bwd_plain(x, dt, cum, Bm, Cm, dy, None, 256)
    torch.cuda.synchronize()
    for name, g, w in zip(BWD_NAMES, got, want):
        _assert_grad_rows(g, w, name)


@pytest.mark.parametrize("route", ["mma", "fma"])
def test_ssd_bwd_kernel_is_deterministic(gen, route):
    """No float atomics: two launches on the same inputs give the same
    bits (dB and dC sum all 80 heads of mamba2's one group)."""
    x, dt, A, Bm, Cm = _ssd_inputs(gen, 2, 512, 80, 64, 1, 128,
                                   torch.bfloat16)
    cum = _chunk_cum(dt, A, 256)
    dy, ds = _ssd_cotangents(gen, x, 256, 128)
    with _routed(ssd_chunk_bwd_cuda, route, n=2):
        a = ssd_chunk_bwd_cuda(x, dt, cum, Bm, Cm, dy, ds, 256, route=route)
        b = ssd_chunk_bwd_cuda(x, dt, cum, Bm, Cm, dy, ds, 256, route=route)
    torch.cuda.synchronize()
    for name, u, v in zip(BWD_NAMES, a, b):
        assert torch.equal(u, v), name


@pytest.mark.parametrize("route", ["mma", "fma"])
def test_ssd_bwd_launches_from_a_fresh_thread(gen, route):
    """G′ runs on the autograd engine's thread: a thread whose first CUDA
    work is its launch succeeds and matches the main thread's bits."""
    import threading
    x, dt, A, Bm, Cm = _ssd_inputs(gen, 1, 256, 16, 64, 1, 128,
                                   torch.bfloat16)
    cum = _chunk_cum(dt, A, 256)
    dy, ds = _ssd_cotangents(gen, x, 256, 128)
    want = ssd_chunk_bwd_cuda(x, dt, cum, Bm, Cm, dy, ds, 256, route=route)
    torch.cuda.synchronize()
    got, errors = [], []

    def run():
        try:
            got.append(ssd_chunk_bwd_cuda(x, dt, cum, Bm, Cm, dy, ds, 256,
                                          route=route))
            torch.cuda.synchronize()
        except Exception as e:      # noqa: BLE001 — re-raised below
            errors.append(e)
    with _routed(ssd_chunk_bwd_cuda, route):
        t = threading.Thread(target=run)
        t.start()
        t.join()
    assert not errors, errors
    for u, v in zip(got[0], want):
        assert torch.equal(u, v)


# ops.ssd_chunked's backward on each route of G′: f32 inputs take the FMA
# route, bf16 ones the mma route.  bf16 leaves get bf16 gradients, which
# both paths round from f32 values that agree to ~1e-5: TOL[bf16] for x, B
# and C; dt and A stay f32.
SSD_CHUNKED_DTYPE = {"fma": torch.float32, "mma": torch.bfloat16}


@pytest.mark.parametrize("route", ["mma", "fma"])
def test_ssd_chunked_backward_is_one_bwd_launch(gen, route):
    """ops.ssd_chunked at a ragged S over three chunks, differentiated in
    x, dt, A, B and C through G and G′ (one launch each, G′ on ``route``),
    against the plain path's autograd on the same inputs."""
    dtype = SSD_CHUNKED_DTYPE[route]
    x, dt, A, Bm, Cm = _ssd_inputs(gen, 2, 700, 16, 64, 1, 128, dtype)
    A = A / 8.0
    wy = torch.randn(x.shape, generator=gen, device="cuda")
    grads = []
    for kernel in (True, False):
        ins = [t.clone().requires_grad_(True) for t in (x, dt, A, Bm, Cm)]
        n = (ssd_chunk_cuda.launches, ssd_chunk_bwd_cuda.launches)
        with _routed(ssd_chunk_bwd_cuda, route, n=int(kernel)):
            if kernel:
                y = ops.ssd_chunked(*ins, 256)
            else:
                with _plain_ssd():
                    y = ops.ssd_chunked(*ins, 256)
            (y.float() * wy).sum().backward()
        assert (ssd_chunk_cuda.launches - n[0],
                ssd_chunk_bwd_cuda.launches - n[1]) == (int(kernel),) * 2
        grads.append([t.grad for t in ins])
    torch.cuda.synchronize()
    for name, g, w in zip(("x", "dt", "A", "B", "C"), *grads):
        _assert_grad_rows(g, w, name, TOL[g.dtype])


@contextlib.contextmanager
def _plain_ssd():
    """ops.ssd_chunked on the plain version (its autograd) for a CUDA
    tensor."""
    saved = ops.ssd_chunk_autograd
    ops.ssd_chunk_autograd = ssd_chunk_plain
    try:
        yield
    finally:
        ops.ssd_chunk_autograd = saved


def test_ssd_bwd_kernel_rejects_what_it_does_not_take(gen):
    x, dt, A, Bm, Cm = _ssd_inputs(gen, 1, 64, 4, 16, 1, 8, torch.float32)
    cum = _chunk_cum(dt, A, 32)
    dy, ds = _ssd_cotangents(gen, x, 32, 8)
    n = ssd_chunk_bwd_cuda.launches
    with pytest.raises(ValueError, match="multiple"):
        ssd_chunk_bwd_cuda(x, dt, cum, Bm, Cm, dy, None, 48)
    with pytest.raises(TypeError):
        ssd_chunk_bwd_cuda(x.half(), dt, cum, Bm.half(), Cm.half(), dy, ds,
                           32)
    with pytest.raises(TypeError, match="float32"):
        ssd_chunk_bwd_cuda(x, dt, cum, Bm, Cm, dy.bfloat16(), ds, 32)
    with pytest.raises(ValueError, match="dstates"):
        ssd_chunk_bwd_cuda(x, dt, cum, Bm, Cm, dy, ds[:, :1], 32)
    with pytest.raises(ValueError, match="head dim"):
        big = torch.zeros((1, 64, 4, 136), device="cuda")
        ssd_chunk_bwd_cuda(big, dt, cum, Bm, Cm, big, None, 32)
    with pytest.raises(ValueError, match="state N"):
        wide = torch.zeros((1, 64, 1, 136), device="cuda")
        ssd_chunk_bwd_cuda(x, dt, cum, wide, wide, dy, None, 32)
    with pytest.raises(ValueError, match="contiguous"):
        ssd_chunk_bwd_cuda(x, dt, cum, Bm, Cm, dy.transpose(2, 3)
                           .contiguous().transpose(2, 3), None, 32)
    assert ssd_chunk_bwd_cuda.launches == n


def test_nccl_world1_round_with_a_mesh_is_bit_equal(gen, monkeypatch,
                                                    tmp_path):
    """Two evaluated vectorized rounds of tests/_torch_dist_workers.py's toy
    federation (4 clients; heads of 32, which kernel B takes) on the card,
    without a mesh and on ``make_federated_mesh()`` over an NCCL group of
    world size 1: every summary and LoRA leaf bit-equal, and the mesh's
    round gathered its uploads and eval sums."""
    import dataclasses

    import torch.distributed as dist

    import _torch_dist_workers as W
    from repro_torch.core.federated import FederatedConfig, FederatedRunner
    from repro_torch.launch.mesh import make_federated_mesh
    from repro_torch.models.model import build_model

    def rounds(mesh=None):
        slm, llm = (build_model(dataclasses.replace(c, head_dim=32))
                    for c in (W.SLM, W.LLM))
        cfg = FederatedConfig(n_devices=4, engine="vectorized", **W.ROUND)
        return W.run_rounds(FederatedRunner(cfg, slm, llm, W.corpus(),
                                            mesh=mesh, device="cuda"))
    want = rounds()
    monkeypatch.setenv("NCCL_SOCKET_IFNAME", "lo")
    dist.init_process_group("nccl", init_method=f"file://{tmp_path}/store",
                            world_size=1, rank=0)
    try:
        got = rounds(make_federated_mesh())
    finally:
        dist.destroy_process_group()
    assert got["summaries"] == want["summaries"]
    assert got["exchanged_bytes"] > 0 and want["exchanged_bytes"] == 0
    for n, leaves in want["leaves"].items():
        for k, v in leaves.items():
            assert torch.equal(got["leaves"][n][k], v), f"{n}:{k}"


def test_two_gloo_ranks_on_the_card_match_world1(gen, tmp_path):
    """tests/_torch_dist_workers.py's sampled federation (8 registered, 4 a
    round; trimmed mean under faults, int8 with error feedback; heads of
    32) for 3 rounds on two spawned gloo ranks that share the card (2 + 2
    a round), against the same rounds at world size 1 on the card.  The
    ranks agree bit for bit (summaries, leaves, stores).  On the card a
    stacked step gives a client other bits in a stack of 2 than of 4
    (``chip_smoke.py``'s ``step_rounding_probe``), and AdamW's first
    steps turn a rounding-sized gradient near 0 into up to lr: so against
    world 1 each CE is held within 2e-2 of world 1's,
    each accuracy within a scored token (or 0.02), each LoRA leaf within
    2 lr an AdamW step (the bound ``chip_smoke.py`` holds the loop and
    vectorized engines to), and the stores' keys and shapes equal (on the
    CPU every one of these is bit-equal)."""
    import _torch_dist_workers as W
    runner = W.sampled_runner(device="cuda")
    cfg = runner.cfg
    scored = min(float(t["loss_mask"][:, 1:].sum()) for t in runner.priv_test)
    want = W.on_host(W.run_rounds(runner))
    res = W.spawn(2, tmp_path, ["sampled_cuda"], timeout=600.0)
    steps = cfg.rounds * (cfg.local_steps_ccl + cfg.local_steps_amt
                          + cfg.server_steps)
    for rank, got in enumerate(res["sampled_cuda"]):
        assert got["block"] == (2 * rank, 2 * rank + 2)
        assert len(got["summaries"]) == len(want["summaries"]) == 3
        assert got["summaries"] == res["sampled_cuda"][0]["summaries"]
        for a, b in zip(got["summaries"], want["summaries"]):
            assert set(a) == set(b)
            for k in a:
                lim = 2e-2 * abs(b[k]) if k.endswith("ce") else \
                    max(0.02, 1.0 / scored)
                assert abs(a[k] - b[k]) <= lim, (k, a[k], b[k])
        flat_got, flat_want = _flat(got["leaves"]), _flat(want["leaves"])
        assert set(flat_got) == set(flat_want)
        for k, v in flat_want.items():
            bound = 2.0 * cfg.lr * steps + 2.0 ** -8 * v.abs()
            assert bool(((flat_got[k] - v).abs() <= bound).all()), k
            assert torch.equal(
                flat_got[k], _flat(res["sampled_cuda"][0]["leaves"])[k]), k
        assert {k: (v.shape, v.dtype) for k, v in got["store"].items()} == \
            {k: (v.shape, v.dtype) for k, v in want["store"].items()}
        for k, v in res["sampled_cuda"][0]["store"].items():
            assert torch.equal(got["store"][k], v), k


def _flat(tree, prefix=""):
    """{"a/b": leaf} of a nested dict."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = v
    return out
