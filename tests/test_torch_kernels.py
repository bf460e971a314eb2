"""Port parity: the plain PyTorch versions of the two ported kernels
against the JAX package's oracles and its Pallas kernels (interpret mode).

On the CPU the port's ``ops`` wrappers take the plain versions (a CUDA
tensor would launch the hand-written kernel; see test_torch_cuda.py).
Tolerances are tests/test_kernels.py's: 2e-4 at float32, 5e-2 at bf16.
"""
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels.flash_attention import flash_attention as jflash
from repro.kernels.paged_attention import paged_flash_attention as jpaged
from repro_torch.kernels import ops
from repro_torch.kernels import ref
from repro_torch.models.layers import BIG_WINDOW

torch.set_num_threads(1)

F32_TOL = dict(atol=2e-4, rtol=2e-4)
BF16_TOL = dict(atol=5e-2, rtol=5e-2)


def _t(a, dtype=torch.float32):
    return torch.from_numpy(np.asarray(a)).to(dtype)


def _np(t):
    return t.float().numpy()


# ---------------------------------------------------------------------------
# kernel A: paged decode attention

@pytest.mark.parametrize("H,K,D,ps,M,window", [
    (4, 2, 16, 8, 6, 16),     # GQA, window
    (4, 4, 32, 4, 8, 0),      # MHA
    (4, 1, 16, 16, 3, 5),     # MQA, window shorter than a page
])
def test_paged_attention_plain_matches_reference(H, K, D, ps, M, window):
    """Idle slot, lengths ending mid-page, scattered non-monotone pages."""
    B, P = 4, 40
    rng = np.random.RandomState(11)
    q = rng.randn(B, 1, H, D).astype(np.float32)
    kp = rng.randn(P, ps, K, D).astype(np.float32)
    vp = rng.randn(P, ps, K, D).astype(np.float32)
    bt = rng.permutation(np.arange(1, P))[:B * M].reshape(B, M).astype(np.int32)
    lens = np.array([1, ps + 1, M * ps - 1, 0], np.int32)
    w = window or BIG_WINDOW

    got = ops.paged_attention(_t(q), _t(kp), _t(vp), _t(bt, torch.int32),
                              _t(lens, torch.int32), w)
    assert got.shape == (B, 1, H * D)
    want = np.asarray(jref.paged_attention_ref(
        q, kp, vp, bt, lens, window=window or None)).reshape(B, 1, H * D)
    pallas = np.asarray(jpaged(jnp.asarray(q), jnp.asarray(kp),
                               jnp.asarray(vp), jnp.asarray(bt),
                               jnp.asarray(lens), w, interpret=True)
                        ).reshape(B, 1, H * D)
    np.testing.assert_allclose(_np(got), want, **F32_TOL)
    np.testing.assert_allclose(_np(got), pallas, **F32_TOL)
    assert np.all(_np(got)[3] == 0.0)          # idle slot: zeros, not NaN


def test_paged_attention_plain_bf16():
    B, H, K, D, ps, M, P = 3, 4, 2, 16, 4, 5, 20
    rng = np.random.RandomState(5)
    q = rng.randn(B, 1, H, D).astype(np.float32)
    kp = rng.randn(P, ps, K, D).astype(np.float32)
    vp = rng.randn(P, ps, K, D).astype(np.float32)
    bt = rng.randint(1, P, (B, M)).astype(np.int32)
    lens = np.array([7, 0, M * ps], np.int32)
    args = [jnp.asarray(a, jnp.bfloat16) for a in (q, kp, vp)]
    want = jref.paged_attention_ref(*args, bt, lens, window=None)
    got = ops.paged_attention(*(_t(a, torch.bfloat16) for a in (q, kp, vp)),
                              _t(bt, torch.int32), _t(lens, torch.int32),
                              BIG_WINDOW)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(_np(got), np.asarray(want, np.float32)
                               .reshape(B, 1, H * D), **BF16_TOL)


def test_paged_attention_ref_matches_reference_ref():
    """The port's oracle is the reference's oracle (window semantics incl.)."""
    B, H, K, D, ps, M, P = 2, 4, 2, 8, 4, 3, 9
    rng = np.random.RandomState(2)
    q = rng.randn(B, 1, H, D).astype(np.float32)
    kp = rng.randn(P, ps, K, D).astype(np.float32)
    vp = rng.randn(P, ps, K, D).astype(np.float32)
    bt = rng.randint(1, P, (B, M)).astype(np.int32)
    lens = np.array([M * ps, 5], np.int32)
    for window in (None, 3):
        got = ref.paged_attention_ref(_t(q), _t(kp), _t(vp), _t(bt, torch.int32),
                                      _t(lens, torch.int32), window)
        want = jref.paged_attention_ref(q, kp, vp, bt, lens, window=window)
        np.testing.assert_allclose(_np(got), np.asarray(want), **F32_TOL)


@functools.lru_cache(maxsize=None)
def _split_case(ps, window):
    """Inputs with ranks that see no key (len 1, an idle slot, a window
    shorter than a tile), lens ending mid-page and on a tile's end, and
    the JAX oracle's and the Pallas kernel's (interpret mode) outputs."""
    B, H, K, D, M = 6, 6, 2, 16, 6
    P = B * M + 1
    rng = np.random.RandomState(ps + window)
    q = rng.randn(B, 1, H, D).astype(np.float32)
    kp = rng.randn(P, ps, K, D).astype(np.float32)
    vp = rng.randn(P, ps, K, D).astype(np.float32)
    bt = rng.permutation(np.arange(1, P))[:B * M].reshape(B, M).astype(np.int32)
    lens = np.array([1, 0, M * ps - ps // 2, 8, M * ps, ps + 1], np.int32)
    w = window or BIG_WINDOW
    want = np.asarray(jref.paged_attention_ref(q, kp, vp, bt, lens,
                                               window=window or None))
    pallas = np.asarray(jpaged(jnp.asarray(q), jnp.asarray(kp),
                               jnp.asarray(vp), jnp.asarray(bt),
                               jnp.asarray(lens), w, interpret=True))
    return (q, kp, vp, bt, lens, w), want, pallas


@pytest.mark.parametrize("splits", [1, 2, 4, 8])
@pytest.mark.parametrize("ps", [4, 8, 16])
@pytest.mark.parametrize("window", [0, 3])
@pytest.mark.parametrize("tile", [4, 32])
def test_paged_attention_split_partials_merge_to_the_reference(
        splits, ps, window, tile):
    """The kernel's split arithmetic in plain PyTorch: each rank's partial
    softmax state over its share of whole key tiles, merged as the
    cluster merges them, equals the reference and the Pallas kernel."""
    from repro_torch.kernels.paged_attention import (
        paged_attention_merge_plain, paged_attention_partials_plain)
    (q, kp, vp, bt, lens, w), want, pallas = _split_case(ps, window)
    args = [_t(q), _t(kp), _t(vp), _t(bt, torch.int32), _t(lens, torch.int32)]
    m, l, acc = paged_attention_partials_plain(*args, w, splits, tile)
    assert m.shape == (splits, 6, 6) and acc.shape == (splits, 6, 6, 16)
    empty = l == 0                  # ranks that saw no key
    assert torch.all(m[empty] == -1e30) and torch.all(acc[empty] == 0)
    if splits == 8:
        assert int(empty[:, 0, 0].sum()) == 7       # len 1: one rank works
    got = _np(paged_attention_merge_plain(m, l, acc, torch.float32))
    np.testing.assert_allclose(got, want, **F32_TOL)
    np.testing.assert_allclose(got, pallas, **F32_TOL)
    assert np.all(got[1] == 0.0)               # idle slot: zeros, not NaN


# the ring form (block tables None): (B, S_c, K, D, window, lens, dtype)
RING_CASES = {
    "gqa": (3, 24, 2, 16, BIG_WINDOW, [24, 7, 13], torch.float32),
    "window": (3, 40, 2, 16, 9, [40, 30, 10], torch.float32),
    "idle_row": (4, 16, 4, 8, BIG_WINDOW, [16, 0, 5, 1], torch.float32),
    "wrapped": (2, 32, 1, 32, 32, [32, 32], torch.float32),   # S_c = window
    "bf16": (3, 24, 2, 16, 12, [24, 0, 17], torch.bfloat16),
}


def _ring_case(B, S_c, K, D, lens, dtype, H_per_K=3):
    gen = torch.Generator().manual_seed(S_c + B)
    q = torch.randn((B, 1, K * H_per_K, D), generator=gen).to(dtype)
    ck, cv = (torch.randn((B, S_c, K, D), generator=gen).to(dtype)
              for _ in range(2))
    tables = torch.arange(B, dtype=torch.int32)[:, None]
    return q, ck, cv, tables, torch.tensor(lens, dtype=torch.int32)


@pytest.mark.parametrize("case", list(RING_CASES))
def test_paged_attention_ring_form_is_the_table_form(case):
    """``block_tables`` None (the pool is B pages, row b's only page is
    page b, as ``layers.decode_attention`` and ``cross_attention_decode``
    read a ring) gives the bits of the arange table [[0], ..., [B - 1]]
    through ``ops.paged_attention`` and the kernel's split partials, and
    the plain version indexes nothing in that form."""
    from torch.utils._python_dispatch import TorchDispatchMode

    from repro_torch.kernels.paged_attention import (
        paged_attention_partials_plain)
    B, S_c, K, D, window, lens, dtype = RING_CASES[case]
    q, ck, cv, tables, lens = _ring_case(B, S_c, K, D, lens, dtype)

    class Ops(TorchDispatchMode):
        seen = set()

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            self.seen.add(func._overloadpacket.__name__)
            return func(*args, **(kwargs or {}))
    with Ops() as mode:
        ring = ops.paged_attention(q, ck, cv, None, lens, window)
    table = ops.paged_attention(q, ck, cv, tables, lens, window)
    assert not mode.seen & {"index", "gather", "index_select"}, mode.seen
    assert ring.dtype == dtype
    assert torch.equal(ring, table)
    assert torch.all(ring[lens == 0] == 0)
    for splits, tile in ((1, 16), (4, 4)):
        w = window if window < BIG_WINDOW else 0
        got = paged_attention_partials_plain(q, ck, cv, None, lens, w,
                                             splits, tile)
        want = paged_attention_partials_plain(q, ck, cv, tables, lens, w,
                                              splits, tile)
        for a, b in zip(got, want):
            assert torch.equal(a, b)


def test_paged_attention_ring_form_refuses_a_pool_of_other_rows():
    q, ck, cv, _, lens = _ring_case(3, 8, 2, 8, [8, 8, 8], torch.float32)
    with pytest.raises(ValueError, match="one page a row"):
        ops.paged_attention(q, ck[:2], cv[:2], None, lens, 0)


# ---------------------------------------------------------------------------
# kernel B: prefill (flash) attention

@pytest.mark.parametrize("B,H,K,Sq,Sk,D,window", [
    (1, 2, 2, 64, 64, 32, 0),        # causal
    (2, 4, 2, 131, 131, 16, 0),      # S = 131 (ragged tail), GQA
    (1, 4, 1, 40, 131, 16, 16),      # Sq != Sk, MQA, window
    (1, 4, 4, 64, 64, 16, 16),       # window
])
def test_flash_attention_plain_matches_reference(B, H, K, Sq, Sk, D, window):
    rng = np.random.RandomState(7)
    q = rng.randn(B, Sq, H, D).astype(np.float32)
    k = rng.randn(B, Sk, K, D).astype(np.float32)
    v = rng.randn(B, Sk, K, D).astype(np.float32)
    got = _np(ops.attention(_t(q), _t(k), _t(v), causal=True, window=window))
    assert got.shape == (B, Sq, H * D)

    kr = np.repeat(k, H // K, 2).transpose(0, 2, 1, 3)
    vr = np.repeat(v, H // K, 2).transpose(0, 2, 1, 3)
    qt = q.transpose(0, 2, 1, 3)

    def model_layout(o):
        return np.asarray(o).transpose(0, 2, 1, 3).reshape(B, Sq, H * D)

    want = model_layout(jref.attention_ref(qt, kr, vr, causal=True,
                                           window=window or None))
    pallas = model_layout(jflash(jnp.asarray(qt), jnp.asarray(kr),
                                 jnp.asarray(vr), causal=True, window=window,
                                 bq=32, bk=32, interpret=True))
    jax_ops = np.asarray(jops.attention(jnp.asarray(q), jnp.asarray(k),
                                        jnp.asarray(v), causal=True,
                                        window=window, bq=32, bk=32))
    for other in (want, pallas, jax_ops):
        np.testing.assert_allclose(got, other, **F32_TOL)


def test_flash_attention_plain_bf16():
    B, H, K, S, D = 1, 4, 2, 48, 16
    rng = np.random.RandomState(9)
    q, k, v = (rng.randn(B, S, n, D).astype(np.float32) for n in (H, K, K))
    got = ops.attention(*(_t(a, torch.bfloat16) for a in (q, k, v)),
                        causal=True, window=0)
    assert got.dtype == torch.bfloat16
    want = jops.attention(*(jnp.asarray(a, jnp.bfloat16) for a in (q, k, v)),
                          causal=True, window=0, bq=16, bk=16)
    np.testing.assert_allclose(_np(got), np.asarray(want, np.float32),
                               **BF16_TOL)


def test_flash_attention_big_window_is_full_causal():
    """layers.BIG_WINDOW (the per-layer 'no window') equals window=0."""
    rng = np.random.RandomState(3)
    q, k, v = (_t(rng.randn(1, 20, 2, 8)) for _ in range(3))
    a = ops.attention(q, k, v, causal=True, window=0)
    b = ops.attention(q, k, v, causal=True, window=BIG_WINDOW)
    assert torch.equal(a, b)


def test_cpu_tensors_take_the_plain_version():
    """On the CPU the wrappers never reach the CUDA launch (no counts)."""
    from repro_torch.kernels.flash_attention import flash_attention_cuda
    from repro_torch.kernels.paged_attention import paged_attention_cuda
    before = (flash_attention_cuda.launches, paged_attention_cuda.launches)
    q = torch.randn(1, 4, 2, 8)
    ops.attention(q, q, q)
    ops.paged_attention(q[:, :1], torch.randn(3, 2, 2, 8),
                        torch.randn(3, 2, 2, 8),
                        torch.ones((1, 2), dtype=torch.int32),
                        torch.tensor([3], dtype=torch.int32), BIG_WINDOW)
    assert (flash_attention_cuda.launches,
            paged_attention_cuda.launches) == before
