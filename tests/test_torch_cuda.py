"""The port's CUDA kernels against their plain versions, on the card.

Every test here needs an NVIDIA GPU (marker ``cuda``) and skips without
one.  The file imports neither JAX nor the JAX package, so it also runs on
a machine that has only PyTorch; from the root of a checkout:

    python -m pytest -q --noconftest -p no:cacheprovider -m cuda \
        tests/test_torch_cuda.py
"""
import pytest
import torch

from repro_torch.kernels import ops
from repro_torch.kernels.flash_attention import (flash_attention_cuda,
                                                 flash_attention_plain)
from repro_torch.kernels.paged_attention import (paged_attention_cuda,
                                                 paged_attention_plain)
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
