"""Kernel D's block-route arithmetic against the JAX package, on the CPU.

The redesigned Gram log-volume kernel sums the raw dot products over S
shares of d (one block of a cluster each), merges them, computes the
log-volume from the merged dots, and computes the gradient in closed form
from the same dots (dL/dv = C v).  Each step has a plain PyTorch twin in
``repro_torch.kernels.gram_volume``; these tests hold them, for every S
that ``gram_log_volume_splits`` can return, against
``repro.core.gram.log_volume``, the Pallas kernel in interpret mode and
``jax.grad``, on the same seeded numpy inputs.  Tolerances: f32 1e-4 (the
gram tolerance of tests/test_kernels.py), bf16 1e-2 (both sides compute in
f32 from the same bf16 values; the bf16 gradient is rounded once on each
side).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import gram as jgram
from repro.kernels.gram_volume import gram_log_volume as jgram_kernel
from repro_torch.kernels.gram_volume import (
    SPLITS, gram_dots_plain, gram_dots_split_plain,
    gram_log_volume_backward_from_dots_plain, gram_log_volume_from_dots_plain)

TOL = {torch.float32: 1e-4, torch.bfloat16: 1e-2}
JNP = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}


def _inputs(k, d, dtype, seed):
    """(vs (16, k, d) rounded to ``dtype``, mask (16, k)): masked rows are
    all zero; sample 2 keeps only its first row, sample 3 none."""
    rng = np.random.RandomState(seed)
    vs = rng.randn(16, k, d).astype(np.float32)
    mask = rng.rand(16, k) < 0.7
    mask[:, 0] = True
    mask[2, 1:] = False
    mask[3, :] = False
    vs = vs * mask[..., None]
    tv = torch.from_numpy(vs).to(dtype)
    return tv, torch.from_numpy(mask), jnp.asarray(tv.float().numpy(),
                                                   JNP[dtype])


def _np(t):
    return t.detach().float().numpy()


# f32 (the algorithm) at every k on single values (d 45, no multiple of 8
# or 4) and on 16-byte steps (d 48); then bf16
CASES = [(k, 45, torch.float32) for k in (1, 2, 4, 8)] \
    + [(4, 48, torch.float32)] + [(k, 45, torch.bfloat16) for k in (2, 8)]


@pytest.mark.parametrize("k,d,dtype", CASES)
def test_split_dots_forward_and_backward_match_jax(k, d, dtype):
    tv, tmask, jv = _inputs(k, d, dtype, seed=10 * k + d)
    jmask = jnp.asarray(tmask.numpy())
    g = np.random.RandomState(k + d).randn(16).astype(np.float32)
    want = np.asarray(jgram.log_volume(jv, jmask))
    kern = np.asarray(jgram_kernel(jv, jmask, interpret=True))
    jgrad = np.asarray(jax.grad(lambda v: jnp.sum(
        jgram.log_volume(v, jmask) * g))(jv).astype(jnp.float32))
    jdots = np.asarray(jnp.einsum("bkd,bld->bkl", jv.astype(jnp.float32),
                                  jv.astype(jnp.float32)))
    tol = TOL[dtype]
    np.testing.assert_allclose(_np(gram_dots_plain(tv)), jdots, rtol=1e-5,
                               atol=1e-5 * np.abs(jdots).max())
    for splits in SPLITS:
        dots = gram_dots_split_plain(tv, splits)
        np.testing.assert_allclose(_np(dots), jdots, rtol=1e-5,
                                   atol=1e-5 * np.abs(jdots).max())
        y = gram_log_volume_from_dots_plain(dots, tmask)
        np.testing.assert_allclose(_np(y), want, atol=tol, rtol=tol)
        np.testing.assert_allclose(_np(y), kern, atol=tol, rtol=tol)
        dv = gram_log_volume_backward_from_dots_plain(tv, dots, tmask,
                                                      torch.from_numpy(g))
        assert dv.dtype == dtype and dv.shape == tv.shape
        np.testing.assert_allclose(_np(dv), jgrad, atol=tol, rtol=tol)
        assert np.all(_np(dv)[~tmask.numpy()] == 0.0)
    # the all-masked sample: G~ = (1 + eps) I whatever its rows (f32
    # rounds 1 + 1e-5 to within 6e-8)
    np.testing.assert_allclose(_np(y)[3], 0.5 * k * np.log1p(1e-5),
                               atol=1e-7 * k, rtol=0)


def test_split_dots_shares_cover_d_once():
    """The shares the twin sums (16-byte steps, in rank order) cover every
    column exactly once: a one-hot row's dots come out exact."""
    for d in (8, 45, 1280):
        for splits in SPLITS:
            for c in (0, d // 2, d - 1):
                v = torch.zeros((1, 2, d))
                v[0, 0, c] = 1.0
                v[0, 1, c] = 2.0
                dots = gram_dots_split_plain(v, splits)
                assert dots.tolist() == [[[1.0, 2.0], [2.0, 4.0]]]
