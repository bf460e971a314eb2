"""Training the ssm family in the port: G′ (the SSD chunk kernel's
backward) and the gradients of the layers above it, against the JAX
package on the same inputs (numpy, from a seed).

* ``ssd_chunk_bwd_plain`` (the kernel's oracle and the CPU path) against
  ``jax.vjp`` of ``repro.kernels.ref.ssd_chunk_ref``, chunk by chunk and
  head by head (dB and dC summed over each group's heads), at mild decay;
  one case with two groups, one over several chunks, each with a nonzero
  end-state gradient.
* ``_SSDChunk`` (G forward, G′ backward, the card's training path) driven
  on the CPU with both launches replaced by the plain versions: its
  gradients equal the plain forward's autograd.
* ``ops.ssd_chunked``'s gradients in x, dt, A, B and C against
  ``jax.grad`` of ``repro.models.ssm.ssd_reference``: a ragged S over
  three chunks, with and without the final state in the loss, and under
  strong decay (A in [-16, -1]), where every gradient must be finite (the
  port of tests/test_perf_variants.py::test_ssd_grad_finite_with_strong_decay:
  the reference's one-chunk oracle masks the value but not the argument of
  exp, so its own vjp is NaN there and ``ssd_reference`` is the oracle).
* The LoRA gradients of ``ssm_block`` against ``jax.grad`` of the
  reference's block, and ``logits_stacked`` of an ssm model against
  separate ``logits`` calls per client.
* G′'s wrapper refuses bad shapes and dtypes before it reaches the card.

Tolerances, float32 throughout: the plain backward against the vjp 1e-4
absolute (sums of up to L products of O(1) terms, taken in another
order); gradients through the chunked SSD 1e-4 absolute plus 1e-3
relative (tests/test_kernels.py's bound for the chunked scan).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import ccl as jccl
from repro.core import lora as jlora
from repro.kernels import ref as jref
from repro.models import ssm as jssm
from repro_torch.configs.base import ModelConfig
from repro_torch.core import ccl, lora
from repro_torch.core.lora import is_lora_leaf
from repro_torch.kernels import ops
from repro_torch.kernels import ssd_scan
from repro_torch.kernels.ssd_scan import ssd_chunk_bwd_plain, ssd_chunk_plain
from repro_torch.models import ssm
from repro_torch.models.model import build_model
from test_torch_moe import rows_close
from test_torch_serving import port_pair, serving_cfg
from test_torch_ssm import _ssm_layer, chunk_cum, ssd_inputs

torch.set_num_threads(1)

VJP = dict(atol=1e-4, rtol=0.0)
GRAD = dict(atol=1e-4, rtol=1e-3)
NAMES = ("dx", "ddt", "dcum", "dB", "dC")


def _np(x):
    return x.detach().float().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x, np.float32)


def _t(a, grad=False):
    return torch.from_numpy(np.array(a, np.float32)).requires_grad_(grad)


def cotangents(B, S, H, P, N, chunk, seed=9):
    rng = np.random.RandomState(seed)
    dy = rng.randn(B, S, H, P).astype(np.float32)
    ds = (rng.randn(B, S // chunk, H, P, N) * 0.5).astype(np.float32)
    return dy, ds


# ---------------------------------------------------------------------------
# G′'s plain version against the reference's one-chunk oracle

def vjp_per_chunk_and_head(x, dt, cum, B_, C_, dy, ds, chunk):
    """jax.vjp of ref.ssd_chunk_ref for every (batch, chunk, head), in the
    model layout; dB, dC summed over each group's heads."""
    Bsz, S, H, P = x.shape
    G, N = B_.shape[2], B_.shape[3]
    nc, L, rep = S // chunk, chunk, H // G

    def heads(a):        # (B, S, H, ...) -> (B*nc*H, L, ...)
        a = a.reshape(Bsz, nc, L, H, *a.shape[3:])
        return np.moveaxis(a, 3, 2).reshape(Bsz * nc * H, L, *a.shape[4:])

    def grouped(a):      # (B, S, G, N) -> per head (B*nc*H, L, N)
        return heads(np.repeat(a, rep, axis=2))

    args = [jnp.asarray(v) for v in (heads(x), heads(dt), heads(cum),
                                     grouped(B_), grouped(C_))]
    dS = jnp.asarray(ds.reshape(Bsz * nc * H, P, N))

    def one(x, dt, cum, b, c, gy, gs):
        _, pull = jax.vjp(jref.ssd_chunk_ref, x, dt, cum, b, c)
        return pull((gy, gs))
    out = jax.vmap(one)(*args, jnp.asarray(heads(dy)), dS)

    def back(a):         # (B*nc*H, L, ...) -> (B, S, H, ...)
        a = np.asarray(a).reshape(Bsz, nc, H, L, *a.shape[2:])
        return np.moveaxis(a, 2, 3).reshape(Bsz, S, H, *a.shape[4:])

    def group_sum(a):    # per head (B, S, H, N) -> (B, S, G, N)
        return back(a).reshape(Bsz, S, G, rep, N).sum(axis=3)
    gx, gdt, gcum, gb, gc = out
    return back(gx), back(gdt), back(gcum), group_sum(gb), group_sum(gc)


@pytest.mark.parametrize("B,S,H,P,G,N,chunk", [
    (1, 8, 2, 16, 1, 8, 8),
    (2, 24, 4, 8, 2, 4, 8),
    (1, 48, 3, 8, 1, 8, 16),
])
def test_bwd_plain_matches_reference_vjp(B, S, H, P, G, N, chunk):
    """G′'s explicit formulas against the reference's vjp, with a nonzero
    end-state gradient in every chunk (the state branch), two groups in
    one case, three chunks in another."""
    x, dt, A, B_, C_ = ssd_inputs(B, S, H, P, G, N)
    cum = chunk_cum(dt, A, chunk)
    dy, ds = cotangents(B, S, H, P, N, chunk)
    got = ssd_chunk_bwd_plain(*(_t(v) for v in (x, dt, cum, B_, C_, dy, ds)),
                              chunk)
    want = vjp_per_chunk_and_head(x, dt, cum, B_, C_, dy, ds, chunk)
    for name, g, w in zip(NAMES, got, want):
        assert g.dtype == torch.float32 and g.shape == w.shape, name
        np.testing.assert_allclose(_np(g), w, err_msg=name, **VJP)
        assert np.abs(w).max() > 1e-2, name      # no vacuous comparison


def test_bwd_plain_without_state_gradient_drops_the_state_terms():
    """dstates None is the zero state gradient."""
    x, dt, A, B_, C_ = ssd_inputs(2, 16, 2, 8, 1, 4)
    cum = chunk_cum(dt, A, 8)
    dy, ds = cotangents(2, 16, 2, 8, 4, 8)
    ins = [_t(v) for v in (x, dt, cum, B_, C_, dy)]
    none = ssd_chunk_bwd_plain(*ins, None, 8)
    zero = ssd_chunk_bwd_plain(*ins, torch.zeros(ds.shape), 8)
    for name, a, b in zip(NAMES, none, zero):
        torch.testing.assert_close(a, b, atol=1e-6, rtol=0, msg=name)


def test_ssd_autograd_function_with_plain_launches(monkeypatch):
    """_SSDChunk (G forward, G′ backward) on the CPU with both launches
    replaced by the plain versions: its gradients in x, dt, cum, B and C
    equal the plain forward's autograd, for y and the states together;
    a loss on y alone reaches G′ with no state gradient."""
    calls = []

    def bwd_launch(*args):
        calls.append(args[6] is None)
        return ssd_chunk_bwd_plain(*args)
    monkeypatch.setattr(ssd_scan, "ssd_chunk_cuda", ssd_chunk_plain)
    monkeypatch.setattr(ssd_scan, "ssd_chunk_bwd_cuda", bwd_launch)
    x, dt, A, B_, C_ = ssd_inputs(1, 24, 4, 8, 2, 4)
    cum = chunk_cum(dt, A, 8)
    dy, ds = cotangents(1, 24, 4, 8, 4, 8)
    for with_state in (True, False):
        grads = []
        for fn in (ssd_scan.ssd_chunk_autograd, ssd_chunk_plain):
            ins = [_t(v, grad=True) for v in (x, dt, cum, B_, C_)]
            y, st = fn(*ins, 8)
            loss = (y * _t(dy)).sum()
            if with_state:
                loss = loss + (st * _t(ds)).sum()
            loss.backward()
            grads.append([t.grad for t in ins])
        for name, g, w in zip(NAMES, *grads):
            np.testing.assert_allclose(_np(g), _np(w), atol=1e-5,
                                       err_msg=name)
    assert calls == [False, True]


def test_bwd_wrapper_refuses_bad_inputs():
    """Shapes, dtypes and the device are checked before any launch."""
    x, dt, A, B_, C_ = ssd_inputs(1, 16, 2, 8, 1, 4)
    cum = chunk_cum(dt, A, 8)
    dy, ds = cotangents(1, 16, 2, 8, 4, 8)
    ins = [_t(v) for v in (x, dt, cum, B_, C_)]
    with pytest.raises(ValueError, match="dy"):
        ssd_scan.ssd_chunk_bwd_cuda(*ins, _t(dy[:, :8]), None, 8)
    with pytest.raises(ValueError, match="dstates"):
        ssd_scan.ssd_chunk_bwd_cuda(*ins, _t(dy), _t(ds[:, :1]), 8)
    with pytest.raises(TypeError, match="float32"):
        ssd_scan.ssd_chunk_bwd_cuda(*ins, _t(dy).double(), None, 8)
    with pytest.raises(ValueError, match="multiple"):
        ssd_scan.ssd_chunk_bwd_cuda(*ins, _t(dy), None, 6)
    big = np.zeros((1, 16, 1, 136), np.float32)
    with pytest.raises(ValueError, match="state N"):
        ssd_scan.ssd_chunk_bwd_cuda(*ins[:3], _t(big), _t(big), _t(dy),
                                    None, 8)
    with pytest.raises(ValueError, match="CUDA"):
        ssd_scan.ssd_chunk_bwd_cuda(*ins, _t(dy), _t(ds), 8)
    assert ssd_scan.ssd_chunk_bwd_cuda.launches == 0


# ---------------------------------------------------------------------------
# the chunked SSD's gradients against jax.grad of ssd_reference

def chunked_grads(x, dt, A, B_, C_, chunk, return_state, seed=10):
    """(port grads, reference grads) of sum(y * wy) [+ sum(h * wh)] in
    x, dt, A, B_, C_."""
    Bsz, S, H, P = x.shape
    N = B_.shape[3]
    rng = np.random.RandomState(seed)
    wy = rng.randn(Bsz, S, H, P).astype(np.float32)
    wh = rng.randn(Bsz, H, P, N).astype(np.float32)

    def jloss(*args):
        out = jssm.ssd_reference(*args[:2], args[2], *args[3:], chunk,
                                 return_state=return_state)
        if return_state:
            return jnp.sum(out[0] * wy) + jnp.sum(out[1] * wh)
        return jnp.sum(out * wy)
    want = jax.grad(jloss, argnums=(0, 1, 2, 3, 4))(
        *(jnp.asarray(v) for v in (x, dt, A, B_, C_)))
    ins = [_t(v, grad=True) for v in (x, dt, A, B_, C_)]
    out = ops.ssd_chunked(*ins, chunk, return_state=return_state)
    loss = (out[0] * _t(wy)).sum() + (out[1] * _t(wh)).sum() \
        if return_state else (out * _t(wy)).sum()
    loss.backward()
    return [t.grad for t in ins], [np.asarray(w) for w in want]


@pytest.mark.parametrize("return_state", [False, True])
def test_ssd_chunked_grads_match_reference(return_state):
    """A ragged S (20 over three chunks of 8, two groups): the padding,
    the cumsum (dcum into dt and A), the recurrence across chunks and,
    with the final state in the loss, its gradient into every chunk's
    end state."""
    x, dt, A, B_, C_ = ssd_inputs(2, 20, 4, 8, 2, 4, seed=12)
    got, want = chunked_grads(x, dt, A, B_, C_, 8, return_state)
    for name, g, w in zip(("x", "dt", "A", "B", "C"), got, want):
        np.testing.assert_allclose(_np(g), w, err_msg=name, **GRAD)


def test_ssd_chunked_grads_finite_with_strong_decay():
    """A in [-16, -1] and dt shifted up by 5: exp of the unmasked
    argument above the diagonal is inf.  Every gradient is finite and
    matches ssd_reference's (whose double where keeps its own finite)."""
    x, dt, A, B_, C_ = ssd_inputs(1, 24, 4, 8, 1, 4, seed=13)
    dt = dt + 5.0
    A = -np.linspace(1.0, 16.0, 4).astype(np.float32)
    got, want = chunked_grads(x, dt, A, B_, C_, 8, True)
    for name, g, w in zip(("x", "dt", "A", "B", "C"), got, want):
        assert torch.isfinite(g).all(), name
        assert np.isfinite(w).all(), name
        np.testing.assert_allclose(_np(g), w, err_msg=name, **GRAD)


# ---------------------------------------------------------------------------
# the block and the stacked stack

def _ssm_cfg(**kw):
    return serving_cfg(family="ssm", ssm_state=8, ssm_head_dim=16,
                       ssm_chunk=8, lora_targets=("in_proj", "out_proj"),
                       **kw)


def test_ssm_block_lora_grads_match_reference():
    """d loss / d LoRA A, B of in_proj and out_proj through one SSD block
    (S 13 over two chunks), against jax.grad of the reference block."""
    jcfg = _ssm_cfg()
    _, jp, tb, tp = port_pair(jcfg)
    jl, tl = _ssm_layer(jp, tp)
    x = (np.random.RandomState(14).randn(2, 13, jcfg.d_model)
         * 0.5).astype(np.float32)
    keys = sorted(k for k in jl if "_lora_" in k)
    assert len(keys) == 4

    def jloss(lora):
        out = jssm.ssm_block({**jl, **lora}, jcfg, jnp.asarray(x))
        return jnp.sum(out ** 2)
    want = jax.jit(jax.grad(jloss))({k: jl[k] for k in keys})
    leaves = {k: tl[k].detach().clone().requires_grad_(True) for k in keys}
    out = ssm.ssm_block({**tl, **leaves}, tb.cfg, _t(x))
    (out ** 2).sum().backward()
    for k in keys:
        w = np.asarray(want[k])
        assert np.abs(w).max() > 0, k
        np.testing.assert_allclose(_np(leaves[k].grad), w, err_msg=k,
                                   atol=1e-4, rtol=1e-3)


def test_ssm_logits_stacked_match_per_client_logits():
    """Three clients' adapters stacked over one ssm backbone (remat on,
    grad mode on): one ``logits_stacked`` pass equals three ``logits``
    calls, and its LoRA gradients equal each client's."""
    cfg = ModelConfig(**dataclasses.asdict(_ssm_cfg(remat=True)))
    bundle = build_model(cfg)
    gen = torch.Generator().manual_seed(3)
    base = bundle.init(gen)
    G, B, S = 3, 2, 11
    per = []
    for g in range(G):
        p = {**base, "layers": {**base["layers"],
                                "ssm": dict(base["layers"]["ssm"])}}
        for k, v in p["layers"]["ssm"].items():
            if is_lora_leaf(k):
                p["layers"]["ssm"][k] = (torch.randn(
                    v.shape, generator=gen) * 0.1).requires_grad_(True)
        per.append(p)
    stacked = {**base, "layers": {**base["layers"], "ssm": {
        k: torch.stack([p["layers"]["ssm"][k].detach() for p in per])
        .requires_grad_(True) if is_lora_leaf(k) else v
        for k, v in base["layers"]["ssm"].items()}}}
    toks = torch.randint(0, cfg.vocab_size, (G, B, S), generator=gen)
    got, _ = bundle.logits_stacked(stacked, {"tokens": toks})
    assert got.shape[:2] == (G, B)
    w = torch.randn(got.shape, generator=gen)
    (got * w).sum().backward()
    for g in range(G):
        want, _ = bundle.logits(per[g], {"tokens": toks[g]})
        torch.testing.assert_close(got[g].detach(), want.detach(),
                                   atol=1e-5, rtol=1e-5)
        (want * w[g]).sum().backward()
        for k, v in stacked["layers"]["ssm"].items():
            if is_lora_leaf(k):
                torch.testing.assert_close(
                    v.grad[g], per[g]["layers"]["ssm"][k].grad,
                    atol=1e-5, rtol=1e-4, msg=k)


def test_soft_prompt_gradients_match_reference():
    """The gradients of the device loss (``mlecs_loss``: the LM loss
    behind the connector's soft prompt, plus the contrastive term) of a
    toy ssm model with respect to the soft-prompt generator's
    ``spg_scale`` and ``spg_bias``, against ``jax.grad`` of the
    reference's, row by row (1e-4 of each row's largest |value|): the
    port differentiates the soft prompt as the reference does."""
    jcfg = _ssm_cfg(n_modalities=3, modality_dim=16, n_soft_tokens=4)
    jb, jp, tb, tp = port_pair(jcfg, unified=True)
    rng = np.random.RandomState(21)
    toks = rng.randint(0, jcfg.vocab_size, (2, 11)).astype(np.int32)
    feats = rng.randn(2, 3, 16).astype(np.float32)
    mask = np.array([[True, False, True], [True, True, False]])
    jbatch = {"tokens": jnp.asarray(toks), "modality_feats":
              jnp.asarray(feats), "modality_mask": jnp.asarray(mask)}
    tbatch = {"tokens": torch.from_numpy(toks).long(), "modality_feats":
              torch.from_numpy(feats), "modality_mask":
              torch.from_numpy(mask)}
    jtrain = jlora.partition(jp)

    def jfn(t):
        return jccl.mlecs_loss(jlora.combine(jp, t), jb, jbatch)[0]
    jg = jax.jit(jax.grad(jfn))(jtrain)
    train = {k: v.detach().requires_grad_(True)
             for k, v in lora.partition(tp).items()}
    loss, _ = ccl.mlecs_loss(lora.combine(tp, train), tb, tbatch)
    tg = ccl.grads_of(loss, train)
    for k in ("connector/spg_scale", "connector/spg_bias"):
        assert np.abs(np.asarray(jg[k])).max() > 0, k
        rows_close(tg[k], jg[k], k)
