"""Port parity for the ssm (mamba2) and hybrid (hymba) serving slice: the
SSD chunk scan's plain version, the chunked SSD, the SSD block and its
recurrent decode, the attention-free and hybrid stacks, the paged
prefill/insert/decode contract and the engine, each against the JAX
package on the same inputs (numpy, from a seed), at the toy sizes of
tests/test_serving.py (2 layers, d 32, N 8, P 16, chunk 8).

Tolerances: the SSD at float32 1e-4 / 1e-3 (tests/test_kernels.py's bound
for the chunked scan against the recurrence); model outputs at float32
1e-4, one bf16 block 6e-2 / 5e-2 (tests/test_torch_serving.py's bound:
the two frameworks round bf16 products at different points).  Through a
whole bf16 stack the SSD amplifies those roundings: dt is a bf16
projection output that enters exp of a cumulative sum, so one ulp moves
the decay of every later row, and the port sums the depthwise conv in
float32 where the reference rounds each tap (models/ssm.py).  On these
toys the reference's bf16 logits lie up to 0.84 (rms 0.044) from its own
float32 forward on the same weights, the port's up to 0.23 (rms 0.016).
So a stack's bf16 outputs are held to the reference at float32 on the
same weights: no farther from it than the reference's bf16 outputs are
(``hold``).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import ccl as jccl
from repro.core import lora as jlora
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels.ssd_scan import ssd_chunk as jssd_chunk
from repro.launch.serve_engine import EngineConfig as JEngineConfig
from repro.launch.serve_engine import ServingEngine as JEngine
from repro.models import ssm as jssm
from repro.models import transformer as jtransformer
from repro.models.model import build_model as jbuild
from repro_torch import interop
from repro_torch.configs.base import ModelConfig
from repro_torch.core.lora import flatten, is_lora_leaf, merge_lora
from repro_torch.kernels import ops, ref
from repro_torch.kernels.ssd_scan import ssd_chunk_cuda, ssd_chunk_plain
from repro_torch.launch.serve_engine import EngineConfig, ServingEngine
from repro_torch.models import ssm, transformer
from repro_torch.models.model import build_model
from repro_torch.models.paged import pages_for
from test_torch_serving import (flat_numpy, port_pair, serving_cfg,
                                strip_adapters)

torch.set_num_threads(1)

SSD = dict(atol=1e-4, rtol=1e-3)
F32 = dict(atol=1e-4, rtol=1e-4)
BF16 = dict(atol=6e-2, rtol=5e-2)
TOL = {"float32": F32, "bfloat16": BF16}

# tests/test_serving.py's toy families
FAMS = {
    "ssm": dict(family="ssm", ssm_state=8, ssm_head_dim=16, ssm_chunk=8),
    "hybrid": dict(family="hybrid", ssm_state=8, ssm_head_dim=16,
                   ssm_chunk=8, lora_targets=("wq", "wo", "in_proj")),
}


def fam_cfg(fam, dtype="float32", **kw):
    return serving_cfg(dtype=dtype, **FAMS[fam], **kw)


def soft_cfg(fam, dtype):
    """A toy family config with LoRA on in_proj/out_proj and a connector
    (the soft-prompt path), for the block and forward tests."""
    return serving_cfg(dtype=dtype, **dict(
        FAMS[fam], lora_targets=("wq", "wk", "wv", "wo", "in_proj",
                                 "out_proj")),
        n_modalities=3, modality_dim=16, n_soft_tokens=4, sliding_window=6,
        global_every=2)


def _np(x):
    return x.float().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x, np.float32)


def _t(a, dtype=None):
    t = torch.from_numpy(np.array(a))
    return t if dtype is None else t.to(dtype)


def ssd_inputs(B, S, H, P, G, N, seed=6, a_scale=0.2):
    """tests/test_kernels.py's SSD inputs, drawn with numpy."""
    rng = np.random.RandomState(seed)
    x = (rng.randn(B, S, H, P) * 0.5).astype(np.float32)
    dt = np.log1p(np.exp(rng.randn(B, S, H))).astype(np.float32)
    A = (-np.exp(rng.randn(H) * a_scale)).astype(np.float32)
    B_ = (rng.randn(B, S, G, N) * 0.5).astype(np.float32)
    C_ = (rng.randn(B, S, G, N) * 0.5).astype(np.float32)
    return x, dt, A, B_, C_


def chunk_cum(dt, A, chunk):
    """The within-chunk cumulative dt * A, (B, S, H) f32."""
    B, S, H = dt.shape
    da = (dt * A).reshape(B, S // chunk, chunk, H)
    return np.cumsum(da, axis=2, dtype=np.float32).reshape(B, S, H)


# ---------------------------------------------------------------------------
# kernel G's plain version, the chunked SSD

@pytest.mark.parametrize("B,S,H,P,G,N,chunk", [
    (1, 8, 2, 16, 1, 8, 8),
    (2, 48, 4, 16, 2, 8, 16),
    (1, 64, 3, 8, 1, 4, 32),
])
def test_ssd_chunk_plain_matches_pallas_kernel(B, S, H, P, G, N, chunk):
    """The plain version in the model layout against the TPU kernel in
    interpret mode (its (B*chunks, H, L, ...) layout, groups repeated) and
    against ref.ssd_chunk_ref, chunk by chunk and head by head."""
    x, dt, A, B_, C_ = ssd_inputs(B, S, H, P, G, N)
    cum = chunk_cum(dt, A, chunk)
    y, st = ssd_chunk_plain(_t(x), _t(dt), _t(cum), _t(B_), _t(C_), chunk)
    nc, rep = S // chunk, H // G

    def tpu(a, *tail):     # (B, S, ...) -> (B*nc, H, L, ...)
        a = a.reshape(B * nc, chunk, *a.shape[2:])
        if tail:           # a group axis: repeat to heads
            a = np.repeat(a, rep, axis=2)
        return jnp.asarray(np.moveaxis(a, 2, 1))
    jy, jst = jssd_chunk(tpu(x), tpu(dt), tpu(cum), tpu(B_, 1), tpu(C_, 1),
                         interpret=True)
    jy = np.moveaxis(np.asarray(jy), 1, 2).reshape(B, S, H, P)
    np.testing.assert_allclose(y.numpy(), jy, **SSD)
    np.testing.assert_allclose(st.numpy(), np.asarray(jst).reshape(
        B, nc, H, P, N), **SSD)
    for b, c, h in ((0, 0, 0), (B - 1, nc - 1, H - 1)):
        rows = slice(c * chunk, (c + 1) * chunk)
        args = (x[b, rows, h], dt[b, rows, h], cum[b, rows, h],
                B_[b, rows, h // rep], C_[b, rows, h // rep])
        ry, rst = jref.ssd_chunk_ref(*map(jnp.asarray, args))
        np.testing.assert_allclose(y[b, rows, h].numpy(), np.asarray(ry),
                                   **SSD)
        np.testing.assert_allclose(st[b, c, h].numpy(), np.asarray(rst),
                                   **SSD)
        py, pst = ref.ssd_chunk_ref(*map(_t, args))
        np.testing.assert_allclose(py.numpy(), np.asarray(ry), **SSD)
        np.testing.assert_allclose(pst.numpy(), np.asarray(rst), **SSD)


@pytest.mark.parametrize("B,S,H,P,G,N,chunk", [
    (1, 32, 2, 8, 1, 4, 8),
    (2, 64, 4, 16, 2, 8, 16),
    (1, 40, 2, 16, 1, 8, 16),      # ragged: 3 chunks, the last 8 rows
    (2, 5, 4, 16, 2, 8, 8),        # shorter than one chunk
    (1, 131, 6, 16, 3, 8, 32),     # ragged over 5 chunks, G = 3
])
def test_ssd_chunked_matches_reference(B, S, H, P, G, N, chunk):
    """ops.ssd_chunked (padding, G's plain version, the inter-chunk
    recurrence) against ssd_reference with its final state, and against
    the token-by-token recurrence of both packages."""
    x, dt, A, B_, C_ = ssd_inputs(B, S, H, P, G, N)
    y, h = ops.ssd_chunked(_t(x), _t(dt), _t(A), _t(B_), _t(C_), chunk,
                           return_state=True)
    jy, jh = jssm.ssd_reference(*map(jnp.asarray, (x, dt, A, B_, C_)),
                                chunk, return_state=True)
    assert y.shape == (B, S, H, P) and h.shape == (B, H, P, N)
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), **SSD)
    np.testing.assert_allclose(h.numpy(), np.asarray(jh), **SSD)
    ry, rh = ref.ssd_recurrent_ref(_t(x), _t(dt), _t(A), _t(B_), _t(C_),
                                   return_state=True)
    jry = jref.ssd_recurrent_ref(*map(jnp.asarray, (x, dt, A, B_, C_)))
    np.testing.assert_allclose(ry.numpy(), np.asarray(jry), **SSD)
    np.testing.assert_allclose(y.numpy(), ry.numpy(), **SSD)
    np.testing.assert_allclose(h.numpy(), rh.numpy(), **SSD)


def test_reference_ssd_wrapper_cannot_serve():
    """The reference's kernel wrapper (repro/kernels/ops.py:ssd_chunked)
    claims ssd_reference's contract but has no padding and no
    ``return_state`` (ROADMAP 3.3): a ragged S fails to reshape, and a
    whole number of chunks works."""
    x, dt, A, B_, C_ = map(jnp.asarray, ssd_inputs(1, 40, 4, 8, 1, 8))
    with pytest.raises(TypeError, match="reshape"):
        jops.ssd_chunked(x, dt, A, B_, C_, chunk=16)
    with pytest.raises(TypeError, match="return_state"):
        jops.ssd_chunked(x[:, :32], dt[:, :32], A, B_[:, :32], C_[:, :32],
                         chunk=16, return_state=True)
    got = jops.ssd_chunked(x[:, :32], dt[:, :32], A, B_[:, :32],
                           C_[:, :32], chunk=16)
    want = ops.ssd_chunked(*(_t(np.asarray(a)) for a in (
        x[:, :32], dt[:, :32], A, B_[:, :32], C_[:, :32])), 16)
    np.testing.assert_allclose(want.numpy(), np.asarray(got), **SSD)


def test_ssd_large_decay_is_finite():
    """|A| dt up to 16 * 6 per row: exp of the unmasked argument above the
    diagonal would be inf, and inf * 0 NaN.  The plain version masks the
    argument, so the output is finite and equals the recurrence."""
    x, dt, A, B_, C_ = ssd_inputs(1, 24, 2, 8, 1, 4)
    dt = dt + 5.0
    A = np.array([-16.0, -1.0], np.float32)
    cum = chunk_cum(dt, A, 8)
    y, st = ssd_chunk_plain(_t(x), _t(dt), _t(cum), _t(B_), _t(C_), 8)
    assert torch.isfinite(y).all() and torch.isfinite(st).all()
    got = ops.ssd_chunked(_t(x), _t(dt), _t(A), _t(B_), _t(C_), 8)
    want = ref.ssd_recurrent_ref(_t(x), _t(dt), _t(A), _t(B_), _t(C_))
    np.testing.assert_allclose(got.numpy(), want.numpy(), **SSD)


def test_ssd_kernel_refuses_a_gradient_and_the_cpu():
    """The kernel has no backward and no CPU mode: it raises rather than
    return a tensor without a gradient or run elsewhere."""
    x, dt, A, B_, C_ = ssd_inputs(1, 8, 2, 16, 1, 8)
    args = (_t(x).requires_grad_(True), _t(dt), _t(chunk_cum(dt, A, 8)),
            _t(B_), _t(C_), 8)
    with pytest.raises(NotImplementedError, match="backward"):
        ssd_chunk_cuda(*args)
    with torch.no_grad(), pytest.raises(ValueError, match="CUDA"):
        ssd_chunk_cuda(*args)
    assert ssd_chunk_cuda.launches == 0


# ---------------------------------------------------------------------------
# the SSD block, its decode step, the stacks

def _ssm_layer(jp, tp, i=0):
    """Layer i's SSD mixer params, JAX and port."""
    jl = jax.tree.map(lambda a: a[i], jp["layers"]["ssm"])
    return jl, {k: v[i] for k, v in tp["layers"]["ssm"].items()}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ssm_block_and_decode_step_match_reference(dtype):
    """ssm_block (with its final state) on a ragged S of 2 chunks, then
    three recurrent decode steps from that state, against JAX."""
    jcfg = soft_cfg("ssm", dtype)
    _, jp, tb, tp = port_pair(jcfg)
    jl, tl = _ssm_layer(jp, tp)
    rng = np.random.RandomState(2)
    x = (rng.randn(2, 13, jcfg.d_model) * 0.5).astype(np.float32)
    jx = jnp.asarray(x, jcfg.param_dtype)
    tx = _t(x, tb.cfg.torch_dtype)
    jblock = jax.jit(jssm.ssm_block, static_argnums=(1, 3))
    jstep = jax.jit(jssm.ssm_decode_step, static_argnums=1)
    jout, jst = jblock(jl, jcfg, jx, True)
    tout, tst = ssm.ssm_block(tl, tb.cfg, tx, return_state=True)
    np.testing.assert_allclose(_np(tout), _np(jout), **TOL[dtype])
    np.testing.assert_allclose(_np(tst["h"]), _np(jst["h"]), **TOL[dtype])
    assert tst["conv"].dtype == tb.cfg.torch_dtype
    np.testing.assert_allclose(_np(tst["conv"]), _np(jst["conv"]),
                               **TOL[dtype])
    assert torch.equal(ssm.init_ssm_state(tb.cfg, 2, "cpu")["h"],
                       _t(np.asarray(jssm.init_ssm_state(jcfg, 2)["h"])))
    for i in range(3):
        xt = (rng.randn(2, 1, jcfg.d_model) * 0.5).astype(np.float32)
        jy, jst = jstep(jl, jcfg, jst, jnp.asarray(xt, jcfg.param_dtype))
        ty, tst = ssm.ssm_decode_step(tl, tb.cfg, tst,
                                      _t(xt, tb.cfg.torch_dtype))
        np.testing.assert_allclose(_np(ty), _np(jy), err_msg=f"step {i}",
                                   **TOL[dtype])
        np.testing.assert_allclose(_np(tst["h"]), _np(jst["h"]),
                                   err_msg=f"step {i}", **TOL[dtype])


def test_causal_conv_matches_reference():
    rng = np.random.RandomState(5)
    x = rng.randn(2, 7, 6).astype(np.float32)
    w = rng.randn(6, 4).astype(np.float32)
    b = rng.randn(6).astype(np.float32)
    got = ssm.causal_conv(_t(x), _t(w), _t(b))
    want = jssm.causal_conv(*map(jnp.asarray, (x, w, b)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)


def _soft_batch(jcfg, jp, tb, tp, toks, seed=8):
    """The same tokens and connector soft prompt for both packages."""
    from repro.core import connector as jconn
    from repro_torch.core import connector
    rng = np.random.RandomState(seed)
    feats = rng.randn(toks.shape[0], jcfg.n_modalities,
                      jcfg.modality_dim).astype(np.float32)
    mask = rng.rand(toks.shape[0], jcfg.n_modalities) < 0.6
    mask[:, 0] = True
    jsoft, _, _ = jconn.connector_prefix(jp["connector"], jcfg,
                                         jnp.asarray(feats), jnp.asarray(mask))
    tsoft, _, _ = connector.connector_prefix(tp["connector"], tb.cfg,
                                             _t(feats), _t(mask))
    return ({"tokens": jnp.asarray(toks), "prefix_embeds": jsoft},
            {"tokens": _t(toks).long(), "prefix_embeds": tsoft})


def hold(got, want, want_f32=None, name=""):
    """At float32: ``got`` equals the reference's ``want`` at 1e-4.  At
    bf16 (``want_f32`` given: the reference at float32 on the same
    weights and inputs): ``got`` is no farther from it than the
    reference's own bf16 ``want`` is, in max and in rms (1.25x, plus 1e-2
    / 1e-3 for outputs the reference gets exactly)."""
    got = _np(got)
    if want_f32 is None:
        np.testing.assert_allclose(got, _np(want), err_msg=name, **F32)
        return
    truth = _np(want_f32)
    port, ref_ = np.abs(got - truth), np.abs(_np(want) - truth)
    assert port.max() <= 1.25 * ref_.max() + 1e-2, (name, port.max(),
                                                   ref_.max())
    rms_port = float(np.sqrt(np.mean(port ** 2)))
    rms_ref = float(np.sqrt(np.mean(ref_ ** 2)))
    assert rms_port <= 1.25 * rms_ref + 1e-3, (name, rms_port, rms_ref)


def f32_reference(jcfg, jp):
    """The reference at float32 on the same (upcast) weights."""
    f32 = dataclasses.replace(jcfg, dtype="float32")
    return jbuild(f32), f32, jax.tree.map(
        lambda a: a.astype(jnp.float32), jp)


@pytest.mark.parametrize("fam", ["ssm", "hybrid"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_forward_matches_reference(fam, dtype):
    """logits, lm_loss, the hidden path and the collected state of the
    mamba2 stack / the hybrid trunk, with a soft prompt, a ragged S over
    two chunks and (hybrid) a window with a global layer."""
    jcfg = soft_cfg(fam, dtype)
    jb, jp, tb, tp = port_pair(jcfg, unified=True)
    toks = np.random.RandomState(4).randint(0, jcfg.vocab_size, (2, 11))
    jbatch, tbatch = _soft_batch(jcfg, jp, tb, tp, toks.astype(np.int32))
    runs = [(jb, jcfg, jp, jbatch)]
    if dtype == "bfloat16":
        jb32, jcfg32, jp32 = f32_reference(jcfg, jp)
        runs.append((jb32, jcfg32, jp32, dict(
            jbatch, prefix_embeds=jbatch["prefix_embeds"].astype(
                jnp.float32))))
    jmod = jssm if fam == "ssm" else jtransformer
    kw = "collect_state" if fam == "ssm" else "collect_kv"
    outs = []
    for b, c, p, batch in runs:
        outs.append((b.logits(p, batch)[0], b.lm_loss(p, batch)[0],
                     b.hidden(p, batch)[0],
                     jmod.forward(p, c, batch["tokens"],
                                  batch["prefix_embeds"], **{kw: True})[2]))
    want, want32 = outs[0], (outs[1] if len(outs) > 1 else (None,) * 4)

    got, aux = tb.logits(tp, tbatch)
    assert got.dtype == torch.float32 and got.shape == want[0].shape
    hold(got, want[0], want32[0], "logits")
    np.testing.assert_allclose(float(tb.lm_loss(tp, tbatch)[0]),
                               float(want[1]), **TOL[dtype])
    hold(tb.hidden(tp, tbatch)[0], want[2], want32[2], "hidden")
    tmod = ssm if fam == "ssm" else transformer
    _, _, tst = tmod.forward(tp, tb.cfg, tbatch["tokens"],
                             tbatch["prefix_embeds"], **{kw: True})
    assert len(tst) == len(want[3]) == (2 if fam == "ssm" else 4)
    for i, (t, j) in enumerate(zip(tst, want[3])):
        assert t.shape == j.shape
        hold(t, j, None if want32[3] is None else want32[3][i], f"state {i}")


# ---------------------------------------------------------------------------
# paged contract and the engine

def paged_run(b, p, dtype, toks, prefix, S, K, ps, slot, page_ids, bt,
              active, torch_side):
    """prefill -> insert in slot ``slot`` -> K decode steps, through the
    JAX bundle or (``torch_side``) the port's.  Returns (kv_len, last
    logits, the inserted state, [slot's logits per step], [slot's ssm_h
    per step])."""
    if torch_side:
        last, pack, kv = b.prefill_paged(
            p, {"tokens": _t(toks[:, :S]).long(),
                "prefix_embeds": _t(prefix, dtype)}, S)
        state = b.insert_paged(b.init_paged(2, 16, ps, "cpu"), pack, slot,
                               _t(page_ids).long())
        inserted = {k: v.clone() for k, v in state.items()}
        lens = torch.zeros(2, dtype=torch.int32)
        lens[slot] = kv
        conv = dict(bt=_t(bt), active=_t(active))
    else:
        last, pack, kv = b.prefill_paged(
            p, {"tokens": jnp.asarray(toks[:, :S]),
                "prefix_embeds": jnp.asarray(prefix, dtype)}, jnp.int32(S))
        state = b.insert_paged(b.init_paged(2, 16, ps), pack,
                               jnp.int32(slot), jnp.asarray(page_ids))
        inserted = state
        lens = jnp.zeros((2,), jnp.int32).at[slot].set(kv)
        conv = dict(bt=jnp.asarray(bt), active=jnp.asarray(active))
    logits, hs = [], []
    for i in range(K):
        tok = np.zeros((2, 1), np.int32)
        tok[slot, 0] = toks[0, S + i]
        tok = _t(tok).long() if torch_side else jnp.asarray(tok)
        lg, state = b.decode_paged(p, state, conv["bt"], lens, tok,
                                   conv["active"])
        logits.append(lg[slot])
        h = state["ssm_h"][:, slot]
        hs.append(h.clone() if torch_side else h)   # the port writes in place
        lens = lens + (conv["active"].int() if torch_side
                       else conv["active"])
    return int(kv), last, inserted, logits, hs


@pytest.mark.parametrize("fam", ["ssm", "hybrid"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_paged_prefill_insert_decode_match_reference(fam, dtype):
    """Exact-length prompt with a soft prompt, seated in slot 1 of 2, then
    four decode steps, against the JAX contract; slot 0 idles."""
    jcfg = fam_cfg(fam, dtype)
    jb, jp, tb, tp = port_pair(jcfg)
    S, K, ps, P, slot = 9, 4, 4, 3, 1
    rng = np.random.RandomState(1)
    toks = rng.randint(0, jcfg.vocab_size, (1, S + K)).astype(np.int32)
    prefix = (rng.randn(1, P, jcfg.d_model) * 0.5).astype(np.float32)
    n_pg = pages_for(P + S + K, ps) if fam == "hybrid" else 0
    page_ids = np.arange(1, 1 + n_pg, dtype=np.int32)
    bt = np.zeros((2, 8), np.int32)
    bt[slot, :n_pg] = page_ids
    active = np.array([False, True])
    args = (toks, prefix, S, K, ps, slot, page_ids, bt, active)

    want = paged_run(jb, jp, jcfg.param_dtype, *args, torch_side=False)
    want32 = (None,) * 5
    if dtype == "bfloat16":
        jb32, _, jp32 = f32_reference(jcfg, jp)
        want32 = paged_run(jb32, jp32, jnp.float32, *args, torch_side=False)
    got = paged_run(tb, tp, tb.cfg.torch_dtype, *args, torch_side=True)
    assert got[0] == want[0] == P + S
    hold(got[1], want[1], want32[1], "prefill logits")
    assert sorted(got[2]) == sorted(want[2])
    for name in got[2]:
        assert got[2][name].dtype == (torch.float32 if name == "ssm_h"
                                      else tb.cfg.torch_dtype), name
        hold(got[2][name], want[2][name],
             None if want32[2] is None else want32[2][name], name)
    for i in range(K):
        hold(got[3][i], want[3][i],
             None if want32[3] is None else want32[3][i], f"logits {i}")
        hold(got[4][i], want[4][i],
             None if want32[4] is None else want32[4][i], f"ssm_h {i}")


ENGINE = dict(n_slots=2, page_size=4, n_pages=32, max_pages_per_seq=8,
              max_out=16, buckets=(8, 16))
MIX = [(5, 6), (8, 3), (12, 9), (3, 1), (9, 12), (6, 4)]   # test_serving.py


@pytest.mark.parametrize("fam", ["ssm", "hybrid"])
def test_engine_matches_reference_engine_greedy(fam):
    """The six-request mix of tests/test_serving.py at exact lengths, two
    with a soft prompt: equal greedy tokens at float32, no page taken by
    an ssm request, free lists restored."""
    jcfg = fam_cfg(fam)
    jb, jp, tb, tp = port_pair(jcfg)
    rng = np.random.RandomState(3)
    reqs = []
    for i, (n, m) in enumerate(MIX):
        toks = rng.randint(0, jcfg.vocab_size, (n,)).astype(np.int32)
        prefix = (rng.randn(2, jcfg.d_model) * 0.5).astype(np.float32) \
            if i in (1, 4) else None
        reqs.append((toks, m, prefix))

    jengine = JEngine(jb, strip_adapters(jlora.merge_lora(jp, jcfg)),
                      JEngineConfig(**ENGINE), merge=False)
    tengine = ServingEngine(tb, tp, EngineConfig(device="cpu", **ENGINE))
    assert tengine.paged_fam == jengine.paged_fam == (fam == "hybrid")
    assert tengine.exact_len and jengine.exact_len
    assert sorted(tengine.pstate) == sorted(jengine.pstate)
    jrids = [jengine.submit(t, max_new=m, prefix_embeds=p) for t, m, p in reqs]
    trids = [tengine.submit(t, max_new=m, prefix_embeds=None if p is None
                            else torch.from_numpy(p)) for t, m, p in reqs]
    tengine._try_admit()
    if fam == "ssm":     # two slots seated, no page taken
        assert len(tengine._free_pages) == ENGINE["n_pages"] - 1
    jdone, tdone = jengine.run(), tengine.run()
    for (toks, m, _), jr, tr in zip(reqs, jrids, trids):
        assert len(tdone[tr].out) == m
        assert tdone[tr].out.tolist() == jdone[jr].out.tolist(), \
            f"len {len(toks)}, budget {m}"
    assert sorted(tengine._free_pages) == list(range(1, ENGINE["n_pages"]))
    assert sorted(tengine._free_slots) == [0, 1]
    assert tengine.n_prefills == len(MIX)


def test_engine_prefills_recurrent_families_at_exact_length():
    """A prompt of 5 tokens is prefilled as 5 for ssm and hybrid (8, the
    bucket, for the dense family)."""
    seen = {}
    for fam in ("dense", "ssm", "hybrid"):
        jcfg = serving_cfg() if fam == "dense" else fam_cfg(fam)
        _, _, tb, tp = port_pair(jcfg)
        engine = ServingEngine(tb, tp, EngineConfig(device="cpu", **ENGINE))
        real = engine.bundle.prefill_paged
        lens = []

        def spy(params, batch, true_len, real=real, lens=lens):
            lens.append(batch["tokens"].shape[1])
            return real(params, batch, true_len)
        engine.bundle = engine.bundle._replace(prefill_paged=spy)
        engine.submit(np.arange(5), max_new=2)
        engine.run()
        seen[fam] = lens
    assert seen == {"dense": [8], "ssm": [5], "hybrid": [5]}


# ---------------------------------------------------------------------------
# interop and merge_lora with the SSM's leaves

def test_interop_round_trip_with_ssm_f32_leaves_is_bit_exact():
    """A bf16 hybrid tree keeps A_log, dt_bias and D_skip in f32: they
    cross as f32, every other leaf as bf16, and back bit for bit."""
    jcfg = soft_cfg("hybrid", "bfloat16")
    _, jp, _, tp = port_pair(jcfg, unified=True)
    want = flat_numpy(jp)
    f32 = sorted(k for k, v in want.items() if v.dtype == np.float32)
    assert f32 == ["layers/ssm/A_log", "layers/ssm/D_skip",
                   "layers/ssm/dt_bias"]
    assert flatten(tp)["layers/ssm/A_log"].dtype == torch.float32
    assert flatten(tp)["layers/ssm/in_proj"].dtype == torch.bfloat16
    got = interop.params_to_numpy(tp)
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


@pytest.mark.parametrize("path", ["layers/ssm/in_proj", "layers/ln1",
                                  "layers/ssm/A_log_scale", "A_log/w"])
def test_interop_still_refuses_other_mismatched_leaves(path):
    flat = {"layers/ssm/A_log": np.zeros(3, np.float32),
            path: np.zeros(3, np.float32)}
    with pytest.raises(TypeError, match="float32 leaf in a torch.bfloat16"):
        interop.params_from_numpy(flat, "cpu", torch.bfloat16)
    half = {"layers/ssm/A_log": np.zeros(3, np.float16)}
    with pytest.raises(TypeError, match="float16"):
        interop.params_from_numpy(half, "cpu", torch.bfloat16)


@pytest.mark.parametrize("fam", ["ssm", "hybrid"])
def test_merge_lora_folds_ssm_adapters(fam):
    """The in_proj/out_proj adapters of both configs' targets are folded
    in and dropped; the f32 leaves pass through; the merged tree serves
    the adapted model."""
    jcfg = soft_cfg(fam, "float32")
    _, jp, tb, tp = port_pair(jcfg)
    merged = flatten(merge_lora(tp, tb.cfg))
    assert not any(is_lora_leaf(k) for k in merged)
    want = flat_numpy(jlora.merge_lora(jp, jcfg))
    assert sorted(merged) == sorted(k for k in want if not is_lora_leaf(k))
    for k in ("layers/ssm/in_proj", "layers/ssm/out_proj"):
        np.testing.assert_allclose(merged[k].numpy(), want[k], atol=1e-6,
                                   rtol=1e-6, err_msg=k)
        assert not torch.equal(merged[k], flatten(tp)[k]), k
    assert torch.equal(merged["layers/ssm/A_log"],
                       flatten(tp)["layers/ssm/A_log"])
    toks = torch.from_numpy(
        np.random.RandomState(1).randint(0, jcfg.vocab_size, (1, 10))).long()
    unmerged, _ = tb.logits(tp, {"tokens": toks})
    served, _ = tb.logits(merge_lora(tp, tb.cfg), {"tokens": toks})
    np.testing.assert_allclose(served.numpy(), unmerged.numpy(), **F32)


# ---------------------------------------------------------------------------
# the configs

def test_port_init_matches_reference_structure():
    """The port's own init gives the reference's leaves: same paths,
    shapes and dtypes (A_log, dt_bias, D_skip f32 in a bf16 tree) and the
    reference's deterministic A_log / dt_bias / D_skip values."""
    for fam in ("ssm", "hybrid"):
        jcfg = soft_cfg(fam, "bfloat16")
        jb = jbuild(jcfg)
        want = flat_numpy(jccl.init_unified(jax.random.key(0), jb))
        cfg = ModelConfig(**dataclasses.asdict(jcfg))
        from repro_torch.core.connector import init_unified
        got = interop.params_to_numpy(
            init_unified(torch.Generator().manual_seed(0), build_model(cfg)))
        assert sorted(got) == sorted(want)
        for k, v in want.items():
            assert got[k].shape == v.shape and got[k].dtype == v.dtype, k
        for k in ("layers/ssm/A_log", "layers/ssm/dt_bias",
                  "layers/ssm/D_skip"):
            np.testing.assert_allclose(got[k], want[k], rtol=1e-6)
