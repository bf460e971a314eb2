"""Port parity for the training slice, module by module: kernel C's and
kernel D's plain versions (forward and gradient), the model loss, AdamW,
MMA, the SE-CCL pooled KL, the eval step and one CCL / AMT local step,
each against the JAX package on the same numpy inputs.

On the CPU the port's ``ops`` wrappers take the plain versions (a CUDA
tensor launches the hand-written kernels; see test_torch_cuda.py).  JAX's
Pallas kernels run in interpret mode.  Tolerances are stated per test:
float32 first (the algorithm), then bf16 (rounding points differ: the
port sums an adapted projection in f32 and rounds once, the reference
rounds each of its three products).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import ModelConfig as JConfig
from repro.core import ccl as jccl
from repro.core import gram as jgram
from repro.core import lora as jlora
from repro.core import mma as jmma
from repro.core import seccl as jseccl
from repro.data import pipeline as jpipe
from repro.data.multimodal import mer_partition as jmer
from repro.data.synthetic import synthetic_multimodal_corpus as jcorpus
from repro.kernels.gram_volume import gram_log_volume as jgram_kernel
from repro.kernels.lora_matmul import lora_matmul as jlora_kernel
from repro.models import layers as jlayers
from repro.models.model import build_model as jbuild
from repro.optim.adamw import adamw as jadamw
from repro.optim.adamw import apply_updates as japply
from repro.optim import schedule as jschedule
from repro_torch import interop
from repro_torch.configs.base import ModelConfig
from repro_torch.core import ccl, gram, lora, mma, seccl
from repro_torch.core.spec import draw_masks
from repro_torch.data import pipeline
from repro_torch.data.synthetic import synthetic_multimodal_corpus
from repro_torch.kernels import ops
from repro_torch.kernels.gram_volume import gram_log_volume_plain
from repro_torch.kernels.lora_matmul import lora_matmul_plain
from repro_torch.models.model import build_model
from repro_torch.optim import schedule
from repro_torch.optim.adamw import adamw, apply_updates

torch.set_num_threads(1)


def _t(a, dtype=torch.float32, grad=False):
    return torch.tensor(np.asarray(a, np.float32), dtype=dtype,
                        requires_grad=grad)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def flat_numpy(tree) -> dict:
    """JAX pytree -> {path_str: ndarray}, bf16 as its uint16 bits."""
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        a = np.asarray(leaf)
        out[jlora.path_str(path)] = a.view(np.uint16) \
            if a.dtype == jnp.bfloat16 else a
    return out


def toy_cfg(dtype="float32", **kw):
    """tests/conftest.py::toy_cfg, at ``dtype``."""
    base = dict(name="toy", family="dense", n_layers=2, d_model=64,
                n_heads=4, n_kv_heads=2, head_dim=16, d_ff=128,
                vocab_size=128, n_modalities=3, modality_dim=32,
                n_soft_tokens=4, connector_dim=48, lora_rank=4, remat=False,
                activation="gelu", dtype=dtype)
    base.update(kw)
    return JConfig(**base)


def unified_pair(jcfg, seed=0):
    """(JAX bundle, JAX unified params with non-zero LoRA B, port bundle,
    port params) from one JAX init."""
    jb = jbuild(jcfg)
    jp = jccl.init_unified(jax.random.key(seed), jb)
    rng = np.random.RandomState(seed)

    def fill(path, leaf):
        if jlora.path_str(path).endswith("_lora_b"):
            return jnp.asarray(rng.randn(*leaf.shape) * 0.05, leaf.dtype)
        return leaf
    jp = jax.tree_util.tree_map_with_path(fill, jp)
    cfg = ModelConfig(**dataclasses.asdict(jcfg))
    tp = interop.params_from_numpy(flat_numpy(jp), "cpu", cfg.torch_dtype)
    return jb, jp, build_model(cfg), tp


@pytest.fixture(scope="module")
def corpus():
    return jcorpus(0, 96, 12, 128, n_classes=4, n_modalities=3,
                   modality_dim=32, template_len=4)


def batch_np(corpus, n=8, mask=None, seed=3):
    idx = np.random.RandomState(seed).permutation(
        corpus["tokens"].shape[0])[:n]
    if mask is None:
        mask = np.array([True, False, True])
    return jpipe._gather_np(corpus, idx, mask)


# ---------------------------------------------------------------------------
# data: the port's numpy copies draw identical arrays

def test_data_copies_are_bit_identical(corpus):
    got = synthetic_multimodal_corpus(0, 96, 12, 128, n_classes=4,
                                      n_modalities=3, modality_dim=32,
                                      template_len=4)
    for k in corpus:
        np.testing.assert_array_equal(got[k], corpus[k])
    np.testing.assert_array_equal(draw_masks(5, 7, 3, 0.4),
                                  jmer(5, 7, 3, 0.4))
    js, ts = jpipe.ClientStreams(), pipeline.ClientStreams()
    for s in (js, ts):
        s.register("a", corpus, 8, 11, np.array([True, False, True]))
    for _ in range(14):                   # crosses an epoch boundary
        a, b = js.pull("a"), ts.pull("a")
        for k in a:
            np.testing.assert_array_equal(a[k], b[k])
    evj = list(jpipe.np_eval_batches(corpus, 40, None))
    evt = list(pipeline.np_eval_batches(corpus, 40, None))
    assert len(evt) == 3 and evt[-1]["row_valid"].sum() == 16
    for a, b in zip(evj, evt):
        for k in a:
            np.testing.assert_array_equal(a[k], b[k])


# ---------------------------------------------------------------------------
# kernel C: lora_matmul

def _lora_np(M, K, N, r, seed=0):
    rng = np.random.RandomState(seed)
    return (rng.randn(M, K).astype(np.float32),
            (rng.randn(K, N) / np.sqrt(K)).astype(np.float32),
            (rng.randn(K, r) / np.sqrt(K)).astype(np.float32),
            (0.1 * rng.randn(r, N)).astype(np.float32))


def test_lora_plain_matches_jax_kernel_interpret():
    """f32: the plain version against the Pallas kernel (blocks divide the
    shapes, as the TPU kernel requires) at 1e-4."""
    x, w, a, b = _lora_np(128, 192, 128, 8)
    want = jlora_kernel(jnp.asarray(x), jnp.asarray(w), jnp.asarray(a),
                        jnp.asarray(b), scale=2.0, bm=64, bn=64, bk=64,
                        interpret=True)
    got = ops.lora_matmul(*(_t(v) for v in (x, w, a, b)), 2.0)
    np.testing.assert_allclose(_np(got), np.asarray(want), atol=1e-4,
                               rtol=1e-4)


@pytest.mark.parametrize("dtype,tol", [("float32", 1e-5), ("bfloat16", 5e-2)])
def test_lora_matches_proj_and_its_gradients(dtype, tol):
    """The model path: ``layers.proj`` with adapters, forward and the
    gradients for x, A and B (``jax.grad``), W frozen.  Ragged shapes.
    Tolerance 1e-5 at f32; 5e-2 at bf16 (rounding points differ)."""
    x, w, a, b = _lora_np(37, 48, 40, 4, seed=1)
    dy = np.random.RandomState(2).randn(37, 40).astype(np.float32)
    jcfg = toy_cfg(dtype, lora_rank=4)
    jdt = jnp.dtype(dtype)
    tdt = ModelConfig(**dataclasses.asdict(jcfg)).torch_dtype

    def jloss(xx, aa, bb):
        p = {"wq": jnp.asarray(w, jdt), "wq_lora_a": aa, "wq_lora_b": bb}
        y = jlayers.proj(p, "wq", xx, jcfg)
        return jnp.sum(y.astype(jnp.float32) * dy), y

    jargs = [jnp.asarray(v, jdt) for v in (x, a, b)]
    (_, jy), jg = jax.value_and_grad(jloss, argnums=(0, 1, 2),
                                     has_aux=True)(*jargs)
    tx, ta, tb = (_t(v, tdt, grad=True) for v in (x, a, b))
    scale = jcfg.lora_alpha / jcfg.lora_rank
    ty = ops.lora_matmul(tx, _t(w, tdt), ta, tb, scale)
    (ty.float() * _t(dy)).sum().backward()
    rtol = 0 if dtype == "float32" else tol
    np.testing.assert_allclose(_np(ty), _np(jy), atol=tol, rtol=rtol)
    for got, want in zip((tx.grad, ta.grad, tb.grad), jg):
        ref = _np(want)
        np.testing.assert_allclose(_np(got), ref,
                                   atol=tol * max(1.0, np.abs(ref).max()),
                                   rtol=rtol)


# ---------------------------------------------------------------------------
# kernel D: gram_log_volume

def _gram_np(B, k, d, seed=0):
    rng = np.random.RandomState(seed)
    vs = rng.randn(B, k, d).astype(np.float32)
    mask = rng.rand(B, k) < 0.7
    mask[:, 0] = True
    mask[2, 1:] = False                   # a sample with one present row
    vs = vs * mask[..., None]             # masked rows are all zero
    return vs, mask


@pytest.mark.parametrize("k", [4, 8])
def test_log_volume_and_gradient_match_jax(k):
    """f32: log_volume against repro.core.gram.log_volume and the Pallas
    kernel (interpret), its gradient against jax.grad; 1e-4."""
    vs, mask = _gram_np(16, k, 48, seed=k)
    g = np.random.RandomState(9).randn(16).astype(np.float32)
    want = jgram.log_volume(jnp.asarray(vs), jnp.asarray(mask))
    kern = jgram_kernel(jnp.asarray(vs), jnp.asarray(mask), interpret=True)
    jgrad = jax.grad(lambda v: jnp.sum(jgram.log_volume(
        v, jnp.asarray(mask)) * g))(jnp.asarray(vs))
    tv = _t(vs, grad=True)
    got = gram.log_volume(tv, torch.from_numpy(mask))
    (got * _t(g)).sum().backward()
    np.testing.assert_allclose(_np(got), np.asarray(want), atol=1e-4,
                               rtol=1e-4)
    np.testing.assert_allclose(_np(got), np.asarray(kern), atol=1e-4,
                               rtol=1e-4)
    np.testing.assert_allclose(_np(tv.grad), np.asarray(jgrad), atol=1e-4,
                               rtol=1e-4)
    assert np.all(_np(tv.grad)[~mask] == 0.0)


@pytest.mark.parametrize("score", ["volume", "cosine"])
def test_contrastive_losses_and_gradients_match_jax(score):
    """f32, 1e-5 (loss) / 1e-4 (grads): one log-volume call over all
    2(1+U) candidate sets equals the reference's per-set calls."""
    rng = np.random.RandomState(4)
    anc = rng.randn(8, 24).astype(np.float32)
    mods = rng.randn(8, 3, 24).astype(np.float32)
    mask = rng.rand(8, 3) < 0.6
    mask[:, 1] = True
    mods = mods * mask[..., None]
    jfn = jgram.contrastive_loss if score == "volume" \
        else jgram.pairwise_cosine_loss
    tfn = gram.contrastive_loss if score == "volume" \
        else gram.pairwise_cosine_loss
    jl, jg = jax.jit(jax.value_and_grad(
        lambda a, m: jfn(a, m, jnp.asarray(mask), 4), argnums=(0, 1)))(
            jnp.asarray(anc), jnp.asarray(mods))
    ta, tm = _t(anc, grad=True), _t(mods, grad=True)
    tl = tfn(ta, tm, torch.from_numpy(mask), 4)
    tl.backward()
    np.testing.assert_allclose(tl.item(), float(jl), atol=1e-5, rtol=1e-5)
    for got, want in zip((ta.grad, tm.grad), jg):
        np.testing.assert_allclose(_np(got), np.asarray(want), atol=1e-4,
                                   rtol=1e-4)
    if score == "volume":
        vols = gram._candidate_volumes(ta, tm, torch.from_numpy(mask), 4,
                                       "anchor")
        jv = jgram._candidate_volumes(jnp.asarray(anc), jnp.asarray(mods),
                                      jnp.asarray(mask), 4, "anchor")
        np.testing.assert_allclose(_np(vols), np.asarray(jv), atol=1e-4)


def test_gram_plain_bf16():
    """bf16 inputs: both sides normalize in f32; 2e-3."""
    vs, mask = _gram_np(8, 4, 64, seed=3)
    jv = jnp.asarray(vs, jnp.bfloat16)
    want = jgram.log_volume(jv, jnp.asarray(mask))
    got = gram_log_volume_plain(torch.from_numpy(vs).to(torch.bfloat16),
                                torch.from_numpy(mask))
    np.testing.assert_allclose(_np(got), np.asarray(want), atol=2e-3,
                               rtol=2e-3)


# ---------------------------------------------------------------------------
# model loss (kernel B's plain version inside) and its gradient

@pytest.mark.parametrize("dtype,tol", [("float32", 1e-5), ("bfloat16", 3e-2)])
@pytest.mark.parametrize("remat", [False, True])
def test_lm_loss_and_lora_grads_match_jax(corpus, dtype, tol, remat):
    """``lm_loss`` on toy_cfg with a soft prompt, and its gradient with
    respect to the trainable leaves (remat on and off)."""
    jb, jp, tb, tp = unified_pair(toy_cfg(dtype, remat=remat))
    b = batch_np(corpus)
    jbatch = {k: jnp.asarray(v) for k, v in b.items()}
    tbatch = pipeline.to_tensors(b, "cpu")
    jtrain = jlora.partition(jp)

    def jfn(t):
        loss, _ = jccl.mlecs_loss(jlora.combine(jp, t), jb, jbatch,
                                  ccl_weight=0.0)
        return loss
    jl, jg = jax.jit(jax.value_and_grad(jfn))(jtrain)
    train = {k: v.detach().requires_grad_(True)
             for k, v in lora.partition(tp).items()}
    tl, _ = ccl.mlecs_loss(lora.combine(tp, train), tb, tbatch,
                           ccl_weight=0.0)
    tg = ccl.grads_of(tl, train)
    assert sorted(tg) == sorted(jg)
    np.testing.assert_allclose(tl.item(), float(jl), rtol=tol)
    gmax = max(float(np.abs(_np(v)).max()) for v in jg.values())
    for k in jg:
        np.testing.assert_allclose(_np(tg[k]), _np(jg[k]),
                                   atol=tol * gmax, err_msg=k)
    # and the bundle's own lm_loss on a raw batch
    jl2, jm = jb.lm_loss(jp, jbatch)
    tl2, tm = tb.lm_loss(tp, tbatch)
    np.testing.assert_allclose(float(tl2), float(jl2), rtol=tol)
    np.testing.assert_allclose(float(tm["ce"]), float(jm["ce"]), rtol=tol)


# ---------------------------------------------------------------------------
# optimizer, aggregation, SE-CCL, eval

def test_adamw_matches_jax_after_steps():
    """Three steps of clipped AdamW on a bf16 + f32 flat dict: moments at
    1e-6, params bit-equal or within one bf16 ulp."""
    rng = np.random.RandomState(0)
    p = {"a": rng.randn(5, 3).astype(np.float32),
         "b": rng.randn(7).astype(np.float32)}
    jp = {"a": jnp.asarray(p["a"], jnp.bfloat16), "b": jnp.asarray(p["b"])}
    tp = {"a": _t(p["a"], torch.bfloat16), "b": _t(p["b"])}
    jo, to = jadamw(3e-3), adamw(3e-3)
    js, ts = jo.init(jp), to.init(tp)
    for i in range(3):
        g = {k: rng.randn(*v.shape).astype(np.float32) * (3.0 if i else 0.1)
             for k, v in p.items()}
        ju, js = jo.update({k: jnp.asarray(v) for k, v in g.items()}, js, jp)
        jp = japply(jp, ju)
        tu, ts = to.update({k: _t(v) for k, v in g.items()}, ts, tp)
        tp = apply_updates(tp, tu)
    assert int(ts["step"]) == int(js["step"]) == 3
    for k in p:
        np.testing.assert_allclose(_np(ts["mu"][k]), np.asarray(js["mu"][k]),
                                   atol=1e-6)
        np.testing.assert_allclose(_np(ts["nu"][k]), np.asarray(js["nu"][k]),
                                   atol=1e-6)
    np.testing.assert_allclose(_np(tp["b"]), np.asarray(jp["b"]), atol=1e-6)
    np.testing.assert_allclose(_np(tp["a"]), _np(jp["a"]), atol=1e-2)


@pytest.mark.parametrize("name,args", [("constant", (3e-3,)),
                                       ("cosine_warmup", (3e-3, 3, 12, 1e-4))])
def test_schedules_and_scheduled_adamw_match_jax(name, args):
    """The learning-rate schedules at steps 0-15 (f32, 1e-6 relative: the
    two libraries' cos differ by an ulp or two), and
    five AdamW steps with the schedule as ``lr`` (f32 params, 1e-6)."""
    jsched, tsched = getattr(jschedule, name)(*args), \
        getattr(schedule, name)(*args)
    for step in range(16):
        np.testing.assert_allclose(
            _np(tsched(torch.tensor(step, dtype=torch.int32))),
            np.asarray(jsched(jnp.asarray(step, jnp.int32))), rtol=1e-6,
            err_msg=f"step {step}")
    rng = np.random.RandomState(5)
    p = {"a": rng.randn(4, 3).astype(np.float32)}
    jp, tp = {"a": jnp.asarray(p["a"])}, {"a": _t(p["a"])}
    jo, to = jadamw(jsched), adamw(tsched)
    js, ts = jo.init(jp), to.init(tp)
    for _ in range(5):
        g = rng.randn(4, 3).astype(np.float32)
        ju, js = jo.update({"a": jnp.asarray(g)}, js, jp)
        jp = japply(jp, ju)
        tu, ts = to.update({"a": _t(g)}, ts, tp)
        tp = apply_updates(tp, tu)
    np.testing.assert_allclose(_np(tp["a"]), np.asarray(jp["a"]), atol=1e-6)


def test_communicated_fraction_matches_jax():
    """Parameter counts and the communicated fraction of the toy model,
    for the LoRA leaves and for the whole trainable set: exact."""
    _, jp, _, tp = unified_pair(toy_cfg())
    assert lora.n_params(tp) == jlora.n_params(jp)
    for tpred, jpred in ((lora.is_lora_leaf, jlora.is_lora_leaf),
                         (lora.default_trainable, jlora.default_trainable)):
        got = lora.communicated_fraction(tp, tpred)
        assert got == jlora.communicated_fraction(jp, jpred)
        assert 0.0 < got < 1.0


def test_mma_matches_jax():
    """Eq. 13 weights and the stacked mean, f32 and bf16 uploads: 1e-7 /
    bit-equal."""
    counts = [3, 1, 2]
    np.testing.assert_allclose(_np(mma.aggregation_weights(counts)),
                               np.asarray(jmma.aggregation_weights(counts)))
    w = np.array(jmma.aggregation_weights(counts))
    rng = np.random.RandomState(1)
    ups = {"x_lora_a": rng.randn(3, 6, 4).astype(np.float32),
           "x_lora_b": rng.randn(3, 4, 5).astype(np.float32)}
    for jdt, tdt in ((jnp.float32, torch.float32),
                     (jnp.bfloat16, torch.bfloat16)):
        jout = jmma.aggregate_stacked(
            {k: jnp.asarray(v, jdt) for k, v in ups.items()}, w)
        tout = mma.aggregate_stacked({k: _t(v, tdt) for k, v in ups.items()},
                                     torch.from_numpy(w))
        for k in ups:
            assert tout[k].dtype == tdt
            np.testing.assert_allclose(_np(tout[k]), _np(jout[k]), atol=1e-7)
    listed = mma.aggregate([{k: _t(v[j]) for k, v in ups.items()}
                            for j in range(3)], torch.from_numpy(w))
    jlisted = jmma.aggregate([{k: jnp.asarray(v[j]) for k, v in ups.items()}
                              for j in range(3)], w)
    for k in ups:
        np.testing.assert_allclose(_np(listed[k]), _np(jlisted[k]), atol=1e-6)
    with pytest.raises(NotImplementedError):
        mma.aggregate_stacked({k: _t(v) for k, v in ups.items()},
                              torch.from_numpy(w), robust="trimmed_mean")


def test_pooled_kl_unequal_lengths_and_vocab():
    """Sequence and vocab pooled to the smaller of the two; the teacher
    gets no gradient.  f32, 1e-5."""
    rng = np.random.RandomState(2)
    s = rng.randn(2, 10, 37).astype(np.float32)
    t = rng.randn(2, 7, 50).astype(np.float32)
    jl, jg = jax.value_and_grad(jseccl.kt_loss)(jnp.asarray(s),
                                                jnp.asarray(t))
    ts, tt = _t(s, grad=True), _t(t, grad=True)
    tl = seccl.kt_loss(ts, tt)
    tl.backward()
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5)
    np.testing.assert_allclose(_np(ts.grad), np.asarray(jg), atol=1e-6)
    assert tt.grad is None or float(tt.grad.abs().max()) == 0.0
    np.testing.assert_allclose(
        float(seccl.pooled_kl(_t(t), _t(s))),
        float(jseccl.pooled_kl(jnp.asarray(t), jnp.asarray(s))), rtol=1e-5)


def test_eval_step_on_padded_tail_batch(corpus):
    """The eval sums of a tail batch padded with zero-validity rows: equal
    to the reference's (f32, 1e-5 relative); the padding adds nothing."""
    jb, jp, tb, tp = unified_pair(toy_cfg())
    data = {k: v[:13] for k, v in corpus.items() if k != "templates"}
    mask = np.array([True, True, False])
    tail = list(jpipe.np_eval_batches(data, 8, mask))[-1]
    assert tail["row_valid"].sum() == 5
    jout = jseccl.make_eval_step(jb)(
        jp, {k: jnp.asarray(v) for k, v in tail.items()})
    tout = seccl.make_eval_step(tb)(tp, pipeline.to_tensors(tail, "cpu"))
    for k in seccl.EVAL_SUM_KEYS:
        np.testing.assert_allclose(float(tout[k]), float(jout[k]), rtol=1e-5)
    valid = dict(tail, row_valid=np.ones(8, np.float32))
    vout = seccl.make_eval_step(tb)(tp, pipeline.to_tensors(valid, "cpu"))
    assert float(vout["weight"]) > float(tout["weight"])
    m = seccl.metrics_from_sums({k: float(v) for k, v in tout.items()})
    assert m == jseccl.metrics_from_sums({k: float(v)
                                          for k, v in jout.items()})


@pytest.mark.parametrize("kind", ["ccl", "amt"])
def test_local_step_matches_jax(corpus, kind):
    """One make_local_step CCL step (server anchor, volume score) or AMT
    step (prox pull): the updated trainable leaves and the moments.
    f32; AdamW's first step moves each leaf by about lr * sign(g), so
    leaves agree to 1e-5 and the loss to 1e-5 relative."""
    jb, jp, tb, tp = unified_pair(toy_cfg(), seed=1)
    b = batch_np(corpus, mask=np.array([True, True, False]))
    jbatch = {k: jnp.asarray(v) for k, v in b.items()}
    tbatch = pipeline.to_tensors(b, "cpu")
    lr = 1e-3
    if kind == "ccl":
        anc = np.random.RandomState(5).randn(8, 48).astype(np.float32)
        jstep = jccl.make_local_step(jb, jadamw(lr), ccl_weight=0.5,
                                     n_negatives=4)
        tstep = ccl.make_local_step(tb, adamw(lr), ccl_weight=0.5,
                                    n_negatives=4)
        jargs, targs = (jnp.asarray(anc),), (_t(anc),)
    else:
        ref = {k: v * 0.5 for k, v in flat_numpy(
            jlora.partition(jp, jlora.is_lora_leaf)).items()}
        jstep = jccl.make_local_step(jb, jadamw(lr), ccl_weight=0.0,
                                     with_anchor=False, prox_weight=0.1)
        tstep = ccl.make_local_step(tb, adamw(lr), ccl_weight=0.0,
                                    with_anchor=False, prox_weight=0.1)
        jargs = (None, {k: jnp.asarray(v) for k, v in ref.items()})
        targs = (None, {k: _t(v) for k, v in ref.items()})
    jtrain = jlora.partition(jp)
    jnew, jopt, jm = jstep(jp, jadamw(lr).init(jtrain), jbatch, *jargs)
    tnew, topt, tm = tstep(tp, adamw(lr).init(lora.partition(tp)), tbatch,
                           *targs)
    np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                               rtol=1e-5)
    if kind == "ccl":
        np.testing.assert_allclose(float(tm["ccl"]), float(jm["ccl"]),
                                   rtol=1e-5)
    jflat = flat_numpy(jlora.partition(jnew))
    tflat = lora.partition(tnew)
    assert sorted(jflat) == sorted(tflat)
    for k in jflat:
        np.testing.assert_allclose(_np(tflat[k]), jflat[k], atol=1e-5,
                                   err_msg=k)
        np.testing.assert_allclose(_np(topt["mu"][k]),
                                   np.asarray(jopt["mu"][k]), atol=1e-6,
                                   err_msg=k)
    # the frozen backbone is shared, not copied
    frozen = [k for k in lora.flatten(tp) if not lora.default_trainable(k)]
    assert all(lora.flatten(tnew)[k] is lora.flatten(tp)[k] for k in frozen)


# ---------------------------------------------------------------------------
# kernel B's gradient, and the kernels' autograd wrappers

@pytest.mark.parametrize("window", [0, 4])
def test_attention_gradient_matches_jax(window):
    """B's plain version (what the interim backward differentiates) against
    jax.grad of the reference's ``layers.mha`` under the causal / window
    mask, GQA; f32, 1e-5."""
    rng = np.random.RandomState(7)
    B, S, H, K, D = 2, 9, 4, 2, 8
    q = rng.randn(B, S, H, D).astype(np.float32)
    k = rng.randn(B, S, K, D).astype(np.float32)
    v = rng.randn(B, S, K, D).astype(np.float32)
    g = rng.randn(B, S, H * D).astype(np.float32)
    pos = jnp.broadcast_to(jnp.arange(S), (B, S))
    mask = jlayers.causal_window_mask(pos, pos, window or jlayers.BIG_WINDOW)

    def jfn(qq, kk, vv):
        return jnp.sum(jlayers.mha(qq, kk, vv, mask[:, None]) * g)
    jg = jax.grad(jfn, argnums=(0, 1, 2))(*(jnp.asarray(a)
                                            for a in (q, k, v)))
    ins = [_t(a, grad=True) for a in (q, k, v)]
    (ops.attention(*ins, causal=True, window=window) * _t(g)).sum().backward()
    for got, want in zip(ins, jg):
        np.testing.assert_allclose(_np(got.grad), np.asarray(want),
                                   atol=1e-5)


def test_kernel_autograd_wrappers_with_plain_launches(monkeypatch):
    """The autograd Functions the card runs (forward and dx through kernel
    C with W read transposed, f32 dA/dB; D's backward entry; B's forward
    with its log-sum-exp and B's backward entry), driven on the CPU with
    every launch replaced by the plain version: their gradients equal the
    plain versions' autograd (f32, 1e-5), and a frozen W that asks for a
    gradient is refused."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import gram_volume as gv
    from repro_torch.kernels import lora_matmul as lm

    def lora_launch(x, w, a, b, scale, trans_w=False):
        return lm.lora_matmul_plain(x, w.t() if trans_w else w, a, b, scale)

    def gram_bwd_launch(vs, mask, gout, eps=1e-5):
        with torch.enable_grad():
            v = vs.detach().requires_grad_(True)
            return torch.autograd.grad(gv.gram_log_volume_plain(v, mask, eps),
                                       v, gout)[0]
    monkeypatch.setattr(lm, "lora_matmul_cuda", lora_launch)
    monkeypatch.setattr(gv, "gram_log_volume_cuda", gv.gram_log_volume_plain)
    monkeypatch.setattr(gv, "gram_log_volume_backward_cuda", gram_bwd_launch)
    monkeypatch.setattr(fa, "flash_attention_cuda", fa.flash_attention_plain)
    monkeypatch.setattr(fa, "flash_attention_backward_cuda",
                        fa.flash_attention_backward_plain)

    x, w, a, b = (_t(v) for v in _lora_np(21, 30, 17, 4, seed=3))
    dy = _t(np.random.RandomState(4).randn(21, 17))
    grads = []
    for fn in (lm.lora_matmul_autograd, lora_matmul_plain):
        ins = [t.clone().requires_grad_(True) for t in (x, a, b)]
        fn(ins[0], w, ins[1], ins[2], 2.0).backward(dy)
        grads.append([t.grad for t in ins])
    for got, want in zip(*grads):
        np.testing.assert_allclose(_np(got), _np(want), atol=1e-5)
    with pytest.raises(NotImplementedError, match="frozen"):
        lm.lora_matmul_autograd(x, w.clone().requires_grad_(True), a, b, 2.0)

    vs, mask = _gram_np(6, 4, 20, seed=5)
    gout = _t(np.random.RandomState(6).randn(6))
    grads = []
    for fn in (gv.gram_log_volume_autograd, gram_log_volume_plain):
        v = _t(vs, grad=True)
        fn(v, torch.from_numpy(mask)).backward(gout)
        grads.append(v.grad)
    np.testing.assert_allclose(_np(grads[0]), _np(grads[1]), atol=1e-5)

    rng = np.random.RandomState(8)
    q, k, v = (_t(rng.randn(2, 7, h, 8)) for h in (4, 2, 2))
    do = _t(rng.randn(2, 7, 4, 8))
    grads = []
    for fn in (fa.flash_attention_autograd, fa.flash_attention_plain):
        ins = [q.clone().requires_grad_(True), k.clone(),
               v.clone().requires_grad_(True)]      # no gradient for k
        fn(*ins, causal=True, window=3).backward(do)
        grads.append([ins[0].grad, ins[2].grad])
        assert ins[1].grad is None
    for got, want in zip(*grads):
        np.testing.assert_allclose(_np(got), _np(want), atol=1e-5)
