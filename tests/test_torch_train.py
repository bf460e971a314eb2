"""Port parity for the trainer (``repro_torch.launch.train``) and what it
reaches: ``per_example_ce``, ``per_example_ce_chunked``,
``mlecs_train_loss`` on both CE paths, ``make_train_step`` (AdamW, SGD
with and without momentum; LoRA-only and full fine-tune), ``sgd``'s
stacked update, ``lora.all_trainable``, the ``batches`` / ``np_batches``
/ ``eval_batches`` iterators, ``run_training`` on the CPU, and kernel C's
autograd with a W that needs a gradient (dW), each against the JAX
package on the same numpy inputs and weights (the JAX init carried over
by ``interop``), at the toy size of tests/conftest.py::toy_cfg, f32.

Tolerances: losses and metrics 1e-5; gradients and updated leaves 1e-4
of each row's largest |value| (AdamW's first steps move each element by
about lr * sign(g), so a leaf agrees only as far as its gradient's
rounding lets the sign agree).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import lora as jlora
from repro.data import pipeline as jpipe
from repro.launch import train as jtrain
from repro.optim.adamw import adamw as jadamw
from repro.optim.adamw import sgd as jsgd
from repro_torch.checkpointing import CheckpointManager
from repro_torch.core import lora
from repro_torch.data import pipeline
from repro_torch.data.synthetic import synthetic_multimodal_corpus
from repro_torch.kernels import lora_matmul as lm
from repro_torch.launch import train
from repro_torch.models.model import build_model
from repro_torch.optim.adamw import adamw, sgd
from test_torch_training import _np, _t, flat_numpy, toy_cfg, unified_pair

torch.set_num_threads(1)

F32 = dict(atol=1e-5, rtol=1e-5)
ROW_TOL = 1e-4
B, S = 4, 12


def rows_close(got, want, name, tol=ROW_TOL):
    """Each row (last axis) of ``got`` within ``tol`` of the row's largest
    |want| (an all-zero row: of 1e-6 of the leaf's largest; an all-zero
    leaf must be matched exactly)."""
    g, w = _np(got), np.asarray(want, np.float32)
    if g.ndim == 0:
        g, w = g[None], w[None]
    g, w = g.reshape(-1, g.shape[-1]), w.reshape(-1, w.shape[-1])
    top = np.abs(w).max()
    if top == 0:
        assert np.array_equal(g, w), name
        return
    scale = np.maximum(np.abs(w).max(1, keepdims=True), 1e-6 * top)
    err = float((np.abs(g - w) / scale).max())
    assert err <= tol, (name, err)


@pytest.fixture(scope="module")
def corpus():
    return synthetic_multimodal_corpus(0, 96, S, 128, n_classes=4,
                                       n_modalities=3, modality_dim=32,
                                       template_len=4)


def batch_np(corpus, anchor=True, seed=3):
    """B rows of the corpus with mixed modality masks, a partial loss
    mask, and (optionally) a server anchor (B, 48)."""
    rng = np.random.RandomState(seed)
    idx = rng.permutation(corpus["tokens"].shape[0])[:B]
    b = jpipe._gather_np(corpus, idx, None)
    b["modality_mask"] = np.array([[1, 0, 1], [1, 1, 1], [0, 1, 1],
                                   [1, 1, 0]], bool)[:B]
    b["modality_feats"] = b["modality_feats"] * b["modality_mask"][..., None]
    b["loss_mask"] = (rng.rand(B, S) > 0.3).astype(np.float32)
    if anchor:
        b["anchor"] = rng.randn(B, 48).astype(np.float32)
    return b


def pair(jcfg):
    """(JAX bundle, JAX params, port bundle, port params) from one JAX
    init, LoRA B non-zero."""
    return unified_pair(jcfg, seed=1)


# ---------------------------------------------------------------------------
# the CE paths

def test_per_example_ce_matches_reference():
    """Logits behind a prefix of 3, a partial loss mask with one row fully
    masked (its CE is 0, not NaN)."""
    rng = np.random.RandomState(0)
    logits = rng.randn(3, 3 + 9, 40).astype(np.float32)
    toks = rng.randint(0, 40, (3, 9)).astype(np.int32)
    mask = (rng.rand(3, 9) > 0.4).astype(np.float32)
    mask[2] = 0
    want = jtrain.per_example_ce(jnp.asarray(logits), jnp.asarray(toks),
                                 jnp.asarray(mask))
    got = train.per_example_ce(_t(logits), torch.from_numpy(toks).long(),
                               _t(mask))
    assert got.shape == (3,) and float(got[2]) == 0.0
    np.testing.assert_allclose(_np(got), np.asarray(want), **F32)


def test_per_example_ce_chunked_values_and_hidden_grads():
    """``loss_chunk`` 7 over S = 33 (32 predicted positions: 5 chunks, the
    last padded), behind a soft prompt of 4: values, and gradients with
    respect to the hidden states against ``jax.grad`` (row by row), equal
    to the full CE path's."""
    jcfg = toy_cfg(vocab_size=512, loss_chunk=7, loss_impl="chunked")
    jb, jp, tb, tp = pair(jcfg)
    rng = np.random.RandomState(2)
    Sl = 33
    hid = (rng.randn(2, 4 + Sl, 64) * 0.5).astype(np.float32)
    toks = rng.randint(0, 512, (2, Sl)).astype(np.int32)
    mask = (rng.rand(2, Sl) > 0.3).astype(np.float32)
    gout = rng.randn(2).astype(np.float32)

    def jfn(h):
        return jnp.sum(jtrain.per_example_ce_chunked(
            jp, jb, h, jnp.asarray(toks), jnp.asarray(mask))
            * jnp.asarray(gout))
    jv = jtrain.per_example_ce_chunked(jp, jb, jnp.asarray(hid),
                                       jnp.asarray(toks), jnp.asarray(mask))
    jg = jax.grad(jfn)(jnp.asarray(hid))
    h = _t(hid, grad=True)
    tv = train.per_example_ce_chunked(tp, tb, h, torch.from_numpy(toks),
                                      _t(mask))
    (tv * _t(gout)).sum().backward()
    np.testing.assert_allclose(_np(tv), np.asarray(jv), **F32)
    rows_close(h.grad, jg, "d hidden")
    # the full path on the same hidden states
    from repro_torch.models.layers import unembed
    h2 = _t(hid, grad=True)
    full = train.per_example_ce(unembed(tp["tok"], tb.cfg, h2),
                                torch.from_numpy(toks), _t(mask))
    (full * _t(gout)).sum().backward()
    np.testing.assert_allclose(_np(full), _np(tv), **F32)
    rows_close(h2.grad, h.grad, "d hidden, full vs chunked", tol=1e-5)


LOSS_CASES = [  # (loss_impl, use_mma_weights, anchor, ccl_weight)
    ("full", True, True, 0.5),
    ("chunked", True, True, 0.5),
    ("full", False, False, 0.5),
    ("chunked", False, False, 0.5),
    ("full", True, False, 0.0),
    ("chunked", False, True, 0.0),
]


@pytest.mark.parametrize("impl,mma,anchor,ccl_weight", LOSS_CASES)
def test_mlecs_train_loss_and_grads_match_reference(corpus, impl, mma,
                                                    anchor, ccl_weight):
    """Loss and metrics (1e-5) and the LoRA / connector gradients against
    ``jax.grad`` row by row (1e-4), on the full and the chunked CE
    (``loss_chunk`` 5 over 11 predicted positions), with and without the
    MMA weights, with a server anchor and with the model's own fused
    representation, at ``ccl_weight`` 0.5 and 0."""
    jcfg = toy_cfg(loss_impl=impl, loss_chunk=5)
    jb, jp, tb, tp = pair(jcfg)
    b = batch_np(corpus, anchor=anchor)
    jbatch = {k: jnp.asarray(v) for k, v in b.items()}
    kw = dict(ccl_weight=ccl_weight, n_negatives=3, use_mma_weights=mma)
    jtr = jlora.partition(jp)

    def jfn(t):
        return jtrain.mlecs_train_loss(jlora.combine(jp, t), jb, jbatch,
                                       **kw)
    (jl, jm), jg = jax.jit(jax.value_and_grad(jfn, has_aux=True))(jtr)
    tr = {k: v.detach().requires_grad_(True)
          for k, v in lora.partition(tp).items()}
    tl, tm = train.mlecs_train_loss(lora.combine(tp, tr), tb,
                                    pipeline.to_tensors(b, "cpu"), **kw)
    assert sorted(tm) == sorted(jm)
    assert ("ccl" in tm) == (ccl_weight > 0)
    for k in jm:
        np.testing.assert_allclose(float(tm[k].detach()), float(jm[k]),
                                   **F32, err_msg=k)
    tg = torch.autograd.grad(tl, list(tr.values()), allow_unused=True)
    for (k, v), g in zip(tr.items(), tg):
        rows_close(torch.zeros_like(v) if g is None else g,
                   jg[k], k)


# ---------------------------------------------------------------------------
# the step and the optimizers

# AdamW at eps 1e-6: at its default 1e-8 an element whose gradient is
# f32 noise (~1e-9 against a row's ~1e-3, e.g. in gelu's tail, where the
# packages' derivatives round differently) moves by ~0.1 lr in one package
# and ~0 in the other, which a comparison of steps cannot tell from a fault
OPTS = {"adamw": (adamw, jadamw, {"eps": 1e-6}),
        "sgd": (sgd, jsgd, {}),
        "sgd_momentum": (sgd, jsgd, {"momentum": 0.9})}


@pytest.mark.parametrize("full_finetune", [False, True])
@pytest.mark.parametrize("opt", list(OPTS))
def test_train_steps_match_reference(corpus, opt, full_finetune):
    """Three ``make_train_step`` steps (AdamW at lr 1e-3; SGD at 0.05)
    against the
    reference's jitted step on the same batches: the metrics of each step,
    then every leaf row by row (1e-4); in LoRA mode the frozen leaves are
    the input's tensors, untouched."""
    make, jmake, kw = OPTS[opt]
    lr = 1e-3 if opt == "adamw" else 0.05
    jb, jp, tb, tp = pair(toy_cfg())
    topt, jopt = make(lr, **kw), jmake(lr, **kw)
    pred = lora.all_trainable if full_finetune else lora.default_trainable
    jpred = jlora.all_trainable if full_finetune else jlora.default_trainable
    jstep = jax.jit(jtrain.make_train_step(jb, jopt, full_finetune,
                                           n_negatives=3))
    tstep = train.make_train_step(tb, topt, full_finetune, n_negatives=3)
    js, ts = jopt.init(jlora.partition(jp, jpred)), \
        topt.init(lora.partition(tp, pred))
    t0 = lora.flatten(tp)
    t0_bits = {k: v.clone() for k, v in t0.items()}
    for i in range(3):
        b = batch_np(corpus, seed=10 + i)
        jp, js, jm = jstep(jp, js, {k: jnp.asarray(v) for k, v in b.items()})
        tp, ts, tm = tstep(tp, ts, pipeline.to_tensors(b, "cpu"))
        for k in jm:
            np.testing.assert_allclose(float(tm[k]), float(jm[k]), **F32,
                                       err_msg=f"step {i} {k}")
    assert int(ts["step"]) == 3
    jflat, tflat = flat_numpy(jp), lora.flatten(tp)
    assert sorted(jflat) == sorted(tflat)
    for k in jflat:
        rows_close(tflat[k], jflat[k], k)
    for k, v in tflat.items():
        if pred(k):
            assert not torch.equal(v, t0_bits[k]), k
        else:
            assert v is t0[k] and torch.equal(v, t0_bits[k]), k


@pytest.mark.parametrize("momentum", [0.0, 0.9])
def test_sgd_update_stacked_equals_per_client_updates(momentum):
    """``sgd``'s ``update_stacked`` over G = 3 clients whose step counts
    differ and whose schedule reads the step: each client's updates and
    moment equal its own ``update`` bit for bit."""
    rng = np.random.RandomState(0)
    G = 3
    shapes = {"l/wq_lora_a": (2, 6, 4), "connector/proj_w": (3, 5, 6)}
    grads = {k: _t(rng.randn(G, *s)) for k, s in shapes.items()}
    params = {k: _t(rng.randn(G, *s)) for k, s in shapes.items()}
    opt = sgd(lambda step: 0.1 / step.float(), momentum=momentum)
    states = []
    for g in range(G):
        st = opt.init({k: v[g] for k, v in params.items()})
        for _ in range(g):
            _, st = opt.update({k: v[g] for k, v in grads.items()}, st,
                               {k: v[g] for k, v in params.items()})
        states.append(st)
    stacked = lora.stack_trees(states)
    assert stacked["step"].tolist() == [0, 1, 2]
    u, st = opt.update_stacked(grads, stacked, params)
    assert st["step"].tolist() == [1, 2, 3]
    for g in range(G):
        ug, sg = opt.update({k: v[g] for k, v in grads.items()}, states[g],
                            {k: v[g] for k, v in params.items()})
        for k in shapes:
            assert torch.equal(u[k][g], ug[k]), k
            if momentum:
                assert torch.equal(st["mu"][k][g], sg["mu"][k]), k
    assert ("mu" in st) == bool(momentum)


def test_all_trainable_selects_every_leaf():
    jb, jp, tb, tp = pair(toy_cfg())
    got = lora.partition(tp, lora.all_trainable)
    assert sorted(got) == sorted(jlora.partition(jp, jlora.all_trainable))
    assert sorted(got) == sorted(lora.flatten(tp))
    assert all(lora.all_trainable(k) for k in ("tok/embed", "x"))


# ---------------------------------------------------------------------------
# the batch iterators

@pytest.mark.parametrize("kind", ["batches", "np_batches", "eval_batches"])
def test_batch_iterators_are_bit_equal_to_reference(corpus, kind):
    """The first batches (train: 30, past the end of an epoch; eval: every
    batch, the padded tail included) under a modality mask, leaf for
    leaf; the tensor iterators' leaves lie on the device asked for."""
    mask = np.array([True, False, True])
    if kind == "eval_batches":
        got = list(pipeline.eval_batches(corpus, 10, mask, device="cpu"))
        want = list(jpipe.eval_batches(corpus, 10, mask))
        assert len(got) == len(want) == 10
    else:
        tit = getattr(pipeline, kind)(corpus, 8, seed=4, modality_mask=mask,
                                      **({"device": "cpu"} if kind ==
                                         "batches" else {}))
        jit_ = getattr(jpipe, kind)(corpus, 8, seed=4, modality_mask=mask)
        got = [next(tit) for _ in range(30)]
        want = [next(jit_) for _ in range(30)]
    for g, w in zip(got, want):
        assert sorted(g) == sorted(w)
        for k in w:
            a = g[k].numpy() if isinstance(g[k], torch.Tensor) else g[k]
            if kind != "np_batches":
                assert isinstance(g[k], torch.Tensor) and \
                    g[k].device.type == "cpu"
            np.testing.assert_array_equal(a, np.asarray(w[k]), err_msg=k)


# ---------------------------------------------------------------------------
# the host loop

def test_run_training_on_cpu(corpus, tmp_path, capsys):
    """30 steps of ``run_training`` on the CPU over ``np_batches`` (numpy
    batches moved to the device): a history row and a printed line at
    every 10th step and the last, the CE falls, and the checkpoint
    restores the returned params bit for bit."""
    from repro_torch.configs.base import ModelConfig
    cfg = ModelConfig(**dataclasses.asdict(toy_cfg()))
    bundle = build_model(cfg)
    it = pipeline.np_batches(corpus, 8, seed=0)
    params, hist = train.run_training(bundle, it, 30, lr=3e-3, log_every=10,
                                      seed=0, checkpoint_dir=str(tmp_path),
                                      device="cpu")
    assert [h["step"] for h in hist] == [0, 10, 20, 29]
    assert sorted(hist[0]) == ["aux", "ccl", "ce", "loss", "step"]
    lines = [ln for ln in capsys.readouterr().out.splitlines()
             if ln.startswith("step ")]
    assert len(lines) == 4 and lines[-1].startswith("step    29  aux=")
    assert hist[-1]["ce"] < hist[0]["ce"] - 0.1
    mgr = CheckpointManager(str(tmp_path))
    like = {k: torch.zeros_like(v) for k, v in lora.flatten(params).items()}
    got = mgr.restore(lora.unflatten(like))
    for k, v in lora.flatten(params).items():
        assert torch.equal(lora.flatten(got)[k], v), k


# ---------------------------------------------------------------------------
# kernel C's autograd with dW

def test_lora_autograd_dw_with_plain_launches(monkeypatch):
    """``_LoraMatmul`` with every launch replaced by the plain version
    and W asking for a gradient (a full fine-tune): dx, dW, dA and dB
    equal the plain version's autograd (f32, 1e-5); the LoRA term adds
    nothing to dW."""
    def lora_launch(x, w, a, b, scale, trans_w=False):
        return lm.lora_matmul_plain(x, w.t() if trans_w else w, a, b, scale)
    monkeypatch.setattr(lm, "lora_matmul_cuda", lora_launch)
    rng = np.random.RandomState(3)
    x, w, a, b = (_t(rng.randn(*s)) for s in ((21, 30), (30, 17), (30, 4),
                                              (4, 17)))
    dy = _t(rng.randn(21, 17))
    grads = []
    for fn in (lm.lora_matmul_autograd, lm.lora_matmul_plain):
        ins = [t.clone().requires_grad_(True) for t in (x, w, a, b)]
        fn(*ins, 2.0).backward(dy)
        grads.append([t.grad for t in ins])
    for got, want in zip(*grads):
        np.testing.assert_allclose(_np(got), _np(want), atol=1e-5)
    np.testing.assert_allclose(_np(grads[0][1]), _np(x.t() @ dy), atol=1e-5)
