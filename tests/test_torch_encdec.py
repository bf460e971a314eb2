"""Port parity for the encdec family (whisper): ``sinusoid``, the encoder,
the cross K/V, the teacher-forced decoder, the forward and ``lm_loss``
with their LoRA gradients, a local step with modality features (CCL on
the connector, no soft prompt) and the stacked step, the ring ``prefill`` / ``decode_step`` and
``generate``, the paged contract and the engine, each against the JAX
package on the same weights (made by the JAX init, LoRA B filled from a
numpy seed, carried over by ``interop``) at the toy size of
tests/test_serving.py (2 + 2 layers, d 32, 16 frames of 24, LoRA on wq
and wv as whisper-medium's).

Tolerances: float32 2e-4, gradients 1e-4 of each row's largest |value|;
bf16 (the forward only) no farther from the reference's float32 logits
than the reference's own bf16 ones (1.25x, as tests/test_torch_ssm.py
holds a bf16 stack).  With no soft prompt the encdec family has no
prefix (its frames feed the encoder), so the reference's ``generate`` is
the oracle as it is (fault 3.8 does not arise).
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_stacked_cases import (client_batches, multimodal,
                                  stacked_step_against_reference)
from repro.core import ccl as jccl
from repro.core import lora as jlora
from repro.launch import serve as jserve
from repro.launch.serve_engine import EngineConfig as JEngineConfig
from repro.launch.serve_engine import ServingEngine as JEngine
from repro.models import encdec as jencdec
from repro.optim.adamw import adamw as jadamw
from repro_torch.core import ccl, lora
from repro_torch.launch import serve
from repro_torch.launch.serve_engine import EngineConfig, ServingEngine
from repro_torch.models import encdec
from repro_torch.optim.adamw import adamw
from test_torch_moe import rows_close
from test_torch_serving import (flat_numpy, port_pair, serving_cfg,
                                strip_adapters)
from test_torch_ssm import f32_reference, hold

torch.set_num_threads(1)

F32 = dict(atol=2e-4, rtol=2e-4)
B, S, K = 2, 12, 3
T_FRAMES = 16


def encdec_cfg(dtype="float32", **kw):
    """tests/test_serving.py's encdec toy, LoRA on wq and wv."""
    return serving_cfg(family="encdec", n_enc_layers=2, frontend="audio",
                       frontend_tokens=T_FRAMES, frontend_dim=24,
                       activation="gelu", lora_targets=("wq", "wv"),
                       dtype=dtype, **kw)


def _np(x):
    return x.detach().float().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x, np.float32)


def inputs(jcfg, rows=B, n=S + K, seed=7):
    """Tokens (rows, n) int32 and frames (rows, T, F) float32."""
    rng = np.random.RandomState(seed)
    toks = rng.randint(0, jcfg.vocab_size, (rows, n)).astype(np.int32)
    fe = (rng.randn(rows, T_FRAMES, jcfg.frontend_dim) * 0.5).astype(
        np.float32)
    return toks, fe


@functools.lru_cache(maxsize=None)
def jitted(jcfg):
    """The reference's encode, encode_cross_kv, decode_forward (with the
    kv) and its bundle's logits / prefill / decode_step, each jitted
    once."""
    jb = port_pair(jcfg)[0]
    return dict(
        encode=jax.jit(lambda p, f: jencdec.encode(p, jcfg, f)),
        cross=jax.jit(lambda p, e: jencdec.encode_cross_kv(p, jcfg, e)),
        decode=jax.jit(lambda p, t, e: jencdec.decode_forward(
            p, jcfg, t, e, collect_kv=True)),
        logits=jax.jit(jb.logits), prefill=jax.jit(jb.prefill),
        step=jax.jit(jb.decode_step))


# ---------------------------------------------------------------------------
# the pieces and the forward

@pytest.mark.parametrize("T,d", [(16, 32), (1536, 1024)])
def test_sinusoid_matches_reference(T, d):
    want = jencdec.sinusoid(T, d, jnp.float32)
    got = encdec.sinusoid(T, d, torch.float32)
    # at whisper-medium's 1,536 frames the angles reach 1,535 rad, whose
    # float32 ulp (1.2e-4) bounds the difference of the two sin / cos
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-4,
                               rtol=0)


def test_encoder_cross_kv_and_decoder_match_reference():
    """``encode``, ``encode_cross_kv`` and ``decode_forward`` (logits and
    the collected self-attention K/V, and the cross K/V it collects)."""
    jcfg = encdec_cfg()
    _, jp, tb, tp = port_pair(jcfg)
    fn = jitted(jcfg)
    toks, fe = inputs(jcfg)
    jenc = fn["encode"](jp, jnp.asarray(fe))
    jxk, jxv = fn["cross"](jp, jenc)
    jlogits, (jk, jv) = fn["decode"](jp, jnp.asarray(toks), jenc)
    cfg = tb.cfg
    with torch.no_grad():
        enc = encdec.encode(tp, cfg, torch.from_numpy(fe))
        xk, xv = encdec.encode_cross_kv(tp, cfg, enc)
        logits, kv = encdec.decode_forward(tp, cfg,
                                           torch.from_numpy(toks).long(),
                                           enc, collect_kv=True)
    assert enc.shape == (B, T_FRAMES, cfg.d_model)
    for got, want in ((enc, jenc), (xk, jxk), (xv, jxv), (logits, jlogits),
                      (kv[0], jk), (kv[1], jv), (kv[2], jxk), (kv[3], jxv)):
        assert tuple(got.shape) == tuple(want.shape)
        np.testing.assert_allclose(_np(got), _np(want), **F32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_forward_and_loss_match_reference(dtype):
    """The bundle's logits (aux 0) and ``lm_loss``; bf16 held against the
    reference's float32 logits as close as its own bf16 ones are."""
    jcfg = encdec_cfg(dtype)
    jb, jp, tb, tp = port_pair(jcfg)
    toks, fe = inputs(jcfg)
    jbatch = {"tokens": jnp.asarray(toks), "frontend_embeds": jnp.asarray(fe)}
    tbatch = {"tokens": torch.from_numpy(toks).long(),
              "frontend_embeds": torch.from_numpy(fe)}
    want, waux = jitted(jcfg)["logits"](jp, jbatch)
    with torch.no_grad():
        got, aux = tb.logits(tp, tbatch)
        loss, m = tb.lm_loss(tp, tbatch)
    assert float(aux) == float(waux) == 0.0
    assert got.shape == (B, S + K, 256)
    wloss, _ = jb.lm_loss(jp, jbatch)
    if dtype == "float32":
        np.testing.assert_allclose(_np(got), _np(want), **F32)
        np.testing.assert_allclose(float(loss), float(wloss), **F32)
        return
    jb32, jcfg32, jp32 = f32_reference(jcfg, jp)
    want32, _ = jb32.logits(jp32, jbatch)
    hold(got, want, want32, "bf16 logits")
    np.testing.assert_allclose(float(loss), float(wloss), rtol=2e-2)


@pytest.mark.parametrize("remat", [False, True])
def test_lora_grads_match_reference(remat):
    """The gradients of ``lm_loss`` with respect to the LoRA leaves (wq,
    wv of the encoder's and the decoder's self-attention) against
    ``jax.grad``, row by row."""
    jcfg = encdec_cfg(remat=remat)
    jb, jp, tb, tp = port_pair(jcfg)
    toks, fe = inputs(jcfg, seed=3)
    jbatch = {"tokens": jnp.asarray(toks), "frontend_embeds": jnp.asarray(fe)}
    jtrain = jlora.partition(jp, jlora.is_lora_leaf)

    def jfn(t):
        return jb.lm_loss(jlora.combine(jp, t), jbatch)[0]
    jl, jg = jax.jit(jax.value_and_grad(jfn))(jtrain)
    train = {k: v.detach().requires_grad_(True)
             for k, v in lora.partition(tp, lora.is_lora_leaf).items()}
    tl, _ = tb.lm_loss(lora.combine(tp, train),
                       {"tokens": torch.from_numpy(toks).long(),
                        "frontend_embeds": torch.from_numpy(fe)})
    tg = ccl.grads_of(tl, train)
    assert sorted(tg) == sorted(jg) and len(tg) == 8
    np.testing.assert_allclose(float(tl.detach()), float(jl), **F32)
    for k in jg:
        rows_close(tg[k], jg[k], k)


def test_bundle_refuses_what_encdec_does_not_take():
    """No soft prompt, frames required; no hidden.  The stacked forms take
    the family: one client's stack equals the unstacked call."""
    _, _, tb, tp = port_pair(encdec_cfg())
    toks, fe = inputs(encdec_cfg())
    t, f = torch.from_numpy(toks).long(), torch.from_numpy(fe)
    assert tb.hidden is None
    pers = lora.stack_clients([lora.partition(tp)])
    stacked = lora.combine(tp, pers)
    got, aux = tb.logits_stacked(stacked, {"tokens": t[None],
                                           "frontend_embeds": f[None]})
    want, _ = tb.logits(tp, {"tokens": t, "frontend_embeds": f})
    np.testing.assert_allclose(_np(got[0]), _np(want), atol=1e-6)
    loss, m = tb.lm_loss_stacked(stacked, {"tokens": t[None],
                                           "frontend_embeds": f[None]})
    assert loss.shape == m["aux"].shape == (1,)
    with pytest.raises(ValueError, match="soft"):
        tb.logits(tp, {"tokens": t, "frontend_embeds": f,
                       "prefix_embeds": torch.zeros((B, 2, 32))})
    with pytest.raises(ValueError, match="soft"):
        tb.logits_stacked(stacked, {"tokens": t[None],
                                    "frontend_embeds": f[None],
                                    "prefix_embeds": torch.zeros((1, B, 2,
                                                                  32))})
    with pytest.raises(ValueError, match="frontend_embeds"):
        tb.logits(tp, {"tokens": t})


def test_local_step_with_modality_features_matches_reference():
    """One ``make_local_step`` CCL step (server anchor) on the encdec toy
    with modality features against the reference's (whose bundle drops
    the soft prompt unread): the loss and CCL term (1e-5 relative), every
    trainable leaf after the AdamW step (1e-5); the soft-prompt leaves
    (``spg_scale``, ``spg_bias``, ``spg_w1``) take a zero gradient and stay
    where they were, in both packages, while the modality projectors
    move."""
    jcfg = multimodal(encdec_cfg())
    jb, jp, tb, tp = port_pair(jcfg, unified=True)
    b, anchor = client_batches(jcfg, 1, B, S, seed=5)
    b, anchor = {k: v[0] for k, v in b.items()}, anchor[0]
    jstep = jccl.make_local_step(jb, jadamw(1e-3), n_negatives=1)
    tstep = ccl.make_local_step(tb, adamw(1e-3), n_negatives=1)
    jnew, _, jm = jstep(jp, jadamw(1e-3).init(jlora.partition(jp)),
                        {k: jnp.asarray(v) for k, v in b.items()},
                        jnp.asarray(anchor))
    tnew, _, tm = tstep(tp, adamw(1e-3).init(lora.partition(tp)),
                        {k: torch.as_tensor(v) for k, v in b.items()},
                        torch.from_numpy(anchor))
    for k in ("loss", "ccl", "ce"):
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-5,
                                   err_msg=k)
    jflat, tflat = flat_numpy(jlora.partition(jnew)), lora.partition(tnew)
    before = lora.partition(tp)
    assert sorted(jflat) == sorted(tflat)
    for k in jflat:
        np.testing.assert_allclose(_np(tflat[k]), jflat[k], atol=1e-5,
                                   err_msg=k)
    for k in ("spg_scale", "spg_bias", "spg_w1"):
        k = f"connector/{k}"
        assert torch.equal(tflat[k], before[k]), k
        np.testing.assert_array_equal(jflat[k],
                                      flat_numpy(jlora.partition(jp))[k])
    assert not torch.equal(tflat["connector/proj_w"],
                           before["connector/proj_w"])


def test_stacked_step_matches_reference():
    """One ``make_stacked_step`` of G = 3 clients (own adapters,
    projectors, connectors, frames and modality features) against the
    reference's (tests/_torch_stacked_cases.py): the encoder's and the
    decoder's adapters and the frontend projector per client, the cross-
    attention shared."""
    m = stacked_step_against_reference(multimodal(encdec_cfg()))
    assert m["aux"].tolist() == [0.0] * 3


# ---------------------------------------------------------------------------
# ring serving

def test_prefill_and_decode_steps_match_reference():
    """The port's ring prefill and K teacher-forced decode steps against
    the reference's ``prefill`` / ``decode_step`` (2e-4), and against the
    reference's forward; the cache's cross K/V are the encoder's."""
    jcfg = encdec_cfg()
    jb, jp, tb, tp = port_pair(jcfg)
    fn = jitted(jcfg)
    toks, fe = inputs(jcfg)
    jfe = jnp.asarray(fe)
    full, _ = fn["logits"](jp, {"tokens": jnp.asarray(toks),
                                "frontend_embeds": jfe})
    jlast, jcache = fn["prefill"](jp, {"tokens": jnp.asarray(toks[:, :S]),
                                       "frontend_embeds": jfe})
    jcache = jserve._reseat_cache(jb.init_cache(B, S + K), jcache)
    t, f = torch.from_numpy(toks).long(), torch.from_numpy(fe)
    with torch.no_grad():
        last, pcache = tb.prefill(tp, {"tokens": t[:, :S],
                                       "frontend_embeds": f})
        cache = serve._reseat_cache(tb.init_cache(B, S + K, "cpu"), pcache)
        assert cache["cross_k"] is pcache["cross_k"]
        np.testing.assert_allclose(_np(cache["cross_v"]),
                                   _np(jcache["cross_v"]), **F32)
        np.testing.assert_allclose(_np(last), _np(jlast), **F32)
        np.testing.assert_allclose(_np(last), _np(full[:, S - 1]), **F32)
        for i in range(K):
            jl, jcache = fn["step"](jp, jcache,
                                    jnp.asarray(toks[:, S + i:S + i + 1]),
                                    jnp.int32(S + i))
            tl, cache = tb.decode_step(tp, cache, t[:, S + i:S + i + 1],
                                       S + i)
            np.testing.assert_allclose(_np(tl), _np(jl),
                                       err_msg=f"step {i}", **F32)
            np.testing.assert_allclose(_np(tl), _np(full[:, S + i]),
                                       err_msg=f"step {i}", **F32)


def test_generate_matches_reference_generate():
    """Greedy tokens equal the reference's ``generate`` (merged weights
    without adapter leaves for it: fault 3.1)."""
    jcfg = encdec_cfg()
    jb, jp, tb, tp = port_pair(jcfg)
    toks, fe = inputs(jcfg, n=S, seed=5)
    want = jserve.generate(jb, strip_adapters(jlora.merge_lora(jp, jcfg)),
                           jnp.asarray(toks), max_new=6, merge=False,
                           batch_extra={"frontend_embeds": jnp.asarray(fe)})
    got = serve.generate(tb, tp, torch.from_numpy(toks).long(), max_new=6,
                         batch_extra={"frontend_embeds":
                                      torch.from_numpy(fe)})
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_prefix_length_is_zero():
    """The frames feed the encoder, not the decoder's cache: ``generate``
    and the engine put the first decoded token at the prompt's length
    (the port once counted the frames as a prefix)."""
    cfg = port_pair(encdec_cfg())[2].cfg
    batch = {"tokens": torch.zeros((1, 5), dtype=torch.long),
             "frontend_embeds": torch.zeros((1, T_FRAMES, 24))}
    assert serve._prefix_len(cfg, batch) == 0
    _, _, tb, tp = port_pair(encdec_cfg())
    engine = ServingEngine(tb, tp, EngineConfig(device="cpu", n_slots=1,
                                                page_size=4, n_pages=8,
                                                max_pages_per_seq=4,
                                                buckets=(8,)))
    engine.submit(np.arange(5), max_new=3,
                  frontend_embeds=torch.zeros((T_FRAMES, 24)))
    engine._try_admit()
    assert engine._prefix_len(engine._slot_req[0]) == 0
    assert int(engine.sched["seq_lens"][0]) == 5
    with pytest.raises(ValueError, match="soft prompt"):
        engine.submit(np.arange(5), frontend_embeds=torch.zeros(
            (T_FRAMES, 24)), prefix_embeds=torch.zeros((2, 32)))


# ---------------------------------------------------------------------------
# paged serving

def test_paged_contract_matches_reference():
    """init_paged (cross_k / cross_v per slot), prefill_paged of a
    right-padded prompt, insert_paged into slot 1, then K steps of
    decode_paged with slot 0 idle, against the reference's."""
    jcfg = encdec_cfg()
    jb, jp, tb, tp = port_pair(jcfg)
    S_, pad, ps, slot = 8, 4, 4, 1
    toks, fe = inputs(jcfg, rows=1, n=S_ + K, seed=1)
    pre = np.pad(toks[:, :S_], ((0, 0), (0, pad)))
    n_pg = -(-(S_ + pad + K) // ps)
    page_ids = np.arange(1, 1 + n_pg, dtype=np.int32)
    bt = np.zeros((2, 8), np.int32)
    bt[slot, :n_pg] = page_ids
    active = np.array([False, True])
    jlast, jpack, jkv = jb.prefill_paged(
        jp, {"tokens": jnp.asarray(pre), "frontend_embeds": jnp.asarray(fe)},
        jnp.int32(S_))
    jstate = jb.insert_paged(jb.init_paged(2, 16, ps), jpack,
                             jnp.int32(slot), jnp.asarray(page_ids))
    with torch.no_grad():
        tstate = tb.init_paged(2, 16, ps, "cpu")
        assert sorted(tstate) == sorted(jb.init_paged(2, 16, ps))
        assert tstate["cross_k"].shape == (2, 2, T_FRAMES, 2, 8)
        tlast, tpack, tkv = tb.prefill_paged(
            tp, {"tokens": torch.from_numpy(pre).long(),
                 "frontend_embeds": torch.from_numpy(fe)}, S_)
        tstate = tb.insert_paged(tstate, tpack, slot,
                                 torch.from_numpy(page_ids).long())
    assert tkv == int(jkv) == S_
    assert sorted(tpack) == sorted(jpack)
    np.testing.assert_allclose(_np(tlast), _np(jlast), **F32)
    for name in ("k_pages", "v_pages", "cross_k", "cross_v"):
        np.testing.assert_allclose(_np(tstate[name]), _np(jstate[name]),
                                   err_msg=name, **F32)
    jlens = jnp.zeros((2,), jnp.int32).at[slot].set(jkv)
    tlens = torch.zeros(2, dtype=torch.int32)
    tlens[slot] = tkv
    for i in range(K):
        tok = np.zeros((2, 1), np.int32)
        tok[slot, 0] = toks[0, S_ + i]
        jl, jstate = jb.decode_paged(jp, jstate, jnp.asarray(bt), jlens,
                                     jnp.asarray(tok), jnp.asarray(active))
        with torch.no_grad():
            tl, tstate = tb.decode_paged(tp, tstate, torch.from_numpy(bt),
                                         tlens, torch.from_numpy(tok).long(),
                                         torch.from_numpy(active))
        np.testing.assert_allclose(_np(tl[slot]), _np(jl[slot]),
                                   err_msg=f"step {i}", **F32)
        jlens = jlens + jnp.asarray(active)
        tlens = tlens + torch.from_numpy(active).int()


def test_engine_matches_reference_engine_greedy():
    """Five requests, each with its own frames, through ``ServingEngine``
    against the reference engine (merged weights without adapter leaves,
    merge=False): equal greedy tokens at float32, free lists restored."""
    jcfg = encdec_cfg()
    jb, jp, tb, tp = port_pair(jcfg)
    conf = dict(n_slots=2, page_size=4, n_pages=32, max_pages_per_seq=8,
                max_out=16, buckets=(8, 16))
    rng = np.random.RandomState(3)
    reqs = [(rng.randint(0, jcfg.vocab_size, (n,)).astype(np.int32), m,
             (rng.randn(T_FRAMES, 24) * 0.5).astype(np.float32))
            for n, m in [(5, 6), (8, 3), (12, 9), (3, 1), (9, 7)]]
    jengine = JEngine(jb, strip_adapters(jlora.merge_lora(jp, jcfg)),
                      JEngineConfig(**conf), merge=False)
    tengine = ServingEngine(tb, tp, EngineConfig(device="cpu", **conf))
    jr = [jengine.submit(t, max_new=m, frontend_embeds=f)
          for t, m, f in reqs]
    tr = [tengine.submit(t, max_new=m, frontend_embeds=torch.from_numpy(f))
          for t, m, f in reqs]
    jdone, tdone = jengine.run(), tengine.run()
    for (_, m, _), a, b in zip(reqs, jr, tr):
        assert len(tdone[b].out) == m
        assert tdone[b].out.tolist() == jdone[a].out.tolist()
    assert sorted(tengine._free_pages) == list(range(1, conf["n_pages"]))
    assert sorted(tengine._free_slots) == [0, 1]


def test_init_params_layout_matches_reference():
    """The port's own init draws the reference's tree: the same leaves,
    shapes and dtypes (the values are the port's generator's)."""
    jcfg = encdec_cfg("bfloat16")
    _, jp, tb, _ = port_pair(jcfg)
    mine = lora.flatten(tb.init(torch.Generator().manual_seed(0)))
    ref = {jlora.path_str(p): a for p, a in
           jax.tree_util.tree_flatten_with_path(jp)[0]}
    assert sorted(mine) == sorted(ref)
    for k, a in ref.items():
        assert tuple(mine[k].shape) == a.shape, k
        assert mine[k].dtype == torch.bfloat16, k
