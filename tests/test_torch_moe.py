"""Port parity for the moe family: ``capacity``, ``moe_mlp`` (routing,
capacity slots, dropped assignments, the Switch aux loss), the moe trunk's
forward, ``lm_loss`` and its LoRA gradients, per-client routing
(``moe_mlp(clients=G)`` against ``vmap``, the stacked step against the
reference's ``make_stacked_step``), ring ``generate`` and decode, the
paged contract and the engine, each against the JAX package on the
same weights (made by the JAX init, LoRA B filled from a numpy seed,
carried over by ``interop``) at the toy sizes of tests/test_serving.py
(2 layers, d 32, 4 experts, top-2, float32).

Every parity test runs at the config's own capacity factor (1.25) and at
0.5, where a prefill drops assignments (asserted for ``moe_mlp``), but
the idle-slot test, which drops at 1.25.  Tolerances: f32 ``moe_mlp``
1e-5, ring decode-step logits 1e-4, logits / loss 2e-4, gradients 1e-4
of each row's largest |value|.  bf16 is held at ``moe_mlp`` only, on
bit-identical inputs, so the f32 router picks the same experts in both
packages (the picks are asserted equal): a bf16 trunk's hidden states
differ by rounding between the packages and could flip a near-tie of
the router.

Capacity makes a token's output depend on the other tokens of its call:
``test_idle_slots_take_capacity_in_both_packages`` shows it for a paged
decode step (ROADMAP, reference fault 3.9).
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import lora as jlora
from repro.launch import serve as jserve
from repro.launch.serve_engine import EngineConfig as JEngineConfig
from repro.launch.serve_engine import ServingEngine as JEngine
from repro.models import moe as jmoe
from repro_torch.configs.base import ModelConfig
from repro_torch.core import ccl, lora
from repro_torch.launch.serve import _reseat_cache, generate
from repro_torch.launch.serve_engine import EngineConfig, ServingEngine
from repro_torch.models import moe, transformer
from _torch_stacked_cases import multimodal, stacked_step_against_reference
from test_torch_serving import port_pair, serving_cfg, strip_adapters

torch.set_num_threads(1)

F32 = dict(atol=2e-4, rtol=2e-4)
MOE_F32 = dict(atol=1e-5, rtol=1e-5)
STEP = dict(atol=1e-4, rtol=1e-4)          # ring decode-step logits
BF16_REL = 1e-2           # bf16 outputs: of the largest |value|
GRAD_TOL = 1e-4
CFS = [1.25, 0.5]          # the config's own; one that drops in prefill
B, S, K = 2, 16, 3


def moe_cfg(cf=1.25, dtype="float32", **kw):
    """tests/test_serving.py's moe toy at capacity factor ``cf``."""
    return serving_cfg(family="moe", n_experts=4, top_k=2, d_ff_expert=64,
                       capacity_factor=cf, dtype=dtype, **kw)


def _np(x):
    return x.detach().float().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x, np.float32)


def layer0(jp, tp):
    """Layer 0's moe leaves of both trees."""
    return (jax.tree.map(lambda a: a[0], jp["layers"]["moe"]),
            {k: v[0] for k, v in tp["layers"]["moe"].items()})


def dropped(cfg, tp, x):
    """Assignments the port drops for x (B, S, d) in layer 0."""
    p = {k: v[0] for k, v in tp["layers"]["moe"].items()}
    T = x.shape[0] * x.shape[1]
    _, _, idx = moe.route(p, cfg, x.reshape(T, -1))
    return int((moe.slots(idx, cfg.n_experts) >= moe.capacity(cfg, T)).sum())


def rows_close(got, want, name, tol=GRAD_TOL):
    """Each row of a gradient (last axis) within ``tol`` of the row's
    largest |want| (an all-zero row: of 1e-6 of the leaf's largest)."""
    g, w = _np(got), _np(want)
    g, w = g.reshape(-1, g.shape[-1]), w.reshape(-1, w.shape[-1])
    scale = np.maximum(np.abs(w).max(1, keepdims=True),
                       1e-6 * np.abs(w).max())
    err = float((np.abs(g - w) / scale).max())
    assert err <= tol, (name, err)


@functools.lru_cache(maxsize=None)
def jitted(jcfg):
    """The reference bundle's logits / prefill / decode_step, each jitted
    once."""
    jb = port_pair(jcfg)[0]
    return (jax.jit(jb.logits), jax.jit(jb.prefill),
            jax.jit(jb.decode_step))


# ---------------------------------------------------------------------------
# capacity and moe_mlp

@pytest.mark.parametrize("cf", [0.5, 1.25, 4.0, 16.0])
def test_capacity_matches_reference(cf):
    for E, Kk in ((4, 2), (16, 2), (128, 8)):
        cfg = ModelConfig(family="moe", n_experts=E, top_k=Kk,
                          d_ff_expert=8, capacity_factor=cf)
        for T in (1, 2, 7, 16, 590, 2360):
            assert moe.capacity(cfg, T) == jmoe.capacity(cfg, T), (E, Kk, T)


@pytest.mark.parametrize("cf", CFS)
def test_moe_mlp_matches_reference(cf):
    """Output and aux at float32 (1e-5), dropped assignments included."""
    jcfg = moe_cfg(cf)
    _, jp, tb, tp = port_pair(jcfg)
    jm, tm = layer0(jp, tp)
    x = np.random.RandomState(1).randn(2, 16, jcfg.d_model).astype(
        np.float32)
    want, waux = jmoe.moe_mlp(jm, jcfg, jnp.asarray(x))
    got, aux = moe.moe_mlp(tm, tb.cfg, torch.from_numpy(x))
    n_drop = dropped(tb.cfg, tp, torch.from_numpy(x))
    assert n_drop > 0 if cf < 1 else True
    np.testing.assert_allclose(_np(got), _np(want), **MOE_F32)
    np.testing.assert_allclose(float(aux), float(waux), **MOE_F32)


def test_moe_mlp_drops_what_the_capacity_cannot_hold():
    """At capacity factor 0.5 assignments are dropped, and a dropped one
    adds nothing: the output equals the kept assignments' gated sum,
    computed expert by expert from the routes."""
    jcfg = moe_cfg(0.5)
    _, _, tb, tp = port_pair(jcfg)
    p = layer0(port_pair(jcfg)[1], tp)[1]
    x = torch.from_numpy(np.random.RandomState(2).randn(
        1, 24, jcfg.d_model).astype(np.float32))
    cfg = tb.cfg
    _, gate, idx = moe.route(p, cfg, x[0])
    rank = moe.slots(idx, cfg.n_experts).view(24, cfg.top_k)
    C = moe.capacity(cfg, 24)
    assert int((rank >= C).sum()) > 0
    want = torch.zeros_like(x[0])
    for t in range(24):
        for j in range(cfg.top_k):
            if rank[t, j] < C:
                e = idx[t, j]
                h = torch.nn.functional.silu(x[0, t] @ p["we_gate"][e]) \
                    * (x[0, t] @ p["we_up"][e])
                want[t] += gate[t, j] * (h @ p["we_down"][e])
    got, _ = moe.moe_mlp(p, cfg, x)
    np.testing.assert_allclose(_np(got[0]), _np(want), **MOE_F32)


@pytest.mark.parametrize("cf", CFS)
def test_moe_mlp_bf16_with_the_same_routes(cf):
    """bf16 on bit-identical inputs: the f32 router picks the same
    experts in both packages (asserted), the outputs agree to bf16
    rounding."""
    jcfg = moe_cfg(cf, dtype="bfloat16")
    _, jp, tb, tp = port_pair(jcfg)
    jm, tm = layer0(jp, tp)
    assert tm["router"].dtype == torch.float32
    x = jnp.asarray(np.random.RandomState(1).randn(2, 16, jcfg.d_model),
                    jnp.bfloat16)
    tx = torch.from_numpy(np.array(x).view(np.int16)).view(torch.bfloat16)
    probs = jax.nn.softmax(x.reshape(32, -1).astype(jnp.float32)
                           @ jm["router"], axis=-1)
    _, jidx = jax.lax.top_k(probs, jcfg.top_k)
    _, _, idx = moe.route(tm, tb.cfg, tx.reshape(32, -1))
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    want, waux = jmoe.moe_mlp(jm, jcfg, x)
    got, aux = moe.moe_mlp(tm, tb.cfg, tx)
    # each package rounds the expert products to bf16 at its own points
    # (1-2 ulp of h), so the error is held against the largest output
    np.testing.assert_allclose(_np(got), _np(want), rtol=0,
                               atol=BF16_REL * np.abs(_np(want)).max())
    np.testing.assert_allclose(float(aux), float(waux), rtol=1e-5)


# ---------------------------------------------------------------------------
# the trunk: forward, loss, gradients

def _tokens(jcfg, shape, seed=7):
    return np.random.RandomState(seed).randint(
        0, jcfg.vocab_size, shape).astype(np.int32)


@pytest.mark.parametrize("cf", CFS)
def test_trunk_logits_aux_and_loss_match_reference(cf):
    """Forward logits and the layers' summed aux (2e-4), and ``lm_loss``
    = ce + 0.01 aux."""
    jcfg = moe_cfg(cf)
    jb, jp, tb, tp = port_pair(jcfg)
    toks = _tokens(jcfg, (B, S + K))
    want, waux = jitted(jcfg)[0](jp, {"tokens": jnp.asarray(toks)})
    tt = torch.from_numpy(toks).long()
    with torch.no_grad():
        got, aux = tb.logits(tp, {"tokens": tt})
        loss, m = tb.lm_loss(tp, {"tokens": tt})
    np.testing.assert_allclose(_np(got), _np(want), **F32)
    np.testing.assert_allclose(float(aux), float(waux), **F32)
    assert float(aux) > 0
    wloss, wm = jb.lm_loss(jp, {"tokens": jnp.asarray(toks)})
    np.testing.assert_allclose(float(loss), float(wloss), **F32)
    np.testing.assert_allclose(float(loss), float(m["ce"]) + 0.01 * float(
        m["aux"]), rtol=1e-6)
    np.testing.assert_allclose(float(m["aux"]), float(wm["aux"]), **F32)


@pytest.mark.parametrize("cf,remat", [(1.25, False), (1.25, True),
                                      (0.5, False)])
def test_lm_loss_lora_grads_match_reference(cf, remat):
    """The gradients of ``lm_loss`` (ce + 0.01 aux) with respect to the
    LoRA leaves against ``jax.grad``, row by row (remat on and off)."""
    jcfg = moe_cfg(cf, remat=remat)
    jb, jp, tb, tp = port_pair(jcfg)
    toks = _tokens(jcfg, (B, S), seed=3)
    jbatch = {"tokens": jnp.asarray(toks)}
    jtrain = jlora.partition(jp, jlora.is_lora_leaf)

    def jfn(t):
        return jb.lm_loss(jlora.combine(jp, t), jbatch)[0]
    jl, jg = jax.jit(jax.value_and_grad(jfn))(jtrain)
    train = {k: v.detach().requires_grad_(True)
             for k, v in lora.partition(tp, lora.is_lora_leaf).items()}
    tl, _ = tb.lm_loss(lora.combine(tp, train),
                       {"tokens": torch.from_numpy(toks).long()})
    tg = ccl.grads_of(tl, train)
    assert sorted(tg) == sorted(jg) and len(tg) == 8
    np.testing.assert_allclose(float(tl.detach()), float(jl), **F32)
    for k in jg:
        rows_close(tg[k], jg[k], k)


@pytest.mark.parametrize("cf", CFS)
def test_moe_mlp_routes_each_client_as_its_own_call(cf):
    """``moe_mlp(clients=G)`` on G = 3 clients' rows (G x 2 rows of 16):
    each client's output and aux equal its own call (1e-6) and the
    reference's ``vmap`` of ``moe_mlp`` over the clients (1e-5), with its
    own capacity (at 0.5 every client drops assignments, counted within
    its own rows); ``clients=1`` is bit-equal to the unstacked call."""
    jcfg = moe_cfg(cf)
    _, jp, tb, tp = port_pair(jcfg)
    jm, tm = layer0(jp, tp)
    G = 3
    x = np.random.RandomState(2).randn(G, 2, 16, jcfg.d_model).astype(
        np.float32)
    xt = torch.from_numpy(x)
    got, aux = moe.moe_mlp(tm, tb.cfg, xt.reshape(G * 2, 16, -1), clients=G)
    assert aux.shape == (G,)
    got = got.reshape(G, 2, 16, -1)
    want, waux = jax.vmap(lambda xx: jmoe.moe_mlp(jm, jcfg, xx))(
        jnp.asarray(x))
    np.testing.assert_allclose(_np(got), _np(want), **MOE_F32)
    np.testing.assert_allclose(_np(aux), _np(waux), **MOE_F32)
    for g in range(G):
        yg, ag = moe.moe_mlp(tm, tb.cfg, xt[g])
        np.testing.assert_allclose(_np(got[g]), _np(yg), atol=1e-6)
        np.testing.assert_allclose(float(aux[g]), float(ag), atol=1e-6)
        if cf < 1:
            assert dropped(tb.cfg, tp, xt[g]) > 0
    one, aux1 = moe.moe_mlp(tm, tb.cfg, xt[0], clients=1)
    alone, aux0 = moe.moe_mlp(tm, tb.cfg, xt[0])
    assert torch.equal(one, alone) and aux1.shape == (1,)
    assert torch.equal(aux1[0], aux0) and aux0.dim() == 0


@pytest.mark.parametrize("cf", CFS)
def test_stacked_step_matches_reference(cf, monkeypatch):
    """One ``make_stacked_step`` of G = 3 clients (own adapters,
    connectors and batches, modality features, a server anchor) against
    the reference's: each client routes, drops and takes its aux alone
    (tests/_torch_stacked_cases.py).  At 0.5 the stacked forward drops
    assignments; the clients' aux differ."""
    ranks = []

    def recording(idx, n_experts):
        out = slots(idx, n_experts)
        ranks.append(out)
        return out
    slots = moe.slots
    monkeypatch.setattr(moe, "slots", recording)
    jcfg = multimodal(moe_cfg(cf))
    m = stacked_step_against_reference(jcfg)
    assert len(set(m["aux"].tolist())) == 3 and float(m["aux"].min()) > 0
    G, T = ranks[0].shape[0], ranks[0].shape[1] // jcfg.top_k
    assert G == 3
    C = moe.capacity(jcfg, T)
    drops = sum(int((r >= C).sum()) for r in ranks)
    assert drops > 0 if cf < 1 else True


def test_vectorized_engine_matches_loop_on_a_moe_cohort():
    """One evaluated round of a toy moe cohort (3 clients, capacity factor
    0.5, so tokens drop) on the vectorized engine (the stacked moe pass:
    each client routes alone) and on the loop engine from the same seed:
    summaries and every LoRA leaf within 1e-6."""
    from _torch_cohort_cases import SLM, make_specs
    from _torch_cohort_cases import corpus as make_corpus
    from repro_torch.core.federated import FederatedRunner
    from test_torch_vectorized import assert_engines_agree
    model = dataclasses.replace(SLM, name="coh-moe", family="moe",
                                n_experts=4, top_k=2, d_ff_expert=32,
                                capacity_factor=0.5)
    _, tspec = make_specs(((model, dict(n_clients=3, name="M")),), None, 1,
                          {})
    corpus = make_corpus()
    runs = {}
    for engine in ("loop", "vectorized"):
        r = FederatedRunner(tspec, corpus, engine=engine, device="cpu")
        runs[engine] = (r, [r.run_round()["summary"]])
    (loop, sl), (vec, sv) = runs["loop"], runs["vectorized"]
    assert vec.cohorts[0].stacked_params is not None
    assert_engines_agree(loop, vec, sl, sv, tol=1e-6)


# ---------------------------------------------------------------------------
# ring serving

@pytest.mark.parametrize("cf", CFS)
def test_prefill_and_decode_steps_match_reference(cf):
    """The port's prefill and K teacher-forced decode steps against the
    reference's ``prefill`` / ``decode_step`` on the same positions
    (1e-4); the same capacity rule in both (the prefill's T = B * S, a
    step's T = B)."""
    jcfg = moe_cfg(cf)
    jb, jp, tb, tp = port_pair(jcfg)
    _, j_prefill, j_decode = jitted(jcfg)
    toks = _tokens(jcfg, (B, S + K))
    jlast, jcache = j_prefill(jp, {"tokens": jnp.asarray(toks[:, :S])})
    jcache = jserve._reseat_cache(jb.init_cache(B, S + K), jcache)
    t = torch.from_numpy(toks).long()
    with torch.no_grad():
        last, cache = tb.prefill(tp, {"tokens": t[:, :S]})
        cache = _reseat_cache(tb.init_cache(B, S + K, "cpu"), cache)
        np.testing.assert_allclose(_np(last), _np(jlast), **STEP)
        for i in range(K):
            jl, jcache = j_decode(jp, jcache,
                                  jnp.asarray(toks[:, S + i:S + i + 1]),
                                  jnp.int32(S + i))
            tl, cache = tb.decode_step(tp, cache, t[:, S + i:S + i + 1],
                                       S + i)
            np.testing.assert_allclose(_np(tl), _np(jl),
                                       err_msg=f"step {i}", **STEP)


@pytest.mark.parametrize("cf", CFS)
def test_generate_greedy_tokens_match_reference(cf):
    """``generate``'s greedy tokens equal the reference's ``generate``
    (merged weights without adapter leaves for it: fault 3.1)."""
    jcfg = moe_cfg(cf)
    jb, jp, tb, tp = port_pair(jcfg)
    toks = _tokens(jcfg, (B, S), seed=5)
    want = jserve.generate(jb, strip_adapters(jlora.merge_lora(jp, jcfg)),
                           jnp.asarray(toks), max_new=6, merge=False)
    got = generate(tb, tp, torch.from_numpy(toks).long(), max_new=6)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# ---------------------------------------------------------------------------
# paged serving

@pytest.mark.parametrize("cf", CFS)
def test_paged_decode_with_an_idle_slot_matches_reference(cf):
    """prefill_paged (right-padded) -> insert into slot 1 -> K steps of
    decode_paged with slot 0 idle, against the reference's, every slot's
    row routed in both."""
    jcfg = moe_cfg(cf)
    jb, jp, tb, tp = port_pair(jcfg)
    S_, pad, ps, slot = 8, 4, 4, 1
    toks = _tokens(jcfg, (1, S_ + K), seed=1)
    pre = np.pad(toks[:, :S_], ((0, 0), (0, pad)))
    n_pg = -(-(S_ + pad + K) // ps)
    page_ids = np.arange(1, 1 + n_pg, dtype=np.int32)
    bt = np.zeros((2, 8), np.int32)
    bt[slot, :n_pg] = page_ids
    active = np.array([False, True])
    jlast, jpack, jkv = jb.prefill_paged(jp, {"tokens": jnp.asarray(pre)},
                                         jnp.int32(S_))
    jstate = jb.insert_paged(jb.init_paged(2, 16, ps), jpack,
                             jnp.int32(slot), jnp.asarray(page_ids))
    with torch.no_grad():
        tlast, tpack, tkv = tb.prefill_paged(
            tp, {"tokens": torch.from_numpy(pre).long()}, S_)
        tstate = tb.insert_paged(tb.init_paged(2, 16, ps, "cpu"), tpack, slot,
                                 torch.from_numpy(page_ids).long())
    assert tkv == int(jkv) == S_
    np.testing.assert_allclose(_np(tlast), _np(jlast), **F32)
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
        np.testing.assert_allclose(_np(tl), _np(jl), err_msg=f"step {i}",
                                   **F32)
        jlens = jlens + jnp.asarray(active)
        tlens = tlens + torch.from_numpy(active).int()


def _slot_logits(decode, params, state_fn, n_slots, slot, tok, lens):
    """Logits of one active ``slot`` among ``n_slots`` (the others idle,
    block-table rows zero) for one decode step."""
    bt = np.zeros((n_slots, 2), np.int32)
    bt[slot] = [1, 2]
    seq = np.zeros((n_slots,), np.int32)
    seq[slot] = lens
    act = np.zeros((n_slots,), bool)
    act[slot] = True
    toks = np.zeros((n_slots, 1), np.int32)
    toks[slot, 0] = tok
    return decode(params, state_fn(), bt, seq, toks, act)[slot]


def test_idle_slots_take_capacity_in_both_packages():
    """Reference fault 3.9, shown in both packages: 8 slots, one active.
    The idle rows (token 0, no keys: identical) route too, each to the
    same experts, so 7 idle rows ahead of the active one (slot 7) fill
    those experts' capacity (C = 5) and the active row's assignments to
    them are dropped; in slot 0 it ranks first.  Its logits differ
    between the two placements, in both packages, and the port equals
    the reference in each."""
    jcfg = moe_cfg()
    jb, jp, tb, tp = port_pair(jcfg)
    assert moe.capacity(tb.cfg, 8) == 5
    tok, lens, ps = 9, 3, 4

    def jstate():
        st = jb.init_paged(8, 4, ps)
        return dict(st, k_pages=st["k_pages"] + 0.1, v_pages=st["v_pages"]
                    + 0.2)

    def tstate():
        st = tb.init_paged(8, 4, ps, "cpu")
        return {k: v + (0.1 if k == "k_pages" else 0.2) for k, v in st.items()}

    def jdecode(p, st, bt, seq, toks, act):
        return _np(jb.decode_paged(p, st, jnp.asarray(bt), jnp.asarray(seq),
                                   jnp.asarray(toks), jnp.asarray(act))[0])

    def tdecode(p, st, bt, seq, toks, act):
        with torch.no_grad():
            return _np(tb.decode_paged(
                p, st, torch.from_numpy(bt), torch.from_numpy(seq),
                torch.from_numpy(toks).long(), torch.from_numpy(act))[0])

    got = {}
    for name, dec, p, st in (("ref", jdecode, jp, jstate),
                             ("port", tdecode, tp, tstate)):
        got[name] = [_slot_logits(dec, p, st, 8, slot, tok, lens)
                     for slot in (0, 7)]
    for first, last in got.values():
        assert np.abs(first - last).max() > 0.05
    for i in range(2):
        np.testing.assert_allclose(got["port"][i], got["ref"][i], **F32)


@pytest.mark.parametrize("cf", CFS)
def test_engine_matches_reference_engine_greedy(cf):
    """Six requests through ``ServingEngine`` against the reference engine
    (merged weights without adapter leaves, merge=False): equal greedy
    tokens at float32, free lists restored.  Two slots: the idle one
    routes too, in both."""
    jcfg = moe_cfg(cf)
    jb, jp, tb, tp = port_pair(jcfg)
    conf = dict(n_slots=2, page_size=4, n_pages=32, max_pages_per_seq=8,
                max_out=16, buckets=(8, 16))
    rng = np.random.RandomState(3)
    reqs = [(rng.randint(0, jcfg.vocab_size, (n,)).astype(np.int32), m)
            for n, m in [(5, 6), (8, 3), (12, 9), (3, 1), (9, 12), (6, 4)]]
    jengine = JEngine(jb, strip_adapters(jlora.merge_lora(jp, jcfg)),
                      JEngineConfig(**conf), merge=False)
    tengine = ServingEngine(tb, tp, EngineConfig(device="cpu", **conf))
    jr = [jengine.submit(t, max_new=m) for t, m in reqs]
    tr = [tengine.submit(t, max_new=m) for t, m in reqs]
    jdone, tdone = jengine.run(), tengine.run()
    for (_, m), a, b in zip(reqs, jr, tr):
        assert len(tdone[b].out) == m
        assert tdone[b].out.tolist() == jdone[a].out.tolist()
    assert sorted(tengine._free_pages) == list(range(1, conf["n_pages"]))


def test_init_params_layout_matches_reference():
    """The port's own init draws the reference's tree: the same leaves,
    shapes and dtypes, the router float32 in a bf16 model (the values are
    the port's generator's)."""
    jcfg = moe_cfg(dtype="bfloat16")
    _, jp, tb, tp = port_pair(jcfg)
    mine = lora.flatten(tb.init(torch.Generator().manual_seed(0)))
    ref = {jlora.path_str(p): a for p, a in
           jax.tree_util.tree_flatten_with_path(jp)[0]}
    assert sorted(mine) == sorted(ref)
    for k, a in ref.items():
        assert tuple(mine[k].shape) == a.shape, k
        want = torch.float32 if k.endswith("/router") else torch.bfloat16
        assert mine[k].dtype == want == lora.flatten(tp)[k].dtype, k
