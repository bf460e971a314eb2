"""Port parity for the serving slice: interop, connector, merge_lora, the
dense forward, the paged prefill/insert/decode contract and the
continuous-batching engine, each against the JAX package on the same
inputs.

Weights are made once by the JAX init, their zero-initialized
``*_lora_b`` leaves filled from a numpy seed (so LoRA does real work), and
carried to the port through ``repro_torch.interop``.  Tolerances: float32
logits 1e-4, connector 1e-4; bf16 6e-2 / 5e-2 — the bound
tests/test_serving.py uses for paged decode against forward.  bf16 cannot
match bit for bit: the reference's prefill rounds the logits to bf16
before its f32 softmax and the weights to bf16 before P.V
(repro/models/layers.py:139,144); the port's kernels keep both in f32.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import ModelConfig as JConfig
from repro.core import ccl as jccl
from repro.core import connector as jconn
from repro.core import lora as jlora
from repro.launch.serve_engine import EngineConfig as JEngineConfig
from repro.launch.serve_engine import ServingEngine as JEngine
from repro.models.model import build_model as jbuild
from repro_torch import interop
from repro_torch.configs.base import ModelConfig
from repro_torch.core import connector
from repro_torch.core.lora import (combine, flatten, is_lora_leaf,
                                   merge_lora, stack_clients)
from repro_torch.launch.serve_engine import EngineConfig, ServingEngine
from repro_torch.models.model import build_model
from repro_torch.models.paged import pages_for

torch.set_num_threads(1)

F32 = dict(atol=1e-4, rtol=1e-4)
BF16 = dict(atol=6e-2, rtol=5e-2)
TOL = {"float32": F32, "bfloat16": BF16}


# ---------------------------------------------------------------------------
# helpers: the JAX side, flattened for interop

def flat_numpy(tree) -> dict:
    """JAX pytree -> {path_str: ndarray}, bf16 as its uint16 bits."""
    leaves, _ = jax.tree_util.tree_flatten_with_path(tree)
    out = {}
    for path, leaf in leaves:
        a = np.asarray(leaf)
        out[jlora.path_str(path)] = a.view(np.uint16) \
            if a.dtype == jnp.bfloat16 else a
    return out


def perturb_lora_b(jparams, seed=0, scale=0.05):
    """Fill every zero-initialized ``*_lora_b`` leaf from a numpy seed."""
    rng = np.random.RandomState(seed)

    def fill(path, leaf):
        if jlora.path_str(path).endswith("_lora_b"):
            noise = rng.randn(*leaf.shape).astype(np.float32) * scale
            return jnp.asarray(noise, leaf.dtype)
        return leaf
    return jax.tree_util.tree_map_with_path(fill, jparams)


def strip_adapters(jparams):
    """A JAX tree without its ``*_lora_a/b`` leaves."""
    if isinstance(jparams, dict):
        return {k: strip_adapters(v) for k, v in jparams.items()
                if not is_lora_leaf(k)}
    return jparams


@functools.lru_cache(maxsize=None)
def port_pair(jcfg, unified=False):
    """(JAX bundle, JAX params, port bundle, port params) from one init.
    Cached: no test writes to the params it gets."""
    cfg = ModelConfig(**dataclasses.asdict(jcfg))
    jb = jbuild(jcfg)
    key = jax.random.key(0)
    jp = jccl.init_unified(key, jb) if unified else jb.init(key)
    jp = perturb_lora_b(jp)
    tp = interop.params_from_numpy(flat_numpy(jp), "cpu", cfg.torch_dtype)
    return jb, jp, build_model(cfg), tp


def serving_cfg(**kw):
    """tests/test_serving.py::_cfg (dense)."""
    base = dict(name="t", n_layers=2, d_model=32, n_heads=4, n_kv_heads=2,
                head_dim=8, d_ff=64, vocab_size=64, n_modalities=0,
                remat=False, lora_rank=2, dtype="float32")
    base.update(kw)
    return JConfig(**base)


def toy_cfg(dtype):
    """tests/conftest.py::toy_cfg, at ``dtype``."""
    return JConfig(
        name="toy", family="dense", n_layers=2, d_model=64, n_heads=4,
        n_kv_heads=2, head_dim=16, d_ff=128, vocab_size=128,
        n_modalities=3, modality_dim=32, n_soft_tokens=4, connector_dim=48,
        lora_rank=4, remat=False, activation="gelu", dtype=dtype)


def _np(x):
    return np.asarray(x, np.float32) if not isinstance(x, torch.Tensor) \
        else x.float().numpy()


# ---------------------------------------------------------------------------
# interop, connector, merge_lora, forward

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_interop_round_trip_is_bit_exact(dtype):
    jb, jp, _, tp = port_pair(toy_cfg(dtype), unified=True)
    want = flat_numpy(jp)
    got = interop.params_to_numpy(tp)
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_connector_prefix_matches_reference(dtype):
    jcfg = toy_cfg(dtype)
    _, jp, tb, tp = port_pair(jcfg, unified=True)
    rng = np.random.RandomState(4)
    feats = rng.randn(5, jcfg.n_modalities, jcfg.modality_dim).astype(np.float32)
    mask = rng.rand(5, jcfg.n_modalities) < 0.6
    mask[:, 0] |= ~mask.any(1)
    want = jconn.connector_prefix(jp["connector"], jcfg, jnp.asarray(feats),
                                  jnp.asarray(mask))
    got = connector.connector_prefix(tp["connector"], tb.cfg,
                                     torch.from_numpy(feats),
                                     torch.from_numpy(mask))
    assert got[0].shape == (5, jcfg.n_soft_tokens, jcfg.d_model)
    for g, w in zip(got, want):
        np.testing.assert_allclose(_np(g), _np(w), **TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_merge_lora_matches_reference(dtype):
    jcfg = toy_cfg(dtype)
    _, jp, tb, tp = port_pair(jcfg, unified=True)
    want = flat_numpy(jlora.merge_lora(jp, jcfg))
    got = flatten(merge_lora(tp, tb.cfg))
    assert not any(is_lora_leaf(k) for k in got)
    assert sorted(got) == sorted(k for k in want if not is_lora_leaf(k))
    changed = 0
    for k, t in got.items():
        w = interop.params_from_numpy({k: want[k]}, "cpu", tb.cfg.torch_dtype)
        w = flatten(w)[k]
        assert t.dtype == w.dtype
        # both sum in f32 and cast back once; the f32 A@B products may
        # differ in the last bit, which bf16 rounding hides or shows as 1 ulp
        tol = dict(atol=1e-6, rtol=1e-6) if dtype == "float32" \
            else dict(atol=1e-2, rtol=1e-2)
        np.testing.assert_allclose(_np(t), _np(w), err_msg=k, **tol)
        changed += not torch.equal(t, flatten(tp)[k])
    assert changed == 4 * 1   # wq, wk, wv, wo (stacked over layers)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_forward_logits_with_soft_prompt_match_reference(dtype):
    jcfg = toy_cfg(dtype)
    jb, jp, tb, tp = port_pair(jcfg, unified=True)
    rng = np.random.RandomState(8)
    toks = rng.randint(0, jcfg.vocab_size, (2, 11)).astype(np.int32)
    feats = rng.randn(2, jcfg.n_modalities, jcfg.modality_dim).astype(np.float32)
    mask = np.array([[True, False, True], [False, True, False]])
    soft, _, _ = jconn.connector_prefix(jp["connector"], jcfg,
                                        jnp.asarray(feats), jnp.asarray(mask))
    want, _ = jb.logits(jp, {"tokens": jnp.asarray(toks),
                             "prefix_embeds": soft})
    tsoft, _, _ = connector.connector_prefix(tp["connector"], tb.cfg,
                                             torch.from_numpy(feats),
                                             torch.from_numpy(mask))
    got, aux = tb.logits(tp, {"tokens": torch.from_numpy(toks).long(),
                              "prefix_embeds": tsoft})
    assert got.dtype == torch.float32
    assert got.shape == (2, jcfg.n_soft_tokens + 11, 256)
    np.testing.assert_allclose(got.numpy(), _np(want), **TOL[dtype])


def test_merge_lora_serves_the_adapted_model():
    """Merged params give the logits of the unmerged (LoRA-applied)
    forward.  The reference's merged tree keeps its adapter leaves and its
    ``proj`` adds them once more (W + 2(α/r)AB): the second half pins how
    far that moves its logits here, the fault recorded in ROADMAP.md."""
    jcfg = toy_cfg("float32")
    jb, jp, tb, tp = port_pair(jcfg)
    toks = np.random.RandomState(1).randint(0, jcfg.vocab_size, (1, 9))
    ttoks = torch.from_numpy(toks).long()
    unmerged, _ = tb.logits(tp, {"tokens": ttoks})
    merged, _ = tb.logits(merge_lora(tp, tb.cfg), {"tokens": ttoks})
    np.testing.assert_allclose(merged.numpy(), unmerged.numpy(), **F32)

    jt = jnp.asarray(toks, jnp.int32)
    j_unmerged, _ = jb.logits(jp, {"tokens": jt})
    j_merged, _ = jb.logits(jlora.merge_lora(jp, jcfg), {"tokens": jt})
    j_stripped, _ = jb.logits(strip_adapters(jlora.merge_lora(jp, jcfg)),
                              {"tokens": jt})
    np.testing.assert_allclose(_np(j_stripped), _np(j_unmerged), **F32)
    assert np.abs(_np(j_merged) - _np(j_unmerged)).max() > 1e-2


# ---------------------------------------------------------------------------
# paged contract: prefill -> insert -> K decode steps, port vs reference

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_paged_prefill_insert_decode_match_reference(dtype):
    """Non-zero slot, prompt right-padded to a bucket, soft prompt."""
    jcfg = serving_cfg(dtype=dtype)
    jb, jp, tb, tp = port_pair(jcfg)
    S, K, ps, pad, P, slot = 8, 4, 4, 4, 3, 1
    rng = np.random.RandomState(1)
    toks = rng.randint(0, jcfg.vocab_size, (1, S + K)).astype(np.int32)
    prefix = (rng.randn(1, P, jcfg.d_model) * 0.5).astype(np.float32)
    pre = np.pad(toks[:, :S], ((0, 0), (0, pad)))
    n_pg = pages_for(P + S + pad + K, ps)
    page_ids = np.arange(1, 1 + n_pg, dtype=np.int32)
    bt = np.zeros((2, 8), np.int32)
    bt[slot, :n_pg] = page_ids
    active = np.array([False, True])

    jprefix = jnp.asarray(prefix, jcfg.param_dtype)
    jlast, jpack, jkv = jb.prefill_paged(
        jp, {"tokens": jnp.asarray(pre), "prefix_embeds": jprefix},
        jnp.int32(S))
    jstate = jb.insert_paged(jb.init_paged(2, 16, ps), jpack, jnp.int32(slot),
                             jnp.asarray(page_ids))

    tprefix = torch.from_numpy(prefix).to(tb.cfg.torch_dtype)
    tlast, tpack, tkv = tb.prefill_paged(
        tp, {"tokens": torch.from_numpy(pre).long(), "prefix_embeds": tprefix},
        S)
    assert tkv == int(jkv) == P + S
    np.testing.assert_allclose(tlast.numpy(), _np(jlast), **TOL[dtype])
    tstate = tb.insert_paged(tb.init_paged(2, 16, ps, "cpu"), tpack, slot,
                             torch.from_numpy(page_ids).long())
    np.testing.assert_allclose(_np(tstate["k_pages"]),
                               _np(jstate["k_pages"]), **TOL[dtype])

    jlens = jnp.zeros((2,), jnp.int32).at[slot].set(jkv)
    tlens = torch.zeros(2, dtype=torch.int32)
    tlens[slot] = tkv
    for i in range(K):
        tok = np.zeros((2, 1), np.int32)
        tok[slot, 0] = toks[0, S + i]
        jlogits, jstate = jb.decode_paged(jp, jstate, jnp.asarray(bt), jlens,
                                          jnp.asarray(tok), jnp.asarray(active))
        tlogits, tstate = tb.decode_paged(tp, tstate, torch.from_numpy(bt),
                                          tlens, torch.from_numpy(tok).long(),
                                          torch.from_numpy(active))
        np.testing.assert_allclose(tlogits[slot].numpy(), _np(jlogits[slot]),
                                   err_msg=f"step {i}", **TOL[dtype])
        jlens = jlens + jnp.asarray(active)
        tlens = tlens + torch.from_numpy(active).int()


# ---------------------------------------------------------------------------
# the engine

ENGINE = dict(n_slots=2, page_size=4, n_pages=32, max_pages_per_seq=8,
              max_out=16, buckets=(8, 16))
MIX = [(5, 6), (8, 3), (12, 9), (3, 1), (9, 12), (6, 4)]   # test_serving.py


def test_engine_matches_reference_engine_greedy():
    """The six-request mix of tests/test_serving.py, two of them with a
    soft prompt: equal greedy tokens at float32, free lists restored.
    The reference engine is given merged weights without adapter leaves
    (merge=False), so both serve W + (α/r)AB."""
    jcfg = serving_cfg()
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
    jrids = [jengine.submit(t, max_new=m, prefix_embeds=p) for t, m, p in reqs]
    trids = [tengine.submit(t, max_new=m, prefix_embeds=None if p is None
                            else torch.from_numpy(p)) for t, m, p in reqs]
    jdone, tdone = jengine.run(), tengine.run()
    assert sorted(tdone) == sorted(trids)
    for (toks, m, _), jr, tr in zip(reqs, jrids, trids):
        assert len(tdone[tr].out) == m
        assert tdone[tr].out.tolist() == jdone[jr].out.tolist(), \
            f"len {len(toks)}, budget {m}"
    assert sorted(tengine._free_pages) == list(range(1, ENGINE["n_pages"]))
    assert sorted(tengine._free_slots) == [0, 1]
    assert tengine.n_prefills == len(MIX) and tengine.n_steps > 0


def test_engine_eos_and_budget_clamp():
    _, _, tb, tp = port_pair(serving_cfg())
    econf = EngineConfig(n_slots=2, page_size=4, n_pages=16,
                         max_pages_per_seq=4, max_out=4, buckets=(8,),
                         device="cpu")
    engine = ServingEngine(tb, tp, econf)
    toks = np.arange(5, dtype=np.int32)
    r_long = engine.submit(toks, max_new=99)      # clamped to max_out
    r_one = engine.submit(toks, max_new=1)        # finishes at admission
    done = engine.run()
    assert len(done[r_long].out) == econf.max_out
    assert len(done[r_one].out) == 1
    eos = int(done[r_one].out[0])
    engine2 = ServingEngine(tb, tp, dataclasses.replace(econf, eos_id=eos))
    r = engine2.submit(toks, max_new=99)
    done2 = engine2.run()
    assert done2[r].out.tolist() == [eos]
    assert sorted(engine2._free_pages) == list(range(1, econf.n_pages))


def test_engine_waits_for_pages_then_admits():
    """A request that fits the block table but not the free pool waits,
    with a slot free, and is admitted after an eviction."""
    _, _, tb, tp = port_pair(serving_cfg())
    econf = EngineConfig(n_slots=2, page_size=4, n_pages=6,
                         max_pages_per_seq=4, max_out=8, buckets=(8,),
                         device="cpu")
    engine = ServingEngine(tb, tp, econf)
    rng = np.random.RandomState(1)
    rids = [engine.submit(rng.randint(0, 64, (5,)), max_new=6)
            for _ in range(2)]
    engine.tick()
    assert len(engine._slot_req) == 1 and len(engine.pending) == 1
    assert len(engine._free_slots) == 1
    done = engine.run()
    assert sorted(done) == sorted(rids)
    assert all(len(done[r].out) == 6 for r in rids)
    assert sorted(engine._free_pages) == list(range(1, econf.n_pages))


def test_engine_temperature_sampling_is_seeded():
    """Temperature sampling draws from the engine's torch.Generator: the
    same seed gives the same tokens (it cannot give jax.random's)."""
    _, _, tb, tp = port_pair(serving_cfg())
    outs = []
    for seed in (0, 0, 1):
        econf = EngineConfig(temperature=1.5, seed=seed, device="cpu",
                             **ENGINE)
        engine = ServingEngine(tb, tp, econf)
        rids = [engine.submit(np.arange(n) % 64, max_new=m) for n, m in MIX]
        done = engine.run()
        outs.append([done[r].out.tolist() for r in rids])
        assert [len(o) for o in outs[-1]] == [m for _, m in MIX]
    assert outs[0] == outs[1]
    assert outs[0] != outs[2]


def test_causal_window_mask_matches_reference():
    from repro.models.layers import causal_window_mask as jmask
    from repro_torch.models.layers import causal_window_mask
    pos = np.arange(9)[None]
    for window in (3, 1 << 30):
        got = causal_window_mask(torch.from_numpy(pos), torch.from_numpy(pos),
                                 window)
        want = jmask(jnp.asarray(pos), jnp.asarray(pos), window)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_engine_admission_overflow_raises():
    _, _, tb, tp = port_pair(serving_cfg())
    econf = EngineConfig(n_slots=1, page_size=4, n_pages=16,
                         max_pages_per_seq=2, max_out=4, buckets=(8,),
                         device="cpu")
    engine = ServingEngine(tb, tp, econf)
    engine.submit(np.zeros(7, np.int32), max_new=4)      # 8+4 > 2*4
    with pytest.raises(ValueError, match="block-table"):
        engine.run()


@pytest.mark.parametrize("family,kw", [
    ("moe", dict(n_experts=4, top_k=2, d_ff_expert=64,
                 capacity_factor=0.5)),
    ("encdec", dict(n_enc_layers=2, frontend="audio", frontend_tokens=16,
                    frontend_dim=24)),
])
def test_stacked_forward_matches_per_client_loop(family, kw):
    """The moe and encdec families' stacked forms: two clients' adapters
    (LoRA B filled per client) stacked over one backbone, each client with
    its own rows; ``logits_stacked`` and ``lm_loss_stacked`` (loss, ce and
    aux per client) equal each client's own ``logits`` / ``lm_loss``
    (1e-5).  The moe toy drops assignments at capacity factor 0.5, each
    client within its own call."""
    cfg = ModelConfig(**dataclasses.asdict(serving_cfg(family=family, **kw)))
    bundle = build_model(cfg)
    gen = torch.Generator().manual_seed(0)
    params = bundle.init(gen)
    G, B, S = 2, 2, 6
    pers = []
    for _ in range(G):
        pers.append({k: (0.1 * torch.randn(v.shape, generator=gen)
                         if k.endswith("_lora_b") else v + 0.05 * torch.randn(
                             v.shape, generator=gen))
                     for k, v in flatten(params).items()
                     if is_lora_leaf(k) or k.startswith("frontend")})
    stacked = combine(params, stack_clients(pers))
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (G, B, S),
                                     generator=gen)}
    if cfg.frontend:
        batch["frontend_embeds"] = torch.randn(
            (G, B, cfg.frontend_tokens, cfg.frontend_dim), generator=gen)
    logits, aux = bundle.logits_stacked(stacked, batch)
    loss, m = bundle.lm_loss_stacked(stacked, batch)
    assert m["aux"].shape == loss.shape == (G,)
    assert aux.shape == ((G,) if family == "moe" else ())
    for g in range(G):
        own = combine(params, pers[g])
        b = {k: v[g] for k, v in batch.items()}
        want, waux = bundle.logits(own, b)
        wl, wm = bundle.lm_loss(own, b)
        np.testing.assert_allclose(logits[g].numpy(), want.numpy(),
                                   atol=1e-5)
        for got, ref in ((m["aux"][g], waux), (loss[g], wl),
                         (m["ce"][g], wm["ce"])):
            np.testing.assert_allclose(float(got), float(ref), atol=1e-5)
    if family == "moe":
        assert float(aux.min()) > 0 and float(aux[0]) != float(aux[1])
