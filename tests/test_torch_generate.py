"""Port parity for ring-cache serving: ``prefill`` + ``decode_step`` of the
dense, windowed, gemma3-pattern, ssm, hybrid and vlm families, the ring
against a full cache on a wrapped window, ``generate`` and
``_reseat_cache``, each against the JAX package on the same weights
(made by the JAX init, LoRA B filled from a numpy seed, carried over by
``interop``) at the sizes of tests/test_models.py (float32, 2 layers,
d 32).

Tolerance 2e-4 (float32; tests/test_models.py holds decode against
forward at 2e-3 within the reference).  On the CPU the ring decode runs
kernel A's plain version, with the ring read as one page per row.

The reference's ``generate`` is wrong with a prefix (ROADMAP, faults in
the reference): it sizes the cache for S + max_new and decodes the first
token at position S, not P + S.  So the vlm case is held against the
reference's own prefill / decode_step loop at the right positions, and
``test_reference_generate_misplaces_a_prefix`` pins the fault.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import lora as jlora
from repro.launch import serve as jserve
from repro_torch.launch.serve import _reseat_cache, generate
from repro_torch.launch.serve_engine import EngineConfig, ServingEngine
from test_torch_serving import port_pair, serving_cfg, strip_adapters

torch.set_num_threads(1)

F32 = dict(atol=2e-4, rtol=2e-4)

# tests/test_models.py's families that the port serves
FAMS = {
    "dense": dict(family="dense"),
    "dense_swa": dict(family="dense", sliding_window=8),
    "gemma3_pattern": dict(family="dense", sliding_window=8, global_every=2),
    "ssm": dict(family="ssm", ssm_state=8, ssm_head_dim=16, ssm_chunk=8),
    "hybrid": dict(family="hybrid", ssm_state=8, ssm_head_dim=16,
                   ssm_chunk=8, lora_targets=("wq", "wo", "in_proj")),
    "vlm": dict(family="vlm", frontend="vision", frontend_tokens=8,
                frontend_dim=24),
}
B, S, K = 2, 16, 3


def _np(x):
    return x.float().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x, np.float32)


@functools.lru_cache(maxsize=None)
def jitted(jcfg):
    """The reference bundle's logits / prefill / decode_step, each jitted
    once (an eager call retraces its layer scan every time)."""
    jb = port_pair(jcfg)[0]
    return (jax.jit(jb.logits), jax.jit(jb.prefill),
            jax.jit(jb.decode_step))


@functools.lru_cache(maxsize=None)
def case(fam):
    """The tokens (and frontend features) of a family case and the JAX
    side: full-forward logits, prefill logits, K decode steps' logits."""
    jb, jp, tb, tp = port_pair(serving_cfg(**FAMS[fam]))
    rng = np.random.RandomState(7)
    toks = rng.randint(0, jb.cfg.vocab_size, (B, S + K)).astype(np.int32)
    extra = {}
    if jb.cfg.frontend:
        extra["frontend_embeds"] = (rng.randn(
            B, jb.cfg.frontend_tokens, jb.cfg.frontend_dim) * 0.5
        ).astype(np.float32)
    jextra = {k: jnp.asarray(v) for k, v in extra.items()}
    j_logits, j_prefill, j_decode = jitted(jb.cfg)
    full, _ = j_logits(jp, {"tokens": jnp.asarray(toks), **jextra})
    P = full.shape[1] - (S + K)
    last, pcache = j_prefill(jp, {"tokens": jnp.asarray(toks[:, :S]),
                                  **jextra})
    cache = jserve._reseat_cache(jb.init_cache(B, P + S + K), pcache)
    steps = []
    for i in range(K):
        logits, cache = j_decode(jp, cache,
                                 jnp.asarray(toks[:, S + i:S + i + 1]),
                                 jnp.int32(P + S + i))
        steps.append(_np(logits))
    return toks, extra, P, _np(full), _np(last), steps


def port_decode(fam):
    """The port's prefill logits and K decode steps' logits."""
    toks, extra, P, _, _, _ = case(fam)
    _, _, tb, tp = port_pair(serving_cfg(**FAMS[fam]))
    textra = {k: torch.from_numpy(v) for k, v in extra.items()}
    t = torch.from_numpy(toks).long()
    with torch.no_grad():
        last, pcache = tb.prefill(tp, {"tokens": t[:, :S], **textra})
        cache = _reseat_cache(tb.init_cache(B, P + S + K, "cpu"), pcache)
        steps = []
        for i in range(K):
            logits, cache = tb.decode_step(tp, cache, t[:, S + i:S + i + 1],
                                           P + S + i)
            steps.append(logits.numpy())
    return last.numpy(), steps


@pytest.mark.parametrize("fam", list(FAMS))
def test_prefill_decode_match_reference_forward(fam):
    """prefill(S) + decode(S..S+K-1) == the reference's forward(S+K)."""
    _, _, P, full, _, _ = case(fam)
    last, steps = port_decode(fam)
    np.testing.assert_allclose(last, full[:, P + S - 1], **F32)
    for i, got in enumerate(steps):
        np.testing.assert_allclose(got, full[:, P + S + i],
                                   err_msg=f"step {i}", **F32)


@pytest.mark.parametrize("fam", list(FAMS))
def test_decode_steps_match_reference_decode_step(fam):
    """The port's prefill and each of K decode steps against the
    reference's ``prefill`` / ``decode_step`` on the same cache
    positions."""
    _, _, _, _, jlast, jsteps = case(fam)
    last, steps = port_decode(fam)
    np.testing.assert_allclose(last, jlast, **F32)
    for i, (got, want) in enumerate(zip(steps, jsteps)):
        np.testing.assert_allclose(got, want, err_msg=f"step {i}", **F32)


def test_ring_cache_wraps_like_a_full_cache():
    """A window-8 model decoding 6 tokens past a 24-token prompt from a
    ring of 8 slots (wrapped three times over) against the reference's
    forward and its own ring decode, and the ring's slots hold the
    reference's positions."""
    jcfg = serving_cfg(**FAMS["dense_swa"])
    jb, jp, tb, tp = port_pair(jcfg)
    j_logits, j_prefill, j_decode = jitted(jcfg)
    S_, K_ = 24, 6
    toks = np.random.RandomState(2).randint(0, 64, (1, S_ + K_))
    full, _ = j_logits(jp, {"tokens": jnp.asarray(toks, jnp.int32)})
    _, jcache = j_prefill(jp, {"tokens": jnp.asarray(toks[:, :S_],
                                                     jnp.int32)})
    t = torch.from_numpy(toks).long()
    with torch.no_grad():
        _, cache = tb.prefill(tp, {"tokens": t[:, :S_]})
        assert cache["k"].shape[2] == 8
        np.testing.assert_array_equal(cache["pos"].numpy(),
                                      np.asarray(jcache["pos"]))
        for i in range(K_):
            jlogits, jcache = j_decode(
                jp, jcache, jnp.asarray(toks[:, S_ + i:S_ + i + 1],
                                        jnp.int32), jnp.int32(S_ + i))
            logits, cache = tb.decode_step(tp, cache,
                                           t[:, S_ + i:S_ + i + 1], S_ + i)
            np.testing.assert_allclose(logits.numpy(), _np(full)[:, S_ + i],
                                       err_msg=f"step {i}", **F32)
            np.testing.assert_allclose(logits.numpy(), _np(jlogits),
                                       err_msg=f"step {i}", **F32)
    np.testing.assert_array_equal(cache["pos"].numpy(),
                                  np.asarray(jcache["pos"]))
    np.testing.assert_allclose(cache["k"].numpy(), _np(jcache["k"]), **F32)


@pytest.mark.parametrize("fam", ["dense", "dense_swa", "ssm", "hybrid"])
def test_generate_matches_reference_generate_greedy(fam):
    """Equal greedy tokens, the port's merge against the reference's
    merged weights without adapter leaves (merge=False: its own merge
    would apply the adapters twice)."""
    jcfg = serving_cfg(**FAMS[fam])
    jb, jp, tb, tp = port_pair(jcfg)
    toks = np.random.RandomState(5).randint(0, 64, (2, 11)).astype(np.int32)
    want = jserve.generate(jb, strip_adapters(jlora.merge_lora(jp, jcfg)),
                           jnp.asarray(toks), max_new=12, merge=False)
    got = generate(tb, tp, torch.from_numpy(toks).long(), max_new=12)
    assert got.shape == (2, 12)
    assert got.tolist() == np.asarray(want).tolist()


@functools.lru_cache(maxsize=None)
def vlm_case():
    """The vlm prompt (2 x 9 tokens, 8 frontend tokens), the reference's
    merged weights without adapter leaves, and its greedy tokens from its
    own prefill / decode_step at the right positions and capacity (P + S
    + max_new)."""
    jcfg = serving_cfg(**FAMS["vlm"])
    jb, jp, _, _ = port_pair(jcfg)
    rng = np.random.RandomState(6)
    toks = rng.randint(0, 64, (2, 9)).astype(np.int32)
    fe = (rng.randn(2, jcfg.frontend_tokens, jcfg.frontend_dim)
          * 0.5).astype(np.float32)
    merged = strip_adapters(jlora.merge_lora(jp, jcfg))
    _, j_prefill, j_decode = jitted(jcfg)
    P, (B_, S_) = jcfg.frontend_tokens, toks.shape
    logits, pcache = j_prefill(merged, {"tokens": jnp.asarray(toks),
                                        "frontend_embeds": jnp.asarray(fe)})
    cache = jserve._reseat_cache(jb.init_cache(B_, P + S_ + VLM_NEW), pcache)
    out = []
    for i in range(VLM_NEW):
        tok = jnp.argmax(logits, axis=-1)[:, None].astype(jnp.int32)
        out.append(np.asarray(tok))
        logits, cache = j_decode(merged, cache, tok, jnp.int32(P + S_ + i))
    return toks, fe, merged, np.concatenate(out, axis=1)


VLM_NEW = 10


def test_generate_with_frontend_matches_reference_loop():
    toks, fe, _, want = vlm_case()
    _, _, tb, tp = port_pair(serving_cfg(**FAMS["vlm"]))
    got = generate(tb, tp, torch.from_numpy(toks).long(), max_new=VLM_NEW,
                   batch_extra={"frontend_embeds": torch.from_numpy(fe)})
    assert got.tolist() == want.tolist()


def test_reference_generate_misplaces_a_prefix():
    """The reference's ``generate`` decodes the first token at position S
    (over the prompt's own cache entries) rather than P + S: its greedy
    tokens leave its own correctly placed loop's."""
    toks, fe, merged, right = vlm_case()
    jb = port_pair(serving_cfg(**FAMS["vlm"]))[0]
    wrong = np.asarray(jserve.generate(
        jb, merged, jnp.asarray(toks), max_new=VLM_NEW, merge=False,
        batch_extra={"frontend_embeds": jnp.asarray(fe)}))
    assert (wrong[:, 0] == right[:, 0]).all()     # from the prefill
    assert (wrong != right).any()


def test_engine_matches_generate_greedy():
    """The paged engine's greedy tokens equal ``generate``'s, request by
    request (tests/test_serving.py's mix), merge on both sides."""
    _, _, tb, tp = port_pair(serving_cfg())
    econf = EngineConfig(n_slots=2, page_size=4, n_pages=32,
                         max_pages_per_seq=8, max_out=16, buckets=(8, 16),
                         device="cpu")
    engine = ServingEngine(tb, tp, econf)
    rng = np.random.RandomState(3)
    reqs = [(rng.randint(0, 64, (n,)).astype(np.int32), m)
            for n, m in [(5, 6), (8, 3), (12, 9), (3, 1), (9, 12), (6, 4)]]
    rids = [engine.submit(t, max_new=m) for t, m in reqs]
    done = engine.run()
    for rid, (toks, m) in zip(rids, reqs):
        want = generate(tb, tp, torch.from_numpy(toks).long()[None],
                        max_new=m)
        assert done[rid].out.tolist() == want[0].tolist(), f"req {rid}"


def test_generate_sampling_is_seeded():
    _, _, tb, tp = port_pair(serving_cfg())
    toks = torch.arange(14).reshape(2, 7) % 64
    outs = [generate(tb, tp, toks, max_new=10, temperature=1.5,
                     generator=torch.Generator().manual_seed(s)).tolist()
            for s in (0, 0, 1)]
    assert outs[0] == outs[1]
    assert outs[0] != outs[2]
    with pytest.raises(ValueError, match="Generator"):
        generate(tb, tp, toks, max_new=2, temperature=1.0)


# ---------------------------------------------------------------------------
# _reseat_cache (tests/test_serving.py's routing cases)

def test_reseat_routes_kv_and_pos():
    big = {"k": torch.zeros((2, 1, 12, 2, 8)), "v": torch.zeros((2, 1, 12, 2, 8)),
           "pos": torch.full((2, 12), -1)}
    small = {"k": torch.ones((2, 1, 8, 2, 8)), "v": torch.ones((2, 1, 8, 2, 8)),
             "pos": torch.arange(8).repeat(2, 1)}
    out = _reseat_cache(big, small)
    assert out["k"].shape == (2, 1, 12, 2, 8)
    assert (out["k"][:, :, :8] == 1).all() and (out["k"][:, :, 8:] == 0).all()
    assert out["pos"][0].tolist() == list(range(8)) + [-1] * 4
    same = {"pos": torch.full((2, 12), 3)}
    assert _reseat_cache(big, same)["pos"] is same["pos"]


def test_reseat_state_shape_mismatch_raises():
    with pytest.raises(ValueError, match="match exactly"):
        _reseat_cache({"ssm_h": torch.zeros((2, 1, 4, 16, 8))},
                      {"ssm_h": torch.zeros((2, 1, 4, 16, 4))})


def test_reseat_unknown_leaf_raises():
    with pytest.raises(KeyError):
        _reseat_cache({"k": torch.zeros((1, 1, 4, 1, 4)),
                       "mystery": torch.zeros(3)},
                      {"mystery": torch.zeros(3)})
    with pytest.raises(KeyError):     # a leaf absent from the serving cache
        _reseat_cache({"k": torch.zeros((1, 1, 4, 1, 4))},
                      {"ssm_h": torch.zeros(3)})
