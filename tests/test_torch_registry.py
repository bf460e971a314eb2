"""Port parity for the registry and the families it adds: every
``ARCH_IDS`` config copy against the reference's (fields, the three
parameter counts, ``reduced()``, windows), the LoRA share of each,
``build_model`` over the registry, the vlm family's frontend prefix,
banded attention and the vlm paged engine, each against the JAX package
on the same weights.

Tolerances: float32 2e-4; bf16 6e-2 / 5e-2 (tests/test_torch_serving.py's
bound: the two frameworks round bf16 products at different points), and
the bf16 band as tests/test_torch_ssm.py holds a bf16 stack.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as jbase
from repro.core import lora as jlora
from repro.launch.serve_engine import EngineConfig as JEngineConfig
from repro.launch.serve_engine import ServingEngine as JEngine
from repro_torch.configs.base import ARCH_IDS, ModelConfig, get_config
from repro_torch.launch.serve_engine import EngineConfig, ServingEngine
from repro_torch.models.layers import padded_vocab
from repro_torch.models.model import build_model, with_overrides
from _torch_stacked_cases import multimodal, stacked_step_against_reference
from test_torch_serving import port_pair, serving_cfg, strip_adapters
from test_torch_ssm import f32_reference, hold

torch.set_num_threads(1)

F32 = dict(atol=2e-4, rtol=2e-4)
BF16 = dict(atol=6e-2, rtol=5e-2)
TOL = {"float32": F32, "bfloat16": BF16}
VLM = dict(family="vlm", frontend="vision", frontend_tokens=8,
           frontend_dim=24)


def _np(x):
    return x.float().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x, np.float32)


# ---------------------------------------------------------------------------
# the registry

def test_registry_names_the_reference_archs():
    assert ARCH_IDS == jbase.ARCH_IDS


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_config_copy_matches_reference(arch):
    ref = jbase.get_config(arch)
    cfg = get_config(arch)
    assert cfg == ModelConfig(**dataclasses.asdict(ref))
    assert cfg.n_params() == ref.n_params()
    assert cfg.n_active_params() == ref.n_active_params()
    assert cfg.n_lora_params() == ref.n_lora_params()
    assert dataclasses.asdict(cfg.reduced()) == dataclasses.asdict(ref.reduced())
    assert [cfg.window_for_layer(i) for i in range(cfg.n_layers)] == \
        [ref.window_for_layer(i) for i in range(ref.n_layers)]
    assert cfg.torch_dtype == torch.bfloat16


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_lora_communication_fraction(arch):
    """The paper's claim: a round moves a sub-percent share of the model's
    parameters (tests/test_smoke_archs.py's bound, 2 %)."""
    cfg = get_config(arch)
    assert 0 < cfg.n_lora_params() / cfg.n_params() < 0.02


def test_get_config_raises_on_an_unknown_arch():
    with pytest.raises(KeyError, match="unknown arch"):
        get_config("gpt-5")


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_build_model_covers_the_registry(arch):
    """Every config of the registry, of all six families, builds and
    serves one step at its reduced size (the encdec family's frames feed
    its encoder: no prefix ahead of the prompt)."""
    cfg = with_overrides(get_config(arch).reduced(), dtype="float32")
    bundle = build_model(cfg)
    params = bundle.init(torch.Generator().manual_seed(0))
    batch = {"tokens": torch.ones((2, 6), dtype=torch.long)}
    if cfg.frontend:
        batch["frontend_embeds"] = torch.randn(
            2, cfg.frontend_tokens, cfg.frontend_dim) * 0.3
    with torch.no_grad():
        last, cache = bundle.prefill(params, batch)
        logits, _ = bundle.decode_step(
            params, cache, torch.ones((2, 1), dtype=torch.long),
            6 + (cfg.frontend_tokens if cfg.family == "vlm" else 0) - 1)
    assert last.shape == logits.shape == (2, padded_vocab(cfg))
    assert torch.isfinite(logits).all()


# ---------------------------------------------------------------------------
# the vlm family and banded attention against the reference

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_vlm_logits_with_frontend_match_reference(dtype):
    jcfg = serving_cfg(dtype=dtype, **VLM)
    jb, jp, tb, tp = port_pair(jcfg)
    rng = np.random.RandomState(4)
    toks = rng.randint(0, 64, (2, 10)).astype(np.int32)
    fe = (rng.randn(2, 8, 24) * 0.5).astype(np.float32)
    soft = (rng.randn(2, 3, jcfg.d_model) * 0.5).astype(np.float32)
    want, _ = jb.logits(jp, {"tokens": jnp.asarray(toks),
                             "frontend_embeds": jnp.asarray(fe),
                             "prefix_embeds": jnp.asarray(soft)})
    got, _ = tb.logits(tp, {"tokens": torch.from_numpy(toks).long(),
                            "frontend_embeds": torch.from_numpy(fe),
                            "prefix_embeds": torch.from_numpy(soft)})
    assert got.shape == (2, 8 + 3 + 10, 256)
    np.testing.assert_allclose(got.numpy(), _np(want), **TOL[dtype])
    with pytest.raises(ValueError, match="frontend_embeds"):
        tb.logits(tp, {"tokens": torch.from_numpy(toks).long()})


def test_vlm_stacked_step_matches_reference():
    """One ``make_stacked_step`` of G = 3 vlm clients, B = 2 rows each,
    every client with its own adapters, connector and frontend projector
    (fp_w1 (G, F, d)), against the reference's ``vmap`` of its local step
    (tests/_torch_stacked_cases.py): each client projects its own frames
    with its own projector."""
    stacked_step_against_reference(multimodal(serving_cfg(**VLM)), G=3, B=2)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kw", [
    dict(sliding_window=8),
    dict(sliding_window=8, global_every=2),
], ids=["pure_swa", "pattern"])
def test_banded_matches_reference_banded(kw, dtype):
    """S = 40 > 2w, so the reference takes ``banded_mha`` on its local
    layers; the port's kernel B (plain version here) walks the band.  At
    bf16 the reference's band rounds its logits and weights to bf16
    (models/banded.py), so the port is held to the reference's banded
    forward at float32 on the same weights, no farther from it than the
    reference's own bf16 output (tests/test_torch_ssm.py's ``hold``)."""
    jcfg = serving_cfg(dtype=dtype, attn_impl="banded", **kw)
    jb, jp, tb, tp = port_pair(jcfg)
    toks = np.random.RandomState(9).randint(0, 64, (2, 40)).astype(np.int32)
    want, _ = jb.logits(jp, {"tokens": jnp.asarray(toks)})
    got, _ = tb.logits(tp, {"tokens": torch.from_numpy(toks).long()})
    if dtype == "float32":
        np.testing.assert_allclose(got.numpy(), _np(want), **F32)
        return
    jb32, _, jp32 = f32_reference(jcfg, jp)
    want32, _ = jb32.logits(jp32, {"tokens": jnp.asarray(toks)})
    hold(got, want, want32, "banded bf16")


def test_vlm_engine_matches_reference_engine_greedy():
    """Four vlm requests (8 frontend tokens each, one also with a soft
    prompt) through both paged engines: equal greedy tokens at float32,
    the reference given merged weights without adapter leaves."""
    jcfg = serving_cfg(**VLM)
    jb, jp, tb, tp = port_pair(jcfg)
    econf = dict(n_slots=2, page_size=4, n_pages=40, max_pages_per_seq=10,
                 max_out=8, buckets=(8, 16))
    rng = np.random.RandomState(3)
    reqs = [(rng.randint(0, 64, (n,)).astype(np.int32), m,
             (rng.randn(8, 24) * 0.5).astype(np.float32),
             (rng.randn(2, 32) * 0.5).astype(np.float32) if i == 1 else None)
            for i, (n, m) in enumerate([(5, 6), (9, 3), (12, 8), (3, 1)])]
    jengine = JEngine(jb, strip_adapters(jlora.merge_lora(jp, jcfg)),
                      JEngineConfig(**econf), merge=False)
    tengine = ServingEngine(tb, tp, EngineConfig(device="cpu", **econf))
    jrids = [jengine.submit(t, max_new=m, frontend_embeds=f, prefix_embeds=p)
             for t, m, f, p in reqs]
    trids = [tengine.submit(t, max_new=m, frontend_embeds=torch.from_numpy(f),
                            prefix_embeds=None if p is None
                            else torch.from_numpy(p))
             for t, m, f, p in reqs]
    jdone, tdone = jengine.run(), tengine.run()
    for (_, m, _, _), jr, tr in zip(reqs, jrids, trids):
        assert len(tdone[tr].out) == m
        assert tdone[tr].out.tolist() == jdone[jr].out.tolist()
    assert sorted(tengine._free_pages) == list(range(1, econf["n_pages"]))
    with pytest.raises(ValueError, match="frontend_embeds"):
        tengine.submit(reqs[0][0])
