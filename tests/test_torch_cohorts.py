"""Port parity for heterogeneous cohorts on the loop engine, and for
``CohortServer``.

The round cases (tests/_torch_cohort_cases.py) hold the port's
``FederatedRunner(FederationSpec(...), corpus, engine="loop")`` against
the JAX loop runner from the same states: two cohorts of different
``d_model`` on disjoint modality subsets (one with its own rho and batch
size) under fedavg and standalone, and under mlecs over the int8 wire
with client faults, and one cohort whose server SLM only partly shares
its shapes.  Summaries rtol 1e-4, every client's and the server's LoRA
leaves atol 2e-5, ``comm_stats`` equal.  Plain mlecs over the two
cohorts, and the robust reductions, are the fault cases of
tests/test_torch_faults.py.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_cohort_cases import (COHORT_CASES, HET, check_comm_and_draws,
                                 check_het_structure, check_leaves,
                                 check_summaries, flat_numpy, make_specs,
                                 port_cfg, run_case)
from _torch_cohort_cases import corpus as make_corpus
from repro.configs.base import ModelConfig as JConfig
from repro.core import lora as jlora
from repro.core import spec as jspec
from repro.launch.serve_engine import CohortServer as JCohortServer
from repro.launch.serve_engine import EngineConfig as JEngineConfig
from repro_torch import interop
from repro_torch.core import lora, spec
from repro_torch.core.federated import FederatedRunner
from repro_torch.launch.serve_engine import CohortServer, EngineConfig

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def corpus():
    return make_corpus()


@pytest.fixture(scope="module", params=sorted(COHORT_CASES))
def case(request, corpus):
    return run_case(request.param, COHORT_CASES[request.param], corpus)


def test_cohort_round_summaries_match_jax(case):
    check_summaries(case)


def test_cohort_round_leaves_match_jax(case):
    check_leaves(case)


def test_cohort_round_comm_and_draws_match_jax(case):
    check_comm_and_draws(case)


def test_cohort_structure_of_the_cases(case):
    """What each case exercises: disjoint modality subsets, own keys and
    shared frozen bases; the partial overlap's single cohort with own
    keys; standalone moving nothing."""
    tr = case["tr"]
    if case["name"] == "partial-overlap":
        (rt,) = tr.cohorts
        assert rt.own and rt.shared and not tr._homogeneous
        return
    check_het_structure(tr)
    if case["name"] == "het-standalone":
        assert tr.comm_stats["uplink_bytes"] == 0


# ---------------------------------------------------------------------------
# the legacy cohort base key, and what the spec form refuses

def test_spec_runner_refuses_unported(corpus):
    _, tspec = make_specs(HET, None, 1, {})
    with pytest.raises(TypeError, match="ParticipantSampler"):
        FederatedRunner(dataclasses.replace(
            tspec, sampler=jspec.ParticipantSampler(per_cohort=1)), corpus,
            device="cpu")
    with pytest.raises(TypeError, match="FaultSpec"):
        FederatedRunner(dataclasses.replace(
            tspec, faults=jspec.FaultSpec(dropout=0.1)), corpus,
            device="cpu")
    with pytest.raises(TypeError):
        FederatedRunner(tspec, corpus, corpus, device="cpu")
    r = FederatedRunner(tspec, corpus, device="cpu")
    with pytest.raises(AttributeError, match="single-cohort"):
        r.cohort_base
    assert len(r.cohort_bases) == 2 and len(r.device_params) == 5


# ---------------------------------------------------------------------------
# CohortServer

SERVE_A = JConfig(name="srv-a", n_layers=2, d_model=32, n_heads=4,
                  n_kv_heads=2, head_dim=8, d_ff=64, vocab_size=64,
                  n_modalities=0, remat=False, lora_rank=2, dtype="float32")
SERVE_B = dataclasses.replace(SERVE_A, name="srv-b", d_model=48, n_heads=4,
                              n_kv_heads=2, head_dim=16, qk_norm=True,
                              activation="silu", rope_theta=1e6)
ENGINE = dict(n_slots=2, page_size=4, n_pages=32, max_pages_per_seq=8,
              max_out=16, buckets=(8, 16))


def _strip(tree):
    if isinstance(tree, dict):
        return {k: _strip(v) for k, v in tree.items()
                if not lora.is_lora_leaf(k)}
    return tree


def test_cohort_server_greedy_tokens_match_reference():
    """Two cohorts of different architectures (one with qk-norm, silu and
    GQA): equal greedy tokens per cohort at float32.  The reference is
    given merged weights without adapter leaves (merge=False), so both
    serve W + (α/r)AB."""
    specs = []
    for mod, conv in ((jspec, lambda c: c), (spec, port_cfg)):
        specs.append(mod.FederationSpec(
            cohorts=(mod.ClientCohort(model=conv(SERVE_A), n_clients=2),
                     mod.ClientCohort(model=conv(SERVE_B), n_clients=1)),
            server_llm=conv(SERVE_A), seed=0))
    from repro.models.model import build_model as jbuild
    rng = np.random.RandomState(0)
    jparams, tparams = [], []
    for c, cfg in enumerate((SERVE_A, SERVE_B)):
        jb = jbuild(cfg)
        jp = jb.init(jax.random.key(c))
        jp = jax.tree_util.tree_map_with_path(
            lambda p, x: jnp.asarray(
                rng.randn(*x.shape).astype(np.float32) * 0.05, x.dtype)
            if jlora.path_str(p).endswith("_lora_b") else x, jp)
        jparams.append(_strip(jlora.merge_lora(jp, cfg)))
        tparams.append(interop.params_from_numpy(flat_numpy(jp), "cpu",
                                                 torch.float32))
    jserver = JCohortServer(specs[0], jparams, JEngineConfig(**ENGINE),
                            merge=False)
    tserver = CohortServer(specs[1], tparams,
                           EngineConfig(device="cpu", **ENGINE))
    mix = [(5, 6), (8, 3), (12, 9), (3, 1), (9, 12)]
    ids = []
    for c in range(2):
        for n, m in mix:
            toks = rng.randint(0, 64, (n,)).astype(np.int32)
            ids.append((c, jserver.submit(c, toks, max_new=m),
                        tserver.submit(c, toks, max_new=m), m))
    jdone, tdone = jserver.serve(), tserver.serve()
    for c, jid, tid, m in ids:
        assert len(tdone[c][tid].out) == m
        assert tdone[c][tid].out.tolist() == jdone[c][jid].out.tolist()
    for e in tserver.engines:
        assert sorted(e._free_pages) == list(range(1, ENGINE["n_pages"]))
    with pytest.raises(ValueError, match="param trees"):
        CohortServer(specs[1], tparams[:1],
                     EngineConfig(device="cpu", **ENGINE))


def test_cohort_server_from_spec_serves_each_architecture():
    tspec = spec.FederationSpec(
        cohorts=(spec.ClientCohort(model=port_cfg(SERVE_A)),
                 spec.ClientCohort(model=port_cfg(SERVE_B))),
        server_llm=port_cfg(SERVE_A), seed=4)
    econf = EngineConfig(device="cpu", **ENGINE)
    a, b = CohortServer.from_spec(tspec, econf), \
        CohortServer.from_spec(tspec, econf)
    assert [e.cfg.name for e in a.engines] == ["srv-a", "srv-b"]
    for ea, eb in zip(a.engines, b.engines):     # seeded from spec.seed
        fa, fb = lora.flatten(ea.params), lora.flatten(eb.params)
        assert all(torch.equal(fa[k], fb[k]) for k in fa)
    for c in range(2):
        a.submit(c, np.arange(5, dtype=np.int32), max_new=4)
    done = a.serve()
    assert [len(d) for d in done] == [1, 1]
    assert all(len(r.out) == 4 for d in done for r in d.values())
