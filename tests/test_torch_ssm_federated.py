"""Training the ssm and hybrid families through the port's
``FederatedRunner`` against the JAX runner, one round on each engine.

One ``FederationSpec`` of two cohorts: a toy ssm model (mamba2's block:
LoRA on ``in_proj`` and ``out_proj``) × 2 clients on modalities 0–1, and
a toy hybrid model (hymba's layer: attention and the SSD mixer in
parallel, LoRA on wq, wo, in_proj, out_proj) × 2 on modality 2.  The
server SLM is the first cohort's model, so the hybrid cohort shares its
``layers/ssm/*`` LoRA keys with it and owns its attention keys.  The
sequence (16 tokens after 2 soft tokens) spans three chunks of 8, so the
chunk end states and their gradient are live.  Both runners start from
the JAX runner's states (``tests/_torch_cohort_cases.py``); summaries are
held at rtol 1e-4, every LoRA leaf at atol 2e-5, ``comm_stats``, the
cohorts' shared / own keys and the fault draws equal.  Engines: the loop,
the vectorized (stacked ssm passes, grouped C on in_proj / out_proj) and
the overlap engine at staleness 1.
"""
import dataclasses

import numpy as np
import pytest

from _torch_cohort_cases import (SLM, carried_state, check_comm_and_draws,
                                 check_leaves, check_summaries, make_specs)
from repro.core.federated import FederatedRunner as JRunner
from repro.data.synthetic import synthetic_multimodal_corpus
from repro_torch.core.federated import FederatedRunner

_SSD = dict(ssm_state=8, ssm_head_dim=8, ssm_chunk=8)
SSM = dataclasses.replace(
    SLM, name="coh-ssm", family="ssm", lora_targets=("in_proj", "out_proj"),
    **_SSD)
HYBRID = dataclasses.replace(
    SLM, name="coh-hybrid", family="hybrid",
    lora_targets=("wq", "wo", "in_proj", "out_proj"), **_SSD)
COHORTS = ((SSM, dict(n_clients=2, name="S", modalities=(0, 1))),
           (HYBRID, dict(n_clients=2, name="Y", modalities=(2,))))
ENGINES = {"loop": {}, "vectorized": {},
           "overlap": dict(staleness=1)}


def corpus(vocab=64):
    return synthetic_multimodal_corpus(0, 96, 16, vocab, n_classes=4,
                                       n_modalities=3, modality_dim=16,
                                       template_len=4)


@pytest.mark.parametrize("engine", sorted(ENGINES))
def test_ssm_and_hybrid_cohorts_match_jax(engine):
    """One evaluated round of the two-cohort spec on ``engine``, from the
    JAX runner's states: the ssm family's stacked pass (no longer
    refused), the chunked SSD's backward through both cohorts' SSD
    blocks and the server SLM's SE-CCL steps."""
    data = corpus()
    jsp, tsp = (dataclasses.replace(s, engine=engine, **ENGINES[engine])
                for s in make_specs(COHORTS, None, 1, {}))
    jr = JRunner(jsp, data)
    tr = FederatedRunner(tsp, data, device="cpu",
                         init_state=carried_state(jr))
    try:
        case = {"jr": jr, "tr": tr, "uplink": {}, "masks": [],
                "sums": {"jax": [], "port": []}}
        for who, r in (("jax", jr), ("port", tr)):
            case["sums"][who].append(r.run_round()["summary"])
        case["masks"].append([(r._rnd_present, r._rnd_contrib,
                               r._rnd_weights) for r in (jr, tr)])
        if engine == "overlap":
            jr.drain()
            assert len(jr._srv_q) == len(tr._srv_q) == 1
        ssm_c, hyb_c = tr.cohorts
        assert not ssm_c.own and hyb_c.own and hyb_c.shared
        assert all(k.startswith("layers/ssm/") for k in hyb_c.shared)
        assert all(np.isfinite(v) for v in case["sums"]["port"][0].values()
                   if isinstance(v, float))
        check_summaries(case)
        check_leaves(case)
        check_comm_and_draws(case)
    finally:
        for r in (jr, tr):
            if hasattr(r, "close"):
                r.close()


def test_runner_refuses_a_corpus_past_a_models_vocabulary():
    """Token ids at or past a model's vocabulary (hymba's 32,001 under a
    GPT-2 corpus of 50,257) would index past its embedding: the runner
    refuses them, naming the models."""
    _, tsp = make_specs(COHORTS, None, 1, {})
    with pytest.raises(ValueError, match="coh-ssm"):
        FederatedRunner(tsp, corpus(vocab=96), device="cpu")
