"""Port parity for the federation spec, the client-fault model and robust
MMA: ``FaultSpec`` / ``ClientCohort`` / ``FederationSpec`` validation and
derived properties, the MER draws, ``FaultSchedule`` masks and Byzantine
sets, ``label_flip`` (all bit-equal to the JAX package); the mean /
trimmed-mean / norm-clip reductions with their cross-cohort combines
against ``repro.core.mma`` to 1e-6 (f32; the reference's reductions are
XLA sums, the port's torch sums, so the last bits may differ); and
rounds of two heterogeneous cohorts under dropout and stragglers (two
under the scaled-update attack for each reduction, one under label
flipping), against the JAX loop runner from the same
states (tests/_torch_cohort_cases.py: summaries rtol 1e-4, leaves atol
2e-5, ``comm_stats``, fault masks and weights equal).
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_cohort_cases import (FAULT_CASES, check_comm_and_draws,
                                 check_het_structure, check_leaves,
                                 check_summaries, run_case)
from _torch_cohort_cases import corpus as make_corpus
from repro.configs.base import ModelConfig as JConfig
from repro.core import mma as jmma
from repro.core import spec as jspec
from repro.core.faults import FaultSchedule as JFaultSchedule
from repro.data import attacks as jattacks
from repro.data.synthetic import synthetic_multimodal_corpus
from repro_torch.configs.base import ModelConfig
from repro_torch.core import mma, spec
from repro_torch.core.faults import FaultSchedule
from repro_torch.data import attacks

torch.set_num_threads(1)

_KW = dict(n_modalities=3, modality_dim=16, n_soft_tokens=2,
           connector_dim=24, lora_rank=2, remat=False, activation="gelu",
           vocab_size=64, dtype="float32")
J_SLM = JConfig(name="a", family="dense", n_layers=1, d_model=24, n_heads=2,
                n_kv_heads=2, head_dim=8, d_ff=48, **_KW)
J_SLM_B = JConfig(name="b", family="dense", n_layers=1, d_model=32,
                  n_heads=2, n_kv_heads=2, head_dim=8, d_ff=64, **_KW)
J_LLM = JConfig(name="l", family="dense", n_layers=1, d_model=32, n_heads=2,
                n_kv_heads=2, head_dim=8, d_ff=64, **_KW)


def port(cfg: JConfig) -> ModelConfig:
    return ModelConfig(**dataclasses.asdict(cfg))


# ---------------------------------------------------------------------------
# FaultSpec / ClientCohort / FederationSpec

FAULT_SPEC_CASES = [
    dict(dropout=1.0), dict(straggler=-0.1), dict(byzantine=1.5),
    dict(max_delay=0), dict(attack="bogus"), dict(attack_scale=0.0),
    dict(byzantine=0.2), dict(dropout=0.3, straggler=0.2, max_delay=3,
                              byzantine=0.25, attack="label_flip", seed=4),
]


@pytest.mark.parametrize("kw", FAULT_SPEC_CASES,
                         ids=range(len(FAULT_SPEC_CASES)))
def test_fault_spec_validation_matches_reference(kw):
    outcome = []
    for mod in (jspec, spec):
        try:
            outcome.append(("ok", dataclasses.asdict(mod.FaultSpec(**kw))))
        except ValueError as e:
            outcome.append(("ValueError", str(e)))
    assert outcome[0] == outcome[1]
    assert spec.ATTACKS == jspec.ATTACKS


COHORT_CASES = [
    dict(n_clients=0), dict(batch_size=0), dict(local_steps_amt=0),
    dict(data_fraction=0.0), dict(rho=1.5), dict(modalities=()),
    dict(modalities=(1, 1)), dict(modalities=(-1,)), dict(modalities=(3,)),
    dict(n_clients=3, modalities=[2, 0], rho=0.4, data_fraction=0.5,
         batch_size=4, local_steps_ccl=2, local_steps_amt=3, name="x"),
]


@pytest.mark.parametrize("kw", COHORT_CASES, ids=range(len(COHORT_CASES)))
def test_client_cohort_validation_matches_reference(kw):
    outcome = []
    for mod, cfg in ((jspec, J_SLM), (spec, port(J_SLM))):
        try:
            c = mod.ClientCohort(model=cfg, **kw)
            d = dataclasses.asdict(c)
            d.pop("model")
            outcome.append(("ok", d))
        except ValueError as e:
            outcome.append(("ValueError", str(e)))
    assert outcome[0] == outcome[1]


def _specs(cohorts, server_slm=None, llm=J_LLM, **kw):
    """The reference's and the port's FederationSpec from one description:
    ``cohorts`` is a list of (JAX model config, ClientCohort kwargs)."""
    out = []
    for mod, conv in ((jspec, lambda c: c), (spec, port)):
        out.append(mod.FederationSpec(
            cohorts=tuple(mod.ClientCohort(model=conv(m), **ck)
                          for m, ck in cohorts),
            server_llm=conv(llm),
            server_slm=None if server_slm is None else conv(server_slm),
            **kw))
    return out


SPEC_ERRORS = {
    "no_cohorts": dict(cohorts=[]),
    "mode": dict(mode="fedprox"),
    "engine": dict(engine="async"),
    "score": dict(ccl_score="dot"),
    "staleness": dict(staleness=1, engine="loop"),
    "robust": dict(robust="median"),
    "trim": dict(trim_frac=0.5),
    "rho": dict(rho=1.2),
    "iface": dict(llm=dataclasses.replace(J_LLM, connector_dim=32)),
}


@pytest.mark.parametrize("name", sorted(SPEC_ERRORS))
def test_federation_spec_validation_matches_reference(name):
    kw = dict(SPEC_ERRORS[name])
    cohorts = kw.pop("cohorts", [(J_SLM, dict(n_clients=2))])
    llm = kw.pop("llm", J_LLM)
    msgs = []
    for mod, conv in ((jspec, lambda c: c), (spec, port)):
        with pytest.raises(ValueError) as e:
            mod.FederationSpec(
                cohorts=tuple(mod.ClientCohort(model=conv(m), **ck)
                              for m, ck in cohorts),
                server_llm=conv(llm), **kw)
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]


HET = [(J_SLM, dict(n_clients=2, name="A", modalities=(0, 1))),
       (J_SLM_B, dict(n_clients=3, name="B", modalities=(2,), rho=0.9,
                      batch_size=4, local_steps_ccl=2, data_fraction=0.5)),
       (J_SLM, dict(n_clients=1, name="C", rho=0.3))]


@pytest.mark.parametrize("seed", [0, 5])
def test_federation_spec_derived_properties_match_reference(seed):
    js, ts = _specs(HET, server_slm=J_SLM_B, seed=seed, rho=0.6,
                    robust="trimmed_mean", engine="loop")
    assert ts.n_cohorts == js.n_cohorts == 3
    assert ts.n_devices == js.n_devices == 6
    assert ts.offsets == js.offsets
    assert [ts.cohort_of(j) for j in range(6)] == \
        [js.cohort_of(j) for j in range(6)]
    with pytest.raises(IndexError):
        ts.cohort_of(6)
    for c in range(3):
        assert ts.cohort_rho(c) == js.cohort_rho(c)
        assert ts.cohort_batch_size(c) == js.cohort_batch_size(c)
        assert ts.cohort_steps_ccl(c) == js.cohort_steps_ccl(c)
        assert ts.cohort_steps_amt(c) == js.cohort_steps_amt(c)
        assert ts.mask_seed(c) == js.mask_seed(c)
        a, b = ts.modality_subset(c, 3), js.modality_subset(c, 3)
        assert (a is None and b is None) or np.array_equal(a, b)
    assert ts.resolved_server_slm == port(js.resolved_server_slm)
    with pytest.raises(ValueError, match="out of range"):
        ts.modality_subset(1, 2)
    # MER draws: subsets and rho overrides, bit for bit
    np.testing.assert_array_equal(ts.draw_masks(3), js.draw_masks(3))
    assert ts.draw_masks(3)[2:5, :2].sum() == 0          # cohort B: {2}
    # the derived legacy view
    tc, jc = ts.to_config(), js.to_config()
    assert {f.name: getattr(tc, f.name) for f in dataclasses.fields(tc)} \
        == {f.name: getattr(jc, f.name) for f in dataclasses.fields(jc)}


def test_from_legacy_matches_reference():
    from repro.core.federated import FederatedConfig as JFedConfig
    from repro_torch.core.federated import FederatedConfig
    kw = dict(n_devices=4, rounds=2, rho=0.5, seed=3, engine="loop",
              robust="norm_clip", trim_frac=0.1)
    js = jspec.FederationSpec.from_legacy(JFedConfig(**kw), J_SLM, J_LLM)
    ts = spec.FederationSpec.from_legacy(FederatedConfig(**kw),
                                         port(J_SLM), port(J_LLM))
    assert ts.n_devices == js.n_devices and ts.offsets == js.offsets
    assert ts.cohorts[0].name == js.cohorts[0].name == "legacy"
    for f in spec.PROTOCOL_FIELDS:
        assert getattr(ts, f) == getattr(js, f), f
    np.testing.assert_array_equal(ts.draw_masks(3), js.draw_masks(3))
    np.testing.assert_array_equal(
        ts.draw_masks(3), spec.draw_masks(3, 4, 3, 0.5))


# ---------------------------------------------------------------------------
# FaultSchedule and the attacks

SCHEDULES = [
    dict(dropout=0.2, straggler=0.2, max_delay=2, byzantine=0.15,
         attack="scaled_update", seed=3),
    dict(dropout=0.4, straggler=0.5, max_delay=3, byzantine=0.25,
         attack="label_flip", seed=9),
    dict(dropout=0.99, straggler=0.99, max_delay=4, seed=0),
    dict(straggler=0.6, max_delay=3, seed=2),
]


@pytest.mark.parametrize("n", [5, 8, 13])
@pytest.mark.parametrize("case", range(len(SCHEDULES)))
def test_fault_schedule_bit_equal(case, n):
    kw = SCHEDULES[case]
    j = JFaultSchedule(jspec.FaultSpec(**kw), n)
    t = FaultSchedule(spec.FaultSpec(**kw), n)
    np.testing.assert_array_equal(t.byzantine, j.byzantine)
    for r in reversed(range(12)):          # any query order
        for a, b in zip(t.round_masks(r), j.round_masks(r)):
            np.testing.assert_array_equal(a, b)
        assert (t.round_masks(r)[0] & t.round_masks(r)[1]).any()


@pytest.fixture(scope="module")
def corpus():
    return synthetic_multimodal_corpus(0, 96, 16, 64, n_classes=4,
                                       n_modalities=3, modality_dim=16,
                                       template_len=4)


@pytest.mark.parametrize("seed", [0, 31_004])
def test_label_flip_bit_equal(corpus, seed):
    want = jattacks.label_flip(corpus, seed=seed)
    got = attacks.label_flip(corpus, seed=seed)
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(np.asarray(got[k]), np.asarray(want[k]))
    assert np.all(got["label"] != corpus["label"])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_scaled_update_bit_equal(dtype):
    rng = np.random.RandomState(0)
    x = rng.randn(3, 5).astype(np.float32)
    jd = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}[dtype]
    td = {"float32": torch.float32, "bfloat16": torch.bfloat16}[dtype]
    want = jattacks.scaled_update({"k": jnp.asarray(x, jd)}, 10.0)["k"]
    got = attacks.scaled_update({"k": torch.from_numpy(x).to(td)}, 10.0)["k"]
    assert got.dtype == td
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(want, np.float32))


# ---------------------------------------------------------------------------
# robust MMA and the cross-cohort combines

def _stack(rng, n, shapes, scale_row=None):
    out = {}
    for k, s in shapes.items():
        v = rng.randn(n, *s).astype(np.float32)
        if scale_row is not None:
            v[scale_row] *= 10.0
        out[k] = v
    return out


def _close(got, want, tol=1e-6):
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(got[k].float().numpy(),
                                   np.asarray(want[k], np.float32),
                                   atol=tol, rtol=tol, err_msg=k)


SHAPES = {"a": (4, 3), "b": (5,), "c": (2, 2, 3)}
PRESENT = {"all": None, "some": [1, 0, 1, 1, 0, 1, 1],
           "one": [0, 0, 0, 1, 0, 0, 0]}


@pytest.mark.parametrize("pres", sorted(PRESENT))
@pytest.mark.parametrize("robust", ["mean", "trimmed_mean", "norm_clip"])
def test_aggregate_stacked_matches_reference(robust, pres):
    rng = np.random.RandomState(1)
    ups = _stack(rng, 7, SHAPES, scale_row=2)
    counts = rng.randint(1, 4, 7)
    p = PRESENT[pres]
    w = np.asarray(jmma.aggregation_weights(counts, present=p))
    np.testing.assert_array_equal(
        mma.aggregation_weights(counts, present=p).numpy(), w)
    for trim, clip in ((0.2, None), (0.4, None), (0.2, 0.5)):
        if robust != "norm_clip" and clip is not None:
            continue
        want = jmma.aggregate_stacked(
            {k: jnp.asarray(v) for k, v in ups.items()}, w, robust=robust,
            present=p, trim_frac=trim, clip=clip)
        got = mma.aggregate_stacked(
            {k: torch.from_numpy(v) for k, v in ups.items()}, w,
            robust=robust, present=p, trim_frac=trim, clip=clip)
        _close(got, want)
    if p is not None:
        np.testing.assert_allclose(mma.renormalize(w, p).numpy(),
                                   np.asarray(jmma.renormalize(w, p)),
                                   rtol=1e-7)


def test_renormalize_zero_mass_gives_zeros():
    z = mma.renormalize([0.5, 0.5], [0, 0])
    np.testing.assert_array_equal(z.numpy(), np.zeros(2, np.float32))
    np.testing.assert_array_equal(
        z.numpy(), np.asarray(jmma.renormalize([0.5, 0.5], [0, 0])))


# cohort 0 shares a and b, cohort 1 shares b and c, cohort 2 only c
SHARED = [("a", "b"), ("b", "c"), ("c",)]
SIZES = (3, 2, 2)
COMBINE_PRESENT = {"all": None,
                   "c1_lost": [[1, 0, 1], [0, 0], [1, 1]],
                   "a_lost": [[0, 0, 0], [1, 0], [0, 1]]}


def _cohort_inputs(seed=2):
    rng = np.random.RandomState(seed)
    ups = [_stack(rng, n, SHAPES) for n in SIZES]
    w = np.asarray(jmma.aggregation_weights(rng.randint(1, 4, sum(SIZES))))
    ws = np.split(w, np.cumsum(SIZES)[:-1])
    return ups, ws


@pytest.mark.parametrize("pres", sorted(COMBINE_PRESENT))
def test_combine_cohort_partials_matches_reference(pres):
    ups, ws = _cohort_inputs()
    p = COMBINE_PRESENT[pres]
    if p is not None:
        ws = [w * np.asarray(m, np.float32) for w, m in zip(ws, p)]
    jparts = [jmma.partial_aggregate_stacked(
        {k: jnp.asarray(v) for k, v in u.items()}, w)
        for u, w in zip(ups, ws)]
    tparts = [mma.partial_aggregate_stacked(
        {k: torch.from_numpy(v) for k, v in u.items()}, w)
        for u, w in zip(ups, ws)]
    for jp, tp in zip(jparts, tparts):
        _close(tp, jp)
    totals = [float(np.float32(w.sum(dtype=np.float32))) for w in ws]
    want = jmma.combine_cohort_partials(
        jparts, SHARED, totals, {k: jnp.float32 for k in SHAPES})
    got = mma.combine_cohort_partials(
        tparts, SHARED, totals, {k: torch.float32 for k in SHAPES})
    _close(got, want)
    if pres == "a_lost":
        assert "a" not in got        # the only cohort sharing it is gone


@pytest.mark.parametrize("pres", sorted(COMBINE_PRESENT))
@pytest.mark.parametrize("robust", ["trimmed_mean", "norm_clip"])
def test_robust_combine_cohorts_matches_reference(robust, pres):
    ups, ws = _cohort_inputs(seed=3)
    p = COMBINE_PRESENT[pres]
    if p is not None:
        ws = [w * np.asarray(m, np.float32) for w, m in zip(ws, p)]
    want = jmma.robust_combine_cohorts(
        [{k: jnp.asarray(v) for k, v in u.items()} for u in ups], ws,
        SHARED, {k: jnp.float32 for k in SHAPES}, robust, present=p,
        trim_frac=0.2)
    got = mma.robust_combine_cohorts(
        [{k: torch.from_numpy(v) for k, v in u.items()} for u in ups], ws,
        SHARED, {k: torch.float32 for k in SHAPES}, robust, present=p,
        trim_frac=0.2)
    _close(got, want)
    if pres == "a_lost":
        assert "a" not in got


# ---------------------------------------------------------------------------
# rounds of heterogeneous cohorts under faults, per reduction

@pytest.fixture(scope="module")
def round_corpus():
    return make_corpus()


@pytest.fixture(scope="module", params=sorted(FAULT_CASES))
def fault_case(request, round_corpus):
    return run_case(request.param, FAULT_CASES[request.param], round_corpus)


def test_fault_round_summaries_match_jax(fault_case):
    check_summaries(fault_case)


def test_fault_round_leaves_match_jax(fault_case):
    check_leaves(fault_case)


def test_fault_round_comm_and_draws_match_jax(fault_case):
    check_comm_and_draws(fault_case)


def test_fault_round_offline_clients_stay_frozen(fault_case):
    """Someone is offline in the case's rounds; an offline client's
    leaves equal the JAX runner's (already checked) and its shuffle
    streams advanced as if it had trained; a Byzantine client exists;
    the trimmed mean drops an upload from each end of some key."""
    tr = fault_case["tr"]
    check_het_structure(tr)
    if tr.cfg.robust == "trimmed_mean":
        trims = []
        for m in fault_case["masks"]:
            contrib = m[1][1]
            for k in set().union(*(rt.shared for rt in tr.cohorts)):
                n = sum(int(contrib[rt.slice].sum()) for rt in tr.cohorts
                        if k in rt.shared)
                trims.append(min(int(tr.cfg.trim_frac * n), (n - 1) // 2))
        assert max(trims) >= 1
    offline = [~m[1][0] for m in fault_case["masks"]]
    assert any(o.any() for o in offline)
    assert tr._faults.byzantine.sum() == round(0.25 * tr.spec.n_devices)
    for j in range(tr.spec.n_devices):
        assert tr._streams.pulled(f"priv/{j}") == len(fault_case["masks"])
