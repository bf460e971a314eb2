"""Shared cases of the cohort and fault parity tests
(tests/test_torch_cohorts.py, tests/test_torch_faults.py).

The JAX loop runner and the port's runner are built from the same
``FederationSpec`` description (the reference's and the port's classes)
and start from the same states (the JAX runner's, carried across with
``repro_torch.interop``: one base per cohort, every client's personal
leaves, the server SLM and LLM) on one corpus, at float32 on toy configs
shaped like tests/test_robustness.py's.  Each case runs one or two rounds
of one CCL, one AMT and one SE-CCL step; then the summaries (rtol 1e-4),
every client's and the server's LoRA leaves (atol 2e-5; over the int8
wire one quantization step more, as tests/test_torch_federated.py
explains), ``comm_stats`` and each round's fault masks and weights (equal)
are compared.
"""
import dataclasses

import jax
import numpy as np
import pytest

from repro.configs.base import ModelConfig as JConfig
from repro.core import lora as jlora
from repro.core import spec as jspec
from repro.core.channel import ChannelSpec as JChannelSpec
from repro.core.federated import FederatedRunner as JRunner
from repro.data.synthetic import synthetic_multimodal_corpus
from repro_torch.configs.base import ModelConfig
from repro_torch.core import lora, spec
from repro_torch.core.channel import ChannelSpec
from repro_torch.core.federated import FederatedRunner

_KW = dict(n_modalities=3, modality_dim=16, n_soft_tokens=2,
           connector_dim=24, lora_rank=2, remat=False, activation="gelu",
           vocab_size=64, dtype="float32")
SLM = JConfig(name="coh-slm", family="dense", n_layers=1, d_model=24,
              n_heads=2, n_kv_heads=2, head_dim=8, d_ff=48, **_KW)
SLM_B = JConfig(name="coh-slm-b", family="dense", n_layers=1, d_model=32,
                n_heads=2, n_kv_heads=2, head_dim=8, d_ff=64, **_KW)
SRV = JConfig(name="coh-srv", family="dense", n_layers=1, d_model=40,
              n_heads=2, n_kv_heads=2, head_dim=8, d_ff=80, **_KW)
LLM = JConfig(name="coh-llm", family="dense", n_layers=1, d_model=32,
              n_heads=2, n_kv_heads=2, head_dim=8, d_ff=64, **_KW)

HET = ((SLM, dict(n_clients=2, name="A", modalities=(0, 1))),
       (SLM_B, dict(n_clients=3, name="B", modalities=(2,), rho=0.9,
                    batch_size=4)))
PARTIAL = ((SLM_B, dict(n_clients=2, name="P")),)
FAULTS = dict(dropout=0.25, straggler=0.25, max_delay=2, byzantine=0.25,
              attack_scale=10.0, seed=3)

# name: (cohorts, server SLM, rounds, spec kwargs).  Plain mlecs over
# two cohorts is the mean reduction's case below (a fault-masked weighted
# mean takes the same partial-sum and cross-cohort combine path), so the
# cohort cases are the other modes, the partial overlap and the int8 wire
# (under the faults: error-feedback residuals advance for present
# clients only)
COHORT_CASES = {
    "het-fedavg": (HET, None, 1, dict(mode="fedavg")),
    "het-standalone": (HET, None, 1, dict(mode="standalone")),
    "partial-overlap": (PARTIAL, SRV, 1, {}),
    "het-int8": (HET, None, 2, dict(
        channel="int8", faults=dict(FAULTS, attack="scaled_update"))),
}
# the robust reductions under the scaled-update attack over two rounds
# (the trimmed mean cuts 0.4 from each end, so the three on-time uploads
# of the keys both cohorts share in round 0 lose one each way); label
# flipping poisons the train shards at init, whatever the reduction, so
# one round of it under the mean
FAULT_CASES = {
    f"{robust}-scaled_update": (HET, None, 2, dict(
        robust=robust, faults=dict(FAULTS, attack="scaled_update"), **kw))
    for robust, kw in (("trimmed_mean", dict(trim_frac=0.4)),
                       ("norm_clip", {}))}
FAULT_CASES["mean-label_flip"] = (HET, None, 1, dict(
    robust="mean", faults=dict(FAULTS, attack="label_flip")))


def port_cfg(cfg: JConfig) -> ModelConfig:
    return ModelConfig(**dataclasses.asdict(cfg))


def flat_numpy(tree) -> dict:
    """JAX pytree -> {path_str: ndarray} (float32 trees here)."""
    return {jlora.path_str(p): np.array(leaf) for p, leaf in
            jax.tree_util.tree_flatten_with_path(tree)[0]}


def _np(t):
    return t.detach().float().numpy()


def make_specs(cohorts, server_slm, rounds, kw):
    """The reference's and the port's FederationSpec of one case."""
    out = []
    for mod, conv, chan in ((jspec, lambda c: c, JChannelSpec),
                            (spec, port_cfg, ChannelSpec)):
        k = dict(kw)
        if "faults" in k:
            k["faults"] = mod.FaultSpec(**k["faults"])
        if "channel" in k:
            k["channel"] = chan(codec=k["channel"])
        out.append(mod.FederationSpec(
            cohorts=tuple(mod.ClientCohort(model=conv(m), **ck)
                          for m, ck in cohorts),
            server_llm=conv(LLM),
            server_slm=None if server_slm is None else conv(server_slm),
            rounds=rounds, local_steps_ccl=1, local_steps_amt=1,
            server_steps=1, batch_size=8, lr=1e-2, rho=0.7, seed=0,
            engine="loop", **k))
    return out


def carried_state(jr) -> dict:
    """The JAX runner's states in the port's ``init_state`` format."""
    return {"cohort_bases": [flat_numpy(b) for b in jr._cohort_bases],
            "personal": [flat_numpy(jlora.partition(p))
                         for p in jr.device_params],
            "server_slm": flat_numpy(jr.server_slm),
            "server_llm": flat_numpy(jr.server_llm)}




def corpus():
    return synthetic_multimodal_corpus(0, 128, 16, 64, n_classes=4,
                                       n_modalities=3, modality_dim=16,
                                       template_len=4)


def run_case(name, desc, corpus):
    """Both runners through the case's rounds, recording each round's
    summary, fault masks and weights (and, over a quantized wire, each
    leaf's largest uplink input)."""
    cohorts, srv, rounds, kw = desc
    jspec_, tspec = make_specs(cohorts, srv, rounds, kw)
    jr = JRunner(jspec_, corpus)
    tr = FederatedRunner(tspec, corpus, device="cpu",
                         init_state=carried_state(jr))
    uplink = {}
    if tspec.channel is not None:
        roundtrip = jr.channel.roundtrip

        def recording(flat, state=None, rnd=0):
            for k, v in flat.items():
                x = np.abs(np.asarray(v, np.float32)
                           + (np.asarray(state[k]) if state else 0.0))
                uplink[k] = max(uplink.get(k, 0.0), float(x.max()))
            return roundtrip(flat, state, rnd)
        jr.channel.roundtrip = recording
    out = {"name": name, "jr": jr, "tr": tr, "uplink": uplink,
           "sums": {"jax": [], "port": []}, "masks": []}
    for _ in range(rounds):
        for who, r in (("jax", jr), ("port", tr)):
            out["sums"][who].append(r.run_round()["summary"])
        out["masks"].append(
            [(r._rnd_present, r._rnd_contrib, r._rnd_weights)
             for r in (jr, tr)])
    return out


def check_summaries(case):
    for j, t in zip(case["sums"]["jax"], case["sums"]["port"]):
        for k in ("avg_ce", "server_ce"):
            np.testing.assert_allclose(t[k], j[k], rtol=1e-4, err_msg=k)
        for k in ("avg_acc", "best_acc", "worst_acc", "server_acc"):
            assert t[k] == pytest.approx(j[k], abs=1e-6), k


def check_leaves(case):
    """Every client's and the server's LoRA leaves at 2e-5; over the int8
    wire one quantization step more (the largest uplink value of the leaf,
    or of any leaf for the server, over 127: a code at a half-way tie may
    move one step)."""
    jr, tr = case["jr"], case["tr"]
    pairs = [(f"client{j}", jp, tp) for j, (jp, tp) in
             enumerate(zip(jr.device_params, tr.device_params))]
    pairs += [("server_slm", jr.server_slm, tr.server_slm),
              ("server_llm", jr.server_llm, tr.server_llm)]
    up = case["uplink"]
    for name, jtree, ttree in pairs:
        jflat = flat_numpy(jlora.partition(jtree, jlora.is_lora_leaf))
        tflat = lora.partition(ttree, lora.is_lora_leaf)
        assert sorted(jflat) == sorted(tflat), name
        for k, want in jflat.items():
            step = 0.0
            if up:
                top = max(up.values()) if name.startswith("server") \
                    else up.get(k, 0.0)
                step = max(top, float(np.abs(want).max())) / 127.0
            np.testing.assert_allclose(_np(tflat[k]), want, rtol=0,
                                       atol=2e-5 + step,
                                       err_msg=f"{name}:{k}")


def check_comm_and_draws(case):
    jr, tr = case["jr"], case["tr"]
    assert tr.comm_stats == jr.comm_stats
    assert tr.comm_log == jr.comm_log
    for (jp, jc, jw), (tp, tc, tw) in case["masks"]:
        for a, b in ((tp, jp), (tc, jc), (tw, jw)):
            if b is None:
                assert a is None
            else:
                np.testing.assert_array_equal(a, np.asarray(b))
    np.testing.assert_array_equal(tr.masks, jr.masks)
    assert [rt.shared for rt in tr.cohorts] == \
        [rt.shared for rt in jr.cohorts]
    assert [rt.own for rt in tr.cohorts] == [rt.own for rt in jr.cohorts]
    assert tr._homogeneous == jr._homogeneous


def check_het_structure(tr):
    """Two cohorts on disjoint modality subsets, cohort B (d 32) holding
    own keys beside the server SLM's (d 24), every member on its cohort's
    shared frozen backbone."""
    a, b = tr.cohorts
    assert not tr.masks[a.slice][:, 2].any()
    assert not tr.masks[b.slice][:, :2].any()
    assert b.own and b.shared and not a.own
    for rt, base in zip(tr.cohorts, tr.cohort_bases):
        bflat = lora.flatten(base)
        for p in rt.device_params:
            flat = lora.flatten(p)
            for k, v in bflat.items():
                if not lora.default_trainable(k):
                    assert flat[k] is v, k
