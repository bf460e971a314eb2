"""Port parity for federated rounds of Algorithm 1 on the loop engine,
and the round's gates and refusals.

The JAX loop runner and the port's runner start from the same states (the
JAX runner's, carried across with ``repro_torch.interop``) on the same
corpus, at float32 on toy configs shaped like tests/test_system.py's; one
round of one CCL, one AMT and one SE-CCL step each, then the summaries and
every device's and the server's LoRA leaves are compared.  The same holds
for two rounds over the int8 / int4 wire (uploads and redistribution
through the channel, with and without error feedback, mlecs and fedavg).
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.configs.base import ModelConfig as JConfig
from repro.core import lora as jlora
from repro.core.channel import ChannelSpec as JChannelSpec
from repro.core.federated import FederatedConfig as JFedConfig
from repro.core.federated import FederatedRunner as JRunner
from repro.core.spec import FaultSpec, FederationSpec, ParticipantSampler
from repro.data.synthetic import synthetic_multimodal_corpus
from repro.models.model import build_model as jbuild
from repro_torch.configs.base import ModelConfig
from repro_torch.core import lora
from repro_torch.core.channel import ChannelSpec
from repro_torch.core.federated import FederatedConfig, FederatedRunner
from repro_torch.kernels.quantize import quantize_rows_plain
from repro_torch.models.model import build_model

torch.set_num_threads(1)

_KW = dict(n_modalities=3, modality_dim=32, n_soft_tokens=4,
           connector_dim=48, lora_rank=4, remat=False, activation="gelu",
           vocab_size=128, dtype="float32")
SLM = JConfig(name="sys-slm", family="dense", n_layers=2, d_model=48,
              n_heads=4, n_kv_heads=2, head_dim=12, d_ff=96, **_KW)
LLM = JConfig(name="sys-llm", family="dense", n_layers=2, d_model=64,
              n_heads=4, n_kv_heads=2, head_dim=16, d_ff=128, **_KW)
ROUND = dict(n_devices=3, rounds=1, local_steps_ccl=1, local_steps_amt=1,
             server_steps=1, batch_size=8, lr=1e-2, rho=0.7)


def port_bundles():
    return tuple(build_model(ModelConfig(**dataclasses.asdict(c)))
                 for c in (SLM, LLM))


def flat_numpy(tree) -> dict:
    """JAX pytree -> {path_str: ndarray} (float32 trees here)."""
    return {jlora.path_str(p): np.array(leaf) for p, leaf in
            jax.tree_util.tree_flatten_with_path(tree)[0]}


def _np(t):
    return t.detach().float().numpy()


@pytest.fixture(scope="module")
def corpus():
    return synthetic_multimodal_corpus(0, 384, 24, 128, n_classes=4,
                                       n_modalities=3, modality_dim=32,
                                       template_len=4)


def runner_pair(corpus, jcfg, tcfg):
    """A JAX loop runner and a port runner from the JAX runner's states."""
    jr = JRunner(jcfg, jbuild(SLM), jbuild(LLM), corpus)
    init = {"cohort_base": flat_numpy(jr._cohort_bases[0]),
            "personal": [flat_numpy(jlora.partition(p))
                         for p in jr.device_params],
            "server_slm": flat_numpy(jr.server_slm),
            "server_llm": flat_numpy(jr.server_llm)}
    tr = FederatedRunner(tcfg, *port_bundles(), corpus, device="cpu",
                         init_state=init)
    return jr, tr


@pytest.fixture(scope="module")
def rounds(corpus):
    """One JAX loop round and one port round from the same states."""
    jr, tr = runner_pair(corpus, JFedConfig(engine="loop", **ROUND),
                         FederatedConfig(engine="loop", **ROUND))
    out = {}
    for name, r in (("jax", jr), ("port", tr)):
        pre = r.evaluate()["summary"]
        post = r.run_round()["summary"]
        out[name] = (pre, post, r)
    return out


def test_round_summaries_match_jax(rounds):
    """Pre- and post-round avg_ce / server_ce / avg_acc at float32: CE to
    1e-4 relative (one step of each kind moves a leaf by about lr * sign(g),
    so float rounding stays small), accuracy equal."""
    (jpre, jpost, _), (tpre, tpost, _) = rounds["jax"], rounds["port"]
    for j, t in ((jpre, tpre), (jpost, tpost)):
        for k in ("avg_ce", "server_ce"):
            np.testing.assert_allclose(t[k], j[k], rtol=1e-4, err_msg=k)
        assert t["avg_acc"] == pytest.approx(j["avg_acc"], abs=1e-6)
    assert tpost["avg_ce"] < tpre["avg_ce"]


def test_final_lora_leaves_match_jax(rounds):
    """Every device's and the server SLM's and LLM's LoRA leaves after
    the round, at float32: 2e-5 absolute (leaves are O(0.1))."""
    jr, tr = rounds["jax"][2], rounds["port"][2]
    pairs = [(jp, tp) for jp, tp in zip(jr.device_params, tr.device_params)]
    pairs += [(jr.server_slm, tr.server_slm), (jr.server_llm, tr.server_llm)]
    for jtree, ttree in pairs:
        jflat = flat_numpy(jlora.partition(jtree, jlora.is_lora_leaf))
        tflat = lora.partition(ttree, lora.is_lora_leaf)
        assert sorted(jflat) == sorted(tflat)
        for k in jflat:
            np.testing.assert_allclose(_np(tflat[k]), jflat[k], atol=2e-5,
                                       err_msg=k)
    assert tr.comm_stats == {**jr.comm_stats, "uplink_client_bytes":
                             {0: jr.comm_stats["uplink_client_bytes"][0]}}


# ---------------------------------------------------------------------------
# two rounds over the int8 / int4 wire

CHANNEL_CASES = {
    "int8-ef": (dict(codec="int8"), "mlecs"),
    "int4-ef": (dict(codec="int4"), "mlecs"),
    "int8-no-ef": (dict(codec="int8", error_feedback=False), "mlecs"),
    "fedavg-int8": (dict(codec="int8"), "fedavg"),
}


def tile_steps(x, ch, qmax):
    """Each element's quantization step: the scale of its wire tile when
    the stacked (N, ...) f32 tensor ``x`` is encoded by channel ``ch``."""
    x = torch.as_tensor(np.asarray(x, np.float32))
    rows = ch._to_rows(x)
    _, s = quantize_rows_plain(rows, qmax)
    return ch._from_rows(s[:, None].expand(rows.shape), x.shape)


@pytest.fixture(scope="module", params=sorted(CHANNEL_CASES))
def channel_rounds(request, corpus):
    """Two rounds of the JAX loop runner and of the port's from the same
    states over one channel; the JAX side records its last uplink input
    (the uploads plus the carried residuals) to size the checks."""
    kw, mode = CHANNEL_CASES[request.param]
    cfg = dict(ROUND, rounds=2, mode=mode)
    jr, tr = runner_pair(
        corpus, JFedConfig(engine="loop", channel=JChannelSpec(**kw), **cfg),
        FederatedConfig(engine="loop", channel=ChannelSpec(**kw), **cfg))
    uplink = {}
    roundtrip = jr.channel.roundtrip

    def recording(flat, state=None, rnd=0):
        if next(iter(flat.values())).shape[0] == ROUND["n_devices"]:
            uplink.clear()
            uplink.update({k: np.asarray(v, np.float32)
                           + (np.asarray(state[k]) if state else 0.0)
                           for k, v in flat.items()})
        return roundtrip(flat, state, rnd)
    jr.channel.roundtrip = recording
    sums = {name: [r.run_round()["summary"] for _ in range(2)]
            for name, r in (("jax", jr), ("port", tr))}
    return dict(jr=jr, tr=tr, sums=sums, uplink=uplink,
                qmax={"int8": 127, "int4": 7}[kw["codec"]])


def test_channel_round_comm_stats_equal_jax(channel_rounds):
    jr, tr = channel_rounds["jr"], channel_rounds["tr"]
    assert tr.comm_stats == {**jr.comm_stats, "uplink_client_bytes":
                             {0: jr.comm_stats["uplink_client_bytes"][0]}}
    assert tr.comm_stats["rounds"] == 2
    assert tr.comm_stats["uplink_bytes"] < tr.comm_stats["uplink_f32_bytes"]


def test_channel_round_summaries_match_jax(channel_rounds):
    """avg_ce / server_ce of both rounds to 1e-4 relative, as without the
    channel: a code that moves across a tie shifts one element by one
    step, which the metrics barely feel."""
    for j, t in zip(channel_rounds["sums"]["jax"],
                    channel_rounds["sums"]["port"]):
        for k in ("avg_ce", "server_ce"):
            np.testing.assert_allclose(t[k], j[k], rtol=1e-4, err_msg=k)


def test_channel_round_leaves_and_residuals_match_jax(channel_rounds):
    """LoRA leaves and EF residuals after two rounds, each element within
    one quantization step (its wire tile's scale) plus 2e-5.  The codec
    is bit-equal to the reference on equal inputs
    (tests/test_torch_channel.py), but the trained values reach it with
    ~1e-7 float differences, and such a difference can move one code
    across a half-way tie: that element then decodes one step apart, and
    its residual differs by the same step.  Devices hold the decoded
    downlink (steps from its tiles); the server SLM aggregated the
    decoded uploads and the LLM learnt from that SLM, so both are held to
    the largest uplink step of the leaf."""
    jr, tr, qmax = (channel_rounds[k] for k in ("jr", "tr", "qmax"))
    ch, up = tr.channel, channel_rounds["uplink"]
    up_step = {k: float(tile_steps(v, ch, qmax).max()) for k, v in up.items()}
    worst = max(up_step.values())
    for jp, tp in zip(jr.device_params, tr.device_params):
        jflat = flat_numpy(jlora.partition(jp, jlora.is_lora_leaf))
        tflat = lora.partition(tp, lora.is_lora_leaf)
        assert sorted(jflat) == sorted(tflat)
        for k, want in jflat.items():
            step = tile_steps(want[None], ch, qmax)[0].numpy()
            err = np.abs(_np(tflat[k]) - want)
            assert (err <= step + 2e-5).all(), (k, float(err.max()))
    for jtree, ttree in ((jr.server_slm, tr.server_slm),
                         (jr.server_llm, tr.server_llm)):
        jflat = flat_numpy(jlora.partition(jtree, jlora.is_lora_leaf))
        tflat = lora.partition(ttree, lora.is_lora_leaf)
        for k, want in jflat.items():
            np.testing.assert_allclose(_np(tflat[k]), want, rtol=0,
                                       atol=up_step.get(k, worst) + 2e-5,
                                       err_msg=k)
    if not tr.channel.stateful:
        assert tr.chan_state == {}
        return
    jstate = jr.cohorts[0].chan_state
    assert sorted(jstate) == sorted(tr.chan_state)
    for k, want in jstate.items():
        step = tile_steps(up[k], ch, qmax).numpy()
        err = np.abs(_np(tr.chan_state[k]) - np.asarray(want))
        assert (err <= step + 2e-5).all(), (k, float(err.max()))
        assert (np.abs(_np(tr.chan_state[k])) <= 0.5 * step * (1 + 1e-6)
                + 1e-12).all(), k


def test_round_keeps_the_backbone_frozen_and_shared(rounds):
    tr = rounds["port"][2]
    base = lora.flatten(tr.cohort_base)
    for p in tr.device_params:
        flat = lora.flatten(p)
        for k, v in base.items():
            if not lora.default_trainable(k):
                assert flat[k] is v, k


# ---------------------------------------------------------------------------
# gates (port only)

def _port_run(corpus, **over):
    cfg = FederatedConfig(engine="loop", **{**ROUND, **over})
    r = FederatedRunner(cfg, *port_bundles(), corpus, device="cpu")
    before = {"llm": lora.flatten(r.server_llm),
              "slm": lora.flatten(r.server_slm),
              "dev": [lora.partition(p, lora.is_lora_leaf)
                      for p in r.device_params]}
    r.run_round()
    return r, before


def _same(a, b):
    return all(torch.equal(a[k], b[k]) for k in a)


@pytest.mark.parametrize("mode,use_ccl,use_seccl,use_mma", [
    ("standalone", True, True, True),
    ("fedavg", True, True, True),
    ("mlecs", False, True, True),
    ("mlecs", True, False, False),
])
def test_mode_and_ablation_gates(corpus, mode, use_ccl, use_seccl, use_mma):
    r, before = _port_run(corpus, mode=mode, use_ccl=use_ccl,
                          use_seccl=use_seccl, use_mma=use_mma)
    llm_same = _same(before["llm"], lora.flatten(r.server_llm))
    slm_same = _same(before["slm"], lora.flatten(r.server_slm))
    pub_pulled = r._streams.pulled("pub/0")
    if mode == "standalone":      # nothing crosses the wire
        assert r.comm_stats["uplink_bytes"] == 0
        assert r.comm_stats["downlink_bytes"] == 0
        assert llm_same and slm_same and pub_pulled == 0
        ups = [lora.partition(p, lora.is_lora_leaf) for p in r.device_params]
        assert not _same(ups[0], ups[1])      # no redistribution
        return
    assert r.comm_stats["uplink_bytes"] > 0
    ups = [lora.partition(p, lora.is_lora_leaf) for p in r.device_params]
    assert _same(ups[0], ups[1]) and _same(ups[1], ups[2])
    if mode == "fedavg":          # no SE-CCL, the server keeps its models
        assert llm_same and slm_same
        assert r._streams.pulled("server") == 0
        assert torch.allclose(r.agg_weights, torch.full((3,), 1 / 3))
        return
    assert pub_pulled == (1 if use_ccl else 0)
    assert llm_same == (not use_seccl)
    assert r._streams.pulled("server") == (1 if use_seccl else 0)
    if not use_mma:
        assert torch.allclose(r.agg_weights, torch.full((3,), 1 / 3))
    else:
        assert not torch.allclose(r.agg_weights, torch.full((3,), 1 / 3))
    assert abs(float(r.agg_weights.sum()) - 1.0) < 1e-6


def test_cosine_score_and_prox_run(corpus):
    r, before = _port_run(corpus, ccl_score="cosine", prox_weight=0.1)
    assert np.isfinite(r.evaluate()["summary"]["avg_ce"])


# ---------------------------------------------------------------------------
# what the port refuses

@pytest.mark.parametrize("over,engine", [
    ({}, "vectorized"),
    ({}, "overlap"),
    ({"robust": "trimmed_mean"}, "loop"),
    ({"channel": ChannelSpec(codec="sketch")}, "loop"),
    ({"faults": FaultSpec(dropout=0.2)}, "loop"),
    ({"sampler": ParticipantSampler(per_cohort=2)}, "loop"),
])
def test_unported_options_raise(corpus, over, engine):
    cfg = FederatedConfig(**{**ROUND, **over})
    with pytest.raises(NotImplementedError):
        FederatedRunner(cfg, *port_bundles(), corpus, engine=engine,
                        device="cpu")


def test_spec_input_checkpoints_and_missing_cuda_raise(corpus):
    spec = FederationSpec.from_legacy(JFedConfig(**ROUND), SLM, LLM)
    with pytest.raises(NotImplementedError, match="FederationSpec"):
        FederatedRunner(spec, *port_bundles(), corpus)
    ok = FederatedConfig(engine="loop", **ROUND)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            FederatedRunner(ok, *port_bundles(), corpus)
    r = FederatedRunner(ok, *port_bundles(), corpus, device="cpu")
    with pytest.raises(NotImplementedError, match="checkpoint"):
        r.checkpoint_state()
    with pytest.raises(ValueError, match="connector interface"):
        big = dataclasses.replace(LLM, connector_dim=64)
        FederatedRunner(ok, port_bundles()[0],
                        build_model(ModelConfig(**dataclasses.asdict(big))),
                        corpus, device="cpu")
