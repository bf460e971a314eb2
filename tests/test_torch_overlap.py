"""The overlap engine of the port (``engine="overlap"``, ``staleness``)
and the sketch codec in a round, on the CPU at toy size.

* ``RoundPrefetcher``: the reference's contract (stream order, a worker
  error re-raised at ``next()``, ``None`` ends the stream), the ``alive``
  probe, and ``close()`` leaving no thread.
* ``staleness=0`` equals the port's vectorized engine bit for bit over
  two evaluated rounds: summaries, every leaf of every client and of the
  server models, ``comm_stats``; on the legacy single cohort and on two
  cohorts under faults over the int8 wire.
* ``staleness=1``: round 0 delivers nothing, round 1 delivers round 0's
  server output to every client, one output always in flight, a
  checkpoint refused while it is; ``staleness=2``: two warm-up rounds,
  then deliveries two rounds late, and the run still learns.  Both as the
  reference's tests (tests/test_federated_engines.py).
* ``staleness=1`` against the JAX overlap runner over two evaluated
  rounds of two cohorts (tests/_torch_cohort_cases.py: summaries rtol
  1e-4, leaves 2e-5, ``comm_stats``, masks and weights equal).
* A sketch round on the loop and the vectorized engines against the JAX
  loop runner (one round of tests/test_torch_federated.py's ``ROUND``
  over the sketch uplink and downlink, rank 8; summaries rtol 1e-4,
  leaves 2e-5, ``comm_stats`` equal).
* A sampled population with its store on disk at ``staleness=0``: the
  staged gathers, four rounds bit-equal to the vectorized engine's, and
  a checkpoint at the round boundary resumed bit for bit.

Two JAX runners in all (their compile is most of the file's time).
Every runner is closed in the test's teardown.
"""
import dataclasses
import gc
import itertools
import threading

import numpy as np
import pytest
import torch

from _torch_cohort_cases import (FAULTS, HET, SLM as COH_SLM, SLM_B,
                                 carried_state, check_comm_and_draws,
                                 check_leaves, check_summaries, flat_numpy,
                                 make_specs)
from _torch_cohort_cases import corpus as make_corpus
from repro.configs.base import ModelConfig as JConfig
from repro.core import lora as jlora
from repro.core.channel import ChannelSpec as JChannelSpec
from repro.core.federated import FederatedConfig as JFedConfig
from repro.core.federated import FederatedRunner as JRunner
from repro.data.synthetic import synthetic_multimodal_corpus
from repro.models.model import build_model as jbuild
from repro_torch.checkpointing import checkpoint as ckpt
from repro_torch.configs.base import ModelConfig
from repro_torch.core import lora, spec
from repro_torch.core.channel import ChannelSpec
from repro_torch.core.federated import FederatedConfig, FederatedRunner
from repro_torch.data.pipeline import RoundPrefetcher
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
# the engine cases: 2 CCL + 2 AMT steps (the second round starts from
# per-client LoRA B), 2 evaluated rounds
ENGINE_ROUND = dict(ROUND, rounds=2, local_steps_ccl=2, local_steps_amt=2)
POP = ((COH_SLM, dict(n_clients=4, name="A", modalities=(0, 1))),
       (SLM_B, dict(n_clients=5, name="B", modalities=(2,), rho=0.9,
                    batch_size=4)))
SAMPLED = dict(channel="int8", robust="trimmed_mean", trim_frac=0.4,
               faults=dict(FAULTS, attack="scaled_update"))


def port_bundles():
    return tuple(build_model(ModelConfig(**dataclasses.asdict(c)))
                 for c in (SLM, LLM))


@pytest.fixture(scope="module")
def corpus():
    return synthetic_multimodal_corpus(0, 384, 24, 128, n_classes=4,
                                       n_modalities=3, modality_dim=32,
                                       template_len=4)


@pytest.fixture
def closing():
    """Runners opened by a test, closed at its teardown; afterwards no
    prefetch or gather thread is left."""
    runners = []
    yield runners.append
    for r in runners:
        r.close()
    left = [t.name for t in threading.enumerate()
            if t.name in ("round-prefetch", "store-gather")]
    assert not left, left


def legacy(corpus, engine, **over):
    cfg = FederatedConfig(engine=engine, **{**ENGINE_ROUND, **over})
    return FederatedRunner(cfg, *port_bundles(), corpus, device="cpu")


def all_leaves(r):
    """Every client's and both server models' leaves, by name."""
    trees = {f"client{j}": p for j, p in enumerate(r.device_params)}
    trees.update(server_slm=r.server_slm, server_llm=r.server_llm)
    return {f"{n}:{k}": v for n, t in trees.items()
            for k, v in lora.flatten(t).items()}


def assert_bit_equal(a, b, sums_a, sums_b):
    assert sums_a == sums_b
    la, lb = all_leaves(a), all_leaves(b)
    assert sorted(la) == sorted(lb)
    for k in la:
        assert torch.equal(la[k], lb[k]), k
    assert a.comm_stats == b.comm_stats and a.comm_log == b.comm_log


def lora_rows_equal(r, c=0):
    tr = lora.partition(r.cohorts[c].stacked_params, lora.is_lora_leaf)
    return all(torch.equal(v[0], v[i]) for v in tr.values()
               for i in range(1, v.shape[0]))


# ---------------------------------------------------------------------------
# the prefetcher

def test_round_prefetcher_replays_order_and_surfaces_errors():
    counter = itertools.count()
    pf = RoundPrefetcher(lambda: next(counter), depth=2)
    assert [next(pf) for _ in range(10)] == list(range(10))
    pf.close()
    assert not pf._thread.is_alive()

    def boom():
        raise ValueError("worker exploded")
    pf2 = RoundPrefetcher(boom)
    for _ in range(2):
        with pytest.raises(RuntimeError, match="prefetch worker died") as e:
            next(pf2)
        assert isinstance(e.value.__cause__, ValueError)
    pf2.close()

    # end of source: make_round returning None -> StopIteration, again
    items = iter([7, 8])
    pf3 = RoundPrefetcher(lambda: next(items, None))
    assert list(pf3) == [7, 8]
    with pytest.raises(StopIteration):
        next(pf3)
    pf3.close()
    assert not pf3._thread.is_alive()


def test_round_prefetcher_alive_probe_and_close_stop_the_worker():
    """A full queue holds the worker; ``close`` stops it and drops the
    buffered rounds; a probe that turns False stops it on its own."""
    made = itertools.count()
    pf = RoundPrefetcher(lambda: next(made), depth=1)
    assert next(pf) == 0
    pf.close()
    assert not pf._thread.is_alive() and next(made) <= 4

    alive = threading.Event()
    alive.set()
    pf2 = RoundPrefetcher(lambda: 1, alive=alive.is_set)
    assert next(pf2) == 1
    alive.clear()
    pf2._thread.join(timeout=10)
    assert not pf2._thread.is_alive()
    pf2.close()


# ---------------------------------------------------------------------------
# staleness 0: the vectorized engine's schedule, bit for bit

def test_overlap0_equals_vectorized_bitwise(corpus, closing):
    vec = legacy(corpus, "vectorized")
    ov = legacy(corpus, "overlap")
    closing(ov)
    sums = {id(r): [r.run_round()["summary"] for _ in range(2)]
            for r in (vec, ov)}
    assert_bit_equal(vec, ov, sums[id(vec)], sums[id(ov)])
    assert not ov._srv_q
    # the anchor model: the server LLM's own frozen tensors, the last
    # delivery's trainables
    rt = ov.cohorts[0]
    base, srv = lora.flatten(rt.anchor_base), lora.flatten(ov.server_llm)
    for k, v in base.items():
        if not lora.default_trainable(k):
            assert v is srv[k], k
    want = lora.partition(ov.server_llm)
    assert all(rt.anchor_tr[k] is want[k] for k in want)
    assert ov.sync() is ov and ov.drain() is ov
    assert ov.evaluate()["summary"] == vec.evaluate()["summary"]


def test_overlap0_equals_vectorized_on_faulty_int8_cohorts(closing):
    """Two cohorts (two architectures, own keys) under dropouts,
    stragglers and a scaled-update attacker over the int8 wire."""
    corpus = make_corpus()
    _, tspec = make_specs(HET, None, 2, dict(
        channel="int8", faults=dict(FAULTS, attack="scaled_update")))
    vec = FederatedRunner(tspec, corpus, engine="vectorized", device="cpu")
    ov = FederatedRunner(tspec, corpus, engine="overlap", device="cpu")
    closing(ov)
    sums = {id(r): [r.run_round()["summary"] for _ in range(2)]
            for r in (vec, ov)}
    assert_bit_equal(vec, ov, sums[id(vec)], sums[id(ov)])
    assert not ov._rnd_present.all()
    for a, b in zip(vec.cohorts, ov.cohorts):
        for k in a.chan_state:
            assert torch.equal(a.chan_state[k], b.chan_state[k]), k


# ---------------------------------------------------------------------------
# staleness 1 and 2

def test_staleness1_lags_redistribution(corpus, closing):
    """Round 0 ends with no delivery (the clients' LoRA still differ),
    round 1 applies round 0's server output to every client; one output
    is always in flight, and a checkpoint is refused while it is."""
    ov = legacy(corpus, "overlap", staleness=1, rounds=3)
    closing(ov)
    s0 = ov.run_round()["summary"]
    assert not lora_rows_equal(ov)
    assert len(ov._srv_q) == 1
    down0 = ov._srv_q[0][0]
    s1 = ov.run_round()["summary"]
    assert lora_rows_equal(ov) and len(ov._srv_q) == 1
    tr = lora.partition(ov.stacked_params, lora.is_lora_leaf)
    for k, v in down0.items():
        assert torch.equal(tr[k][0], v), k
    for s in (s0, s1):
        assert all(np.isfinite(list(s.values())))
    with pytest.raises(RuntimeError, match="staleness queue"):
        ov.checkpoint_state()


def test_staleness2_warmup_and_convergence(closing):
    """Two cohorts at staleness 2: two warm-up rounds with nothing
    delivered (the queue fills to 2, the clients of a cohort stay
    distinct), then deliveries two rounds late; the final CE improves on
    the initial model and stays within 0.25 of the staleness-1 run."""
    corpus = make_corpus()
    _, tspec = make_specs(HET, None, 4, {})
    r2 = FederatedRunner(dataclasses.replace(tspec, engine="overlap",
                                             staleness=2), corpus,
                         device="cpu")
    r1 = FederatedRunner(dataclasses.replace(tspec, engine="overlap",
                                             staleness=1), corpus,
                         device="cpu")
    closing(r2), closing(r1)
    pre = r2.evaluate()["summary"]["avg_ce"]
    hist2 = []
    for rnd in range(4):
        hist2.append(r2.run_round()["summary"])
        if rnd < 2:
            assert len(r2._srv_q) == rnd + 1
            assert not lora_rows_equal(r2)
        else:
            assert len(r2._srv_q) == 2
            assert lora_rows_equal(r2)
    hist1 = [r1.run_round()["summary"] for _ in range(4)]
    ce1, ce2 = hist1[-1]["avg_ce"], hist2[-1]["avg_ce"]
    assert np.isfinite(ce1) and np.isfinite(ce2)
    assert ce2 < pre
    assert abs(ce2 - ce1) <= 0.25, (ce1, ce2)


# ---------------------------------------------------------------------------
# against the JAX overlap runner

def test_staleness1_matches_jax_overlap(closing):
    """Two cohorts (mlecs, the cross-cohort combine and own keys) at
    staleness 1 from the JAX runner's states, two evaluated rounds."""
    corpus = make_corpus()
    jsp, tsp = (dataclasses.replace(s, engine="overlap", staleness=1)
                for s in make_specs(HET, None, 2, {}))
    jr = JRunner(jsp, corpus)
    tr = FederatedRunner(tsp, corpus, device="cpu",
                         init_state=carried_state(jr))
    closing(tr)
    case = {"jr": jr, "tr": tr, "uplink": {}, "masks": [],
            "sums": {"jax": [], "port": []}}
    for _ in range(2):
        for who, r in (("jax", jr), ("port", tr)):
            case["sums"][who].append(r.run_round()["summary"])
        case["masks"].append([(r._rnd_present, r._rnd_contrib,
                               r._rnd_weights) for r in (jr, tr)])
    jr.drain()
    assert len(jr._srv_q) == len(tr._srv_q) == 1
    check_summaries(case)
    check_leaves(case)
    check_comm_and_draws(case)
    jr.close()


# ---------------------------------------------------------------------------
# the sketch codec in a round

def test_sketch_round_matches_jax_on_loop_and_vectorized(corpus):
    """One round over the sketch uplink and downlink (rank 8: the LoRA A
    leaves project on the left, the B leaves on the right) on the port's
    loop and vectorized engines from the JAX loop runner's states."""
    kw = dict(codec="sketch", sketch_rank=8, seed=3)
    jr = JRunner(JFedConfig(engine="loop", channel=JChannelSpec(**kw),
                            **ROUND), jbuild(SLM), jbuild(LLM), corpus)
    init = {"cohort_base": flat_numpy(jr._cohort_bases[0]),
            "personal": [flat_numpy(jlora.partition(p))
                         for p in jr.device_params],
            "server_slm": flat_numpy(jr.server_slm),
            "server_llm": flat_numpy(jr.server_llm)}
    jsum = jr.run_round()["summary"]
    for engine in ("loop", "vectorized"):
        tr = FederatedRunner(FederatedConfig(
            engine=engine, channel=ChannelSpec(**kw), **ROUND),
            *port_bundles(), corpus, device="cpu", init_state=init)
        case = {"jr": jr, "tr": tr, "uplink": {}, "masks": [],
                "sums": {"jax": [jsum], "port": [tr.run_round()["summary"]]}}
        check_summaries(case)
        check_leaves(case)
        assert tr.comm_stats == jr.comm_stats
        assert tr.comm_stats["uplink_ratio"] > 1.0
        assert {k[2] for k in tr.channel._bases} == {0}


# ---------------------------------------------------------------------------
# a sampled population with its store on disk: staged gathers, resume

def test_sampled_overlap_resumes_bit_identically(tmp_path, closing):
    """4 + 5 registered clients, 2 + 3 sampled a round, faults, the
    trimmed mean and the int8 wire, the store spilled to disk, at
    staleness 0: every round's gather is staged on a thread, four rounds
    equal the vectorized engine's bit for bit, and a runner restored from
    the checkpoint after round 2 replays rounds 3 and 4 bit for bit."""
    corpus = synthetic_multimodal_corpus(0, 256, 16, 64, n_classes=4,
                                         n_modalities=3, modality_dim=16,
                                         template_len=4)
    _, tsp = make_specs(POP, None, 4, SAMPLED)
    tsp = dataclasses.replace(tsp, sampler=spec.ParticipantSampler(
        per_cohort=(2, 3), seed=1))
    ov = FederatedRunner(dataclasses.replace(tsp, engine="overlap"), corpus,
                         device="cpu", store_dir=str(tmp_path / "pop"))
    vec = FederatedRunner(dataclasses.replace(tsp, engine="vectorized"),
                          corpus, device="cpu")
    closing(ov)
    outs = {id(r): [] for r in (ov, vec)}
    mgr = ckpt.CheckpointManager(str(tmp_path / "ck"))
    for rnd in range(4):
        for r in (ov, vec):
            outs[id(r)].append(r.run_round())
        assert ov._staged_gather["rnd"] == rnd + 1
        if rnd == 1:
            assert ov.save_checkpoint(mgr) == 2
    for a, b in zip(outs[id(ov)], outs[id(vec)]):
        assert a["participants"] == b["participants"]
    assert_bit_equal(ov, vec, [o["summary"] for o in outs[id(ov)]],
                     [o["summary"] for o in outs[id(vec)]])

    back = FederatedRunner(dataclasses.replace(tsp, engine="overlap"),
                           corpus, device="cpu")
    closing(back)
    back.load_checkpoint(mgr)
    again = [back.run_round() for _ in range(2)]
    for a, b in zip(outs[id(ov)][2:], again):
        assert a["participants"] == b["participants"]
        assert a["summary"] == b["summary"]
    la, lb = all_leaves(ov), all_leaves(back)
    assert all(torch.equal(la[k], lb[k]) for k in la)


def test_dropped_runner_stops_its_worker(corpus):
    """Without ``close()`` the prefetch worker holds the runner weakly:
    once the runner is collected the worker ends.  (The worker holds it
    while it assembles a round, so collect until it is idle.)"""
    ov = legacy(corpus, "overlap", rounds=1)
    thread = ov._prefetch._thread
    assert thread.is_alive()
    del ov
    for _ in range(40):
        gc.collect()
        thread.join(timeout=0.25)
        if not thread.is_alive():
            break
    assert not thread.is_alive()
