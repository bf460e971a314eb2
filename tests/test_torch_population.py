"""The registered population and checkpoints of the port against the
reference: ``ParticipantSchedule`` draws, ``ClientStore``, the npz pytree
format in both directions, ``sampled_weights``, the sampler's validation,
an identity sampler against the unsampled runner (bit for bit, both
engines), sampled rounds against the JAX vectorized runner, checkpoints
exchanged between the packages, and port-to-port resume.

The round cases run the shared cohort configurations of
tests/_torch_cohort_cases.py at float32 on the CPU: two cohorts of 4 and
5 registered clients (two architectures, disjoint modality subsets) of
which each round samples 2 and 3, under dropout, stragglers and a
scaled-update attacker, the trimmed mean (0.4 from each end) and the int8
wire with error feedback; one CCL, one AMT and one SE-CCL step a round.
Against JAX: summaries rtol 1e-4, leaves atol 2e-5 plus one quantization
step (the file's tolerances), masks, weights, participants and
``comm_stats`` equal.  The port's two engines agree to 1e-5 (the
reference's engine tolerance); an identity sampler and a resumed run are
bit-identical to their references.  One JAX runner in all (its compile
costs most of the file's time): the sampled rounds, both checkpoints and
the exchanged third round share it.
"""
import dataclasses
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_cohort_cases import (FAULTS, SLM, SLM_B, _np, carried_state,
                                 check_comm_and_draws, check_leaves,
                                 check_summaries, flat_numpy, make_specs)
from repro.checkpointing import checkpoint as jckpt
from repro.core import lora as jlora
from repro.core import mma as jmma
from repro.core import spec as jspec
from repro.core import store as jstore
from repro.core.federated import FederatedRunner as JRunner
from repro.data.synthetic import synthetic_multimodal_corpus
from repro_torch.checkpointing import checkpoint as ckpt
from repro_torch.core import lora, mma, spec
from repro_torch.core.federated import FederatedRunner
from repro_torch.core.store import ClientStore, ParticipantSchedule

torch.set_num_threads(1)

ENGINE_TOL = 1e-5          # the reference's loop vs vectorized tolerance
# 4 + 5 registered clients, 2 + 3 sampled a round
POP = ((SLM, dict(n_clients=4, name="A", modalities=(0, 1))),
       (SLM_B, dict(n_clients=5, name="B", modalities=(2,), rho=0.9,
                    batch_size=4)))
PER_COHORT = (2, 3)
SAMPLED = dict(channel="int8", robust="trimmed_mean", trim_frac=0.4,
               faults=dict(FAULTS, attack="scaled_update"))


@pytest.fixture(scope="module")
def corpus():
    return synthetic_multimodal_corpus(0, 256, 16, 64, n_classes=4,
                                       n_modalities=3, modality_dim=16,
                                       template_len=4)


def pop_specs(engine, rounds=2, per_cohort=PER_COHORT, kw=SAMPLED, seed=1):
    """The reference's and the port's spec of the sampled population."""
    js, ts = make_specs(POP, None, rounds, kw)
    return (dataclasses.replace(
        s, engine=engine, sampler=None if per_cohort is None else
        mod.ParticipantSampler(per_cohort=per_cohort, seed=seed))
        for s, mod in ((js, jspec), (ts, spec)))


def leaves_of(r):
    """Every registered client's and the servers' LoRA leaves (clones)."""
    out = {}
    for j, p in enumerate(r.device_params):
        out.update({f"client{j}:{k}": v.clone() for k, v in
                    lora.partition(p, lora.is_lora_leaf).items()})
    for n in ("server_slm", "server_llm"):
        out.update({f"{n}:{k}": v.clone() for k, v in
                    lora.partition(getattr(r, n), lora.is_lora_leaf).items()})
    return out


def jax_leaves(jr):
    """:func:`leaves_of` of a JAX runner, as numpy."""
    out = {}
    trees = [(f"client{j}", p) for j, p in enumerate(jr.device_params)]
    trees += [(n, getattr(jr, n)) for n in ("server_slm", "server_llm")]
    for n, p in trees:
        out.update({f"{n}:{k}": v for k, v in flat_numpy(
            jlora.partition(p, jlora.is_lora_leaf)).items()})
    return out


def recording_uplink(tr):
    """Record, per LoRA key, the largest |upload + residual| the port's
    channel quantizes (the int8 step of the tolerance)."""
    seen, roundtrip = {}, tr.channel.roundtrip

    def rec(flat, state=None, rnd=0):
        for k, v in flat.items():
            x = v.float() + (state[k] if state else 0.0)
            seen[k] = max(seen.get(k, 0.0), float(x.abs().max()))
        return roundtrip(flat, state, rnd)
    tr.channel.roundtrip = rec
    return seen


def read_flat(path):
    """A checkpoint file as {key: np.ndarray} (no bf16 here)."""
    with open(path + ".json") as f:
        meta = json.load(f)
    with np.load(path + ".npz") as data:
        return {k: np.array(data[f"a{m['idx']}"]) for k, m in meta.items()}


# ---------------------------------------------------------------------------
# the schedule, the sampler's validation, the sampled weights


@pytest.mark.parametrize("per_cohort", [2, (3, 1), 99],
                         ids=["scalar", "tuple", "identity"])
def test_schedule_draws_equal_reference(per_cohort):
    """Rounds 0-9 over cohorts of 5 and 4: the same counts, identity
    flag, local indices and global ids as the reference, sorted."""
    js = jstore.ParticipantSchedule(
        jspec.ParticipantSampler(per_cohort=per_cohort, seed=3), [5, 4],
        [0, 5])
    ts = ParticipantSchedule(spec.ParticipantSampler(
        per_cohort=per_cohort, seed=3), [5, 4], [0, 5])
    assert ts.counts == js.counts and ts.total == js.total
    assert ts.is_identity == js.is_identity == (per_cohort == 99)
    for r in range(10):
        for a, b in zip(ts.round_locals(r), js.round_locals(r)):
            np.testing.assert_array_equal(a, b)
            assert list(a) == sorted(set(a))
        np.testing.assert_array_equal(ts.round_ids(r), js.round_ids(r))
    if per_cohort == 99:
        np.testing.assert_array_equal(ts.round_ids(4), np.arange(9))
    else:
        assert len({tuple(ts.round_ids(r)) for r in range(10)}) > 1


SAMPLER_ERRORS = {
    "zero": (dict(per_cohort=0), None),
    "zero-entry": (dict(per_cohort=(1, 0)), None),
    "entries": (dict(per_cohort=(2,)), [5, 4]),
    "out-of-range": (dict(per_cohort=(2, 6)), [5, 4]),
}


@pytest.mark.parametrize("name", sorted(SAMPLER_ERRORS))
def test_sampler_validation_matches_reference(name):
    """Each invalid sampler raises ValueError with the reference's
    message, at construction or at ``counts``."""
    kw, sizes = SAMPLER_ERRORS[name]
    msgs = []
    for mod in (jspec, spec):
        with pytest.raises(ValueError) as e:
            mod.ParticipantSampler(**kw).counts(sizes)
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]


def test_spec_validates_and_types_the_sampler():
    """The spec resolves the counts at construction (as the reference's
    does) and refuses a sampler of the reference package."""
    js, ts = pop_specs("vectorized")
    assert ts.sampler.counts([4, 5]) == js.sampler.counts([4, 5]) == (2, 3)
    for mod, s in ((jspec, js), (spec, ts)):
        with pytest.raises(ValueError, match="out of range"):
            dataclasses.replace(s, sampler=mod.ParticipantSampler(
                per_cohort=(2, 6)))
    with pytest.raises(TypeError, match="ParticipantSampler"):
        dataclasses.replace(ts, sampler=jspec.ParticipantSampler(2))


def test_sampled_weights_match_reference():
    """Eq. 13 over a sampled subset (with and without a survivor mask)
    equals the reference's, and over the whole population in id order
    equals ``aggregation_weights`` bit for bit."""
    counts = [3, 1, 2, 2, 3, 0, 1]
    ids = [1, 3, 4, 6]
    pres = np.array([True, False, True, True])
    for p in (None, pres):
        np.testing.assert_array_equal(
            mma.sampled_weights(counts, ids, present=p).numpy(),
            np.asarray(jmma.sampled_weights(counts, ids, present=p)))
    assert torch.equal(mma.sampled_weights(counts, range(7)),
                       mma.aggregation_weights(counts))


# ---------------------------------------------------------------------------
# the store and the checkpoint format


def client_state(cid):
    return {"train": {"layers/attn/wq_lora_a": torch.full((2, 3), cid,
                                                          dtype=torch.float32),
                      "layers/attn/wq_lora_b": torch.full(
                          (4,), cid / 2 + 1 / 3, dtype=torch.bfloat16)},
            "opt": (torch.tensor(cid, dtype=torch.int32),
                    {"m": torch.full((2, 3), -cid, dtype=torch.float32)})}


def bits(t):
    return t.view(torch.int16) if t.dtype == torch.bfloat16 else t


@pytest.mark.parametrize("spill", [False, True], ids=["memory", "spill"])
def test_client_store_roundtrip(tmp_path, spill):
    """put / get / gather (row order follows the ids) / scatter (rows
    swapped back under swapped ids) / nbytes / state_pytree, bf16 leaves
    bit for bit; an entry is a host copy, never a view of its source."""
    store = ClientStore(str(tmp_path / "spill") if spill else None)
    src = [client_state(cid) for cid in range(3)]
    for cid, st in enumerate(src):
        store.put(cid, st)
    src[1]["train"]["layers/attn/wq_lora_a"].add_(100.0)   # the source only
    assert len(store) == 3 and store.ids() == [0, 1, 2]
    for got, want in zip(ckpt.flatten_pytree(store.get(1)).values(),
                         ckpt.flatten_pytree(client_state(1)).values()):
        assert got.dtype == want.dtype and torch.equal(bits(got), bits(want))
    g = store.gather([2, 0])
    a = g["train"]["layers/attn/wq_lora_a"]
    assert a.shape == (2, 2, 3) and a[0, 0, 0] == 2 and a[1, 0, 0] == 0
    assert g["train"]["layers/attn/wq_lora_b"].dtype == torch.bfloat16
    assert g["opt"][0].tolist() == [2, 0]
    store.scatter([0, 2], g)
    assert store.get(0)["train"]["layers/attn/wq_lora_a"][0, 0] == 2
    assert store.get(2)["train"]["layers/attn/wq_lora_a"][0, 0] == 0
    assert store.get(2)["opt"][1]["m"][0, 0] == 0
    per_client = 6 * 4 + 4 * 2 + 4 + 6 * 4
    assert store.nbytes() == 3 * per_client
    if spill:
        files = set(os.listdir(tmp_path / "spill"))
        assert {f"client_{j}.{e}" for j in range(3)
                for e in ("npz", "json")} <= files
    fresh = ClientStore(None)
    fresh.load_state_pytree(store.state_pytree())
    assert fresh.ids() == store.ids()
    for cid in store.ids():
        for x, y in zip(ckpt.flatten_pytree(fresh.get(cid)).values(),
                        ckpt.flatten_pytree(store.get(cid)).values()):
            assert torch.equal(bits(x), bits(y))


def tree_pair():
    """One tree in both packages' leaf types: bf16, f32, int32, an int64
    scalar, nested tuples and '/'-joined dict keys."""
    rng = np.random.RandomState(0)
    f32 = rng.randn(3, 5).astype(np.float32)
    b16 = rng.randn(4, 2).astype(np.float32)
    steps = np.arange(3, dtype=np.int32)
    t = {"round": torch.tensor(7, dtype=torch.int64),
         "server": {"layers/attn/wq_lora_b": torch.from_numpy(b16).to(
             torch.bfloat16), "connector/w": torch.from_numpy(f32)},
         "clients": ((torch.from_numpy(steps), {"mu": torch.from_numpy(
             f32 * 2)}), (torch.from_numpy(steps + 1),))}
    j = {"round": np.int64(7),
         "server": {"layers/attn/wq_lora_b": np.asarray(
             jnp.asarray(b16, jnp.bfloat16)), "connector/w": f32},
         "clients": ((steps, {"mu": f32 * 2}), (steps + 1,))}
    return t, j


def test_checkpoint_format_is_shared_with_reference(tmp_path):
    """A tree saved by the port loads back bit for bit, loads with the
    reference's ``load_pytree`` bit for bit (and the reverse), and both
    packages write the same manifest."""
    t, j = tree_pair()
    ckpt.save_pytree(str(tmp_path / "port"), t)
    jckpt.save_pytree(str(tmp_path / "jax"), j)
    manifests = [json.load(open(tmp_path / f"{n}.json"))
                 for n in ("port", "jax")]
    assert manifests[0] == manifests[1]
    assert manifests[0]["server/layers/attn/wq_lora_b"]["dtype"] == \
        "bfloat16"
    want = ckpt.flatten_pytree(t)
    for name in ("port", "jax"):
        back = ckpt.load_pytree(str(tmp_path / name), t)
        assert isinstance(back["clients"][0], tuple)
        for k, v in ckpt.flatten_pytree(back).items():
            assert v.dtype == want[k].dtype, k
            assert torch.equal(bits(v), bits(want[k])), (name, k)
        jback = jckpt.load_pytree(str(tmp_path / name), j)
        for k, v in jckpt.flatten_pytree(jback).items():
            ref = want[k]
            got = np.asarray(v)
            if ref.dtype == torch.bfloat16:
                assert got.dtype == jnp.bfloat16
                np.testing.assert_array_equal(
                    got.view(np.uint16), bits(ref).numpy().view(np.uint16))
            else:
                np.testing.assert_array_equal(got, ref.numpy())


def test_checkpoint_manager_keeps_the_newest(tmp_path):
    """``keep=`` garbage collection, ``latest_step`` and a restore of the
    newest step, as the reference's manager."""
    t, _ = tree_pair()
    d = str(tmp_path / "ck")
    assert ckpt.latest_step(d) is None
    mgr = ckpt.CheckpointManager(d, keep=2)
    with pytest.raises(FileNotFoundError):
        mgr.restore(t)
    for step in (1, 5, 3):
        mgr.save(step, dict(t, round=torch.tensor(step)))
    assert sorted(os.listdir(d)) == ["step_3.json", "step_3.npz",
                                     "step_5.json", "step_5.npz"]
    assert ckpt.latest_step(d) == jckpt.latest_step(d) == 5
    assert int(mgr.restore(t)["round"]) == 5
    assert int(mgr.restore(t, step=3)["round"]) == 3


# ---------------------------------------------------------------------------
# the runner under a sampler


def two_rounds(r):
    return [r.run_round() for _ in range(2)]


@pytest.mark.parametrize("engine", ["loop", "vectorized"])
def test_identity_sampler_is_bit_equal(corpus, engine):
    """A sampler that covers every client reproduces the unsampled runner
    bit for bit over two faulty rounds over int8: summaries, weights,
    every leaf, ``comm_stats``; the population sits in the store."""
    _, plain = pop_specs(engine, per_cohort=None)
    _, ident = pop_specs(engine, per_cohort=99)
    a = FederatedRunner(plain, corpus, device="cpu")
    b = FederatedRunner(ident, corpus, device="cpu")
    assert a.store is None and len(b.store) == 9
    offline = False
    for ra, rb in zip(two_rounds(a), two_rounds(b)):
        assert ra["summary"] == rb["summary"]
        assert rb["participants"] == list(range(9))
        offline |= not a._rnd_present.all()
    np.testing.assert_array_equal(a._rnd_weights, b._rnd_weights)
    assert offline
    la, lb = leaves_of(a), leaves_of(b)
    assert sorted(la) == sorted(lb)
    assert all(torch.equal(la[k], lb[k]) for k in la)
    assert a.comm_stats == b.comm_stats and a.comm_log == b.comm_log


@pytest.fixture(scope="module")
def sampled_case(corpus, tmp_path_factory):
    """The sampled population on the JAX vectorized runner and the port's
    vectorized runner from its states: two rounds, then each saves a
    checkpoint (J and P); the JAX runner loads P, the port runner J, and
    each runs the third round.  The port's loop engine runs the first two
    rounds from the same states."""
    jsp, tsp = pop_specs("vectorized")
    jr = JRunner(jsp, corpus)
    init = carried_state(jr)
    tr = FederatedRunner(tsp, corpus, device="cpu", init_state=init)
    uplink = recording_uplink(tr)
    case = {"jr": jr, "tr": tr, "uplink": uplink, "masks": [],
            "sums": {"jax": [], "port": []}, "participants": []}
    for _ in range(2):
        outs = [r.run_round() for r in (jr, tr)]
        for who, o in zip(("jax", "port"), outs):
            case["sums"][who].append(o["summary"])
        case["participants"].append([o["participants"] for o in outs])
        case["masks"].append([(r._rnd_present, r._rnd_contrib,
                               r._rnd_weights) for r in (jr, tr)])
    case["leaves"] = leaves_of(tr)
    case["jleaves"] = {k: np.array(v) for k, v in jax_leaves(jr).items()}
    loop = FederatedRunner(dataclasses.replace(tsp, engine="loop"), corpus,
                           device="cpu", init_state=init)
    case["loop"] = (loop, two_rounds(loop))

    # the checkpoints, then the third round on the other package's file
    root = tmp_path_factory.mktemp("ckpt")
    jdir, tdir = str(root / "jax"), str(root / "port")
    assert jr.save_checkpoint(jckpt.CheckpointManager(jdir)) == 2
    assert tr.save_checkpoint(ckpt.CheckpointManager(tdir)) == 2
    case["files"] = (os.path.join(jdir, "step_2"),
                     os.path.join(tdir, "step_2"))
    jr.load_checkpoint(jckpt.CheckpointManager(tdir))
    tr.load_checkpoint(ckpt.CheckpointManager(jdir))
    case["third"] = [r.run_round() for r in (jr, tr)]
    return case


def test_sampled_rounds_match_jax_vectorized(sampled_case):
    """Two sampled rounds: the same participants, masks and weights over
    the working set, summaries, every registered client's and the
    servers' leaves (at 2e-5 plus one int8 step: the uplink's largest
    value of the key, of any key for the servers, over 127), and the
    bytes on the wire (``comm_stats`` after the third round too) as the
    JAX vectorized runner."""
    case = sampled_case
    for jp, tp in case["participants"]:
        assert jp == tp and len(tp) == sum(PER_COHORT)
    assert case["participants"][0] != case["participants"][1]
    check_summaries(case)
    check_comm_and_draws(case)
    up, got = case["uplink"], case["leaves"]
    assert sorted(got) == sorted(case["jleaves"])
    for name, want in case["jleaves"].items():
        who, k = name.split(":", 1)
        top = max(up.values()) if who.startswith("server") \
            else up.get(k, 0.0)
        step = max(top, float(np.abs(want).max())) / 127.0
        np.testing.assert_allclose(_np(got[name]), want, rtol=0,
                                   atol=2e-5 + step, err_msg=name)


def test_sampled_loop_engine_matches_vectorized(sampled_case):
    """The same two sampled rounds on the port's loop engine: summaries,
    participants and every leaf within 1e-5 of the vectorized engine's,
    the same bytes on the wire."""
    loop, outs = sampled_case["loop"]
    for o, s, (_, parts) in zip(outs, sampled_case["sums"]["port"],
                                sampled_case["participants"]):
        assert o["participants"] == parts
        for k, v in s.items():
            assert abs(o["summary"][k] - v) <= ENGINE_TOL * max(1, abs(v))
    got, want = leaves_of(loop), sampled_case["leaves"]
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        np.testing.assert_allclose(_np(got[k]), _np(v), rtol=0,
                                   atol=ENGINE_TOL, err_msg=k)
    assert loop.comm_log == sampled_case["tr"].comm_log[:2]


def test_checkpoints_cross_packages(sampled_case):
    """J (written by the JAX runner) and P (by the port's) hold the same
    keys, the store's per-client entries with their residuals included,
    with leaves within the parity tolerance; each package ran its third
    round from the other's file, and the two third rounds agree."""
    jfile, tfile = sampled_case["files"]
    J, P = read_flat(jfile), read_flat(tfile)
    assert sorted(J) == sorted(P)
    assert {k.split("/")[0] for k in P} == {
        "round", "server_llm", "server_slm", "server_llm_opt",
        "server_slm_opt", "last_global", "clients"}
    assert any(k.startswith("clients/c8/chan/") for k in P)
    assert int(J["round"]) == int(P["round"]) == 2
    step = max(sampled_case["uplink"].values()) / 127.0
    for k, v in J.items():
        assert P[k].dtype == v.dtype, k
        np.testing.assert_allclose(P[k], v, rtol=0, atol=2e-5 + step,
                                   err_msg=k)
    (jo, to) = sampled_case["third"]
    assert jo["participants"] == to["participants"]
    third = dict(sampled_case, sums={"jax": [jo["summary"]],
                                     "port": [to["summary"]]})
    check_summaries(third)
    check_leaves(third)


@pytest.mark.parametrize("engine", ["loop", "vectorized"])
def test_port_resume_is_bit_identical(corpus, tmp_path, engine):
    """Two sampled rounds, a checkpoint, two more; a fresh runner (the
    loop engine's with its store spilled to disk) restored from the
    checkpoint replays the last two rounds bit for bit: participants,
    summaries and every leaf.  The device holds the working set only."""
    _, tsp = pop_specs(engine)
    a = FederatedRunner(tsp, corpus, device="cpu")
    two_rounds(a)
    mgr = ckpt.CheckpointManager(str(tmp_path / "ck"))
    assert a.save_checkpoint(mgr) == 2
    cont = two_rounds(a)
    spill = str(tmp_path / "pop") if engine == "loop" else None
    b = FederatedRunner(tsp, corpus, device="cpu", store_dir=spill)
    b.load_checkpoint(mgr)
    for x, y in zip(cont, two_rounds(b)):
        assert x["participants"] == y["participants"]
        assert x["summary"] == y["summary"]
    la, lb = leaves_of(a), leaves_of(b)
    assert all(torch.equal(la[k], lb[k]) for k in la)
    if spill:
        assert {f"client_{j}.npz" for j in range(9)} <= set(os.listdir(spill))
        assert all(not rt.device_params for rt in b.cohorts)
    else:
        for rt, k in zip(b.cohorts, PER_COHORT):
            assert rt.work_n == k
            for v in lora.partition(rt.stacked_params).values():
                assert v.shape[0] == k
            for v in rt.chan_state.values():
                assert v.shape[0] == k
    assert a.store.nbytes() == b.store.nbytes()
