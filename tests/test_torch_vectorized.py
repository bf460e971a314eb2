"""The port's vectorized engine: each of its stacked parts against G
unstacked calls, the port's vectorized runner against the port's loop
runner, and against the JAX vectorized runner.

The stacked parts (f32, CPU, the plain versions of the kernels): kernel
C's grouped form (against per-group ``lora_matmul_plain`` and against
``jax.vmap`` of the Pallas kernel in interpret mode), the stacked loss
(one masked mean per client), the contrastive losses (negatives rolled
within each client), AdamW (the clip and the step count per client), the
stacked eval pass, the stacked batch streams and the client-axis helpers.
Each has a planted case that a folded (client-blind) version fails.  The
runners agree to 1e-5 on summaries and every LoRA leaf, with
``comm_stats`` equal (on this CPU the two engines agree bit for bit); the
JAX vectorized runner to rtol 1e-4 on summaries and atol 2e-5 on leaves.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_cohort_cases import (FAULTS, HET, PARTIAL, SRV,
                                 SLM as COH_SLM, carried_state,
                                 check_comm_and_draws, check_leaves,
                                 check_summaries, make_specs)
from _torch_cohort_cases import corpus as make_corpus
from repro.core.federated import FederatedRunner as JRunner
from repro.data import pipeline as jpipe
from repro.kernels.lora_matmul import lora_matmul as jlora_kernel
from repro_torch.configs.base import ModelConfig
from repro_torch.core import ccl, gram, lora, seccl
from repro_torch.core.channel import ChannelSpec
from repro_torch.core.federated import FederatedConfig, FederatedRunner
from repro_torch.core.spec import FaultSpec
from repro_torch.data import pipeline
from repro_torch.data.synthetic import synthetic_multimodal_corpus
from repro_torch.kernels import lora_matmul as lm
from repro_torch.kernels import ops
from repro_torch.models.model import build_model
from repro_torch.optim.adamw import adamw

torch.set_num_threads(1)

_KW = dict(n_modalities=3, modality_dim=32, n_soft_tokens=4,
           connector_dim=48, lora_rank=4, remat=False, activation="gelu",
           vocab_size=128, dtype="float32")
SLM = ModelConfig(name="vec-slm", family="dense", n_layers=2, d_model=48,
                  n_heads=4, n_kv_heads=2, head_dim=12, d_ff=96, **_KW)
LLM = ModelConfig(name="vec-llm", family="dense", n_layers=2, d_model=64,
                  n_heads=4, n_kv_heads=2, head_dim=16, d_ff=128, **_KW)
ROUND = dict(n_devices=3, rounds=2, local_steps_ccl=2, local_steps_amt=2,
             server_steps=1, batch_size=8, lr=1e-2, rho=0.7)
ENGINE_TOL = 1e-5          # the reference's loop vs vectorized tolerance


def _t(a, grad=False):
    return torch.tensor(np.asarray(a, np.float32), requires_grad=grad)


def _np(t):
    return t.detach().float().numpy()


@pytest.fixture(scope="module")
def corpus():
    return synthetic_multimodal_corpus(0, 384, 24, 128, n_classes=4,
                                       n_modalities=3, modality_dim=32,
                                       template_len=4)


def grouped_np(G, Mg, K, N, r, seed=0):
    """Inputs of grouped C: x (G·Mg, K), shared w, per-group a and a
    non-zero, different b for every group."""
    rng = np.random.RandomState(seed)
    return (rng.randn(G * Mg, K).astype(np.float32),
            (rng.randn(K, N) / np.sqrt(K)).astype(np.float32),
            (rng.randn(G, K, r) / np.sqrt(K)).astype(np.float32),
            (0.1 * rng.randn(G, r, N)).astype(np.float32))


# ---------------------------------------------------------------------------
# kernel C's grouped form

@pytest.mark.parametrize("G,Mg,K,N,r", [(3, 17, 24, 20, 4), (2, 5, 8, 16, 8),
                                        (1, 9, 12, 7, 2)])
def test_grouped_lora_plain_matches_per_group_calls(G, Mg, K, N, r):
    """Values and gradients (x, A, B) of the grouped plain version against
    G calls of ``lora_matmul_plain`` (f32, 1e-6).  Planted: every group on
    group 0's adapter (the wrong-index fault) is far off."""
    x, w, a, b = grouped_np(G, Mg, K, N, r)
    dy = np.random.RandomState(1).randn(G * Mg, N).astype(np.float32)
    xs, as_, bs = _t(x, True), _t(a, True), _t(b, True)
    y = ops.lora_matmul_grouped(xs, _t(w), as_, bs, 2.0)
    y.backward(_t(dy))
    xr, ar, br = _t(x, True), _t(a, True), _t(b, True)
    want = torch.cat([lm.lora_matmul_plain(xr[g * Mg:(g + 1) * Mg], _t(w),
                                           ar[g], br[g], 2.0)
                      for g in range(G)])
    want.backward(_t(dy))
    np.testing.assert_allclose(_np(y), _np(want), atol=1e-6)
    for got, ref in ((xs, xr), (as_, ar), (bs, br)):
        np.testing.assert_allclose(_np(got.grad), _np(ref.grad), atol=1e-6)
    if G > 1:
        wrong = lm.lora_matmul_grouped_plain(
            xs.detach(), _t(w), as_.detach()[:1].expand(G, -1, -1),
            bs.detach()[:1].expand(G, -1, -1), 2.0)
        assert float((wrong - want.detach()).abs().max()) > 1e-2


def test_grouped_lora_plain_matches_vmapped_jax_kernel():
    """The grouped plain version against ``jax.vmap`` of the Pallas kernel
    over the client axis (interpret mode, blocks dividing the shapes) at
    1e-4, f32."""
    G, Mg, K, N, r = 3, 64, 128, 128, 8
    x, w, a, b = grouped_np(G, Mg, K, N, r, seed=2)
    want = jax.vmap(lambda xg, ag, bg: jlora_kernel(
        xg, jnp.asarray(w), ag, bg, scale=2.0, bm=64, bn=64, bk=64,
        interpret=True))(jnp.asarray(x.reshape(G, Mg, K)), jnp.asarray(a),
                         jnp.asarray(b))
    got = ops.lora_matmul_grouped(_t(x), _t(w), _t(a), _t(b), 2.0)
    np.testing.assert_allclose(_np(got), np.asarray(want).reshape(G * Mg, N),
                               atol=1e-4, rtol=1e-4)


def test_grouped_autograd_wrapper_with_plain_launches(monkeypatch):
    """The grouped autograd Function the card runs (forward and dx through
    the grouped kernel with W read transposed and the transposed adapter
    views, per-group f32 dA/dB), every launch replaced by the plain
    version: gradients equal the plain version's autograd (1e-5), and the
    route function takes the grouped shapes and refuses ragged groups."""
    def launch(x, w, a, b, scale, trans_w=False):
        return lm.lora_matmul_grouped_plain(x, w.t() if trans_w else w, a, b,
                                            scale)
    monkeypatch.setattr(lm, "lora_matmul_grouped_cuda", launch)
    x, w, a, b = grouped_np(3, 11, 16, 24, 4, seed=5)
    dy = _t(np.random.RandomState(6).randn(33, 24))
    grads = []
    for fn in (lm.lora_matmul_grouped_autograd, lm.lora_matmul_grouped_plain):
        ins = [_t(v, True) for v in (x, a, b)]
        fn(ins[0], _t(w), ins[1], ins[2], 2.0).backward(dy)
        grads.append([t.grad for t in ins])
    for got, want in zip(*grads):
        np.testing.assert_allclose(_np(got), _np(want), atol=1e-5)
    bf = torch.bfloat16
    xb, wb = torch.zeros(3 * 136, 64, dtype=bf), torch.zeros(64, 32, dtype=bf)
    ab, bb = torch.zeros(3, 64, 8, dtype=bf), torch.zeros(3, 8, 32, dtype=bf)
    assert lm.lora_matmul_grouped_route(xb, wb, ab, bb) == "wgmma"
    assert lm.lora_matmul_grouped_route(_t(x), _t(w), _t(a), _t(b)) == "fma"
    with pytest.raises(ValueError, match="grouped"):
        lm.lora_matmul_grouped_route(xb[:-1], wb, ab, bb)


# ---------------------------------------------------------------------------
# the stacked model loss, contrastive losses, AdamW and eval

def _stacked_unified(cfg, G, seed=0):
    """One backbone and G clients' personal leaves (LoRA B non-zero and
    different per client): (bundle, stacked tree, per-client trees)."""
    bundle = build_model(cfg)
    gen = torch.Generator().manual_seed(seed)
    base = ccl.init_unified(gen, bundle)
    clients = []
    for g in range(G):
        pers = lora.partition(ccl.init_unified(gen, bundle))
        pers = {k: (0.05 * torch.randn(v.shape, generator=gen)
                    if k.endswith("_lora_b") else v) for k, v in pers.items()}
        clients.append(pers)
    stacked = lora.combine(base, lora.stack_clients(clients))
    return bundle, stacked, [lora.combine(base, c) for c in clients]


def _client_batches(corpus, G, B, seeds=(3, 4, 5)):
    masks = np.array([[1, 0, 1], [1, 1, 1], [0, 1, 1]], bool)
    it = pipeline.stacked_batches([corpus] * G, B, seeds[:G], masks[:G])
    return next(it)


def test_stacked_lm_and_mlecs_loss_match_per_client(corpus):
    """``lm_loss_stacked`` and the stacked ``mlecs_loss`` (CCL term with
    server-style anchors) give each client its own loss and gradients,
    equal to G unstacked calls (1e-6).  Planted: client 2 sees half the
    loss-mask tokens of the others, so one mean over all G·B rows differs
    from the per-client means."""
    G, B = 3, 6
    bundle, stacked, trees = _stacked_unified(SLM, G)
    batch = _client_batches(corpus, G, B)
    batch["loss_mask"][2, :, ::2] = 0
    tb = pipeline.to_tensors(batch, "cpu")
    anchor = torch.randn((G, B, 48), generator=torch.Generator().manual_seed(9))
    train = {k: v.clone().requires_grad_(True)
             for k, v in lora.partition(stacked).items()}
    loss, (m, _) = ccl.mlecs_loss(lora.combine(stacked, train), bundle, tb,
                                  anchor=anchor, n_negatives=4, stacked=True)
    assert loss.shape == (G,)
    grads = ccl.grads_of(loss.sum(), train)
    ce_all = []
    for g in range(G):
        tr = {k: v.clone().requires_grad_(True)
              for k, v in lora.partition(trees[g]).items()}
        b = {k: v[g] for k, v in tb.items()}
        lg, (mg, _) = ccl.mlecs_loss(lora.combine(trees[g], tr), bundle, b,
                                     anchor=anchor[g], n_negatives=4)
        np.testing.assert_allclose(_np(loss[g]), _np(lg), rtol=1e-6)
        np.testing.assert_allclose(_np(m["ccl"][g]), _np(mg["ccl"]),
                                   rtol=1e-6)
        for k, v in ccl.grads_of(lg, tr).items():
            np.testing.assert_allclose(_np(grads[k][g]), _np(v), atol=1e-6,
                                       err_msg=k)
        ce_all.append(_np(mg["ce"]))
    ls, _ = bundle.lm_loss_stacked(stacked, tb)
    # one mean over every row (the folding fault) is not the clients' mean
    w = tb["loss_mask"][:, :, 1:].float()
    assert abs(float((ls * w.sum((1, 2))).sum() / w.sum())
               - float(ls.mean())) > 1e-3
    np.testing.assert_allclose(_np(m["ce"]), ce_all, rtol=1e-6)


@pytest.mark.parametrize("score", [gram.contrastive_loss,
                                   gram.pairwise_cosine_loss])
def test_stacked_contrastive_losses_roll_within_clients(score):
    """With a client axis, the in-batch negatives roll within each
    client's B rows: each client's loss equals its own unstacked call
    (1e-6), and the whole batch goes through one log-volume call.  Planted:
    the same rows folded into one batch of G·B (negatives crossing
    clients) give other losses."""
    rng = np.random.RandomState(0)
    G, B, M, d = 3, 5, 3, 16
    anchor = _t(rng.randn(G, B, d))
    mods = _t(rng.randn(G, B, M, d))
    mask = torch.from_numpy(rng.rand(G, B, M) < 0.7)
    got = score(anchor, mods, mask, 3)
    assert got.shape == (G,)
    want = [float(score(anchor[g], mods[g], mask[g], 3)) for g in range(G)]
    np.testing.assert_allclose(_np(got), want, rtol=1e-6)
    folded = score(anchor.reshape(G * B, d), mods.reshape(G * B, M, d),
                   mask.reshape(G * B, M), 3)
    assert abs(float(folded) - float(np.mean(want))) > 1e-4


def test_stacked_adamw_clips_and_counts_per_client():
    """``update_stacked`` against G calls of ``update``, bit for bit on
    this CPU (held at 1e-7): client 1's gradient alone exceeds the clip
    norm (the others do not) and the clients' step counts differ (an
    offline client's count was selected back).  Planted: one clip over
    all clients' gradients changes the unclipped clients' updates."""
    rng = np.random.RandomState(0)
    G = 3
    shapes = {"l/wq_lora_a": (2, 12, 4), "l/wq_lora_b": (2, 4, 12),
              "connector/proj_w": (3, 8, 6)}
    grads = {k: _t(rng.randn(G, *s) * 0.01) for k, s in shapes.items()}
    grads["l/wq_lora_a"][1] *= 1e4
    params = {k: _t(rng.randn(G, *s)) for k, s in shapes.items()}
    opt = adamw(1e-2)
    states = [opt.init({k: v[g] for k, v in params.items()})
              for g in range(G)]
    for _ in range(2):           # advance client 0 twice, client 2 once
        _, states[0] = opt.update({k: v[0] for k, v in grads.items()},
                                  states[0], {k: v[0] for k, v in
                                              params.items()})
    _, states[2] = opt.update({k: v[2] for k, v in grads.items()}, states[2],
                              {k: v[2] for k, v in params.items()})
    stacked = lora.stack_trees(states)
    assert stacked["step"].tolist() == [2, 0, 1]
    u, st = opt.update_stacked(grads, stacked, params)
    assert st["step"].tolist() == [3, 1, 2]
    for g in range(G):
        ug, sg = opt.update({k: v[g] for k, v in grads.items()}, states[g],
                            {k: v[g] for k, v in params.items()})
        for k in shapes:
            np.testing.assert_allclose(_np(u[k][g]), _np(ug[k]), atol=1e-7)
            np.testing.assert_allclose(_np(st["mu"][k][g]),
                                       _np(sg["mu"][k]), atol=1e-7)
    # one global clip over every client would scale clients 0 and 2 too
    total = float(torch.sqrt(sum((v ** 2).sum() for v in grads.values())))
    assert total > 1.0
    small = float(torch.sqrt(sum((v[0] ** 2).sum() for v in grads.values())))
    assert small < 1.0


def test_stacked_eval_pass_matches_per_client_loop(corpus):
    """``make_eval_fn(n_clients=G)`` over padded stacked shards of test
    sets of different sizes (one shorter than a batch) equals each
    client's host loop over its own padded batches (the loop engine's
    order of f32 sums): metrics to 1e-6."""
    G, B = 3, 8
    bundle, stacked, trees = _stacked_unified(SLM, G, seed=1)
    datas = [{k: v[:n] for k, v in corpus.items()} for n in (20, 5, 13)]
    masks = np.array([[1, 0, 1], [1, 1, 1], [0, 1, 1]], bool)
    steps = pipeline.to_tensors(pipeline.stack_eval_steps(
        pipeline.stacked_eval_batches(datas, B, masks)), "cpu")
    assert steps["tokens"].shape[:3] == (3, G, B)
    sums = seccl.make_eval_fn(bundle, n_clients=G)(stacked, steps)
    step = seccl.make_eval_step(bundle)
    for g in range(G):
        acc = {k: np.float32(0) for k in seccl.EVAL_SUM_KEYS}
        for b in pipeline.np_eval_batches(datas[g], B, masks[g]):
            out = step(trees[g], pipeline.to_tensors(b, "cpu"))
            acc = {k: np.float32(acc[k] + np.float32(out[k].item()))
                   for k in acc}
        got = seccl.metrics_from_sums({k: float(v[g]) for k, v in
                                       sums.items()})
        want = seccl.metrics_from_sums(acc)
        for k in want:
            np.testing.assert_allclose(got[k], want[k], rtol=1e-6,
                                       atol=1e-7)


# ---------------------------------------------------------------------------
# stacked batches and the client-axis helpers

def test_stacked_streams_match_the_reference_and_the_loop(corpus):
    """``stacked_batches`` + ``stack_steps`` equal the JAX package's, and
    each client's sub-stream is its own ``ClientStreams`` stream; the
    bank's ``gather_steps`` pulls the same; ``stacked_eval_batches`` equals
    the reference's padded shards."""
    datas = [corpus, {k: v[:50] for k, v in corpus.items()}, corpus]
    seeds, masks = [5, 6, 7], np.array([[1, 0, 1], [1, 1, 1], [0, 1, 1]],
                                       bool)
    got = pipeline.stack_steps(pipeline.stacked_batches(datas, 8, seeds,
                                                        masks), 3)
    want = jpipe.stack_steps(jpipe.stacked_batches(datas, 8, seeds, masks), 3)
    bank = pipeline.ClientStreams()
    for j, d in enumerate(datas):
        bank.register(f"c/{j}", d, 8, seeds[j], masks[j])
    gathered = bank.gather_steps([f"c/{j}" for j in range(3)], 3)
    solo = pipeline.ClientStreams()
    solo.register("c/1", datas[1], 8, seeds[1], masks[1])
    one = solo.stack_steps("c/1", 3)
    for k in want:
        np.testing.assert_array_equal(got[k], np.asarray(want[k]))
        np.testing.assert_array_equal(gathered[k], got[k])
        np.testing.assert_array_equal(one[k], got[k][:, 1])
    ev = pipeline.stack_eval_steps(pipeline.stacked_eval_batches(
        datas[:2], 8, masks[:2]))
    jev = jpipe.stack_eval_steps(jpipe.stacked_eval_batches(
        datas[:2], 8, masks[:2]))
    for k in jev:
        np.testing.assert_array_equal(ev[k], np.asarray(jev[k]))


def test_client_axis_helpers():
    rng = np.random.RandomState(0)
    clients = [{"a/x_lora_a": _t(rng.randn(2, 3)), "connector/w": _t(
        rng.randn(4))} for _ in range(3)]
    st = lora.stack_clients(clients)
    assert st["a/x_lora_a"].shape == (3, 2, 3)
    back = lora.unstack_clients(st)
    for c, b in zip(clients, back):
        assert all(torch.equal(c[k], b[k]) for k in c)
    shared = {"a/x_lora_a": _t(rng.randn(2, 3)), "connector/w": _t(
        rng.randn(4))}
    bc = lora.broadcast_clients(st, shared)
    assert all(torch.equal(bc[k][j], shared[k]) for k in bc for j in range(3))
    tree = {"step": torch.arange(3), "mu": dict(st)}
    assert torch.equal(lora.unstack_tree(tree, 3)[2]["mu"]["connector/w"],
                       clients[2]["connector/w"])
    with pytest.raises(ValueError, match="key sets"):
        lora.stack_clients([clients[0], {"other": clients[1]["connector/w"]}])


# ---------------------------------------------------------------------------
# the vectorized runner against the loop runner

def _leaves(trees):
    return [lora.partition(t, lora.is_lora_leaf) for t in trees]


def assert_engines_agree(loop, vec, sums_loop, sums_vec, tol=ENGINE_TOL):
    """Summaries and every device's and server model's LoRA leaves within
    ``tol`` (the engine tolerance); ``comm_stats`` and ``comm_log``
    equal."""
    for a, b in zip(sums_loop, sums_vec):
        assert set(a) == set(b)
        for k in a:
            np.testing.assert_allclose(b[k], a[k], rtol=0, atol=tol,
                                       err_msg=k)
    trees_l = loop.device_params + [loop.server_slm, loop.server_llm]
    trees_v = vec.device_params + [vec.server_slm, vec.server_llm]
    for la, lb in zip(_leaves(trees_l), _leaves(trees_v)):
        assert sorted(la) == sorted(lb)
        for k in la:
            np.testing.assert_allclose(_np(lb[k]), _np(la[k]), rtol=0,
                                       atol=tol, err_msg=k)
    assert vec.comm_stats == loop.comm_stats
    assert vec.comm_log == loop.comm_log


def _legacy_pair(corpus, **over):
    out = []
    for engine in ("loop", "vectorized"):
        cfg = FederatedConfig(engine=engine, **{**ROUND, **over})
        out.append(FederatedRunner(cfg, build_model(SLM), build_model(LLM),
                                   corpus, device="cpu"))
    return out


ENGINE_CASES = {
    "mlecs": {},
    "fedavg": dict(mode="fedavg"),
    "standalone": dict(mode="standalone"),
    "faults-trimmed-scaled": dict(
        robust="trimmed_mean", faults=FaultSpec(
            dropout=0.3, straggler=0.3, max_delay=2, byzantine=0.3,
            attack="scaled_update", attack_scale=10.0, seed=3)),
    "int8": dict(channel=ChannelSpec(codec="int8")),
    "cosine-prox": dict(ccl_score="cosine", prox_weight=0.1),
    "no-mma-no-seccl": dict(use_mma=False, use_seccl=False),
    "no-ccl": dict(use_ccl=False),
}


@pytest.mark.parametrize("name", sorted(ENGINE_CASES))
def test_vectorized_runner_matches_loop_runner(corpus, name):
    """Two evaluated rounds of 2 CCL + 2 AMT + 1 SE-CCL steps on each
    engine from the same seed: the second round starts from per-client,
    non-zero LoRA B (the first round's training), where a wrong adapter
    index would show."""
    loop, vec = _legacy_pair(corpus, **ENGINE_CASES[name])
    sums, offline = {}, []
    for who, r in (("loop", loop), ("vec", vec)):
        sums[who] = [r.run_round()["summary"]]
        if who == "vec" and name != "fedavg":
            bs = lora.partition(r.stacked_params, lambda k: "_lora_b" in k)
            assert all(float(v.abs().max()) > 0 for v in bs.values())
        if who == "vec" and r._rnd_present is not None:
            offline.append(not r._rnd_present.all())
        sums[who].append(r.run_round()["summary"])
    assert_engines_agree(loop, vec, sums["loop"], sums["vec"])
    if "faults" in ENGINE_CASES[name]:
        assert offline == [True]
        steps = vec.stacked_opt["step"].tolist()
        assert steps == [o["step"].item() for o in loop.device_opt]
        assert len(set(steps)) > 1          # an offline client kept its count


def test_vectorized_runner_views_and_eval_refresh(corpus):
    """The stacked views (one shared backbone under every member's view,
    opt states unstacked), ``evaluate()`` after the round, and a test set
    shorter than a batch (after ``refresh_eval_shards``) agree with the
    loop engine."""
    loop, vec = _legacy_pair(corpus, rounds=1, local_steps_ccl=1,
                             local_steps_amt=1)
    for r in (loop, vec):
        r.run_round(evaluate=False)
    base = lora.flatten(vec.cohort_base)
    for p in vec.device_params:
        for k, v in lora.flatten(p).items():
            if not lora.default_trainable(k):
                assert v is base[k], k
    sub = {k: v[:3] for k, v in loop.priv_test[-1].items()}
    for r in (loop, vec):
        r.priv_test[-1] = sub
        r.refresh_eval_shards()
    assert_engines_agree(loop, vec, [loop.evaluate()["summary"]],
                         [vec.evaluate()["summary"]])
    assert [o["step"].item() for o in vec.device_opt] == [2, 2, 2]


COHORT_ENGINE_CASES = {
    # two architectures on disjoint modality subsets (one cohort at its
    # own batch size) under the scaled-update attack, dropouts and
    # stragglers over the int8 wire, mlecs with the trimmed mean
    "het-int8-faults": (HET, None, dict(
        channel="int8", robust="trimmed_mean", trim_frac=0.4,
        faults=dict(FAULTS, attack="scaled_update"))),
    # one cohort whose server SLM shares only part of its keys (own keys
    # averaged within the cohort)
    "partial-overlap": (PARTIAL, SRV, {}),
}


@pytest.mark.parametrize("name", sorted(COHORT_ENGINE_CASES))
def test_vectorized_cohorts_match_loop_cohorts(name):
    """Cohort structures of the spec form: two rounds per engine from the
    same seed."""
    cohorts, srv, kw = COHORT_ENGINE_CASES[name]
    corpus = make_corpus()
    _, tspec = make_specs(cohorts, srv, 2, kw)
    runs = {}
    for engine in ("loop", "vectorized"):
        r = FederatedRunner(tspec, corpus, engine=engine, device="cpu")
        runs[engine] = (r, [r.run_round()["summary"] for _ in range(2)])
    (loop, sl), (vec, sv) = runs["loop"], runs["vectorized"]
    assert_engines_agree(loop, vec, sl, sv)
    assert all(rt.stacked_params is not None for rt in vec.cohorts)
    if len(vec.cohorts) > 1:
        with pytest.raises(AttributeError, match="single-cohort"):
            vec.stacked_params


# ---------------------------------------------------------------------------
# against the JAX vectorized runner (each case is one JAX runner, whose
# compile costs most: two cases)

JAX_CASES = {
    "mlecs-2-rounds": (((COH_SLM, dict(n_clients=3, name="A")),), 2, {}),
    "het-faults": (HET, 2, dict(
        robust="norm_clip", faults=dict(FAULTS, attack="scaled_update"))),
}


@pytest.mark.parametrize("name", sorted(JAX_CASES))
def test_vectorized_runner_matches_jax_vectorized(name):
    """The port's vectorized runner against the JAX vectorized runner from
    the JAX runner's states: a single cohort over two mlecs rounds, and
    two heterogeneous cohorts under faults (norm clip, scaled update) over
    two rounds.  Summaries rtol 1e-4, leaves atol 2e-5, ``comm_stats``,
    fault masks and weights equal."""
    cohorts, rounds, kw = JAX_CASES[name]
    corpus = make_corpus()
    jspec_, tspec = (dataclasses.replace(s, engine="vectorized")
                     for s in make_specs(cohorts, None, rounds, kw))
    jr = JRunner(jspec_, corpus)
    tr = FederatedRunner(tspec, corpus, device="cpu",
                         init_state=carried_state(jr))
    case = {"jr": jr, "tr": tr, "uplink": {}, "masks": [],
            "sums": {"jax": [], "port": []}}
    for _ in range(rounds):
        for who, r in (("jax", jr), ("port", tr)):
            case["sums"][who].append(r.run_round()["summary"])
        case["masks"].append([(r._rnd_present, r._rnd_contrib,
                               r._rnd_weights) for r in (jr, tr)])
    check_summaries(case)
    check_leaves(case)
    check_comm_and_draws(case)
