"""Multi-rank cases of tests/test_torch_distributed.py: gloo ranks on the
CPU, one process each, started with ``torch.multiprocessing``'s spawn
method from a ``file://`` store.  This module imports neither ``jax`` nor
``repro`` (a spawned rank imports it afresh), and every rank runs with
one thread.

:func:`spawn` starts ``world`` ranks of :func:`worker`, joins them with a
timeout (a hung rank fails the test) and returns what each rank saved.
Each case is a function ``case(rank, world, out_dir) -> result``
(tensors and plain values, saved with ``torch.save``); ``out_dir`` is
shared by the ranks and the parent (checkpoints cross it).
"""
from __future__ import annotations

import dataclasses
import os
import traceback

import torch

from repro_torch.checkpointing import CheckpointManager, flatten_pytree
from repro_torch.configs.base import ModelConfig
from repro_torch.core import lora, spec as spec_lib
from repro_torch.core.channel import ChannelSpec
from repro_torch.core.federated import FederatedConfig, FederatedRunner
from repro_torch.data.synthetic import synthetic_multimodal_corpus
from repro_torch.models import moe
from repro_torch.models.model import build_model
from repro_torch.optim.adamw import Optimizer

_KW = dict(n_modalities=3, modality_dim=32, n_soft_tokens=4,
           connector_dim=48, lora_rank=4, remat=False, activation="gelu",
           vocab_size=128, dtype="float32")
SLM = ModelConfig(name="dist-slm", family="dense", n_layers=2, d_model=48,
                  n_heads=4, n_kv_heads=2, head_dim=12, d_ff=96, **_KW)
SLM_B = ModelConfig(name="dist-slm-b", family="dense", n_layers=1,
                    d_model=32, n_heads=2, n_kv_heads=2, head_dim=8,
                    d_ff=64, **_KW)
LLM = ModelConfig(name="dist-llm", family="dense", n_layers=2, d_model=64,
                  n_heads=4, n_kv_heads=2, head_dim=16, d_ff=128, **_KW)
ROUND = dict(rounds=2, local_steps_ccl=1, local_steps_amt=1,
             server_steps=1, batch_size=8, lr=1e-2, rho=0.7, seed=0)
MOE = ModelConfig(name="dist-moe", family="moe", n_layers=2, d_model=32,
                  n_heads=4, n_kv_heads=2, head_dim=8, d_ff=0,
                  vocab_size=64, n_experts=8, top_k=2, d_ff_expert=64,
                  capacity_factor=8.0, n_modalities=0, remat=False,
                  dtype="float32")


def corpus():
    return synthetic_multimodal_corpus(0, 384, 24, 128, n_classes=4,
                                       n_modalities=3, modality_dim=32,
                                       template_len=4)


def legacy_runner(engine, n, mesh=None):
    """The toy legacy federation of ``n`` clients on ``engine``."""
    cfg = FederatedConfig(n_devices=n, engine=engine, **ROUND)
    return FederatedRunner(cfg, build_model(SLM), build_model(LLM), corpus(),
                           mesh=mesh, device="cpu")


def cohort_runner(mesh=None, staleness=0):
    """Two cohorts (2 clients on modalities 0-1, 2 of another architecture
    on modality 2) on the overlap engine at ``staleness``."""
    fspec = spec_lib.FederationSpec(
        cohorts=(spec_lib.ClientCohort(model=SLM, n_clients=2, name="A",
                                       modalities=(0, 1)),
                 spec_lib.ClientCohort(model=SLM_B, n_clients=2, name="B",
                                       modalities=(2,), rho=0.9)),
        server_llm=LLM, engine="overlap", staleness=staleness,
        **{k: v for k, v in ROUND.items()})
    return FederatedRunner(fspec, corpus(), mesh=mesh, device="cpu")


SAMPLED = dict(ROUND, rounds=3)
SAMPLED_SAVE_AT = 2         # the checkpoint: after rounds 0 and 1


def sampled_runner(mesh=None, device="cpu"):
    """8 registered clients, 4 sampled a round, on the vectorized engine:
    trimmed-mean MMA under faults, the int8 wire with error feedback (the
    residuals ride in the store).  On the card the heads are 32 wide
    (kernel B's)."""
    slm, llm = SLM, LLM
    if device != "cpu":
        slm, llm = (dataclasses.replace(c, head_dim=32) for c in (SLM, LLM))
    cfg = FederatedConfig(
        n_devices=8, engine="vectorized", robust="trimmed_mean",
        trim_frac=0.25, channel=ChannelSpec(codec="int8"),
        faults=spec_lib.FaultSpec(dropout=0.2, straggler=0.2, seed=3),
        sampler=spec_lib.ParticipantSampler(per_cohort=4, seed=0),
        **SAMPLED)
    return FederatedRunner(cfg, build_model(slm), build_model(llm),
                           corpus(), mesh=mesh, device=device)


def on_host(tree):
    """Every tensor of a nested dict / list result on the CPU."""
    if isinstance(tree, dict):
        return {k: on_host(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(on_host(v) for v in tree)
    return tree.cpu() if isinstance(tree, torch.Tensor) else tree


def run_rounds(runner, ckpt=None, save_at=None, start=0):
    """Evaluated rounds ``start`` .. ``rounds - 1`` (a checkpoint written
    to ``ckpt`` at the boundary before round ``save_at``): each round's
    summary, then every client's LoRA leaves and the server SLM's and
    LLM's trainables (where this rank holds the server), and under a
    sampler the store's whole population."""
    try:
        summaries = []
        for r in range(start, runner.cfg.rounds):
            if r == save_at:
                runner.save_checkpoint(CheckpointManager(ckpt))
            summaries.append(runner.run_round()["summary"])
        runner.drain()
        leaves = {f"device{j}": lora.partition(p, lora.is_lora_leaf)
                  for j, p in enumerate(runner.device_params)}
        if runner.server_slm is not None:
            leaves["server_slm"] = lora.partition(runner.server_slm)
            leaves["server_llm"] = lora.partition(runner.server_llm)
        out = {"summaries": summaries, "leaves": leaves,
               "exchanged_bytes": runner.exchanged_bytes}
        if runner.store is not None:
            out["store"] = flatten_pytree(runner.store.state_pytree())
        return out
    finally:
        runner.close()


def resume(runner, ckpt):
    """``runner`` restored from ``ckpt``'s latest step, then its remaining
    rounds (:func:`run_rounds`)."""
    runner.load_checkpoint(CheckpointManager(ckpt))
    return run_rounds(runner, start=SAMPLED_SAVE_AT)


# ---------------------------------------------------------------------------
# the cases


def case_split(rank, world, out_dir):
    """N = 4 clients on the vectorized engine, split over the data ranks,
    with a checkpoint after round 0 (``<out_dir>/split``); a fresh runner
    on the mesh resumes from it and runs round 1 again."""
    from repro_torch.launch.mesh import make_federated_mesh
    mesh = make_federated_mesh(device_type="cpu")
    runner = legacy_runner("vectorized", 4, mesh)
    rt = runner.cohorts[0]
    ckpt = os.path.join(out_dir, "split")
    out = run_rounds(runner, ckpt, save_at=1)
    out["block"] = (rt.blk[0].start, rt.blk[0].stop)
    again = legacy_runner("vectorized", 4, mesh)
    again.load_checkpoint(CheckpointManager(ckpt))
    out["resumed"] = run_rounds(again, start=1)
    return out


def case_sampled(rank, world, out_dir):
    """The sampled federation (:func:`sampled_runner`) on the data ranks:
    3 rounds with a checkpoint after round 1 (``<out_dir>/sampled``),
    then fresh runners resume round 2 from it and from the world-1
    checkpoint the parent left in ``<out_dir>/sampled_w1``."""
    from repro_torch.launch.mesh import make_federated_mesh
    mesh = make_federated_mesh(device_type="cpu")
    runner = sampled_runner(mesh)
    rt = runner.cohorts[0]
    out = run_rounds(runner, os.path.join(out_dir, "sampled"),
                     save_at=SAMPLED_SAVE_AT)
    out["block"] = (rt.blk[0].start, rt.blk[0].stop)
    out["resumed"] = resume(sampled_runner(mesh),
                            os.path.join(out_dir, "sampled"))
    out["resumed_w1"] = resume(sampled_runner(mesh),
                               os.path.join(out_dir, "sampled_w1"))
    return out


def case_sampled_cuda(rank, world, out_dir):
    """The sampled federation's 3 rounds with every rank on cuda:0 (gloo
    takes CUDA tensors; NCCL no two ranks on one device), results on the
    host."""
    from repro_torch.launch.mesh import make_federated_mesh
    torch.cuda.set_device(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    runner = sampled_runner(make_federated_mesh(device_type="cuda"),
                            device="cuda")
    blk = runner.cohorts[0].blk[0]
    out = on_host(run_rounds(runner))
    out["block"] = (blk.start, blk.stop)
    return out


def case_replicated(rank, world, out_dir):
    """N = 3 clients, which the data ranks do not divide: replicated."""
    from repro_torch.launch.mesh import make_federated_mesh
    runner = legacy_runner("vectorized", 3,
                           make_federated_mesh(device_type="cpu"))
    out = run_rounds(runner)
    out["block"] = runner.cohorts[0].blk
    return out


def case_cohort_meshes(rank, world, out_dir):
    """The two-cohort overlap federation on per-cohort meshes (each cohort
    on its own rank at world 2) at staleness 0 and 1, the meshes' rank
    sets, and how many SE-CCL steps this rank ran (the server rank's
    only); at staleness 0 a checkpoint after round 0
    (``<out_dir>/overlap``, the server state broadcast from its rank)
    that a fresh runner on the meshes resumes."""
    from repro_torch.launch.mesh import make_cohort_meshes
    meshes = make_cohort_meshes(2, device_type="cpu")
    out = {"ranks": [m.mesh.flatten().tolist() for m in meshes]}
    ckpt = os.path.join(out_dir, "overlap")
    for s in (0, 1):
        runner = cohort_runner(meshes, staleness=s)
        calls = [0]
        step = runner.se_step

        def counted(*a, _step=step):
            calls[0] += 1
            return _step(*a)
        runner.se_step = counted
        out[s] = run_rounds(runner, ckpt, save_at=1 if s == 0 else None)
        out[s]["se_steps"] = calls[0]
    again = cohort_runner(meshes)
    again.load_checkpoint(CheckpointManager(ckpt))
    out[0]["resumed"] = run_rounds(again, start=1)
    return out


def case_mma(rank, world, out_dir):
    """``mma_psum_weights`` of this rank's modality counts over the data
    group, and the single-shard value."""
    from repro_torch.core.mma import mma_psum_weights
    from repro_torch.launch.mesh import make_federated_mesh
    mesh = make_federated_mesh(device_type="cpu")
    counts = torch.tensor([[3, 1, 2], [2, 2, 3]][rank % 2],
                          dtype=torch.int32)
    return {"w": mma_psum_weights(counts, mesh.get_group("data")),
            "single": mma_psum_weights(counts)}


def moe_inputs():
    gen = torch.Generator().manual_seed(0)
    from repro_torch.models.moe import init_moe
    p = init_moe(gen, MOE)
    x = torch.randn((4, 16, MOE.d_model), generator=gen)
    return p, x


def case_moe(rank, world, out_dir):
    """``moe_mlp_sharded`` on a (world // 2, 2) (data, model) mesh, and a
    moe trunk with ``moe_impl="sharded"`` through its ffn in the same
    context (logits)."""
    from repro_torch.launch.mesh import make_federated_mesh
    from repro_torch.models import moe
    from repro_torch.sharding.partition import sharding_context
    from repro_torch.sharding.rules import rules_for
    p, x = moe_inputs()
    mesh = make_federated_mesh(n_model=2, device_type="cpu")
    with torch.no_grad(), sharding_context(mesh, rules_for("train", False)):
        y, aux = moe.moe_mlp_sharded(p, MOE, x)
        bundle = build_model(dataclasses.replace(MOE, moe_impl="sharded"))
        params = bundle.init(torch.Generator().manual_seed(1))
        tokens = torch.randint(0, MOE.vocab_size, (2, 8),
                               generator=torch.Generator().manual_seed(2))
        logits, trunk_aux = bundle.logits(params, {"tokens": tokens})
    return {"y": y, "aux": aux, "shape": tuple(mesh.shape),
            "logits": logits, "trunk_aux": trunk_aux}


def moe_grad_inputs():
    """``moe_inputs`` with every leaf and x requiring a gradient, and a
    fixed projection of y for the loss."""
    p, x = moe_inputs()
    r = torch.randn(x.shape, generator=torch.Generator().manual_seed(5))
    return ({k: v.requires_grad_(True) for k, v in p.items()},
            x.requires_grad_(True), r)


def moe_loss(fn, p, x, r, cfg=MOE):
    """sum(y r) + 3 aux of ``fn(p, cfg, x)``, and the gradients of x and
    every weight."""
    y, aux = fn(p, cfg, x)
    loss = torch.sum(y * r) + 3.0 * aux
    leaves = {"x": x, **p}
    grads = torch.autograd.grad(loss, list(leaves.values()))
    return {"y": y.detach(), "aux": aux.detach(),
            **dict(zip(leaves, grads))}


TRAIN_MOE = dataclasses.replace(MOE, moe_impl="sharded", n_layers=1)


def capture_grads() -> Optimizer:
    """An optimizer that applies nothing and keeps the gradients as its
    state."""
    return Optimizer(
        init=lambda params: {},
        update=lambda g, state, params: (
            {k: torch.zeros_like(v) for k, v in params.items()},
            {k: v.detach() for k, v in g.items()}),
        update_stacked=None)


def moe_train_step():
    """One full fine-tune ``make_train_step`` of the toy sharded moe trunk
    on a seeded batch: (loss, {leaf: gradient})."""
    from repro_torch.launch.train import make_train_step
    bundle = build_model(TRAIN_MOE)
    params = bundle.init(torch.Generator().manual_seed(1))
    gen = torch.Generator().manual_seed(4)
    batch = {"tokens": torch.randint(0, MOE.vocab_size, (4, 12),
                                     generator=gen),
             "loss_mask": torch.ones((4, 12), dtype=torch.int32)}
    step = make_train_step(bundle, capture_grads(), full_finetune=True)
    _, grads, metrics = step(params, {}, batch)
    return metrics["loss"], grads


def case_moe_grads(rank, world, out_dir):
    """``moe_mlp_sharded``'s forward and gradients on each (data, model)
    mesh of this world ((1, 2) and (2, 1) at world 2, (2, 2) at world 4),
    and a full fine-tune step of the sharded moe trunk in a sharding
    context on the (world // 2, 2) mesh."""
    from repro_torch.launch.mesh import make_federated_mesh
    from repro_torch.sharding.partition import sharding_context
    from repro_torch.sharding.rules import rules_for
    rules = rules_for("train", False)
    out = {}
    for n_model in ((2, 1) if world == 2 else (2,)):
        mesh = make_federated_mesh(n_model=n_model, device_type="cpu")
        with sharding_context(mesh, rules):
            out[tuple(mesh.shape)] = moe_loss(moe.moe_mlp_sharded,
                                              *moe_grad_inputs())
            if n_model == 2:
                out["train_step"] = moe_train_step()
    return out


CASES = {f.__name__[5:]: f for f in (case_split, case_sampled,
                                     case_sampled_cuda, case_replicated,
                                     case_cohort_meshes, case_mma, case_moe,
                                     case_moe_grads)}


# ---------------------------------------------------------------------------
# the ranks


def worker(rank, world, store, out_dir, cases):
    """One gloo rank: the process group from the ``file://`` store, every
    case in order (each saved to ``<out_dir>/<case>-<rank>.pt``), then the
    group destroyed.  A failure is saved as its traceback."""
    import torch.distributed as dist
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{store}",
                            world_size=world, rank=rank)
    try:
        for name in cases:
            try:
                res = CASES[name](rank, world, out_dir)
            except Exception:  # noqa: BLE001 — reported by the parent
                res = {"error": traceback.format_exc()}
            torch.save(res, os.path.join(out_dir, f"{name}-{rank}.pt"))
            if "error" in res:
                break
    finally:
        dist.destroy_process_group()


def spawn(world, tmp_path, cases, timeout=120.0):
    """Run ``cases`` on ``world`` gloo ranks; {case: [rank results]}.
    Raises where a rank hangs past ``timeout`` seconds, exits non-zero or
    saved an error."""
    import torch.multiprocessing as mp
    ctx = mp.get_context("spawn")
    out_dir = str(tmp_path)
    procs = [ctx.Process(target=worker, args=(r, world,
                                              str(tmp_path / "store"),
                                              out_dir, tuple(cases)))
             for r in range(world)]
    for p in procs:
        p.start()
    for p in procs:
        p.join(timeout)
    hung = [r for r, p in enumerate(procs) if p.is_alive()]
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join()
    if hung:
        raise AssertionError(f"ranks {hung} hung past {timeout} s")
    results = {}
    for name in cases:
        results[name] = []
        for r in range(world):
            path = os.path.join(out_dir, f"{name}-{r}.pt")
            if not os.path.exists(path):
                raise AssertionError(f"rank {r} saved no {name!r} "
                                     f"(exit codes "
                                     f"{[p.exitcode for p in procs]})")
            res = torch.load(path, weights_only=False)
            if "error" in res:
                raise AssertionError(f"rank {r}, {name}:\n{res['error']}")
            results[name].append(res)
    bad = [p.exitcode for p in procs if p.exitcode != 0]
    if bad:
        raise AssertionError(f"rank exit codes {bad}")
    return results
