"""Multi-rank cases of tests/test_torch_distributed.py: gloo ranks on the
CPU, one process each, started with ``torch.multiprocessing``'s spawn
method from a ``file://`` store.  This module imports neither ``jax`` nor
``repro`` (a spawned rank imports it afresh), and every rank runs with
one thread.

:func:`spawn` starts ``world`` ranks of :func:`worker`, joins them with a
timeout (a hung rank fails the test) and returns what each rank saved.
Each case is a function ``case(rank, world) -> result`` (tensors and
plain values, saved with ``torch.save``).
"""
from __future__ import annotations

import dataclasses
import os
import traceback

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core import lora, spec as spec_lib
from repro_torch.core.federated import FederatedConfig, FederatedRunner
from repro_torch.data.synthetic import synthetic_multimodal_corpus
from repro_torch.models.model import build_model

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


def cohort_runner(mesh=None):
    """Two cohorts (2 clients on modalities 0-1, 2 of another architecture
    on modality 2) on the overlap engine at staleness 0."""
    fspec = spec_lib.FederationSpec(
        cohorts=(spec_lib.ClientCohort(model=SLM, n_clients=2, name="A",
                                       modalities=(0, 1)),
                 spec_lib.ClientCohort(model=SLM_B, n_clients=2, name="B",
                                       modalities=(2,), rho=0.9)),
        server_llm=LLM, engine="overlap", staleness=0,
        **{k: v for k, v in ROUND.items()})
    return FederatedRunner(fspec, corpus(), mesh=mesh, device="cpu")


def run_rounds(runner):
    """Every evaluated round's summary, then every client's LoRA leaves and
    the server SLM's and LLM's trainables."""
    try:
        summaries = [runner.run_round()["summary"]
                     for _ in range(runner.cfg.rounds)]
        runner.drain()
        leaves = {f"device{j}": lora.partition(p, lora.is_lora_leaf)
                  for j, p in enumerate(runner.device_params)}
        leaves["server_slm"] = lora.partition(runner.server_slm)
        leaves["server_llm"] = lora.partition(runner.server_llm)
        return {"summaries": summaries, "leaves": leaves,
                "exchanged_bytes": runner.exchanged_bytes}
    finally:
        runner.close()


# ---------------------------------------------------------------------------
# the cases


def case_split(rank, world):
    """N = 4 clients on the vectorized engine, split over the data ranks;
    a checkpoint and a sampler on that mesh are refused (with a sampler
    of 2 a round, the working set is split 1 + 1 at world 2)."""
    from repro_torch.launch.mesh import make_federated_mesh
    mesh = make_federated_mesh(device_type="cpu")
    runner = legacy_runner("vectorized", 4, mesh)
    rt = runner.cohorts[0]
    refused = []
    try:
        runner.checkpoint_state()
    except NotImplementedError:
        refused.append("checkpoint")
    out = run_rounds(runner)
    out["block"] = (rt.blk[0].start, rt.blk[0].stop)
    cfg = FederatedConfig(n_devices=4, engine="vectorized", sampler=(
        spec_lib.ParticipantSampler(per_cohort=2, seed=0)), **ROUND)
    try:
        FederatedRunner(cfg, build_model(SLM), build_model(LLM), corpus(),
                        mesh=mesh, device="cpu")
    except NotImplementedError:
        refused.insert(0, "sampler")
    out["refused"] = refused
    return out


def case_replicated(rank, world):
    """N = 3 clients, which the data ranks do not divide: replicated."""
    from repro_torch.launch.mesh import make_federated_mesh
    runner = legacy_runner("vectorized", 3,
                           make_federated_mesh(device_type="cpu"))
    out = run_rounds(runner)
    out["block"] = runner.cohorts[0].blk
    return out


def case_cohort_meshes(rank, world):
    """The two-cohort overlap federation on per-cohort meshes (each cohort
    on its own rank at world 2), and the meshes' rank sets."""
    from repro_torch.launch.mesh import make_cohort_meshes
    meshes = make_cohort_meshes(2, device_type="cpu")
    out = run_rounds(cohort_runner(meshes))
    out["ranks"] = [m.mesh.flatten().tolist() for m in meshes]
    return out


def case_mma(rank, world):
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


def case_moe(rank, world):
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


CASES = {f.__name__[5:]: f for f in (case_split, case_replicated,
                                     case_cohort_meshes, case_mma,
                                     case_moe)}


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
                res = CASES[name](rank, world)
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
