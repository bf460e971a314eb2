"""The port's distribution on ``torch.distributed``, on the CPU: the
stacked engines' rounds under a DeviceMesh, ``moe_mlp_sharded``'s expert
split, ``mma_psum_weights`` and the per-cohort meshes.

* at world size 1 (gloo, in process): the vectorized and overlap rounds
  with ``mesh=`` (one federated mesh, and the overlap engine's per-cohort
  list) bit-equal (``torch.equal``) to the same rounds without one, and
  the constructor's ``ValueError``s;
* at world size 2 (spawned gloo ranks, tests/_torch_dist_workers.py):
  N = 4 clients split 2 + 2, summaries and every LoRA leaf held to the
  world-1 run at ``atol=1e-5`` (the reference's
  ``_assert_summaries_match``), with a checkpoint after round 0 that a
  fresh runner on the mesh resumes bit for bit and a world-1 runner
  within 1e-5; a sampled federation (8 registered, 4 a round, split 2 +
  2; trimmed mean under faults, int8 with error feedback) over 3 rounds
  at 1e-5, every rank's store equal, its world-2 checkpoint resumed at
  world 2 (bit-equal) and at world 1, and the world-1 checkpoint resumed
  at world 2; N = 3, which the ranks do not divide, replicated and
  bit-equal; the two-cohort overlap federation on per-cohort meshes
  (one rank each) at staleness 0 and 1 at 1e-5, the server on rank 1
  only (rank 0 runs no SE-CCL step and holds no server), its staleness-0
  checkpoint resumed on the meshes and at world 1;
  ``mma_psum_weights`` across the ranks summing to 1;
  ``moe_mlp_sharded`` on (data, model) = (1, 2) and a moe trunk with
  ``moe_impl="sharded"`` against ``moe_mlp`` at capacity factor 8 (no
  drops; y and logits at 2e-4, aux at 1e-4, as
  tests/test_moe_sharded.py's 2 x 4 case); ``moe_mlp_sharded``'s
  gradients (x, the router, every expert weight) on (1, 2) and (2, 1)
  against ``moe_mlp``'s, row by row at 2e-4 of each row's largest
  |value|, and a full fine-tune ``make_train_step`` of a sharded moe
  trunk in a sharding context against world 1 (loss at 1e-5, gradients
  row by row);
* at world size 4: ``moe_mlp_sharded`` on (2, 2) as above, forward and
  gradients, the train step, N = 4 split 1 + 1 + 1 + 1 with its
  checkpoint, and the sampled federation split 1 + 1 + 1 + 1;
* ``cohort_rank_slices`` (the ranks of ``make_cohort_meshes``) against
  the reference's device sets, which one subprocess prints under
  ``--xla_force_host_platform_device_count=8``, for 1-10 cohorts x
  ``n_model`` 1, 2 and 4.
"""
import contextlib
import dataclasses
import json
import os
import shutil
import subprocess
import sys
import tempfile
import types

import numpy as np
import pytest
import torch
import torch.distributed as dist

import _torch_dist_workers as W
from repro_torch.checkpointing import CheckpointManager
from repro_torch.core.federated import FederatedConfig, FederatedRunner
from repro_torch.launch import mesh as mesh_lib
from repro_torch.models import moe
from repro_torch.models.model import build_model

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@contextlib.contextmanager
def single_rank():
    """A world-1 gloo process group from a ``file://`` store."""
    with tempfile.TemporaryDirectory() as d:
        dist.init_process_group("gloo", init_method=f"file://{d}/store",
                                world_size=1, rank=0)
        try:
            yield
        finally:
            dist.destroy_process_group()


@pytest.fixture(scope="module")
def references(tmp_path_factory):
    """The rounds without a mesh: N = 4 and N = 3 on the vectorized engine,
    the sampled federation (with its checkpoint after round 1), the
    two-cohort federation on the overlap engine at staleness 0 and 1; the
    moe gradients and train step at world 1."""
    ckpt = str(tmp_path_factory.mktemp("sampled_w1"))
    return {"split": W.run_rounds(W.legacy_runner("vectorized", 4)),
            "replicated": W.run_rounds(W.legacy_runner("vectorized", 3)),
            "sampled": W.run_rounds(W.sampled_runner(), ckpt,
                                    save_at=W.SAMPLED_SAVE_AT),
            "sampled_ckpt": ckpt,
            "cohort_meshes": {s: W.run_rounds(W.cohort_runner(staleness=s))
                              for s in (0, 1)},
            "moe_grads": W.moe_loss(moe.moe_mlp, *W.moe_grad_inputs()),
            "train_step": W.moe_train_step()}


def _close(g, v, atol, what):
    if atol == 0:
        assert torch.equal(g, v), what
    else:
        np.testing.assert_allclose(g.numpy(), v.numpy(), rtol=0, atol=atol,
                                   err_msg=what)


def assert_rounds_match(got, want, atol):
    """Summaries, every leaf and (under a sampler) every store entry
    within ``atol`` (0: ``torch.equal``); ``got``'s summaries are the last
    rounds of ``want``'s where it ran fewer (a resumed run)."""
    n = len(got["summaries"])
    assert 0 < n <= len(want["summaries"])
    for a, b in zip(got["summaries"], want["summaries"][-n:]):
        assert set(a) == set(b)
        for k in a:
            np.testing.assert_allclose(a[k], b[k], rtol=0, atol=atol,
                                       err_msg=f"summary key {k!r}")
    assert set(got["leaves"]) == set(want["leaves"])
    for n, leaves in want["leaves"].items():
        assert set(got["leaves"][n]) == set(leaves)
        for k, v in leaves.items():
            _close(got["leaves"][n][k], v, atol, f"{n}:{k}")
    assert ("store" in got) == ("store" in want)
    if "store" in want:
        assert set(got["store"]) == set(want["store"])
        for k, v in want["store"].items():
            _close(got["store"][k], v, atol, f"store {k}")


def without_server(want):
    """A round record without the server's leaves (a rank that holds no
    server)."""
    return dict(want, leaves={n: v for n, v in want["leaves"].items()
                              if not n.startswith("server")})


def resume_at_world1(make, ckpt, start):
    """A world-1 runner from ``make()`` restored from ``ckpt``, its rounds
    from ``start`` on."""
    runner = make()
    runner.load_checkpoint(CheckpointManager(ckpt))
    return W.run_rounds(runner, start=start)


def assert_rows_close(got, want, rel, what):
    """Row by row (the last axis) within ``rel`` of the row's largest
    |value| of ``want``."""
    g = got.reshape(-1, got.shape[-1]).double()
    w = want.reshape(-1, want.shape[-1]).double()
    tol = rel * w.abs().amax(dim=1, keepdim=True)
    bad = (g - w).abs() > tol
    assert not bool(bad.any()), (
        f"{what}: {int(bad.sum())} entries past {rel} of their row's "
        f"largest, e.g. {float((g - w).abs().max())}")


def check_moe_grads(results, references, shapes):
    """Each rank's ``moe_mlp_sharded`` forward and gradients on every mesh
    of ``shapes`` against ``moe_mlp``'s, and its train step's loss and
    gradients against world 1's."""
    want = references["moe_grads"]
    loss1, grads1 = references["train_step"]
    for got in results:
        for shape in shapes:
            g = got[shape]
            np.testing.assert_allclose(g["y"].numpy(), want["y"].numpy(),
                                       atol=2e-4)
            assert abs(float(g["aux"]) - float(want["aux"])) < 1e-4
            assert set(g) == set(want)
            for k in set(want) - {"y", "aux"}:
                assert_rows_close(g[k], want[k], 2e-4, f"{shape} d{k}")
        loss, grads = got["train_step"]
        assert abs(float(loss) - float(loss1)) <= 1e-5
        assert set(grads) == set(grads1)
        for k, v in grads1.items():
            assert_rows_close(grads[k], v, 2e-4, f"train step d{k}")


@pytest.mark.parametrize("case", ["vectorized", "overlap", "cohort_meshes"])
def test_world1_mesh_rounds_are_bit_equal(case, references):
    """At data size 1 the placement is a no-op and the gathers copies:
    every summary and leaf equals the run without a mesh, bit for bit."""
    with single_rank():
        if case == "cohort_meshes":
            got = W.run_rounds(W.cohort_runner(
                mesh_lib.make_cohort_meshes(2, device_type="cpu")))
            want = references["cohort_meshes"][0]
        else:
            mesh = mesh_lib.make_federated_mesh(device_type="cpu")
            got = W.run_rounds(W.legacy_runner(case, 4, mesh))
            want = (references["split"] if case == "vectorized" else
                    W.run_rounds(W.legacy_runner(case, 4)))
    assert got["exchanged_bytes"] > 0
    assert_rounds_match(got, want, atol=0)


def test_mesh_arguments_are_checked():
    cfg = FederatedConfig(n_devices=2, engine="vectorized", **W.ROUND)
    bundles = build_model(W.SLM), build_model(W.LLM)
    with single_rank():
        meshes = mesh_lib.make_cohort_meshes(2, device_type="cpu")
        with pytest.raises(ValueError, match="1 cohorts"):
            FederatedRunner(dataclasses.replace(cfg, engine="overlap"),
                            *bundles, W.corpus(), mesh=meshes, device="cpu")
        with pytest.raises(ValueError, match="engine='overlap'"):
            FederatedRunner(cfg, *bundles, W.corpus(), mesh=meshes[:1],
                            device="cpu")
    card = types.SimpleNamespace(device_type="cuda")
    with pytest.raises(ValueError, match="'cuda' mesh"):
        FederatedRunner(cfg, *bundles, W.corpus(), mesh=card, device="cpu")


def moe_reference():
    """``moe_mlp`` and the moe trunk's logits with ``moe_impl="scatter"``
    on the workers' inputs."""
    p, x = W.moe_inputs()
    y, aux = moe.moe_mlp(p, W.MOE, x)
    bundle = build_model(W.MOE)
    params = bundle.init(torch.Generator().manual_seed(1))
    tokens = torch.randint(0, W.MOE.vocab_size, (2, 8),
                           generator=torch.Generator().manual_seed(2))
    with torch.no_grad():
        logits, trunk_aux = bundle.logits(params, {"tokens": tokens})
    return y, aux, logits, trunk_aux


def check_moe(results, shape):
    y, aux, logits, trunk_aux = moe_reference()
    for got in results:
        assert got["shape"] == shape
        np.testing.assert_allclose(got["y"].numpy(), y.numpy(), atol=2e-4)
        assert abs(float(got["aux"]) - float(aux)) < 1e-4
        np.testing.assert_allclose(got["logits"].numpy(), logits.numpy(),
                                   atol=2e-4)
        assert abs(float(got["trunk_aux"]) - float(trunk_aux)) < 1e-4


def check_split(res, references, tmp_path, per):
    """N = 4 split ``per`` a rank: the rounds at 1e-5, the resumed round
    bit-equal on the mesh and within 1e-5 at world 1."""
    for rank, got in enumerate(res):
        assert got["block"] == (per * rank, per * rank + per)
        assert_rounds_match(got, references["split"], atol=1e-5)
        assert_rounds_match(got["resumed"], got, atol=0)
    w1 = resume_at_world1(lambda: W.legacy_runner("vectorized", 4),
                          str(tmp_path / "split"), 1)
    assert_rounds_match(w1, references["split"], atol=1e-5)


def check_sampled(res, references, tmp_path, per):
    """The sampled federation split ``per`` a rank: 3 rounds at 1e-5,
    equal stores on every rank, its checkpoint resumed on the mesh
    (bit-equal) and at world 1 (1e-5), the world-1 checkpoint resumed on
    the mesh (1e-5)."""
    want = references["sampled"]
    for rank, got in enumerate(res):
        assert got["block"] == (per * rank, per * rank + per)
        assert_rounds_match(got, want, atol=1e-5)
        assert_rounds_match(got, res[0], atol=0)
        assert_rounds_match(got["resumed"], got, atol=0)
        assert_rounds_match(got["resumed_w1"], want, atol=1e-5)
    w1 = resume_at_world1(W.sampled_runner, str(tmp_path / "sampled"),
                          W.SAMPLED_SAVE_AT)
    assert_rounds_match(w1, want, atol=1e-5)


def spawn_with_w1_checkpoint(world, tmp_path, references, cases):
    """:func:`W.spawn` with the world-1 sampled checkpoint in the ranks'
    directory."""
    shutil.copytree(references["sampled_ckpt"], tmp_path / "sampled_w1")
    return W.spawn(world, tmp_path, cases)


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory, references):
    """Every world-2 case from one spawn of two gloo ranks, and their
    directory."""
    d = tmp_path_factory.mktemp("two_ranks")
    return spawn_with_w1_checkpoint(
        2, d, references, ["split", "sampled", "replicated",
                           "cohort_meshes", "mma", "moe", "moe_grads"]), d


@pytest.fixture(scope="module")
def four_ranks(tmp_path_factory, references):
    """Every world-4 case from one spawn of four gloo ranks, and their
    directory."""
    d = tmp_path_factory.mktemp("four_ranks")
    return spawn_with_w1_checkpoint(
        4, d, references, ["moe", "moe_grads", "split", "sampled"]), d


def test_two_ranks(two_ranks, references):
    res, d = two_ranks
    check_split(res["split"], references, d, 2)
    for got in res["replicated"]:
        assert got["block"] == (slice(0, 3),) and got["exchanged_bytes"] == 0
        assert_rounds_match(got, references["replicated"], atol=0)
    w = [float(r["w"]) for r in res["mma"]]
    assert w == pytest.approx([6 / 13, 7 / 13], abs=1e-7)
    assert sum(w) == pytest.approx(1.0, abs=1e-6)
    assert [float(r["single"]) for r in res["mma"]] == [1.0, 1.0]
    check_moe(res["moe"], (1, 2))


def test_two_ranks_sampled_population(two_ranks, references):
    res, d = two_ranks
    check_sampled(res["sampled"], references, d, 2)


def test_two_ranks_overlap_server_rank(two_ranks, references):
    """Per-cohort meshes (one rank each) at staleness 0 and 1: the server
    lives on the last rank only, and the rounds match world 1; the
    staleness-0 checkpoint after round 0 resumes on the meshes bit for
    bit and at world 1 within 1e-5."""
    res, d = two_ranks
    for rank, got in enumerate(res["cohort_meshes"]):
        assert got["ranks"] == [[0], [1]]
        for s in (0, 1):
            want = references["cohort_meshes"][s]
            assert got[s]["se_steps"] == (0 if rank == 0 else 2)
            assert_rounds_match(got[s], want if rank == 1 else
                                without_server(want), atol=1e-5)
        assert_rounds_match(got[0]["resumed"], got[0], atol=0)
    w1 = resume_at_world1(W.cohort_runner, str(d / "overlap"), 1)
    assert_rounds_match(w1, references["cohort_meshes"][0], atol=1e-5)


def test_two_ranks_moe_gradients(two_ranks, references):
    check_moe_grads(two_ranks[0]["moe_grads"], references,
                    [(1, 2), (2, 1)])


def test_four_ranks(four_ranks, references):
    res, d = four_ranks
    check_moe(res["moe"], (2, 2))
    check_split(res["split"], references, d, 1)


def test_four_ranks_sampled_population(four_ranks, references):
    res, d = four_ranks
    check_sampled(res["sampled"], references, d, 1)


def test_four_ranks_moe_gradients(four_ranks, references):
    check_moe_grads(four_ranks[0]["moe_grads"], references, [(2, 2)])


_REF_COHORT_MESHES = r"""
import json, os
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import jax
from repro.launch.mesh import make_cohort_meshes
print(json.dumps({f"{c},{m}": [[[d.id for d in row] for row in mesh.devices]
                               for mesh in make_cohort_meshes(c, m)]
                  for c in range(1, 11) for m in (1, 2, 4)}))
"""


def test_cohort_rank_slices_match_reference():
    env = dict(os.environ, PYTHONPATH="src", JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    out = subprocess.run([sys.executable, "-c", _REF_COHORT_MESHES],
                         env=env, capture_output=True, text=True,
                         timeout=300, cwd=ROOT)
    assert out.returncode == 0, out.stderr
    ref = json.loads(out.stdout.strip().splitlines()[-1])
    ids = sorted({d for grid in ref["1,1"] for row in grid for d in row})
    assert ids == list(range(8))
    for key, want in ref.items():
        c, m = map(int, key.split(","))
        got = mesh_lib.cohort_rank_slices(8, c, m)
        assert [np.reshape(ranks, shape).tolist()
                for ranks, shape in got] == want, key
