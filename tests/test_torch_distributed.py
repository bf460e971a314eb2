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
  ``_assert_summaries_match``); N = 3, which the ranks do not divide,
  replicated and bit-equal; the two-cohort overlap federation on
  per-cohort meshes (one rank each) at 1e-5; ``mma_psum_weights`` across
  the ranks summing to 1; ``moe_mlp_sharded`` on (data, model) = (1, 2)
  and a moe trunk with ``moe_impl="sharded"`` against ``moe_mlp`` at
  capacity factor 8 (no drops; y and logits at 2e-4, aux at 1e-4, as
  tests/test_moe_sharded.py's 2 x 4 case); a sampler and a checkpoint
  refused on the split mesh;
* at world size 4: ``moe_mlp_sharded`` on (2, 2) as above, and N = 4
  split 1 + 1 + 1 + 1;
* ``cohort_rank_slices`` (the ranks of ``make_cohort_meshes``) against
  the reference's device sets, which one subprocess prints under
  ``--xla_force_host_platform_device_count=8``, for 1-10 cohorts x
  ``n_model`` 1, 2 and 4.
"""
import contextlib
import dataclasses
import json
import os
import subprocess
import sys
import tempfile
import types

import numpy as np
import pytest
import torch
import torch.distributed as dist

import _torch_dist_workers as W
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
def references():
    """The rounds without a mesh: N = 4 and N = 3 on the vectorized engine,
    the two-cohort federation on the overlap engine."""
    return {"split": W.run_rounds(W.legacy_runner("vectorized", 4)),
            "replicated": W.run_rounds(W.legacy_runner("vectorized", 3)),
            "cohort_meshes": W.run_rounds(W.cohort_runner())}


def assert_rounds_match(got, want, atol):
    """Summaries and every leaf within ``atol`` (0: ``torch.equal``)."""
    assert len(got["summaries"]) == len(want["summaries"])
    for a, b in zip(got["summaries"], want["summaries"]):
        assert set(a) == set(b)
        for k in a:
            np.testing.assert_allclose(a[k], b[k], rtol=0, atol=atol,
                                       err_msg=f"summary key {k!r}")
    assert set(got["leaves"]) == set(want["leaves"])
    for n, leaves in want["leaves"].items():
        assert set(got["leaves"][n]) == set(leaves)
        for k, v in leaves.items():
            g = got["leaves"][n][k]
            if atol == 0:
                assert torch.equal(g, v), f"{n}:{k}"
            else:
                np.testing.assert_allclose(g.numpy(), v.numpy(), rtol=0,
                                           atol=atol, err_msg=f"{n}:{k}")


@pytest.mark.parametrize("case", ["vectorized", "overlap", "cohort_meshes"])
def test_world1_mesh_rounds_are_bit_equal(case, references):
    """At data size 1 the placement is a no-op and the gathers copies:
    every summary and leaf equals the run without a mesh, bit for bit."""
    with single_rank():
        if case == "cohort_meshes":
            got = W.run_rounds(W.cohort_runner(
                mesh_lib.make_cohort_meshes(2, device_type="cpu")))
            want = references["cohort_meshes"]
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


def test_two_ranks(tmp_path, references):
    res = W.spawn(2, tmp_path, ["split", "replicated", "cohort_meshes",
                                "mma", "moe"])
    for rank, got in enumerate(res["split"]):
        assert got["block"] == (2 * rank, 2 * rank + 2)
        assert got["refused"] == ["sampler", "checkpoint"]
        assert_rounds_match(got, references["split"], atol=1e-5)
    for got in res["replicated"]:
        assert got["block"] == (slice(0, 3),) and got["exchanged_bytes"] == 0
        assert_rounds_match(got, references["replicated"], atol=0)
    for got in res["cohort_meshes"]:
        assert got["ranks"] == [[0], [1]]
        assert_rounds_match(got, references["cohort_meshes"], atol=1e-5)
    w = [float(r["w"]) for r in res["mma"]]
    assert w == pytest.approx([6 / 13, 7 / 13], abs=1e-7)
    assert sum(w) == pytest.approx(1.0, abs=1e-6)
    assert [float(r["single"]) for r in res["mma"]] == [1.0, 1.0]
    check_moe(res["moe"], (1, 2))


def test_four_ranks(tmp_path, references):
    res = W.spawn(4, tmp_path, ["moe", "split"])
    check_moe(res["moe"], (2, 2))
    for rank, got in enumerate(res["split"]):
        assert got["block"] == (rank, rank + 1)
        assert_rounds_match(got, references["split"], atol=1e-5)


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
