"""The port's dry run (``repro_torch.launch.{specs,dryrun}``,
``configs.INPUT_SHAPES``, ``launch.mesh.fake_world``) against the JAX
package's, in process on the CPU.

Against the reference, exactly: the input shapes; ``variant_for_shape``
(as ``asdict``) and ``model_flops`` for every arch x shape; the train
batch's shapes and dtypes; ``train_batch_pspecs`` and ``cache_pspecs``
(every arch's cache at decode_32k and long_500k, on a 16 x 16 and a
2 x 16 x 16 stand-in mesh) as tuples; ``model_structs`` leaf by leaf at
full size; ``collective_bytes`` on the records of the reference parser's
synthetic HLO, scan trips included.

The dry run itself, each test that starts a fake process group ending it:
one rank's FLOP and collectives of a column- then row-parallel MLP at
(16, 16); ``dryrun_one`` on one registry config per family at one layer
(train_4k and decode_32k); ``main`` writing one JSON a combination under
the reference's file names.
"""
import ast
import dataclasses
import importlib
import json
import math
import os

import jax
import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro.configs.base import INPUT_SHAPES as J_SHAPES
from repro.configs.base import get_config as jget_config
from repro.launch import specs as jspecs
from repro.models.model import build_model as jbuild
from repro.sharding import rules as jrules
from repro_torch.configs import ARCH_IDS, INPUT_SHAPES, InputShape, get_config
from repro_torch.launch import dryrun as D
from repro_torch.launch import specs as S
from repro_torch.launch.mesh import (PEAK_FLOPS_BF16, fake_world,
                                     make_host_mesh, make_production_mesh)
from repro_torch.models.model import build_model
from repro_torch.sharding import rules

torch.set_num_threads(1)

MESHES = [(("data", "model"), (16, 16), False),
          (("pod", "data", "model"), (2, 16, 16), True)]


@pytest.fixture(scope="module")
def ref():
    """The reference's dry-run module, imported without letting it set
    XLA_FLAGS for this process (as tests/test_dryrun_parser.py)."""
    saved = os.environ.get("XLA_FLAGS")
    mod = importlib.import_module("repro.launch.dryrun")
    if saved is None:
        os.environ.pop("XLA_FLAGS", None)
    else:
        os.environ["XLA_FLAGS"] = saved
    return mod


class FakeMesh:
    """The reference's abstract mesh (axis names, a devices array)."""

    def __init__(self, names, shape):
        self.axis_names = names
        self.devices = np.empty(shape)


@pytest.fixture
def fake_256():
    """A fake 256-rank default process group, ended after the test."""
    fake_world(256)
    try:
        yield
    finally:
        dist.destroy_process_group()


def _dt(dtype) -> str:
    return str(dtype).replace("torch.", "")


# ---------------------------------------------------------------------------
# against the reference

def test_input_shapes_match_reference():
    assert {k: dataclasses.asdict(v) for k, v in INPUT_SHAPES.items()} == \
        {k: dataclasses.asdict(v) for k, v in J_SHAPES.items()}
    assert isinstance(INPUT_SHAPES["train_4k"], InputShape)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_variant_for_shape_matches_reference(arch):
    for name in INPUT_SHAPES:
        got = S.variant_for_shape(get_config(arch), INPUT_SHAPES[name])
        want = jspecs.variant_for_shape(jget_config(arch), J_SHAPES[name])
        assert dataclasses.asdict(got) == dataclasses.asdict(want), name


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_model_flops_match_reference(arch, ref):
    for name in INPUT_SHAPES:
        got = D.model_flops(S.variant_for_shape(get_config(arch),
                                                INPUT_SHAPES[name]),
                            INPUT_SHAPES[name])
        want = ref.model_flops(jspecs.variant_for_shape(
            jget_config(arch), J_SHAPES[name]), J_SHAPES[name])
        assert got == want, name


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_train_batch_structs_and_pspecs_match_reference(arch):
    cfg, jcfg = get_config(arch), jget_config(arch)
    for name in ("train_4k", "prefill_32k"):
        got = S.train_batch_structs(cfg, INPUT_SHAPES[name])
        want = jspecs.train_batch_structs(jcfg, J_SHAPES[name])
        assert {k: (tuple(v.shape), _dt(v.dtype)) for k, v in got.items()} \
            == {k: (tuple(v.shape), str(v.dtype)) for k, v in want.items()}
        assert all(v.device.type == "meta" for v in got.values())
    for mp in (False, True):
        got = S.train_batch_pspecs(cfg, rules.rules_for("train", mp))
        want = jspecs.train_batch_pspecs(jcfg, jrules.rules_for("train", mp))
        assert {k: tuple(v) for k, v in got.items()} == \
            {k: tuple(v) for k, v in want.items()}
    dec = S.decode_batch_structs(cfg, INPUT_SHAPES["decode_32k"])
    jdec = jspecs.decode_batch_structs(jcfg, J_SHAPES["decode_32k"])
    assert (tuple(dec["tokens"].shape), _dt(dec["tokens"].dtype)) == \
        (tuple(jdec["tokens"].shape), str(jdec["tokens"].dtype))
    assert dec["pos"] == 32767 and jdec["pos"].shape == ()


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_cache_pspecs_match_reference(arch):
    """Every cache leaf's shape (the port's on the meta device, the
    reference's from ``jax.eval_shape``) and spec, at decode_32k and
    long_500k on both production meshes."""
    for name in ("decode_32k", "long_500k"):
        shape = INPUT_SHAPES[name]
        cfg = S.variant_for_shape(get_config(arch), shape)
        jcfg = jspecs.variant_for_shape(jget_config(arch), J_SHAPES[name])
        cache = build_model(cfg).init_cache(shape.global_batch,
                                            shape.seq_len, "meta")
        jb = jbuild(jcfg)
        jcache = jax.eval_shape(lambda: jb.init_cache(shape.global_batch,
                                                      shape.seq_len))
        assert {k: tuple(v.shape) for k, v in cache.items()} == \
            {k: tuple(v.shape) for k, v in jcache.items()}
        for names, mshape, mp in MESHES:
            got = S.cache_pspecs(cfg, cache, (names, mshape), mp)
            want = jspecs.cache_pspecs(jcfg, jcache,
                                       FakeMesh(names, mshape), mp)
            assert {k: tuple(v) for k, v in got.items()} == \
                {k: tuple(v) for k, v in want.items()}, (name, mshape)


def _flat(tree, prefix=()):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, (*prefix, k)))
        else:
            out["/".join((*prefix, k))] = (tuple(v.shape), _dt(v.dtype))
    return out


@pytest.fixture(scope="module")
def ref_structs():
    """The reference's ``model_structs`` of each arch at full size, built
    once per arch (flattened: path -> (shape, dtype))."""
    cache = {}

    def get(arch):
        if arch not in cache:
            st = jspecs.model_structs(jbuild(jget_config(arch)))
            flat = jax.tree_util.tree_flatten_with_path(st)[0]
            cache[arch] = {"/".join(str(k.key) for k in path):
                           (tuple(leaf.shape), str(leaf.dtype))
                           for path, leaf in flat}
        return cache[arch]
    return get


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_model_structs_match_reference(arch, ref_structs):
    from torch._subclasses.fake_tensor import FakeTensor
    st = S.model_structs(build_model(get_config(arch)))
    assert all(isinstance(v, FakeTensor) for v in
               torch.utils._pytree.tree_leaves(st))
    assert _flat(st) == ref_structs(arch)


# the reference parser's synthetic HLO (tests/test_dryrun_parser.py): an
# all-gather over 16 and an all-reduce over 4 in the entry computation, an
# all-reduce over 16 in a loop body
HLO = """
ENTRY %main (p0: bf16[128,512]) -> bf16[2048,512] {
  %ag = bf16[2048,512]{1,0} all-gather(bf16[128,512] %p0), replica_groups=[16,16]<=[256], dimensions={0}
  %ar = f32[64,64]{1,0} all-reduce(f32[64,64] %x), replica_groups={{0,1,2,3}}, to_apply=%sum
  ROOT %t = bf16[2048,512] tuple()
}

%body.1 (arg: f32[8]) -> f32[8] {
  %ar2 = f32[1024]{0} all-reduce(f32[1024] %y), replica_groups=[1,16]<=[16], to_apply=%sum
}
"""
RECORDS = [D.Collective("all-gather", 2048 * 512 * 2, 16),
           D.Collective("all-reduce", 64 * 64 * 4, 4),
           D.Collective("all-reduce", 1024 * 4, 16, in_body=True)]


@pytest.mark.parametrize("trips", [1, 10])
def test_collective_bytes_match_reference_parser(ref, trips):
    got = D.collective_bytes(RECORDS, scan_trips=trips)
    want = ref.collective_bytes(HLO, scan_trips=trips)
    assert got == want
    one = D.collective_bytes([D.Collective("all-gather", 128, 1)])
    assert one == ref.collective_bytes(
        "%ag = bf16[8,8] all-gather(bf16[8,8] %p), "
        "replica_groups=[256,1]<=[256]\n") == \
        {"total_bytes": 0.0, "per_op": {}}


# ---------------------------------------------------------------------------
# the dry run

def test_fake_world_refuses_a_second_group(fake_256):
    assert dist.get_world_size() == 256 and dist.get_backend() == "fake"
    with pytest.raises(RuntimeError, match="already exists"):
        fake_world(4)


def test_rank_cost_counts_one_ranks_share(fake_256):
    """x (4096, 4096) split over "data" by rows, W1 column- and W2
    row-parallel over "model": the whole product is 2^38 FLOP, a rank's
    local matmuls 2^30 (1/256); the partial sums reduce over the 16 ranks
    of a "model" group in one all-reduce of the rank's (256, 4096) bf16
    block."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.tensor import DTensor, Replicate, Shard
    from torch.utils.flop_counter import FlopCounterMode
    mesh = make_production_mesh(device_type="cpu")
    n = 4096

    def dt(local, placements):
        return DTensor.from_local(local, mesh, placements, run_check=False,
                                  shape=(n, n), stride=(n, 1))
    bf = torch.bfloat16
    with FakeTensorMode(allow_non_fake_inputs=True):
        x = dt(torch.empty(n // 16, n, dtype=bf), [Shard(0), Replicate()])
        w1 = dt(torch.empty(n, n // 16, dtype=bf), [Replicate(), Shard(1)])
        w2 = dt(torch.empty(n // 16, n, dtype=bf), [Replicate(), Shard(0)])
        cost = D.RankCost()
        with D.counting(cost):
            y = ((x @ w1) @ w2).redistribute(mesh, [Shard(0), Replicate()])
        with FlopCounterMode(display=False) as glob:
            (x @ w1) @ w2
    assert glob.get_total_flops() == 274_877_906_944
    assert cost.flops == 274_877_906_944 // 256
    assert cost.collectives == [D.Collective("all-reduce", 256 * n * 2, 16)]
    assert y.to_local().shape == (256, n) and not cost.replicated
    coll = D.collective_bytes(cost.collectives)
    assert coll["total_bytes"] == 2.0 * 256 * n * 2 * 15 / 16


def _reference_keys():
    """The keys of the reference's result dict and of its roofline terms,
    read from its source."""
    src = open(importlib.util.find_spec("repro.launch.dryrun").origin).read()
    keys = {}
    for node in ast.walk(ast.parse(src)):
        if isinstance(node, ast.Assign) and isinstance(node.value, ast.Dict) \
                and isinstance(node.targets[0], ast.Name) \
                and node.targets[0].id in ("res", "terms"):
            keys[node.targets[0].id] = {k.value for k in node.value.keys
                                        if isinstance(k, ast.Constant)}
    return keys["res"], keys["terms"] | {"dominant"}


FAMILIES = {"dense": "qwen3-1.7b", "moe": "phi3.5-moe-42b-a6.6b",
            "ssm": "mamba2-2.7b", "hybrid": "hymba-1.5b",
            "encdec": "whisper-medium", "vlm": "internvl2-1b"}


@pytest.mark.parametrize("shape", ["train_4k", "decode_32k"])
@pytest.mark.parametrize("family", list(FAMILIES))
def test_dryrun_one_per_family(family, shape, ref):
    arch = FAMILIES[family]
    assert get_config(arch).family == family
    cut = ["n_layers=1"] + (["n_enc_layers=1"] if family == "encdec" else [])
    res = D.dryrun_one(arch, shape, overrides=cut)
    assert not dist.is_initialized()
    res_keys, term_keys = _reference_keys()
    assert res_keys <= set(res) and set(res["roofline"]) == term_keys
    assert res["path"] == D.PATH and res["mesh"] == "16x16"
    assert res["chips"] == 256 and res["kind"] == INPUT_SHAPES[shape].kind
    terms = {k: v for k, v in res["roofline"].items() if k != "dominant"}
    assert all(math.isfinite(v) and v >= 0 for v in terms.values())
    assert res["roofline"]["dominant"] in terms
    assert res["roofline"]["compute_s_analytic"] == \
        res["model_flops_total"] / 256 / PEAK_FLOPS_BF16
    mem = res["memory_analysis"]
    assert mem["argument_size_in_bytes"] > 0 and mem["temp_size_in_bytes"] \
        >= 0 and res["cost_analysis"]["flops"] > 0
    cfg = D._apply_overrides(S.variant_for_shape(
        get_config(arch), INPUT_SHAPES[shape]), cut)
    assert res["model_flops_total"] == D.model_flops(cfg,
                                                     INPUT_SHAPES[shape])


def test_main_writes_one_file_a_combination(tmp_path):
    base = ["--arch", "mamba2-2.7b", "--shape", "decode_32k", "--set",
            "n_layers=1", "--out-dir", str(tmp_path)]
    D.main(base)
    D.main(base + ["--full-finetune", "--tag", "t"])
    names = sorted(os.listdir(tmp_path))
    assert names == ["mamba2-2.7b__decode_32k.json",
                     "mamba2-2.7b__decode_32k__fft__t.json"]
    res = json.loads((tmp_path / names[1]).read_text())
    assert res["mesh"] == "16x16" and res["chips"] == 256 and \
        res["mode"] == "full_ft__t"
    D.main(base + ["--skip-existing"])       # nothing new
    assert len(os.listdir(tmp_path)) == 2
    assert not dist.is_initialized()


def test_dryrun_one_on_a_given_mesh_and_shape():
    """The caller's (1, 1) mesh over its own fake group and an
    ``InputShape`` of its own; the argument bytes are the params', the
    optimizer state's and the batch's, each leaf once."""
    fake_world(1)
    try:
        mesh = make_host_mesh(device_type="cpu")
        shape = InputShape("t", 64, 2, "train")
        res = D.dryrun_one("qwen3-1.7b", "t", shape=shape, mesh=mesh,
                           overrides=["n_layers=1"])
    finally:
        dist.destroy_process_group()
    cfg = D._apply_overrides(get_config("qwen3-1.7b"), ["n_layers=1"])
    st = S.model_structs(build_model(cfg))
    from repro_torch.core import lora
    leaves = torch.utils._pytree.tree_leaves(st)
    n_train = sum(v.numel() for v in lora.partition(st).values())
    batch = S.train_batch_structs(cfg, shape)
    want = (sum(v.numel() * v.element_size() for v in leaves)
            + 2 * 4 * n_train + 4
            + sum(v.numel() * v.element_size() for v in batch.values()))
    assert res["memory_analysis"]["argument_size_in_bytes"] == want
    assert res["chips"] == 1 and res["shape"] == "t"


def test_run_replicated_gathers_writes_back_and_wraps(fake_256):
    """An op DTensor fails on runs on whole tensors: an in-place op writes
    its result back into the input's own block (placement kept, the same
    DTensor returned), a new output comes back replicated; the gathers
    are counted."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.tensor import DTensor, Replicate, Shard
    mesh = make_production_mesh(device_type="cpu")
    with FakeTensorMode(allow_non_fake_inputs=True):
        x = DTensor.from_local(torch.empty(4, 8), mesh,
                               [Shard(0), Replicate()], run_check=False,
                               shape=(64, 8), stride=(8, 1))
        y = DTensor.from_local(torch.empty(64, 8), mesh,
                               [Replicate(), Replicate()], run_check=False)
        cost = D.RankCost()
        with D.counting(cost):
            got = D._run_replicated(torch.ops.aten.add_.Tensor, (x, y), {})
            rolled = D._run_replicated(torch.ops.aten.roll.default,
                                       (x, [1], [0]), {})
            # a split on an inner dim comes back in the global layout, so
            # a view of it holds
            z = DTensor.from_local(torch.empty(16, 2), mesh,
                                   [Replicate(), Shard(1)], run_check=False,
                                   shape=(16, 32), stride=(32, 1))
            flat = D._run_replicated(torch.ops.aten.view.default,
                                     (z, [512]), {})
            # 14 rows over 16 ranks: rank 0's block of 1, gathered to 16
            # and cut to 14
            u = DTensor.from_local(torch.empty(1, 4), mesh,
                                   [Replicate(), Shard(0)], run_check=False,
                                   shape=(14, 4), stride=(4, 1))
            uneven = D._run_replicated(torch.ops.aten.view.default,
                                       (u, [56]), {})
    assert got is x and x.placements == (Shard(0), Replicate())
    assert x.to_local().shape == (4, 8)
    assert rolled.placements == (Replicate(), Replicate())
    assert rolled.to_local().shape == (64, 8)
    assert flat.shape == (512,) and flat.to_local().shape == (512,)
    assert uneven.to_local().shape == (56,)
    assert cost.collectives == [D.Collective("all-gather", 64 * 8 * 4, 16)] \
        * 2 + [D.Collective("all-gather", 16 * 32 * 4, 16),
               D.Collective("all-gather", 16 * 4 * 4, 16)]
