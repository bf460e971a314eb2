"""The port's sharding layer (``repro_torch.sharding``) against the JAX
package's, in process on the CPU.

* ``rules_for`` for every kind and ``multi_pod``, mapping by mapping;
* ``_sanitize_spec`` on generated specs, shapes and abstract meshes
  (1 x 1, 2 x 4, 16 x 16, 2 x 16 x 16): the port reads a ``(names,
  shape)`` pair, the reference a mesh stand-in, equal specs;
* ``kv_cache_axes`` over a grid of batch, cache length, KV heads and mesh;
* ``logical_axes_for`` / ``param_pspecs`` for every registry config, on
  the real leaves of ``reduced()`` and at full size from shapes alone
  (``jax.eval_shape`` against an init on the meta device), with and
  without a 16 x 16 mesh;
* ``constrain`` / ``constrain_kv_cache``: the identity, and the
  reference's ``ValueError`` on a rank mismatch inside a context;
* ``moe_mlp_sharded`` in a 1 x 1 gloo context against the reference's in
  a 1 x 1 ``sharding_context`` (f32; aux at 1e-5 and y at 1e-5 relative,
  as tests/test_moe_sharded.py), bit-equal to the port's ``moe_mlp``, and
  ``mma_psum_weights`` against the reference's at ``axis_names=()``;
* ``tree_shardings`` on a world-1 mesh, and the per-cohort rank slices.
"""
import contextlib
import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
from jax.sharding import PartitionSpec as P

from repro.configs.base import ModelConfig as JConfig
from repro.configs.base import get_config as jget_config
from repro.core import mma as jmma
from repro.models import moe as jmoe
from repro.models.model import build_model as jbuild
from repro.sharding import partition as jpart
from repro.sharding import rules as jrules
from repro_torch.configs.base import ARCH_IDS, ModelConfig, get_config
from repro_torch.core import mma
from repro_torch.launch import mesh as mesh_lib
from repro_torch.models import moe
from repro_torch.models.model import build_model
from repro_torch.sharding import partition as part
from repro_torch.sharding import rules
from repro_torch.sharding.rules import Spec

torch.set_num_threads(1)

MESHES = [(("data", "model"), (1, 1)), (("data", "model"), (2, 4)),
          (("data", "model"), (16, 16)),
          (("pod", "data", "model"), (2, 16, 16))]


class FakeMesh:
    """The reference's abstract mesh (axis names, a devices array)."""

    def __init__(self, names, shape):
        self.axis_names = names
        self.devices = np.empty(shape)


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


@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
@pytest.mark.parametrize("multi_pod", [False, True])
def test_rules_match_reference(kind, multi_pod):
    got, want = rules.rules_for(kind, multi_pod), jrules.rules_for(
        kind, multi_pod)
    assert got.name == want.name
    assert got.mapping == want.mapping
    for logical in [None, *want.mapping, "unknown"]:
        assert got.axis(logical) == want.axis(logical)
    assert tuple(got.spec("batch", None, "heads")) == \
        tuple(want.spec("batch", None, "heads"))
    with pytest.raises(ValueError):
        rules.rules_for("serve", multi_pod)
    assert rules.TRAIN_RULES == rules.rules_for("train", False)
    assert rules.DECODE_RULES.mapping == jrules.DECODE_RULES.mapping


def test_spec_is_an_immutable_tuple():
    s = Spec("model", None, ("pod", "data"))
    assert s == ("model", None, ("pod", "data")) and len(s) == 3
    assert isinstance(s, tuple) and hash(s) == hash(tuple(s))
    assert repr(Spec(None)) == "Spec(None,)"


@pytest.mark.parametrize("names,shape", MESHES,
                         ids=lambda v: "x".join(map(str, v)))
def test_sanitize_spec_matches_reference(names, shape):
    rng = np.random.RandomState(sum(shape))
    entries = [None, "data", "model", "pod", ("data", "model"),
               ("pod", "data"), ("model", "data"), ("data", "data"),
               ("pod", "data", "model")]
    dims = [1, 2, 3, 4, 6, 8, 12, 16, 32, 48, 64, 256, 512, 6482]
    fake = FakeMesh(names, shape)
    for _ in range(300):
        nd = rng.randint(1, 5)
        dshape = tuple(int(rng.choice(dims)) for _ in range(nd))
        spec = [entries[i] for i in rng.randint(0, len(entries),
                                                rng.randint(0, nd + 1))]
        got = part._sanitize_spec(Spec(*spec), dshape, (names, shape))
        want = jpart._sanitize_spec(P(*spec), dshape, fake)
        assert tuple(got) == tuple(want), (spec, dshape)


@pytest.mark.parametrize("names,shape", MESHES,
                         ids=lambda v: "x".join(map(str, v)))
def test_kv_cache_axes_match_reference(names, shape):
    sizes = dict(zip(names, shape))
    for B in (1, 2, 3, 8, 16, 32, 128):
        for Sc in (1, 16, 100, 512, 32768, 524288):
            for K in (1, 2, 4, 8, 16):
                for mp in (False, True):
                    assert part.kv_cache_axes(B, Sc, K, sizes, mp) == \
                        jpart.kv_cache_axes(B, Sc, K, sizes, mp), \
                        (B, Sc, K, mp)


def _ref_specs(structs, mesh=None):
    specs = jpart.param_pspecs(structs, jrules.rules_for("train", False),
                               mesh)
    flat, _ = jax.tree_util.tree_flatten_with_path(
        specs, is_leaf=lambda x: isinstance(x, P))
    return {"/".join(str(k.key) for k in path): tuple(s)
            for path, s in flat}


def _port_specs(params, mesh=None):
    out = {}

    def visit(tree, prefix):
        for k, v in tree.items():
            if isinstance(v, dict):
                visit(v, (*prefix, k))
            else:
                out["/".join((*prefix, k))] = tuple(v)
    visit(part.param_pspecs(params, rules.rules_for("train", False), mesh),
          ())
    return out


class _MetaGen:
    """A stand-in generator whose draws land on the meta device."""
    device = torch.device("meta")


@pytest.fixture
def meta_init(monkeypatch):
    """``build_model(cfg).init`` on the meta device: shapes and dtypes,
    no memory (``torch.randn`` drops the stand-in generator)."""
    randn = torch.randn

    def meta_randn(*args, generator=None, **kw):
        return randn(*args, **kw)
    monkeypatch.setattr(torch, "randn", meta_randn)
    return lambda cfg: build_model(cfg).init(_MetaGen())


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_pspecs_match_reference(arch, meta_init):
    """Every leaf's logical axes and spec, on the real leaves of the
    reduced config and at full size from shapes, bare and sanitized
    against a 16 x 16 mesh."""
    jcfg, cfg = jget_config(arch), get_config(arch)
    for jc, c, real in ((jcfg.reduced(), cfg.reduced(), True),
                        (jcfg, cfg, False)):
        structs = jax.eval_shape(lambda: jbuild(jc).init(jax.random.key(0)))
        params = (build_model(c).init(torch.Generator().manual_seed(0))
                  if real else meta_init(c))
        for mesh, jmesh in ((None, None),
                            ((("data", "model"), (16, 16)),
                             FakeMesh(("data", "model"), (16, 16)))):
            got, want = _port_specs(params, mesh), _ref_specs(structs, jmesh)
            assert got == want
        flat = dict(jax.tree_util.tree_flatten_with_path(structs)[0])
        for path, leaf in flat.items():
            key = "/".join(str(k.key) for k in path)
            assert part.logical_axes_for(key, leaf) == \
                jpart.logical_axes_for(path, leaf)


def test_logical_axes_of_flat_and_sequence_paths():
    leaf = torch.zeros((8, 4))
    assert part.logical_axes_for("layers/attn/wq_lora_a", leaf) == \
        ("embed", "replicated")
    assert part.logical_axes_for(("layers", "attn", "wo_lora_b"), leaf) == \
        ("replicated", "embed")
    assert part.logical_axes_for("connector/w", torch.zeros(3, 2, 5)) == \
        ("replicated",) * 3
    assert part.logical_axes_for("layers/attn/wq", torch.zeros(2, 8, 4)) \
        == (None, "embed", "heads")


def test_constrain_is_the_identity_and_checks_rank():
    x = torch.zeros((2, 3, 4))
    cache = torch.zeros((2, 8, 2, 4))
    assert part.constrain(x, "batch") is x           # no context: no check
    assert part.constrain_kv_cache(x) is x
    assert part.current_context() is None
    mesh = (("data", "model"), (2, 4))
    with part.sharding_context(mesh, rules.TRAIN_RULES):
        assert part.current_context() == (mesh, rules.TRAIN_RULES)
        assert part.constrain(x, "batch", "seq", "embed") is x
        assert part.constrain_kv_cache(cache) is cache
        with pytest.raises(ValueError, match="rank 3"):
            part.constrain(x, "batch", "seq")
        with pytest.raises(ValueError):
            part.constrain_kv_cache(x)
    assert part.current_context() is None


def _moe_cfgs():
    kw = dict(name="t", family="moe", n_layers=2, d_model=32, n_heads=4,
              n_kv_heads=2, head_dim=8, d_ff=0, vocab_size=64, n_experts=4,
              top_k=2, d_ff_expert=64, capacity_factor=4.0, n_modalities=0,
              remat=False, dtype="float32")
    return JConfig(**kw), ModelConfig(**kw)


def test_moe_mlp_sharded_matches_reference_on_1x1():
    jcfg, cfg = _moe_cfgs()
    p = jax.tree.map(lambda a: a.astype(jnp.float32),
                     jmoe.init_moe(jax.random.key(0), jcfg))
    x = jax.random.normal(jax.random.key(1), (2, 16, jcfg.d_model))
    with jpart.sharding_context(jax.make_mesh((1, 1), ("data", "model")),
                                jrules.rules_for("train", False)):
        y_ref, aux_ref = jmoe.moe_mlp_sharded(p, jcfg, x)
    tp = {k: torch.from_numpy(np.array(v)) for k, v in p.items()}
    tx = torch.from_numpy(np.array(x))
    with single_rank():
        with part.sharding_context(mesh_lib.make_federated_mesh(
                device_type="cpu"), rules.rules_for("train", False)):
            y, aux = moe.moe_mlp_sharded(tp, cfg, tx)
            with pytest.raises(NotImplementedError):
                moe.moe_mlp_sharded(tp, cfg, tx, clients=2)
    # |y| reaches ~90 here, where one f32 ulp is ~8e-6: across the two
    # frameworks y is held at 1e-5 relative (the reference holds its two
    # XLA paths at 1e-5 absolute)
    np.testing.assert_allclose(y.numpy(), np.asarray(y_ref), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(float(aux), float(aux_ref), atol=1e-5)
    y0, aux0 = moe.moe_mlp(tp, cfg, tx)            # outside a context
    assert [torch.equal(a, b) for a, b in
            zip(moe.moe_mlp_sharded(tp, cfg, tx), (y0, aux0))] == [True] * 2


def test_mma_psum_weights_match_reference_single_shard():
    for counts in ([2, 3], [0, 0], [1, 2, 3, 3]):
        want = float(jmma.mma_psum_weights(jnp.array(counts), axis_names=()))
        got = mma.mma_psum_weights(torch.tensor(counts, dtype=torch.int32))
        assert got.dtype == torch.float32 and float(got) == want


def test_meshes_and_tree_shardings_on_one_rank():
    from torch.distributed.tensor import Replicate, Shard
    with pytest.raises(RuntimeError, match="process group"):
        mesh_lib.make_federated_mesh(device_type="cpu")
    with single_rank():
        host = mesh_lib.make_host_mesh(device_type="cpu")
        fed = mesh_lib.make_federated_mesh(device_type="cpu")
        assert mesh_lib.mesh_axis_sizes(host) == {"data": 1, "model": 1}
        assert mesh_lib.n_chips(fed) == 1 and fed.device_type == "cpu"
        assert [mesh_lib.mesh_axis_sizes(m) for m in
                mesh_lib.make_cohort_meshes(3, device_type="cpu")] == \
            [{"data": 1, "model": 1}] * 3
        with pytest.raises(ValueError, match="256"):
            mesh_lib.make_production_mesh(device_type="cpu")
        specs = {"w": Spec("model", None), "b": {"c": Spec(None, "data")}}
        got = part.tree_shardings(specs, fed)
        assert got == {"w": (Replicate(), Shard(0)),
                       "b": {"c": (Shard(1), Replicate())}}
        assert part.client_block(5, fed, rules.TRAIN_RULES, axis=1) == \
            (slice(None), slice(0, 5))
