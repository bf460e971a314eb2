"""Sharding helpers on a ``torch.distributed`` DeviceMesh (port of
``repro.sharding.partition``).

The reference is one controller over a GSPMD mesh; the port runs one
process a rank (SPMD with explicit collectives).  Each rank holds plain
local tensors: its block of a sharded axis, or the whole of a replicated
one.  The kernels take raw pointers, so no DTensor reaches the hot path.
A placement is honoured only where the reference spells out a data
movement: the stacked engines' client axis (:func:`client_block`,
:func:`place_stacked`, the runner's gathers), ``moe_mlp_sharded``'s expert
split and ``mma_psum_weights``.

The reference's :func:`constrain` and :func:`constrain_kv_cache` are
``with_sharding_constraint`` hints to XLA's partitioner; the port's model
calls them at the reference's points (the banded module's five aside: the
port has no banded module).  Outside a :func:`sharding_context` they
return ``x`` itself, so the card's paths see nothing of them.  Inside one,
a ``DTensor`` (the dry run's: ``launch/dryrun.py`` enters the context) is
redistributed to the placements of the sanitized spec, and its gradient
to the same placements on the way back, as JAX's transpose of the
constraint constrains the cotangent; a plain tensor is returned as it is.

A mesh is read through its ``mesh_dim_names`` and ``shape`` (a DeviceMesh),
or given as a ``(names, shape)`` pair where no process group is needed
(the pure spec functions).
"""
from __future__ import annotations

import contextlib
import re
import threading
from typing import Optional, Tuple

import torch

from repro_torch.checkpointing.checkpoint import map_pytree
from repro_torch.sharding.rules import Rules, Spec

_ctx = threading.local()


@contextlib.contextmanager
def sharding_context(mesh, rules: Rules):
    prev = getattr(_ctx, "value", None)
    _ctx.value = (mesh, rules)
    try:
        yield
    finally:
        _ctx.value = prev


def current_context():
    return getattr(_ctx, "value", None)


def mesh_sizes(mesh) -> dict:
    """{axis name: size} of a DeviceMesh or a ``(names, shape)`` pair."""
    if isinstance(mesh, tuple):
        names, shape = mesh
    else:
        names, shape = mesh.mesh_dim_names, mesh.shape
    return dict(zip(names, shape))


def _sanitize_spec(spec, shape, mesh) -> Spec:
    """Drop duplicate mesh axes and axes that don't divide the dim (a
    placement that cannot hold degrades to replication, never fails)."""
    sizes = mesh_sizes(mesh)
    used = set()
    out = []
    for dim, entry in zip(shape, tuple(spec) + (None,) * (len(shape)
                                                          - len(spec))):
        axes = entry if isinstance(entry, tuple) else (
            (entry,) if entry is not None else ())
        kept = []
        prod = 1
        for a in axes:
            if a in used or a not in sizes:
                continue
            if dim % (prod * sizes[a]) != 0:
                continue
            kept.append(a)
            prod *= sizes[a]
            used.add(a)
        out.append(tuple(kept) if len(kept) > 1 else (kept[0] if kept
                                                      else None))
    return Spec(*out)


class _Constrain(torch.autograd.Function):
    """A DTensor redistributed to ``placements``, its gradient too (DTensor's
    own ``redistribute`` sends the gradient back to the input's
    placements)."""

    @staticmethod
    def forward(ctx, x, placements):
        ctx.placements = placements
        return x.redistribute(x.device_mesh, placements)

    @staticmethod
    def backward(ctx, g):
        return g.redistribute(g.device_mesh, ctx.placements), None


def _constrained(x, spec: Spec):
    """``x`` (a DTensor) at ``spec``'s placements on its mesh (a split over
    a mesh dim of one rank is none: replicated, as the dry run places its
    inputs): ``x`` itself where it already has them and needs no
    gradient."""
    from torch.distributed.tensor import Replicate
    mesh = x.device_mesh
    placements = tuple(Replicate() if n == 1 else p for n, p in
                       zip(mesh.shape, tree_shardings(spec, mesh)))
    if tuple(x.placements) == placements and not x.requires_grad:
        return x
    return _Constrain.apply(x, placements)


def _is_dtensor(x) -> bool:
    from torch.distributed.tensor import DTensor
    return isinstance(x, DTensor)


def constrain(x, *logical: Optional[str]):
    """The reference's activation constraint.  Outside a context ``x``
    itself; inside one the logical axes must match ``x``'s rank, and a
    DTensor comes out at the placements of the rules' spec, sanitized
    against its shape (a plain tensor as it is)."""
    ctx = current_context()
    if ctx is None:
        return x
    if x.dim() != len(logical):
        raise ValueError(f"rank {x.dim()} vs logical axes {logical}")
    if not _is_dtensor(x):
        return x
    mesh, rules = ctx
    return _constrained(x, _sanitize_spec(rules.spec(*logical),
                                          tuple(x.shape), mesh))


def kv_cache_axes(B: int, Sc: int, K: int, sizes: dict, multi_pod: bool):
    """Shared sharding policy for decode KV caches (B, Sc, K, hd): batch
    over data(+pod) when divisible; else sequence-parallel KV over data
    (and model too when kv heads are unshardable)."""
    dsz, msz = sizes.get("data", 1), sizes.get("model", 1)
    psz = sizes.get("pod", 1) if multi_pod else 1

    def div(n, s):
        return s > 1 and n % s == 0 and n >= s

    if div(B, dsz * psz):
        b_ax = ("pod", "data") if multi_pod else ("data",)
    elif div(B, dsz):
        b_ax = ("data",)
    else:
        b_ax = None
    used_data = b_ax is not None
    k_ax = "model" if div(K, msz) else None
    s_ax = None
    if not used_data and div(Sc, dsz):
        s_ax = ("data",)
        if k_ax is None and div(Sc, dsz * msz):
            s_ax = ("data", "model")
    elif k_ax is None and div(Sc, msz):
        s_ax = ("model",)
    return b_ax, (tuple(s_ax) if s_ax else None), k_ax


def constrain_kv_cache(x):
    """x: (B, Sc, K, hd) under the shared KV-cache policy
    (:func:`kv_cache_axes`), as :func:`constrain`: ``x`` itself outside a
    context; inside one ``x`` must be rank 4."""
    ctx = current_context()
    if ctx is None:
        return x
    if x.dim() != 4:
        raise ValueError(f"KV cache of rank {x.dim()}, expected "
                         "(B, Sc, K, hd)")
    if not _is_dtensor(x):
        return x
    sizes = mesh_sizes(ctx[0])
    B, Sc, K, _ = x.shape
    b_ax, s_ax, k_ax = kv_cache_axes(B, Sc, K, sizes, "pod" in sizes)
    return _constrained(x, Spec(b_ax, s_ax, k_ax, None))


# ---------------------------------------------------------------------------
# stacked federated clients (the stacked engines' leading client axis)

def client_axes(n: int, mesh, rules: Rules) -> Tuple[str, ...]:
    """The mesh axes a client axis of ``n`` is split over: the "device"
    logical axis, sanitized against ``n`` (``()`` where it replicates:
    the data size does not divide ``n``)."""
    entry = _sanitize_spec(Spec(rules.axis("device")), (n,), mesh)[0]
    if entry is None:
        return ()
    return entry if isinstance(entry, tuple) else (entry,)


def client_block(n: int, mesh, rules: Rules, axis: int = 0):
    """This rank's block of a client axis of ``n`` at dimension ``axis``,
    as an index (``x[client_block(...)]``): the counterpart of the
    reference's ``stacked_client_shardings`` (``axis=0``, state trees) and
    ``stacked_eval_shardings`` (``axis=1``, (T, N, B, ...) eval stacks).
    Ranks along the mesh axes of :func:`client_axes` take consecutive
    equal blocks in client order; the whole axis where the placement
    replicates; None on a rank outside ``mesh``."""
    coord = mesh.get_coordinate()
    if coord is None:
        return None
    axes = client_axes(n, mesh, rules)
    names = list(mesh.mesh_dim_names)
    idx, shards = 0, 1
    for a in axes:
        size = mesh.shape[names.index(a)]
        idx = idx * size + coord[names.index(a)]
        shards *= size
    per = n // shards
    return (slice(None),) * axis + (slice(idx * per, (idx + 1) * per),)


def mesh_device(mesh) -> torch.device:
    """The device this rank's tensors of ``mesh`` live on (its current
    CUDA device on a "cuda" mesh)."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def place_stacked(tree, mesh, rules: Optional[Rules], axis: int = 0,
                  device=None):
    """A stacked client tree at its compute placement: on a mesh, this
    rank's block of the client axis ``axis`` (a copy where the axis is
    split, the leaf itself where it is whole) on the mesh's device; off a
    mesh, every leaf moved to ``device`` (left where it is when None)."""
    if mesh is not None and rules is not None:
        dev = mesh_device(mesh)

        def f(leaf):
            if leaf.dim() <= axis:
                return leaf.to(dev)
            blk = client_block(leaf.shape[axis], mesh, rules, axis)
            if blk is None:
                raise ValueError("this rank is not on the mesh")
            whole = blk[axis] == slice(0, leaf.shape[axis])
            return leaf.to(dev) if whole else leaf[blk].to(dev).clone()
        return map_pytree(f, tree)
    if device is not None:
        return map_pytree(lambda t: t.to(device), tree)
    return tree


def replicated(tree, mesh):
    """Every leaf whole on the mesh's device (server state on the client
    mesh: each rank holds and computes the same copy)."""
    dev = mesh_device(mesh)
    return map_pytree(lambda t: t.to(dev), tree)


# ---------------------------------------------------------------------------
# parameter partitioning by leaf path

# leaf-name -> logical axes of the *unstacked* (single-layer) parameter.
# A leading layer-stack dimension is detected by rank and padded with None.
# Names are matched on the last path component.
_LEAF_LOGICAL = {
    # embeddings
    "embed": ("vocab", "embed"),
    "unembed": ("embed", "vocab"),
    "pos_embed": ("seq", "embed"),
    # attention
    "wq": ("embed", "heads"),
    "wk": ("embed", "kv_heads"),
    "wv": ("embed", "kv_heads"),
    "wo": ("heads", "embed"),
    "q_norm": ("replicated",),
    "k_norm": ("replicated",),
    # dense mlp
    "w_gate": ("embed", "ff"),
    "w_up": ("embed", "ff"),
    "w_down": ("ff", "embed"),
    # moe: experts on "model", d_model FSDP-sharded on "data"
    "router": ("embed", "replicated"),
    "we_gate": ("experts", "embed_fsdp", "replicated"),
    "we_up": ("experts", "embed_fsdp", "replicated"),
    "we_down": ("experts", "replicated", "embed_fsdp"),
    # ssm
    "in_proj": ("embed", "ssm_inner"),
    "out_proj": ("ssm_inner", "embed"),
    "conv_w": ("ssm_inner", "replicated"),
    "conv_b": ("ssm_inner",),
    "A_log": ("replicated",),
    "dt_bias": ("replicated",),
    "ssm_norm": ("ssm_inner",),
    # norms / scalars
    "scale": ("replicated",),
    "bias": ("replicated",),
}

# LoRA adapters: A has the target's input dim, B the target's output dim.
_LORA_A_LOGICAL = {
    "wq": ("embed", "replicated"), "wk": ("embed", "replicated"),
    "wv": ("embed", "replicated"), "wo": ("heads", "replicated"),
    "in_proj": ("embed", "replicated"), "out_proj": ("ssm_inner",
                                                     "replicated"),
}
_LORA_B_LOGICAL = {
    "wq": ("replicated", "heads"), "wk": ("replicated", "kv_heads"),
    "wv": ("replicated", "kv_heads"), "wo": ("replicated", "embed"),
    "in_proj": ("replicated", "ssm_inner"), "out_proj": ("replicated",
                                                         "embed"),
}


def logical_axes_for(path, leaf) -> tuple:
    """The logical axes of ``leaf`` at ``path``: a flat ``"a/b/c"`` key or
    a sequence of keys."""
    names = path.split("/") if isinstance(path, str) else \
        [str(p) for p in path]
    last = names[-1].split("/")[-1]
    m = re.match(r"^(.*)_lora_([ab])$", last)
    if m:
        target, which = m.group(1), m.group(2)
        table = _LORA_A_LOGICAL if which == "a" else _LORA_B_LOGICAL
        axes = table.get(target, ("replicated", "replicated"))
    elif last in _LEAF_LOGICAL:
        axes = _LEAF_LOGICAL[last]
    else:
        # connector / frontend / heads of the ML-ECS connector: replicate
        axes = tuple("replicated" for _ in range(leaf.ndim))
    # pad a leading layer-stack dim with None
    if leaf.ndim == len(axes) + 1:
        axes = (None,) + tuple(axes)
    elif leaf.ndim != len(axes):
        axes = tuple("replicated" for _ in range(leaf.ndim))
    return axes


def param_pspecs(params, rules: Rules, mesh=None):
    """A :class:`Spec` for every leaf of a parameter tree (nested dicts,
    or a flat dict of ``"a/b/c"`` keys), in the tree's structure.  With
    ``mesh`` the specs are sanitized against the leaf shapes (an axis
    that does not divide its dim replicates)."""
    def visit(tree, prefix):
        out = {}
        for k, v in tree.items():
            path = (*prefix, k)
            if isinstance(v, dict):
                out[k] = visit(v, path)
                continue
            spec = rules.spec(*logical_axes_for("/".join(map(str, path)),
                                                v))
            out[k] = spec if mesh is None else _sanitize_spec(
                spec, tuple(v.shape), mesh)
        return out
    return visit(params, ())


def tree_shardings(spec_tree, mesh):
    """Each :class:`Spec` of ``spec_tree`` as DTensor placements on
    ``mesh``, one a mesh dimension: ``Shard(d)`` where the spec puts that
    mesh axis on tensor dim ``d``, else ``Replicate()`` (for callers that
    build DTensors; the port's own paths keep plain local tensors)."""
    from torch.distributed.tensor import Replicate, Shard

    def one(spec):
        placements = [Replicate()] * len(mesh.mesh_dim_names)
        for d, entry in enumerate(spec):
            axes = entry if isinstance(entry, tuple) else (
                (entry,) if entry is not None else ())
            for a in axes:
                placements[list(mesh.mesh_dim_names).index(a)] = Shard(d)
        return tuple(placements)

    if isinstance(spec_tree, Spec):
        return one(spec_tree)
    return {k: tree_shardings(v, mesh) for k, v in spec_tree.items()}
