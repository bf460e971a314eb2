"""Production-mesh dry run (port of ``repro.launch.dryrun``): one step of
the train, prefill or decode path for every (architecture x input shape),
on fake tensors over a fake process group of the reference's production
mesh, (16, 16) = 256 ranks or (2, 16, 16) = 512 with ``--multi-pod``; the
per-rank FLOP, bytes, memory and collectives of that step, and the three
roofline terms.

The reference lowers and compiles the step with XLA and reads its cost
and memory analyses and the post-SPMD HLO.  Here:

* ``launch.mesh.fake_world`` starts a ``"fake"`` process group (its
  collectives move nothing) and ``make_production_mesh(device_type=
  "cpu")`` builds the mesh; params, optimizer state, batch and caches are
  DTensors on it, placed by the ported specs (``param_pspecs``,
  ``launch.specs``), each rank's block a fake tensor of the local shape;
* the step runs once under ``FakeTensorMode`` (no memory, no arithmetic)
  and ``implicit_replication`` (the model mixes DTensors with tensors it
  makes itself, RoPE's angles and the like, which join as replicated);
* the step runs inside ``sharding_context(mesh, rules)``, as the
  reference's does, so the model's ``constrain`` points (the reference's
  eleven outside ``banded.py``) place its activations; its outputs are
  placed as the reference's ``out_shardings`` place them;
* :class:`RankCost`, a dispatch mode beneath DTensor, sees each rank's
  local ops and counts: matmul FLOP on local shapes (``torch.utils.
  flop_counter``'s formulas; elementwise ops count none), bytes accessed
  (the input and output bytes of every local op but views: no fusion, so
  an upper bound on what a fused step moves), memory (argument bytes: the
  local params, optimizer state, batch and cache that an op reads or an
  output holds, as ``jax.jit``'s ``keep_unused=False`` drops the rest;
  output bytes: outputs that alias no argument; temp bytes: the peak of
  live local storage minus all the arguments) and every collective (op,
  output bytes, group size), which :func:`collective_bytes` turns into
  per-rank traffic by the reference's ring formulas.  The ops DTensor runs
  on global shapes to propagate metadata are not a rank's and are not
  counted;
* DTensor lays out some ops otherwise than GSPMD, and the dry run gives
  those its own split forms for the duration (:func:`_handlers`, in
  DTensor's custom-handler table, as ``loss_parallel`` does): softmax and
  log-softmax over a split dim and their gradients, ``new_zeros`` and
  ``scatter_add`` (the full CE's gradient stays placed like its logits),
  ``mm`` / ``bmm`` (no partial product left to reduce once a use, no
  gather of a split batch dim), a view that cuts a split dim into more
  parts than it has ranks (the split moves to the sequence), a cut or a
  row of a split dim, and a lookup in a vocab-split table;
* DTensor's own rules differ between torch versions (the card's host
  runs 2.11, the CPU tests 2.13); where they do, the table's handler
  gives both versions one answer, the layout 2.13's DTensor picks
  (``VERSION_GAPS``: strided splits of merged batch and heads, ``roll``,
  ``flip`` and ``constant_pad_nd``, the Gram path's batched linalg, the
  moe buffer's writes, a masked partial sum met by an add, a product
  cut to its weight's split).

Differences from the reference, each a reason its numbers differ:

* the path is the plain twins of ``kernels/ops.py`` (what the port runs on
  CPU tensors), not the card's kernels, as the reference costs its jnp
  path and not its Pallas kernels; the JSON says so under ``"path"``.
  Their elementwise ops are not fused (the attention twin holds its
  logits twice), and A's twin reads a decode step's ring through its
  block table, a gather the reference's ``mha`` over the ring has not;
* where DTensor cannot hold GSPMD's layout, the activations differ: a
  head split of fewer heads than ranks (gemma-2b's 8 over 16) becomes a
  split of the sequence, where GSPMD tiles the head dim; an op DTensor
  fails on runs replicated (``_run_replicated``, counted in the JSON's
  ``replicated_ops``);
* the port runs every layer in Python, so each collective is seen once per
  issue and no scan-trip multiplier applies (``layers_per_body`` is 1);
* the collective term is bytes over ``NVLINK_BW``, one H100 SXM's NVLink
  rate: past one 8-GPU node the fabric is slower, so the term is a lower
  bound there;
* ``lower_s`` is the host seconds to build and place the inputs and
  ``compile_s`` those of the fake step (the reference's lowering and XLA
  compile); ``torch`` is the version that ran it, since DTensor's
  propagation differs between versions.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch gemma-2b --shape train_4k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--multi-pod]
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --jobs 7
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch ... --full-finetune
Outputs one JSON per combo under experiments/dryrun_torch/.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import threading
import time
import traceback
import weakref
from typing import Dict, List, NamedTuple, Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.configs.base import (ARCH_IDS, INPUT_SHAPES, InputShape,
                                      get_config)
from repro_torch.core import lora as lora_lib
from repro_torch.launch import specs as S
from repro_torch.launch.mesh import (HBM_BW, NVLINK_BW, PEAK_FLOPS_BF16,
                                     fake_world, make_production_mesh,
                                     mesh_axis_sizes, n_chips)
from repro_torch.launch.serve import make_serve_step
from repro_torch.launch.train import make_train_step
from repro_torch.models.model import build_model
from repro_torch.optim.adamw import adamw
from repro_torch.sharding.partition import param_pspecs, sharding_context
from repro_torch.sharding.rules import Spec, rules_for

ASSIGNED = [a for a in ARCH_IDS if not a.startswith("mlecs")]

PATH = "plain twins on fake CPU tensors"


# ---------------------------------------------------------------------------
# collectives

class Collective(NamedTuple):
    """One collective a rank issued: the reference's HLO op name, the
    bytes of its output on this rank, its group size, and whether it sits
    in a loop body the reference's HLO holds once (never, for the port's
    eager steps)."""
    op: str
    nbytes: int
    group: int
    in_body: bool = False


# functional-collective op name -> the reference's HLO op name
_COLLECTIVE_OPS = {
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_reduce": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "all_to_all_single": "all-to-all",
    "shard_dim_alltoall": "all-to-all",
    "broadcast": "broadcast",
}


def collective_bytes(records: List[Collective], scan_trips: int = 1) -> dict:
    """Per-rank collective traffic estimate from the step's collectives
    (the reference reads them from the post-SPMD HLO).

    Ring estimates on the output bytes: all-gather ~= out*(g-1)/g,
    all-reduce ~= 2*out*(g-1)/g, reduce-scatter ~= out*(g-1), all-to-all
    ~= out*(g-1)/g, permute = out; a broadcast is costed as an all-gather.
    A record ``in_body`` counts ``scan_trips`` times, as the reference
    multiplies its while-loop bodies; groups of one move nothing."""
    per_op: Dict[str, dict] = {}
    total = 0.0
    for r in records:
        g = r.group
        if g <= 1:
            continue
        if r.op == "all-reduce":
            moved = 2.0 * r.nbytes * (g - 1) / g
        elif r.op == "reduce-scatter":
            moved = float(r.nbytes) * (g - 1)
        elif r.op == "collective-permute":
            moved = float(r.nbytes)
        else:          # all-gather, all-to-all, broadcast
            moved = float(r.nbytes) * (g - 1) / g
        moved *= scan_trips if r.in_body else 1
        d = per_op.setdefault(r.op, {"count": 0, "bytes": 0.0})
        d["count"] += 1
        d["bytes"] += moved
        total += moved
    return {"total_bytes": total, "per_op": per_op}


def _group_size(func, args, kwargs) -> int:
    named = dict(zip((a.name for a in func._schema.arguments), args))
    named.update(kwargs)
    if "group_size" in named:
        return int(named["group_size"])
    from torch.distributed.distributed_c10d import _resolve_process_group
    return _resolve_process_group(named["group_name"]).size()


# ---------------------------------------------------------------------------
# per-rank cost of the local ops

def _tensors(tree):
    return [t for t in torch.utils._pytree.tree_leaves(tree)
            if isinstance(t, torch.Tensor)]


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


_prop = threading.local()       # .depth: DTensor's propagation, nested


@contextlib.contextmanager
def _marking_propagation():
    """While DTensor propagates shardings it runs each new op once on fake
    tensors of the global shapes (to learn the output's shape): those ops
    are no rank's.  Mark them by wrapping the propagator's uncached path,
    and its output-shape pass, which torch 2.11 also calls on its own, for
    the duration.  They run outside the dry run's ``FakeTensorMode``: they
    make fake tensors of their own, and the small index tensors read on
    the host to split a dim unevenly must be real."""
    from torch.distributed.tensor._sharding_prop import ShardingPropagator
    name = "propagate_op_sharding_non_cached"
    if getattr(ShardingPropagator, name, None) is None:
        raise NotImplementedError(
            f"torch {torch.__version__}: ShardingPropagator has no {name}, "
            "so the dry run cannot tell DTensor's global-shape propagation "
            "from a rank's ops")
    origs = {n: getattr(ShardingPropagator, n) for n in (
        name, "_propagate_tensor_meta_non_cached")
        if getattr(ShardingPropagator, n, None) is not None}

    def marked(orig):
        def wrapped(self, *a, **k):
            from torch._subclasses.fake_tensor import unset_fake_temporarily
            _prop.depth = getattr(_prop, "depth", 0) + 1
            try:
                with unset_fake_temporarily():
                    return orig(self, *a, **k)
            finally:
                _prop.depth -= 1
        return wrapped
    for n, orig in origs.items():
        setattr(ShardingPropagator, n, marked(orig))
    try:
        yield
    finally:
        for n, orig in origs.items():
            setattr(ShardingPropagator, n, orig)


@contextlib.contextmanager
def _all_to_all_on_cpu_meshes():
    """DTensor turns a shard-to-shard move on a "cpu" mesh into an
    all-gather and a chunk (gloo has no all-to-all); the card's NCCL runs
    one all-to-all.  Cost the card's: call the all-to-all op, whose fake
    kernel gives its output shape, on every mesh."""
    from torch.distributed.tensor import placement_types as pt
    orig = getattr(pt, "shard_dim_alltoall", None)
    if orig is None:
        yield
        return

    def alltoall(input, gather_dim, shard_dim, mesh, mesh_dim):
        return torch.ops._dtensor.shard_dim_alltoall(
            input, gather_dim, shard_dim, mesh.get_group(mesh_dim).group_name)
    pt.shard_dim_alltoall = alltoall
    try:
        yield
    finally:
        pt.shard_dim_alltoall = orig


# ---------------------------------------------------------------------------
# DTensor ops the reference's partitioner splits and DTensor does not

def _strided(p) -> bool:
    """A strided split (``_StridedShard``: the dim cut into ``split_factor``
    pieces, each rank holding its block of every piece), which torch 2.11
    counts as a ``Shard`` and 2.13 does not."""
    from torch.distributed.tensor.placement_types import _StridedShard
    return isinstance(p, _StridedShard)


def _splits(x, dim: int) -> List[int]:
    """The mesh dims that split dim ``dim`` of DTensor ``x`` (none where a
    placement other than a split or a copy, a partial sum or a strided
    split, is on ``x``)."""
    if any(_strided(p) or not (p.is_shard() or p.is_replicate())
           for p in x.placements):
        return []
    return [i for i, p in enumerate(x.placements) if p.is_shard(dim)]


def _all_reduce(t, op: str, mesh, mesh_dims):
    """``t`` reduced with ``op`` over each of ``mesh_dims`` (counted by
    the caller's mode, as every local collective)."""
    c10d = torch.ops._c10d_functional
    for d in mesh_dims:
        t = c10d.wait_tensor(c10d.all_reduce(
            t, op, mesh.get_group(d).group_name))
    return t


def _from_local(local, mesh, placements, shape, stride):
    """``local`` as this rank's block of a DTensor.  A strided split is
    one of a view's (each rank's block of every ``split_factor`` piece of
    the dim), as DTensor's own view rule makes it, and not the shard
    order ``from_local`` reads one as."""
    from torch.distributed.tensor import DTensor
    if not any(_strided(p) for p in placements):
        return DTensor.from_local(local, mesh, placements, run_check=False,
                                  shape=tuple(shape), stride=tuple(stride))
    from torch.distributed.tensor._dtensor_spec import DTensorSpec, TensorMeta
    spec = DTensorSpec(mesh, tuple(placements), TensorMeta(
        torch.Size(shape), tuple(stride), local.dtype),
        use_strided_shard_as_shard_order=False)
    return DTensor(local, spec, requires_grad=local.requires_grad)


def _dtensor(local, mesh, placements, shape):
    """``local`` as this rank's block of a contiguous DTensor of ``shape``
    placed by ``placements`` on ``mesh``."""
    stride, n = [], 1
    for s in reversed(shape):
        stride.insert(0, n)
        n *= s
    return _from_local(local, mesh, placements, shape, stride)


def _to(x, placements):
    """DTensor ``x`` at ``placements``: itself where it is there already,
    else redistributed, detached first (the handlers run beneath autograd,
    and torch 2.11's ``redistribute`` of a tensor that needs a gradient
    calls ``detach_``, which DTensor has no rule for)."""
    if tuple(x.placements) == tuple(placements):
        return x
    return x.detach().redistribute(x.device_mesh, tuple(placements))


def _like(x):
    return x.device_mesh, x.placements, x.shape


def _unhandled(func, args, kwargs):
    """``func`` through DTensor's own rule, this table's handler set
    aside for the call."""
    from torch.distributed.tensor import DTensor
    table = DTensor._op_dispatcher._custom_op_handlers
    handler = table.pop(func)
    try:
        return func(*args, **kwargs)
    finally:
        table[func] = handler


def _softmax(func, args, kwargs):
    """(log-)softmax over a split dim, as GSPMD splits it: each rank's
    block shifted by the all-reduced max and normalised by the
    all-reduced sum of its exponentials (DTensor gathers the dim)."""
    x, dim, half_to_float = args
    dim %= x.dim()
    split = _splits(x, dim)
    if not split:
        return _unhandled(func, args, kwargs)
    t = x._local_tensor
    t = t.float() if half_to_float else t
    m = _all_reduce(torch.amax(t, dim, keepdim=True), "max", x.device_mesh,
                    split)
    shifted = t - m
    s = _all_reduce(torch.sum(torch.exp(shifted), dim, keepdim=True), "sum",
                    x.device_mesh, split)
    if func is torch.ops.aten._log_softmax.default:
        return _dtensor(shifted - torch.log(s), *_like(x))
    return _dtensor(torch.exp(shifted) / s, *_like(x))


def _softmax_backward(func, args, kwargs):
    """The backward of :func:`_softmax` where its output is split on the
    dim: the row sums all-reduced, the gradient taken to the output's
    placements."""
    grad, out, dim, _ = args
    dim %= out.dim()
    split = _splits(out, dim)
    if not split:
        return _unhandled(func, args, kwargs)
    g = _to(grad, out.placements)._local_tensor
    y = out._local_tensor
    if func is torch.ops.aten._log_softmax_backward_data.default:
        s = _all_reduce(torch.sum(g, dim, keepdim=True), "sum",
                        out.device_mesh, split)
        return _dtensor(g - torch.exp(y) * s, *_like(out))
    s = _all_reduce(torch.sum(g * y, dim, keepdim=True), "sum",
                    out.device_mesh, split)
    return _dtensor(y * (g - s), *_like(out))


def _new_zeros(func, args, kwargs):
    """Zeros are right under any placement.  They keep each split of
    ``self`` whose dim keeps its size, and a dim that ``self`` holds at
    size 1 (the gradient of a gather along it) is split over the mesh dims
    that copy ``self``, as the tensor the gather read is split (DTensor
    makes every new size replicated)."""
    from torch.distributed.tensor import Replicate, Shard
    x, size = args[0], tuple(args[1])
    mesh = x.device_mesh
    if len(size) != x.dim() or any(not (p.is_shard() or p.is_replicate())
                                   for p in x.placements):
        return _unhandled(func, args, kwargs)
    placements = [p if p.is_shard() and size[p.dim] == x.shape[p.dim]
                  else Replicate() for p in x.placements]
    parts = [1] * len(size)
    for p, n in zip(placements, mesh.shape):
        if p.is_shard():
            parts[p.dim] *= n
    for i, n in enumerate(mesh.shape):
        if placements[i].is_shard() or n == 1:
            continue
        for d, s in enumerate(size):
            if x.shape[d] == 1 != s and s % (parts[d] * n) == 0:
                placements[i] = Shard(d)
                parts[d] *= n
                break
    local = list(size)
    for d, k in enumerate(parts):
        local[d] //= k
    return _dtensor(x._local_tensor.new_zeros(local, **kwargs), mesh,
                    placements, size)


def _scatter_add(func, args, kwargs):
    """``self.scatter_add(dim, index, src)`` where ``self`` is split on
    ``dim``: each rank adds the entries whose index falls in its block,
    shifted to the block (DTensor gathers ``self`` on the dim)."""
    from torch.distributed.tensor import DTensor, Replicate
    x, dim, index, src = args
    dim %= x.dim()
    split = _splits(x, dim)
    if not split or not all(isinstance(t, DTensor) for t in (index, src)):
        return _unhandled(func, args, kwargs)
    mesh = x.device_mesh
    keep = tuple(Replicate() if i in split else p
                 for i, p in enumerate(x.placements))
    idx = _to(index, keep)._local_tensor
    val = _to(src, keep)._local_tensor
    t = x._local_tensor
    coord, block = mesh.get_coordinate(), 0
    for i in split:
        block = block * mesh.shape[i] + coord[i]
    n = t.shape[dim]
    local = idx - block * n
    inside = (local >= 0) & (local < n)
    out = t.scatter_add(dim, local.clamp(0, n - 1),
                        val * inside.to(val.dtype))
    return _dtensor(out, *_like(x))


def _matmul(func, args, kwargs):
    """``a @ b`` (``mm``, ``bmm``) laid out as GSPMD lays out a dot, where
    DTensor's choice, which weighs only the moves of its inputs, does not:

    * a mesh dim that splits a's contracting dim and b's output dim: DTensor
      may move b onto its contracting dim, leaving a partial product whose
      reduction it does not weigh; a's contracting dim is gathered first
      where that moves fewer bytes than the reduction;
    * a mesh dim that splits a's rows and b's output dim (the queries and
      the keys of attention): DTensor may move both onto the batch dim,
      unevenly, where no later view holds them; the smaller input is
      gathered first;
    * a ``bmm`` whose batch dim a mesh dim splits in one input (the heads
      of a (batch x heads) dim, a strided split) and copies in the other:
      the copy is cut alike and each rank multiplies its blocks (DTensor
      gathers the split);
    * the product is reduced at once where it is a partial sum, scattered
      over its last dim where that divides (as XLA reduces a dot's
      partial sums before their uses): DTensor leaves it partial, and each
      later op that needs the sum reduces its own copy."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    a, b = args
    if not (isinstance(a, DTensor) and isinstance(b, DTensor)) or \
            any(p.is_partial() for p in a.placements + b.placements):
        return _unhandled(func, args, kwargs)
    mesh = a.device_mesh
    k, n = a.dim() - 1, b.dim() - 1
    if func is torch.ops.aten.mm.default and any(
            _strided(p) and p.dim != k for p in a.placements):
        # rows merged from a split batch and sequence: their strided
        # split gathered first, as torch 2.13's DTensor gathers it (2.11's
        # keeps it through the product; VERSION_GAPS)
        a = _unstrided(a)

    def gathered(x, i):
        return _to(x, tuple(Replicate() if j == i else p
                            for j, p in enumerate(x.placements)))
    rows = a._local_tensor.numel() // a._local_tensor.shape[-1]
    for i, (p, q) in enumerate(zip(a.placements, b.placements)):
        if not q.is_shard(n):
            continue
        g = mesh.shape[i]
        if p.is_shard(k) and _nbytes(a._local_tensor) * (g - 1) < \
                rows * b.shape[-1] * a.element_size() * (g - 1) / g:
            a = gathered(a, i)
        elif p.is_shard(k - 1):
            if _nbytes(b._local_tensor) <= _nbytes(a._local_tensor):
                b = gathered(b, i)
            else:
                a = gathered(a, i)
    if a.dim() == 3:
        out = _batched(a, b)
        if out is not None:
            return out
    out = _unhandled(func, (a, b), kwargs)
    if not any(p.is_partial() for p in out.placements):
        return out
    last = out.dim() - 1
    parts = _prod(n for p, n in zip(out.placements, mesh.shape)
                  if p.is_shard(last))
    placements = list(out.placements)
    for i, (p, n) in enumerate(zip(out.placements, mesh.shape)):
        if p.is_partial():
            # (a split nested inside one a later mesh dim holds would
            # move that one's blocks too)
            split = out.shape[last] % (parts * n) == 0 and not any(
                q.is_shard(last) for q in out.placements[i + 1:])
            parts *= n if split else 1
            placements[i] = Shard(last) if split else Replicate()
    return _to(out, tuple(placements))


def _unstrided(x):
    """DTensor ``x`` with each strided split gathered (innermost mesh dim
    first): an all-gather of the blocks over its mesh dim, each rank's
    pieces put back in the dim's order; the other placements kept."""
    from torch.distributed.tensor import Replicate
    c10d = torch.ops._c10d_functional
    mesh, t, placements = x.device_mesh, x._local_tensor, list(x.placements)
    for m in reversed(range(mesh.ndim)):
        p = placements[m]
        if not _strided(p):
            continue
        group, d, sf = mesh.get_group(m), p.dim, p.split_factor
        n, size = group.size(), t.shape[p.dim]
        g = c10d.wait_tensor(c10d.all_gather_into_tensor(
            t.movedim(d, 0).contiguous(), n, group.group_name))
        rest = g.shape[1:]
        t = g.reshape(n, sf, size // sf, *rest).transpose(0, 1).reshape(
            n * size, *rest).movedim(0, d)
        placements[m] = Replicate()
    return _from_local(t, mesh, placements, x.shape, x.stride())


def _slice(func, args, kwargs):
    """A cut of a split dim (the SSM's ``z``, ``xBC`` and ``dt`` out of its
    fused projection): its split moved to an earlier dim (an all-to-all),
    the cut made whole there, and moved back where the cut divides, as
    GSPMD reshards a slice (DTensor gathers the dim)."""
    from torch.distributed.tensor import Shard
    x = args[0]
    dim = (args[1] if len(args) > 1 else 0) % x.dim()
    split = _splits(x, dim)
    step = args[4] if len(args) > 4 else 1
    if not split or step != 1:
        return _unhandled(func, args, kwargs)
    mesh = x.device_mesh
    parts = [_prod(n for p, n in zip(x.placements, mesh.shape)
                   if p.is_shard(d)) for d in range(x.dim())]
    moved = list(x.placements)
    for i in split:
        n = mesh.shape[i]
        for d in reversed(range(dim)):
            if x.shape[d] % (parts[d] * n) == 0:
                moved[i] = Shard(d)
                parts[d] *= n
                break
        else:
            return _unhandled(func, args, kwargs)
    out = _unhandled(func, (_to(x, tuple(moved)), *args[1:]), kwargs)
    if out.shape[dim] % _prod(mesh.shape[i] for i in split) == 0:
        out = _to(out, x.placements)
    return out


def _split_dim(p):
    """The tensor dim a placement splits (a ``Shard``'s or a strided
    split's, which torch 2.13 does not count as a ``Shard``), else None."""
    return None if p.is_replicate() or p.is_partial() else p.dim


def _cut(x, placements):
    """``x`` cut to ``placements`` on each mesh dim that copies it: each
    rank keeps its block of the local tensor (a view; a strided split's
    blocks, one from each of its ``split_factor`` pieces, joined in one
    copy), where DTensor's redistribute cuts it chunk by chunk."""
    mesh, coord = x.device_mesh, x.device_mesh.get_coordinate()
    t = x._local_tensor
    for i, p in enumerate(placements):
        if not x.placements[i].is_replicate() or p.is_replicate():
            continue
        n, d, shape = mesh.shape[i], p.dim, t.shape
        sf = getattr(p, "split_factor", 1)
        t = t.reshape(*shape[:d], sf, n, shape[d] // (sf * n),
                      *shape[d + 1:]).select(d + 1, coord[i]).reshape(
            *shape[:d], shape[d] // n, *shape[d + 1:])
    return _from_local(t, mesh, tuple(placements), x.shape, x.stride())


def _batched(a, b):
    """``bmm(a, b)`` on each rank's blocks where no mesh dim splits the
    contracting dim: each mesh dim splits the batch dim of both alike, or
    a's rows, or b's columns, or neither.  A mesh dim that splits the
    batch dim of one input copies the other cut to match; where it splits
    the other otherwise (another dim, or the batch dim in another order),
    that input is gathered first if it is the smaller.  None where the
    placements are otherwise."""
    from torch.distributed.tensor import Replicate, Shard
    mesh = a.device_mesh
    pa, pb, out = list(a.placements), list(b.placements), []
    small_b = _nbytes(b._local_tensor) <= _nbytes(a._local_tensor)
    gather_a, gather_b = list(pa), list(pb)
    for i, (p, q) in enumerate(zip(pa, pb)):
        if p != q and not (p.is_replicate() or q.is_replicate()):
            if _split_dim(p) == 0 and small_b:
                gather_b[i] = q = Replicate()
            elif _split_dim(q) == 0 and not small_b:
                gather_a[i] = p = Replicate()
        if _split_dim(p) == 0 and q.is_replicate():
            pb[i] = q = p
        elif _split_dim(q) == 0 and p.is_replicate():
            pa[i] = p = q
        else:
            pa[i], pb[i] = p, q
        if _split_dim(p) == 0 and p == q:
            out.append(p)
        elif p.is_replicate() and q.is_replicate():
            out.append(p)
        elif p.is_shard(1) and q.is_replicate():
            out.append(Shard(1))
        elif p.is_replicate() and q.is_shard(2):
            out.append(Shard(2))
        else:
            return None
    a = _cut(_to(a, tuple(gather_a)), pa)
    b = _cut(_to(b, tuple(gather_b)), pb)
    return _dtensor(torch.bmm(a._local_tensor, b._local_tensor), mesh,
                    tuple(out), (a.shape[0], a.shape[1], b.shape[2]))


def _view_groups(src, dst):
    """The dims of a view of shape ``src`` as ``dst``, in groups ([src
    dims], [dst dims]) whose sizes multiply alike, outermost first
    (trailing size-1 dims join the last group); None where they do not
    line up."""
    if 0 in src or 0 in dst:
        return None
    groups, i, j = [], 0, 0
    while i < len(src) and j < len(dst):
        a, b, pa, pb = [i], [j], src[i], dst[j]
        i, j = i + 1, j + 1
        while pa != pb:
            if pa < pb and i < len(src):
                a.append(i)
                pa, i = pa * src[i], i + 1
            elif pb < pa and j < len(dst):
                b.append(j)
                pb, j = pb * dst[j], j + 1
            else:
                return None
        groups.append((a, b))
    if not groups or any(src[k] != 1 for k in range(i, len(src))) or \
            any(dst[k] != 1 for k in range(j, len(dst))):
        return None
    groups[-1][0].extend(range(i, len(src)))
    groups[-1][1].extend(range(j, len(dst)))
    return groups


def _strided_view(func, args):
    """A view that merges leading dims of which an inner one is split
    (the batch and the heads of an ``einsum``, both split, into the
    batch of a ``bmm``; the outer dims split by earlier mesh dims), or
    that cuts a dim a strided split holds (its result, back into batch
    and heads): each rank's block viewed alike, the split of an inner
    merged dim a strided split of the merged dim (its ``split_factor``
    the local size of the dims outside it), a strided split cut back onto
    the dim it came from.  torch 2.13's DTensor lays such a view out so;
    2.11's gathers the inner dim.  None where no strided split is made or
    read, or the dims do not map so."""
    from torch.distributed.tensor import Shard
    from torch.distributed.tensor.placement_types import _StridedShard
    x, shape = args[0], list(args[1])
    if -1 in shape:
        shape[shape.index(-1)] = x.numel() // -_prod(shape)
    groups = _view_groups(tuple(x.shape), shape)
    if groups is None:
        return None
    mesh = x.device_mesh
    src, dst = list(x.shape), list(shape)      # local sizes, mesh dim by dim
    group = {d: g for g, (a, _) in enumerate(groups) for d in a}
    split_by = {}
    for m, p in enumerate(x.placements):
        split_by.setdefault(_split_dim(p), []).append(m)
    out, strided = [], False
    for m, (n, p) in enumerate(zip(mesh.shape, x.placements)):
        d = _split_dim(p)
        if d is None:
            out.append(p)
            continue
        sf = getattr(p, "split_factor", 1) if _strided(p) else 1
        a, b = groups[group[d]]
        if len(b) == 1:             # a dim kept, or dims merged into one
            if len(a) > 1 and sf > 1:
                return None
            o, sf = b[0], sf * _prod(src[e] for e in a if e < d)
            if sf > 1 and len(a) > 1 and (o != 0 or any(
                    k > m for e in a if e < d for k in split_by.get(e, ()))):
                # only a bmm's batch, its outer dims split first (a split
                # merged otherwise is DTensor's to lay out)
                return None
        elif len(a) == 1:           # a dim cut into several: the strided
            o, before = None, 1     # split's pieces lie outside its dim
            for e in b:
                if before == sf and dst[e] > 1 and dst[e] % n == 0:
                    o = e
                    break
                before *= dst[e]
            if o is None:
                return None
            strided |= sf > 1
            sf = 1
        else:
            return None
        if src[d] % n or dst[o] % n:
            return None
        src[d] //= n
        dst[o] //= n
        strided |= sf > 1
        out.append(_StridedShard(o, split_factor=sf) if sf > 1 else Shard(o))
    if not strided:
        return None
    try:
        local = func(x._local_tensor, dst)
    except RuntimeError:            # a block that does not view so
        return None
    return _dtensor(local, mesh, tuple(out), shape)


def _view(func, args, kwargs):
    """A view DTensor fails on, or lays out otherwise than GSPMD: dims
    merged with an inner split, or cut back from one
    (:func:`_strided_view`); a split dim cut into more parts than it has
    ranks (8 heads out of a dim split 16 ways), or dims merged with more
    than their outermost split otherwise.  There each split of a dim the
    view keeps, or of the outermost dim of a merge, stays; each other
    moves to the innermost such dim it divides (the sequence, for a head
    reshape: the split GSPMD keeps by tiling the heads), else is
    gathered.  Then DTensor's view, or the fallback's whole tensors
    (:func:`_run_replicated`) where it fails again."""
    from torch.distributed.tensor import Replicate, Shard
    out = _strided_view(func, args)
    if out is not None:
        return out
    try:
        return _unhandled(func, args, kwargs)
    except Exception:  # noqa: BLE001 (DTensor's failures vary by version)
        x, shape = args[0], list(args[1])
        if -1 in shape:
            shape[shape.index(-1)] = x.numel() // -_prod(shape)
        kept = 0
        while kept < min(x.dim(), len(shape)) and x.shape[kept] == \
                shape[kept]:
            kept += 1
        if kept < len(shape) and x.dim() > kept + 1 and \
                x.shape[kept] * x.shape[kept + 1] <= shape[kept] and \
                shape[kept] % x.shape[kept] == 0:
            kept += 1      # a merge's outermost dim: its blocks stay whole
        placements = [p if p.is_shard() and p.dim < kept else None
                      for p in x.placements]
        parts = [1] * kept
        for p, n in zip(placements, x.device_mesh.shape):
            if p is not None:
                parts[p.dim] *= n
        for i, n in enumerate(x.device_mesh.shape):
            if placements[i] is not None:
                continue
            placements[i] = Replicate()
            if not x.placements[i].is_shard():
                continue
            for d in reversed(range(kept)):
                if x.shape[d] % (parts[d] * n) == 0:
                    placements[i] = Shard(d)
                    parts[d] *= n
                    break
        if tuple(placements) == tuple(x.placements):
            raise
        return _unhandled(func, (_to(x, tuple(placements)), *args[1:]),
                          kwargs)


def _select(func, args, kwargs):
    """``x.select(dim, i)`` on a split dim (the ring write of a decode
    step, the last position of a prefill): a view of one rank's block, as
    GSPMD updates and reads a split cache in place (DTensor gathers the
    dim).  The dry run's rank stands for the owner of row ``i``."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    x, dim, i = args
    dim %= x.dim()
    split = _splits(x, dim)
    if not split:
        return _unhandled(func, args, kwargs)
    t = x._local_tensor
    view = t.select(dim, (i % x.shape[dim]) % t.shape[dim])
    placements = tuple(
        Replicate() if not p.is_shard() or p.dim == dim else
        Shard(p.dim - (p.dim > dim)) for p in x.placements)
    drop = lambda v: tuple(v[:dim]) + tuple(v[dim + 1:])  # noqa: E731
    return DTensor.from_local(view, x.device_mesh, placements,
                              run_check=False, shape=drop(x.shape),
                              stride=drop(x.stride()))


def _index(func, args, kwargs):
    """``x[idx]`` (one index tensor, on dim 0) where x is split on dim 0:
    each rank looks up the ids in its block and the rows are all-reduced,
    as GSPMD partitions the gather (a vocab-split embedding), where that
    moves fewer bytes than moving the table's split onto its outermost
    other dim that divides (an all-to-all) and looking up whole rows (the
    ring read through a block table; torch 2.11's DTensor gathers the
    table)."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    x, indices = args
    idx = indices[0] if len(indices) == 1 else None
    split = _splits(x, 0)
    if idx is None or not split:
        return _unhandled(func, args, kwargs)
    mesh = x.device_mesh
    idx_pl = idx.placements if isinstance(idx, DTensor) else \
        (Replicate(),) * mesh.ndim
    if any(not q.is_replicate() and not p.is_replicate()
           for p, q in zip(x.placements, idx_pl)) or \
            any(q.is_partial() for q in idx_pl):
        return _unhandled(func, args, kwargs)
    local_idx = idx._local_tensor if isinstance(idx, DTensor) else idx
    t = x._local_tensor
    row = _nbytes(t) // t.shape[0]
    if 2 * local_idx.numel() * row >= _nbytes(t):
        moved, parts = list(x.placements), [1] * x.dim()
        for i in split:
            n = mesh.shape[i]
            for d in range(1, x.dim()):
                if x.shape[d] % (parts[d] * n) == 0 and not any(
                        p.is_shard(d) for p in x.placements):
                    moved[i] = Shard(d)
                    parts[d] *= n
                    break
            else:
                return _unhandled(func, args, kwargs)
        return _unhandled(func, (_to(x, tuple(moved)), indices), kwargs)
    coord, block = mesh.get_coordinate(), 0
    for i in split:
        block = block * mesh.shape[i] + coord[i]
    n = t.shape[0]
    shifted = local_idx.long() - block * n
    inside = (shifted >= 0) & (shifted < n)
    rows = t[shifted.clamp(0, n - 1)]
    rows = rows * inside.reshape(*inside.shape, *(1,) * (t.dim() - 1)) \
        .to(rows.dtype)
    rows = _all_reduce(rows, "sum", mesh, split)
    k = local_idx.dim()
    placements = tuple(
        q if p.is_replicate() else
        Replicate() if p.is_shard(0) else Shard(p.dim - 1 + k)
        for p, q in zip(x.placements, idx_pl))
    return _dtensor(rows, mesh, placements,
                    tuple(idx.shape) + tuple(x.shape[1:]))


def _index_put(func, args, kwargs):
    """``x[..., idx, ...] = values`` in place (a prefill writing its ring
    cache), ``values`` placed as x.  Where ``idx`` covers a split dim of
    x whole and ``values`` has x's shape, each rank writes its block of
    the values into its block of x, as GSPMD writes a ring that has not
    wrapped (DTensor gathers the whole cache; a wrapped ring's rotation, a
    permute of blocks, is not counted).  Where the dim is whole on every
    rank, each writes its blocks at the same indices (torch 2.11's DTensor
    has no rule for it), rows of any number among them
    (:func:`_put_rows`, which alone takes ``index_put``, the copy)."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    x, indices, values = args[:3]
    accumulate = args[3] if len(args) > 3 else kwargs.get("accumulate",
                                                          False)
    dims = [d for d, i in enumerate(indices) if i is not None]
    # (``x[...] = v`` hands index_put_ v without its leading 1-dims)
    lead = x.dim() - values.dim() if isinstance(values, DTensor) else -1
    idx = indices[dims[0]] if len(dims) == 1 else None
    if _rows_into_whole_dim(x, dims, idx, values):
        return _put_rows(func, x, dims[0], idx, values, accumulate)
    if func is not torch.ops.aten.index_put_.default or idx is None or \
            accumulate or lead < 0 or \
            tuple(values.shape) != tuple(x.shape[lead:]) or \
            any(n != 1 for n in x.shape[:lead]) or \
            idx.numel() != x.shape[dims[0]] or \
            any(p.is_partial() for p in x.placements) or \
            (isinstance(idx, DTensor) and
             not all(p.is_replicate() for p in idx.placements)):
        return _unhandled(func, args, kwargs)
    placements = tuple(Shard(p.dim - lead) if p.is_shard() else Replicate()
                       for p in x.placements)
    v = _to(values, placements)._local_tensor
    if _splits(x, dims[0]):
        x._local_tensor.copy_(v)
    else:
        local = [None] * x.dim()
        local[dims[0]] = idx._local_tensor if isinstance(idx, DTensor) \
            else idx
        func(x._local_tensor, local, v)
    return x


def _rows_into_whole_dim(x, dims, idx, values) -> bool:
    """``x[idx] = values`` (one index tensor of one dim on dim ``k``,
    values of x's rank) where no mesh dim splits x's dim ``k`` nor holds
    a partial sum or a strided split of x, and values match x's other
    dims: the moe's scatter of routed rows into its (E·C, d) buffer."""
    from torch.distributed.tensor import DTensor
    if idx is None or idx.dim() != 1 or not isinstance(values, DTensor) or \
            values.dim() != x.dim():
        return False
    k = dims[0]
    return all(_split_dim(p) != k and not p.is_partial() and not _strided(p)
               for p in x.placements) and \
        all(values.shape[d] == x.shape[d] for d in range(x.dim()) if d != k)


def _put_rows(func, x, k, idx, values, accumulate):
    """:func:`_rows_into_whole_dim`'s write, as torch 2.13's DTensor
    makes it: the indices gathered whole, the values placed as x (each
    split of another dim kept, dim ``k`` gathered), and each rank writing
    every row into its block (torch 2.11's DTensor runs it on whole
    tensors).  ``index_put`` writes into a copy of x, which may be cut:
    a mesh dim that copies x and splits the values keeps the values' split
    of another dim, or moves it to the innermost other dim it divides (an
    all-to-all), x cut alike, innermost mesh dim first."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    mesh = x.device_mesh
    target = list(x.placements)
    if func is torch.ops.aten.index_put.default:
        taken = {_split_dim(p) for p in target} - {None}
        for m in reversed(range(mesh.ndim)):
            e, n = _split_dim(values.placements[m]), mesh.shape[m]
            if not target[m].is_replicate() or e is None or \
                    _strided(values.placements[m]):
                continue
            if e == k or e in taken:
                e = next((d for d in reversed(range(x.dim()))
                          if d != k and d not in taken and
                          x.shape[d] % n == 0), None)
            if e is not None:
                target[m] = Shard(e)
                taken.add(e)
    target = tuple(target)
    whole = (Replicate(),) * mesh.ndim
    v = _to(values, target)._local_tensor
    i = _to(idx, whole)._local_tensor if isinstance(idx, DTensor) else idx
    local = [None] * x.dim()
    local[k] = i
    if func is torch.ops.aten.index_put_.default:
        func(x._local_tensor, local, v, accumulate)
        return x
    x = _cut(x, target)
    return _dtensor(func(x._local_tensor, local, v, accumulate), *_like(x))


def _masked_sum(func, args, kwargs):
    """An op on a masked partial sum (the full CE's gather of each rank's
    vocab block, summed into the loss): each such mesh dim reduced by an
    all-reduce of the local block, as the sum it stands for, and the op
    then DTensor's.  torch 2.11's DTensor reduces it through the mask the
    gather left, whose shape the sum no longer has, and fails."""
    from torch.distributed.tensor import DTensor, Partial, Replicate

    def reduced(x):
        if not isinstance(x, DTensor) or not any(
                p.is_partial() and type(p) is not Partial
                for p in x.placements):
            return x
        mesh, t, placements = x.device_mesh, x._local_tensor, []
        for m, p in enumerate(x.placements):
            if p.is_partial() and type(p) is not Partial:
                t = _all_reduce(t, p.reduce_op, mesh, [m])
                p = Replicate()
            placements.append(p)
        return _from_local(t, mesh, placements, x.shape, x.stride())
    return _unhandled(func, tuple(reduced(a) for a in args), kwargs)


def _cut_to_split(func, args, kwargs):
    """A broadcasting product where a mesh dim copies one operand and
    splits the other on a dim the first holds at full size (hymba's SSM
    input times its conv weight, the weight split over model): the copy
    cut alike (a local slice, no byte moved), as torch 2.13's DTensor lays
    it out; 2.11's gathers the split operand instead, and the whole SSD
    path after it then runs copied over model.  Then DTensor's rule."""
    from torch.distributed.tensor import DTensor, Shard
    a, b = args[:2]
    if not (isinstance(a, DTensor) and isinstance(b, DTensor)) or any(
            not (p.is_shard() or p.is_replicate()) or _strided(p)
            for p in a.placements + b.placements):
        return _unhandled(func, args, kwargs)
    cuts = {id(a): list(a.placements), id(b): list(b.placements)}
    for m, n in enumerate(a.device_mesh.shape):
        for x, y in ((a, b), (b, a)):
            p, q = x.placements[m], y.placements[m]
            if not (p.is_shard() and q.is_replicate()):
                continue
            d = p.dim + y.dim() - x.dim()        # the same dim of y
            if d >= 0 and y.shape[d] == x.shape[p.dim] > 1 and \
                    y.shape[d] % n == 0 and \
                    not any(r.is_shard(d) for r in cuts[id(y)]):
                cuts[id(y)][m] = Shard(d)
    if cuts[id(a)] == list(a.placements) and \
            cuts[id(b)] == list(b.placements):
        return _unhandled(func, args, kwargs)
    return _unhandled(func, (_cut(a, cuts[id(a)]), _cut(b, cuts[id(b)]),
                             *args[2:]), kwargs)


def _free_dims(func, args):
    """(the dims of ``func``'s first operand it maps over, one operand and
    output dim each, alike in every operand and output; whether a partial
    sum passes through), or None where the op is not of this form."""
    aten = torch.ops.aten
    x, nd = args[0], args[0].dim()
    if func is aten.roll.default:
        dims = args[2] if len(args) > 2 else []
        busy = {d % nd for d in dims} if dims else set(range(nd))
        return [d for d in range(nd) if d not in busy], True
    if func is aten.flip.default:
        busy = {d % nd for d in args[1]}
        return [d for d in range(nd) if d not in busy], True
    if func is aten.constant_pad_nd.default:
        pad = list(args[1])
        busy = {nd - 1 - i for i in range(len(pad) // 2)
                if pad[2 * i] or pad[2 * i + 1]}
        value = args[2] if len(args) > 2 else 0
        return [d for d in range(nd) if d not in busy], value == 0
    if func is aten.diagonal_backward.default:
        sizes, offset, d1, d2 = args[1:5]
        n = len(sizes)
        if offset or {d1 % n, d2 % n} != {n - 2, n - 1}:
            return None
        return list(range(n - 2)), True
    if func is aten.linalg_solve_triangular.default and \
            args[1].dim() != nd:
        return None
    return list(range(nd - 2)), False      # the batched linalg ops


def _mapped(func, args, kwargs):
    """An op that maps over some dims of its operands and works along the
    others (``roll`` and ``flip`` along theirs, ``constant_pad_nd`` along
    its padded dims, the batched Cholesky, triangular solve and
    ``diagonal`` gradient of the Gram log-volume along the last two), by
    torch 2.13's rule: each split of a mapped dim kept, each split of
    another dim moved to the innermost mapped dim it divides (an
    all-to-all, on its own mesh dim, where 2.13's planner may land it on
    another of the same bytes) or else gathered, a copy kept, a partial
    sum kept where the op is linear and reduced where not; every operand
    placed alike and each rank's block computed.  torch 2.11's DTensor
    has no such rule and runs these ops on whole tensors
    (:func:`_run_replicated`)."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    x = args[0]
    form = _free_dims(func, args) if isinstance(x, DTensor) else None
    operands = [a for a in args if isinstance(a, DTensor)]
    if form is None or any(_strided(p) for a in operands
                           for p in a.placements) or \
            any(a.placements != x.placements for a in operands[1:]
                if any(p.is_partial() for p in a.placements)):
        return _unhandled(func, args, kwargs)
    free, linear = form
    mesh = x.device_mesh
    parts = [1] * x.dim()
    for n, p in zip(mesh.shape, x.placements):
        if p.is_shard() and p.dim in free:
            parts[p.dim] *= n
    target = []
    for n, p in zip(mesh.shape, x.placements):
        if p.is_shard() and p.dim in free:
            target.append(p)
        elif p.is_shard():
            into = next((d for d in reversed(free)
                         if x.shape[d] % (parts[d] * n) == 0 and not any(
                             q.is_shard(d) for q in x.placements)), None)
            if into is not None:
                parts[into] *= n
            target.append(Replicate() if into is None else Shard(into))
        else:
            target.append(p if p.is_replicate() or linear else Replicate())
    target = tuple(target)
    local = [_to(a, target)._local_tensor if isinstance(a, DTensor) else a
             for a in args]
    if func is torch.ops.aten.diagonal_backward.default:
        sizes = list(local[1])          # the output's sizes, made local
        for n, p in zip(mesh.shape, target):
            if p.is_shard():
                sizes[p.dim] //= n
        local[1] = sizes
    out = func(*local, **kwargs)

    def wrap(t):
        shape = list(t.shape)
        for n, p in zip(mesh.shape, target):
            if p.is_shard():
                shape[p.dim] *= n
        return _dtensor(t, mesh, target, shape)
    return torch.utils._pytree.tree_map_only(torch.Tensor, wrap, out)


def _prod(xs) -> int:
    n = 1
    for x in xs:
        n *= x
    return n


class VersionGap(NamedTuple):
    """Where DTensor's own handling of an op (or of a step of its
    dispatch) differs between the torch versions the dry run runs on:
    what DTensor does there, the versions it was seen on, the dry run's
    answer (a function of this module, the handler of each op it keys in
    :func:`_handlers`), and the test of ``tests/test_torch_dryrun_parity
    .py`` that holds the answer."""
    wrong: str
    seen_on: tuple
    answer: str
    test: str


_VIEWS = "aten.view.default aten._unsafe_view.default"
_LINALG = ("aten.linalg_cholesky_ex.default aten.cholesky_inverse.default "
           "aten.linalg_solve_triangular.default "
           "aten.diagonal_backward.default")

# every workaround of a torch-version gap, keyed by the ops it covers (a
# space-separated key covers each); the card's host has torch 2.11, this
# repository's CPU tests 2.13
VERSION_GAPS = {
    _VIEWS: VersionGap(
        "dims merged where an inner one is split (attention's einsum over "
        "batch and heads, both split; the SSM decode's over batch and "
        "heads; the moe's experts and slots): 2.11 gathers the inner dim "
        "(``view`` raises; ``_unsafe_view`` all-gathers: 2,013,281,280 B a "
        "rank at whisper-medium decode_32k), where 2.13 makes a strided "
        "split (:func:`_strided_view`); merged otherwise with more than "
        "their outermost split, 2.11 raises", ("2.11",), "_view",
        "test_ring_attention_keeps_batch_and_heads_split"),
    "aten.mm.default": VersionGap(
        "rows merged from a batch and a sequence both split (the strided "
        "split of :func:`_strided_view`) meeting a weight split on its "
        "contracting dim (gemma-2b's projections at prefill_32k): 2.11 "
        "keeps the rows strided through the product, or fails it; 2.13 "
        "gathers them first", ("2.11",), "_matmul",
        "test_merged_rows_are_gathered_before_a_matmul"),
    "aten.mul.Tensor": VersionGap(
        "a broadcasting product of a copy and an operand split on a dim "
        "the copy holds whole (hymba's SSM input times its conv weight): "
        "2.11 gathers the split operand, 2.13 cuts the copy (free)",
        ("2.11",), "_cut_to_split",
        "test_product_cuts_the_copy_to_the_split"),
    "aten.index.Tensor": VersionGap(
        "a lookup in a table split on its rows (the ring read through a "
        "block table): 2.11 gathers the table", ("2.11",), "_index",
        "test_toy_decode_cell_against_the_reference_dry_run"),
    "aten.index_put_.default": VersionGap(
        "a write at the same indices into a dim every rank holds whole "
        "(a prefill's ring, the moe's buffer of routed rows): 2.11 has no "
        "rule and runs it on whole tensors", ("2.11",), "_index_put",
        "test_moe_buffer_write_gathers_only_the_rows"),
    "aten.index_put.default": VersionGap(
        "the same write into a copy (the moe buffer's gradient): 2.11 "
        "runs it on whole tensors", ("2.11",), "_index_put",
        "test_moe_buffer_write_gathers_only_the_rows"),
    "aten.roll.default aten.flip.default aten.constant_pad_nd.default":
        VersionGap(
        "roll along a split batch dim (the CCL loss's negatives), flip and "
        "pad along a split sequence (the SSD's chunks): 2.11 has no rule "
        "and runs them on whole tensors; 2.13 moves the split to a dim the "
        "op maps over", ("2.11",), "_mapped",
        "test_roll_and_pad_move_the_split_off_their_dims"),
    _LINALG: VersionGap(
        "the batched Cholesky, triangular solve and diagonal gradient of "
        "the Gram log-volume: 2.11 has no rule and runs them on whole "
        "tensors; 2.13 maps them over the batch", ("2.11",), "_mapped",
        "test_gram_linalg_maps_over_the_batch"),
    "aten.add.Tensor": VersionGap(
        "a masked partial sum (the full CE's gather, summed into the "
        "loss) met by an add: 2.11 reduces it through the gather's mask, "
        "which no longer fits, and fails", ("2.11",), "_masked_sum",
        "test_masked_sum_is_reduced_before_an_add"),
    "aten.detach_.default": VersionGap(
        "``redistribute`` of a tensor that needs a gradient calls "
        "``detach_``, which DTensor has no rule for", ("2.11",), "_to",
        "test_constrain_places_a_dtensor_and_its_gradient"),
    "ShardingPropagator._propagate_tensor_meta_non_cached": VersionGap(
        "DTensor runs its output-shape pass on global shapes outside the "
        "uncached propagation too, ops that are no rank's", ("2.11",),
        "_marking_propagation", "test_split_ops_are_the_dry_runs_only"),
    "DTensor.placements": VersionGap(
        "some DTensors carry fewer placements than mesh dims (the "
        "missing ones replicate)", ("2.11",), "_whole",
        "test_toy_cell_against_the_reference_dry_run"),
}


def _handlers():
    """{op: the dry run's split form of it} (see each handler)."""
    aten = torch.ops.aten
    return {aten._softmax.default: _softmax,
            aten._log_softmax.default: _softmax,
            aten._softmax_backward_data.default: _softmax_backward,
            aten._log_softmax_backward_data.default: _softmax_backward,
            aten.new_zeros.default: _new_zeros,
            aten.scatter_add.default: _scatter_add,
            aten.mm.default: _matmul, aten.bmm.default: _matmul,
            aten.view.default: _view, aten._unsafe_view.default: _view,
            aten.slice.Tensor: _slice, aten.select.int: _select,
            aten.index.Tensor: _index, aten.index_put_.default: _index_put,
            aten.index_put.default: _index_put,
            aten.add.Tensor: _masked_sum, aten.mul.Tensor: _cut_to_split,
            aten.roll.default: _mapped, aten.flip.default: _mapped,
            aten.constant_pad_nd.default: _mapped,
            aten.linalg_cholesky_ex.default: _mapped,
            aten.cholesky_inverse.default: _mapped,
            aten.linalg_solve_triangular.default: _mapped,
            aten.diagonal_backward.default: _mapped}


@contextlib.contextmanager
def _split_ops():
    """Give DTensor the split forms of :func:`_handlers`' ops for the
    duration (its custom-handler table, as ``loss_parallel`` does); each
    falls back to DTensor's own rule where its dim is not split."""
    from torch.distributed.tensor import DTensor
    table = DTensor._op_dispatcher._custom_op_handlers
    mine = _handlers()
    clash = set(mine) & set(table)
    if clash:
        raise RuntimeError(
            f"DTensor already handles {sorted(map(str, clash))}")
    table.update(mine)
    try:
        yield
    finally:
        for op in mine:
            table.pop(op, None)


def _whole(x):
    """A DTensor's local block made whole, each mesh dim's split undone on
    the local tensor (innermost first): an all-gather for a shard (cut to
    the global size: an uneven split pads its last blocks), an all-reduce
    for a partial sum; then laid out with the DTensor's global strides, as
    a view of it expects.  The functional collectives are this rank's
    local ops, so the caller's mode counts them."""
    from torch.distributed.tensor import Partial
    c10d = torch.ops._c10d_functional
    mesh, t = x.device_mesh, x._local_tensor
    # (a DTensor may carry fewer placements than mesh dims: torch 2.11
    # makes some with one; the missing ones replicate)
    for dim, p in reversed(list(enumerate(x.placements))):
        group = mesh.get_group(dim)
        if p.is_shard():
            g = c10d.all_gather_into_tensor(t.movedim(p.dim, 0).contiguous(),
                                            group.size(), group.group_name)
            t = c10d.wait_tensor(g).movedim(0, p.dim)
        elif isinstance(p, Partial):
            t = c10d.wait_tensor(c10d.all_reduce(t, p.reduce_op,
                                                 group.group_name))
    if any(a < b for a, b in zip(t.shape, x.shape)):
        # DTensor left a block that disagrees with its placements (seen
        # over three mesh dims): what was gathered is counted, and the op
        # gets a whole tensor of the global shape (fake: shapes are all
        # that count here)
        t = t.new_empty(x.shape)
    t = t[tuple(slice(0, n) for n in x.shape)]
    if t.stride() != x.stride():
        # (a method of the fake block, so fake: a factory function here,
        # outside the fake mode, would allocate the whole tensor)
        t = t.new_empty_strided(x.shape, x.stride()).copy_(t)
    return t


def _block(t, placements, mesh):
    """This rank's block of a whole tensor under ``placements`` (a local
    chunk per split mesh dim, outermost first; no collective)."""
    coord = mesh.get_coordinate()
    for dim, p in enumerate(placements):
        if p.is_shard():
            t = torch.chunk(t, mesh.shape[dim], p.dim)[coord[dim]]
    return t


def _run_replicated(func, args, kwargs):
    """``func`` on every rank's whole tensors: each DTensor input made
    whole (:func:`_whole`: the collectives are counted), the op run on
    them, each input it writes cut back to its block and copied into it,
    and each new output a replicated DTensor.  DTensor's own dispatch is
    not used, since it is what failed."""
    from torch.distributed.tensor import DTensor, Replicate
    leaves = torch.utils._pytree.tree_leaves((args, kwargs))
    mesh = next(a.device_mesh for a in leaves if isinstance(a, DTensor))
    whole = {}

    def local(x):
        if isinstance(x, DTensor):
            whole[id(x)] = _whole(x)
            return whole[id(x)]
        return x
    with torch.no_grad():
        largs, lkwargs = torch.utils._pytree.tree_map(local, (args, kwargs))
        out = func(*largs, **lkwargs)
        written = {}
        for a, value in zip(func._schema.arguments, args):
            if a.alias_info is not None and a.alias_info.is_write and \
                    isinstance(value, DTensor):
                w = whole[id(value)]
                value._local_tensor.copy_(_block(w, value.placements, mesh))
                written[id(w)] = value

        def wrap(t):
            if not isinstance(t, torch.Tensor):
                return t
            if id(t) in written:
                return written[id(t)]
            return DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim,
                                      run_check=False)
        return torch.utils._pytree.tree_map(wrap, out)


class RankCost(TorchDispatchMode):
    """Counts one rank's local ops (see the module docstring): ``flops``,
    ``bytes_accessed``, ``collectives`` and live storage (``peak_bytes``
    over the run, from ``track`` of the arguments on).

    An op on DTensors goes to DTensor, which calls its local ops back
    through this mode.  Where DTensor fails on the op (no sharding
    strategy, none for these placements, or local shapes it got wrong on
    an uneven split), the op runs again by :func:`_run_replicated`, on
    whole tensors on every rank: ``replicated`` counts those ops by name
    (what the failed try counted stays counted); an op that fails there
    too raises its error."""

    def __init__(self):
        super().__init__()
        self.flops = 0
        self.bytes_accessed = 0
        self.collectives: List[Collective] = []
        self.replicated: Dict[str, int] = {}
        self._live: Dict[int, int] = {}
        self.live_bytes = 0
        self.peak_bytes = 0
        self.read = set()           # ids of the storages an op read
        self._in_dtensor = False

    def track(self, tensors) -> int:
        """Count each storage of ``tensors`` live from now until it is
        freed; returns the bytes of those that were new."""
        new = 0
        for t in tensors:
            st = t.untyped_storage()
            key = id(st)
            if key in self._live:
                continue
            n = st.nbytes()
            self._live[key] = n
            self.live_bytes += n
            new += n
            weakref.finalize(st, self._free, key)
        self.peak_bytes = max(self.peak_bytes, self.live_bytes)
        return new

    def _free(self, key):
        self.live_bytes -= self._live.pop(key, 0)

    def _dtensor_op(self, func, args, kwargs):
        from torch._subclasses.fake_tensor import unset_fake_temporarily
        self._in_dtensor = True
        try:
            # DTensor's local ops come back here; the local blocks are fake
            # tensors, which dispatch to their own mode, while the small
            # index tensors DTensor makes and reads on the host to split
            # a dim unevenly stay real
            with unset_fake_temporarily(), self:
                try:
                    return func(*args, **kwargs)
                except Exception:  # noqa: BLE001
                    # DTensor's failures vary with the torch version (no
                    # strategy, none for these placements, an internal
                    # error on an uneven split): each sends the op to the
                    # replicated run, which raises where the op is at fault
                    name = str(func)
                    self.replicated[name] = self.replicated.get(name, 0) + 1
                    return _run_replicated(func, args, kwargs)
        finally:
            self._in_dtensor = False

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch._subclasses.fake_tensor import FakeTensor
        from torch.distributed.tensor import DTensor
        kwargs = kwargs or {}
        if any(issubclass(t, DTensor) for t in types) and \
                not self._in_dtensor and not getattr(_prop, "depth", 0):
            return self._dtensor_op(func, args, kwargs)
        if any(t is not torch.Tensor and not issubclass(t, FakeTensor)
               for t in types):
            return NotImplemented
        out = func(*args, **kwargs)
        if getattr(_prop, "depth", 0):
            return out
        outs = _tensors(out)
        from torch.utils.flop_counter import flop_registry
        packet = func._overloadpacket
        if packet in flop_registry:
            self.flops += flop_registry[packet](*args, **kwargs, out_val=out)
        name = func._opname
        if func.namespace in ("_c10d_functional", "_dtensor") and \
                name in _COLLECTIVE_OPS:
            self.collectives.append(Collective(
                _COLLECTIVE_OPS[name], sum(_nbytes(t) for t in outs),
                _group_size(func, args, kwargs)))
        ins = _tensors((args, kwargs))
        if not func.is_view and name != "wait_tensor":
            self.bytes_accessed += sum(_nbytes(t) for t in ins + outs)
        # what an op copies from (a view's schema may copy: ``to``); a
        # ``prim`` op (``prim.device``, which DTensor asks of every leaf a
        # layer's ``v[i]`` selects) reads metadata, not the storage
        in_ids = {id(t.untyped_storage()) for t in ins}
        if func.namespace != "prim" and (
                not func.is_view or any(id(t.untyped_storage()) not in in_ids
                                        for t in outs)):
            self.read.update(in_ids)
        self.track(outs)
        return out


@contextlib.contextmanager
def counting(cost: RankCost):
    """``cost`` counts the DTensor code run inside (under the caller's
    ``FakeTensorMode``), with plain tensors joining DTensors as
    replicated."""
    from torch.distributed.tensor.experimental import implicit_replication
    with _marking_propagation(), _all_to_all_on_cpu_meshes(), \
            _split_ops(), implicit_replication(), cost:
        yield cost


# ---------------------------------------------------------------------------
# placement

def _local_shape(shape, placements, mesh) -> tuple:
    from torch.distributed.tensor import Shard
    local = list(shape)
    for size, p in zip(mesh.shape, placements):
        if isinstance(p, Shard):
            if local[p.dim] % size:
                raise ValueError(f"dim {p.dim} of {tuple(shape)} does not "
                                 f"split over {size} ranks")
            local[p.dim] //= size
    return tuple(local)


def _place(tree, placements, mesh):
    """Each leaf of ``tree`` (global fake tensors) as a DTensor on ``mesh``
    whose local block is a new fake tensor of the local shape (no view of
    the global one, so its storage is the rank's).  A split over a mesh
    axis of one rank is no split: it is placed as replicated, which spares
    DTensor's redistribution planning on a (1, 1) mesh."""
    from torch.distributed.tensor import DTensor, Replicate
    if isinstance(tree, dict):
        return {k: _place(v, placements[k], mesh) for k, v in tree.items()}
    placements = tuple(Replicate() if size == 1 else p
                       for size, p in zip(mesh.shape, placements))
    local = torch.empty(_local_shape(tree.shape, placements, mesh),
                        dtype=tree.dtype)
    return DTensor.from_local(local, mesh, placements, run_check=False,
                              shape=tree.shape, stride=tree.stride())


def _placed(tree, placements, mesh):
    """``tree``'s DTensors redistributed to ``placements`` (a tree of the
    same structure; None keeps a subtree as it is), as the reference's
    ``out_shardings`` place its step's outputs."""
    from torch.distributed.tensor import DTensor, Replicate
    if placements is None:
        return tree
    if isinstance(tree, dict):
        return {k: _placed(v, placements.get(k), mesh)
                for k, v in tree.items()}
    if isinstance(tree, tuple):
        return tuple(_placed(v, p, mesh) for v, p in zip(tree, placements))
    if not isinstance(tree, DTensor):
        return tree
    return tree.redistribute(mesh, tuple(
        Replicate() if size == 1 else p
        for size, p in zip(mesh.shape, placements)))


def _locals(tree) -> List[torch.Tensor]:
    from torch.distributed.tensor import DTensor
    return [t.to_local() if isinstance(t, DTensor) else t
            for t in _tensors(tree)]


# ---------------------------------------------------------------------------
# the reference's model-level arithmetic

def model_flops(cfg, shape) -> float:
    """MODEL_FLOPS = 6*N*D (dense) / 6*N_active*D (MoE); decode D = batch
    (one token each)."""
    n = cfg.n_active_params()
    if shape.kind == "train":
        return 6.0 * n * shape.global_batch * shape.seq_len
    if shape.kind == "prefill":
        return 2.0 * n * shape.global_batch * shape.seq_len
    return 2.0 * n * shape.global_batch


def _apply_overrides(cfg, overrides):
    if not overrides:
        return cfg
    kw = {}
    for ov in overrides:
        k, v = ov.split("=", 1)
        cur = getattr(cfg, k)
        if isinstance(cur, bool):
            v = v.lower() in ("1", "true", "yes")
        elif isinstance(cur, int):
            v = int(v)
        elif isinstance(cur, float):
            v = float(v)
        kw[k] = v
    return dataclasses.replace(cfg, **kw)


# ---------------------------------------------------------------------------
# one combination

def _step(bundle, cfg, shape, mesh, rules, multi_pod, full_finetune,
          ccl_weight, use_mma):
    """(run, args): the step of ``shape.kind`` as a closure over DTensor
    arguments placed on ``mesh``, its outputs placed as the reference's
    ``out_shardings`` place them, and those arguments (a tree)."""
    from torch.distributed.tensor import Replicate
    params_st = S.model_structs(bundle)
    p_sh = S.shardings(param_pspecs(params_st, rules, mesh), mesh)
    params = _place(params_st, p_sh, mesh)
    repl = (Replicate(),) * mesh.ndim
    bsz = mesh_axis_sizes(mesh)

    if shape.kind == "train":
        opt = adamw(1e-4)
        step = make_train_step(bundle, opt, full_finetune=full_finetune,
                               ccl_weight=ccl_weight,
                               use_mma_weights=use_mma)
        pred = (lora_lib.all_trainable if full_finetune
                else lora_lib.default_trainable)
        train_st = lora_lib.partition(params_st, pred)
        opt_st = opt.init(train_st)
        t_sh = S.shardings(param_pspecs(train_st, rules, mesh), mesh)
        opt_state = {"step": _place(opt_st["step"], repl, mesh),
                     "mu": _place(opt_st["mu"], t_sh, mesh),
                     "nu": _place(opt_st["nu"], t_sh, mesh)}
        batch = _place(S.train_batch_structs(cfg, shape, device="cpu"),
                       S.shardings(S.train_batch_pspecs(cfg, rules), mesh),
                       mesh)
        o_sh = {"step": repl, "mu": t_sh, "nu": t_sh}
        return (lambda: _placed(step(params, opt_state, batch),
                                (p_sh, o_sh, None), mesh),
                (params, opt_state, batch))

    if shape.kind == "prefill":
        B, T = shape.global_batch, shape.seq_len
        b_st = {"tokens": torch.empty((B, T), dtype=torch.int32)}
        b_specs = {"tokens": rules.spec("batch", None)}
        if cfg.frontend:
            b_st["frontend_embeds"] = torch.empty(
                (B, cfg.frontend_tokens, cfg.frontend_dim),
                dtype=cfg.torch_dtype)
            b_specs["frontend_embeds"] = rules.spec("batch", None, None)
        batch = _place(b_st, S.shardings(b_specs, mesh), mesh)

        def prefill():
            logits, cache = bundle.prefill(params, batch)
            c_specs = S.cache_pspecs(cfg, cache, mesh, multi_pod)
            return _placed((logits, cache),
                           (repl, S.shardings(c_specs, mesh)), mesh)
        return prefill, (params, batch)

    cache_st = bundle.init_cache(shape.global_batch, shape.seq_len, "cpu")
    c_sh = S.shardings(S.cache_pspecs(cfg, cache_st, mesh, multi_pod), mesh)
    cache = _place(cache_st, c_sh, mesh)
    inp = S.decode_batch_structs(cfg, shape, device="cpu")
    tok_spec = Spec(rules.axis("batch"), None) \
        if shape.global_batch % bsz["data"] == 0 else Spec(None, None)
    toks = _place(inp["tokens"], S.shardings(tok_spec, mesh), mesh)
    serve = make_serve_step(bundle)
    out_sh = (S.shardings(Spec(tok_spec[0], "model"), mesh), c_sh)
    return (lambda: _placed(serve(params, cache, toks, inp["pos"]), out_sh,
                            mesh),
            (params, cache, toks))


def dryrun_one(arch: str, shape_name: str, multi_pod: bool = False,
               full_finetune: bool = False, ccl_weight: float = 0.5,
               use_mma: bool = True, extra_tag: str = "",
               overrides=None, *, mesh=None,
               shape: Optional[InputShape] = None) -> dict:
    """The dry run of one (arch x shape) combination.  ``mesh`` (a
    DeviceMesh over a fake group the caller started) and ``shape`` (an
    :class:`InputShape` in place of ``INPUT_SHAPES[shape_name]``) replace
    the production mesh and the assigned shape; by default this starts a
    fake group of the production mesh's size and ends it on return."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    shape = shape or INPUT_SHAPES[shape_name]
    cfg = S.variant_for_shape(get_config(arch), shape)
    cfg = _apply_overrides(cfg, overrides)
    bundle = build_model(cfg)
    rules = rules_for("decode" if shape.kind == "decode" else "train",
                      multi_pod)
    with contextlib.ExitStack() as stack:
        if mesh is None:
            import torch.distributed as dist
            fake_world(512 if multi_pod else 256)
            stack.callback(dist.destroy_process_group)
            mesh = make_production_mesh(multi_pod=multi_pod,
                                        device_type="cpu")
        t0 = time.time()
        stack.enter_context(FakeTensorMode(allow_non_fake_inputs=True))
        stack.enter_context(sharding_context(mesh, rules))
        run, args = _step(bundle, cfg, shape, mesh, rules, multi_pod,
                          full_finetune, ccl_weight, use_mma)
        cost = RankCost()
        arg_bytes = cost.track(_locals(args))
        t_lower = time.time() - t0
        with counting(cost):
            out = run()
        t_compile = time.time() - t0 - t_lower
        arg_st = {id(t.untyped_storage()): t.untyped_storage().nbytes()
                  for t in _locals(args)}
        out_st = {id(t.untyped_storage()): t.untyped_storage().nbytes()
                  for t in _locals(out)}
        # as jit's keep_unused=False: an argument no op reads and no
        # output holds is not one
        mem = {"argument_size_in_bytes": sum(
                   n for k, n in arg_st.items()
                   if k in cost.read or k in out_st),
               "output_size_in_bytes": sum(n for k, n in out_st.items()
                                           if k not in arg_st),
               "alias_size_in_bytes": sum(n for k, n in out_st.items()
                                          if k in arg_st),
               "temp_size_in_bytes": cost.peak_bytes - arg_bytes}
        chips = n_chips(mesh)
        del out, run, args
    coll = collective_bytes(cost.collectives)
    flops_dev = float(cost.flops)
    bytes_dev = float(cost.bytes_accessed)
    mf = model_flops(cfg, shape)
    param_bytes_dev = 2.0 * cfg.n_params() / chips      # bf16
    reads = {"train": 3.0, "prefill": 1.0, "decode": 1.0}[shape.kind]
    terms = {
        "compute_s": flops_dev / PEAK_FLOPS_BF16,
        "compute_s_analytic": (mf / chips) / PEAK_FLOPS_BF16,
        "memory_s": bytes_dev / HBM_BW,
        "memory_s_analytic": reads * param_bytes_dev / HBM_BW,
        "collective_s": coll["total_bytes"] / NVLINK_BW,
    }
    dom = max(("compute_s_analytic", "memory_s_analytic", "collective_s"),
              key=lambda k: terms[k])
    return {
        "arch": arch, "shape": shape.name, "variant": cfg.name,
        "mesh": "2x16x16" if multi_pod else "16x16", "chips": chips,
        "kind": shape.kind,
        "mode": ("full_ft" if full_finetune else "mlecs") + extra_tag,
        "lower_s": round(t_lower, 1), "compile_s": round(t_compile, 1),
        "cost_analysis": {"flops": flops_dev, "bytes accessed": bytes_dev},
        "memory_analysis": mem,
        "collectives": coll,
        "model_flops_total": mf,
        "model_flops_per_chip": mf / chips,
        "useful_flops_frac": (mf / chips) / flops_dev if flops_dev else None,
        "roofline": {**terms, "dominant": dom},
        "layers_per_body": 1,
        "n_params": cfg.n_params(), "n_active_params": cfg.n_active_params(),
        "n_lora_params": cfg.n_lora_params(),
        "path": PATH,
        "replicated_ops": dict(sorted(cost.replicated.items())),
        "torch": torch.__version__,
    }


def _in_processes(args, combos):
    """``main`` for each combination in a child process of its own,
    ``args.jobs`` at once; each child's output printed when it ends."""
    import subprocess
    import sys
    from concurrent.futures import ThreadPoolExecutor
    flags = [f for f, on in (("--multi-pod", args.multi_pod),
                             ("--full-finetune", args.full_finetune),
                             ("--no-mma", args.no_mma),
                             ("--skip-existing", args.skip_existing)) if on]
    flags += ["--ccl-weight", str(args.ccl_weight), "--out-dir",
              args.out_dir] + [a for ov in args.overrides
                               for a in ("--set", ov)]
    flags += ["--tag", args.tag] if args.tag else []

    def one(combo):
        done = subprocess.run(
            [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
             combo[0], "--shape", combo[1], *flags], capture_output=True,
            text=True)
        print(done.stdout + done.stderr, end="", flush=True)
        return done.returncode
    with ThreadPoolExecutor(args.jobs) as pool:
        failed = [c for c, rc in zip(combos, pool.map(one, combos)) if rc]
    if failed:
        print("FAILURES:", *failed)
        raise SystemExit(1)
    print("all dry-runs passed")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ASSIGNED + ["mlecs-slm-720m",
                                                  "mlecs-llm-6b"])
    ap.add_argument("--shape", choices=list(INPUT_SHAPES))
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--full-finetune", action="store_true",
                    help="Multi-FedAvg baseline (all-param gradients)")
    ap.add_argument("--no-mma", action="store_true")
    ap.add_argument("--ccl-weight", type=float, default=0.5)
    ap.add_argument("--out-dir", default="experiments/dryrun_torch")
    ap.add_argument("--skip-existing", action="store_true")
    ap.add_argument("--set", action="append", default=[], dest="overrides",
                    help="config override key=value (e.g. n_layers=1)")
    ap.add_argument("--tag", default="", help="suffix for the output file")
    ap.add_argument("--jobs", type=int, default=1,
                    help="combinations run at once, each in a process of "
                         "its own (one fake group a process)")
    args = ap.parse_args(argv)

    os.makedirs(args.out_dir, exist_ok=True)
    if args.all:
        combos = [(a, s) for a in ASSIGNED for s in INPUT_SHAPES]
    else:
        if not (args.arch and args.shape):
            ap.error("--arch/--shape or --all")
        combos = [(args.arch, args.shape)]
    if args.jobs > 1 and len(combos) > 1:
        return _in_processes(args, combos)

    failures = []
    for arch, shp in combos:
        tag = "__mp" if args.multi_pod else ""
        mode = "__fft" if args.full_finetune else ""
        if args.tag:
            mode += f"__{args.tag}"
        name = f"{arch}__{shp}{tag}{mode}.json"
        path = os.path.join(args.out_dir, name)
        if args.skip_existing and os.path.exists(path):
            print(f"[skip] {name}")
            continue
        print(f"[dryrun] {arch} x {shp} mesh="
              f"{'2x16x16' if args.multi_pod else '16x16'} ...", flush=True)
        try:
            res = dryrun_one(arch, shp, args.multi_pod, args.full_finetune,
                             ccl_weight=args.ccl_weight,
                             use_mma=not args.no_mma,
                             extra_tag=f"__{args.tag}" if args.tag else "",
                             overrides=args.overrides)
            with open(path, "w") as f:
                json.dump(res, f, indent=1)
            r = res["roofline"]
            print(f"  OK lower={res['lower_s']}s compile={res['compile_s']}s "
                  f"compute={r['compute_s']:.4f}s memory={r['memory_s']:.4f}s "
                  f"collective={r['collective_s']:.4f}s dom={r['dominant']}",
                  flush=True)
        except Exception as e:
            traceback.print_exc()
            failures.append((arch, shp, str(e)[:200]))
    if failures:
        print("FAILURES:")
        for f in failures:
            print(" ", f)
        raise SystemExit(1)
    print("all dry-runs passed")


if __name__ == "__main__":
    main()
