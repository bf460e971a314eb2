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
* :class:`RankCost`, a dispatch mode beneath DTensor, sees each rank's
  local ops and counts: matmul FLOP on local shapes (``torch.utils.
  flop_counter``'s formulas; elementwise ops count none), bytes accessed
  (the input and output bytes of every local op but views: no fusion, so
  an upper bound on what a fused step moves), memory (argument bytes: the
  local params, optimizer state, batch and cache; output bytes: outputs
  that alias no argument; temp bytes: the peak of live local storage
  minus the arguments) and every collective (op, output bytes, group
  size), which :func:`collective_bytes` turns into per-rank traffic by the
  reference's ring formulas.  The ops DTensor runs on global shapes to
  propagate metadata are not a rank's and are not counted.

Differences from the reference, each a reason its numbers differ:

* the path is the plain twins of ``kernels/ops.py`` (what the port runs on
  CPU tensors), not the card's kernels, as the reference costs its jnp
  path and not its Pallas kernels; the JSON says so under ``"path"``;
* the activations' layouts are DTensor's sharding propagation's, op by op
  from the params' and inputs' placements: the port's model calls no
  ``constrain`` (``sharding/partition.py``), so none of the reference's
  activation hints reach it.  Where propagation replicates a large
  activation, every rank computes and holds it, and the terms show it;
* the port runs every layer in Python, so each collective is seen once per
  issue and no scan-trip multiplier applies (``layers_per_body`` is 1);
* the collective term is bytes over ``NVLINK_BW``, one H100 SXM's NVLink
  rate: past one 8-GPU node the fabric is slower, so the term is a lower
  bound there;
* ``lower_s`` is the host seconds to build and place the inputs and
  ``compile_s`` those of the fake step (the reference's lowering and XLA
  compile).

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch gemma-2b --shape train_4k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--multi-pod]
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
from repro_torch.sharding.partition import param_pspecs
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
    are no rank's.  Mark them by wrapping the propagator's uncached path
    for the duration.  It runs outside the dry run's ``FakeTensorMode``:
    it makes fake tensors of its own, and the small index tensors it reads
    on the host to split a dim unevenly must be real."""
    from torch.distributed.tensor._sharding_prop import ShardingPropagator
    name = "propagate_op_sharding_non_cached"
    orig = getattr(ShardingPropagator, name, None)
    if orig is None:
        raise NotImplementedError(
            f"torch {torch.__version__}: ShardingPropagator has no {name}, "
            "so the dry run cannot tell DTensor's global-shape propagation "
            "from a rank's ops")

    def wrapped(self, *a, **k):
        from torch._subclasses.fake_tensor import unset_fake_temporarily
        _prop.depth = getattr(_prop, "depth", 0) + 1
        try:
            with unset_fake_temporarily():
                return orig(self, *a, **k)
        finally:
            _prop.depth -= 1
    setattr(ShardingPropagator, name, wrapped)
    try:
        yield
    finally:
        setattr(ShardingPropagator, name, orig)


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
        t = torch.empty_strided(x.shape, x.stride(), dtype=t.dtype,
                                device=t.device).copy_(t)
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
        if not func.is_view and name != "wait_tensor":
            self.bytes_accessed += sum(
                _nbytes(t) for t in _tensors((args, kwargs)) + outs)
        self.track(outs)
        return out


@contextlib.contextmanager
def counting(cost: RankCost):
    """``cost`` counts the DTensor code run inside (under the caller's
    ``FakeTensorMode``), with plain tensors joining DTensors as
    replicated."""
    from torch.distributed.tensor.experimental import implicit_replication
    with _marking_propagation(), _all_to_all_on_cpu_meshes(), \
            implicit_replication(), cost:
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
    arguments placed on ``mesh``, and those arguments (a tree)."""
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
        return (lambda: step(params, opt_state, batch),
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
        return lambda: bundle.prefill(params, batch), (params, batch)

    cache_st = bundle.init_cache(shape.global_batch, shape.seq_len, "cpu")
    c_sh = S.shardings(S.cache_pspecs(cfg, cache_st, mesh, multi_pod), mesh)
    cache = _place(cache_st, c_sh, mesh)
    inp = S.decode_batch_structs(cfg, shape, device="cpu")
    tok_spec = Spec(rules.axis("batch"), None) \
        if shape.global_batch % bsz["data"] == 0 else Spec(None, None)
    toks = _place(inp["tokens"], S.shardings(tok_spec, mesh), mesh)
    serve = make_serve_step(bundle)
    return (lambda: serve(params, cache, toks, inp["pos"]),
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
        run, args = _step(bundle, cfg, shape, mesh, rules, multi_pod,
                          full_finetune, ccl_weight, use_mma)
        cost = RankCost()
        arg_bytes = cost.track(_locals(args))
        t_lower = time.time() - t0
        with counting(cost):
            out = run()
        t_compile = time.time() - t0 - t_lower
        arg_ids = {id(t.untyped_storage()) for t in _locals(args)}
        out_st = {id(t.untyped_storage()): t.untyped_storage().nbytes()
                  for t in _locals(out)}
        mem = {"argument_size_in_bytes": arg_bytes,
               "output_size_in_bytes": sum(n for k, n in out_st.items()
                                           if k not in arg_ids),
               "alias_size_in_bytes": sum(n for k, n in out_st.items()
                                          if k in arg_ids),
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
    }


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
    args = ap.parse_args(argv)

    os.makedirs(args.out_dir, exist_ok=True)
    if args.all:
        combos = [(a, s) for a in ASSIGNED for s in INPUT_SHAPES]
    else:
        if not (args.arch and args.shape):
            ap.error("--arch/--shape or --all")
        combos = [(args.arch, args.shape)]

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
