"""Mesh construction on ``torch.distributed`` (port of
``repro.launch.mesh``).

Every builder returns ``torch.distributed.device_mesh.DeviceMesh``es over
the ranks of the default process group, with the reference's axis names
("data", "model"; "pod" for two pods).  The caller starts the process
group first (``torch.distributed.init_process_group``: NCCL on the card,
gloo on the CPU, with its address, world size and rank); no builder
starts one or falls back to a CPU group.  Every rank calls a builder with
the same arguments, since a mesh's process groups are made by all ranks
together.  ``device_type`` is ``"cuda"`` unless the caller asks for
``"cpu"``.
"""
from __future__ import annotations

import os

import torch

_TCMALLOC_CANDIDATES = (
    "/usr/lib/x86_64-linux-gnu/libtcmalloc.so.4",
    "/usr/lib/x86_64-linux-gnu/libtcmalloc_minimal.so.4",
    "/usr/lib/libtcmalloc.so.4",
)

# One NVIDIA H100 SXM (80 GB HBM3) at its full power limit of 700 W, from
# NVIDIA's data sheet (dense rates, no sparsity); a card set below 700 W
# (nvidia-smi's power.limit) runs slower under load.
PEAK_FLOPS_BF16 = 989e12      # FLOP/s, bf16 tensor cores; H100 SXM, 700 W
PEAK_FLOPS_F32 = 67e12        # FLOP/s, f32 outside the tensor cores; 700 W
HBM_BW = 3.35e12              # B/s, HBM3; H100 SXM, 700 W
NVLINK_BW = 900e9             # B/s a GPU, NVLink 4 (18 links, both
                              # directions together); H100 SXM, 700 W


def setup_host_env() -> dict:
    """The host-environment hint of the reference's ``setup_host_env``
    that applies to this package: whether tcmalloc is preloaded (it must
    be, through ``LD_PRELOAD``, before the process starts), for the
    client store's large host buffers.  The reference's other variables
    configure XLA's runtime, which this package does not use.  Returns
    the dict of what it set or found, for logging."""
    changed = {}
    if "tcmalloc" in os.environ.get("LD_PRELOAD", ""):
        os.environ.setdefault(
            "TCMALLOC_LARGE_ALLOC_REPORT_THRESHOLD", "60000000000")
        changed["TCMALLOC_LARGE_ALLOC_REPORT_THRESHOLD"] = (
            os.environ["TCMALLOC_LARGE_ALLOC_REPORT_THRESHOLD"])
    elif any(os.path.exists(c) for c in _TCMALLOC_CANDIDATES):
        changed["hint"] = ("tcmalloc available but not preloaded; start "
                           "the process with LD_PRELOAD set to it")
    return changed


def _world() -> int:
    """The default process group's world size; raises without one."""
    import torch.distributed as dist
    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError(
            "no torch.distributed process group: call "
            "torch.distributed.init_process_group (NCCL on the card, gloo "
            "on the CPU) before building a mesh")
    return dist.get_world_size()


def _mesh(device_type: str, ranks, shape, names):
    from torch.distributed.device_mesh import DeviceMesh
    return DeviceMesh(device_type,
                      torch.as_tensor(list(ranks), dtype=torch.int64)
                      .reshape(shape), mesh_dim_names=names)


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str = "cuda"):
    """The (16, 16) ("data", "model") pod, or (2, 16, 16) ("pod", "data",
    "model") two pods, over the first 256 / 512 ranks."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    n = 1
    for s in shape:
        n *= s
    world = _world()
    if world < n:
        raise ValueError(f"a {shape} mesh needs {n} ranks; the process "
                         f"group has {world}")
    return _mesh(device_type, range(n), shape, axes)


def make_host_mesh(device_type: str = "cuda"):
    """A (1, 1) mesh on rank 0: one device runs the same SPMD code."""
    _world()
    return _mesh(device_type, [0], (1, 1), ("data", "model"))


def make_federated_mesh(n_model: int = 1, device_type: str = "cuda"):
    """The stacked engines' mesh: every rank joins the "data" axis, which
    the rules alias to the client axis, so the clients split across
    ranks; ``n_model`` ranks a data block share its clients (the experts'
    axis).  At world size 1 this is the (1, 1) host mesh."""
    n_model = max(1, n_model)
    n_data = max(1, _world() // n_model)
    return _mesh(device_type, range(n_data * n_model), (n_data, n_model),
                 ("data", "model"))


def cohort_rank_slices(world: int, n_cohorts: int, n_model: int = 1):
    """The ranks of each cohort's mesh in :func:`make_cohort_meshes`, as
    ``[(ranks, (n_data, n_model)), ...]``: the ranks split evenly, leading
    cohorts taking the remainder; ``n_model`` clamped to a slice, and a
    slice that is not a multiple of it drops its tail ranks; with fewer
    ranks than cohorts the surplus cohorts share the last rank."""
    ranks = list(range(world))
    base, rem = divmod(world, n_cohorts)
    out, lo = [], 0
    for c in range(n_cohorts):
        take = base + (1 if c < rem else 0)
        if take == 0:               # more cohorts than ranks
            sl = [ranks[-1]]
        else:
            sl = ranks[lo:lo + take]
            lo += take
        nm = max(1, min(n_model, len(sl)))
        n_data = len(sl) // nm
        out.append((sl[:n_data * nm], (n_data, nm)))
    return out


def make_cohort_meshes(n_cohorts: int, n_model: int = 1,
                       device_type: str = "cuda"):
    """Disjoint per-cohort ("data", "model") meshes (the overlap engine's
    ``mesh=[...]`` form) on :func:`cohort_rank_slices`' ranks: cohorts of
    different architectures run their device phases at once, each on its
    own ranks, the "data" axis carrying the cohort's clients."""
    return [_mesh(device_type, ranks, shape, ("data", "model"))
            for ranks, shape in cohort_rank_slices(_world(), n_cohorts,
                                                   n_model)]


def mesh_axis_sizes(mesh) -> dict:
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


def n_chips(mesh) -> int:
    return mesh.size()
