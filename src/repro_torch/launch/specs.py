"""Shape stand-ins and :class:`Spec` trees for every model input (port of
``repro.launch.specs``): the dry run (``launch/dryrun.py``) places these
as DTensors and costs one step on them, allocating nothing.

The reference's ``jax.ShapeDtypeStruct`` becomes a fake tensor (made under
the caller's ``FakeTensorMode``) or a meta tensor: shape and dtype, no
storage.  Its ``PartitionSpec`` becomes the port's :class:`Spec`, and its
``NamedSharding`` DTensor placements (:func:`shardings`).

The port's caches have the reference's layout, leaf for leaf: ring K / V
(L, B, S_c, K, hd), ``pos`` (L, S_c) (int64 here, int32 there), the SSM
state ``ssm_h`` (L, B, H, P, N) f32 and conv window ``ssm_conv`` (L, B,
W-1, conv_dim), the encoder's ``cross_k`` / ``cross_v`` (L, B, T, K, hd).
So :func:`cache_pspecs` reads each by the reference's name and axes.  The
reference's ``pspecs_for`` (``param_pspecs`` under another name, called
nowhere) is left out.
"""
from __future__ import annotations

import dataclasses
from typing import Dict

import torch

from repro_torch.configs.base import InputShape, ModelConfig
from repro_torch.core import ccl as ccl_lib
from repro_torch.core.connector import latent_dim as _cdim
from repro_torch.sharding.partition import (kv_cache_axes, mesh_sizes,
                                            tree_shardings)
from repro_torch.sharding.rules import Rules, Spec


def variant_for_shape(cfg: ModelConfig, shape: InputShape) -> ModelConfig:
    """long_500k on a full-attention arch runs the sliding-window variant
    (ring KV cache of 4,096 slots), as in the reference."""
    if (shape.name == "long_500k" and cfg.family not in ("ssm",)
            and cfg.sliding_window == 0):
        return dataclasses.replace(cfg, name=cfg.name + "-swa",
                                   sliding_window=4096)
    return cfg


# ---------------------------------------------------------------------------
# batch specs

def train_batch_structs(cfg: ModelConfig, shape: InputShape,
                        device="meta") -> Dict[str, torch.Tensor]:
    """The reference's train batch, leaf for leaf, as empty tensors on
    ``device`` (fake tensors where a ``FakeTensorMode`` is active)."""
    B, S = shape.global_batch, shape.seq_len
    M, fd = cfg.n_modalities, cfg.modality_dim

    def e(shp, dtype):
        return torch.empty(shp, dtype=dtype, device=device)
    out = {"tokens": e((B, S), torch.int32),
           "loss_mask": e((B, S), torch.float32)}
    if M > 0:
        out["modality_feats"] = e((B, M, fd), torch.float32)
        out["modality_mask"] = e((B, M), torch.bool)
        out["anchor"] = e((B, _cdim(cfg)), torch.float32)
    if cfg.frontend:
        out["frontend_embeds"] = e((B, cfg.frontend_tokens,
                                    cfg.frontend_dim), cfg.torch_dtype)
    return out


def train_batch_pspecs(cfg: ModelConfig, rules: Rules) -> Dict[str, Spec]:
    b = rules.axis("batch")
    out = {"tokens": Spec(b, None), "loss_mask": Spec(b, None)}
    if cfg.n_modalities > 0:
        out["modality_feats"] = Spec(b, None, None)
        out["modality_mask"] = Spec(b, None)
        out["anchor"] = Spec(b, None)
    if cfg.frontend:
        out["frontend_embeds"] = Spec(b, None, None)
    return out


def decode_batch_structs(cfg: ModelConfig, shape: InputShape,
                         device="meta") -> Dict:
    """A decode step's inputs: ``tokens`` (B, 1) int32 and ``pos``, a
    Python int (the port's ``decode_step`` takes one; the reference's is a
    traced () int32): the cache's last position, a step at full
    context."""
    return {"tokens": torch.empty((shape.global_batch, 1), dtype=torch.int32,
                                  device=device),
            "pos": shape.seq_len - 1}


# ---------------------------------------------------------------------------
# cache specs (divisibility-aware)

def _div(n: int, size: int) -> bool:
    return n % size == 0 and n >= size


def cache_pspecs(cfg: ModelConfig, cache_structs, mesh,
                 multi_pod: bool) -> Dict[str, Spec]:
    """A :class:`Spec` for each cache leaf, by its name: the reference's
    rules on the same shapes.  ``mesh`` is a DeviceMesh or a ``(names,
    shape)`` pair."""
    sizes = mesh_sizes(mesh)
    dsz, msz = sizes.get("data", 1), sizes.get("model", 1)

    specs = {}
    for name, s in cache_structs.items():
        if name in ("k", "v"):          # (L, B, Sc, K, hd)
            _, B, Sc, K, _ = s.shape
            b_ax, s_ax, k_ax = kv_cache_axes(B, Sc, K, sizes, multi_pod)
            specs[name] = Spec(None, b_ax, s_ax, k_ax, None)
        elif name in ("cross_k", "cross_v"):
            _, B, T, K, _ = s.shape
            b_ax = ("data",) if _div(B, dsz) else None
            k_ax = "model" if _div(K, msz) else None
            t_ax = None
            if b_ax is None and _div(T, dsz):
                t_ax = "data"
            specs[name] = Spec(None, b_ax, t_ax, k_ax, None)
        elif name == "pos":
            specs[name] = Spec(None, None)   # tiny (L, Sc); replicate
        elif name == "ssm_h":            # (L, B, H, Pd, N)
            _, B, H, Pd, _ = s.shape
            b_ax = ("data",) if _div(B, dsz) else None
            h_ax = "model" if _div(H, msz) else None
            p_ax = "model" if (h_ax is None and _div(Pd, msz)) else None
            specs[name] = Spec(None, b_ax, h_ax, p_ax, None)
        elif name == "ssm_conv":         # (L, B, W-1, conv_dim)
            _, B, _, cd = s.shape
            b_ax = ("data",) if _div(B, dsz) else None
            c_ax = "model" if _div(cd, msz) else None
            specs[name] = Spec(None, b_ax, None, c_ax)
        else:
            specs[name] = Spec(*([None] * s.dim()))
    return specs


# ---------------------------------------------------------------------------
# parameter / optimizer structs

def model_structs(bundle):
    """The unified model's params (``init_unified``) as fake tensors, which
    draw nothing and allocate nothing: of the active ``FakeTensorMode``,
    else of a new one."""
    from torch._guards import detect_fake_mode
    from torch._subclasses.fake_tensor import FakeTensorMode
    with detect_fake_mode() or FakeTensorMode():
        return ccl_lib.init_unified(torch.Generator(), bundle)


def shardings(tree_pspec, mesh):
    """DTensor placements for every :class:`Spec` of ``tree_pspec`` on
    ``mesh`` (the reference's ``NamedSharding`` tree)."""
    return tree_shardings(tree_pspec, mesh)
