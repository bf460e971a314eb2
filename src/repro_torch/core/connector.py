"""The unified model's connector C (port of ``repro.core.connector``):
per-modality projectors (Eq. 4), a fusion MLP (Eq. 9) and a soft-prompt
generator (Eq. 10), plus ``init_unified`` (``repro.core.ccl``), which
builds the backbone and then the connector.

Every function also takes G clients at once: connector leaves stacked
(G, ...) with inputs (G, B, ...), or one connector (the server's) over
(G, B, ...) inputs.  The products are ``torch.einsum`` / ``torch.matmul``
with the leading axes batched, as ``vmap`` of the reference gives.
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import _dense_init


def latent_dim(cfg: ModelConfig) -> int:
    """The connector's shared latent width (``connector_dim`` or d_model)."""
    return cfg.connector_dim or cfg.d_model


def init_connector(gen: torch.Generator, cfg: ModelConfig) -> dict:
    """Connector params on ``gen``'s device.  Needs cfg.n_modalities > 0."""
    M, fd, d, c = cfg.n_modalities, cfg.modality_dim, cfg.d_model, latent_dim(cfg)
    dt = cfg.torch_dtype
    return {
        "proj_w": _dense_init(gen, (M, fd, c), dt),
        "proj_b": torch.zeros((M, c), dtype=dt, device=gen.device),
        "fuse_w1": _dense_init(gen, (M * c, c), dt),
        "fuse_w2": _dense_init(gen, (c, c), dt),
        "spg_w1": _dense_init(gen, (c, d), dt),
        "spg_scale": torch.ones((cfg.n_soft_tokens, d), dtype=dt,
                                device=gen.device),
        "spg_bias": _dense_init(gen, (cfg.n_soft_tokens, d), dt, scale=0.02),
    }


def project_modalities(p, cfg: ModelConfig, feats, mask):
    """Eq. 4.  feats: ([G,] B, M, fd); mask: ([G,] B, M) bool
    availability.  Returns ([G,] B, M, c) with absent modalities zeroed."""
    h = torch.einsum("...bmf,...mfd->...bmd", feats.to(p["proj_w"].dtype),
                     p["proj_w"]) + p["proj_b"][..., None, :, :]
    return h * mask[..., None].to(h.dtype)


def fuse(p, cfg: ModelConfig, h, mask):
    """Eq. 9: fused multimodal representation ([G,] B, c)."""
    flat = (h * mask[..., None].to(h.dtype)).reshape(*h.shape[:-2], -1)
    return F.gelu(flat @ p["fuse_w1"], approximate="tanh") @ p["fuse_w2"]


def soft_prompt(p, cfg: ModelConfig, fused):
    """Eq. 10: soft-prompt tokens ([G,] B, n_soft, d)."""
    g = F.gelu(fused @ p["spg_w1"], approximate="tanh")
    return (g[..., None, :] * p["spg_scale"][..., None, :, :]
            + p["spg_bias"][..., None, :, :])


def connector_prefix(p, cfg: ModelConfig, feats, mask
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Full connector pass: returns (soft_tokens, modality_reps, fused)."""
    h = project_modalities(p, cfg, feats, mask)
    s = fuse(p, cfg, h, mask)
    return soft_prompt(p, cfg, s), h, s


def init_unified(gen: torch.Generator, bundle) -> dict:
    """The unified model M = {C (connector), B (backbone)}: the backbone's
    params, then the connector's, both drawn from ``gen``."""
    params = bundle.init(gen)
    if bundle.cfg.n_modalities > 0:
        params["connector"] = init_connector(gen, bundle.cfg)
    return params
