"""Deterministic synthetic multimodal corpora (copy of
``repro.data.synthetic`` without its unused JAX import: the arrays are
identical, drawn from ``np.random.default_rng``).

The paper's datasets (VAST 27M clips, UR-FALL) are gated; per the repro band
we simulate them with a corpus that preserves the *structure* the method
exploits: several modalities carrying a shared latent semantic (class), and
text targets that are only predictable from that latent — so the multimodal
connector and the CCL alignment measurably matter.

Each sample:
  latent class c ~ U(n_classes)
  modality m feature  = W_m @ mu_c + noise        (B, M, modality_dim)
  tokens = [ctx (weakly informative) | template_c (deterministic)],
  loss_mask covers the template region only (summary generation analogue);
  with template length 1 this is the classification task (UR-FALL analogue).
"""
from __future__ import annotations

from typing import Dict

import numpy as np


def synthetic_multimodal_corpus(seed: int, n_samples: int, seq_len: int,
                                vocab_size: int, n_classes: int,
                                n_modalities: int, modality_dim: int,
                                template_len: int = 8,
                                latent_dim: int = 32,
                                noise: float = 0.3) -> Dict[str, np.ndarray]:
    rng = np.random.default_rng(seed)
    assert template_len < seq_len
    ctx_len = seq_len - template_len

    mu = rng.normal(size=(n_classes, latent_dim)).astype(np.float32)
    W = rng.normal(size=(n_modalities, latent_dim, modality_dim)) \
        .astype(np.float32) / np.sqrt(latent_dim)
    templates = rng.integers(2, vocab_size, size=(n_classes, template_len)) \
        .astype(np.int32)

    cls = rng.integers(0, n_classes, size=(n_samples,)).astype(np.int32)
    latent = mu[cls] + noise * rng.normal(
        size=(n_samples, latent_dim)).astype(np.float32)
    feats = np.einsum("nl,mld->nmd", latent, W).astype(np.float32)
    feats += noise * rng.normal(size=feats.shape).astype(np.float32)

    # context tokens: mostly uniform noise, weakly class-colored
    ctx = rng.integers(2, vocab_size, size=(n_samples, ctx_len)) \
        .astype(np.int32)
    tokens = np.concatenate([ctx, templates[cls]], axis=1)
    loss_mask = np.zeros((n_samples, seq_len), np.float32)
    loss_mask[:, ctx_len:] = 1.0

    return {
        "tokens": tokens,
        "loss_mask": loss_mask,
        "modality_feats": feats,
        "label": cls,
        "template_start": np.full((n_samples,), ctx_len, np.int32),
        "templates": templates,          # (n_classes, template_len) — eval aid
    }
