"""Modality-heterogeneity partition (paper §4.1); a copy of
``repro.data.multimodal``.

MER (modality existing rate) rho: each device possesses modality m with
probability Bernoulli(rho) — a device-level draw, matching the paper's
"variations in both the number and combinations of modalities available
across devices".  At least one modality is always kept.  An optional
``allowed`` subset (the cohort API's per-cohort modality restriction)
composes with the draw: disallowed modalities are never kept and the
≥1-modality guarantee is satisfied *within* the subset.

Data split: 3/4 private (across devices), 1/4 public; 90/10 train/test;
:func:`take_fraction` optionally thins a private shard (per-cohort data
slices).
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np


def mer_partition(seed: int, n_devices: int, n_modalities: int,
                  rho: float, allowed: Optional[np.ndarray] = None
                  ) -> np.ndarray:
    """(n_devices, n_modalities) bool availability masks.

    ``allowed`` (optional, (n_modalities,) bool) restricts the draw to a
    modality subset.  With ``allowed=None`` the rng consumption is
    bit-identical to the historical two-arg form — ``rng.integers`` is
    consumed only for empty rows — so existing seeds reproduce exactly.
    """
    rng = np.random.default_rng(seed)
    masks = rng.random((n_devices, n_modalities)) < rho
    if allowed is not None:
        allowed = np.asarray(allowed, bool)
        if not allowed.any():
            raise ValueError("allowed modality subset is empty")
        masks &= allowed
        choices = np.flatnonzero(allowed)
    for j in range(n_devices):
        if not masks[j].any():
            if allowed is None:
                masks[j, rng.integers(n_modalities)] = True
            else:
                masks[j, choices[rng.integers(len(choices))]] = True
    return masks


def take_fraction(data: Dict[str, np.ndarray], fraction: float,
                  seed: int) -> Dict[str, np.ndarray]:
    """Keep a random ``fraction`` of the rows (per-cohort data slices).

    ``fraction >= 1.0`` is the literal identity (no rng consumed, no
    copies) so legacy full-shard behavior is reproduced bit-for-bit; at
    least one row is always kept.
    """
    if fraction >= 1.0:
        return data
    n = data["tokens"].shape[0]
    keep = max(1, int(n * fraction))
    rng = np.random.default_rng(seed)
    return _slice(data, np.sort(rng.permutation(n)[:keep]))


def _slice(data: Dict[str, np.ndarray], idx) -> Dict[str, np.ndarray]:
    n = data["tokens"].shape[0]
    return {k: (v[idx] if isinstance(v, np.ndarray) and v.shape[:1] == (n,)
                else v) for k, v in data.items()}


def paper_split(data: Dict[str, np.ndarray], n_devices: int, seed: int
                ) -> Tuple[Dict, List[Dict]]:
    """Returns (public, [private_j]) with the paper's quarter/three-quarter
    allocation."""
    n = data["tokens"].shape[0]
    rng = np.random.default_rng(seed)
    perm = rng.permutation(n)
    n_pub = n // 4
    public = _slice(data, perm[:n_pub])
    rest = perm[n_pub:]
    shards = np.array_split(rest, n_devices)
    privates = [_slice(data, s) for s in shards]
    return public, privates


def train_test_split(data: Dict[str, np.ndarray], test_frac: float = 0.1,
                     seed: int = 0) -> Tuple[Dict, Dict]:
    n = data["tokens"].shape[0]
    rng = np.random.default_rng(seed)
    perm = rng.permutation(n)
    n_test = max(1, int(n * test_frac))
    return _slice(data, perm[n_test:]), _slice(data, perm[:n_test])
