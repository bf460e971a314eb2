"""Protocol validation and the MER mask draw of one homogeneous cohort
(the part of ``repro.core.spec`` the legacy ``FederatedConfig`` form
needs).  Draws are identical to the reference's."""
from __future__ import annotations

import numpy as np

from repro_torch.data.multimodal import mer_partition

MODES = ("mlecs", "standalone", "fedavg")
ENGINES = ("loop", "vectorized", "overlap")
CCL_SCORES = ("volume", "cosine")
ROBUST = ("mean", "trimmed_mean", "norm_clip")

# cohort c draws its MER masks from seed + c * _MASK_SEED_STRIDE
_MASK_SEED_STRIDE = 7919


def validate_protocol(mode: str, engine: str, ccl_score: str,
                      staleness: int, robust: str = "mean",
                      trim_frac: float = 0.2) -> None:
    """Reject invalid protocol knobs at construction time (the
    reference's rules and messages)."""
    if mode not in MODES:
        raise ValueError(f"unknown mode {mode!r}; expected one of {MODES}")
    if engine not in ENGINES:
        raise ValueError(
            f"unknown engine {engine!r}; expected one of {ENGINES}")
    if ccl_score not in CCL_SCORES:
        raise ValueError(
            f"unknown ccl_score {ccl_score!r}; expected one of {CCL_SCORES}")
    if staleness < 0:
        raise ValueError("staleness must be >= 0")
    if staleness > 0 and engine != "overlap":
        raise ValueError(
            f"staleness={staleness} requires engine='overlap' (the other "
            "engines have no pipeline to lag); got engine=" + repr(engine))
    if robust not in ROBUST:
        raise ValueError(
            f"unknown robust {robust!r}; expected one of {ROBUST}")
    if not (0.0 <= trim_frac < 0.5):
        raise ValueError(
            f"trim_frac must be in [0, 0.5) — trimming half the clients "
            f"from each end leaves nothing to average; got {trim_frac}")


def mask_seed(seed: int, cohort: int = 0) -> int:
    """Seed of cohort ``cohort``'s MER draw (cohort 0 = the seed itself)."""
    return seed + _MASK_SEED_STRIDE * cohort


def draw_masks(seed: int, n_devices: int, n_modalities: int,
               rho: float) -> np.ndarray:
    """(n_devices, n_modalities) bool MER masks of one unrestricted cohort
    (``FederationSpec.draw_masks`` of the legacy single-cohort spec)."""
    return mer_partition(mask_seed(seed, 0), n_devices, n_modalities, rho)
