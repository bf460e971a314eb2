"""FederationSpec — the declarative, cohort-based description of a
federation (port of ``repro.core.spec``): protocol validation, the
client-fault model :class:`FaultSpec`, :class:`ClientCohort` and
:class:`FederationSpec`.  Rules, messages and draws are the reference's.

A cohort is ``n_clients`` edge devices sharing ONE
:class:`~repro_torch.configs.base.ModelConfig`; cohorts may differ in
architecture (model-structure heterogeneity).  Cross-cohort aggregation
runs on the shared subset: the LoRA leaves whose path and shape match
between a cohort's SLM and the server SLM.  A single-cohort spec built by
:meth:`FederationSpec.from_legacy` reproduces the legacy runner.

:class:`ParticipantSampler` sets how many registered clients each round
samples (the working set: :mod:`repro_torch.core.store`).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np

from repro_torch.configs.base import ModelConfig
from repro_torch.core.channel import ChannelSpec
from repro_torch.core.connector import latent_dim
from repro_torch.data.multimodal import mer_partition

MODES = ("mlecs", "standalone", "fedavg")
ENGINES = ("loop", "vectorized", "overlap")
CCL_SCORES = ("volume", "cosine")
ROBUST = ("mean", "trimmed_mean", "norm_clip")
ATTACKS = ("none", "label_flip", "scaled_update")

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


@dataclasses.dataclass(frozen=True)
class FaultSpec:
    """The unreliable-client model, drawn per round from its own seed
    stream (:class:`repro_torch.core.faults.FaultSchedule`):

    * ``dropout`` — per-round probability that a client is offline: it
      trains nothing, uploads nothing and misses the redistribution;
    * ``straggler`` / ``max_delay`` — per-round probability that a
      straggle event starts, lasting ``U{1..max_delay}`` rounds: the
      client trains and receives, but its upload misses the aggregation;
    * ``byzantine`` — the fraction of clients (a fixed set) that attack:
      ``"label_flip"`` poisons their private train shards,
      ``"scaled_update"`` reports ``attack_scale`` times the true upload.
    """

    dropout: float = 0.0
    straggler: float = 0.0
    max_delay: int = 1
    byzantine: float = 0.0
    attack: str = "none"
    attack_scale: float = 10.0
    seed: int = 0

    def __post_init__(self):
        for name in ("dropout", "straggler"):
            v = getattr(self, name)
            if not (0.0 <= v < 1.0):
                raise ValueError(f"{name} must be in [0, 1); got {v}")
        if not (0.0 <= self.byzantine <= 1.0):
            raise ValueError(
                f"byzantine must be in [0, 1]; got {self.byzantine}")
        if self.max_delay < 1:
            raise ValueError("max_delay must be >= 1 round")
        if self.attack not in ATTACKS:
            raise ValueError(
                f"unknown attack {self.attack!r}; expected one of {ATTACKS}")
        if self.attack_scale <= 0.0:
            raise ValueError("attack_scale must be > 0")
        if self.byzantine > 0.0 and self.attack == "none":
            raise ValueError(
                "byzantine > 0 needs an attack ('label_flip' or "
                "'scaled_update'); use byzantine=0 for honest clients")


@dataclasses.dataclass(frozen=True)
class ParticipantSampler:
    """Per-round participant sampling over the registered population.

    ``per_cohort`` is the per-round sample size: one int shared by every
    cohort (clamped to each cohort's size), or a tuple with one entry per
    cohort, each in ``[1, n_clients]``.  Draws replay statelessly from
    ``(seed, round)`` (:class:`repro_torch.core.store.ParticipantSchedule`),
    so checkpoint/resume needs no sampler state.  The Eq. 13 weights
    renormalize over the sampled set; a sampler whose counts equal the
    cohort sizes is the identity and reproduces the unsampled runner bit
    for bit."""

    per_cohort: object = 1            # int | Tuple[int, ...]
    seed: int = 0

    def __post_init__(self):
        pc = self.per_cohort
        if isinstance(pc, (tuple, list)):
            pc = tuple(int(k) for k in pc)
            if any(k < 1 for k in pc):
                raise ValueError(f"per_cohort entries must be >= 1; got {pc}")
        else:
            pc = int(pc)
            if pc < 1:
                raise ValueError(f"per_cohort must be >= 1; got {pc}")
        object.__setattr__(self, "per_cohort", pc)

    def counts(self, cohort_sizes) -> Tuple[int, ...]:
        """Per-cohort sample counts, validated against cohort sizes."""
        sizes = tuple(int(n) for n in cohort_sizes)
        pc = self.per_cohort
        if isinstance(pc, int):
            ks = tuple(min(pc, n) for n in sizes)
        else:
            if len(pc) != len(sizes):
                raise ValueError(
                    f"per_cohort has {len(pc)} entries for "
                    f"{len(sizes)} cohorts")
            ks = pc
        for k, n in zip(ks, sizes):
            if not (1 <= k <= n):
                raise ValueError(
                    f"sample count {k} out of range for cohort of {n}")
        return ks


@dataclasses.dataclass(frozen=True)
class ClientCohort:
    """``n_clients`` edge devices sharing one model architecture.

    ``modalities`` (optional) restricts the cohort to a subset of the
    global modality ids (the MER draw composes with it); ``rho`` overrides
    the federation's MER; ``data_fraction`` keeps that fraction of each
    member's private shard; ``batch_size`` / ``local_steps_ccl`` /
    ``local_steps_amt`` override the federation's protocol values."""

    model: ModelConfig
    n_clients: int = 1
    name: str = ""
    modalities: Optional[Tuple[int, ...]] = None
    rho: Optional[float] = None
    data_fraction: float = 1.0
    batch_size: Optional[int] = None
    local_steps_ccl: Optional[int] = None
    local_steps_amt: Optional[int] = None

    def __post_init__(self):
        if self.n_clients < 1:
            raise ValueError("n_clients must be >= 1")
        for name in ("batch_size", "local_steps_ccl", "local_steps_amt"):
            v = getattr(self, name)
            if v is not None and int(v) < 1:
                raise ValueError(f"cohort {name} must be >= 1; got {v}")
        if not (0.0 < self.data_fraction <= 1.0):
            raise ValueError("data_fraction must be in (0, 1]")
        if self.rho is not None and not (0.0 <= self.rho <= 1.0):
            raise ValueError("rho must be in [0, 1]")
        if self.modalities is not None:
            mods = tuple(int(m) for m in self.modalities)
            if not mods:
                raise ValueError("modalities subset must be non-empty "
                                 "(use None for all modalities)")
            if len(set(mods)) != len(mods) or min(mods) < 0:
                raise ValueError(f"bad modality subset {mods}")
            if self.model.n_modalities and max(mods) >= self.model.n_modalities:
                raise ValueError(
                    f"modality id {max(mods)} out of range for "
                    f"n_modalities={self.model.n_modalities}")
            object.__setattr__(self, "modalities", mods)


@dataclasses.dataclass(frozen=True)
class FederationSpec:
    """A whole federation: cohorts + server + protocol.  ``n_devices`` is
    the sum of the cohort sizes; ``server_slm`` defaults to the first
    cohort's model."""

    cohorts: Tuple[ClientCohort, ...]
    server_llm: ModelConfig
    server_slm: Optional[ModelConfig] = None

    # protocol hyperparameters (the legacy FederatedConfig surface)
    rounds: int = 5
    local_steps_ccl: int = 4
    local_steps_amt: int = 4
    server_steps: int = 4
    batch_size: int = 8
    lr: float = 3e-3
    rho: float = 0.7                 # default MER (cohorts may override)
    n_negatives: int = 4
    seed: int = 0
    engine: str = "vectorized"       # "loop" | "vectorized" | "overlap"
    staleness: int = 0               # overlap: rounds a delivery lags
    use_mma: bool = True
    use_seccl: bool = True
    use_ccl: bool = True
    mode: str = "mlecs"
    kt_weight: float = 0.5
    prox_weight: float = 0.0
    ccl_score: str = "volume"
    robust: str = "mean"             # mean (Eq. 13) | trimmed_mean | norm_clip
    trim_frac: float = 0.2           # fraction trimmed from EACH end
    faults: Optional[FaultSpec] = None
    sampler: Optional[ParticipantSampler] = None
    channel: Optional[ChannelSpec] = None    # wire codec (None = identity)

    def __post_init__(self):
        cohorts = tuple(self.cohorts)
        if not cohorts:
            raise ValueError("FederationSpec needs at least one cohort")
        object.__setattr__(self, "cohorts", cohorts)
        validate_protocol(self.mode, self.engine, self.ccl_score,
                          self.staleness, self.robust, self.trim_frac)
        if not (0.0 <= self.rho <= 1.0):
            raise ValueError("rho must be in [0, 1]")
        if self.sampler is not None:
            if not isinstance(self.sampler, ParticipantSampler):
                raise TypeError(
                    "sampler must be repro_torch.core.spec."
                    f"ParticipantSampler; got {type(self.sampler).__name__}")
            # resolve and validate the per-cohort counts now, not mid-run
            self.sampler.counts([c.n_clients for c in cohorts])
        if self.channel is not None and not isinstance(self.channel,
                                                       ChannelSpec):
            raise TypeError(
                f"channel must be a ChannelSpec; got {type(self.channel)}")
        # anchored CCL and cross-cohort aggregation need ONE connector
        # latent space; backbones are free to differ
        models = [c.model for c in cohorts] + [self.server_llm,
                                               self.resolved_server_slm]
        if any(m.n_modalities > 0 for m in models):
            iface = {(m.n_modalities, m.modality_dim, latent_dim(m))
                     for m in models}
            if len(iface) != 1:
                raise ValueError(
                    "cohort/server models disagree on the connector "
                    f"interface (n_modalities, modality_dim, latent): "
                    f"{sorted(iface)}")

    # ------------------------------------------------------------------
    @property
    def resolved_server_slm(self) -> ModelConfig:
        """The server-side SLM config (defaults to cohort 0's model)."""
        return self.server_slm if self.server_slm is not None \
            else self.cohorts[0].model

    @property
    def n_cohorts(self) -> int:
        """Number of device cohorts in the federation."""
        return len(self.cohorts)

    @property
    def n_devices(self) -> int:
        """Total client count across cohorts (the legacy ``n_devices``)."""
        return sum(c.n_clients for c in self.cohorts)

    @property
    def offsets(self) -> Tuple[int, ...]:
        """Global client index of each cohort's first member."""
        out, acc = [], 0
        for c in self.cohorts:
            out.append(acc)
            acc += c.n_clients
        return tuple(out)

    def cohort_of(self, j: int) -> int:
        """Cohort index owning global client ``j``."""
        for c, off in enumerate(self.offsets):
            if off <= j < off + self.cohorts[c].n_clients:
                return c
        raise IndexError(j)

    def cohort_rho(self, c: int) -> float:
        """Cohort ``c``'s MER keep-rate (override or spec default)."""
        return self.cohorts[c].rho if self.cohorts[c].rho is not None \
            else self.rho

    def cohort_batch_size(self, c: int) -> int:
        """Cohort ``c``'s training batch size (override or spec default)."""
        v = self.cohorts[c].batch_size
        return int(v) if v is not None else self.batch_size

    def cohort_steps_ccl(self, c: int) -> int:
        """Cohort ``c``'s CCL local-step count (override or default)."""
        v = self.cohorts[c].local_steps_ccl
        return int(v) if v is not None else self.local_steps_ccl

    def cohort_steps_amt(self, c: int) -> int:
        """Cohort ``c``'s AMT local-step count (override or default)."""
        v = self.cohorts[c].local_steps_amt
        return int(v) if v is not None else self.local_steps_amt

    def mask_seed(self, c: int) -> int:
        """Seed of cohort ``c``'s MER draw (cohort 0 = the spec seed)."""
        return mask_seed(self.seed, c)

    def modality_subset(self, c: int, n_modalities: int
                        ) -> Optional[np.ndarray]:
        """Cohort ``c``'s allowed-modality bool vector (None = all)."""
        mods = self.cohorts[c].modalities
        if mods is None:
            return None
        if max(mods) >= n_modalities:
            raise ValueError(
                f"cohort {c} modality subset {mods} out of range for the "
                f"corpus' {n_modalities} modalities")
        allowed = np.zeros(n_modalities, bool)
        allowed[list(mods)] = True
        return allowed

    def draw_masks(self, n_modalities: int) -> np.ndarray:
        """(n_devices, n_modalities) MER availability masks, cohort-wise:
        cohort ``c`` draws ``mer_partition(mask_seed(c), ...)`` at its own
        ``rho`` restricted to its modality subset."""
        parts = [
            mer_partition(self.mask_seed(c), coh.n_clients, n_modalities,
                          self.cohort_rho(c),
                          allowed=self.modality_subset(c, n_modalities))
            for c, coh in enumerate(self.cohorts)]
        return np.concatenate(parts, axis=0)

    # ------------------------------------------------------------------
    def to_config(self):
        """The derived legacy view (a ``FederatedConfig`` with
        ``n_devices = sum of cohort sizes``) — what ``runner.cfg`` holds."""
        from repro_torch.core.federated import FederatedConfig
        return FederatedConfig(
            n_devices=self.n_devices,
            **{f: getattr(self, f) for f in PROTOCOL_FIELDS})

    @classmethod
    def from_legacy(cls, cfg, slm_cfg: ModelConfig, llm_cfg: ModelConfig
                    ) -> "FederationSpec":
        """One homogeneous cohort of ``cfg.n_devices`` clients: the legacy
        constructor's semantics (same MER draw, streams and keys)."""
        return cls(
            cohorts=(ClientCohort(model=slm_cfg, n_clients=cfg.n_devices,
                                  name="legacy"),),
            server_llm=llm_cfg,
            **{f: getattr(cfg, f) for f in PROTOCOL_FIELDS})


PROTOCOL_FIELDS = (
    "rounds", "local_steps_ccl", "local_steps_amt", "server_steps",
    "batch_size", "lr", "rho", "n_negatives", "seed", "engine", "staleness",
    "use_mma", "use_seccl", "use_ccl", "mode", "kt_weight", "prox_weight",
    "ccl_score", "robust", "trim_frac", "faults", "sampler", "channel")
