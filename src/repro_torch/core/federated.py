"""The ML-ECS federated round — Algorithm 1 on the loop and vectorized
engines, for cohort-structured federations (port of
``repro.core.federated``).

One cloud server (a unified LLM and a server-side SLM) and N edge devices
(unified SLMs with heterogeneous modality availability).  Per round:

  1. the server LLM's connector fuses omni-modal anchors on each device's
     public batch;
  2. each device runs CCL steps (public data, anchored), then AMT steps
     (private data), and uploads the LoRA leaves of its SLM;
  3. the server aggregates the uploads with MMA weights (Eq. 13) into its
     SLM;
  4. the server runs SE-CCL: pooled-KL transfer between its SLM and LLM
     on public data (Eq. 15-16), each model with its own AdamW update;
  5. the server SLM's LoRA leaves are redistributed to every device.

**Cohorts.**  The runner is built from a
:class:`~repro_torch.core.spec.FederationSpec`: an ordered tuple of
cohorts, each of ``n_clients`` devices sharing ONE architecture (plus an
optional modality subset, MER ``rho``, data fraction, batch size and step
counts).  Across cohorts the protocol runs on the **shared subset**: the
LoRA keys whose path and shape match the server SLM; the others federate
within their cohort only (the intra-cohort MMA average).  Aggregation is
two-level and order-deterministic: per-cohort f32 partial sums under
globally normalized Eq. 13 weights, then a cohort-ordered shared-key
combine.  The legacy form ``FederatedRunner(cfg, slm_bundle, llm_bundle,
corpus)`` is a shim over :meth:`FederationSpec.from_legacy`.

**Faults.**  A :class:`~repro_torch.core.spec.FaultSpec` draws per-round
presence and straggle masks (:class:`~repro_torch.core.faults.
FaultSchedule`): an offline client trains nothing (its streams still
advance), uploads nothing and receives nothing; a straggler trains and
receives, but its upload weighs 0.  The Eq. 13 mass renormalizes over the
present, on-time clients.  Byzantine clients flip their train labels at
init or scale their uploads.  ``robust`` picks the reduction (mean,
trimmed_mean, norm_clip); robust reductions take the raw per-client
uploads.

**Engines.**  ``engine="loop"`` (the numerical ground truth) runs every
client's steps one client at a time.  ``engine="vectorized"`` (the
reference's default) stacks each cohort's personal leaves and AdamW
states on a leading client axis and runs each local step as ONE stacked
step for all clients of the cohort (:func:`~repro_torch.core.ccl.
make_stacked_step`): every kernel on the step's path launches once per
cohort, kernel C in its grouped form.  Offline clients train with the
others and are then selected back (parameters and AdamW state, its step
count included); their streams advance.  Client evaluation runs each
cohort's padded eval shards in one pass per batch.  The two engines share
everything after the device phase: the wire, the combines, SE-CCL and the
delivery (redistribution is a presence-masked broadcast into the stack).
They agree to float rounding.

Covered: the loop and vectorized engines, the modes mlecs / fedavg /
standalone, the ablations ``use_mma`` / ``use_seccl`` / ``use_ccl``, both
CCL scores, ``prox_weight``, the three reductions, client faults, and the
identity, int8 and int4 channels (uploads cross the wire before MMA, each
cohort's redistribution crosses it on the way down).  The overlap engine,
the sketch codec, participant sampling and checkpoints raise
``NotImplementedError``.

Every member of a cohort shares ONE frozen backbone (the cohort base);
only its personal leaves (LoRA + connector) are its own, stacked (n, ...)
under the vectorized engine.  Steps never write a tensor in place: a step
returns a new tree that shares the frozen leaves.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch import interop
from repro_torch.core import ccl as ccl_lib
from repro_torch.core import lora, mma, seccl
from repro_torch.core.channel import ChannelSpec, TensorSpec
from repro_torch.core.faults import FaultSchedule
from repro_torch.core.spec import (ENGINES, ClientCohort, FaultSpec,
                                   FederationSpec, validate_protocol)
from repro_torch.data import attacks
from repro_torch.data.multimodal import (paper_split, take_fraction,
                                         train_test_split)
from repro_torch.data.pipeline import (ClientStreams, np_eval_batches,
                                       stack_eval_steps,
                                       stacked_eval_batches, to_tensors)
from repro_torch.models.model import build_model
from repro_torch.optim.adamw import adamw, apply_updates


def _do_ccl(cfg: "FederatedConfig") -> bool:
    """Does the device phase run the CCL (public-data, anchored) steps?"""
    return cfg.mode != "standalone" and cfg.use_ccl


def _do_seccl(cfg: "FederatedConfig") -> bool:
    """Does the server run the SE-CCL training phase (Alg. 1 step 4)?"""
    return cfg.mode not in ("standalone", "fedavg") and cfg.use_seccl


def _ccl_weight(cfg: "FederatedConfig") -> float:
    """CCL loss weight of the device public-data steps (0 outside mlecs)."""
    return 0.5 if (cfg.use_ccl and cfg.mode == "mlecs") else 0.0


def _where_clients(mask: torch.Tensor, new, old):
    """Per-client select over the stacked leading axis of (nested) dicts:
    ``new`` where the client took part this round, ``old`` (its pre-round
    value) where it was offline."""
    if isinstance(new, dict):
        return {k: _where_clients(mask, v, old[k]) for k, v in new.items()}
    return torch.where(mma._bcast(mask, new), new, old)


def _scale_uploads(uploads: Dict[str, torch.Tensor], scale: np.ndarray
                   ) -> Dict[str, torch.Tensor]:
    """Byzantine scaled-update over a stacked upload: client j reports
    ``scale[j] × u_j`` (1.0 for honest clients: exact), the product in f32
    rounded once, as :func:`repro_torch.data.attacks.scaled_update`."""
    out = {}
    for k, v in uploads.items():
        s = torch.as_tensor(scale, dtype=torch.float32, device=v.device)
        out[k] = (v.float() * mma._bcast(s, v)).to(v.dtype)
    return out


@dataclasses.dataclass
class FederatedConfig:
    """Hyperparameters of one federated simulation: the reference's fields
    and defaults.  ``channel`` is a :class:`ChannelSpec` and ``faults`` a
    :class:`FaultSpec` of the port (None = identity wire, no faults).
    ``sampler`` is accepted (opaque) and refused by
    :class:`FederatedRunner`, as is the sketch codec."""

    n_devices: int = 3
    rounds: int = 5
    local_steps_ccl: int = 4
    local_steps_amt: int = 4
    server_steps: int = 4
    batch_size: int = 8
    lr: float = 3e-3
    rho: float = 0.7                 # modality existing rate (MER)
    n_negatives: int = 4
    seed: int = 0
    engine: str = "vectorized"       # "loop" or "vectorized"
    staleness: int = 0
    use_mma: bool = True             # False -> uniform averaging (w/o MMA)
    use_seccl: bool = True           # False -> skip step 4     (w/o SE-CCL)
    use_ccl: bool = True             # False -> devices skip step 2's loss
    mode: str = "mlecs"              # mlecs | standalone | fedavg
    kt_weight: float = 0.5
    prox_weight: float = 0.0         # FedProx-style pull toward the global
    ccl_score: str = "volume"        # volume (Eq. 5-8) | cosine (ablation)
    robust: str = "mean"             # mean | trimmed_mean | norm_clip
    trim_frac: float = 0.2
    faults: Optional[FaultSpec] = None
    sampler: Optional[Any] = None
    channel: Optional[ChannelSpec] = None   # wire codec (None = identity)

    def __post_init__(self):
        if self.n_devices < 1:
            raise ValueError("n_devices must be >= 1")
        validate_protocol(self.mode, self.engine, self.ccl_score,
                          self.staleness, self.robust, self.trim_frac)


def _refuse_unported(spec: FederationSpec, engine: str) -> None:
    if engine not in ENGINES:
        raise ValueError(f"unknown engine {engine!r}")
    if engine == "overlap":
        raise NotImplementedError(
            "engine='overlap' is not ported; pass engine='loop' or "
            "'vectorized'")
    if spec.staleness > 0:
        raise ValueError("staleness > 0 requires the overlap engine")
    if spec.channel is not None and spec.channel.codec == "sketch":
        raise NotImplementedError(
            "the sketch codec is not ported (identity, int8, int4)")
    if spec.faults is not None and not isinstance(spec.faults, FaultSpec):
        raise TypeError("faults must be repro_torch.core.spec.FaultSpec; "
                        f"got {type(spec.faults).__name__}")
    if spec.sampler is not None:
        raise NotImplementedError(
            "participant sampling is not ported (sampler=None)")


class _Cohort:
    """Runtime state of one cohort: its model bundle, the contiguous
    global-client slice it owns, its globally normalized Eq. 13 weights,
    the server-shape-shared key subset, the wire templates and byte costs,
    its members' parameters and optimizer states, and its steps.  The
    loop engine keeps one tree per member (``device_params``,
    ``device_opt``); the vectorized engine one stacked tree
    (``stacked_params``: the backbone once, the personal leaves (n, ...))
    and one stacked AdamW state (``stacked_opt``), with its padded eval
    shards (``eval_steps``)."""

    def __init__(self, idx: int, spec: ClientCohort, bundle, offset: int):
        self.idx = idx
        self.bundle = bundle
        self.offset = offset
        self.n = spec.n_clients
        self.weights = None          # (n,) globally normalized MMA weights
        self.w_total = 0.0           # the cohort's weight mass
        self.shared: Tuple[str, ...] = ()   # server-shape-matching LoRA keys
        self.own: Tuple[str, ...] = ()      # cohort-local LoRA keys
        self.own_dtypes: Dict = {}
        self.last_global: Dict = {}  # last delivery (prox reference)
        self.device_params: List = []
        self.device_opt: List = []
        self.stacked_params: Optional[dict] = None
        self.stacked_opt: Optional[dict] = None
        self.eval_steps: Optional[Dict] = None

    @property
    def slice(self) -> slice:
        """Global client-index slice of this cohort's members."""
        return slice(self.offset, self.offset + self.n)


class FederatedRunner:
    """A federation of cohorts and the cloud server, on the loop or the
    vectorized engine (``engine``, default the spec's):

        ``FederatedRunner(spec, corpus, engine=None, device="cuda",
        init_state=None)``

    or through the legacy single-cohort shim:

        ``FederatedRunner(cfg, slm_bundle, llm_bundle, corpus, ...)``

    The states are drawn from a ``torch.Generator`` seeded with the seed
    on ``device`` unless ``init_state`` gives them: a dict of flat numpy
    trees (``interop`` format) with ``"cohort_bases"`` (one shared
    unified SLM per cohort; the legacy ``"cohort_base"`` names cohort 0's),
    ``"personal"`` (each global client's trainable leaves),
    ``"server_slm"`` and ``"server_llm"``.  The runner runs on the card;
    ``device="cpu"`` asks for the CPU."""

    def __init__(self, spec, *args, engine: Optional[str] = None,
                 device="cuda", init_state: Optional[Dict] = None):
        if isinstance(spec, FederationSpec):
            if len(args) != 1:
                raise TypeError("FederatedRunner(spec, corpus, engine=..., "
                                "device=..., init_state=...)")
            (corpus,) = args
            bundles = [build_model(c.model) for c in spec.cohorts]
            llm_bundle = build_model(spec.server_llm)
            srv_slm_bundle = (bundles[0] if spec.server_slm is None
                              else build_model(spec.server_slm))
        elif isinstance(spec, FederatedConfig):
            if len(args) != 3:
                raise TypeError("FederatedRunner(cfg, slm_bundle, "
                                "llm_bundle, corpus, ...)")
            slm_bundle, llm_bundle, corpus = args
            spec = FederationSpec.from_legacy(spec, slm_bundle.cfg,
                                              llm_bundle.cfg)
            bundles = [slm_bundle]
            srv_slm_bundle = slm_bundle
        else:
            raise TypeError(f"expected FederationSpec or FederatedConfig, "
                            f"got {type(spec).__name__}")
        self.spec = spec
        self.cfg = cfg = spec.to_config()
        self.engine = engine or spec.engine
        _refuse_unported(spec, self.engine)
        self._stacked = self.engine == "vectorized"
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("CUDA is not available; pass device='cpu' "
                               "to run the round on the CPU")
        self.channel = (spec.channel or ChannelSpec()).make()
        self.slm = bundles[0]        # legacy alias: cohort 0's bundle
        self.llm = llm_bundle
        self._srv_slm_bundle = srv_slm_bundle
        N = cfg.n_devices

        # data: public / private, train / test, modality masks.  Private
        # shards are allocated over the GLOBAL client index, then thinned
        # by the owning cohort's data_fraction.
        public, privates = paper_split(corpus, N, cfg.seed)
        self.public_train, self.public_test = train_test_split(
            public, 0.1, cfg.seed)
        self.priv_train, self.priv_test = [], []
        for j, pv in enumerate(privates):
            frac = spec.cohorts[spec.cohort_of(j)].data_fraction
            pv = take_fraction(pv, frac, cfg.seed + 10_000 + j)
            tr, te = train_test_split(pv, 0.1, cfg.seed + j + 1)
            self.priv_train.append(tr)
            self.priv_test.append(te)
        M = corpus["modality_feats"].shape[1]
        self.masks = spec.draw_masks(M)

        # the fault model: per-round host masks; label-flip poisoning
        # rewrites the Byzantine clients' TRAIN shards before any stream
        # reads them (test shards stay clean)
        self._faults = (FaultSchedule(spec.faults, N)
                        if spec.faults is not None else None)
        self._round_idx = 0
        self._rnd_no = None          # the current round's index
        self._rnd_present = None     # (N,) bool — training + delivery mask
        self._rnd_contrib = None     # (N,) bool — aggregation mask
        self._rnd_weights = None     # (N,) f32 — survivor-renormalized
        self._attack_scale = None    # (N,) f32 — scaled-update factors
        if self._faults is not None:
            fl = spec.faults
            if fl.attack == "label_flip":
                for j in np.flatnonzero(self._faults.byzantine):
                    self.priv_train[j] = attacks.label_flip(
                        self.priv_train[j], seed=fl.seed + 31_000 + j)
            elif fl.attack == "scaled_update" and \
                    bool(self._faults.byzantine.any()):
                self._attack_scale = np.where(
                    self._faults.byzantine, fl.attack_scale,
                    1.0).astype(np.float32)

        # models: one frozen backbone per cohort, shared by its members
        if init_state is None:
            device_params = self._init_states(bundles)
        else:
            device_params = self._load_states(init_state, bundles)

        self.opt = opt = adamw(cfg.lr, weight_decay=0.0)
        device_opt = [opt.init(lora.partition(p)) for p in device_params]
        self.server_llm_opt = opt.init(lora.partition(self.server_llm))
        self.server_slm_opt = opt.init(lora.partition(self.server_slm))

        # MMA weights (Eq. 13), normalized GLOBALLY so per-cohort partial
        # sums recompose into the flat Eq. 13 aggregate on shared keys
        self._mod_counts = [int(self.masks[j].sum()) for j in range(N)]
        if cfg.use_mma and cfg.mode == "mlecs":
            self.agg_weights = mma.aggregation_weights(self._mod_counts,
                                                       device=self.device)
        else:
            self.agg_weights = torch.ones((N,), device=self.device) / N

        # cohort runtimes: weights, shared / own keys, wire, state, steps
        server_lora = lora.partition(self.server_slm, lora.is_lora_leaf)
        self._server_lora_dtypes = {k: v.dtype for k, v in server_lora.items()}
        ident = ChannelSpec().make()
        self._cohorts: List[_Cohort] = []
        for c, cs in enumerate(spec.cohorts):
            rt = _Cohort(c, cs, bundles[c], spec.offsets[c])
            rt.weights = (self.agg_weights if spec.n_cohorts == 1
                          else self.agg_weights[rt.slice])
            rt.w_total = float(rt.weights.cpu().numpy().astype(np.float32)
                               .sum(dtype=np.float32))
            rt.device_params = device_params[rt.slice]
            rt.device_opt = device_opt[rt.slice]
            up0 = lora.partition(rt.device_params[0], lora.is_lora_leaf)
            rt.shared = lora.shared_keys(up0, server_lora)
            rt.own = tuple(k for k in sorted(up0) if k not in rt.shared)
            rt.own_dtypes = {k: up0[k].dtype for k in rt.own}
            rt.last_global = {k: server_lora[k] for k in rt.shared}
            # the wire: the stacked upload template, the error-feedback
            # residuals (f32, (n, ...)) and the exact per-round byte costs
            # (bytes_on_wire is linear in the client axis)
            rt.up_like = {k: TensorSpec((rt.n, *v.shape), v.dtype)
                          for k, v in up0.items()}
            rt.chan_state = self.channel.init_state(rt.up_like, self.device)
            rt.uplink_client_bytes = \
                self.channel.bytes_on_wire(rt.up_like) // rt.n
            rt.dense_client_bytes = ident.bytes_on_wire(rt.up_like) // rt.n
            # the paper's Fig. 3 baseline is dense float32 uploads
            rt.f32_client_bytes = 4 * sum(v.numel() for v in up0.values())
            down_like = {k: server_lora[k] for k in rt.shared}
            down_like.update({k: up0[k] for k in rt.own})
            rt.downlink_bytes = self.channel.bytes_on_wire(
                {k: TensorSpec((1, *v.shape), v.dtype)
                 for k, v in down_like.items()})
            # the steps (public attributes, so a caller can time or wrap
            # them): per client on the loop engine, per cohort stacked on
            # the vectorized one
            make_step = (ccl_lib.make_stacked_step if self._stacked
                         else ccl_lib.make_local_step)
            rt.ccl_step = make_step(
                rt.bundle, opt, ccl_weight=_ccl_weight(cfg),
                n_negatives=cfg.n_negatives, ccl_score=cfg.ccl_score)
            rt.amt_step = make_step(
                rt.bundle, opt, ccl_weight=0.0, with_anchor=False,
                prox_weight=cfg.prox_weight)
            if self._stacked:
                rt.stacked_params = lora.combine(
                    self.cohort_bases[c], lora.stack_clients(
                        [lora.partition(p) for p in rt.device_params]))
                rt.stacked_opt = lora.stack_trees(rt.device_opt)
                rt.device_params, rt.device_opt = [], []
                rt.eval_fn = seccl.make_eval_fn(rt.bundle, n_clients=rt.n)
            else:
                rt.eval_step = seccl.make_eval_step(rt.bundle)
            self._cohorts.append(rt)
        # the legacy fast path needs FULL key coverage by one cohort
        self._homogeneous = (spec.n_cohorts == 1
                             and not self._cohorts[0].own
                             and len(self._cohorts[0].shared)
                             == len(server_lora))
        self._bytes_up = self._bytes_up_dense = 0
        self._bytes_up_f32 = self._bytes_down = 0
        self.comm_log: List[Dict] = []

        # one shuffle stream per GLOBAL client id (plus the server's)
        self._streams = ClientStreams()
        for j in range(N):
            bs_c = spec.cohort_batch_size(spec.cohort_of(j))
            self._streams.register(f"pub/{j}", self.public_train, bs_c,
                                   cfg.seed + 100 + j, self.masks[j])
            self._streams.register(f"priv/{j}", self.priv_train[j], bs_c,
                                   cfg.seed + 200 + j, self.masks[j])
        self._streams.register("server", self.public_train, cfg.batch_size,
                               cfg.seed + 999)

        self.se_step = self._make_seccl_step()
        self.llm_eval_step = seccl.make_eval_step(self.llm)
        self._server_eval_fn = seccl.make_eval_fn(self.llm)
        self._server_eval_steps = None
        self.refresh_eval_shards()
        self.history: List[Dict] = []

    # ------------------------------------------------------------------
    def _init_states(self, bundles) -> List[dict]:
        """Draw every state from one generator: per cohort its base, then
        each further member's personal leaves; then the server SLM and
        LLM.  Returns the members' trees in global order."""
        gen = torch.Generator(device=self.device).manual_seed(self.cfg.seed)
        self.cohort_bases, device_params = [], []
        for c, cs in enumerate(self.spec.cohorts):
            base = ccl_lib.init_unified(gen, bundles[c])
            self.cohort_bases.append(base)
            device_params.append(base)
            for _ in range(1, cs.n_clients):
                personal = lora.partition(ccl_lib.init_unified(gen,
                                                               bundles[c]))
                device_params.append(lora.combine(base, personal))
        self.server_slm = ccl_lib.init_unified(gen, self._srv_slm_bundle)
        self.server_llm = ccl_lib.init_unified(gen, self.llm)
        return device_params

    def _load_states(self, state: Dict, bundles) -> List[dict]:
        spec = self.spec
        bases = state.get("cohort_bases")
        if bases is None:
            bases = [state["cohort_base"]]
        if len(bases) != spec.n_cohorts:
            raise ValueError(f"init_state has {len(bases)} cohort bases for "
                             f"{spec.n_cohorts} cohorts")
        if len(state["personal"]) != spec.n_devices:
            raise ValueError(f"init_state has {len(state['personal'])} "
                             f"personal sets for {spec.n_devices} devices")
        self.cohort_bases = [
            interop.params_from_numpy(b, self.device, bd.cfg.torch_dtype)
            for b, bd in zip(bases, bundles)]
        device_params = []
        for j, pers in enumerate(state["personal"]):
            c = spec.cohort_of(j)
            device_params.append(lora.combine(
                self.cohort_bases[c],
                interop.leaves_from_numpy(pers, self.device,
                                          bundles[c].cfg.torch_dtype)))
        self.server_slm = interop.params_from_numpy(
            state["server_slm"], self.device,
            self._srv_slm_bundle.cfg.torch_dtype)
        self.server_llm = interop.params_from_numpy(
            state["server_llm"], self.device, self.llm.cfg.torch_dtype)
        return device_params

    def _make_seccl_step(self) -> Callable:
        """Joint SE-CCL update of the server LLM (Eq. 15) and the server
        SLM (Eq. 16), with the server SLM's own bundle.  Each model runs
        twice: ``mlecs_loss`` with its soft prompt, then ``logits`` on the
        raw batch for the KT terms.  One backward gives both models'
        gradients; each takes its own AdamW update."""
        cfg = self.cfg
        llm, slm = self.llm, self._srv_slm_bundle

        def step(llm_params, slm_params, llm_opt, slm_opt, batch):
            t_llm = {k: v.detach().requires_grad_(True)
                     for k, v in lora.partition(llm_params).items()}
            t_slm = {k: v.detach().requires_grad_(True)
                     for k, v in lora.partition(slm_params).items()}
            llm_full = lora.combine(llm_params, t_llm)
            slm_full = lora.combine(slm_params, t_slm)
            l_llm, _ = ccl_lib.mlecs_loss(
                llm_full, llm, batch, anchor=None,
                ccl_weight=0.5 if cfg.use_ccl else 0.0,
                n_negatives=cfg.n_negatives)
            l_slm, _ = ccl_lib.mlecs_loss(slm_full, slm, batch, anchor=None,
                                          ccl_weight=0.0)
            y_llm, _ = llm.logits(llm_full, batch)
            y_slm, _ = slm.logits(slm_full, batch)
            kt_llm = seccl.kt_loss(y_llm, y_slm)      # LLM learns from SLM
            kt_slm = seccl.kt_loss(y_slm, y_llm)      # SLM learns from LLM
            total = (l_llm + cfg.kt_weight * kt_llm
                     + l_slm + cfg.kt_weight * kt_slm)
            both = {**{("llm", k): v for k, v in t_llm.items()},
                    **{("slm", k): v for k, v in t_slm.items()}}
            grads = ccl_lib.grads_of(total, both)
            out = []
            for tag, t, o, params in (("llm", t_llm, llm_opt, llm_params),
                                      ("slm", t_slm, slm_opt, slm_params)):
                t = {k: v.detach() for k, v in t.items()}
                u, o = self.opt.update({k: grads[(tag, k)] for k in t}, o, t)
                out.append((lora.combine(params, apply_updates(t, u)), o))
            (llm_params, llm_opt), (slm_params, slm_opt) = out
            metrics = {"llm": l_llm.detach(), "slm": l_slm.detach(),
                       "kt_llm": kt_llm.detach(), "kt_slm": kt_slm.detach()}
            return llm_params, slm_params, llm_opt, slm_opt, metrics

        return step

    # ------------------------------------------------------------------
    # views

    @property
    def cohorts(self) -> Tuple[_Cohort, ...]:
        """The per-cohort runtime states (offset, size, shared keys,
        weights, members' parameters and steps)."""
        return tuple(self._cohorts)

    def _single(self) -> _Cohort:
        """The sole cohort (the legacy single-cohort attribute views)."""
        if len(self._cohorts) != 1:
            raise AttributeError(
                "this attribute is the legacy single-cohort view; use "
                "runner.cohorts[c].<attr> on multi-cohort federations")
        return self._cohorts[0]

    @property
    def device_params(self) -> List[dict]:
        """Every device's parameter tree, in global client order (views of
        the stacks under the vectorized engine: the cohort's backbone and
        the client's slice of each personal leaf)."""
        if self._stacked:
            out = []
            for rt in self._cohorts:
                personal = lora.partition(rt.stacked_params)
                out += [lora.combine(rt.stacked_params,
                                     lora.gather_client(personal, i))
                        for i in range(rt.n)]
            return out
        return [p for rt in self._cohorts for p in rt.device_params]

    @property
    def device_opt(self) -> List:
        """Every device's optimizer state, in global client order."""
        if self._stacked:
            return [o for rt in self._cohorts
                    for o in lora.unstack_tree(rt.stacked_opt, rt.n)]
        return [o for rt in self._cohorts for o in rt.device_opt]

    @property
    def stacked_params(self) -> dict:
        """Legacy single-cohort view of the stacked parameters (the
        vectorized engine)."""
        return self._single().stacked_params

    @property
    def stacked_opt(self) -> dict:
        """Legacy single-cohort view of the stacked AdamW state."""
        return self._single().stacked_opt

    @property
    def cohort_base(self) -> dict:
        return self.cohort_bases[self._single().idx]

    @property
    def up_like(self) -> Dict:
        return self._single().up_like

    @property
    def chan_state(self) -> Dict:
        return self._single().chan_state

    @property
    def ccl_step(self) -> Callable:
        return self._single().ccl_step

    @ccl_step.setter
    def ccl_step(self, fn: Callable) -> None:
        self._single().ccl_step = fn

    @property
    def amt_step(self) -> Callable:
        return self._single().amt_step

    @amt_step.setter
    def amt_step(self, fn: Callable) -> None:
        self._single().amt_step = fn

    # ------------------------------------------------------------------
    def pull(self, name: str) -> Dict[str, torch.Tensor]:
        """The next batch of stream ``name`` (``"pub/<j>"``, ``"priv/<j>"``,
        ``"server"``) as tensors on the runner's device."""
        return to_tensors(self._streams.pull(name), self.device)

    @torch.no_grad()
    def anchors(self, pub: Dict[str, torch.Tensor]) -> torch.Tensor:
        """The server LLM's fused anchors for a device's public batch (its
        features already zeroed by the device's MER mask), with an
        all-ones modality mask."""
        batch = dict(pub, modality_mask=torch.ones_like(pub["modality_mask"]))
        return ccl_lib.server_anchors(self.server_llm, self.llm, batch)

    @torch.no_grad()
    def stacked_anchors(self, pub: Dict[str, torch.Tensor]) -> torch.Tensor:
        """:meth:`anchors` for a cohort's stacked public batch (G, B, ...)
        at once: (G, B, c)."""
        batch = dict(pub, modality_mask=torch.ones_like(pub["modality_mask"]))
        return ccl_lib.stacked_server_anchors(self.server_llm, self.llm,
                                              batch)

    # ------------------------------------------------------------------
    # per-round fault state (no-ops without a FaultSpec)

    def _begin_round(self) -> None:
        """Advance the round counter and draw the round's presence and
        straggle masks, with the Eq. 13 weights renormalized over the
        contributing (present and on-time) clients."""
        cfg = self.cfg
        self._rnd_no = self._round_idx
        self._round_idx += 1
        if self._faults is None:
            return
        present, ontime = self._faults.round_masks(self._rnd_no)
        contrib = present & ontime
        if cfg.use_mma and cfg.mode == "mlecs":
            w = mma.aggregation_weights(self._mod_counts,
                                        present=contrib).numpy()
        else:
            w = contrib.astype(np.float32) / max(int(contrib.sum()), 1)
        self._rnd_present = present
        self._rnd_contrib = contrib
        self._rnd_weights = np.array(w, np.float32)

    def _active_weights(self) -> np.ndarray:
        """This round's globally normalized weights as host numpy."""
        if self._rnd_weights is not None:
            return self._rnd_weights
        return self.agg_weights.cpu().numpy().astype(np.float32)

    def _weights_for(self, rt: _Cohort):
        """The cohort's weights this round (fault-masked under faults)."""
        if self._rnd_weights is None:
            return rt.weights
        return torch.as_tensor(self._rnd_weights[rt.slice],
                               device=self.device)

    def _w_total_for(self, rt: _Cohort) -> float:
        """The cohort's weight mass this round (its surviving mass under
        faults: the combine's renormalization denominator)."""
        if self._rnd_weights is None:
            return rt.w_total
        return float(self._rnd_weights[rt.slice].sum(dtype=np.float32))

    def _present_for(self, rt: _Cohort) -> Optional[torch.Tensor]:
        """The cohort's block of the presence mask (None without faults)."""
        if self._rnd_present is None:
            return None
        return torch.as_tensor(self._rnd_present[rt.slice],
                               device=self.device)

    # ------------------------------------------------------------------
    # aggregation

    def _own_avgs(self, partials) -> Tuple[Dict, ...]:
        """Each cohort's intra-cohort MMA average of its non-shared keys,
        from its f32 partial sums, over its surviving mass; a cohort that
        lost every contributor averages nothing."""
        out = []
        for rt, p in zip(self._cohorts, partials):
            wt = self._w_total_for(rt)
            if not rt.own or not wt > 0.0:
                out.append({})
                continue
            out.append({k: (p[k] / float(np.float32(wt))).to(rt.own_dtypes[k])
                        for k in rt.own})
        return tuple(out)

    def _combine_payloads(self, stacked):
        """Fold each cohort's decoded uploads (stacked on the client axis)
        into the server-bound aggregate: under ``robust != "mean"`` the
        raw uploads through :meth:`_robust_combine`; else the weighted mean
        of the single fully shared cohort, or each cohort's f32 partial
        sums combined on the shared keys in cohort order.  Returns
        ``(agg, own_avgs)``."""
        if self.cfg.robust != "mean":
            return self._robust_combine(stacked)
        if self._homogeneous:
            return mma.aggregate_stacked(
                stacked[0], self._weights_for(self._cohorts[0])), ({},)
        partials = [mma.partial_aggregate_stacked(s, self._weights_for(rt))
                    for rt, s in zip(self._cohorts, stacked)]
        agg = mma.combine_cohort_partials(
            partials, [rt.shared for rt in self._cohorts],
            [self._w_total_for(rt) for rt in self._cohorts],
            self._server_lora_dtypes)
        return agg, self._own_avgs(partials)

    def _robust_combine(self, payloads):
        """The robust reduction over each cohort's RAW stacked uploads:
        own keys within the cohort, shared keys across the cohorts that
        share them.  Returns ``(agg, own_avgs)``."""
        cfg = self.cfg
        w = self._active_weights()
        contrib = self._rnd_contrib          # None without a fault model
        if self._homogeneous:
            agg = mma.aggregate_stacked(
                payloads[0], w, robust=cfg.robust, present=contrib,
                trim_frac=cfg.trim_frac)
            return agg, ({},)
        own_avgs = []
        for rt, p in zip(self._cohorts, payloads):
            wsl = w[rt.slice]
            csl = None if contrib is None else contrib[rt.slice]
            mass = float(wsl.sum() if csl is None else (wsl * csl).sum())
            if not rt.own or not mass > 0.0:
                own_avgs.append({})
                continue
            own_avgs.append(mma.aggregate_stacked(
                {k: p[k] for k in rt.own}, wsl, robust=cfg.robust,
                present=csl, trim_frac=cfg.trim_frac))
        agg = mma.robust_combine_cohorts(
            payloads, [w[rt.slice] for rt in self._cohorts],
            [rt.shared for rt in self._cohorts],
            self._server_lora_dtypes, cfg.robust,
            present=(None if contrib is None else
                     [contrib[rt.slice] for rt in self._cohorts]),
            trim_frac=cfg.trim_frac)
        return agg, tuple(own_avgs)

    def _cohort_delivery(self, rt: _Cohort, down: Dict, own_avg: Dict
                         ) -> Dict:
        """What cohort ``rt`` receives in Alg. 1 step 5: the server's
        values on its shared keys plus its intra-cohort average of its own
        keys (``down`` itself for the fully shared single cohort).  A key
        that aggregated nothing this round re-sends the previous value."""
        if self._homogeneous:
            return down
        delivery = {}
        for k in rt.shared:
            if k in down:
                delivery[k] = down[k]
            elif k in rt.last_global:
                delivery[k] = rt.last_global[k]
        for k in rt.own:
            if k in own_avg:
                delivery[k] = own_avg[k]
            elif k in rt.last_global:
                delivery[k] = rt.last_global[k]
        return delivery

    # ------------------------------------------------------------------
    # the wire

    def _encode_uploads(self, uploads: List[Dict]) -> List[Dict]:
        """The uplink: each cohort's uploads, stacked on the client axis,
        cross the channel; returns what the server receives (each cohort's
        decoded leaves, stacked) and advances the error-feedback residuals
        of the PRESENT clients only."""
        out = []
        for rt, stacked in zip(self._cohorts, uploads):
            # stateless codecs hold {} as their state and get {} back
            dec, new_state = self.channel.roundtrip(stacked, rt.chan_state,
                                                    self._rnd_no)
            if self.channel.stateful:
                pres = self._present_for(rt)
                if pres is not None:
                    new_state = {
                        k: torch.where(mma._bcast(pres, v), v,
                                       rt.chan_state[k])
                        for k, v in new_state.items()}
                rt.chan_state = new_state
            out.append(dec)
        return out

    def _deliver(self, rt: _Cohort, delivery: Dict) -> None:
        """Alg. 1 step 5: splice the (decoded) delivery into every
        reachable member of the cohort (a broadcast over the stack under
        the vectorized engine, masked by presence); it is also the
        cohort's prox reference of the next round.  Offline clients
        receive nothing."""
        rt.last_global = delivery
        if self._stacked:
            cur = lora.partition(rt.stacked_params, lambda k: k in delivery)
            bcast = lora.broadcast_clients(cur, delivery)
            pres = self._present_for(rt)
            if pres is not None:
                bcast = _where_clients(pres, bcast, cur)
            rt.stacked_params = lora.combine(rt.stacked_params, bcast)
            return
        pres = self._rnd_present
        for i in range(rt.n):
            if pres is None or pres[rt.offset + i]:
                rt.device_params[i] = lora.combine(rt.device_params[i],
                                                   delivery)

    def _commit_comm(self) -> None:
        """Account one round's exact bytes on the wire: per cohort, every
        PRESENT member's encoded upload (stragglers transmit too, offline
        clients nothing) and one multicast downlink; standalone rounds
        move nothing."""
        if self.cfg.mode == "standalone":
            self.comm_log.append({"round": self._rnd_no, "uplink": 0,
                                  "downlink": 0})
            return
        up = up_dense = up_f32 = down = 0
        for rt in self._cohorts:
            n = rt.n
            if self._rnd_present is not None:
                n = int(self._rnd_present[rt.slice].sum())
            up += n * rt.uplink_client_bytes
            up_dense += n * rt.dense_client_bytes
            up_f32 += n * rt.f32_client_bytes
            down += rt.downlink_bytes
        self._bytes_up += up
        self._bytes_up_dense += up_dense
        self._bytes_up_f32 += up_f32
        self._bytes_down += down
        self.comm_log.append({"round": self._rnd_no, "uplink": int(up),
                              "downlink": int(down)})

    @property
    def comm_stats(self) -> Dict:
        """Wire-traffic totals over the committed rounds: the codec, the
        exact uplink and downlink bytes, what the same uploads would cost
        dense (in their own dtype and in f32), the ratios, and each
        cohort's encoded bytes per client."""
        up, dense = int(self._bytes_up), int(self._bytes_up_dense)
        f32 = int(self._bytes_up_f32)
        return {"codec": self.channel.spec.codec,
                "rounds": len(self.comm_log),
                "uplink_bytes": up, "uplink_dense_bytes": dense,
                "uplink_f32_bytes": f32,
                "uplink_ratio": (dense / up) if up else float("inf"),
                "uplink_ratio_f32": (f32 / up) if up else float("inf"),
                "downlink_bytes": int(self._bytes_down),
                "uplink_client_bytes": {rt.idx: rt.uplink_client_bytes
                                        for rt in self._cohorts}}

    # ------------------------------------------------------------------
    def run_round(self, evaluate: bool = True) -> Dict:
        """One communication round (the reference's ``_run_round_loop`` on
        the loop engine; its vectorized round, fused or split by cohort, on
        the vectorized one: both are a device phase per cohort, then the
        shared server side).

        Client metrics are measured on the post-AMT device models, server
        metrics after SE-CCL; redistribution seeds the next round.  With
        ``evaluate=False`` no metric is computed and ``{}`` is returned."""
        cfg = self.cfg
        self._begin_round()
        # (1)-(2) the device side: per client (loop) or per cohort
        # (vectorized); each cohort's uploads stacked on the client axis
        uploads = (self._device_phase_stacked() if self._stacked
                   else self._device_phase_loop())

        client_eval = self.evaluate_clients() if evaluate else None
        if cfg.mode == "standalone":
            self._commit_comm()
            return self._finalize_eval(client_eval) if evaluate else {}

        # the uplink wire, then (3) MMA over what the server received: f32,
        # left to right over the clients, then cohort order per key.  The
        # devices keep their own (undecoded) parameters.
        agg, own_avgs = self._combine_payloads(self._encode_uploads(uploads))

        if cfg.mode == "fedavg":
            # Multi-FedAvg: the average straight back, through the
            # downlink once per cohort
            for c, rt in enumerate(self._cohorts):
                self._deliver(rt, self.channel.roundtrip_tree(
                    self._cohort_delivery(rt, agg, own_avgs[c]),
                    self._rnd_no))
            self._commit_comm()
            return self._finalize_eval(client_eval) if evaluate else {}

        self.server_slm = lora.combine(self.server_slm, agg)
        # (4) SE-CCL on the server
        if _do_seccl(cfg):
            for _ in range(cfg.server_steps):
                (self.server_llm, self.server_slm, self.server_llm_opt,
                 self.server_slm_opt, _) = self.se_step(
                    self.server_llm, self.server_slm, self.server_llm_opt,
                    self.server_slm_opt, self.pull("server"))
        # (5) redistribute: the server SLM's shared leaves and each
        # cohort's own averages, through the downlink; the server SLM
        # keeps its own values
        down = lora.partition(self.server_slm, lora.is_lora_leaf)
        for c, rt in enumerate(self._cohorts):
            self._deliver(rt, self.channel.roundtrip_tree(
                self._cohort_delivery(rt, down, own_avgs[c]), self._rnd_no))
        self._commit_comm()
        return self._finalize_eval(client_eval) if evaluate else {}

    def _device_phase_loop(self) -> List[Dict]:
        """The loop engine's device side: each client's CCL then AMT steps,
        one client at a time.  Returns each cohort's uploads (LoRA leaves,
        Byzantine-scaled where marked) stacked on the client axis."""
        cfg, spec = self.cfg, self.spec
        pres, scale = self._rnd_present, self._attack_scale
        uploads: List[Dict] = []
        for rt in self._cohorts:
            k_ccl = spec.cohort_steps_ccl(rt.idx)
            k_amt = spec.cohort_steps_amt(rt.idx)
            ups = []
            for i in range(rt.n):
                j = rt.offset + i
                p, o = rt.device_params[i], rt.device_opt[i]
                if pres is not None and not pres[j]:
                    # offline: the round does not happen for this device,
                    # but its shuffle streams advance as the reference's do
                    if _do_ccl(cfg):
                        self._streams.advance(f"pub/{j}", k_ccl)
                    self._streams.advance(f"priv/{j}", k_amt)
                    ups.append(lora.partition(p, lora.is_lora_leaf))
                    continue
                if _do_ccl(cfg):
                    for _ in range(k_ccl):
                        pub = self.pull(f"pub/{j}")
                        p, o, _ = rt.ccl_step(p, o, pub, self.anchors(pub))
                gref = rt.last_global if cfg.prox_weight > 0 else None
                for _ in range(k_amt):
                    p, o, _ = rt.amt_step(p, o, self.pull(f"priv/{j}"),
                                          None, gref)
                rt.device_params[i], rt.device_opt[i] = p, o
                ups.append(lora.partition(p, lora.is_lora_leaf))
            if scale is not None:
                # Byzantine scaled-update: every marked client reports
                # scale × u (a stale upload weighs 0 anyway)
                ups = [attacks.scaled_update(u, float(scale[rt.offset + i]))
                       if scale[rt.offset + i] != 1.0 else u
                       for i, u in enumerate(ups)]
            uploads.append(lora.stack_clients(ups))
        return uploads

    def _device_phase_stacked(self) -> List[Dict]:
        """The vectorized engine's device side: per cohort, the round's
        batches of all its clients pulled at once (client-major per step,
        one transfer per phase), then each CCL and AMT step as ONE stacked
        step for all clients.  Offline clients train with the others and
        are selected back (parameters and AdamW state, the step count
        included); their streams advance as the loop engine's do.
        Returns each cohort's uploads stacked on the client axis."""
        cfg, spec = self.cfg, self.spec
        uploads: List[Dict] = []
        for rt in self._cohorts:
            names = range(rt.offset, rt.offset + rt.n)
            p0, o0 = rt.stacked_params, rt.stacked_opt
            p, o = p0, o0
            k_ccl = spec.cohort_steps_ccl(rt.idx) if _do_ccl(cfg) else 0
            if k_ccl:
                pubs = to_tensors(self._streams.gather_steps(
                    [f"pub/{j}" for j in names], k_ccl), self.device)
                for t in range(k_ccl):
                    pub = {k: v[t] for k, v in pubs.items()}
                    p, o, _ = rt.ccl_step(p, o, pub, self.stacked_anchors(pub))
            gref = rt.last_global if cfg.prox_weight > 0 else None
            k_amt = spec.cohort_steps_amt(rt.idx)
            if k_amt:
                privs = to_tensors(self._streams.gather_steps(
                    [f"priv/{j}" for j in names], k_amt), self.device)
                for t in range(k_amt):
                    p, o, _ = rt.amt_step(
                        p, o, {k: v[t] for k, v in privs.items()}, None, gref)
            pres = self._present_for(rt)
            if pres is not None:
                # an offline client's round does not happen: its training
                # is undone by a per-client select
                p = lora.combine(p, _where_clients(
                    pres, lora.partition(p), lora.partition(p0)))
                o = _where_clients(pres, o, o0)
            rt.stacked_params, rt.stacked_opt = p, o
            up = lora.partition(p, lora.is_lora_leaf)
            if self._attack_scale is not None:
                up = _scale_uploads(up, self._attack_scale[rt.slice])
            uploads.append(up)
        return uploads

    def run(self) -> List[Dict]:
        """Run ``cfg.rounds`` evaluated rounds, appending to ``history``."""
        for _ in range(self.cfg.rounds):
            self.history.append(self.run_round())
        return self.history

    # ------------------------------------------------------------------
    def _eval_model(self, step, params, data, mask,
                    batch_size: Optional[int] = None) -> Dict:
        """Host loop over padded in-order eval batches, accumulating the
        per-batch masked sums in f32 (the reference's order)."""
        sums = {k: np.float32(0.0) for k in seccl.EVAL_SUM_KEYS}
        for batch in np_eval_batches(data, batch_size or self.cfg.batch_size,
                                     mask):
            out = step(params, to_tensors(batch, self.device))
            for k in sums:
                sums[k] = np.float32(sums[k] + np.float32(out[k].item()))
        return seccl.metrics_from_sums(sums)

    def refresh_eval_shards(self) -> None:
        """(Re)build the vectorized engine's eval shards from the CURRENT
        ``priv_test`` / ``public_test``: per cohort its clients' test sets
        in padded (T, n, B, ...) steps at the cohort's batch size, and the
        server's (T, B, ...) steps, on the runner's device.  Call it after
        changing a test set; a no-op on the loop engine (which reads the
        test sets live)."""
        if not self._stacked:
            return
        for rt in self._cohorts:
            sl = rt.slice
            rt.eval_steps = to_tensors(stack_eval_steps(stacked_eval_batches(
                self.priv_test[sl], self.spec.cohort_batch_size(rt.idx),
                self.masks[sl])), self.device)
        self._server_eval_steps = to_tensors(stack_eval_steps(
            np_eval_batches(self.public_test, self.cfg.batch_size)),
            self.device)

    def evaluate_clients(self) -> List[Dict]:
        """Per-device ``{"ce", "acc"}`` on each private test set, in global
        client order, each cohort at its own batch size: one client at a
        time (loop), or all of a cohort's clients in one pass per padded
        eval batch (vectorized)."""
        if self._stacked:
            out = []
            for rt in self._cohorts:
                sums = rt.eval_fn(rt.stacked_params, rt.eval_steps)
                host = {k: v.cpu().numpy() for k, v in sums.items()}
                out += [seccl.metrics_from_sums({k: v[i]
                                                 for k, v in host.items()})
                        for i in range(rt.n)]
            return out
        return [self._eval_model(rt.eval_step, rt.device_params[i],
                                 self.priv_test[rt.offset + i],
                                 self.masks[rt.offset + i],
                                 self.spec.cohort_batch_size(rt.idx))
                for rt in self._cohorts for i in range(rt.n)]

    def evaluate_server(self) -> Dict:
        """Server LLM ``{"ce", "acc"}`` on the public test set (the
        vectorized engine over its prebuilt eval steps)."""
        if self._stacked:
            return seccl.metrics_from_sums(self._server_eval_fn(
                self.server_llm, self._server_eval_steps))
        return self._eval_model(self.llm_eval_step, self.server_llm,
                                self.public_test, None)

    def _finalize_eval(self, client_eval: Optional[List[Dict]] = None
                       ) -> Dict:
        cs = client_eval if client_eval is not None \
            else self.evaluate_clients()
        out = {"client": cs, "server": self.evaluate_server()}
        out["summary"] = {
            "avg_acc": float(np.mean([c["acc"] for c in cs])),
            "best_acc": float(np.max([c["acc"] for c in cs])),
            "worst_acc": float(np.min([c["acc"] for c in cs])),
            "avg_ce": float(np.mean([c["ce"] for c in cs])),
            "server_acc": out["server"]["acc"],
            "server_ce": out["server"]["ce"],
        }
        return out

    def evaluate(self) -> Dict:
        """Test metrics of every device and of the server on the current
        parameters (between rounds: post-redistribution)."""
        return self._finalize_eval()

    # ------------------------------------------------------------------
    def checkpoint_state(self) -> Dict:
        raise NotImplementedError("checkpoints are not ported")

    def save_checkpoint(self, mgr, step: Optional[int] = None) -> int:
        raise NotImplementedError("checkpoints are not ported")

    def load_checkpoint(self, mgr, step: Optional[int] = None):
        raise NotImplementedError("checkpoints are not ported")
