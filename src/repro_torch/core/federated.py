"""The ML-ECS federated round — Algorithm 1 on the loop, vectorized and
overlap engines, for cohort-structured federations (port of
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

``engine="overlap"`` runs the vectorized device phase and the server
phase (the combine's landing in the server SLM, SE-CCL, the delivery and
the anchor trainables) pipelined across rounds.  ``staleness`` sets how
many rounds a delivery lags: each round pushes its server output onto a
queue, and once the queue holds more than ``staleness`` entries the
oldest is applied, under THIS round's presence mask and through the
downlink with THIS round's index.  Each cohort anchors its CCL steps on a
stale anchor model: the server LLM's frozen leaves (the same tensors, no
copy) with the trainables of the last applied delivery.
``staleness=0`` reproduces the vectorized engine bit for bit.  On the
card the server phase runs on its own CUDA stream (events and
``record_stream`` order the tensors that cross); on the CPU it runs
inline.  A worker thread (:class:`~repro_torch.data.pipeline.
RoundPrefetcher`) assembles each round's host batches ahead of the
applied rounds, and under a sampler the next round's store gather is
staged on a thread after each scatter; both do host work only, every
transfer stays on the main thread.  :meth:`FederatedRunner.sync` waits
for the clients' side, :meth:`~FederatedRunner.drain` for everything,
and :meth:`~FederatedRunner.close` stops the threads.

**Registered population.**  A :class:`~repro_torch.core.spec.
ParticipantSampler` on the spec splits client state in two: every
registered client's personal state lives on the host (or on disk, with
``store_dir=``) in a :class:`~repro_torch.core.store.ClientStore`, and
the engines keep only the round's working set on the device.  Each round
draws its participants (:class:`~repro_torch.core.store.
ParticipantSchedule`, stateless from ``(seed, round)``), gathers their
rows from the store into the stacked buffers (the loop engine reads and
writes each member's entry), trains on Eq. 13 weights renormalized over
the sampled set, and scatters the rows back.  Per-round vectors (weights,
presence, attack scale) are working-set sized: a cohort's block is its
``work_slice``.  A sampler that covers every client reproduces the
unsampled runner bit for bit.  :meth:`FederatedRunner.save_checkpoint` /
:meth:`~FederatedRunner.load_checkpoint` round-trip the run state (the
round counter, the server, the population) in the reference's format;
a restore replays the sampler's draws and the data streams from the round
counter, so the resumed rounds are bit-identical.

**A mesh.**  ``mesh=`` (a ``torch.distributed`` DeviceMesh from
:mod:`repro_torch.launch.mesh`, or the overlap engine's per-cohort list)
splits the stacked engines' client axis over the mesh's "data" ranks, one
process a rank (SPMD).  Each rank trains its block of every cohort on its
mesh (the whole cohort where the data size does not divide it); the
uploads' LoRA leaves are all-gathered over the data group in client order
(and broadcast from a cohort mesh to the ranks it leaves out), so every
rank runs the same server side on the same N uploads: the wire, the
scan-ordered MMA, SE-CCL, the residuals and the server evaluation are
computed whole on every rank.  Deliveries land in each rank's block, and
the per-client eval sums are gathered, so a round's metrics are the same
on every rank.  Under a sampler every rank holds the whole store and
draws the same members; it trains its block of the working set, and the
trained blocks (personal leaves, AdamW state) are gathered before every
rank writes them back, so the stores stay equal.  A checkpoint is the
tree one rank builds (the stacks gathered); rank 0 writes it, and every
rank reads it whole and keeps its block, so it loads at any world size.
Past one rank the overlap engine runs the server chain on the world's
last rank only (the reference's last device): the server models live
there, the others keep the anchor base, and each applied delivery (the
down payload, the anchor trainables) and the server's eval sums are
broadcast from it.  At data size 1 the placement is a no-op and the
gathers are copies: the round is bit for bit the one without a mesh.
The loop engine runs every client on every rank (the mesh replicates
it).

Covered: the loop and vectorized engines, the modes mlecs / fedavg /
standalone, the ablations ``use_mma`` / ``use_seccl`` / ``use_ccl``, both
CCL scores, ``prox_weight``, the three reductions, client faults,
participant sampling, checkpoints, and the identity, int8, int4 and sketch
channels (uploads cross the wire before MMA, each cohort's redistribution
crosses it on the way down).

Every member of a cohort shares ONE frozen backbone (the cohort base);
only its personal leaves (LoRA + connector) are its own, stacked (n, ...)
under the vectorized engine.  Steps never write a tensor in place: a step
returns a new tree that shares the frozen leaves.
"""
from __future__ import annotations

import collections
import dataclasses
import math
import threading
import weakref
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from repro_torch import interop
from repro_torch.core import ccl as ccl_lib
from repro_torch.core import lora, mma, seccl
from repro_torch.checkpointing.checkpoint import map_pytree
from repro_torch.core.channel import ChannelSpec, TensorSpec
from repro_torch.core.faults import FaultSchedule
from repro_torch.core.spec import (ENGINES, ClientCohort, FaultSpec,
                                   FederationSpec, ParticipantSampler,
                                   validate_protocol)
from repro_torch.core.store import ClientStore, ParticipantSchedule
from repro_torch.data import attacks
from repro_torch.data.multimodal import (paper_split, take_fraction,
                                         train_test_split)
from repro_torch.data.pipeline import (ClientStreams, RoundPrefetcher,
                                       np_eval_batches, stack_eval_steps,
                                       stacked_eval_batches, to_tensors)
from repro_torch.models.model import build_model
from repro_torch.optim.adamw import adamw, apply_updates
from repro_torch.sharding import collectives as coll
from repro_torch.sharding import partition as shard_part
from repro_torch.sharding.rules import TRAIN_RULES


# the server's state: its models and their AdamW states
_SERVER_STATE = ("server_llm", "server_slm", "server_llm_opt",
                 "server_slm_opt")


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


def _to_device(tree, device):
    """Every tensor leaf of a pytree moved to ``device``."""
    return map_pytree(lambda t: t.to(device), tree)


def _record_stream(tree, stream) -> None:
    """Mark every tensor of a pytree as used on ``stream``: the caching
    allocator then reuses its memory only after the work queued there
    when it is freed."""
    def mark(t):
        if isinstance(t, torch.Tensor):
            t.record_stream(stream)
    map_pytree(mark, tree)


def _meta(tree):
    """A pytree's tensors as meta tensors: its shapes and dtypes, no
    data."""
    return map_pytree(lambda t: t.to("meta"), tree)


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
    and defaults.  ``channel`` is a :class:`ChannelSpec`, ``faults`` a
    :class:`FaultSpec` and ``sampler`` a :class:`ParticipantSampler` of
    the port (None = identity wire, no faults, every client every
    round)."""

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
    engine: str = "vectorized"       # "loop" | "vectorized" | "overlap"
    staleness: int = 0               # overlap: rounds a delivery lags
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
    sampler: Optional[ParticipantSampler] = None
    channel: Optional[ChannelSpec] = None   # wire codec (None = identity)

    def __post_init__(self):
        if self.n_devices < 1:
            raise ValueError("n_devices must be >= 1")
        validate_protocol(self.mode, self.engine, self.ccl_score,
                          self.staleness, self.robust, self.trim_frac)


def _check_engine(spec: FederationSpec, engine: str) -> None:
    if engine not in ENGINES:
        raise ValueError(f"unknown engine {engine!r}")
    if spec.staleness > 0 and engine != "overlap":
        raise ValueError("staleness > 0 requires the overlap engine")
    if spec.faults is not None and not isinstance(spec.faults, FaultSpec):
        raise TypeError("faults must be repro_torch.core.spec.FaultSpec; "
                        f"got {type(spec.faults).__name__}")


class _Cohort:
    """Runtime state of one cohort: its model bundle, the contiguous
    global-client slice it owns, its globally normalized Eq. 13 weights,
    the server-shape-shared key subset, the wire templates and byte costs,
    its members' parameters and optimizer states, and its steps.  The
    loop engine keeps one tree per member (``device_params``,
    ``device_opt``; none under a sampler: the store holds them); the
    vectorized engine one stacked tree (``stacked_params``: the backbone
    once, the personal leaves (work_n, ...)) and one stacked AdamW state
    (``stacked_opt``), with its padded eval shards (``eval_steps``; per
    sampled member set in ``eval_cache`` under a sampler).  The overlap
    engine adds the cohort's stale anchor model: ``anchor_base`` (the
    server LLM's tree: its frozen leaves are the server's own tensors)
    and ``anchor_tr`` (the trainables of the last applied delivery)."""

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
        self.eval_cache: Dict = {}   # sampled eval shards, by member tuple
        self.anchor_base: Optional[dict] = None
        self.anchor_tr: Dict = {}
        # the round's working set (the whole cohort without a sampler):
        # the stacked buffers hold work_n clients, and every per-round
        # vector (weights, presence, attack scale) is indexed by
        # work_slice
        self.work_n = spec.n_clients
        self.work_offset = offset
        # the cohort's placement on its mesh (:meth:`FederatedRunner.
        # _place_on_mesh`): this rank's block of the stacked client axis
        # (an index; the whole axis without a split), whether this rank
        # holds any of it, the data group the blocks are gathered over
        # (None: no split), the rank that broadcasts the gathered stacks to
        # the ranks the mesh leaves out (None: it leaves none out), and the
        # full stacks' meta templates for those gathers
        self.blk: tuple = (slice(None),)
        self.member = True
        self.group = None
        self.root: Optional[int] = None
        self.like: Optional[Dict] = None

    @property
    def slice(self) -> slice:
        """Global client-index slice of this cohort's members."""
        return slice(self.offset, self.offset + self.n)

    @property
    def work_slice(self) -> slice:
        """This cohort's block of the round's working-set vectors (equal
        to :attr:`slice` without a sampler)."""
        return slice(self.work_offset, self.work_offset + self.work_n)


class FederatedRunner:
    """A federation of cohorts and the cloud server, on the loop, the
    vectorized or the overlap engine (``engine``, default the spec's):

        ``FederatedRunner(spec, corpus, mesh=None, engine=None,
        device="cuda", init_state=None, store_dir=None)``

    or through the legacy single-cohort shim:

        ``FederatedRunner(cfg, slm_bundle, llm_bundle, corpus, ...)``

    The states are drawn from a ``torch.Generator`` seeded with the seed
    on ``device`` unless ``init_state`` gives them: a dict of flat numpy
    trees (``interop`` format) with ``"cohort_bases"`` (one shared
    unified SLM per cohort; the legacy ``"cohort_base"`` names cohort 0's),
    ``"personal"`` (each global client's trainable leaves),
    ``"server_slm"`` and ``"server_llm"``.  Under a sampler the population
    is registered in a :class:`ClientStore` (``store_dir`` spills it to
    one file a client).  The runner runs on the card; ``device="cpu"``
    asks for the CPU.  ``mesh`` (a DeviceMesh of ``device``'s type, built
    after the process group) splits the stacked engines' client axis over
    its "data" ranks; a per-cohort list of meshes (the overlap engine
    only) puts each cohort on its own ranks.  Every rank builds the runner
    with the same arguments and runs the same rounds.  An overlap runner
    owns threads: call :meth:`close` when done with it."""

    def __init__(self, spec, *args, mesh=None, engine: Optional[str] = None,
                 device="cuda", init_state: Optional[Dict] = None,
                 store_dir: Optional[str] = None):
        if isinstance(spec, FederationSpec):
            if len(args) != 1:
                raise TypeError("FederatedRunner(spec, corpus, mesh=..., "
                                "engine=..., device=..., init_state=...)")
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
        _check_engine(spec, self.engine)
        self._stacked = self.engine in ("vectorized", "overlap")
        self._overlap = self.engine == "overlap"
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("CUDA is not available; pass device='cpu' "
                               "to run the round on the CPU")
        if isinstance(mesh, (list, tuple)):
            if len(mesh) != spec.n_cohorts:
                raise ValueError(
                    f"per-cohort mesh list has {len(mesh)} entries for "
                    f"{spec.n_cohorts} cohorts")
            if self.engine != "overlap":
                raise ValueError(
                    "per-cohort meshes need engine='overlap'; pass a single "
                    "shared mesh for the other engines")
            self._meshes: Optional[Tuple] = tuple(mesh)
            self.mesh = None
        else:
            self._meshes = None
            self.mesh = mesh
        for m in self._meshes or (mesh,):
            if m is not None and m.device_type != self.device.type:
                raise ValueError(f"a {m.device_type!r} mesh for a runner on "
                                 f"{self.device}")
        # the ranks running this federation (1 without a mesh), and the
        # overlap engine's server rank past one rank: the world's last
        self._world = (dist.get_world_size()
                       if any(m is not None for m in self._meshes or (mesh,))
                       else 1)
        self._server_rank = (self._world - 1
                             if self._overlap and self._world > 1 else None)
        self.channel = (spec.channel or ChannelSpec()).make()
        self.slm = bundles[0]        # legacy alias: cohort 0's bundle
        self.llm = llm_bundle
        self._srv_slm_bundle = srv_slm_bundle
        N = cfg.n_devices
        # a token id at or past a model's vocabulary is no token of it, and
        # past its padded rows it indexes past the embedding (on the card
        # an out-of-range gather; the reference's jnp.take fills NaN), so
        # every model must cover the corpus
        top = int(np.max(corpus["tokens"]))
        short = sorted({m.cfg.name for m in [*bundles, llm_bundle,
                                             srv_slm_bundle]
                        if m.cfg.vocab_size <= top})
        if short:
            raise ValueError(f"corpus token ids reach {top}, past the "
                             f"vocabulary of {short}")

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
        self._rnd_present = None     # (S,) bool — training + delivery mask
        self._rnd_contrib = None     # (S,) bool — aggregation mask
        self._rnd_weights = None     # (S,) f32 — survivor-renormalized
        self._attack_scale = None    # (N,) f32 — scaled-update factors
        # participant sampling: the registered population (the store) and
        # the round's working set; the per-round vectors above are
        # working-set sized (S == N without a sampler)
        self._schedule = (ParticipantSchedule(
            spec.sampler, [c.n_clients for c in spec.cohorts], spec.offsets)
            if spec.sampler is not None else None)
        self._store = (ClientStore(store_dir)
                       if self._schedule is not None else None)
        self._rnd_locals = None      # per-cohort sampled LOCAL indices
        self._rnd_ids = None         # (S,) sampled GLOBAL client ids
        self._rnd_scale = None       # (S,) the attack scale of the sampled
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
        if self._store is not None:
            # the registered population: every client's personal state
            # (with a zero error-feedback residual under a stateful codec)
            # on the host; the device keeps the working set only
            for j, (p, o) in enumerate(zip(device_params, device_opt)):
                entry = {"train": lora.partition(p), "opt": o}
                if self.channel.stateful:
                    entry["chan"] = {
                        k: torch.zeros(v.shape, dtype=torch.float32)
                        for k, v in lora.partition(
                            p, lora.is_lora_leaf).items()}
                self._store.put(j, entry)

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
        counts = (self._schedule.counts if self._schedule is not None
                  else [c.n_clients for c in spec.cohorts])
        for c, cs in enumerate(spec.cohorts):
            rt = _Cohort(c, cs, bundles[c], spec.offsets[c])
            rt.work_n = counts[c]
            rt.work_offset = sum(counts[:c])
            rt.weights = (self.agg_weights if spec.n_cohorts == 1
                          else self.agg_weights[rt.slice])
            rt.w_total = float(rt.weights.cpu().numpy().astype(np.float32)
                               .sum(dtype=np.float32))
            # the members' states (under a sampler: round 0's draw, which
            # the stacked buffers are seeded with; the store holds all)
            members = [rt.offset + i for i in self._members(rt, 0)]
            rt.device_params = [device_params[j] for j in members]
            rt.device_opt = [device_opt[j] for j in members]
            up0 = lora.partition(rt.device_params[0], lora.is_lora_leaf)
            rt.shared = lora.shared_keys(up0, server_lora)
            rt.own = tuple(k for k in sorted(up0) if k not in rt.shared)
            rt.own_dtypes = {k: up0[k].dtype for k in rt.own}
            rt.last_global = {k: server_lora[k] for k in rt.shared}
            # the wire: the stacked upload template, the error-feedback
            # residuals (f32, (work_n, ...)) and the exact per-round byte
            # costs (bytes_on_wire is linear in the client axis)
            rt.up_like = {k: TensorSpec((rt.work_n, *v.shape), v.dtype)
                          for k, v in up0.items()}
            rt.chan_state = self.channel.init_state(rt.up_like, self.device)
            rt.uplink_client_bytes = \
                self.channel.bytes_on_wire(rt.up_like) // rt.work_n
            rt.dense_client_bytes = \
                ident.bytes_on_wire(rt.up_like) // rt.work_n
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
                bs_c = spec.cohort_batch_size(c)
                rt.eval_blocks = max(
                    -(-self.priv_test[j]["tokens"].shape[0] // bs_c)
                    for j in range(rt.offset, rt.offset + rt.n))
                rt.eval_fn = seccl.make_eval_fn(rt.bundle,
                                                n_clients=rt.work_n)
            else:
                rt.eval_step = seccl.make_eval_step(rt.bundle)
                if self._schedule is not None:
                    rt.device_params, rt.device_opt = [], []
            self._cohorts.append(rt)
        del device_params, device_opt
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
        self.exchanged_bytes = 0     # bytes the client-axis gathers received
        if self._stacked:
            self._place_on_mesh()
        self.refresh_eval_shards()
        self.history: List[Dict] = []
        self._srv_q: collections.deque = collections.deque()
        self._srv_stream = self._srv_event = None
        self._prefetch = self._staged_gather = None
        if self._overlap:
            self._init_overlap()

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
    # placement on a mesh

    @property
    def _serves(self) -> bool:
        """Does this rank hold the server (every rank but past one rank
        on the overlap engine, where the last one does)?"""
        return self._server_rank is None or \
            dist.get_rank() == self._server_rank

    def _server_state(self) -> Dict:
        """The server models and their AdamW states, by attribute name."""
        return {name: getattr(self, name) for name in _SERVER_STATE}

    def _mesh_for(self, idx: int):
        """The mesh cohort ``idx`` lives on (shared, per-cohort, or None)."""
        return self._meshes[idx] if self._meshes is not None else self.mesh

    def _placement_key(self, rt: _Cohort):
        """Identity of cohort ``rt``'s client placement: cohorts with the
        same key share downloaded server products (the anchor base)."""
        m = self._mesh_for(rt.idx)
        return id(m) if m is not None else None

    def _to_client_placement(self, rt: _Cohort, tree):
        """A server product where cohort ``rt``'s clients live: whole on
        its mesh's device (the same tensors where they are there
        already)."""
        m = self._mesh_for(rt.idx)
        return tree if m is None else shard_part.replicated(tree, m)

    def _place_on_mesh(self) -> None:
        """Each cohort's client stack (personal leaves, AdamW state; under
        a sampler the round's working set) to this rank's block of its
        mesh's "data" axis (:meth:`_block`), and the server state whole on
        every rank: an exact no-op at data size 1 (the leaves stay the same
        tensors).  Records each cohort's block, data group and broadcast
        root, and the meta templates of its full stacks for
        :meth:`_exchange`."""
        meshes = {}
        for rt in self._cohorts:
            m = self._mesh_for(rt.idx)
            if m is None:
                continue
            meshes[id(m)] = m
            n = rt.work_n
            axes = shard_part.client_axes(n, m, TRAIN_RULES)
            if len(axes) > 1:
                raise NotImplementedError("a client axis over several mesh "
                                          "axes")
            blk = shard_part.client_block(n, m, TRAIN_RULES)
            personal = lora.partition(rt.stacked_params)
            rt.like = {"personal": _meta(personal),
                       "opt": _meta(rt.stacked_opt),
                       "up": _meta(lora.partition(personal,
                                                  lora.is_lora_leaf)),
                       "eval": {k: torch.empty((n,), dtype=torch.float32,
                                               device="meta")
                                for k in seccl.EVAL_SUM_KEYS}}
            rt.member = blk is not None
            rt.root = (None if m.mesh.numel() == dist.get_world_size()
                       else int(m.mesh.min()))
            if rt.member:
                rt.blk = blk
                if axes:
                    rt.group = m.get_group(axes[0])
            else:
                rt.blk = (slice(0, 0),)
            rt.stacked_params = lora.combine(rt.stacked_params,
                                             self._block(rt, personal))
            rt.stacked_opt = self._block(rt, rt.stacked_opt)
            rt.last_global = self._to_client_placement(rt, rt.last_global)
            rt.weights = self._to_client_placement(rt, rt.weights)
        for m in meshes.values():
            for name in _SERVER_STATE:
                setattr(self, name, shard_part.replicated(getattr(self, name),
                                                          m))

    def _block(self, rt: _Cohort, tree):
        """This rank's block of a whole (work_n, ...) client stack of
        cohort ``rt`` on the device: the stack itself (moved) without a
        mesh or where the block is the whole axis, a copy of the block
        where the mesh splits it, an empty block on a rank the mesh leaves
        out."""
        m = self._mesh_for(rt.idx)
        if m is None:
            return _to_device(tree, self.device)
        if not rt.member:
            return map_pytree(lambda v: v[:0].to(self.device), tree)
        return shard_part.place_stacked(tree, m, TRAIN_RULES)

    def _whole_stacks(self, rt: _Cohort) -> Tuple[Dict, Dict]:
        """Cohort ``rt``'s whole (personal leaves, AdamW state) stacks on
        every rank (:meth:`_exchange`; collective on a mesh that splits
        them)."""
        return (self._exchange(rt, lora.partition(rt.stacked_params)
                               if rt.member else None, "personal"),
                self._exchange(rt, rt.stacked_opt if rt.member else None,
                               "opt"))

    def _exchange(self, rt: _Cohort, local, kind: str):
        """The cohort's whole client stack on every rank, from this rank's
        block ``local`` (a dict of (n_block, ...) leaves, nested dicts
        allowed; None on a rank the cohort's mesh leaves out): the blocks
        all-gathered over the data group in client order, one packed
        tensor a dtype, then broadcast from the mesh's first rank to the
        ranks it leaves out.  ``kind`` names the template of the whole
        stack in ``rt.like`` ("personal", "opt", "up", "eval").  ``local``
        itself where nothing needs moving (no mesh, or the whole stack on
        every rank of a mesh that covers them all)."""
        if rt.like is None or (rt.group is None and rt.root is None):
            return local
        return self._exchange_tree(rt, local, rt.like[kind])

    def _exchange_tree(self, rt: _Cohort, local, like) -> Dict:
        out = {k: self._exchange_tree(rt, None if local is None else local[k],
                                      v)
               for k, v in like.items() if isinstance(v, dict)}
        groups: Dict = {}
        for k in sorted(k for k, v in like.items()
                        if not isinstance(v, dict)):
            groups.setdefault(like[k].dtype, []).append(k)
        for dtype, keys in groups.items():
            tails = [tuple(like[k].shape[1:]) for k in keys]
            widths = [math.prod(t) for t in tails]
            if local is not None:
                buf = torch.cat([local[k].reshape(local[k].shape[0], -1)
                                 for k in keys], dim=1)
                if rt.group is not None:
                    buf = torch.cat(coll.all_gather(buf, rt.group), dim=0)
            else:
                buf = torch.empty((rt.work_n, sum(widths)), dtype=dtype,
                                  device=self.device)
            if rt.root is not None:
                dist.broadcast(buf, src=rt.root)
            self.exchanged_bytes += buf.numel() * buf.element_size()
            for k, t, col in zip(keys, tails,
                                 torch.split(buf, widths, dim=1)):
                out[k] = col.reshape((rt.work_n, *t)).contiguous()
        return out

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
    def store(self) -> Optional[ClientStore]:
        """The registered population (None without a sampler: all client
        state is then resident)."""
        return self._store

    def _members(self, rt: _Cohort, rnd: Optional[int] = None) -> List[int]:
        """Local indices of cohort ``rt``'s working set: every member
        without a sampler, else round ``rnd``'s draw (default: the draw
        the current client state belongs to, :meth:`_active_locals`)."""
        if self._schedule is None:
            return list(range(rt.n))
        locs = (self._active_locals() if rnd is None
                else self._schedule.round_locals(rnd))
        return [int(i) for i in locs[rt.idx]]

    def _loop_client_state(self, rt: _Cohort, i: int):
        """Client ``rt.offset + i``'s parameters and AdamW state on the
        loop engine: the resident trees, or under a sampler the cohort's
        backbone with the client's stored personal leaves, on the
        device."""
        if self._schedule is None:
            return rt.device_params[i], rt.device_opt[i]
        st = self._store.get(rt.offset + i)
        return (lora.combine(self.cohort_bases[rt.idx],
                             _to_device(st["train"], self.device)),
                _to_device(st["opt"], self.device))

    @property
    def device_params(self) -> List[dict]:
        """Every device's parameter tree, in global client order (views of
        the stacks under the vectorized engine: the cohort's backbone and
        the client's slice of each personal leaf; under a sampler every
        registered client's, from the store).  On a mesh that splits the
        clients every rank gathers them all: every rank must read it."""
        if self._schedule is not None:
            return [self._loop_client_state(rt, i)[0]
                    for rt in self._cohorts for i in range(rt.n)]
        if self._stacked:
            out = []
            for rt in self._cohorts:
                personal = self._exchange(
                    rt, lora.partition(rt.stacked_params) if rt.member
                    else None, "personal")
                out += [lora.combine(rt.stacked_params,
                                     lora.gather_client(personal, i))
                        for i in range(rt.n)]
            return out
        return [p for rt in self._cohorts for p in rt.device_params]

    @property
    def device_opt(self) -> List:
        """Every device's optimizer state, in global client order (gathered
        as :attr:`device_params` is on a mesh that splits the clients)."""
        if self._schedule is not None:
            return [self._loop_client_state(rt, i)[1]
                    for rt in self._cohorts for i in range(rt.n)]
        if self._stacked:
            return [o for rt in self._cohorts
                    for o in lora.unstack_tree(self._exchange(
                        rt, rt.stacked_opt if rt.member else None, "opt"),
                        rt.n)]
        return [o for rt in self._cohorts for o in rt.device_opt]

    @property
    def stacked_params(self) -> dict:
        """Legacy single-cohort view of the stacked parameters (the
        vectorized engine; this rank's block on a mesh)."""
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
    def stacked_anchors(self, pub: Dict[str, torch.Tensor],
                        llm_params: Optional[dict] = None) -> torch.Tensor:
        """:meth:`anchors` for a cohort's stacked public batch (G, B, ...)
        at once: (G, B, c), from ``llm_params`` (default the live server
        LLM; the overlap engine passes the cohort's anchor model)."""
        batch = dict(pub, modality_mask=torch.ones_like(pub["modality_mask"]))
        return ccl_lib.stacked_server_anchors(
            self.server_llm if llm_params is None else llm_params, self.llm,
            batch)

    # ------------------------------------------------------------------
    # per-round fault state (no-ops without a FaultSpec)

    def _begin_round(self) -> None:
        """Advance the round counter and draw the round's host state: the
        sampled participants (under a sampler, with their attack scale),
        the presence and straggle masks restricted to them, and the Eq. 13
        weights renormalized over the contributing (sampled, present and
        on-time) clients."""
        cfg = self.cfg
        rnd = self._rnd_no = self._round_idx
        self._round_idx += 1
        ids = None
        if self._schedule is not None:
            self._rnd_locals = self._schedule.round_locals(rnd)
            self._rnd_ids = ids = np.concatenate([
                off + loc for off, loc in zip(self.spec.offsets,
                                              self._rnd_locals)])
            self._rnd_scale = (self._attack_scale[ids]
                               if self._attack_scale is not None else None)
        if self._faults is None:
            if ids is None:
                return
            # weights renormalized over the sampled set (the identity
            # sampler gives the init-time weights bit for bit); presence
            # stays None
            if cfg.use_mma and cfg.mode == "mlecs":
                w = mma.sampled_weights(self._mod_counts, ids).numpy()
            else:
                w = np.ones((len(ids),), np.float32) / len(ids)
            self._rnd_weights = np.array(w, np.float32)
            return
        present, ontime = self._faults.round_masks(rnd)
        if ids is not None:
            present = present[ids].copy()
            ontime = ontime[ids].copy()
            if not bool((present & ontime).any()):
                # a sampled set whose every member failed would push an
                # all-zero weight vector to the server: revive one member
                # (its upload is its pre-round state)
                present[0] = ontime[0] = True
        contrib = present & ontime
        if cfg.use_mma and cfg.mode == "mlecs":
            w = (mma.aggregation_weights(self._mod_counts, present=contrib)
                 if ids is None else mma.sampled_weights(
                     self._mod_counts, ids, present=contrib)).numpy()
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
        """The cohort's weights this round (fault-masked under faults,
        over the working set under a sampler)."""
        if self._rnd_weights is None:
            return rt.weights
        return torch.as_tensor(self._rnd_weights[rt.work_slice],
                               device=self.device)

    def _w_total_for(self, rt: _Cohort) -> float:
        """The cohort's weight mass this round (its surviving sampled mass
        under faults: the combine's renormalization denominator)."""
        if self._rnd_weights is None:
            return rt.w_total
        return float(self._rnd_weights[rt.work_slice].sum(dtype=np.float32))

    def _present_for(self, rt: _Cohort) -> Optional[torch.Tensor]:
        """The cohort's block of the presence mask (None without faults)."""
        if self._rnd_present is None:
            return None
        return torch.as_tensor(self._rnd_present[rt.work_slice],
                               device=self.device)

    def _scale_for(self, rt: _Cohort) -> Optional[np.ndarray]:
        """The cohort's working-set block of the Byzantine scale vector
        (None without a scaled-update attack)."""
        if self._rnd_scale is not None:
            return self._rnd_scale[rt.work_slice]
        if self._attack_scale is not None:
            return self._attack_scale[rt.slice]
        return None

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
            wsl = w[rt.work_slice]
            csl = None if contrib is None else contrib[rt.work_slice]
            mass = float(wsl.sum() if csl is None else (wsl * csl).sum())
            if not rt.own or not mass > 0.0:
                own_avgs.append({})
                continue
            own_avgs.append(mma.aggregate_stacked(
                {k: p[k] for k in rt.own}, wsl, robust=cfg.robust,
                present=csl, trim_frac=cfg.trim_frac))
        agg = mma.robust_combine_cohorts(
            payloads, [w[rt.work_slice] for rt in self._cohorts],
            [rt.shared for rt in self._cohorts],
            self._server_lora_dtypes, cfg.robust,
            present=(None if contrib is None else
                     [contrib[rt.work_slice] for rt in self._cohorts]),
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
        of the PRESENT clients only.  On the loop engine under a sampler
        the residuals come from the members' store entries and go back
        there."""
        chan = self.channel
        in_store = chan.stateful and self._store is not None \
            and not self._stacked
        out = []
        for rt, stacked in zip(self._cohorts, uploads):
            if in_store:
                ids = [rt.offset + i for i in self._members(rt)]
                rt.chan_state = _to_device(self._store.gather(ids)["chan"],
                                           self.device)
            # stateless codecs hold {} as their state and get {} back
            dec, new_state = chan.roundtrip(stacked, rt.chan_state,
                                            self._rnd_no)
            if chan.stateful:
                pres = self._present_for(rt)
                if pres is not None:
                    new_state = _where_clients(pres, new_state,
                                               rt.chan_state)
                rt.chan_state = new_state
            if in_store:
                for pos, cid in enumerate(ids):
                    entry = dict(self._store.get(cid))
                    entry["chan"] = lora.gather_client(new_state, pos)
                    self._store.put(cid, entry)
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
                bcast = _where_clients(pres[rt.blk], bcast, cur)
            rt.stacked_params = lora.combine(rt.stacked_params, bcast)
            return
        pres = self._rnd_present
        for pos, i in enumerate(self._members(rt)):
            if pres is not None and not pres[rt.work_offset + pos]:
                continue
            if self._store is None:
                rt.device_params[i] = lora.combine(rt.device_params[i],
                                                   delivery)
                continue
            # the stored personal leaves; every other entry key (the
            # residual "chan") stays as it is
            j = rt.offset + i
            st = self._store.get(j)
            train = dict(st["train"])
            train.update({k: v for k, v in delivery.items() if k in train})
            self._store.put(j, dict(st, train=train))

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
            n = rt.work_n
            if self._rnd_present is not None:
                n = int(self._rnd_present[rt.work_slice].sum())
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
        metrics after SE-CCL; redistribution seeds the next round.  Under
        a sampler the round's participants train (their rows gathered from
        the store and scattered back at the end) and the metrics are
        theirs.  With ``evaluate=False`` no metric is computed and ``{}``
        is returned.  The overlap engine's round is
        :meth:`_run_round_overlap`."""
        if self._overlap:
            return self._run_round_overlap(evaluate)
        self._begin_round()
        self._load_working_set(self._rnd_no)
        # (1)-(2) the device side: per client (loop) or per cohort
        # (vectorized); each cohort's uploads stacked on the client axis
        uploads = (self._device_phase_stacked() if self._stacked
                   else self._device_phase_loop())
        client_eval = self.evaluate_clients() if evaluate else None
        if self.cfg.mode != "standalone":
            self._server_side(uploads)
        self._scatter_working_set()
        self._commit_comm()
        return self._finalize_eval(client_eval) if evaluate else {}

    # ------------------------------------------------------------------
    # the overlap engine: the server phase pipelined behind the device
    # phases by ``staleness`` rounds

    def _init_overlap(self) -> None:
        """The server stream (on the card), each cohort's anchor model
        (the server LLM's own tree: no copy of its frozen leaves), the
        batch prefetcher and, under a sampler, round 0's staged gather.
        Past one rank the server lives on the server rank only: the
        others keep the templates of what it broadcasts and drop the
        server models and AdamW states (their anchor base keeps the LLM's
        frozen leaves)."""
        if self.device.type == "cuda" and self._srv_stream is None:
            self._srv_stream = torch.cuda.Stream(self.device)
        bases = {}
        for rt in self._cohorts:
            key = self._placement_key(rt)
            if key not in bases:
                bases[key] = self._to_client_placement(rt, self.server_llm)
            rt.anchor_base = bases[key]
            rt.anchor_tr = lora.partition(rt.anchor_base)
        if self._server_rank is not None:
            self._server_like = _meta(self._server_state())
            self._delivery_like = {
                "down": _meta(lora.partition(self.server_slm,
                                             lora.is_lora_leaf)),
                "anchor_tr": _meta(lora.partition(self.server_llm))}
            if not self._serves:
                for name in _SERVER_STATE:
                    setattr(self, name, None)
        self._assemble_idx = self._round_idx
        self._start_prefetch()
        if self._schedule is not None:
            self._stage_gather_for(self._round_idx)

    def _start_prefetch(self) -> None:
        """(Re)start the round-assembly worker.  It holds the runner
        weakly and stops once the runner is collected (:meth:`close` is
        the deterministic path).  While it lives it is the only reader of
        the data streams."""
        ref = weakref.ref(self)

        def assemble():
            runner = ref()
            return None if runner is None else runner._assemble_round()

        self._prefetch = RoundPrefetcher(assemble,
                                         alive=lambda: ref() is not None)

    def _assemble_round(self) -> Tuple[List[Tuple], Optional[Dict]]:
        """The next assembled round's host batches: each cohort's
        ``(pub, priv)`` stacks and the server's (server_steps, B, ...)
        stack (None without SE-CCL).  Runs on the prefetch worker, its
        round counter ahead of the applied rounds (a sampler's draws are
        a function of the round, so the worker draws the same sets)."""
        rnd = self._assemble_idx
        self._assemble_idx += 1
        return self._assemble_cohorts(rnd), self._server_steps()

    def _server_steps(self) -> Optional[Dict]:
        """The round's server batches, (server_steps, B, ...) host stacks
        (None without SE-CCL)."""
        if not _do_seccl(self.cfg):
            return None
        return self._streams.stack_steps("server", self.cfg.server_steps)

    def _server_phase(self, agg: Dict, steps: Optional[Dict]) -> Tuple:
        """:meth:`_server_chain` on the server stream (inline on the CPU):
        the stream first waits for the work queued so far on the caller's
        stream (the aggregate), and every tensor of its inputs is marked
        as used there.  Returns ``(down, anchor_tr, done)``, ``done`` the
        event that ends the phase (None on the CPU)."""
        stream = self._srv_stream
        if stream is None:
            return (*self._server_chain(agg, steps), None)
        ready = torch.cuda.current_stream(self.device).record_event()
        with torch.cuda.stream(stream):
            stream.wait_event(ready)
            _record_stream((agg, self.server_llm, self.server_slm,
                            self.server_llm_opt, self.server_slm_opt),
                           stream)
            down, anchor_tr = self._server_chain(agg, steps)
            self._srv_event = stream.record_event()
        return down, anchor_tr, self._srv_event

    def _sync_server(self) -> None:
        """Order the caller's stream after every server phase queued so
        far and mark the server's tensors as used there (a no-op without a
        server stream)."""
        if self._srv_event is None:
            return
        cur = torch.cuda.current_stream(self.device)
        cur.wait_event(self._srv_event)
        _record_stream((self.server_llm, self.server_slm,
                        self.server_llm_opt, self.server_slm_opt), cur)

    def _run_round_overlap(self, evaluate: bool = True) -> Dict:
        """One pipelined round: every cohort's device phase on the
        prefetched batches, anchored on its anchor model; the uplink and
        the combine; the server phase (on the server stream), pushed onto
        the staleness queue; the client eval on the post-AMT models while
        the server phase runs; then, once the queue holds more than
        ``staleness`` outputs, the oldest delivered (this round's presence
        mask and downlink round) and the anchor trainables replaced.
        Under fedavg the queued output is the aggregate itself.  Past one
        rank only the server rank runs the server phase, and it
        broadcasts the delivery and the anchor trainables as they are
        applied."""
        cfg = self.cfg
        self._begin_round()
        self._load_working_set(self._rnd_no)
        batches, server = next(self._prefetch)
        uploads = self._device_phase_stacked(batches)
        if cfg.mode != "standalone":
            agg, own_avgs = self._combine_payloads(
                self._encode_uploads(uploads))
            if cfg.mode == "fedavg":
                self._srv_q.append((agg, None, own_avgs, None))
            elif self._serves:
                down, anchor_tr, done = self._server_phase(agg, server)
                self._srv_q.append((down, anchor_tr, own_avgs, done))
            else:
                self._srv_q.append((None, None, own_avgs, None))
        client_eval = self.evaluate_clients() if evaluate else None
        if len(self._srv_q) > cfg.staleness:
            down, anchor_tr, own_avgs, done = self._srv_q.popleft()
            if done is not None:
                cur = torch.cuda.current_stream(self.device)
                cur.wait_event(done)
                _record_stream((down, anchor_tr), cur)
            if self._server_rank is not None and cfg.mode != "fedavg":
                got = coll.broadcast_tree(
                    {"down": down, "anchor_tr": anchor_tr}
                    if self._serves else None, self._delivery_like,
                    self._server_rank, self.device)
                down, anchor_tr = got["down"], got["anchor_tr"]
            self._apply_deliveries(down, own_avgs)
            if anchor_tr is not None:
                for rt in self._cohorts:
                    rt.anchor_tr = anchor_tr
        self._scatter_working_set()
        if self._schedule is not None:
            # round r+1's store gather, on a thread, behind this round
            self._stage_gather_for(self._round_idx)
        self._commit_comm()
        return self._finalize_eval(client_eval) if evaluate else {}

    def _stage_gather_for(self, rnd: int) -> None:
        """Start round ``rnd``'s store gather (host work only) on a
        thread; :meth:`_load_working_set` joins it."""
        box = {"out": None, "err": None, "rnd": rnd}

        def work():
            try:
                box["out"] = self._gather_host(rnd)
            except Exception as e:  # noqa: BLE001 — re-raised at the join
                box["err"] = e

        box["thread"] = threading.Thread(target=work, name="store-gather",
                                         daemon=True)
        self._staged_gather = box
        box["thread"].start()

    def sync(self) -> "FederatedRunner":
        """Wait for the clients' side of the queued work (on the card: the
        caller's stream; under the overlap engine the server phase is off
        that path, :meth:`drain` waits for it too)."""
        if self.device.type == "cuda":
            torch.cuda.current_stream(self.device).synchronize()
        return self

    def drain(self) -> "FederatedRunner":
        """Wait for all queued work: every cohort's state, the server
        chain and the pending server outputs (every stream of the
        device)."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return self

    def close(self) -> None:
        """Stop the overlap engine's threads (the prefetcher, and a staged
        gather, which is dropped); a no-op on the other engines, safe to
        call twice."""
        box, self._staged_gather = self._staged_gather, None
        if box is not None:
            box["thread"].join()
        pf, self._prefetch = self._prefetch, None
        if pf is not None:
            pf.close()

    def _server_side(self, uploads: List[Dict]) -> None:
        """The uplink wire, then (3) MMA over what the server received
        (f32, left to right over the clients, then cohort order per key;
        the devices keep their own undecoded parameters), then (4) SE-CCL
        and (5) the redistribution; under fedavg the average goes straight
        back."""
        agg, own_avgs = self._combine_payloads(self._encode_uploads(uploads))
        if self.cfg.mode != "fedavg":
            agg, _ = self._server_chain(agg, self._server_steps())
        self._apply_deliveries(agg, own_avgs)

    def _server_chain(self, agg: Dict, steps: Optional[Dict]
                      ) -> Tuple[Dict, Dict]:
        """The aggregate lands in the server SLM, then (4) SE-CCL on the
        server batches ``steps`` (:meth:`_server_steps`).  Returns what
        the clients get back: the server SLM's LoRA leaves and the server
        LLM's trainables (the overlap engine's anchor download)."""
        self.server_slm = lora.combine(self.server_slm, agg)
        if steps is not None:
            steps = to_tensors(steps, self.device)
            for t in range(self.cfg.server_steps):
                (self.server_llm, self.server_slm, self.server_llm_opt,
                 self.server_slm_opt, _) = self.se_step(
                    self.server_llm, self.server_slm, self.server_llm_opt,
                    self.server_slm_opt, {k: v[t] for k, v in steps.items()})
        return (lora.partition(self.server_slm, lora.is_lora_leaf),
                lora.partition(self.server_llm))

    def _apply_deliveries(self, down: Dict, own_avgs) -> None:
        """(5) Redistribution: each cohort's delivery (the server's values
        of its shared keys and its own-key averages) through the downlink
        with this round's index, spliced into its reachable members."""
        for c, rt in enumerate(self._cohorts):
            self._deliver(rt, self.channel.roundtrip_tree(
                self._cohort_delivery(rt, down, own_avgs[c]), self._rnd_no))

    # ------------------------------------------------------------------
    # the working set under a sampler: the round's participants gathered
    # from the store into the stacked buffers, scattered back at the end

    def _gather_host(self, rnd: int) -> List[Dict]:
        """Round ``rnd``'s participants' store entries, one host stack per
        cohort (cohort by cohort: their personal key sets may differ)."""
        return [self._store.gather([rt.offset + i
                                    for i in self._members(rt, rnd)])
                for rt in self._cohorts]

    def _load_working_set(self, rnd: int) -> None:
        """Gather round ``rnd``'s participants from the store into each
        cohort's stacked buffers (stacked engines under a sampler; one
        host stack and one transfer a leaf; the overlap engine's staged
        gather when it is this round's): the personal leaves and the AdamW
        state move, this rank's block of them on a mesh (:meth:`_block`),
        and the residuals whole (the wire runs whole on every rank); the
        backbone in the buffer never does.  Every rank holds the whole
        store and draws the same members."""
        if self._schedule is None or not self._stacked:
            return
        host, box = None, self._staged_gather
        if box is not None:
            self._staged_gather = None
            box["thread"].join()
            if box["err"] is not None:
                raise RuntimeError("staged store gather failed") \
                    from box["err"]
            if box["rnd"] == rnd:
                host = box["out"]
        if host is None:
            host = self._gather_host(rnd)
        for rt, h in zip(self._cohorts, host):
            rt.stacked_params = lora.combine(rt.stacked_params,
                                             self._block(rt, h["train"]))
            rt.stacked_opt = self._block(rt, h["opt"])
            if "chan" in h:
                rt.chan_state = _to_device(h["chan"], self.device)

    def _scatter_working_set(self) -> None:
        """Write the trained working set back to the store: the personal
        leaves, the AdamW state and the residuals, what construction
        registered (stacked engines under a sampler).  On a mesh that
        splits the working set the blocks are gathered first
        (:meth:`_whole_stacks`), so every rank writes the same entries and
        the stores stay equal."""
        if self._schedule is None or not self._stacked:
            return
        for rt in self._cohorts:
            train, opt = self._whole_stacks(rt)
            entry = {"train": train, "opt": opt}
            if self.channel.stateful:
                entry["chan"] = rt.chan_state
            self._store.scatter([rt.offset + i for i in self._members(rt)],
                                entry)

    def _device_phase_loop(self) -> List[Dict]:
        """The loop engine's device side: each member's CCL then AMT steps,
        one client at a time (under a sampler the round's participants,
        each read from the store and written back after AMT).  Returns
        each cohort's uploads (LoRA leaves, Byzantine-scaled where marked)
        stacked on the client axis."""
        cfg, spec = self.cfg, self.spec
        pres = self._rnd_present
        uploads: List[Dict] = []
        for rt in self._cohorts:
            k_ccl = spec.cohort_steps_ccl(rt.idx)
            k_amt = spec.cohort_steps_amt(rt.idx)
            members = self._members(rt)
            ups = []
            for pos, i in enumerate(members):
                j = rt.offset + i
                p, o = self._loop_client_state(rt, i)
                if pres is not None and not pres[rt.work_offset + pos]:
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
                if self._store is None:
                    rt.device_params[i], rt.device_opt[i] = p, o
                else:
                    # the whole entry is overwritten: carry the residual
                    # (it advances in _encode_uploads) forward
                    entry = {"train": lora.partition(p), "opt": o}
                    if self.channel.stateful:
                        entry["chan"] = self._store.get(j)["chan"]
                    self._store.put(j, entry)
                ups.append(lora.partition(p, lora.is_lora_leaf))
            scale = self._scale_for(rt)
            if scale is not None:
                # Byzantine scaled-update: every marked client reports
                # scale × u (a stale upload weighs 0 anyway)
                ups = [attacks.scaled_update(u, float(scale[pos]))
                       if scale[pos] != 1.0 else u
                       for pos, u in enumerate(ups)]
            uploads.append(lora.stack_clients(ups))
        return uploads

    def _assemble_cohorts(self, rnd: int) -> List[Tuple]:
        """Round ``rnd``'s host batch stacks, one ``(pub, priv)`` pair per
        cohort ((k, n, B, ...) numpy leaves over the round's working set,
        client-major per step; None for a phase with no step): every
        member pulls, offline ones too, so the streams advance as the
        loop engine's do."""
        cfg, spec = self.cfg, self.spec
        out = []
        for rt in self._cohorts:
            names = [rt.offset + i for i in self._members(rt, rnd)]
            k_ccl = spec.cohort_steps_ccl(rt.idx) if _do_ccl(cfg) else 0
            k_amt = spec.cohort_steps_amt(rt.idx)
            out.append(tuple(
                self._streams.gather_steps([f"{s}/{j}" for j in names], k)
                if k else None for s, k in (("pub", k_ccl), ("priv", k_amt))))
        return out

    def _device_phase_stacked(self, batches: Optional[List[Tuple]] = None
                              ) -> List[Dict]:
        """The stacked engines' device side: per cohort, the round's
        batches of all its clients (pulled here, or the overlap engine's
        prefetched ``batches``; one transfer per phase), then each CCL and
        AMT step as ONE stacked step for all clients, anchored on the live
        server LLM (the overlap engine: the cohort's anchor model).
        Offline clients train with the others and are selected back
        (parameters and AdamW state, the step count included).  Under a
        sampler the stack is the round's working set.  On a mesh each rank
        trains its block of the clients (every cohort first, so that
        cohorts on disjoint ranks train at once), then the blocks' uploads
        are gathered.  Returns each cohort's uploads stacked on the client
        axis."""
        cfg, spec = self.cfg, self.spec
        if batches is None:
            batches = self._assemble_cohorts(self._rnd_no)
        uploads: List[Optional[Dict]] = []
        for rt, (pub_np, priv_np) in zip(self._cohorts, batches):
            if not rt.member:
                uploads.append(None)
                continue
            cols = (slice(None), *rt.blk)     # (k, n, B, ...) host stacks
            p0, o0 = rt.stacked_params, rt.stacked_opt
            p, o = p0, o0
            if pub_np is not None:
                llm = (lora.combine(rt.anchor_base, rt.anchor_tr)
                       if self._overlap else None)
                pubs = to_tensors({k: v[cols] for k, v in pub_np.items()},
                                  self.device)
                for t in range(spec.cohort_steps_ccl(rt.idx)):
                    pub = {k: v[t] for k, v in pubs.items()}
                    p, o, _ = rt.ccl_step(p, o, pub,
                                          self.stacked_anchors(pub, llm))
            gref = rt.last_global if cfg.prox_weight > 0 else None
            k_amt = spec.cohort_steps_amt(rt.idx)
            if priv_np is not None:
                privs = to_tensors({k: v[cols] for k, v in priv_np.items()},
                                   self.device)
                for t in range(k_amt):
                    p, o, _ = rt.amt_step(
                        p, o, {k: v[t] for k, v in privs.items()}, None, gref)
            pres = self._present_for(rt)
            if pres is not None:
                # an offline client's round does not happen: its training
                # is undone by a per-client select
                pres = pres[rt.blk]
                p = lora.combine(p, _where_clients(
                    pres, lora.partition(p), lora.partition(p0)))
                o = _where_clients(pres, o, o0)
            rt.stacked_params, rt.stacked_opt = p, o
            up = lora.partition(p, lora.is_lora_leaf)
            scale = self._scale_for(rt)
            if scale is not None:
                up = _scale_uploads(up, scale[rt.blk])
            uploads.append(up)
        return [self._exchange(rt, up, "up")
                for rt, up in zip(self._cohorts, uploads)]

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
        in padded (T, n, B, ...) steps at the cohort's batch size (under a
        sampler built per draw: the cache is emptied), and the server's
        (T, B, ...) steps, on the runner's device.  Call it after changing
        a test set; a no-op on the loop engine (which reads the test sets
        live)."""
        if not self._stacked:
            return
        for rt in self._cohorts:
            rt.eval_cache.clear()
            if self._schedule is not None:
                continue
            sl = rt.slice
            steps = stack_eval_steps(stacked_eval_batches(
                self.priv_test[sl], self.spec.cohort_batch_size(rt.idx),
                self.masks[sl]))
            # (T, n, B, ...): this rank's block of the clients
            rt.eval_steps = (to_tensors({k: v[(slice(None), *rt.blk)]
                                         for k, v in steps.items()},
                                        self.device)
                             if rt.member else None)
        self._server_eval_steps = to_tensors(stack_eval_steps(
            np_eval_batches(self.public_test, self.cfg.batch_size)),
            self.device)

    def _active_locals(self) -> List[np.ndarray]:
        """The per-cohort sampled local indices the CURRENT client state
        belongs to: this round's draw once :meth:`_begin_round` ran, else
        the next round's (the stacked buffers were seeded or restored with
        exactly that draw)."""
        if self._rnd_locals is not None:
            return self._rnd_locals
        return self._schedule.round_locals(self._round_idx)

    def _active_ids(self) -> np.ndarray:
        """The sampled global client ids of :meth:`_active_locals`."""
        return np.concatenate([
            off + loc for off, loc in zip(self.spec.offsets,
                                          self._active_locals())])

    def _sampled_eval_steps(self, rt: _Cohort, members: List[int]) -> Dict:
        """Padded stacked eval shards of this rank's block of one cohort's
        sampled members (all of them off a split mesh), cached by member
        tuple (at most 8).  The block count is the cohort's
        ``eval_blocks`` (the most any member needs), so the shapes do not
        depend on the draw."""
        key = tuple(members)
        steps = rt.eval_cache.get(key)
        if steps is None:
            js = [rt.offset + i for i in key][rt.blk[0]]
            steps = to_tensors(stack_eval_steps(stacked_eval_batches(
                [self.priv_test[j] for j in js],
                self.spec.cohort_batch_size(rt.idx),
                self.masks[np.array(js)], n_blocks=rt.eval_blocks)),
                self.device)
            if len(rt.eval_cache) >= 8:
                rt.eval_cache.pop(next(iter(rt.eval_cache)))
            rt.eval_cache[key] = steps
        return steps

    def evaluate_clients(self) -> List[Dict]:
        """Per-device ``{"ce", "acc"}`` on each private test set, in global
        client order (under a sampler: the round's participants, still in
        id order), each cohort at its own batch size: one client at a
        time (loop), or all of a cohort's clients in one pass per padded
        eval batch (vectorized; on a mesh each rank its block, the sums
        gathered)."""
        if self._stacked:
            local = []
            for rt in self._cohorts:
                if not rt.member:
                    local.append(None)
                    continue
                steps = (rt.eval_steps if self._schedule is None else
                         self._sampled_eval_steps(rt, self._members(rt)))
                local.append(rt.eval_fn(rt.stacked_params, steps))
            out = []
            for rt, sums in zip(self._cohorts, local):
                sums = self._exchange(rt, sums, "eval")
                host = {k: v.cpu().numpy() for k, v in sums.items()}
                out += [seccl.metrics_from_sums({k: v[i]
                                                 for k, v in host.items()})
                        for i in range(rt.work_n)]
            return out
        return [self._eval_model(rt.eval_step,
                                 self._loop_client_state(rt, i)[0],
                                 self.priv_test[rt.offset + i],
                                 self.masks[rt.offset + i],
                                 self.spec.cohort_batch_size(rt.idx))
                for rt in self._cohorts for i in self._members(rt)]

    def evaluate_server(self) -> Dict:
        """Server LLM ``{"ce", "acc"}`` on the public test set (the
        stacked engines over their prebuilt eval steps, after the server
        phases queued so far; past one rank on the overlap engine the
        server rank's sums, broadcast)."""
        self._sync_server()
        if self._stacked:
            sums = (self._server_eval_fn(self.server_llm,
                                         self._server_eval_steps)
                    if self._serves else None)
            if self._server_rank is not None:
                sums = coll.broadcast_tree(
                    sums, {k: torch.empty((), device="meta")
                           for k in seccl.EVAL_SUM_KEYS},
                    self._server_rank, self.device)
            return seccl.metrics_from_sums(sums)
        return self._eval_model(self.llm_eval_step, self.server_llm,
                                self.public_test, None)

    def _finalize_eval(self, client_eval: Optional[List[Dict]] = None
                       ) -> Dict:
        cs = client_eval if client_eval is not None \
            else self.evaluate_clients()
        out = {"client": cs, "server": self.evaluate_server()}
        if self._schedule is not None:
            # which registered clients the per-client metrics belong to
            out["participants"] = [int(j) for j in self._active_ids()]
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
    # checkpoint / resume: the whole run state as ONE pytree through a
    # CheckpointManager, in the reference's format and key for key its
    # tree.  A restore sets the round counter and replays the stream bank
    # by per-round pull counts, so the next rounds draw the same
    # participants and fault masks and consume the same data as the
    # uninterrupted run, bit for bit.

    def checkpoint_state(self) -> Dict:
        """The run state: the round counter, the server models and their
        AdamW states, each cohort's last delivery, and every client's
        personal state (the store under a sampler; else the stacked
        ``(train, opt)`` per cohort, or per-client tuples on the loop
        engine), plus the residuals as ``channel`` under a stateful codec
        without a sampler.  Refuses the overlap engine's pending server
        outputs: a non-empty staleness queue is not a round boundary.  On
        a mesh it is collective: the stacks are gathered whole
        (:meth:`_whole_stacks`) and the overlap engine's server state is
        broadcast from the server rank, so every rank builds the tree
        that one rank builds."""
        if self._srv_q:
            raise RuntimeError(
                "cannot checkpoint with pending pipelined server outputs "
                "(overlap staleness queue is non-empty)")
        self._sync_server()
        if self._schedule is not None:
            clients = self._store.state_pytree()
        elif self._stacked:
            clients = tuple(self._whole_stacks(rt) for rt in self._cohorts)
        else:
            clients = tuple(
                (tuple(lora.partition(p) for p in rt.device_params),
                 tuple(rt.device_opt))
                for rt in self._cohorts)
        server = self._server_state()
        if self._server_rank is not None:
            server = coll.broadcast_tree(
                server if self._serves else None, self._server_like,
                self._server_rank, self.device)
        state = {
            "round": torch.tensor(self._round_idx, dtype=torch.int64),
            **server,
            "last_global": tuple(rt.last_global for rt in self._cohorts),
            "clients": clients,
        }
        if self.channel.stateful and self._schedule is None:
            state["channel"] = tuple(rt.chan_state for rt in self._cohorts)
        return state

    def save_checkpoint(self, mgr, step: Optional[int] = None) -> int:
        """Write the run state at the current round boundary through
        ``mgr`` (a :class:`repro_torch.checkpointing.CheckpointManager`);
        returns the step used (default: the completed-round count).  On
        more than one rank every rank calls it: rank 0 of the world writes
        and the others wait at a barrier until the file is whole."""
        step = self._round_idx if step is None else int(step)
        state = self.checkpoint_state()
        if self._world == 1 or dist.get_rank() == 0:
            mgr.save(step, state)
        if self._world > 1:
            dist.barrier()
        return step

    def load_checkpoint(self, mgr, step: Optional[int] = None
                        ) -> "FederatedRunner":
        """Restore a state saved by :meth:`save_checkpoint` (of this
        package or of the reference, at any world size) into this
        identically built runner and fast-forward the data streams to the
        restored round.  On a mesh every rank calls it and reads the whole
        tree, and keeps its block of each stack (the server, past one rank
        on the overlap engine, on the server rank only)."""
        self._restore_state(mgr.restore(self.checkpoint_state(), step))
        return self

    def _restore_state(self, state: Dict) -> None:
        # the overlap engine's threads read the data streams and the
        # store: stop them before touching either
        self.close()
        self._srv_q.clear()
        rnd = int(state["round"])
        self._round_idx = rnd
        self._rnd_present = self._rnd_contrib = self._rnd_weights = None
        self._rnd_locals = self._rnd_ids = self._rnd_no = None
        self._rnd_scale = None
        for name in _SERVER_STATE:
            setattr(self, name, state[name])
        for rt, lg in zip(self._cohorts, state["last_global"]):
            rt.last_global = lg
        if self._schedule is not None:
            self._store.load_state_pytree(state["clients"])
            # the working set the next round draws
            self._load_working_set(rnd)
        elif self._stacked:
            for rt, (train, opt) in zip(self._cohorts, state["clients"]):
                rt.stacked_params = lora.combine(rt.stacked_params,
                                                 self._block(rt, train))
                rt.stacked_opt = self._block(rt, opt)
        else:
            for rt, (trains, opts) in zip(self._cohorts, state["clients"]):
                for i, (tr, o) in enumerate(zip(trains, opts)):
                    rt.device_params[i] = lora.combine(rt.device_params[i],
                                                       tr)
                    rt.device_opt[i] = o
        if "channel" in state:
            for rt, cs in zip(self._cohorts, state["channel"]):
                rt.chan_state = cs
        # the data streams: back to position 0, then the completed
        # rounds' pulls
        self._streams.reset()
        self._replay_streams(rnd)
        if self._overlap:
            # an empty queue at the boundary: the anchor trainables are
            # the restored server LLM's (whose frozen leaves it now holds;
            # past one rank only the server rank keeps the server)
            self._init_overlap()

    def _replay_streams(self, rounds: int) -> None:
        """Fast-forward the stream bank past ``rounds`` completed rounds:
        every engine takes the same pulls a round (offline clients advance
        their streams too; only sampled members pull at all)."""
        cfg, spec = self.cfg, self.spec
        pulls: Dict[str, int] = {}
        for r in range(rounds):
            for rt in self._cohorts:
                k_ccl = spec.cohort_steps_ccl(rt.idx) if _do_ccl(cfg) else 0
                k_amt = spec.cohort_steps_amt(rt.idx)
                for i in self._members(rt, r):
                    j = rt.offset + i
                    pulls[f"pub/{j}"] = pulls.get(f"pub/{j}", 0) + k_ccl
                    pulls[f"priv/{j}"] = pulls.get(f"priv/{j}", 0) + k_amt
            if _do_seccl(cfg):
                pulls["server"] = pulls.get("server", 0) + cfg.server_steps
        for name, k in pulls.items():
            if k:
                self._streams.advance(name, k)
