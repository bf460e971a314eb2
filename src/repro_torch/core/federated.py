"""The ML-ECS federated round — Algorithm 1 on the loop engine (port of
the legacy single-cohort form of ``repro.core.federated``).

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

Covered: one homogeneous cohort, ``engine="loop"``, the modes mlecs /
fedavg / standalone, the ablations ``use_mma`` / ``use_seccl`` /
``use_ccl``, both CCL scores, ``prox_weight``, the mean reduction, and the
identity, int8 and int4 channels (uploads cross the wire before MMA, the
redistribution crosses it on the way down).  Everything else, the sketch
codec included, raises ``NotImplementedError``.

Every device shares ONE frozen backbone (the tensors of the cohort base);
only its personal leaves (LoRA + connector) are its own.  Steps never
write a tensor in place: a step returns a new tree that shares the frozen
leaves.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

from repro_torch import interop
from repro_torch.core import ccl as ccl_lib
from repro_torch.core import lora, mma, seccl
from repro_torch.core.channel import ChannelSpec, TensorSpec
from repro_torch.core.connector import latent_dim
from repro_torch.core.spec import ENGINES, draw_masks, validate_protocol
from repro_torch.data.multimodal import (paper_split, take_fraction,
                                         train_test_split)
from repro_torch.data.pipeline import ClientStreams, np_eval_batches, to_tensors
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


@dataclasses.dataclass
class FederatedConfig:
    """Hyperparameters of one federated simulation: the reference's fields
    and defaults.  ``channel`` is a :class:`ChannelSpec` of the port (None
    = identity).  ``faults`` and ``sampler`` are accepted here (as the
    reference's objects, opaque to the port) and refused by
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
    engine: str = "vectorized"       # only "loop" is ported
    staleness: int = 0
    use_mma: bool = True             # False -> uniform averaging (w/o MMA)
    use_seccl: bool = True           # False -> skip step 4     (w/o SE-CCL)
    use_ccl: bool = True             # False -> devices skip step 2's loss
    mode: str = "mlecs"              # mlecs | standalone | fedavg
    kt_weight: float = 0.5
    prox_weight: float = 0.0         # FedProx-style pull toward the global
    ccl_score: str = "volume"        # volume (Eq. 5-8) | cosine (ablation)
    robust: str = "mean"             # only "mean" is ported
    trim_frac: float = 0.2
    faults: Optional[Any] = None
    sampler: Optional[Any] = None
    channel: Optional[ChannelSpec] = None   # wire codec (None = identity)

    def __post_init__(self):
        if self.n_devices < 1:
            raise ValueError("n_devices must be >= 1")
        validate_protocol(self.mode, self.engine, self.ccl_score,
                          self.staleness, self.robust, self.trim_frac)


def _refuse_unported(cfg: FederatedConfig, engine: str) -> None:
    if engine not in ENGINES:
        raise ValueError(f"unknown engine {engine!r}")
    if engine != "loop":
        raise NotImplementedError(
            f"engine={engine!r} is not ported; pass engine='loop'")
    if cfg.robust != "mean":
        raise NotImplementedError(
            f"robust={cfg.robust!r} MMA is not ported (mean only)")
    if cfg.channel is not None:
        if not isinstance(cfg.channel, ChannelSpec):
            raise TypeError("channel must be repro_torch.core.channel."
                            f"ChannelSpec; got {type(cfg.channel).__name__}")
        if cfg.channel.codec == "sketch":
            raise NotImplementedError(
                "the sketch codec is not ported (identity, int8, int4)")
    if cfg.faults is not None:
        raise NotImplementedError("client faults are not ported (faults=None)")
    if cfg.sampler is not None:
        raise NotImplementedError(
            "participant sampling is not ported (sampler=None)")


class FederatedRunner:
    """One homogeneous cohort of ``cfg.n_devices`` edge devices and the
    cloud server, on the loop engine:

        ``FederatedRunner(cfg, slm_bundle, llm_bundle, corpus,
        engine=None, device="cuda", init_state=None)``

    The states are drawn from a ``torch.Generator`` seeded with
    ``cfg.seed`` on ``device`` unless ``init_state`` gives them: a dict of
    flat numpy trees (``interop`` format) with ``"cohort_base"`` (the
    shared unified SLM), ``"personal"`` (a list of each device's
    trainable leaves), ``"server_slm"`` and ``"server_llm"``.
    The runner runs on the card; ``device="cpu"`` asks for the CPU."""

    def __init__(self, cfg, slm_bundle=None, llm_bundle=None, corpus=None,
                 *, engine: Optional[str] = None, device="cuda",
                 init_state: Optional[Dict] = None):
        if not isinstance(cfg, FederatedConfig):
            if hasattr(cfg, "cohorts"):
                raise NotImplementedError(
                    "FederationSpec input is not ported; use the legacy "
                    "form FederatedRunner(FederatedConfig, slm_bundle, "
                    "llm_bundle, corpus)")
            raise TypeError(f"expected FederatedConfig, got "
                            f"{type(cfg).__name__}")
        if slm_bundle is None or llm_bundle is None or corpus is None:
            raise TypeError("FederatedRunner(cfg, slm_bundle, llm_bundle, "
                            "corpus, ...)")
        self.engine = engine or cfg.engine
        _refuse_unported(cfg, self.engine)
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("CUDA is not available; pass device='cpu' "
                               "to run the round on the CPU")
        iface = {(b.cfg.n_modalities, b.cfg.modality_dim, latent_dim(b.cfg))
                 for b in (slm_bundle, llm_bundle)}
        if len(iface) != 1:
            raise ValueError(
                "cohort/server models disagree on the connector interface "
                f"(n_modalities, modality_dim, latent): {sorted(iface)}")
        self.cfg = cfg
        self.slm, self.llm = slm_bundle, llm_bundle
        N = cfg.n_devices

        # data: public / private, train / test, modality masks
        public, privates = paper_split(corpus, N, cfg.seed)
        self.public_train, self.public_test = train_test_split(
            public, 0.1, cfg.seed)
        self.priv_train, self.priv_test = [], []
        for j, pv in enumerate(privates):
            pv = take_fraction(pv, 1.0, cfg.seed + 10_000 + j)
            tr, te = train_test_split(pv, 0.1, cfg.seed + j + 1)
            self.priv_train.append(tr)
            self.priv_test.append(te)
        M = corpus["modality_feats"].shape[1]
        self.masks = draw_masks(cfg.seed, N, M, cfg.rho)

        # models: one frozen backbone shared by every device
        if init_state is None:
            self._init_states(N)
        else:
            self._load_states(init_state, N)

        self.opt = opt = adamw(cfg.lr, weight_decay=0.0)
        self.device_opt = [opt.init(lora.partition(p))
                           for p in self.device_params]
        self.server_llm_opt = opt.init(lora.partition(self.server_llm))
        self.server_slm_opt = opt.init(lora.partition(self.server_slm))

        counts = [int(self.masks[j].sum()) for j in range(N)]
        if cfg.use_mma and cfg.mode == "mlecs":
            self.agg_weights = mma.aggregation_weights(counts,
                                                       device=self.device)
        else:
            self.agg_weights = torch.ones((N,), device=self.device) / N

        server_lora = lora.partition(self.server_slm, lora.is_lora_leaf)
        up0 = lora.partition(self.device_params[0], lora.is_lora_leaf)
        if lora.shared_keys(up0, server_lora) != tuple(sorted(up0)) \
                or len(up0) != len(server_lora):
            raise NotImplementedError(
                "the server SLM's LoRA leaves differ from the devices': "
                "heterogeneous cohorts are not ported")
        self.last_global = dict(server_lora)

        # the wire: the stacked upload templates, the error-feedback
        # residuals (f32, (N, ...)) and the exact per-round byte costs
        # (bytes_on_wire is linear in the client axis)
        self.channel = (cfg.channel or ChannelSpec()).make()
        self.up_like = {k: TensorSpec((N, *v.shape), v.dtype)
                        for k, v in up0.items()}
        self.chan_state = self.channel.init_state(self.up_like, self.device)
        self._uplink_client_bytes = \
            self.channel.bytes_on_wire(self.up_like) // N
        self._dense_client_bytes = \
            ChannelSpec().make().bytes_on_wire(self.up_like) // N
        # the paper's Fig. 3 baseline is dense float32 uploads
        self._f32_client_bytes = 4 * sum(v.numel() for v in up0.values())
        self._downlink_bytes = self.channel.bytes_on_wire(
            {k: TensorSpec((1, *v.shape), v.dtype)
             for k, v in server_lora.items()})
        self._bytes_up = self._bytes_up_dense = 0
        self._bytes_up_f32 = self._bytes_down = 0
        self.comm_log: List[Dict] = []

        self._streams = ClientStreams()
        for j in range(N):
            self._streams.register(f"pub/{j}", self.public_train,
                                   cfg.batch_size, cfg.seed + 100 + j,
                                   self.masks[j])
            self._streams.register(f"priv/{j}", self.priv_train[j],
                                   cfg.batch_size, cfg.seed + 200 + j,
                                   self.masks[j])
        self._streams.register("server", self.public_train, cfg.batch_size,
                               cfg.seed + 999)

        # the steps (public attributes, so a caller can time or wrap them)
        self.ccl_step = ccl_lib.make_local_step(
            self.slm, opt, ccl_weight=_ccl_weight(cfg),
            n_negatives=cfg.n_negatives, ccl_score=cfg.ccl_score)
        self.amt_step = ccl_lib.make_local_step(
            self.slm, opt, ccl_weight=0.0, with_anchor=False,
            prox_weight=cfg.prox_weight)
        self.se_step = self._make_seccl_step()
        self.slm_eval_step = seccl.make_eval_step(self.slm)
        self.llm_eval_step = seccl.make_eval_step(self.llm)
        self._round_idx = 0
        self.history: List[Dict] = []

    # ------------------------------------------------------------------
    def _init_states(self, N: int) -> None:
        gen = torch.Generator(device=self.device).manual_seed(self.cfg.seed)
        self.cohort_base = ccl_lib.init_unified(gen, self.slm)
        self.device_params = [self.cohort_base]
        for _ in range(1, N):
            personal = lora.partition(ccl_lib.init_unified(gen, self.slm))
            self.device_params.append(lora.combine(self.cohort_base,
                                                   personal))
        self.server_slm = ccl_lib.init_unified(gen, self.slm)
        self.server_llm = ccl_lib.init_unified(gen, self.llm)

    def _load_states(self, state: Dict, N: int) -> None:
        sdt, ldt = self.slm.cfg.torch_dtype, self.llm.cfg.torch_dtype
        self.cohort_base = interop.params_from_numpy(
            state["cohort_base"], self.device, sdt)
        if len(state["personal"]) != N:
            raise ValueError(f"init_state has {len(state['personal'])} "
                             f"personal sets for {N} devices")
        self.device_params = [
            lora.combine(self.cohort_base,
                         interop.leaves_from_numpy(pers, self.device, sdt))
            for pers in state["personal"]]
        self.server_slm = interop.params_from_numpy(
            state["server_slm"], self.device, sdt)
        self.server_llm = interop.params_from_numpy(
            state["server_llm"], self.device, ldt)

    def _make_seccl_step(self) -> Callable:
        """Joint SE-CCL update: the LLM minimizes Eq. 15, the SLM Eq. 16.
        Each model runs twice: ``mlecs_loss`` with its soft prompt, then
        ``logits`` on the raw batch for the KT terms.  One backward gives
        both models' gradients; each takes its own AdamW update."""
        cfg = self.cfg
        llm, slm = self.llm, self.slm

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

    def _deliver(self, delivery: Dict[str, torch.Tensor]) -> None:
        """Alg. 1 step 5: splice the (decoded) delivery into every device;
        it is also the prox reference of the next round."""
        self.last_global = delivery
        self.device_params = [lora.combine(p, delivery)
                              for p in self.device_params]

    def _encode_uploads(self, uploads: List[Dict]) -> Dict[str, torch.Tensor]:
        """The uplink: every device's upload, stacked on the client axis,
        crosses the channel; returns what the server receives (stacked)
        and advances the error-feedback residuals."""
        stacked = {k: torch.stack([u[k] for u in uploads])
                   for k in uploads[0]}
        # stateless codecs hold {} as their state and get {} back
        dec, self.chan_state = self.channel.roundtrip(
            stacked, self.chan_state, self._round_idx - 1)
        return dec

    def _commit_comm(self) -> None:
        """Account one round's exact bytes on the wire: every device's
        encoded upload and one multicast downlink; standalone rounds move
        nothing."""
        rnd = self._round_idx - 1
        if self.cfg.mode == "standalone":
            self.comm_log.append({"round": rnd, "uplink": 0, "downlink": 0})
            return
        N = self.cfg.n_devices
        up = N * self._uplink_client_bytes
        self._bytes_up += up
        self._bytes_up_dense += N * self._dense_client_bytes
        self._bytes_up_f32 += N * self._f32_client_bytes
        self._bytes_down += self._downlink_bytes
        self.comm_log.append({"round": rnd, "uplink": up,
                              "downlink": self._downlink_bytes})

    @property
    def comm_stats(self) -> Dict:
        """Wire-traffic totals over the committed rounds: the codec, the
        exact uplink and downlink bytes, what the same uploads would cost
        dense (in their own dtype and in f32), and the ratios."""
        up, dense = int(self._bytes_up), int(self._bytes_up_dense)
        f32 = int(self._bytes_up_f32)
        return {"codec": self.channel.spec.codec,
                "rounds": len(self.comm_log),
                "uplink_bytes": up, "uplink_dense_bytes": dense,
                "uplink_f32_bytes": f32,
                "uplink_ratio": (dense / up) if up else float("inf"),
                "uplink_ratio_f32": (f32 / up) if up else float("inf"),
                "downlink_bytes": int(self._bytes_down),
                "uplink_client_bytes": {0: self._uplink_client_bytes}}

    # ------------------------------------------------------------------
    def run_round(self, evaluate: bool = True) -> Dict:
        """One communication round (``_run_round_loop`` of the reference).

        Client metrics are measured on the post-AMT device models, server
        metrics after SE-CCL; redistribution seeds the next round.  With
        ``evaluate=False`` no metric is computed and ``{}`` is returned."""
        cfg = self.cfg
        self._round_idx += 1
        uploads = []
        for j in range(cfg.n_devices):
            p, o = self.device_params[j], self.device_opt[j]
            if _do_ccl(cfg):
                for _ in range(cfg.local_steps_ccl):
                    pub = self.pull(f"pub/{j}")
                    p, o, _ = self.ccl_step(p, o, pub, self.anchors(pub))
            gref = self.last_global if cfg.prox_weight > 0 else None
            for _ in range(cfg.local_steps_amt):
                p, o, _ = self.amt_step(p, o, self.pull(f"priv/{j}"), None,
                                        gref)
            self.device_params[j], self.device_opt[j] = p, o
            uploads.append(lora.partition(p, lora.is_lora_leaf))

        client_eval = self.evaluate_clients() if evaluate else None
        if cfg.mode == "standalone":
            self._commit_comm()
            return self._finalize_eval(client_eval) if evaluate else {}

        # the uplink wire, then (3) MMA (Eq. 13) over what the server
        # received: f32, left to right over the devices.  The devices keep
        # their own (undecoded) parameters.
        agg = mma.aggregate_stacked(self._encode_uploads(uploads),
                                    self.agg_weights)
        rnd = self._round_idx - 1
        if cfg.mode == "fedavg":
            self._deliver(self.channel.roundtrip_tree(agg, rnd))
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
        # (5) redistribute the server SLM's LoRA leaves through the
        # downlink; the server SLM keeps its own values
        self._deliver(self.channel.roundtrip_tree(
            lora.partition(self.server_slm, lora.is_lora_leaf), rnd))
        self._commit_comm()
        return self._finalize_eval(client_eval) if evaluate else {}

    def run(self) -> List[Dict]:
        """Run ``cfg.rounds`` evaluated rounds, appending to ``history``."""
        for _ in range(self.cfg.rounds):
            self.history.append(self.run_round())
        return self.history

    # ------------------------------------------------------------------
    def _eval_model(self, step, params, data, mask) -> Dict:
        """Host loop over padded in-order eval batches, accumulating the
        per-batch masked sums in f32 (the reference's order)."""
        sums = {k: np.float32(0.0) for k in seccl.EVAL_SUM_KEYS}
        for batch in np_eval_batches(data, self.cfg.batch_size, mask):
            out = step(params, to_tensors(batch, self.device))
            for k in sums:
                sums[k] = np.float32(sums[k] + np.float32(out[k].item()))
        return seccl.metrics_from_sums(sums)

    def evaluate_clients(self) -> List[Dict]:
        """Per-device ``{"ce", "acc"}`` on each private test set."""
        return [self._eval_model(self.slm_eval_step, self.device_params[j],
                                 self.priv_test[j], self.masks[j])
                for j in range(self.cfg.n_devices)]

    def evaluate_server(self) -> Dict:
        """Server LLM ``{"ce", "acc"}`` on the public test set."""
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
