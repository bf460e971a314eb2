"""Plain PyTorch reference of ML-ECS's federated round (Algorithm 1), in
float32 (or the control's fp8 products), a few clients of a cohort at a
time.

Per round: every client of every cohort takes its CCL steps on its public
batches, anchored on the server LLM's fused connector output, then its
AMT steps on its private batches (each step its own AdamW update,
clipped to a global norm of 1 over the client's LoRA and connector
leaves); the clients' LoRA leaves are averaged with the Eq. 13 weights
(modality counts), within the cohort for keys the server SLM lacks and
across the cohorts that share a key otherwise; the average lands in the
server SLM; the server takes its SE-CCL steps (each model's own loss, the
pooled KL from the other, one AdamW update each); and each cohort gets
back the server SLM's LoRA leaves it shares and its own averages.

:class:`ReferenceFederation` records what the comparison reads: every
step's losses, the AdamW first moments after the first round and the
trainable leaves' change over the rounds followed.
"""
from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch

from bench.reference import data as D
from bench.reference import model as R

B1, B2, EPS, CLIP = 0.9, 0.95, 1e-8, 1.0
CHUNK_TOKENS = 4608          # tokens of one call: a few clients' rows


class _Adam:
    """AdamW (no weight decay) over a group's stacked f32 leaves (n, ...),
    each client clipped to a global norm of 1 over its own leaves; steps
    run on a slice of the clients."""

    def __init__(self, leaves: Dict[str, torch.Tensor], lr: float):
        self.lr = lr
        self.t = torch.zeros(next(iter(leaves.values())).shape[0])
        self.mu = {k: torch.zeros_like(v) for k, v in leaves.items()}
        self.nu = {k: torch.zeros_like(v) for k, v in leaves.items()}

    def step(self, leaves, grads, sl: slice) -> None:
        """Update ``leaves[k][sl]`` in place from ``grads`` (the slice's)."""
        sq = sum(torch.sum(g * g, dim=tuple(range(1, g.dim())))
                 for g in grads.values())
        scale = torch.clamp(CLIP / (torch.sqrt(sq) + 1e-9), max=1.0)
        self.t[sl] += 1
        t = self.t[sl]
        for k, g in grads.items():
            shape = (-1,) + (1,) * (g.dim() - 1)
            g = g * scale.reshape(shape)
            mu = B1 * self.mu[k][sl] + (1 - B1) * g
            nu = B2 * self.nu[k][sl] + (1 - B2) * g * g
            self.mu[k][sl], self.nu[k][sl] = mu, nu
            bc1 = (1 - B1 ** t).to(g.device).reshape(shape)
            bc2 = (1 - B2 ** t).to(g.device).reshape(shape)
            leaves[k][sl] -= self.lr * (mu / bc1) / (torch.sqrt(nu / bc2)
                                                     + EPS)


def _tensors(batches: List[Dict[str, np.ndarray]], device
             ) -> Dict[str, torch.Tensor]:
    """Clients' host batches stacked (C, B, ...) on ``device``."""
    out = {}
    for k in batches[0]:
        t = torch.from_numpy(np.stack([b[k] for b in batches]))
        out[k] = (t.long() if t.dtype in (torch.int32, torch.int64)
                  else t.float() if t.is_floating_point() else t).to(device)
    return out


def _half(batch: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """The first half of each client's rows (the half-batch fault)."""
    n = batch["tokens"].shape[1] // 2
    return {k: v[:, :n] for k, v in batch.items()}


def _grads(loss, leaves: Dict) -> Dict:
    keys = list(leaves)
    got = torch.autograd.grad(loss, [leaves[k] for k in keys],
                              allow_unused=True)
    return {k: torch.zeros_like(leaves[k]) if g is None else g
            for k, g in zip(keys, got)}


class ReferenceFederation:
    """The federation of ``fed`` (cohorts, seed, protocol) over ``models``
    ({"edge": [cfg, ...], "server_llm": cfg, "server_slm": cfg}) from
    ``weights`` (the harness's draw, :func:`bench.weights.draw`) and
    ``corpus``.  ``half_batch`` plants the half-batch fault (every step on
    the first half of each client's rows)."""

    def __init__(self, fed: Dict, models: Dict, corpus, weights: Dict,
                 num: R.Numerics, device, half_batch: bool = False):
        self.fed, self.models, self.num = fed, models, num
        self.device, self.half_batch = torch.device(device), half_batch
        self.data = D.federation_data(corpus, fed)
        m = np.asarray(self.data["mod_counts"], np.float64)
        self.w = m / max(m.sum(), 1.0)                   # Eq. 13
        self.slices = D.cohort_slices(fed)
        self.seq_len = corpus["tokens"].shape[1]
        dev = self.device

        def frozen(flat):
            return {k: num.weight(v.to(dev)) for k, v in flat.items()
                    if not R.is_trainable(k)}
        self.bases = [frozen(b) for b in weights["cohort_bases"]]
        # each cohort's clients' trainable leaves, and each server model's,
        # stacked on a client axis (the server's of size 1)
        self.tr = [{k: v.to(dev).float() for k, v in st.items()}
                   for st in weights["personal_stacks"]]
        self.srv = {}
        for name in ("server_slm", "server_llm"):
            flat = weights[name]
            self.srv[name] = (frozen(flat), {
                k: v.to(dev).float()[None] for k, v in flat.items()
                if R.is_trainable(k)})
        self.init = {k: v.clone() for k, v in self._named().items()}
        lr = fed["lr"]
        self.opt = [_Adam(t, lr) for t in self.tr]
        self.srv_opt = {n: _Adam(t, lr) for n, (_, t) in self.srv.items()}
        srv_lora = {k: v.shape[1:] for k, v in
                    self.srv["server_slm"][1].items() if R.is_lora(k)}
        self.shared = [sorted(k for k, v in t.items() if R.is_lora(k)
                              and srv_lora.get(k) == v.shape[1:])
                       for t in self.tr]
        self.records: List[Dict] = []
        self.first_moments: Optional[Dict[str, float]] = None
        self.first_step: Dict[str, float] = {}

    def _named(self) -> Dict[str, torch.Tensor]:
        """Every trainable leaf of every client and server model, by the
        comparison's name."""
        out = {f"c{c}/{j}/{k}": v[j] for c, t in enumerate(self.tr)
               for k, v in t.items() for j in range(v.shape[0])}
        out.update({f"{n}/{k}": v[0] for n, (_, t) in self.srv.items()
                    for k, v in t.items()})
        return out

    def _batches(self, names: List[str]):
        b = _tensors([self.data["streams"][n].pull() for n in names],
                     self.device)
        return _half(b) if self.half_batch else b

    @torch.no_grad()
    def _anchors(self, batch):
        """The server LLM's fused connector output on every row, with all
        modalities marked present (absent ones are zero features)."""
        frozen, tr = self.srv["server_llm"]
        C, B = batch["modality_feats"].shape[:2]
        feats = batch["modality_feats"].reshape(1, C * B,
                                                *batch["modality_feats"]
                                                .shape[2:])
        ones = torch.ones(feats.shape[:3], dtype=torch.bool,
                          device=feats.device)
        p = {**frozen, **tr}
        h = R.project_modalities(self.num, p, feats, ones)
        return R.fuse(self.num, p, h, ones).reshape(C, B, -1)

    def _cohort_step(self, c: int, kind: str) -> List[float]:
        """One local step of every client of cohort ``c``, a few clients a
        call; returns their losses."""
        m = self.models["edge"][c]
        rng = self.slices[c]
        per = max(1, CHUNK_TOKENS // (self.fed["batch_size"]
                                      * (m["n_soft_tokens"] + self.seq_len)))
        losses = []
        for a in range(0, len(rng), per):
            sl = slice(a, min(a + per, len(rng)))
            names = [f"{'pub' if kind == 'ccl' else 'priv'}/{rng[j]}"
                     for j in range(sl.start, sl.stop)]
            batch = self._batches(names)
            anchor = self._anchors(batch) if kind == "ccl" else None
            t = {k: v[sl].detach().clone().requires_grad_(True)
                 for k, v in self.tr[c].items()}
            p = {**self.bases[c], **t}
            soft, mods, _ = R.connector_prefix(
                self.num, p, batch["modality_feats"], batch["modality_mask"])
            loss = R.lm_loss(self.num, p, m, batch, soft)
            if anchor is not None:
                loss = loss + 0.5 * R.contrastive_loss(
                    anchor, mods, batch["modality_mask"],
                    self.fed["n_negatives"])
            grads = _grads(torch.sum(loss), t)
            with torch.no_grad():
                self.opt[c].step(self.tr[c], grads, sl)
            losses += loss.detach().cpu().tolist()
        if not self.records and not any(k.startswith(f"c{c}/")
                                        for k in self.first_step):
            self.first_step.update(self._moments_of(c))
        return losses

    def _moments_of(self, c) -> Dict[str, float]:
        """The norm of each leaf's first moment, cohort ``c``'s clients'
        (or, with ``c`` None, the server models')."""
        if c is None:
            return {f"{n}/{k}": float(torch.linalg.vector_norm(v))
                    for n, o in self.srv_opt.items() for k, v in o.mu.items()}
        out = {}
        for k, v in self.opt[c].mu.items():
            n = torch.linalg.vector_norm(v.reshape(v.shape[0], -1), dim=1)
            out.update({f"c{c}/{j}/{k}": x
                        for j, x in enumerate(n.cpu().tolist())})
        return out

    def _server_step(self, batch) -> Dict[str, float]:
        kt_w = self.fed["kt_weight"]
        outs, ys, train = {}, {}, {}
        for name, ccl_w in (("server_llm", 0.5), ("server_slm", 0.0)):
            m = self.models[name]
            frozen, tr = self.srv[name]
            t = {k: v.detach().clone().requires_grad_(True)
                 for k, v in tr.items()}
            p = {**frozen, **t}
            soft, mods, fused = R.connector_prefix(
                self.num, p, batch["modality_feats"], batch["modality_mask"])
            loss = R.lm_loss(self.num, p, m, batch, soft)
            if ccl_w:
                loss = loss + ccl_w * R.contrastive_loss(
                    fused, mods, batch["modality_mask"],
                    self.fed["n_negatives"])
            outs[name] = loss[0]
            ys[name] = R.forward(self.num, p, m, batch["tokens"])[0]
            train[name] = t
        kt_llm = R.pooled_kl(ys["server_llm"], ys["server_slm"].detach())
        kt_slm = R.pooled_kl(ys["server_slm"], ys["server_llm"].detach())
        total = outs["server_llm"] + kt_w * kt_llm + outs["server_slm"] \
            + kt_w * kt_slm
        grads = _grads(total, {(n, k): v for n, t in train.items()
                               for k, v in t.items()})
        with torch.no_grad():
            for name, t in train.items():
                self.srv_opt[name].step(self.srv[name][1],
                                        {k: grads[(name, k)] for k in t},
                                        slice(0, 1))
        return {"llm": outs["server_llm"].item(),
                "slm": outs["server_slm"].item(),
                "kt_llm": kt_llm.item(), "kt_slm": kt_slm.item()}

    @torch.no_grad()
    def _aggregate_and_deliver(self, server_steps) -> List[Dict]:
        """(3) Eq. 13 over the uploads (LoRA leaves) into the server SLM,
        (4) the SE-CCL steps, (5) the redistribution."""
        partials, masses = [], []
        for c, rng in enumerate(self.slices):
            w = torch.as_tensor(self.w[list(rng)], dtype=torch.float32,
                                device=self.device)
            partials.append({
                k: torch.tensordot(w, v, dims=([0], [0]))
                for k, v in self.tr[c].items() if R.is_lora(k)})
            masses.append(float(self.w[list(rng)].sum()))
        srv_slm = self.srv["server_slm"][1]
        for k in sorted({k for ks in self.shared for k in ks}):
            cs = [c for c, ks in enumerate(self.shared) if k in ks]
            srv_slm[k][0] = sum(partials[c][k] for c in cs) / sum(
                masses[c] for c in cs)
        with torch.enable_grad():
            recs = [server_steps()]
            if not self.records:
                self.first_step.update(self._moments_of(None))
            recs += [server_steps()
                     for _ in range(1, self.fed["server_steps"])]
        for c, t in enumerate(self.tr):
            for k in self.shared[c]:
                t[k][:] = srv_slm[k][0]
            for k in partials[c]:
                if k not in self.shared[c]:
                    t[k][:] = partials[c][k] / masses[c]
        return recs

    def run_round(self) -> Dict:
        """One round; returns and records its losses."""
        fed = self.fed
        rec = {"clients": [], "server": []}
        for c in range(len(self.slices)):
            rec["clients"].append({
                "ccl": [self._cohort_step(c, "ccl")
                        for _ in range(fed["local_steps_ccl"])],
                "amt": [self._cohort_step(c, "amt")
                        for _ in range(fed["local_steps_amt"])]})
        rec["server"] = self._aggregate_and_deliver(
            lambda: self._server_step(self._batches(["server"])))
        if not self.records:
            self.first_moments = self.moment_norms()
        self.records.append(rec)
        return rec

    def moment_norms(self) -> Dict[str, float]:
        """The norm of every trainable leaf's AdamW first moment."""
        out = self._moments_of(None)
        for c in range(len(self.opt)):
            out.update(self._moments_of(c))
        return out

    def change_norms(self) -> Dict[str, float]:
        """The norm of every trainable leaf's change since the start."""
        return {k: float(torch.linalg.vector_norm(v - self.init[k]))
                for k, v in self._named().items()}

    def losses(self) -> Dict[str, float]:
        """Every recorded loss, keyed as the harness keys the program's."""
        return loss_dict(self.records)


def loss_dict(records: List[Dict]) -> Dict[str, float]:
    """{"r<round>/c<cohort>/<kind><step>/<client>": loss,
    "r<round>/server<step>/<name>": loss} of a list of round records."""
    out = {}
    for r, rec in enumerate(records):
        for c, cl in enumerate(rec["clients"]):
            for kind in ("ccl", "amt"):
                for s, vals in enumerate(cl[kind]):
                    for j, v in enumerate(vals):
                        out[f"r{r}/c{c}/{kind}{s}/{j}"] = float(v)
        for s, srv in enumerate(rec["server"]):
            for name, v in srv.items():
                out[f"r{r}/server{s}/{name}"] = float(v)
    return out
