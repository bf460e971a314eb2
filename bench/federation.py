"""The program side of a cell: the federation of a configuration and a
traffic mix built in the port (``repro_torch``), hooks on its steps, and
the readings the comparison takes from its state.

The port is imported inside the functions that need it, so the rest of
the benchmark (the manifest, the reference, the op counts) imports
without it.
"""
from __future__ import annotations

import time
from typing import Dict, List

import numpy as np
import torch

from bench.corpus import synthetic_multimodal_corpus


def models(cfg: Dict) -> Dict:
    """{"edge": [model dict per cohort], "server_llm", "server_slm"} of a
    configuration file (the server SLM defaults to the first cohort's)."""
    edge = [e["model"] for e in cfg["edge"]]
    slm = cfg.get("server_slm")
    return {"edge": edge, "server_llm": cfg["server_llm"]["model"],
            "server_slm": slm["model"] if slm else edge[0]}


def fed_params(traffic: Dict, seed: int) -> Dict:
    """The protocol of a traffic mix, as plain values both sides read."""
    return {"cohorts": [(c["clients"], None if c.get("modalities") is None
                         else tuple(c["modalities"]))
                        for c in traffic["cohorts"]],
            "seed": int(seed),
            **{k: traffic[k] for k in (
                "rho", "batch_size", "lr", "n_negatives", "kt_weight",
                "local_steps_ccl", "local_steps_amt", "server_steps")}}


def corpus(models_: Dict, traffic: Dict, seed: int) -> Dict[str, np.ndarray]:
    """The round's corpus from the seed, over the smallest vocabulary of
    the federation's models (an id past a model's vocabulary is none of
    its tokens)."""
    c = traffic["corpus"]
    vocab = min(m["vocab_size"] for m in
                [*models_["edge"], models_["server_llm"],
                 models_["server_slm"]])
    return synthetic_multimodal_corpus(
        int(seed), c["n_samples"], c["seq_len"], vocab,
        n_classes=c["n_classes"], n_modalities=c["n_modalities"],
        modality_dim=c["modality_dim"], template_len=c["template_len"])


def build_runner(models_: Dict, fed: Dict, traffic: Dict, data,
                 init_state: Dict, device):
    """The port's ``FederatedRunner`` for the federation, from the
    harness's weights."""
    from repro_torch.configs.base import ModelConfig
    from repro_torch.core.federated import FederatedRunner
    from repro_torch.core.spec import ClientCohort, FederationSpec

    def cfg(m):
        return ModelConfig(**{k: tuple(v) if isinstance(v, list) else v
                              for k, v in m.items()})
    cohorts = tuple(
        ClientCohort(cfg(m), n, f"cohort{c}", modalities=mods)
        for c, (m, (n, mods)) in enumerate(zip(models_["edge"],
                                               fed["cohorts"])))
    slm = models_["server_slm"]
    spec = FederationSpec(
        cohorts=cohorts, server_llm=cfg(models_["server_llm"]),
        server_slm=None if slm is models_["edge"][0] else cfg(slm),
        rounds=1, engine=traffic["engine"], seed=fed["seed"],
        **{k: fed[k] for k in ("rho", "batch_size", "lr", "n_negatives",
                               "kt_weight", "local_steps_ccl",
                               "local_steps_amt", "server_steps")})
    return FederatedRunner(spec, data, device=device, init_state=init_state)


class StepHooks:
    """Wraps the runner's stacked CCL and AMT steps and its SE-CCL step:
    records each step's losses while ``record`` is set, and while
    ``timed`` is set brackets each step with ``synchronize`` and the host
    clock (the spans of the traced run)."""

    def __init__(self, runner, device):
        self.runner, self.device = runner, torch.device(device)
        self.record, self.timed = False, False
        self.round = -1
        self.losses: Dict = {}
        self.first: Dict = {}        # first-step moment norms, by cohort
        self.spans: List[tuple] = []
        self.syncs: List[int] = []
        self._count: Dict = {}
        self._orig = ([(rt.ccl_step, rt.amt_step) for rt in runner.cohorts],
                      runner.se_step)
        for c, rt in enumerate(runner.cohorts):
            rt.ccl_step = self._wrap(rt.ccl_step, c, "ccl")
            rt.amt_step = self._wrap(rt.amt_step, c, "amt")
        runner.se_step = self._wrap(runner.se_step, None, "server")

    def sync(self) -> int:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        t = time.perf_counter_ns()
        self.syncs.append(t)
        return t

    def new_round(self) -> None:
        self.round += 1
        self._count = {}

    def _wrap(self, fn, c, kind):
        span = "server_step" if kind == "server" else "client_step"

        def step(*args, **kw):
            t0 = self.sync() if self.timed else None
            out = fn(*args, **kw)
            if self.timed:
                self.spans.append((span, t0, self.sync()))
            if self.record:
                s = self._count.get((c, kind), 0)
                self._count[(c, kind)] = s + 1
                self.losses[(self.round, c, kind, s)] = out[-1]
                if self.round == 0 and c not in self.first:
                    self.first[c] = _first_moments(c, out)
            return out
        return step

    def release(self) -> None:
        """Put the runner's own steps back."""
        for rt, (ccl, amt) in zip(self.runner.cohorts, self._orig[0]):
            rt.ccl_step, rt.amt_step = ccl, amt
        self.runner.se_step = self._orig[1]

    def loss_dict(self) -> Dict[str, float]:
        """The recorded losses keyed as the reference keys them."""
        out = {}
        for (r, c, kind, s), m in self.losses.items():
            if kind == "server":
                for name in ("llm", "slm", "kt_llm", "kt_slm"):
                    out[f"r{r}/server{s}/{name}"] = float(m[name])
            else:
                for j, v in enumerate(m["loss"].float().cpu().tolist()):
                    out[f"r{r}/c{c}/{kind}{s}/{j}"] = float(v)
        return out


def _first_moments(c, out) -> Dict[str, float]:
    """The norm of each leaf's AdamW first moment right after a client's
    (cohort ``c``) or the server's (``c`` None) first step: 0.1 times the
    first gradient as the optimizer clipped it."""
    if c is None:
        return {f"{name}/{k}": float(torch.linalg.vector_norm(v.float()))
                for name, o in (("server_llm", out[2]), ("server_slm", out[3]))
                for k, v in o["mu"].items()}
    res = {}
    for k, v in out[1]["mu"].items():
        norms = torch.linalg.vector_norm(v.float().reshape(v.shape[0], -1),
                                         dim=1).cpu().tolist()
        res.update({f"c{c}/{j}/{k}": n for j, n in enumerate(norms)})
    return res


def _trainable(tree) -> Dict[str, torch.Tensor]:
    from repro_torch.core.lora import default_trainable, flatten
    return {k: v for k, v in flatten(tree).items() if default_trainable(k)}


def moment_norms(runner) -> Dict[str, float]:
    """The norm of every trainable leaf's AdamW first moment, each client's
    and the server models'."""
    out = {}
    for c, rt in enumerate(runner.cohorts):
        for k, v in rt.stacked_opt["mu"].items():
            norms = torch.linalg.vector_norm(v.float().reshape(v.shape[0], -1),
                                             dim=1).cpu().tolist()
            out.update({f"c{c}/{j}/{k}": n for j, n in enumerate(norms)})
    for name in ("server_slm", "server_llm"):
        for k, v in getattr(runner, name + "_opt")["mu"].items():
            out[f"{name}/{k}"] = float(torch.linalg.vector_norm(v.float()))
    return out


def _f32(a: np.ndarray) -> np.ndarray:
    if a.dtype == np.uint16:
        return (a.astype(np.uint32) << 16).view(np.float32)
    return a.astype(np.float32)


def init_trainables(state: Dict, cohort_sizes: List[int]) -> Dict:
    """The trainable leaves of an ``init_state``, as the change norms
    need them: each cohort's clients stacked, and the server models'."""
    from repro_torch.core.lora import default_trainable
    out, j = {}, 0
    for c, n in enumerate(cohort_sizes):
        keys = [k for k in state["personal"][j] if default_trainable(k)]
        out[f"c{c}"] = {k: np.stack([state["personal"][j + i][k]
                                     for i in range(n)]) for k in keys}
        j += n
    for name in ("server_slm", "server_llm"):
        out[name] = {k: v for k, v in state[name].items()
                     if default_trainable(k)}
    return out


def change_norms(runner, init: Dict) -> Dict[str, float]:
    """The norm of every trainable leaf's change since ``init``."""
    out = {}
    for c, rt in enumerate(runner.cohorts):
        now = _trainable(rt.stacked_params)
        for k, a in init[f"c{c}"].items():
            v = now[k]
            d = v.float() - torch.from_numpy(_f32(a)).to(v.device)
            norms = torch.linalg.vector_norm(
                d.reshape(d.shape[0], -1), dim=1).cpu().tolist()
            out.update({f"c{c}/{j}/{k}": n for j, n in enumerate(norms)})
    for name in ("server_slm", "server_llm"):
        now = _trainable(getattr(runner, name))
        for k, a in init[name].items():
            v = now[k]
            out[f"{name}/{k}"] = float(torch.linalg.vector_norm(
                v.float() - torch.from_numpy(_f32(a)).to(v.device)))
    return out

