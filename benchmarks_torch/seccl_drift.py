"""Where the port's federated round leaves the reference's, on the toy
configuration of tests/test_torch_federated.py (float32, CPU).

    PYTHONPATH=src:tests JAX_PLATFORMS=cpu python benchmarks_torch/seccl_drift.py

Runs two rounds of the legacy ROUND (3 clients, one CCL, one AMT and one
SE-CCL step) on four runners from the same states: JAX loop, JAX
vectorized, port loop, port vectorized, and prints each pair's largest
LoRA difference per tree after each round.  Then it feeds the port's
SE-CCL step the JAX step's exact inputs (captured in the JAX loop run) and
prints the LLM LoRA's largest departure from the JAX step's output, the
gradient's (AdamW's first moment, 0.1 g after the first step) and the
gradient, first moment, second moment and update at the worst element.
"""
import sys

import jax
import numpy as np
import torch

import test_torch_federated as T
from repro.core import lora as jlora
from repro.core.federated import FederatedConfig as JFedConfig
from repro.core.federated import FederatedRunner as JRunner
from repro.models.model import build_model as jbuild
from repro_torch import interop
from repro_torch.core import lora
from repro_torch.core.federated import FederatedConfig, FederatedRunner


def jnum(tree):
    return {jlora.path_str(p): np.asarray(v, np.float64)
            for p, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def tnum(tree):
    return {k: v.detach().numpy().astype(np.float64)
            for k, v in lora.flatten(tree).items()}


def lora_trees(r, is_jax):
    trees = [(f"dev{j}", p) for j, p in enumerate(r.device_params)]
    trees += [("server_slm", r.server_slm), ("server_llm", r.server_llm)]
    out = {}
    for name, p in trees:
        flat = jnum(p) if is_jax else tnum(p)
        out.update({f"{name}:{k}": v for k, v in flat.items()
                    if lora.is_lora_leaf(k)})
    return out


def worst_by_tree(a, b):
    out = {}
    for k in a:
        t = k.split(":")[0]
        out[t] = max(out.get(t, 0.0), float(np.abs(a[k] - b[k]).max()))
    return out


def worst(a, b, pick):
    k = max((k for k in a if pick(k)), key=lambda k: np.abs(a[k] - b[k]).max())
    return k, float(np.abs(a[k] - b[k]).max())


def port_opt(o):
    fl = jnum(o)
    return {"step": torch.tensor(int(fl["step"]), dtype=torch.int32),
            **{m: {k[3:]: torch.tensor(v, dtype=torch.float32)
                   for k, v in fl.items() if k.startswith(m + "/")}
               for m in ("mu", "nu")}}


def main() -> int:
    torch.set_num_threads(1)
    corpus = T.synthetic_multimodal_corpus(0, 384, 24, 128, n_classes=4,
                                           n_modalities=3, modality_dim=32,
                                           template_len=4)
    rnd_cfg = dict(T.ROUND, rounds=2)
    jl = JRunner(JFedConfig(engine="loop", **rnd_cfg), jbuild(T.SLM),
                 jbuild(T.LLM), corpus)
    jv = JRunner(JFedConfig(engine="vectorized", **rnd_cfg), jbuild(T.SLM),
                 jbuild(T.LLM), corpus)
    init = {"cohort_base": T.flat_numpy(jl._cohort_bases[0]),
            "personal": [T.flat_numpy(jlora.partition(p))
                         for p in jl.device_params],
            "server_slm": T.flat_numpy(jl.server_slm),
            "server_llm": T.flat_numpy(jl.server_llm)}
    tl, tv = (FederatedRunner(FederatedConfig(engine=e, **rnd_cfg),
                              *T.port_bundles(), corpus, device="cpu",
                              init_state=init)
              for e in ("loop", "vectorized"))
    captured, jstep = [], jl._se_step

    def capture(*args):
        out = jstep(*args)
        captured.append((args, out))
        return out
    jl._se_step = capture
    for rnd in range(2):
        for r in (jl, jv, tl, tv):
            r.run_round()
        a, b, c, d = (lora_trees(jl, True), lora_trees(jv, True),
                      lora_trees(tl, False), lora_trees(tv, False))
        print(f"round {rnd}: largest LoRA difference per tree")
        for what, x, y in (("jax loop vs jax vectorized", a, b),
                           ("port loop vs jax loop", c, a),
                           ("port vectorized vs jax vectorized", d, b),
                           ("port loop vs port vectorized", c, d)):
            print(f"  {what}: {worst_by_tree(x, y)}")
    se_step = FederatedRunner(FederatedConfig(engine="loop", **rnd_cfg),
                              *T.port_bundles(), corpus, device="cpu",
                              init_state=init).se_step
    for rnd, (args, out) in enumerate(captured):
        llm, slm = (interop.params_from_numpy(
            {k: v.astype(np.float32) for k, v in jnum(t).items()}, "cpu",
            torch.float32) for t in args[:2])
        batch = {k: torch.from_numpy(np.array(v)) for k, v in
                 args[4].items()}
        batch = {k: v.long() if v.dtype == torch.int32 else v
                 for k, v in batch.items()}
        got = se_step(llm, slm, port_opt(args[2]), port_opt(args[3]), batch)
        jl_out, tl_out = jnum(out[0]), tnum(got[0])
        k, e = worst(jl_out, tl_out, lora.is_lora_leaf)
        jm, tm = jnum(out[2]), tnum(got[2]["mu"])
        jmu = {k2[3:]: v for k2, v in jm.items() if k2.startswith("mu/")}
        mk, me = worst(jmu, tm, lambda _: True)
        print(f"round {rnd} SE-CCL step, the port's on JAX's inputs: LLM "
              f"LoRA {k} {e:.3e} from JAX's; first moment {mk} {me:.3e} "
              f"(leaf's largest |mu| {np.abs(jmu[mk]).max():.3e})")
        d = np.abs(jl_out[k] - tl_out[k])
        i = np.unravel_index(np.argmax(d), d.shape)
        p0 = jnum(args[0])[k][i]
        print(f"  at {k}{[int(x) for x in i]}: mu jax {jmu[k][i]:.6e} port "
              f"{tm[k][i]:.6e}; nu {jnum(out[2])['nu/' + k][i]:.3e}; "
              f"update jax {jl_out[k][i] - p0:.6e} port "
              f"{tl_out[k][i] - p0:.6e}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
