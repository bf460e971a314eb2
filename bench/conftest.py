"""Shared fixtures of the benchmark's CPU tests: toy cells in a temporary
checkout (their own ``BENCHMARK.json``, configurations, traffic mixes,
limits and the real metric readers), run on the CPU in float32."""
from __future__ import annotations

import json
import shutil
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parent


def _model(name, family, **kw):
    m = {"name": name, "family": family, "n_layers": 2, "d_model": 64,
         "n_heads": 4, "n_kv_heads": 4, "head_dim": 16, "d_ff": 128,
         "vocab_size": 300, "activation": "gelu", "norm_eps": 1e-6,
         "tie_embeddings": True, "rope_theta": 10000.0, "qk_norm": False,
         "sliding_window": 0, "global_every": 0, "lora_rank": 4,
         "lora_alpha": 8.0, "lora_targets": ["wq", "wk", "wv", "wo"],
         "n_modalities": 3, "modality_dim": 16, "n_soft_tokens": 4,
         "connector_dim": 32, "dtype": "float32", "remat": False}
    m.update(kw)
    return m


TOY_LLM = _model("toy-llm", "dense", d_model=96, n_kv_heads=2, head_dim=24,
                 d_ff=192, vocab_size=320, tie_embeddings=False)
TOY_CONFIGS = {
    "toy-dense": {"edge": [{"model": _model("toy-slm", "dense")}]},
    "toy-ssmhybrid": {"edge": [
        {"model": _model("toy-mamba2", "ssm", n_heads=1, n_kv_heads=1,
                         d_ff=0, activation="silu", ssm_state=16,
                         ssm_head_dim=16, ssm_expand=2, ssm_conv=4,
                         ssm_chunk=32, ssm_groups=1,
                         lora_targets=["in_proj", "out_proj"])},
        {"model": _model("toy-hymba", "hybrid", n_kv_heads=2,
                         activation="silu", sliding_window=8,
                         global_every=2, ssm_state=8, ssm_head_dim=16,
                         ssm_expand=2, ssm_conv=4, ssm_chunk=32,
                         ssm_groups=1, vocab_size=290,
                         lora_targets=["wq", "wk", "wv", "wo", "in_proj",
                                       "out_proj"])}]},
}
TOY_TRAFFIC = {
    "toy-one": {"cohorts": [{"clients": 3, "modalities": None}],
                "seq_len": 16},
    "toy-two": {"cohorts": [{"clients": 2, "modalities": [0, 1]},
                            {"clients": 2, "modalities": [2]}],
                "seq_len": 40},
}
TOY_CELLS = {"toy.dense": ("toy-dense", "toy-one"),
             "toy.ssmhybrid": ("toy-ssmhybrid", "toy-two")}


def write_toy_checkout(root: Path, limits=None) -> Path:
    """A checkout under ``root`` holding the toy cells; returns ``root``."""
    bench = root / "bench"
    for d in ("configs", "traffic", "limits"):
        (bench / d).mkdir(parents=True, exist_ok=True)
    shutil.copytree(BENCH / "metrics", bench / "metrics", dirs_exist_ok=True)
    for name, cfg in TOY_CONFIGS.items():
        doc = {"name": name, "source": "toy", "reduced": [], "assumed": [],
               "server_llm": {"model": TOY_LLM}, "server_slm": None, **cfg}
        (bench / "configs" / f"{name}.json").write_text(json.dumps(doc))
    for name, t in TOY_TRAFFIC.items():
        doc = {"cohorts": t["cohorts"], "batch_size": 4,
               "local_steps_ccl": 1, "local_steps_amt": 1,
               "server_steps": 1, "rho": 0.7, "n_negatives": 2,
               "lr": 0.003, "kt_weight": 0.5, "engine": "vectorized",
               "corpus": {"n_samples": 256, "seq_len": t["seq_len"],
                          "n_classes": 4, "n_modalities": 3,
                          "modality_dim": 16, "template_len": 4},
               "followed_rounds": 2}
        (bench / "traffic" / f"{name}.json").write_text(json.dumps(doc))
    manifest = json.loads((BENCH.parent / "BENCHMARK.json").read_text())
    manifest["configs"] = [
        {"name": n, "source": "toy", "file": f"bench/configs/{n}.json",
         "reduced": [], "why": "toy"} for n in TOY_CONFIGS]
    manifest["workloads"] = [
        {"name": c, "config": cfg, "traffic": tr, "chips": 1, "why": "toy"}
        for c, (cfg, tr) in TOY_CELLS.items()]
    for m in manifest["per_layer"]:
        m.pop("workloads", None)
    (root / "BENCHMARK.json").write_text(json.dumps(manifest))
    for c in TOY_CELLS:
        (bench / "limits" / f"{c}.json").write_text(json.dumps(
            limits or {"loss_gap": 1e-4, "grad_gap": 1e-4,
                       "moment_gap": 1e-3, "change_gap": 1e-3}))
    return root


@pytest.fixture
def toy_checkout(tmp_path):
    return write_toy_checkout(tmp_path)
