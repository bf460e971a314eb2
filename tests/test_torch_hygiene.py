"""Package hygiene of the PyTorch/CUDA port: it imports no JAX and nothing
of the JAX package, and its entry points run on the card unless asked
for the CPU (no silent CPU run where CUDA is missing)."""
import ast
import pathlib

import numpy as np
import pytest
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.launch.serve_engine import EngineConfig, ServingEngine
from repro_torch.models.model import build_model

torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parent.parent
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) \
    + [ROOT / "chip_smoke.py"]


def forbidden_imports(tree: ast.AST):
    """(lineno, module) of every import of jax/jaxlib or of ``repro``."""
    def bad(mod: str) -> bool:
        top = mod.split(".")[0]
        return top in ("jax", "jaxlib", "repro")

    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                if bad(alias.name):
                    yield node.lineno, alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            if bad(node.module or ""):
                yield node.lineno, node.module


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_port_imports_no_jax_and_no_reference(path):
    found = list(forbidden_imports(ast.parse(path.read_text())))
    assert not found, f"{path.relative_to(ROOT)} imports {found}"


def test_checker_catches_forbidden_imports():
    src = ("import jax\nimport jax.numpy as jnp\nfrom repro.models import x\n"
           "import repro_torch\nfrom repro_torch.models import y\n"
           "from . import z\n")
    assert [m for _, m in forbidden_imports(ast.parse(src))] == \
        ["jax", "jax.numpy", "repro.models"]


def test_engine_without_device_raises_when_cuda_is_missing(monkeypatch):
    """EngineConfig defaults to device='cuda'; without a card the engine
    refuses instead of falling back to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = ModelConfig(name="t", n_layers=1, d_model=16, n_heads=2,
                      n_kv_heads=2, head_dim=8, d_ff=32, vocab_size=32,
                      dtype="float32")
    bundle = build_model(cfg)
    params = bundle.init(torch.Generator().manual_seed(0))
    assert EngineConfig().device == "cuda"
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ServingEngine(bundle, params)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ServingEngine(bundle, params, EngineConfig(device="cuda"))
    engine = ServingEngine(bundle, params, EngineConfig(device="cpu"))
    engine.submit(np.arange(3), max_new=2)
    assert len(engine.run()) == 1


def test_engine_rejects_params_on_another_device():
    cfg = ModelConfig(name="t", n_layers=1, d_model=16, n_heads=2,
                      n_kv_heads=2, head_dim=8, d_ff=32, vocab_size=32,
                      dtype="float32")
    bundle = build_model(cfg)
    params = bundle.init(torch.Generator().manual_seed(0))
    params["final_norm"] = params["final_norm"].to("meta")
    with pytest.raises(ValueError, match="not on cpu"):
        ServingEngine(bundle, params, EngineConfig(device="cpu"))


@pytest.mark.parametrize("family", ["ssm", "hybrid"])
def test_recurrent_engines_without_device_raise_when_cuda_is_missing(
        monkeypatch, family):
    """The same for the ssm and hybrid families: the card by default, the
    CPU only when asked."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = ModelConfig(name="t", family=family, n_layers=1, d_model=16,
                      n_heads=2, n_kv_heads=2, head_dim=8, d_ff=32,
                      vocab_size=32, ssm_state=4, ssm_head_dim=8,
                      ssm_chunk=4, dtype="float32")
    bundle = build_model(cfg)
    params = bundle.init(torch.Generator().manual_seed(0))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ServingEngine(bundle, params)
    engine = ServingEngine(bundle, params, EngineConfig(device="cpu"))
    engine.submit(np.arange(3), max_new=2)
    assert len(engine.run()) == 1
