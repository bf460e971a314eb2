"""The trainer on every assigned architecture: for each arch of
``repro.configs.base.ARCH_IDS`` that the reference's
tests/test_smoke_archs.py trains (all but the paper's own pair), at
``.reduced()`` and float32, one ``make_train_step`` of the port from the
reference's init (LoRA B filled from a numpy seed, carried over by
``interop``) against the reference's jitted ``make_train_step`` on the
same batch (modality features and a server anchor; the vlm and encdec
frontends' stub features): the loss within 2e-4, every updated leaf
within 1e-4 of its row's largest |value|, the frozen leaves the input's
tensors.  whisper-medium's case is the encdec family under CCL: its
connector feeds CCL, and its soft-prompt leaves, which no loss reads,
stay where they were in both packages.

The step takes SGD (lr 0.1): an updated leaf is then p - lr g, so the
comparison holds every gradient row by row.  AdamW's first step moves an
element by about lr * sign(g), so an element whose gradient is f32 noise
(a modality no row of the batch has) moves by a different fraction of lr
in each package; tests/test_torch_train.py holds AdamW's steps.
"""
import dataclasses
import importlib.util
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import ARCH_IDS
from repro.configs.base import get_config as jget_config
from repro.core import lora as jlora
from repro.launch import train as jtrain
from repro.optim.adamw import sgd as jsgd
from repro_torch.configs.base import get_config as tget_config
from repro_torch.core import lora
from repro_torch.data import pipeline
from repro_torch.launch import train
from repro_torch.optim.adamw import sgd
from test_torch_train import rows_close
from test_torch_training import flat_numpy, unified_pair

torch.set_num_threads(1)

ASSIGNED = [a for a in ARCH_IDS if not a.startswith("mlecs")]
LOSS_TOL = dict(atol=2e-4, rtol=2e-4)


def batch_np(cfg, B=2, S=32, seed=1):
    """tests/test_smoke_archs.py::_batch's leaves, from numpy, with a
    partial loss mask and mixed modality masks."""
    rng = np.random.RandomState(seed)
    b = {"tokens": rng.randint(0, cfg.vocab_size, (B, S)).astype(np.int32),
         "loss_mask": (rng.rand(B, S) > 0.2).astype(np.float32)}
    if cfg.n_modalities:
        M = cfg.n_modalities
        b["modality_mask"] = np.array([[True] * M, [True] + [False] * (M - 1)]
                                      )[:B]
        b["modality_feats"] = rng.randn(B, M, cfg.modality_dim).astype(
            np.float32) * b["modality_mask"][..., None]
        b["anchor"] = rng.randn(B, cfg.connector_dim or cfg.d_model).astype(
            np.float32)
    if cfg.frontend:
        b["frontend_embeds"] = (rng.randn(B, cfg.frontend_tokens,
                                          cfg.frontend_dim) * 0.3).astype(
            np.float32)
    return b


def step_against_reference(arch, S):
    """One SGD ``make_train_step`` of the port against the reference's
    jitted one at ``.reduced()`` f32, rows of S tokens."""
    jcfg = dataclasses.replace(jget_config(arch).reduced(), dtype="float32")
    jb, jp, tb, tp = unified_pair(jcfg, seed=2)
    b = batch_np(jcfg, S=S)
    jopt, topt = jsgd(0.1), sgd(0.1)
    jnew, _, jm = jax.jit(jtrain.make_train_step(jb, jopt))(
        jp, jopt.init(jlora.partition(jp)),
        {k: jnp.asarray(v) for k, v in b.items()})
    tnew, ts, tm = train.make_train_step(tb, topt)(
        tp, topt.init(lora.partition(tp)), pipeline.to_tensors(b, "cpu"))
    assert sorted(tm) == sorted(jm)
    for k in jm:
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), **LOSS_TOL,
                                   err_msg=k)
    assert np.isfinite(float(tm["loss"]))
    if jcfg.is_moe:
        assert float(tm["aux"]) > 0
    jflat, tflat, t0 = flat_numpy(jnew), lora.flatten(tnew), lora.flatten(tp)
    assert sorted(jflat) == sorted(tflat)
    for k, v in tflat.items():
        if lora.default_trainable(k):
            rows_close(v, jflat[k], f"{arch}: {k}")
        else:
            assert v is t0[k], k
    return jcfg, jp, jflat, tflat, t0


@pytest.mark.parametrize("arch", ASSIGNED)
def test_train_step_matches_reference(arch):
    jcfg, jp, jflat, tflat, t0 = step_against_reference(arch, 32)
    if jcfg.family == "encdec":
        for k in ("connector/spg_scale", "connector/spg_bias"):
            assert torch.equal(tflat[k], t0[k])
            np.testing.assert_array_equal(jflat[k], flat_numpy(jp)[k])
        assert not torch.equal(tflat["connector/proj_w"],
                               t0["connector/proj_w"])


# rows of 96 tokens: behind the soft prompt (and the vlm's stub vision
# tokens) the window of 32 bites on the local layers, and the SSD spans
# three chunks of 32 and a ragged fourth, so its inter-chunk state
# carries a gradient
LONG_S = 96


@pytest.mark.parametrize("arch", ["gemma3-1b", "hymba-1.5b", "mamba2-2.7b",
                                  "internvl2-1b"])
def test_train_step_matches_reference_where_window_and_chunks_bite(arch):
    jcfg, _, _, tflat, t0 = step_against_reference(arch, LONG_S)
    S = LONG_S + jcfg.n_soft_tokens + jcfg.frontend_tokens
    if jcfg.sliding_window:
        assert S > 2 * jcfg.sliding_window
    if jcfg.ssm_state:
        assert S > 3 * jcfg.ssm_chunk
    if jcfg.frontend:
        # the projector's gradient came through the attention backward
        moved = [k for k in tflat if k.startswith("frontend/")
                 and not torch.equal(tflat[k], t0[k])]
        assert moved, "frontend leaves unmoved"


@pytest.fixture(scope="module")
def smoke():
    """``chip_smoke.py`` as a module (its launch plan is pure Python)."""
    path = pathlib.Path(__file__).resolve().parent.parent / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("arch", ["mamba2-2.7b", "hymba-1.5b"])
def test_trainer_launch_plan_counts_the_ssd(smoke, arch, dtype):
    """The card's trainer plan names G and G' (L x 2 under remat and L a
    step), hymba's in_proj on C's FMA route both ways at bf16, and every
    C, B, B', G and G' launch on the FMA route at f32."""
    cfg = dataclasses.replace(tget_config(arch), dtype=dtype)
    L, steps = cfg.n_layers, 2
    want, fma = smoke.trainer_launches(cfg, steps)
    assert want["ssd_chunk"] == L * 2 * steps
    assert want["ssd_chunk_bwd"] == L * steps
    attn = cfg.family == "hybrid"
    assert want["flash_attention"] == L * 2 * steps * attn
    assert want["flash_attention_backward"] == L * steps * attn
    n_targets = len(cfg.lora_targets)
    assert want["lora_matmul"] == steps * n_targets * (2 * L + L)
    if dtype == "float32":
        assert fma == {k: want[k] for k in (
            "lora_matmul", "flash_attention", "flash_attention_backward",
            "ssd_chunk", "ssd_chunk_bwd")}
    else:
        # in_proj (N = 2 d_inner + 2 G N + heads = 6,482) on FMAs, 2L
        # forward (remat) and L dx a step
        assert fma == {"lora_matmul": steps * 3 * L * attn}
