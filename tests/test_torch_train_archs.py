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


@pytest.mark.parametrize("arch", ASSIGNED)
def test_train_step_matches_reference(arch):
    jcfg = dataclasses.replace(jget_config(arch).reduced(), dtype="float32")
    jb, jp, tb, tp = unified_pair(jcfg, seed=2)
    b = batch_np(jcfg)
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
    if jcfg.family == "encdec":
        for k in ("connector/spg_scale", "connector/spg_bias"):
            assert torch.equal(tflat[k], t0[k])
            np.testing.assert_array_equal(jflat[k], flat_numpy(jp)[k])
        assert not torch.equal(tflat["connector/proj_w"],
                               t0["connector/proj_w"])
