"""One stacked local step of the port against the reference's, shared by
the moe, encdec and vlm parity tests.

G clients, each with its own personal leaves (LoRA, connector, frontend
projector: the reference's at init plus a numpy draw per client) and its
own batch (tokens, a partial loss mask, modality features under its own
modality masks, a server anchor, and the frontend's stub features where
the family has a frontend).  The reference runs ``make_stacked_step`` (a
``vmap`` of its local step over G whole trees); the port runs its
``make_stacked_step`` on one backbone with the personal leaves stacked
(G, ...).  Both take SGD (lr 0.1), so each updated leaf is p - lr g and
the comparison holds every client's gradient row by row.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.core import ccl as jccl
from repro.core import lora as jlora
from repro.optim.adamw import sgd as jsgd
from repro_torch.core import ccl, lora
from repro_torch.data import pipeline
from repro_torch.optim.adamw import sgd
from test_torch_serving import flat_numpy, port_pair
from test_torch_train import rows_close

METRIC_TOL = dict(atol=2e-4, rtol=2e-4)
LR = 0.1


def multimodal(jcfg, **kw):
    """``jcfg`` with three modalities behind a connector (latent 24, 3
    soft tokens) and ``kw``."""
    return dataclasses.replace(jcfg, n_modalities=3, modality_dim=16,
                               connector_dim=24, n_soft_tokens=3, **kw)


def client_batches(jcfg, G, B, S, seed):
    """Numpy leaves (G, B, ...): each client's own draw and masks."""
    rng = np.random.RandomState(seed)
    M = jcfg.n_modalities
    masks = np.array([[1, 0, 1], [1, 1, 1], [0, 1, 1], [1, 1, 0]], bool)
    b = {"tokens": rng.randint(0, jcfg.vocab_size, (G, B, S)).astype(
            np.int32),
         "loss_mask": (rng.rand(G, B, S) > 0.2).astype(np.float32),
         "modality_mask": np.stack([np.roll(masks, g, 0)[:B, :M]
                                    for g in range(G)])}
    b["modality_feats"] = rng.randn(G, B, M, jcfg.modality_dim).astype(
        np.float32) * b["modality_mask"][..., None]
    if jcfg.frontend:
        b["frontend_embeds"] = (rng.randn(G, B, jcfg.frontend_tokens,
                                          jcfg.frontend_dim) * 0.5).astype(
            np.float32)
    anchor = rng.randn(G, B, jcfg.connector_dim).astype(np.float32)
    return b, anchor


def stacked_step_against_reference(jcfg, G=3, B=2, S=12, seed=0):
    """Runs both stacked steps; checks every metric per client (2e-4) and
    every updated personal leaf row by row (1e-4).  Returns the port's
    metrics of (G,) values."""
    jb, jp, tb, tp = port_pair(jcfg, unified=True)
    rng = np.random.RandomState(seed + 1)
    base = flat_numpy(jlora.partition(jp))
    pers = [{k: (v + rng.randn(*v.shape) * 0.05).astype(np.float32)
             for k, v in base.items()} for _ in range(G)]
    jtrees = [jlora.combine(jp, {k: jnp.asarray(v) for k, v in p.items()})
              for p in pers]
    jstacked = jax.tree.map(lambda *xs: jnp.stack(xs), *jtrees)
    jopt, topt = jsgd(LR), sgd(LR)
    jstate = jax.tree.map(lambda *xs: jnp.stack(xs),
                          *[jopt.init(jlora.partition(t)) for t in jtrees])
    b, anchor = client_batches(jcfg, G, B, S, seed)
    jnew, _, jm = jax.jit(jccl.make_stacked_step(jb, jopt, n_negatives=1))(
        jstacked, jstate, {k: jnp.asarray(v) for k, v in b.items()},
        jnp.asarray(anchor))

    tpers = [{k: torch.from_numpy(v) for k, v in p.items()} for p in pers]
    tstacked = lora.combine(tp, lora.stack_clients(tpers))
    tstate = lora.stack_trees([topt.init(p) for p in tpers])
    tnew, tstate, tm = ccl.make_stacked_step(tb, topt, n_negatives=1)(
        tstacked, tstate, pipeline.to_tensors(b, "cpu"),
        torch.from_numpy(anchor))
    assert tstate["step"].tolist() == [1] * G
    for k, v in tm.items():
        assert v.shape == (G,), k
        np.testing.assert_allclose(v.float().numpy(), np.asarray(jm[k]),
                                   **METRIC_TOL, err_msg=k)
    jflat, tflat = flat_numpy(jlora.partition(jnew)), lora.partition(tnew)
    assert sorted(jflat) == sorted(tflat)
    for k, v in tflat.items():
        assert v.shape[0] == G, k
        rows_close(v, jflat[k], k)
    frozen = lora.flatten(tp)
    for k, v in lora.flatten(tnew).items():
        if not lora.default_trainable(k):
            assert v is frozen[k], k
    return tm
