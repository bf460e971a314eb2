"""AdamW over flat dicts of tensors (port of ``repro.optim.adamw``):
decoupled weight decay, bias correction, global-norm clipping, float32
moments whatever the param dtype.  Functional, as the reference: ``update``
returns new updates and a new state and changes nothing in place."""
from __future__ import annotations

from typing import Callable, Dict, NamedTuple, Optional

import torch


class Optimizer(NamedTuple):
    init: Callable
    update: Callable     # (grads, state, params) -> (updates, state)


def global_norm(tree: Dict[str, torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum of squares over all leaves, in f32 (leaves summed
    in sorted-key order, the reference's ``jax.tree.leaves`` order)."""
    sq = [torch.sum(tree[k].float() ** 2) for k in sorted(tree)]
    return torch.sqrt(torch.sum(torch.stack(sq)))


def clip_by_global_norm(tree: Dict[str, torch.Tensor], max_norm: float):
    norm = global_norm(tree)
    scale = torch.clamp(max_norm / (norm + 1e-9), max=1.0)
    return {k: g.float() * scale for k, g in tree.items()}, norm


def adamw(lr: Callable | float, b1: float = 0.9, b2: float = 0.95,
          eps: float = 1e-8, weight_decay: float = 0.0,
          clip_norm: Optional[float] = 1.0) -> Optimizer:
    lr_fn = lr if callable(lr) else (lambda _: lr)

    def init(params: Dict[str, torch.Tensor]):
        dev = next(iter(params.values())).device
        zeros = {k: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
                 for k, p in params.items()}
        return {"step": torch.zeros((), dtype=torch.int32, device=dev),
                "mu": zeros,
                "nu": {k: z.clone() for k, z in zeros.items()}}

    def update(grads, state, params):
        step = state["step"] + 1
        if clip_norm is not None:
            grads, _ = clip_by_global_norm(grads, clip_norm)
        else:
            grads = {k: g.float() for k, g in grads.items()}
        mu = {k: b1 * state["mu"][k] + (1 - b1) * g for k, g in grads.items()}
        nu = {k: b2 * state["nu"][k] + (1 - b2) * g * g
              for k, g in grads.items()}
        t = step.float()
        bc1 = 1 - torch.tensor(b1, dtype=torch.float32, device=t.device) ** t
        bc2 = 1 - torch.tensor(b2, dtype=torch.float32, device=t.device) ** t
        lr_t = lr_fn(step)

        def upd(m, v, p):
            u = (m / bc1) / (torch.sqrt(v / bc2) + eps)
            if weight_decay:
                u = u + weight_decay * p.float()
            return (-lr_t * u).to(p.dtype)

        updates = {k: upd(mu[k], nu[k], params[k]) for k in grads}
        return updates, {"step": step, "mu": mu, "nu": nu}

    return Optimizer(init, update)


def apply_updates(params: Dict[str, torch.Tensor],
                  updates: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """p + u, with u cast to p's dtype."""
    return {k: p + updates[k].to(p.dtype) for k, p in params.items()}
