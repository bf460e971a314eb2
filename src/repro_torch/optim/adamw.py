"""AdamW and SGD over flat dicts of tensors (port of
``repro.optim.adamw``).  AdamW: decoupled weight decay, bias correction,
global-norm clipping; SGD: plain or with heavy-ball momentum; float32
moments whatever the param dtype.  Functional, as the reference:
``update`` returns new updates and a new state and changes nothing in
place.

``update_stacked`` is ``vmap(update)`` over a leading client axis: every
leaf, gradient and moment is (G, ...), the step count is (G,), and the
global-norm clip is taken per client."""
from __future__ import annotations

from typing import Callable, Dict, NamedTuple, Optional

import torch


class Optimizer(NamedTuple):
    init: Callable
    update: Callable     # (grads, state, params) -> (updates, state)
    update_stacked: Callable   # the same over a leading client axis


def global_norm(tree: Dict[str, torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum of squares over all leaves, in f32 (leaves summed
    in sorted-key order, the reference's ``jax.tree.leaves`` order)."""
    sq = [torch.sum(tree[k].float() ** 2) for k in sorted(tree)]
    return torch.sqrt(torch.sum(torch.stack(sq)))


def clip_by_global_norm(tree: Dict[str, torch.Tensor], max_norm: float):
    norm = global_norm(tree)
    scale = torch.clamp(max_norm / (norm + 1e-9), max=1.0)
    return {k: g.float() * scale for k, g in tree.items()}, norm


def _per_client(v: torch.Tensor, leaf: torch.Tensor) -> torch.Tensor:
    """A (G,) vector shaped to broadcast over a (G, ...) leaf."""
    return v.reshape(v.shape[:1] + (1,) * (leaf.dim() - 1))


def _client_col(v, leaf):
    """A per-step value shaped to broadcast over a (G, ...) leaf: a (G,)
    tensor per client, a scalar as it is."""
    if isinstance(v, torch.Tensor) and v.dim():
        return _per_client(v, leaf)
    return v


def stacked_global_norm(tree: Dict[str, torch.Tensor]) -> torch.Tensor:
    """Each client's :func:`global_norm` over (G, ...) leaves: (G,) f32
    (each client's leaf sums in one contiguous row, summed as
    :func:`global_norm` sums its 1-D stack, so the two agree bit for bit
    on the CPU)."""
    sq = [torch.sum(tree[k].float() ** 2, dim=tuple(range(1, tree[k].dim())))
          for k in sorted(tree)]
    return torch.sqrt(torch.sum(torch.stack(sq, dim=1), dim=1))


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

    def apply(grads, state, params, col):
        """The update from (clipped) f32 grads; ``col`` shapes a per-step
        scalar (or (G,) vector) to broadcast over a leaf."""
        step = state["step"] + 1
        mu = {k: b1 * state["mu"][k] + (1 - b1) * g for k, g in grads.items()}
        nu = {k: b2 * state["nu"][k] + (1 - b2) * g * g
              for k, g in grads.items()}
        t = step.float()
        bc1 = 1 - torch.tensor(b1, dtype=torch.float32, device=t.device) ** t
        bc2 = 1 - torch.tensor(b2, dtype=torch.float32, device=t.device) ** t
        lr_t = lr_fn(step)

        def upd(m, v, p):
            u = (m / col(bc1, m)) / (torch.sqrt(v / col(bc2, m)) + eps)
            if weight_decay:
                u = u + weight_decay * p.float()
            return (-col(lr_t, m) * u).to(p.dtype)

        updates = {k: upd(mu[k], nu[k], params[k]) for k in grads}
        return updates, {"step": step, "mu": mu, "nu": nu}

    def update(grads, state, params):
        if clip_norm is not None:
            grads, _ = clip_by_global_norm(grads, clip_norm)
        else:
            grads = {k: g.float() for k, g in grads.items()}
        return apply(grads, state, params, lambda v, leaf: v)

    def update_stacked(grads, state, params):
        """``update`` for G clients: (G, ...) leaves, ``state["step"]``
        (G,), each client clipped by its own global norm."""
        grads = {k: g.float() for k, g in grads.items()}
        if clip_norm is not None:
            scale = torch.clamp(clip_norm / (stacked_global_norm(grads)
                                             + 1e-9), max=1.0)
            grads = {k: g * _per_client(scale, g) for k, g in grads.items()}
        return apply(grads, state, params, _client_col)

    return Optimizer(init, update, update_stacked)


def sgd(lr: Callable | float, momentum: float = 0.0) -> Optimizer:
    """SGD: u = -lr * g, or with ``momentum`` m = momentum * m + g in f32
    and u = -lr * m; the update cast to the param's dtype."""
    lr_fn = lr if callable(lr) else (lambda _: lr)

    def init(params: Dict[str, torch.Tensor]):
        dev = next(iter(params.values())).device
        st = {"step": torch.zeros((), dtype=torch.int32, device=dev)}
        if momentum:
            st["mu"] = {k: torch.zeros(p.shape, dtype=torch.float32,
                                       device=p.device)
                        for k, p in params.items()}
        return st

    def apply(grads, state, params, col):
        step = state["step"] + 1
        lr_t = lr_fn(step)
        if momentum:
            mu = {k: momentum * state["mu"][k] + g.float()
                  for k, g in grads.items()}
            return ({k: (-col(lr_t, m) * m).to(params[k].dtype)
                     for k, m in mu.items()}, {"step": step, "mu": mu})
        return ({k: (-col(lr_t, g) * g.float()).to(params[k].dtype)
                 for k, g in grads.items()}, {"step": step})

    def update(grads, state, params):
        return apply(grads, state, params, lambda v, leaf: v)

    def update_stacked(grads, state, params):
        """``update`` for G clients: (G, ...) leaves, ``state["step"]``
        (G,)."""
        return apply(grads, state, params, _client_col)

    return Optimizer(init, update, update_stacked)


def apply_updates(params: Dict[str, torch.Tensor],
                  updates: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """p + u, with u cast to p's dtype."""
    return {k: p + updates[k].to(p.dtype) for k, p in params.items()}
