"""The port's collectives on ``torch.distributed`` over nested trees, and
their conjugates under autograd.

Every rank calls each collective in the same order, with tensors of the
same shapes and dtypes.  The tensors stay where they are: NCCL and gloo
both take CUDA tensors for ``all_gather``, ``all_reduce`` and
``broadcast`` (gloo as of torch 2.11, checked on an H100 by
``chip_smoke.py``'s ``distribution_ranks`` phase, two gloo ranks on one
card), so nothing is staged through the host.

The autograd forms make a collective differentiable where every rank
holds the same loss (the replicated-loss convention of
``moe_mlp_sharded``): each rank's gradient of its local copy of a
replicated input is its share, so

* :func:`enter_replicated` (identity forward) all-reduces the gradient;
* :func:`reduce_partials` (all-reduce forward) passes the gradient on;
* :func:`gather_blocks` (all-gather of the data blocks forward) keeps
  this rank's block of the gradient.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import torch
import torch.distributed as dist


def all_gather(t: torch.Tensor, group=None) -> List[torch.Tensor]:
    """Every rank's ``t`` of ``group``, in rank order."""
    parts = [torch.empty_like(t) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, t.contiguous(), group=group)
    return parts


def broadcast_tree(tree: Optional[Dict], like: Dict, src: int, device,
                   group=None) -> Dict:
    """A nested dict of tensors held by global rank ``src`` on every rank
    of ``group``: ``like`` is its template (meta tensors, the same on
    every rank), ``tree`` the tree on ``src`` (None elsewhere).  One
    packed broadcast a dtype, the leaves in sorted-key order; ``src``
    gets its own ``tree`` back, the others new tensors on ``device``."""
    flat: Dict[tuple, torch.Tensor] = {}

    def walk(node, path):
        for k in sorted(node):
            if isinstance(node[k], dict):
                walk(node[k], (*path, k))
            else:
                flat[(*path, k)] = node[k]
    walk(like, ())
    mine = dist.get_rank() == src
    got: Dict[tuple, torch.Tensor] = {}
    groups: Dict[torch.dtype, List[tuple]] = {}
    for key, v in flat.items():
        groups.setdefault(v.dtype, []).append(key)
    for dtype, keys in groups.items():
        sizes = [flat[k].numel() for k in keys]
        if mine:
            buf = torch.cat([_leaf(tree, k).reshape(-1) for k in keys])
        else:
            buf = torch.empty((sum(sizes),), dtype=dtype, device=device)
        dist.broadcast(buf, src=src, group=group)
        if not mine:
            for k, part in zip(keys, torch.split(buf, sizes)):
                got[k] = part.view(flat[k].shape)
    if mine:
        return tree
    out: Dict = {}
    for key, v in got.items():
        node = out
        for p in key[:-1]:
            node = node.setdefault(p, {})
        node[key[-1]] = v
    return out


def _leaf(tree: Dict, key: tuple) -> torch.Tensor:
    for p in key:
        tree = tree[p]
    return tree


# ---------------------------------------------------------------------------
# conjugate collectives (autograd)

class _EnterReplicated(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, groups):
        ctx.groups = groups
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        for group in ctx.groups:
            dist.all_reduce(g, group=group)
        return g, None


class _ReducePartials(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, groups):
        y = x.contiguous().clone()
        for group in groups:
            dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherBlocks(torch.autograd.Function):
    @staticmethod
    def forward(ctx, y, groups, block, n_blocks):
        ctx.block, ctx.n_blocks = block, n_blocks
        for group in reversed(groups):
            y = torch.cat(all_gather(y.contiguous(), group), dim=0)
        return y

    @staticmethod
    def backward(ctx, g):
        rows = g.shape[0] // ctx.n_blocks
        return (g[ctx.block * rows:(ctx.block + 1) * rows].contiguous(),
                None, None, None)


def enter_replicated(x: torch.Tensor, groups: Sequence) -> torch.Tensor:
    """``x`` (the same on every rank of ``groups``) as it is; its gradient
    is summed over ``groups``, one all-reduce a group."""
    return _EnterReplicated.apply(x, tuple(groups))


def reduce_partials(x: torch.Tensor, groups: Sequence) -> torch.Tensor:
    """The sum of the ranks' ``x`` over ``groups`` (a new tensor, one
    all-reduce a group); its gradient passes unchanged to each rank's
    ``x``."""
    return _ReducePartials.apply(x, tuple(groups))


def gather_blocks(y: torch.Tensor, groups: Sequence, block: int,
                  n_blocks: int) -> torch.Tensor:
    """The ranks' dim-0 blocks ``y`` concatenated in block order over the
    data ``groups`` (outermost first; gathered innermost first), where
    this rank's block is ``block`` of ``n_blocks``; the gradient keeps
    this rank's block."""
    return _GatherBlocks.apply(y, tuple(groups), block, n_blocks)
