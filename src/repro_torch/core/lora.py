"""LoRA parameter handling and the trainable/frozen split (port of
``repro.core.lora``).

Params are nested dicts of tensors.  Their flat form is keyed by the
'/'-joined paths of the reference's ``path_str`` (``layers/attn/wq``), the
key space :mod:`repro_torch.interop` carries weights across in.  The
trainable subset is such a flat dict: gradients are taken over it only.
"""
from __future__ import annotations

from typing import Callable, Dict, List, Sequence, Tuple

import torch

from repro_torch.core.channel import TensorSpec


def path_str(path: Sequence) -> str:
    """'/'-join a sequence of dict keys (the reference's path format)."""
    return "/".join(str(p) for p in path)


def flatten(tree: dict, prefix: Sequence = ()) -> Dict[str, torch.Tensor]:
    """Nested dict of tensors -> {path_str: tensor}."""
    out: Dict[str, torch.Tensor] = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(flatten(v, (*prefix, k)))
        else:
            out[path_str((*prefix, k))] = v
    return out


def unflatten(flat: Dict[str, torch.Tensor]) -> dict:
    """Inverse of :func:`flatten`."""
    tree: dict = {}
    for path, leaf in flat.items():
        *parents, last = path.split("/")
        node = tree
        for p in parents:
            node = node.setdefault(p, {})
        node[last] = leaf
    return tree


def is_lora_leaf(path: str) -> bool:
    """True for LoRA adapter leaves (``*_lora_a`` / ``*_lora_b``)."""
    return "_lora_a" in path or "_lora_b" in path


def default_trainable(path: str) -> bool:
    """The paper's AMT trainable set: LoRA adapters + the multimodal
    connector + the (stub) frontend projector."""
    return (is_lora_leaf(path) or path.startswith("connector")
            or path.startswith("frontend"))


def all_trainable(path: str) -> bool:
    """Full fine-tune (the Multi-FedAvg baseline): every leaf."""
    return True


def partition(params: dict,
              predicate: Callable[[str], bool] = default_trainable
              ) -> Dict[str, torch.Tensor]:
    """The leaves whose path satisfies ``predicate``, as a flat dict."""
    return {k: v for k, v in flatten(params).items() if predicate(k)}


def combine(params: dict, trainable: Dict[str, torch.Tensor]) -> dict:
    """A new tree with ``trainable``'s leaves put in; leaves without an
    entry (a partial dict) pass through as the same tensors."""
    def visit(tree, prefix):
        return {k: visit(v, (*prefix, k)) if isinstance(v, dict)
                else trainable.get(path_str((*prefix, k)), v)
                for k, v in tree.items()}
    return visit(params, ())


def shared_keys(a: Dict[str, torch.Tensor], b: Dict[str, torch.Tensor]
                ) -> Tuple[str, ...]:
    """Keys present in both flat dicts with one shape and dtype."""
    return tuple(sorted(
        k for k, v in a.items()
        if k in b and b[k].shape == v.shape and b[k].dtype == v.dtype))


def stack_trees(trees: Sequence[dict]) -> dict:
    """Stack identically-structured dicts of tensors on a new axis 0."""
    first = trees[0]
    return {k: stack_trees([t[k] for t in trees]) if isinstance(v, dict)
            else torch.stack([t[k] for t in trees]) for k, v in first.items()}


def gather_tree_device(tree: dict, j: int) -> dict:
    """Client ``j`` of a tree whose every leaf is stacked on axis 0."""
    return {k: gather_tree_device(v, j) if isinstance(v, dict) else v[j]
            for k, v in tree.items()}


def unstack_tree(tree: dict, n: int) -> list:
    """Inverse of :func:`stack_trees`: the ``n`` trees of the clients."""
    return [gather_tree_device(tree, j) for j in range(n)]


# ---------------------------------------------------------------------------
# the clients of a cohort as one flat dict with a leading client axis (the
# reference's ``StackedClients``).  The vectorized engine stacks only the
# personal leaves (LoRA + connector): the cohort keeps one frozen backbone.


def stack_clients(clients: Sequence[Dict[str, torch.Tensor]]
                  ) -> Dict[str, torch.Tensor]:
    """Stack per-client flat dicts (one key set) client-major: (N, ...)."""
    keys = set(clients[0])
    if any(set(c) != keys for c in clients):
        raise ValueError("the clients' key sets differ")
    return {k: torch.stack([c[k] for c in clients]) for k in clients[0]}


def gather_client(stacked: Dict[str, torch.Tensor], j: int
                  ) -> Dict[str, torch.Tensor]:
    """Client ``j``'s leaves of a stacked flat dict."""
    return {k: v[j] for k, v in stacked.items()}


def unstack_clients(stacked: Dict[str, torch.Tensor]
                    ) -> List[Dict[str, torch.Tensor]]:
    """Inverse of :func:`stack_clients`."""
    n = next(iter(stacked.values())).shape[0]
    return [gather_client(stacked, j) for j in range(n)]


def broadcast_clients(stacked: Dict[str, torch.Tensor],
                      flat: Dict[str, torch.Tensor]
                      ) -> Dict[str, torch.Tensor]:
    """Every client's entry of ``stacked``'s keys replaced by the shared
    ``flat`` value (the redistribution, Alg. 1 step 5): an expanded view,
    no copy."""
    n = next(iter(stacked.values())).shape[0]
    return {k: flat[k].expand((n,) + tuple(flat[k].shape)) for k in stacked}


def n_params(tree: dict) -> int:
    """Number of scalars in a (nested or flat) dict of tensors."""
    return sum(v.numel() for v in flatten(tree).values())


def communicated_fraction(params: dict,
                          predicate: Callable[[str], bool] = is_lora_leaf,
                          channel=None) -> float:
    """Fraction of the parameter volume communicated per round (paper
    Fig. 3: 0.65 % for the r=8 SLM).

    With ``channel=None``: communicated parameters over all parameters
    (the count form).  With a :class:`repro_torch.core.channel.Channel` or
    ``ChannelSpec``: the codec's exact ``bytes_on_wire`` for the
    communicated leaves over the dense bytes of the whole model.  Only the
    leaves' shapes and dtypes are read."""
    flat = partition(params, predicate)
    if channel is None:
        return n_params(flat) / max(1, n_params(params))
    channel = channel.make() if hasattr(channel, "make") else channel
    like = {k: TensorSpec((1, *v.shape), v.dtype) for k, v in flat.items()}
    total = sum(v.numel() * v.dtype.itemsize
                for v in flatten(params).values())
    return channel.bytes_on_wire(like) / max(1, total)


def merge_lora(params: dict, cfg) -> dict:
    """Fold LoRA updates into the frozen weights (W' = W + (α/r) A B),
    summed in float32 and cast back, so decode pays no adapter cost.

    The adapter leaves are dropped from the result.  The reference keeps
    them, and its ``proj`` then adds (α/r) A B a second time on top of the
    merged weight (ROADMAP, faults found against the reference); without
    them ``proj`` computes exactly W' x."""
    flat = flatten(params)
    scale = cfg.lora_alpha / cfg.lora_rank
    new = {}
    for s, leaf in flat.items():
        if is_lora_leaf(s):
            continue
        a = flat.get(s + "_lora_a")
        if a is not None:
            leaf = _merged(leaf, a, flat[s + "_lora_b"], scale)
        new[s] = leaf
    return unflatten(new)


def _merged(w, a, b, scale: float):
    """W + scale A B in float32, cast back; a leaf stacked over layers is
    merged one layer at a time (granite-20b's stacked wq is 7.9 GB in
    float32)."""
    if w.dim() > 2:
        out = torch.empty_like(w)
        for i in range(w.shape[0]):
            out[i] = _merged(w[i], a[i], b[i], scale)
        return out
    return (w.float() + scale * (a.float() @ b.float())).to(w.dtype)
