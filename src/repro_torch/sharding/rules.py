"""Logical-axis -> mesh-axis rules (port of ``repro.sharding.rules``).

Model and runner code name tensor dimensions by *logical* axis; the rules
map those to the axes of a ``torch.distributed`` DeviceMesh.  A production
mesh is either ("data", "model") for one 16 x 16 pod or ("pod", "data",
"model") for two; the "pod" axis joins "data" for batch parallelism so the
same rules serve both.  A :class:`Spec` is the port's PartitionSpec: one
entry a dimension, each ``None`` (replicated), a mesh axis name, or a
tuple of names.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple, Union

Axis = Union[None, str, Tuple[str, ...]]


class Spec(tuple):
    """An immutable per-dimension placement: ``Spec("model", None)``, a
    tuple of its entries.  A one-name tuple entry is that name, as in
    ``jax.sharding.PartitionSpec``."""

    def __new__(cls, *entries: Axis):
        return super().__new__(cls, (
            e[0] if isinstance(e, tuple) and len(e) == 1 else e
            for e in entries))

    def __repr__(self) -> str:
        return f"Spec{tuple.__repr__(self)}"


@dataclasses.dataclass(frozen=True)
class Rules:
    name: str
    mapping: dict

    def axis(self, logical: Optional[str]) -> Axis:
        if logical is None:
            return None
        return self.mapping.get(logical)

    def spec(self, *logical: Optional[str]) -> Spec:
        return Spec(*[self.axis(a) for a in logical])


def _base(batch_axes: Axis, kv_seq: Axis = None) -> dict:
    return {
        # activations
        "batch": batch_axes,
        # stacked federated clients: the stacked engines' client axis
        # parallelizes over the same ranks as data parallelism
        "device": batch_axes,
        "seq": None,
        "kv_seq": kv_seq,        # decode: KV cache sequence dim
        "embed": None,
        "act_heads": "model",    # activation head dim (flattened h*hd)
        "act_ff": "model",
        "act_experts": "model",
        "act_ssm": "model",
        # banded attention: query/key blocks are embarrassingly parallel
        "seq_block": "model",
        # weights
        "vocab": "model",
        "heads": "model",        # flattened (n_heads*head_dim) weight dim
        "kv_heads": "model",
        "ff": "model",
        "experts": "model",
        "ssm_inner": "model",
        # FSDP axis for expert weights: experts on "model", d_model on
        # "data"
        "embed_fsdp": "data",
        "replicated": None,
    }


def rules_for(kind: str, multi_pod: bool) -> Rules:
    batch: Axis = ("pod", "data") if multi_pod else ("data",)
    if kind == "train" or kind == "prefill":
        return Rules(f"{kind}{'_mp' if multi_pod else ''}", _base(batch))
    if kind == "decode":
        # decode: the KV cache's sequence dim over "data" (sequence
        # parallelism); batch additionally over "pod" when present
        return Rules(f"decode{'_mp' if multi_pod else ''}",
                     _base(batch, kv_seq="data"))
    raise ValueError(kind)


TRAIN_RULES = rules_for("train", multi_pod=False)
DECODE_RULES = rules_for("decode", multi_pod=False)
