"""SPMD sharding on a ``torch.distributed`` DeviceMesh: logical-axis rules
and placement helpers (port of ``repro.sharding``)."""
from repro_torch.sharding.rules import (Rules, Spec, TRAIN_RULES,
                                        DECODE_RULES, rules_for)
from repro_torch.sharding.partition import (
    constrain, sharding_context, param_pspecs, tree_shardings,
)
