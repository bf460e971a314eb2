"""Model configurations (the port's own copy of ``repro.configs``)."""
from repro_torch.configs.base import (ARCH_IDS, INPUT_SHAPES, InputShape,
                                      ModelConfig, get_config)
