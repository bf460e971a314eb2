"""gemma-2b: dense, GeGLU, head_dim 256, MQA [arXiv:2403.08295] (copied from
``repro.configs.gemma_2b``).  Shapes match the published model; weights are
random."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="gemma-2b",
    family="dense",
    source="arXiv:2403.08295 (Gemma)",
    n_layers=18,
    d_model=2048,
    n_heads=8, n_kv_heads=1, head_dim=256,   # MQA
    d_ff=16384,
    vocab_size=256000,
    activation="geglu",
    tie_embeddings=True,
    rope_theta=10000.0,
    n_modalities=3,
)
