"""granite-20b: dense llama-arch code model, MQA, a gpt-bigcode-style
two-matrix gelu MLP (20.1B in all) [arXiv:2405.04324] (copied from
``repro.configs.granite_20b``).  Shapes match the published model; weights are
random."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="granite-20b",
    family="dense",
    source="arXiv:2405.04324 (Granite Code Models)",
    n_layers=52,
    d_model=6144,
    n_heads=48, n_kv_heads=1, head_dim=128,   # MQA
    d_ff=24576,
    vocab_size=49152,
    activation="gelu",     # gpt-bigcode-style 2-matrix MLP (20.1B total;
                           # a 3-matrix silu MLP would overshoot to 28B)
    tie_embeddings=False,
    n_modalities=3,
)
