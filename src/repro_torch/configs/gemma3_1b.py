"""gemma3-1b: dense, 5:1 local:global attention, 128k context
[hf:google/gemma-3-1b-pt] (copied from
``repro.configs.gemma3_1b``).  Shapes match the published model; weights are
random."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="gemma3-1b",
    family="dense",
    source="hf:google/gemma-3-1b-pt",
    n_layers=26,
    d_model=1152,
    n_heads=4, n_kv_heads=1, head_dim=256,
    d_ff=6912,
    vocab_size=262144,
    activation="geglu",
    tie_embeddings=True,
    rope_theta=1_000_000.0,
    qk_norm=True,
    sliding_window=512,      # local layers
    global_every=6,          # 5 local : 1 global
    n_modalities=3,
)
