"""hymba-1.5b (copied from ``repro.configs.hymba_1p5b``): hybrid, parallel
attention + mamba heads per layer [arXiv:2411.13676].  Sliding-window
attention with periodic global layers (Hymba's 3 global layers
approximated as every-16th); meta tokens omitted, as in the reference.
Shapes match the published model; weights are random."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="hymba-1.5b",
    family="hybrid",
    source="arXiv:2411.13676 (Hymba)",
    n_layers=32,
    d_model=1600,
    n_heads=25, n_kv_heads=5, head_dim=64,
    d_ff=5504,
    vocab_size=32001,
    activation="silu",
    tie_embeddings=True,
    sliding_window=1024,
    global_every=16,
    ssm_state=16,
    ssm_head_dim=64,        # d_inner = 3200 -> 50 SSM heads
    ssm_expand=2,
    ssm_conv=4,
    ssm_chunk=256,
    lora_targets=("wq", "wk", "wv", "wo", "in_proj", "out_proj"),
    n_modalities=3,
)
