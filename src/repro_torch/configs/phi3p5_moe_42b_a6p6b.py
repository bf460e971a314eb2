"""phi3.5-moe-42b-a6.6b: 16 experts, top-2
[hf:microsoft/Phi-3.5-MoE-instruct] (copied from
``repro.configs.phi3p5_moe_42b_a6p6b``).  Shapes match the published model; weights are
random."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="phi3.5-moe-42b-a6.6b",
    family="moe",
    source="hf:microsoft/Phi-3.5-MoE-instruct",
    n_layers=32,
    d_model=4096,
    n_heads=32, n_kv_heads=8, head_dim=128,
    d_ff=0,
    d_ff_expert=6400,
    n_experts=16,
    top_k=2,
    vocab_size=32064,
    activation="silu",
    tie_embeddings=False,
    n_modalities=3,
)
