"""qwen3-moe-235b-a22b: 128 experts, top-8, GQA with 4 KV heads
[hf:Qwen/Qwen3-30B-A3B scaled per assignment] (copied from
``repro.configs.qwen3_moe_235b_a22b``).  Shapes match the published model; weights are
random."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-moe-235b-a22b",
    family="moe",
    source="hf:Qwen/Qwen3-235B-A22B (assignment: Qwen3-30B-A3B card)",
    n_layers=94,
    d_model=4096,
    n_heads=64, n_kv_heads=4, head_dim=128,
    d_ff=0,
    d_ff_expert=1536,
    n_experts=128,
    top_k=8,
    vocab_size=151936,
    activation="silu",
    qk_norm=True,
    tie_embeddings=False,
    rope_theta=1_000_000.0,
    n_modalities=3,
)
