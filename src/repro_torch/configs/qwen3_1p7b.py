"""qwen3-1.7b (copied from ``repro.configs.qwen3_1p7b``): dense, qk_norm,
GQA with 8 KV heads [hf:Qwen/Qwen3-8B family card].  Shapes match the
published model; weights are random."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-1.7b",
    family="dense",
    source="hf:Qwen/Qwen3-1.7B (assignment card: Qwen3-8B)",
    n_layers=28,
    d_model=2048,
    n_heads=16, n_kv_heads=8, head_dim=128,
    d_ff=6144,
    vocab_size=151936,
    activation="silu",
    qk_norm=True,
    tie_embeddings=True,
    rope_theta=1_000_000.0,
    n_modalities=3,
)
