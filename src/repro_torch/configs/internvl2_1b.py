"""internvl2-1b: VLM; the InternViT vision encoder is a stub (the caller
passes (B, 256, 1024) patch embeddings, projected by
``transformer.frontend_prefix``), the Qwen2-0.5B-class language decoder
is implemented [arXiv:2404.16821] (copied from
``repro.configs.internvl2_1b``).  Shapes match the published model; weights are
random."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="internvl2-1b",
    family="vlm",
    source="arXiv:2404.16821 (InternVL2)",
    n_layers=24,
    d_model=896,
    n_heads=14, n_kv_heads=2, head_dim=64,
    d_ff=4864,
    vocab_size=151655,
    activation="silu",
    tie_embeddings=True,
    rope_theta=1_000_000.0,
    frontend="vision",
    frontend_tokens=256,
    frontend_dim=1024,
    n_modalities=3,
)
