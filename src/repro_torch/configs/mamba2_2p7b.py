"""mamba2-2.7b (copied from ``repro.configs.mamba2_2p7b``): SSD
(state-space duality), attention-free [arXiv:2405.21060].  Shapes match
the published model; weights are random."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-2.7b",
    family="ssm",
    source="arXiv:2405.21060 (Mamba-2, SSD)",
    n_layers=64,
    d_model=2560,
    n_heads=1, n_kv_heads=1, head_dim=64,   # unused (attention-free)
    d_ff=0,
    vocab_size=50280,
    ssm_state=128,
    ssm_head_dim=64,          # d_inner = 5120 -> 80 SSD heads
    ssm_expand=2,
    ssm_conv=4,
    ssm_chunk=256,
    ssm_groups=1,
    activation="silu",
    tie_embeddings=True,
    lora_targets=("in_proj", "out_proj"),
    n_modalities=3,
)
