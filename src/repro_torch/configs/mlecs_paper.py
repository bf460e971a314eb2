"""The paper's own backbones (copied from ``repro.configs.mlecs_paper``):
the MiniLLM-gpt2-720M on-device SLM and the GPT-J-6B-class server LLM
(§4.1).  Shapes match the published models; weights are random."""
from repro_torch.configs.base import ModelConfig

SLM = ModelConfig(
    name="mlecs-slm-720m",
    family="dense",
    source="MiniLLM-gpt2-720M [14] (GPT-2 large shapes)",
    n_layers=36,
    d_model=1280,
    n_heads=20, n_kv_heads=20, head_dim=64,
    d_ff=5120,
    vocab_size=50257,
    activation="gelu",
    tie_embeddings=True,
    lora_rank=8,
    lora_alpha=16.0,
    n_modalities=3,           # VAST: vision / audio / subtitle
    modality_dim=256,
    n_soft_tokens=8,
)

LLM = ModelConfig(
    name="mlecs-llm-6b",
    family="dense",
    source="GPT-J-6B [31]",
    n_layers=28,
    d_model=4096,
    n_heads=16, n_kv_heads=16, head_dim=256,
    d_ff=16384,
    vocab_size=50400,
    activation="gelu",
    tie_embeddings=False,
    lora_rank=8,
    n_modalities=3,
    modality_dim=256,
    n_soft_tokens=8,
)

CONFIGS = {"mlecs-slm-720m": SLM, "mlecs-llm-6b": LLM}
