"""whisper-medium: encoder-decoder, the conv/mel frontend a stub
[arXiv:2212.04356] (copied from ``repro.configs.whisper_medium``).  Shapes match the published model; weights are
random."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="whisper-medium",
    family="encdec",
    source="arXiv:2212.04356 (Whisper)",
    n_layers=24,            # decoder
    n_enc_layers=24,        # encoder
    d_model=1024,
    n_heads=16, n_kv_heads=16, head_dim=64,   # MHA
    d_ff=4096,
    vocab_size=51865,
    activation="gelu",
    tie_embeddings=True,
    frontend="audio",
    frontend_tokens=1536,    # whisper's 1500 frames padded to 1536 so the
                             # cross-attention KV shards 16-way (stub anyway)
    frontend_dim=1024,
    lora_targets=("wq", "wv"),
    n_modalities=3,
)
