"""Unified model configuration, copied from ``repro.configs.base``.

The fields are the reference's, one for one, so a reference config converts
with ``ModelConfig(**dataclasses.asdict(ref_cfg))``.  The only change is the
dtype accessor: :attr:`ModelConfig.torch_dtype` in place of ``param_dtype``.

The registry (``ARCH_IDS``, :func:`get_config`) names the same configs as
the reference's, and ``INPUT_SHAPES`` / :class:`InputShape` the same
assigned input shapes, which the dry run (``launch/dryrun.py``) costs.
"""
from __future__ import annotations

import dataclasses
import importlib
from typing import Tuple

import torch

FAMILIES = ("dense", "moe", "ssm", "hybrid", "encdec", "vlm")

# the dtypes the port's kernels take
_TORCH_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    # identity -----------------------------------------------------------
    name: str = "model"
    family: str = "dense"            # one of FAMILIES
    source: str = ""                 # citation: paper / model card

    # transformer trunk ---------------------------------------------------
    n_layers: int = 2
    d_model: int = 256
    n_heads: int = 4
    n_kv_heads: int = 4
    head_dim: int = 64
    d_ff: int = 1024
    vocab_size: int = 1024
    activation: str = "silu"         # silu | geglu | gelu
    norm_eps: float = 1e-6
    tie_embeddings: bool = True
    rope_theta: float = 10000.0
    qk_norm: bool = False

    # attention pattern ----------------------------------------------------
    sliding_window: int = 0          # 0 = full attention
    global_every: int = 0            # >0: every Nth layer uses full attention
    attn_impl: str = "masked"        # masked | banded (the same function)

    # mixture of experts ----------------------------------------------------
    n_experts: int = 0
    top_k: int = 0
    d_ff_expert: int = 0
    capacity_factor: float = 1.25
    router_aux_weight: float = 0.01
    moe_impl: str = "scatter"

    # state-space (mamba2 / SSD) --------------------------------------------
    ssm_state: int = 0
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    ssm_conv: int = 4
    ssm_chunk: int = 256
    ssm_groups: int = 1

    # encoder-decoder --------------------------------------------------------
    n_enc_layers: int = 0

    # modality frontend stub (audio / vision) --------------------------------
    frontend: str = ""
    frontend_tokens: int = 0
    frontend_dim: int = 0

    # ML-ECS / LoRA ------------------------------------------------------------
    lora_rank: int = 8
    lora_alpha: float = 16.0
    lora_targets: Tuple[str, ...] = ("wq", "wk", "wv", "wo")
    n_modalities: int = 0            # 0 = text-only, connector disabled
    modality_dim: int = 256          # raw per-modality feature dim
    n_soft_tokens: int = 8           # soft-prompt tokens generated from fusion
    connector_dim: int = 0           # shared CCL latent space (0 -> d_model)

    # numerics / training ------------------------------------------------------
    dtype: str = "bfloat16"
    remat: bool = True
    loss_impl: str = "full"
    loss_chunk: int = 512

    def __post_init__(self):
        if self.family not in FAMILIES:
            raise ValueError(f"unknown family {self.family!r}")
        if self.dtype not in _TORCH_DTYPES:
            raise ValueError(f"unsupported dtype {self.dtype!r}")
        if (self.family in ("dense", "moe", "vlm", "encdec", "hybrid")
                and self.n_heads % max(self.n_kv_heads, 1)):
            raise ValueError(f"n_heads {self.n_heads} is not a multiple of "
                             f"n_kv_heads {self.n_kv_heads}")

    # derived quantities -------------------------------------------------------
    @property
    def torch_dtype(self) -> torch.dtype:
        """The parameter dtype as a torch dtype."""
        return _TORCH_DTYPES[self.dtype]

    @property
    def d_inner(self) -> int:
        """SSM inner width."""
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim

    @property
    def is_moe(self) -> bool:
        return self.n_experts > 0

    def window_for_layer(self, layer: int) -> int:
        """Per-layer sliding window (0 = full).  gemma3-style local:global."""
        if self.sliding_window == 0:
            return 0
        if self.global_every > 0 and (layer + 1) % self.global_every == 0:
            return 0
        return self.sliding_window

    def n_params(self) -> int:
        """Analytic parameter count (same formula as the reference)."""
        d, L = self.d_model, self.n_layers
        emb = self.vocab_size * d
        if not self.tie_embeddings:
            emb *= 2
        per_layer = 0
        if self.family in ("dense", "moe", "vlm", "encdec", "hybrid"):
            qkv = d * (self.n_heads + 2 * self.n_kv_heads) * self.head_dim
            o = self.n_heads * self.head_dim * d
            per_layer += qkv + o + 2 * d
        if self.family in ("dense", "vlm", "encdec", "hybrid"):
            mult = 3 if self.activation in ("silu", "geglu") else 2
            per_layer += mult * d * self.d_ff
        if self.is_moe:
            mult = 3 if self.activation in ("silu", "geglu") else 2
            per_layer += self.n_experts * mult * d * self.d_ff_expert
            per_layer += d * self.n_experts
        if self.family in ("ssm", "hybrid"):
            di, N, H = self.d_inner, self.ssm_state, self.ssm_heads
            G = self.ssm_groups
            in_proj = d * (2 * di + 2 * G * N + H)
            out_proj = di * d
            conv = (di + 2 * G * N) * self.ssm_conv
            per_layer += in_proj + out_proj + conv + 2 * H + di
        total = emb + L * per_layer + d
        if self.n_enc_layers:
            enc_layer = (d * (self.n_heads + 2 * self.n_kv_heads) * self.head_dim
                         + self.n_heads * self.head_dim * d
                         + 2 * d * self.d_ff + 2 * d)
            total += self.n_enc_layers * enc_layer
            total += L * (d * (self.n_heads + 2 * self.n_kv_heads) * self.head_dim
                          + self.n_heads * self.head_dim * d)
        return int(total)

    def n_active_params(self) -> int:
        """Active params per token (MoE: only top_k experts count)."""
        if not self.is_moe:
            return self.n_params()
        mult = 3 if self.activation in ("silu", "geglu") else 2
        inactive = (self.n_experts - self.top_k) * mult * self.d_model \
            * self.d_ff_expert * self.n_layers
        return int(self.n_params() - inactive)

    def n_lora_params(self) -> int:
        """Communicated parameter volume per round: the adapters' (the
        paper's share-of-parameters claim)."""
        r = self.lora_rank
        per_target = {
            "wq": self.d_model * r + r * self.n_heads * self.head_dim,
            "wk": self.d_model * r + r * self.n_kv_heads * self.head_dim,
            "wv": self.d_model * r + r * self.n_kv_heads * self.head_dim,
            "wo": self.n_heads * self.head_dim * r + r * self.d_model,
            "in_proj": self.d_model * r + r * (
                2 * self.d_inner + 2 * self.ssm_groups * self.ssm_state
                + self.ssm_heads),
            "out_proj": self.d_inner * r + r * self.d_model,
        }
        n_attn_layers = self.n_layers + self.n_enc_layers
        total = 0
        for t in self.lora_targets:
            if t in ("wq", "wk", "wv", "wo"):
                if self.family == "ssm":
                    continue
                total += n_attn_layers * per_target[t]
            elif t in ("in_proj", "out_proj") \
                    and self.family in ("ssm", "hybrid"):
                total += self.n_layers * per_target[t]
        return int(total)

    def reduced(self) -> "ModelConfig":
        """Small variant for CPU smoke tests (same cuts as the reference)."""
        return dataclasses.replace(
            self,
            name=self.name + "-smoke",
            n_layers=2,
            n_enc_layers=min(self.n_enc_layers, 2),
            d_model=min(self.d_model, 128),
            n_heads=min(self.n_heads, 4),
            n_kv_heads=min(self.n_kv_heads, 2),
            head_dim=min(self.head_dim, 32),
            d_ff=min(self.d_ff, 256),
            d_ff_expert=min(self.d_ff_expert, 128) if self.is_moe else 0,
            n_experts=min(self.n_experts, 4) if self.is_moe else 0,
            top_k=min(self.top_k, 2) if self.is_moe else 0,
            vocab_size=min(self.vocab_size, 512),
            ssm_state=min(self.ssm_state, 16) if self.ssm_state else 0,
            ssm_head_dim=min(self.ssm_head_dim, 16) if self.ssm_state else 64,
            ssm_chunk=32,
            sliding_window=min(self.sliding_window, 32) if self.sliding_window else 0,
            frontend_tokens=min(self.frontend_tokens, 16) if self.frontend else 0,
            frontend_dim=min(self.frontend_dim, 64) if self.frontend else 0,
            lora_rank=4,
            n_modalities=self.n_modalities,
            modality_dim=min(self.modality_dim, 32),
            n_soft_tokens=4,
            remat=False,
        )


# ---------------------------------------------------------------------------
# registry

ARCH_IDS = (
    "mamba2-2.7b",
    "gemma-2b",
    "gemma3-1b",
    "qwen3-moe-235b-a22b",
    "granite-20b",
    "qwen3-1.7b",
    "whisper-medium",
    "internvl2-1b",
    "phi3.5-moe-42b-a6.6b",
    "hymba-1.5b",
    # the paper's own backbones
    "mlecs-slm-720m",
    "mlecs-llm-6b",
)

_MODULE_FOR = {
    "mamba2-2.7b": "mamba2_2p7b",
    "gemma-2b": "gemma_2b",
    "gemma3-1b": "gemma3_1b",
    "qwen3-moe-235b-a22b": "qwen3_moe_235b_a22b",
    "granite-20b": "granite_20b",
    "qwen3-1.7b": "qwen3_1p7b",
    "whisper-medium": "whisper_medium",
    "internvl2-1b": "internvl2_1b",
    "phi3.5-moe-42b-a6.6b": "phi3p5_moe_42b_a6p6b",
    "hymba-1.5b": "hymba_1p5b",
    "mlecs-slm-720m": "mlecs_paper",
    "mlecs-llm-6b": "mlecs_paper",
}


def get_config(arch: str) -> ModelConfig:
    """The config of ``arch`` (one of ``ARCH_IDS``); raises ``KeyError``
    on an unknown id."""
    if arch not in _MODULE_FOR:
        raise KeyError(f"unknown arch {arch!r}; known: {sorted(_MODULE_FOR)}")
    mod = importlib.import_module(f"repro_torch.configs.{_MODULE_FOR[arch]}")
    return mod.CONFIGS[arch] if hasattr(mod, "CONFIGS") else mod.CONFIG


# ---------------------------------------------------------------------------
# input shapes (assigned)

@dataclasses.dataclass(frozen=True)
class InputShape:
    name: str
    seq_len: int
    global_batch: int
    kind: str          # "train" | "prefill" | "decode"


INPUT_SHAPES = {
    "train_4k": InputShape("train_4k", 4096, 256, "train"),
    "prefill_32k": InputShape("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": InputShape("decode_32k", 32768, 128, "decode"),
    "long_500k": InputShape("long_500k", 524288, 1, "decode"),
}
