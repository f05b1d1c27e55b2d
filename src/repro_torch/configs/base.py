"""ArchConfig: one declarative description of each model-zoo architecture.

A copy of ``repro.configs.base`` (pure data; the port imports nothing of the
reference package). Every name resolves as it does there, so a config built
in one package compares equal field by field with the other's. The port's
model zoo builds every family (see
:func:`repro_torch.models.model_zoo.build_model`).
"""

from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Dict, Optional


@dataclass(frozen=True)
class MoEConfig:
    num_experts: int
    top_k: int
    d_ff_expert: int
    num_shared_experts: int = 0
    d_ff_shared: int = 0  # total shared-expert ffn width
    capacity_factor: float = 1.25  # train/prefill dispatch capacity


@dataclass(frozen=True)
class SSMConfig:
    d_state: int
    head_dim: int = 64
    expand: int = 2
    conv_width: int = 4
    chunk: int = 256  # SSD chunk length


@dataclass(frozen=True)
class MLAConfig:
    kv_lora_rank: int  # compressed kv latent (deepseek: 512)
    q_lora_rank: int = 0  # 0 → full-rank q
    rope_head_dim: int = 64  # decoupled rope dims per head
    nope_head_dim: int = 128
    v_head_dim: int = 128


@dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str  # dense | moe | ssm | hybrid | vlm | audio
    num_layers: int
    d_model: int
    num_heads: int  # query heads (0 for attn-free)
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: Optional[int] = None  # default d_model // num_heads
    activation: str = "swiglu"  # swiglu | geglu | gelu
    qkv_bias: bool = False
    rope_theta: float = 10000.0
    rope_style: str = "rope"  # rope | mrope | none
    norm_eps: float = 1e-6
    tie_embeddings: bool = False
    attn_window: Optional[int] = None  # sliding-window size (None = full)
    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    mla: Optional[MLAConfig] = None
    # hybrid (zamba2-style): one SHARED attention block applied every
    # ``hybrid_attn_every`` ssm blocks, reusing the same weights
    hybrid_attn_every: int = 0
    # encoder-decoder (seamless-style)
    encoder_layers: int = 0  # >0 → enc-dec; num_layers = decoder
    # modality frontend stub: prefix of precomputed embeddings
    prefix_tokens: int = 0  # patches/frames in train/prefill
    source: str = ""  # citation
    shard_ssm_heads: bool = False
    shard_attn_heads: bool = False
    # --- numeric policy ----------------------------------------------------
    param_dtype: str = "float32"
    activation_dtype: str = "bfloat16"
    optimizer: str = "adam"  # adam | sgdm
    remat: bool = True

    @property
    def resolved_head_dim(self) -> int:
        if self.head_dim is not None:
            return self.head_dim
        return self.d_model // max(self.num_heads, 1)

    @property
    def is_encdec(self) -> bool:
        return self.encoder_layers > 0

    @property
    def attention_free(self) -> bool:
        return self.family == "ssm"

    @property
    def subquadratic(self) -> bool:
        """Can this config decode at 500k context?"""
        return (self.family in ("ssm", "hybrid")) or (self.attn_window is not None)

    def reduced(self) -> "ArchConfig":
        """Smoke-test variant: 2 layers, d_model <= 256, <= 4 experts; same
        family and code paths, CPU-sized. Note that it keeps kv heads = heads
        whenever the full config has more than 4 kv heads (phi4's 8 become 4
        = heads): a test that needs grouped heads sets ``num_kv_heads``."""
        d_model = min(self.d_model, 256)
        heads = min(self.num_heads, 4) if self.num_heads else 0
        kv = min(self.num_kv_heads, heads) if heads else 0
        if heads and self.num_kv_heads == self.num_heads:
            kv = heads
        changes: Dict = dict(
            num_layers=2,
            d_model=d_model,
            num_heads=heads,
            num_kv_heads=max(kv, 1) if heads else 0,
            d_ff=min(self.d_ff, 512) if self.d_ff else 0,
            vocab_size=min(self.vocab_size, 512),
            head_dim=64 if self.head_dim else None,
        )
        if self.moe:
            changes["moe"] = replace(
                self.moe,
                num_experts=4,
                top_k=min(self.moe.top_k, 2),
                d_ff_expert=min(self.moe.d_ff_expert, 128),
                d_ff_shared=min(self.moe.d_ff_shared, 128),
            )
        if self.ssm:
            changes["ssm"] = replace(self.ssm, d_state=min(self.ssm.d_state, 16), chunk=32)
        if self.mla:
            changes["mla"] = replace(
                self.mla, kv_lora_rank=64, rope_head_dim=16, nope_head_dim=32, v_head_dim=32
            )
        if self.encoder_layers:
            changes["encoder_layers"] = 2
        if self.hybrid_attn_every:
            changes["hybrid_attn_every"] = 2
        if self.prefix_tokens:
            changes["prefix_tokens"] = 8
        if self.attn_window:
            changes["attn_window"] = min(self.attn_window, 64)
        return replace(self, **changes)


# ------------------------------------------------------------------ shapes --
@dataclass(frozen=True)
class InputShape:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


INPUT_SHAPES: Dict[str, InputShape] = {
    "train_4k": InputShape("train_4k", 4_096, 256, "train"),
    "prefill_32k": InputShape("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": InputShape("decode_32k", 32_768, 128, "decode"),
    "long_500k": InputShape("long_500k", 524_288, 1, "decode"),
}


# ---------------------------------------------------------------- registry --
_REGISTRY: Dict[str, ArchConfig] = {}


def register(cfg: ArchConfig) -> ArchConfig:
    _REGISTRY[cfg.name] = cfg
    return cfg


def get_config(name: str) -> ArchConfig:
    from repro_torch import configs  # every config module registers on import

    configs.load_all()
    if name not in _REGISTRY:
        raise KeyError(f"unknown arch {name!r}; have {sorted(_REGISTRY)}")
    return _REGISTRY[name]


def all_configs() -> Dict[str, ArchConfig]:
    from repro_torch import configs

    configs.load_all()
    return dict(_REGISTRY)
