"""DeepSeek-V2 236B [arXiv:2405.04434]: MLA (kv_lora=512) + fine-grained MoE
(160 routed top-6 + 2 shared experts); first layer dense."""

from repro_torch.configs.base import ArchConfig, MLAConfig, MoEConfig, register

CONFIG = register(
    ArchConfig(
        name="deepseek-v2-236b",
        family="moe",
        num_layers=60,
        d_model=5120,
        num_heads=128,
        num_kv_heads=128,  # MLA: all heads share the compressed latent
        d_ff=12288,  # the dense first layer's FFN width
        vocab_size=102400,
        activation="swiglu",
        moe=MoEConfig(
            num_experts=160, top_k=6, d_ff_expert=1536, num_shared_experts=2, d_ff_shared=3072
        ),
        mla=MLAConfig(
            kv_lora_rank=512,
            q_lora_rank=1536,
            rope_head_dim=64,
            nope_head_dim=128,
            v_head_dim=128,
        ),
        source="arXiv:2405.04434",
    )
)
