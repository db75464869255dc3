"""deepseek-moe-16b [moe] — 28L d_model=2048 16H d_ff=1408(per-expert)
vocab=102400, fine-grained MoE: 2 shared + 64 routed top-6, first layer
dense. [arXiv:2401.06066]
"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(
    ModelConfig(
        name="deepseek-moe-16b",
        arch_type="moe",
        source="arXiv:2401.06066 (DeepSeekMoE)",
        num_layers=28,
        d_model=2048,
        num_heads=16,
        num_kv_heads=16,
        d_ff=10944,              # dense-layer FFN (layer 0)
        vocab_size=102400,
        rope_theta=10_000.0,
        num_experts=64,
        num_shared_experts=2,
        moe_top_k=6,
        moe_d_ff=1408,
        first_dense_layers=1,
        max_gen_length=32_768,
    ),
    tiny=ModelConfig(
        name="deepseek-moe-16b-tiny",
        arch_type="moe",
        num_layers=2,
        d_model=128,
        num_heads=4,
        num_kv_heads=4,
        d_ff=256,
        vocab_size=512,
        num_experts=4,
        num_shared_experts=1,
        moe_top_k=2,
        moe_d_ff=64,
        first_dense_layers=1,
        max_gen_length=256,
    ),
)
