"""mixtral-8x7b [moe] — 32L d_model=4096 32H (GQA kv=8) d_ff=14336
vocab=32000, MoE 8 experts top-2, sliding-window attention (4096).
[arXiv:2401.04088]
"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(
    ModelConfig(
        name="mixtral-8x7b",
        arch_type="moe",
        source="arXiv:2401.04088 (Mixtral of Experts)",
        num_layers=32,
        d_model=4096,
        num_heads=32,
        num_kv_heads=8,
        d_ff=14336,
        vocab_size=32000,
        rope_theta=1_000_000.0,
        sliding_window=4096,
        num_experts=8,
        num_shared_experts=0,
        moe_top_k=2,
        moe_d_ff=14336,
        max_gen_length=32_768,
    ),
    tiny=ModelConfig(
        name="mixtral-8x7b-tiny",
        arch_type="moe",
        num_layers=2,
        d_model=128,
        num_heads=4,
        num_kv_heads=2,
        d_ff=256,
        vocab_size=512,
        sliding_window=64,
        num_experts=4,
        moe_top_k=2,
        moe_d_ff=256,
        max_gen_length=256,
    ),
)
