"""moonshot-v1-16b-a3b — 48L d_model=2048 16H (GQA kv=16) d_ff=1408
(per-expert) vocab=163840, MoE 64 experts top-6 (Moonlight / Kimi
Moonlight-16B-A3B family; the paper's own Moonlight workload).
[hf:moonshotai/Moonlight-16B-A3B]
"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(
    ModelConfig(
        name="moonshot-v1-16b-a3b",
        arch_type="moe",
        source="hf:moonshotai/Moonlight-16B-A3B",
        num_layers=48,
        d_model=2048,
        num_heads=16,
        num_kv_heads=16,
        d_ff=11264,              # dense-layer FFN (layer 0, deepseek-v3-style)
        vocab_size=163840,
        rope_theta=50_000.0,
        num_experts=64,
        num_shared_experts=2,
        moe_top_k=6,
        moe_d_ff=1408,
        first_dense_layers=1,
        max_gen_length=65_536,
    ),
    tiny=ModelConfig(
        name="moonshot-v1-16b-a3b-tiny",
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
