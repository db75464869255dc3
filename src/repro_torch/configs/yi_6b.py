"""yi-6b [dense] — 32L d_model=4096 32H (GQA kv=4) d_ff=11008 vocab=64000,
llama-architecture GQA. [arXiv:2403.04652]
"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(
    ModelConfig(
        name="yi-6b",
        arch_type="dense",
        source="arXiv:2403.04652 (Yi: Open Foundation Models)",
        num_layers=32,
        d_model=4096,
        num_heads=32,
        num_kv_heads=4,
        d_ff=11008,
        vocab_size=64000,
        rope_theta=5_000_000.0,
        max_gen_length=65_536,
    ),
    tiny=ModelConfig(
        name="yi-6b-tiny",
        arch_type="dense",
        num_layers=2,
        d_model=128,
        num_heads=4,
        num_kv_heads=1,
        d_ff=256,
        vocab_size=512,
        max_gen_length=256,
    ),
)
