"""granite-3-8b [dense] — 40L d_model=4096 32H (GQA kv=8) d_ff=12800
vocab=49155. [hf:ibm-granite/granite-3.0-2b-base family, 8b-base sizing]
"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(
    ModelConfig(
        name="granite-3-8b",
        arch_type="dense",
        source="hf:ibm-granite/granite-3.0-8b-base (family card: granite-3.0-2b-base)",
        num_layers=40,
        d_model=4096,
        num_heads=32,
        num_kv_heads=8,
        d_ff=12800,
        vocab_size=49155,
        rope_theta=10_000.0,
        tie_embeddings=True,
        max_gen_length=65_536,
    ),
    tiny=ModelConfig(
        name="granite-3-8b-tiny",
        arch_type="dense",
        num_layers=2,
        d_model=128,
        num_heads=4,
        num_kv_heads=2,
        d_ff=256,
        vocab_size=512,
        tie_embeddings=True,
        max_gen_length=256,
    ),
)
