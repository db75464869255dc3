"""phi4-mini-3.8b [dense] — 32L d_model=3072 24H (GQA kv=8) d_ff=8192
vocab=200064, RoPE + SwiGLU + GQA. [arXiv:2412.08905]
"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(
    ModelConfig(
        name="phi4-mini-3.8b",
        arch_type="dense",
        source="arXiv:2412.08905 (Phi-4 technical report; mini sizing per model card)",
        num_layers=32,
        d_model=3072,
        num_heads=24,
        num_kv_heads=8,
        d_ff=8192,
        vocab_size=200064,
        rope_theta=10_000.0,
        tie_embeddings=True,
        max_gen_length=65_536,
    ),
    tiny=ModelConfig(
        name="phi4-mini-3.8b-tiny",
        arch_type="dense",
        num_layers=2,
        d_model=96,
        num_heads=3,
        num_kv_heads=1,
        d_ff=256,
        vocab_size=512,
        tie_embeddings=True,
        max_gen_length=256,
    ),
)
