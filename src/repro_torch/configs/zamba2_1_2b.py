"""zamba2-1.2b [hybrid] — 38L d_model=2048, Mamba2 blocks + one shared
(weight-tied) attention block applied periodically; 32H kv=32 d_ff=8192
vocab=32000, ssm_state=64. [arXiv:2411.15242]
"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(
    ModelConfig(
        name="zamba2-1.2b",
        arch_type="hybrid",
        source="arXiv:2411.15242 (Zamba2 suite)",
        num_layers=38,            # mamba2 blocks
        d_model=2048,
        num_heads=32,
        num_kv_heads=32,
        head_dim=64,
        d_ff=8192,                # shared block MLP
        vocab_size=32000,
        rope_theta=10_000.0,
        ssm_state=64,
        ssm_conv=4,
        ssm_expand=2,
        ssm_head_dim=64,
        ssm_ngroups=1,
        ssm_chunk=256,
        hybrid_attn_every=6,      # shared attn block after every 6 mamba blocks
        sliding_window=4096,      # shared attn uses a window for long-context decode
        tie_embeddings=True,
        max_gen_length=65_536,
    ),
    tiny=ModelConfig(
        name="zamba2-1.2b-tiny",
        arch_type="hybrid",
        num_layers=2,
        d_model=128,
        num_heads=4,
        num_kv_heads=4,
        head_dim=32,
        d_ff=256,
        vocab_size=512,
        ssm_state=16,
        ssm_head_dim=32,
        ssm_chunk=32,
        hybrid_attn_every=1,
        sliding_window=64,
        tie_embeddings=True,
        max_gen_length=256,
    ),
)
