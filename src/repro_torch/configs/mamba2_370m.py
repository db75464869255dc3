"""mamba2-370m [ssm] — 48L d_model=1024 (attention-free) vocab=50280,
ssm_state=128, SSD (state-space duality). [arXiv:2405.21060]
"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(
    ModelConfig(
        name="mamba2-370m",
        arch_type="ssm",
        source="arXiv:2405.21060 (Transformers are SSMs / Mamba-2)",
        num_layers=48,
        d_model=1024,
        num_heads=0,
        num_kv_heads=0,
        d_ff=0,
        vocab_size=50280,
        ssm_state=128,
        ssm_conv=4,
        ssm_expand=2,
        ssm_head_dim=64,
        ssm_ngroups=1,
        ssm_chunk=256,
        tie_embeddings=True,
        max_gen_length=65_536,
    ),
    tiny=ModelConfig(
        name="mamba2-370m-tiny",
        arch_type="ssm",
        num_layers=2,
        d_model=128,
        vocab_size=512,
        ssm_state=16,
        ssm_conv=4,
        ssm_expand=2,
        ssm_head_dim=32,
        ssm_ngroups=1,
        ssm_chunk=32,
        tie_embeddings=True,
        max_gen_length=256,
    ),
)
