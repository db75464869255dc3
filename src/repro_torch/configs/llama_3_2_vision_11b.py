"""llama-3.2-vision-11b [vlm] — 40L d_model=4096 32H (GQA kv=8) d_ff=14336
vocab=128256, cross-attention image layers every 5 decoder layers.
[hf:meta-llama/Llama-3.2-11B-Vision]
"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(
    ModelConfig(
        name="llama-3.2-vision-11b",
        arch_type="vlm",
        source="hf:meta-llama/Llama-3.2-11B-Vision",
        num_layers=40,
        d_model=4096,
        num_heads=32,
        num_kv_heads=8,
        d_ff=14336,
        vocab_size=128256,
        rope_theta=500_000.0,
        cross_attn_every=5,
        num_image_tokens=1601,   # 1 global + 4 tiles x 400 patches (stubbed)
        max_gen_length=40_960,
    ),
    tiny=ModelConfig(
        name="llama-3.2-vision-11b-tiny",
        arch_type="vlm",
        num_layers=2,
        d_model=128,
        num_heads=4,
        num_kv_heads=2,
        d_ff=256,
        vocab_size=512,
        cross_attn_every=2,
        num_image_tokens=16,
        max_gen_length=256,
    ),
)
