"""whisper-tiny [audio] — 4L d_model=384 6H d_ff=1536 vocab=51865, enc-dec,
conv/mel frontend stubbed (``models.model.modality_inputs`` gives frame
embeddings).
[arXiv:2212.04356]
"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(
    ModelConfig(
        name="whisper-tiny",
        arch_type="audio",
        source="arXiv:2212.04356 (Robust Speech Recognition via Large-Scale Weak Supervision)",
        num_layers=4,            # decoder layers
        encoder_layers=4,
        d_model=384,
        num_heads=6,
        num_kv_heads=6,
        d_ff=1536,
        vocab_size=51865,
        rope_theta=10_000.0,     # (whisper uses learned pos-emb; we use RoPE — noted in DESIGN)
        num_audio_frames=1500,
        tie_embeddings=True,
        max_gen_length=8_192,
    ),
    tiny=ModelConfig(
        name="whisper-tiny-tiny",
        arch_type="audio",
        num_layers=2,
        encoder_layers=2,
        d_model=96,
        num_heads=3,
        num_kv_heads=3,
        d_ff=192,
        vocab_size=512,
        num_audio_frames=24,
        tie_embeddings=True,
        max_gen_length=128,
    ),
)
