"""Model / shape / run configuration for the PyTorch port of Seer.

A copy of ``repro.configs.base`` (the port imports nothing of the JAX
package); the parity tests assert the two stay field-for-field equal.

Every assigned architecture gets one ``<arch>.py`` module that builds a
:class:`ModelConfig` with the exact published numbers (source cited in the
module docstring).  ``tiny_variant`` derives the reduced smoke-test config
(<=2 layers, d_model<=512, <=4 experts) from the same family so the smoke
tests exercise the same code path as the dry-run.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field, replace
from typing import Optional


@dataclass(frozen=True)
class ModelConfig:
    # identity
    name: str
    arch_type: str                 # dense | moe | ssm | hybrid | vlm | audio
    source: str = ""               # citation for the numbers

    # transformer trunk
    num_layers: int = 0
    d_model: int = 0
    num_heads: int = 0
    num_kv_heads: int = 0
    head_dim: int = 0              # 0 -> d_model // num_heads
    d_ff: int = 0
    vocab_size: int = 0
    rope_theta: float = 500_000.0
    rms_eps: float = 1e-5
    tie_embeddings: bool = False

    # attention variants
    sliding_window: int = 0        # 0 = full causal attention
    attn_logit_softcap: float = 0.0

    # MoE
    num_experts: int = 0
    num_shared_experts: int = 0
    moe_top_k: int = 0
    moe_d_ff: int = 0              # per-expert hidden dim (fine-grained MoE)
    moe_every: int = 1             # MoE layer every N layers (1 = all)
    first_dense_layers: int = 0    # deepseek-moe: layer 0 is dense
    router_aux_coef: float = 0.01
    capacity_factor: float = 1.25

    # SSM (Mamba2 / SSD)
    ssm_state: int = 0
    ssm_conv: int = 4
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    ssm_ngroups: int = 1
    ssm_chunk: int = 128

    # hybrid (Zamba2-style): a shared (weight-tied) attention block applied
    # every `hybrid_attn_every` SSM blocks.
    hybrid_attn_every: int = 0

    # VLM (Llama-3.2-Vision-style): cross-attention block after every
    # `cross_attn_every` self-attention layers; vision tower is stubbed.
    cross_attn_every: int = 0
    num_image_tokens: int = 0

    # encoder-decoder (Whisper-style): conv/mel frontend stubbed, encoder is
    # bidirectional, decoder has self+cross attention.
    encoder_layers: int = 0
    num_audio_frames: int = 0

    # numerics
    dtype: str = "bfloat16"
    param_dtype: str = "float32"

    # engine defaults
    max_gen_length: int = 65_536

    def __post_init__(self):
        if self.head_dim == 0 and self.num_heads:
            object.__setattr__(self, "head_dim", self.d_model // self.num_heads)

    # ---- derived quantities -------------------------------------------------
    @property
    def is_attention_free(self) -> bool:
        return self.arch_type == "ssm"

    @property
    def is_encoder_decoder(self) -> bool:
        return self.encoder_layers > 0

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_nheads(self) -> int:
        return self.d_inner // self.ssm_head_dim if self.ssm_head_dim else 0

    def num_params(self) -> int:
        """Analytic parameter count (matches init; used for 6ND roofline)."""
        d, f, v = self.d_model, self.d_ff, self.vocab_size
        hd = self.head_dim
        attn = d * (self.num_heads * hd) + 2 * d * (self.num_kv_heads * hd) \
            + (self.num_heads * hd) * d
        mlp = 3 * d * f if f else 0
        n = 0
        if self.arch_type == "ssm":
            n += self.num_layers * self._ssm_block_params()
        elif self.arch_type == "hybrid":
            n += self.num_layers * self._ssm_block_params()
            # one shared attention+mlp block (weight tied across uses)
            n += attn + 3 * d * self.d_ff + 2 * d
        else:
            per_layer = attn + 2 * d  # norms
            if self.num_experts:
                e_ff = self.moe_d_ff or f
                n_moe = (self.num_layers - self.first_dense_layers + self.moe_every - 1) // self.moe_every
                n_dense = self.num_layers - n_moe
                per = attn + 2 * d
                n += self.num_layers * per
                n += n_moe * (self.num_experts * 3 * d * e_ff
                              + self.num_shared_experts * 3 * d * e_ff
                              + d * self.num_experts)
                n += n_dense * 3 * d * f
            else:
                n += self.num_layers * (per_layer + mlp)
        if self.cross_attn_every:
            n_cross = self.num_layers // self.cross_attn_every
            n += n_cross * (attn + 2 * d)
        if self.is_encoder_decoder:
            # encoder self-attn + mlp, decoder cross-attn already above? no:
            n += self.encoder_layers * (attn + 3 * d * f + 2 * d)
            n += self.num_layers * (attn + 2 * d)  # decoder cross-attn
        n += v * d  # embedding
        if not self.tie_embeddings:
            n += v * d
        n += d  # final norm
        return n

    def _ssm_block_params(self) -> int:
        d, di, s = self.d_model, self.d_inner, self.ssm_state
        nh = self.ssm_nheads
        in_proj = d * (2 * di + 2 * self.ssm_ngroups * s + nh)
        conv = (di + 2 * self.ssm_ngroups * s) * self.ssm_conv
        out_proj = di * d
        return in_proj + conv + out_proj + 2 * nh + di + d  # A,D,norm,dt_bias

    def active_params(self) -> int:
        """Active (per-token) params for MoE rooflines (6*N_active*D)."""
        if not self.num_experts:
            return self.num_params()
        e_ff = self.moe_d_ff or self.d_ff
        dead = (self.num_experts - self.moe_top_k) * 3 * self.d_model * e_ff
        n_moe = (self.num_layers - self.first_dense_layers + self.moe_every - 1) // self.moe_every
        return self.num_params() - n_moe * dead


@dataclass(frozen=True)
class InputShape:
    name: str
    seq_len: int
    global_batch: int
    mode: str                      # "train" | "prefill" | "decode"


INPUT_SHAPES = {
    "train_4k":    InputShape("train_4k",    4_096,   256, "train"),
    "prefill_32k": InputShape("prefill_32k", 32_768,   32, "prefill"),
    "decode_32k":  InputShape("decode_32k",  32_768,  128, "decode"),
    "long_500k":   InputShape("long_500k",  524_288,    1, "decode"),
}

# Window used when an attention arch runs long_500k via the sliding-window
# variant (beyond-paper feature; see DESIGN.md §4).
LONG_CONTEXT_WINDOW = 16_384


_REGISTRY: dict[str, "ModelConfig"] = {}
_TINY: dict[str, "ModelConfig"] = {}


def register(cfg: ModelConfig, tiny: ModelConfig) -> ModelConfig:
    _REGISTRY[cfg.name] = cfg
    _TINY[cfg.name] = tiny
    return cfg


def get_config(name: str) -> ModelConfig:
    _ensure_loaded()
    if name not in _REGISTRY:
        raise KeyError(f"unknown arch {name!r}; have {sorted(_REGISTRY)}")
    return _REGISTRY[name]


def get_tiny_config(name: str) -> ModelConfig:
    _ensure_loaded()
    return _TINY[name]


def list_archs() -> list[str]:
    _ensure_loaded()
    return sorted(_REGISTRY)


def _ensure_loaded():
    # import the per-arch modules exactly once
    if _REGISTRY:
        return
    from repro_torch.configs import (  # noqa: F401
        deepseek_moe_16b, granite_3_8b, llama_3_2_vision_11b, mamba2_370m,
        mixtral_8x7b, moonshot_v1_16b_a3b, phi4_mini_3_8b, whisper_tiny,
        yi_6b, zamba2_1_2b,
    )


def for_shape(cfg: ModelConfig, shape: InputShape) -> ModelConfig:
    """Adapt a config to an input shape (e.g. long-context sliding window)."""
    if shape.name == "long_500k" and cfg.arch_type not in ("ssm",):
        win = cfg.sliding_window or LONG_CONTEXT_WINDOW
        win = min(win, LONG_CONTEXT_WINDOW)
        return replace(cfg, sliding_window=win)
    return cfg
