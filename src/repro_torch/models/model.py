"""The modality frontends' stub.

Counterpart of ``repro.models.model.modality_inputs``: the JAX package
stubs the vision encoder and the audio conv/mel frontend (the one stub it
allows) with zero embeddings, and so does the port.  ``input_specs`` and
``cache_specs`` build JAX ``ShapeDtypeStruct``s for the multi-pod
dry-run and have no counterpart here.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import DeviceLike, resolve_device, torch_dtype


def modality_inputs(cfg: ModelConfig, batch: int,
                    device: DeviceLike = None) -> dict:
    """Stubbed modality-frontend outputs: VLM ``image_embeds`` (projected
    vision-encoder patch embeddings), audio ``audio_frames`` (post-conv
    mel frame embeddings), zeros of ``(batch, num_image_tokens |
    num_audio_frames, d_model)`` in ``cfg.dtype`` on ``device``; {} for
    text-only archs."""
    spec = {"vlm": ("image_embeds", cfg.num_image_tokens),
            "audio": ("audio_frames", cfg.num_audio_frames)}.get(
        cfg.arch_type)
    if spec is None:
        return {}
    name, length = spec
    return {name: torch.zeros((batch, length, cfg.d_model),
                              dtype=torch_dtype(cfg.dtype),
                              device=resolve_device(device))}
