"""Device selection for the port's entry points.

Every entry point (``init_params``, ``init_cache``, ``Instance``,
``SeerRollout``, the bridge) puts its tensors on ``cuda`` unless the
caller passes ``device="cpu"``.  Without a card and without that
request they raise: the port never carries on quietly on the CPU.
"""
from __future__ import annotations

from typing import Optional, Union

import torch

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = None) -> torch.device:
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch runs on CUDA unless asked otherwise, and no CUDA "
            "device is available; pass device='cpu' for the plain path")
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def torch_dtype(name: Optional[str]) -> torch.dtype:
    """numpy-style dtype name (``cfg.dtype``) -> torch dtype; the port
    runs float32 and bfloat16, the two its kernels take."""
    return {"float32": torch.float32, "bfloat16": torch.bfloat16}[name]


def dtype_name(dtype: torch.dtype) -> str:
    """torch dtype -> the numpy-style name the JAX package prints
    (``torch.bfloat16`` -> ``bfloat16``); KV-blob header CRCs hash it."""
    return str(dtype).replace("torch.", "")
