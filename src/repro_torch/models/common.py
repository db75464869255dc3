"""Shared building blocks: norms (plain and Mamba2's gated one), RoPE,
the weight-casting matmul and the cross-entropy of training.

Counterpart of ``repro.models.common``.  The dtype steps are kept
exactly: RMSNorm runs in f32 and casts back, RoPE angles are f32, and
``lin`` casts the weight to the activation dtype on every call, so a
weight stored once in the activation dtype computes the same result as
the JAX package's f32 master weights.
"""
from __future__ import annotations

import functools

import torch


def lin(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Matmul with the weight cast to the activation dtype."""
    return x @ w.to(x.dtype)


def rms_norm(x: torch.Tensor, weight: torch.Tensor,
             eps: float = 1e-5) -> torch.Tensor:
    dt = x.dtype
    x = x.float()
    var = torch.mean(torch.square(x), dim=-1, keepdim=True)
    x = x * torch.rsqrt(var + eps)
    return (x * weight.float()).to(dt)


@functools.lru_cache(maxsize=None)
def rope_freqs(head_dim: int, theta: float,
               device: torch.device) -> torch.Tensor:
    """f32 ``1 / theta ** (2i / head_dim)``, built on ``device`` by
    kernels alone (``torch.full``, not a host copy, which would sync) and
    kept per (head_dim, theta, device)."""
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32,
                        device=device) / head_dim
    base = torch.full((), theta, dtype=torch.float32, device=device)
    return 1.0 / torch.pow(base, exps)


def gated_rms_norm(x: torch.Tensor, gate: torch.Tensor, weight: torch.Tensor,
                   eps: float = 1e-5) -> torch.Tensor:
    """Mamba2's RMSNorm(x * silu(gate)): silu of the gate in f32, cast to
    x's dtype, then :func:`rms_norm`."""
    g = gate.float()
    return rms_norm(x * (g * torch.sigmoid(g)).to(x.dtype), weight, eps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: (..., T, H, D); positions: broadcastable to (..., T)."""
    d = x.shape[-1]
    freqs = rope_freqs(d, theta, x.device)                     # (D/2,)
    angles = positions[..., :, None, None].float() * freqs     # (...,T,1,D/2)
    cos, sin = torch.cos(angles), torch.sin(angles)
    x1, x2 = x[..., : d // 2], x[..., d // 2:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def softmax_cross_entropy(logits: torch.Tensor,
                          labels: torch.Tensor) -> torch.Tensor:
    """-log softmax(logits)[label], with the log-sum-exp in f32.  The
    gold logit is read by an index, whose gradient is an ``index_put``
    that has a deterministic (atomic-free) form on the card."""
    lf = logits.float()
    logz = torch.logsumexp(lf, dim=-1)
    flat = lf.reshape(-1, lf.shape[-1])
    rows = torch.arange(flat.shape[0], device=flat.device)
    gold = flat[rows, labels.reshape(-1).long()].reshape(labels.shape)
    return logz - gold


def token_logprobs(logits: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    return -softmax_cross_entropy(logits, tokens)
