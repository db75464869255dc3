"""Shared building blocks: norms (plain and Mamba2's gated one), RoPE,
the weight-casting matmul and the cross-entropy of training.

Counterpart of ``repro.models.common``.  The dtype steps are kept
exactly: RMSNorm runs in f32 and casts back, RoPE angles are f32, and
``lin`` casts the weight to the activation dtype on every call, so a
weight stored once in the activation dtype computes the same result as
the JAX package's f32 master weights.

Row invariance.  Off autograd (the engine path: every cached forward,
the production cached steps, the cross-attention caches) ``lin`` runs
the row-invariant product (``kernels.row_gemm``) and ``rms_norm`` the
row-invariant reduction (``kernels.row_reduce``): the bits of one output
row depend only on that row and the reduction's length, never on the
call's other rows, its columns or its route, so a request's tokens do
not change with the rows it shares a step with (a crash's rebatching, a
verify's width, tp's column shards).  Where autograd records (the train
step) both stay the PyTorch operations they were.
"""
from __future__ import annotations

import functools

import torch

from repro_torch.kernels.row_gemm.ops import row_gemm
from repro_torch.kernels.row_reduce import ops as row_reduce
from repro_torch.kernels.row_reduce.ref import rms_norm_rows


def records_grad(*ts: torch.Tensor) -> bool:
    """Whether autograd records an operation on ``ts``."""
    return torch.is_grad_enabled() and any(t.requires_grad for t in ts)


def lin(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Matmul with the weight cast to the activation dtype: the
    row-invariant product off autograd, ``torch.matmul`` under it."""
    w = w.to(x.dtype)
    if records_grad(x, w):
        return x @ w
    return row_gemm(x, w)


def rms_norm(x: torch.Tensor, weight: torch.Tensor,
             eps: float = 1e-5) -> torch.Tensor:
    """RMSNorm in f32, cast back: the row-invariant reduction off
    autograd, PyTorch's operations under it."""
    if records_grad(x, weight):
        return rms_norm_rows(x, weight, eps)
    return row_reduce.rms_norm(x, weight, eps)


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
