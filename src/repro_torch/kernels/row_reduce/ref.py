"""Plain PyTorch versions of the engine path's row reductions
(``row_reduce``): RMSNorm and the log-sum-exp of logits rows.

``rms_norm_rows`` is ``models.common.rms_norm``'s arithmetic (f32, the
mean of squares, ``rsqrt``, the f32 weight, cast back), which the train
step runs under autograd; ``rms_norm_ref`` is the same function as the
kernel's plain version, ``logsumexp_ref`` ``torch.logsumexp`` over the
last dim.  On the CPU they are row-invariant (each row reduced by the
same vector loop, and ``exp``'s vector and scalar routines agree, which
``tests/test_torch_row_invariance.py`` checks) but for one case: a
reduction with a single output splits its row across threads once it
passes 32,768 values, so a lone row is reduced beside a copy of itself.
"""
from __future__ import annotations

import torch

# calls of the plain versions, so that a run on the card can show that its
# engine path never took them
calls = {"rms_norm": 0, "logsumexp": 0}


def rms_norm_rows(x: torch.Tensor, weight: torch.Tensor,
                  eps: float = 1e-5) -> torch.Tensor:
    dt = x.dtype
    x = x.float()
    var = torch.mean(torch.square(x), dim=-1, keepdim=True)
    x = x * torch.rsqrt(var + eps)
    return (x * weight.float()).to(dt)


def _lone_row_doubled(x: torch.Tensor) -> torch.Tensor:
    """x as (rows, last dim), a single row stacked with a copy of itself."""
    rows = x.reshape(-1, x.shape[-1])
    return torch.cat([rows, rows]) if rows.shape[0] == 1 else rows


def rms_norm_ref(x: torch.Tensor, weight: torch.Tensor,
                 eps: float = 1e-5) -> torch.Tensor:
    calls["rms_norm"] += 1
    out = rms_norm_rows(_lone_row_doubled(x), weight, eps)
    return out[:max(1, x.numel() // max(x.shape[-1], 1))].reshape(x.shape)


def logsumexp_ref(x: torch.Tensor) -> torch.Tensor:
    """log(sum(exp(x), -1)) of f32 ``x`` (..., V)."""
    calls["logsumexp"] += 1
    out = torch.logsumexp(_lone_row_doubled(x), dim=-1)
    return out[:max(1, x.numel() // max(x.shape[-1], 1))].reshape(
        x.shape[:-1])
