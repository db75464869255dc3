"""Plain PyTorch version of the row-invariant product (``row_gemm``).

``row_gemm_ref(a, w)`` is ``a @ w`` for a (..., K) and w (K, N) of a's
dtype, and ``row_bmm_ref(a, w)`` the batched (E, M, K) x (E, K, N) form;
both compute in f32 (a bf16 product is exact in f32) and round once to
a's dtype, as the kernel does.  Like the kernel they are row-invariant
on the CPU: the bits of one output row depend only on that row of ``a``,
on ``w`` and on the widths, never on how many rows the call has or which
of ``w``'s columns it was given.

How: CPU BLAS computes a one-row product in its matrix-vector routine,
which sums in another order than a product of two rows or more (up to
7.6e-6 apart at 64 x 256); PyTorch's batched product of fewer than 400
multiply-adds takes a plain loop instead of BLAS; and at K or N past 512
the BLAS product's row arithmetic depends on M (1024 x 1024: thousands of
rows differ).  So a product here pads its rows to at least
``min_rows(K, N)`` with zeros (at least two, and enough for BLAS), a
one-column W to two columns (the same routine by columns), and runs in
blocks of at most ``BLOCK`` columns of K and of N, the K blocks
summed in ascending order: each block is a product at widths where
``tests/test_torch_row_invariance.py`` holds BLAS row-invariant across M
and column slices, and the blocking depends on K and N alone.  On the
card the plain version is the kernel's oracle, held at a tolerance, and
runs one f32 product.
"""
from __future__ import annotations

import torch

BLOCK = 512          # K and N columns of one BLAS product
_BLAS_MIN = 400      # multiply-adds below which torch's bmm leaves BLAS
# calls of the plain version, so that a run on the card can show that its
# engine path never took it
calls = {"row_gemm": 0}


def min_rows(K: int, N: int) -> int:
    """Rows a product of widths K x N is padded to: two at least (BLAS's
    one-row routine sums in another order), and enough that a batched
    product stays on BLAS."""
    kn = max(min(K, BLOCK) * min(N, BLOCK), 1)
    return max(2, -(-_BLAS_MIN // kn))


def _pad_rows(a: torch.Tensor, rows: int) -> torch.Tensor:
    """(..., M, K) with zero rows appended up to ``rows``."""
    M = a.shape[-2]
    if M >= rows:
        return a
    pad = a.new_zeros(*a.shape[:-2], rows - M, a.shape[-1])
    return torch.cat([a, pad], dim=-2)


def blocked_product(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """f32 (..., M, K) @ (..., K, N) -> (..., M, N) f32, row-invariant on
    the CPU: rows padded to ``min_rows``, products in blocks of at most
    ``BLOCK`` columns of K and N, K blocks summed in order.  On the card,
    where the plain version is the kernel's oracle at a tolerance, one
    f32 product (cuBLAS, TF32 off)."""
    if a.device.type != "cpu":
        return torch.matmul(a, w)
    M, K = a.shape[-2:]
    N = w.shape[-1]
    a = _pad_rows(a, min_rows(K, N))
    if N < 2:      # a one-column product is BLAS's matrix-vector routine
        w = torch.cat([w, w.new_zeros(*w.shape[:-1], 2 - N)], dim=-1)
        return blocked_product(a, w)[..., :M, :N]
    if K <= BLOCK and N <= BLOCK:
        return torch.matmul(a, w)[..., :M, :]
    cols = []
    for n0 in range(0, N, BLOCK):
        acc = None
        for k0 in range(0, K, BLOCK):
            part = torch.matmul(a[..., k0:k0 + BLOCK],
                                w[..., k0:k0 + BLOCK, n0:n0 + BLOCK])
            acc = part if acc is None else acc + part
        cols.append(acc)
    return torch.cat(cols, dim=-1)[..., :M, :]


def row_gemm_ref(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """a (..., K) @ w (K, N), w in a's dtype; a's dtype out."""
    calls["row_gemm"] += 1
    K, N = w.shape
    out = blocked_product(a.reshape(-1, K).float(),
                          w.float().contiguous())
    return out.to(a.dtype).reshape(*a.shape[:-1], N)


def row_bmm_ref(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """a (E, M, K) @ w (E, K, N), w in a's dtype; a's dtype out."""
    calls["row_gemm"] += 1
    return blocked_product(a.float(), w.float().contiguous()).to(a.dtype)
