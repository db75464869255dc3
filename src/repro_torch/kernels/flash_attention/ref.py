"""Plain PyTorch versions of the flash-attention kernel (K3): the
forward and the FlashAttention-2 backward.

Counterpart of ``repro.kernels.flash_attention.ref.flash_attention_ref``
(the oracle of ``flash_attention_pallas``).  Contract (the cache-free
forward of training):

  q:     (B, Tq, Hq, D)   query i sits at position ``q_offset + i``
  k, v:  (B, Tk, Hk, D)   key j sits at position j; query head h reads
                          KV head h // (Hq/Hk)

Mask: causal (key <= query) and, with ``window``, key > query - window.
Scores, the softmax and the sums are f32; outputs have the inputs' dtype.

One difference from ``flash_attention_ref``: a row that sees no key
gives 0 (and log-sum-exp -inf, and no gradient), as the Pallas kernel
(``l == 0 -> 1`` in ``_flash_kernel``) and ``repro.models.attention._plain``
do; ``flash_attention_ref`` gives the mean of v there.  The forward
follows ``_plain`` op for op (scale ``1/sqrt(float32(D))`` on the f32
query), so on the CPU the port's cache-free forward matches the JAX
package's.

``calls`` counts calls of the two functions below, so that a run on the
card can show that its main path never took the plain version.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.spec_verify.ref import NEG_INF, f32_scale

calls = {"forward": 0, "backward": 0}


def contiguous_mask(Tq: int, Tk: int, *, q_offset: int, causal: bool,
                    window: int, device) -> torch.Tensor:
    """(Tq, Tk) bool: which keys each query sees."""
    qp = q_offset + torch.arange(Tq, device=device)[:, None]
    kp = torch.arange(Tk, device=device)[None, :]
    m = torch.ones((Tq, Tk), dtype=torch.bool, device=device)
    if causal:
        m = m & (kp <= qp)
    if window:
        m = m & (kp > qp - window)
    return m


def _scores(q, k, mask):
    """f32 scores (B, Hk, G, Tq, Tk), masked to NEG_INF."""
    B, Tq, Hq, D = q.shape
    Hk = k.shape[2]
    qg = (q.float() * f32_scale(D)).reshape(B, Tq, Hk, Hq // Hk, D)
    s = torch.einsum("bqhgd,bkhd->bhgqk", qg, k.float())
    return torch.where(mask, s, NEG_INF)


def flash_attention_fwd_ref(q: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor, *, q_offset: int = 0,
                            causal: bool = True, window: int = 0):
    """-> (o (B,Tq,Hq,D) in q's dtype, lse (B,Hq,Tq) f32).  ``lse`` is
    the log-sum-exp of each row's visible scores, -inf for a row that
    sees nothing (whose output is 0)."""
    calls["forward"] += 1
    B, Tq, Hq, D = q.shape
    Tk = k.shape[1]
    mask = contiguous_mask(Tq, Tk, q_offset=q_offset, causal=causal,
                           window=window, device=q.device)
    s = _scores(q, k, mask)
    seen = mask.any(dim=-1)[:, None]                       # (Tq, 1)
    p = torch.where(seen, torch.softmax(s, dim=-1), 0.0)
    o = torch.einsum("bhgqk,bkhd->bqhgd", p, v.float())
    lse = torch.where(seen[:, 0], torch.logsumexp(s, dim=-1), -torch.inf)
    return (o.reshape(B, Tq, Hq, D).to(q.dtype),
            lse.reshape(B, Hq, Tq))


def flash_attention_bwd_ref(q: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor, o: torch.Tensor,
                            lse: torch.Tensor, do: torch.Tensor, *,
                            q_offset: int = 0, causal: bool = True,
                            window: int = 0):
    """FlashAttention-2's backward from the forward's output ``o`` and
    log-sum-exp ``lse`` (B,Hq,Tq):

        P  = exp(S * scale - LSE)      (0 where masked)
        dV = P^T dO
        dP = dO V^T
        dS = P * (dP - rowsum(dO * O))
        dQ = dS K * scale
        dK = dS^T Q * scale

    with the G query heads of a KV head summed into its dK, dV.  All in
    f32 -> (dq, dk, dv) in the inputs' dtypes."""
    calls["backward"] += 1
    B, Tq, Hq, D = q.shape
    Tk, Hk = k.shape[1], k.shape[2]
    G = Hq // Hk
    scale = f32_scale(D)
    mask = contiguous_mask(Tq, Tk, q_offset=q_offset, causal=causal,
                           window=window, device=q.device)
    s = _scores(q, k, mask)                                # (B,Hk,G,Tq,Tk)
    lse_g = lse.reshape(B, Hk, G, Tq, 1)
    p = torch.where(mask & torch.isfinite(lse_g),
                    torch.exp(s - lse_g), 0.0)
    dog = do.float().reshape(B, Tq, Hk, G, D)
    delta = (dog * o.float().reshape(B, Tq, Hk, G, D)).sum(-1)
    dv = torch.einsum("bhgqk,bqhgd->bkhd", p, dog)
    dp = torch.einsum("bqhgd,bkhd->bhgqk", dog, v.float())
    ds = p * (dp - delta.permute(0, 2, 3, 1)[..., None])
    dq = torch.einsum("bhgqk,bkhd->bqhgd", ds, k.float()) * scale
    qg = q.float().reshape(B, Tq, Hk, G, D)
    dk = torch.einsum("bhgqk,bqhgd->bkhd", ds, qg) * scale
    return (dq.reshape(B, Tq, Hq, D).to(q.dtype), dk.to(k.dtype),
            dv.to(v.dtype))
