"""Plain PyTorch versions of the spec-verify (K1) and tree-verify (K2)
attention kernels.

Counterparts of ``repro.kernels.spec_verify.ref.spec_verify_ref`` /
``tree_verify_ref`` and of ``repro.models.attention._plain`` on the
slot-cache path, which compute the same functions.  Contract:

  q:     (B, T, Hq, D)   query tokens (decode T=1, verify T=gamma+1,
                         mixed prefill T <= prefill_chunk)
  k, v:  (B, S, Hk, D)   slot cache; query head h reads KV head h//(Hq/Hk)
  q_pos: (B, T) int32    absolute position of each query token
  k_pos: (B, S) int32    absolute position held by each slot, -1 = empty

Mask: (k_pos >= 0) & (k_pos <= q_pos) & (k_pos > q_pos - window if
window); K2 ANDs a (B, T, S) ``tree_mask`` into it.  Scores and the
softmax are f32; rows with no visible key give 0; the output has q's
dtype.  This follows ``_plain`` op for op (scale
``1/sqrt(float32(D))`` on the f32 query), so on the CPU the port's
forward matches the JAX package's.
"""
from __future__ import annotations

import numpy as np
import torch

NEG_INF = -1e30
# calls of the two plain versions, so that a run on the card can show that
# its main path never took them
calls = {"spec_verify": 0, "tree_verify": 0}


def f32_scale(D: int) -> float:
    """``1 / sqrt(float32(D))`` rounded to f32, as ``_plain`` computes it
    (not ``D ** -0.5``); a Python float, so no device tensor is made."""
    return float(np.float32(1.0) / np.sqrt(np.float32(D)))


def pos_mask(q_pos: torch.Tensor, k_pos: torch.Tensor,
             window: int = 0) -> torch.Tensor:
    """(B,T), (B,S) -> (B,T,S) bool visibility."""
    qp = q_pos[:, :, None]
    kp = k_pos[:, None, :]
    m = (kp >= 0) & (kp <= qp)
    if window:
        m = m & (kp > qp - window)
    return m


def spec_verify_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    q_pos: torch.Tensor, k_pos: torch.Tensor, *,
                    window: int = 0) -> torch.Tensor:
    calls["spec_verify"] += 1
    return _masked_ref(q, k, v, pos_mask(q_pos, k_pos, window))


def tree_verify_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    q_pos: torch.Tensor, k_pos: torch.Tensor,
                    tree_mask: torch.Tensor, *,
                    window: int = 0) -> torch.Tensor:
    """K2: K1 with ``tree_mask`` (B, T, S), bool or uint8 (0 = hidden),
    ANDed into the positional mask — a draft-tree node sees the committed
    prefix and its own ancestors, never a sibling at its position."""
    calls["tree_verify"] += 1
    return _masked_ref(q, k, v,
                       pos_mask(q_pos, k_pos, window) & tree_mask.bool())


def _masked_ref(q, k, v, mask):
    B, T, Hq, D = q.shape
    Hk = k.shape[2]
    G = Hq // Hk
    qg = (q.float() * f32_scale(D)).reshape(B, T, Hk, G, D)
    s = torch.einsum("bqhgd,bkhd->bhgqk", qg, k.float())    # (B,Hk,G,T,S)
    m = mask[:, None, None]
    s = torch.where(m, s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    p = torch.where(m.any(dim=-1, keepdim=True), p, 0.0)
    o = torch.einsum("bhgqk,bkhd->bqhgd", p, v.float())
    return o.reshape(B, T, Hq, D).to(q.dtype)
