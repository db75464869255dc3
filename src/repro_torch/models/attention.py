"""Attention over the slot cache.

Counterpart of ``repro.models.attention`` on the path the engine runs:
every cached forward attends T query tokens to a slot-indexed KV cache
masked by each slot's absolute position.  The JAX package computes it
with ``_plain`` (its forward never calls the Pallas kernel); in the port
the hand-written spec-verify kernel (K1) *is* that attention on the
card, and the tree-verify kernel (K2) is the attention of a forward
that carries an ``allowed_mask`` (tree speculation).  Their plain
versions — which follow ``_plain`` op for op — run on a CPU tensor.
The cache-free forward (training, cross-attention)
belongs to the flash-attention kernel (K3), a later slice.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels.spec_verify.ops import spec_verify, tree_verify


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              q_pos: torch.Tensor, k_pos: torch.Tensor, *,
              window: int = 0, softcap: float = 0.0,
              allowed_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """q: (B,T,Hq,D); k,v: (B,S,Hk,D) slot cache; q_pos (B,T) and k_pos
    (B,S) absolute positions (-1 = empty slot) -> (B,T,Hq,D).

    The mask is (k_pos >= 0) & (k_pos <= q_pos) & window — the JAX
    package's causal mask with ``kv_valid = k_pos >= 0``.

    ``allowed_mask`` (B,T,S) bool: the JAX package lets it *replace* that
    mask, while K2 ANDs it in (as the Pallas tree kernel does).  The two
    agree because the mask ``forward`` builds is a subset of the
    positional one (cached slots use the positional mask itself, this
    step's slots ancestor-or-self columns at positions <= the query's);
    the tests check that subset on the engine's tree batches."""
    if softcap:
        raise NotImplementedError(
            "attention softcap is not on this slice's path")
    if allowed_mask is not None:
        return tree_verify(q, k, v, q_pos, k_pos, allowed_mask,
                           window=window)
    return spec_verify(q, k, v, q_pos, k_pos, window=window)
