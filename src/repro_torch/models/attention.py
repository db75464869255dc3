"""Attention: over the slot cache, and cache-free over contiguous
positions.

Counterpart of ``repro.models.attention`` on the paths the port runs.
Every cached forward attends T query tokens to a slot-indexed KV cache
masked by each slot's absolute position.  The JAX package computes it
with ``_plain`` (its forward never calls the Pallas kernel); in the port
the hand-written spec-verify kernel (K1) *is* that attention on the
card, and the tree-verify kernel (K2) is the attention of a forward that
carries an ``allowed_mask`` (tree speculation).  A VLM or audio model's
cross-attention to its cached memory is K1 too, at zero positions
(``transformer._cross_attn`` says why that is the non-causal mask).
The cache-free forward (training, and the audio encoder) attends a
sequence to itself at positions 0..T-1, causal or not, and in training
a cross block's queries to the whole memory (non-causal); the JAX
package runs ``_plain`` (or its XLA ``_flash`` scan for long sequences)
and differentiates it by autodiff, the port runs the flash-attention
kernel (K3) with its hand-written backward.  The plain versions of all three —
which follow ``_plain`` op for op — run on a CPU tensor.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.kernels.spec_verify.ops import spec_verify, tree_verify


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              q_pos: torch.Tensor, k_pos: torch.Tensor, *,
              causal: bool = True, window: int = 0,
              kv_valid: Optional[torch.Tensor] = None,
              softcap: float = 0.0,
              allowed_mask: Optional[torch.Tensor] = None,
              contiguous: bool = False,
              split_like: Optional[Tuple[int, int]] = None,
              lse: bool = False):
    """q: (B,T,Hq,D); k,v: (B,S,Hk,D); q_pos (B,T) and k_pos (B,S)
    absolute positions -> (B,T,Hq,D).

    ``contiguous=False``: k, v are a slot cache and k_pos the position
    each slot holds (-1 = empty).  The mask is (k_pos >= 0) & (k_pos <=
    q_pos) & window — the JAX package's causal mask with ``kv_valid =
    k_pos >= 0`` — through K1.

    ``allowed_mask`` (B,T,S) bool: the JAX package lets it *replace* that
    mask, while K2 ANDs it in (as the Pallas tree kernel does).  The two
    agree because the mask ``forward`` builds is a subset of the
    positional one (cached slots use the positional mask itself, this
    step's slots ancestor-or-self columns at positions <= the query's);
    the tests check that subset on the engine's tree batches.

    ``contiguous=True`` (the cache-free forward and the audio encoder):
    q_pos and k_pos are 0..T-1 in every row, which the caller made or
    checked (or, non-causal, a cross block's zero positions: no mask
    reads them), and the mask is causal (or none) & window, through K3.
    No ``kv_valid`` there: ``grpo_loss`` never passes a token mask.

    ``split_like`` (Hq, Hk): q, k, v hold a rank's shard of a layer of Hq
    query and Hk KV heads; K1 / K2 then cut the cache into the shares the
    unsharded call would, so each head's result does not depend on the
    tensor-parallel degree.

    ``lse=True`` (the slot-cache path): K1 / K2's partials, (o f32, the
    rows' log-sum-exp (B,T,Hq) f32, -inf where a row sees no key), for a
    merge across shares of the slots (``sharding.merge_ranks``)."""
    if softcap:
        raise NotImplementedError(
            "attention softcap is not on a ported path")
    if contiguous:
        if lse:
            raise NotImplementedError("lse is the slot-cache path's")
        if kv_valid is not None or allowed_mask is not None:
            raise NotImplementedError(
                "kv_valid / allowed_mask on the cache-free path are not "
                "on a ported path")
        return flash_attention(q, k, v, causal=causal, window=window)
    if not causal or kv_valid is not None:
        raise NotImplementedError(
            "the slot-cache path is causal with kv_valid = k_pos >= 0")
    if allowed_mask is not None:
        return tree_verify(q, k, v, q_pos, k_pos, allowed_mask,
                           window=window, split_like=split_like, lse=lse)
    return spec_verify(q, k, v, q_pos, k_pos, window=window,
                       split_like=split_like, lse=lse)
