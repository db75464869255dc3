"""Position-keyed sampling, bit-exact with the JAX package.

Counterpart of ``repro.engine.sampling``.  The RNG for the token at
absolute position p of request r depends only on (base_key, r_seed, p),
so a speculative-verify forward and a plain sequential decode sample
identical tokens given identical prefixes — speculation is lossless even
at temperature > 0.

The JAX package draws its noise with threefry-2x32 under
``jax_threefry_partitionable=True``: the base key is ``PRNGKey(seed)`` =
(seed >> 32, seed & 0xffffffff), each ``fold_in(key, d)`` hashes the
count pair (0, d) under the key, and ``gumbel(key, (V,))`` ("low" mode)
hashes the counts (0, i) for i < V, takes the xor of the two output
words as 32 random bits, turns the top 23 into a float in [1, 2), and
returns ``-log(-log(max(tiny, f - 1 + tiny)))``.  This module reproduces
those steps on tensors.  The uint32 arithmetic runs in int64 with
``& 0xFFFFFFFF``, because CUDA torch lacks most uint32 operations; keys
are built on the device from seeds and positions, with no host sync.
"""
from __future__ import annotations

from typing import Optional, Tuple, Union

import torch

from repro_torch.kernels.row_reduce import ops as row_reduce

_M32 = 0xFFFFFFFF
_PARITY = 0x1BD11BDA
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_TINY = torch.finfo(torch.float32).tiny

Word = Union[int, torch.Tensor]


def _rotl(x: torch.Tensor, d: int) -> torch.Tensor:
    return ((x << d) | (x >> (32 - d))) & _M32


def threefry2x32(k1: Word, k2: Word, x1: Word, x2: Word
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Threefry-2x32 (20 rounds) on uint32 values held in int64 tensors
    (or Python ints), broadcasting like the JAX primitive."""
    ks = (k1, k2, k1 ^ k2 ^ _PARITY)
    x1 = (x1 + ks[0]) & _M32
    x2 = (x2 + ks[1]) & _M32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x1 = (x1 + x2) & _M32
            x2 = x1 ^ _rotl(x2, r)
        x1 = (x1 + ks[(i + 1) % 3]) & _M32
        x2 = (x2 + ks[(i + 2) % 3] + i + 1) & _M32
    return x1, x2


def prng_key(seed: int) -> Tuple[int, int]:
    """``jax.random.PRNGKey(seed)`` as two uint32 words."""
    return (seed >> 32) & _M32, seed & _M32


def fold_in(k1: Word, k2: Word, data: Word):
    """``jax.random.fold_in``: hash the count pair (0, data)."""
    if isinstance(data, torch.Tensor):
        data = data.long() & _M32
    else:
        data &= _M32
    return threefry2x32(k1, k2, 0, data)


def position_keys(base_key, seeds: torch.Tensor,
                  positions: torch.Tensor) -> torch.Tensor:
    """seeds (B,), positions (B,T) -> keys (B,T,2) int64 holding the
    uint32 words of ``fold_in(fold_in(base_key, seed), pos)``."""
    s1, s2 = fold_in(base_key[0], base_key[1], seeds)
    p1, p2 = fold_in(s1[:, None], s2[:, None], positions)
    return torch.stack([p1, p2], dim=-1)


def gumbel(keys: torch.Tensor, V: int) -> torch.Tensor:
    """``jax.random.gumbel(key, (V,), float32)`` for every key of
    ``keys`` (..., 2) -> (..., V) f32."""
    counts = torch.arange(V, dtype=torch.int64, device=keys.device)
    y1, y2 = threefry2x32(keys[..., 0, None], keys[..., 1, None], 0, counts)
    bits = (((y1 ^ y2) >> 9) | 0x3F800000).to(torch.int32)
    u = bits.view(torch.float32) - 1.0
    u = torch.clamp_min(u * (1.0 - _TINY) + _TINY, _TINY)
    return -torch.log(-torch.log(u))


def sample_tokens(logits: torch.Tensor, keys: torch.Tensor,
                  temps: torch.Tensor,
                  row_valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """logits (B,T,V) f32; keys (B,T,2); temps (B,) -> (B,T) int32.

    temp <= 0 -> greedy; else Gumbel-max sampling.  Rows outside
    ``row_valid`` (prefill rows of a mixed step) are forced greedy and
    returned as -1."""
    V = logits.shape[-1]
    lf = logits.float()
    if row_valid is not None:
        temps = torch.where(row_valid, temps, 0.0)
    t = temps[:, None, None]
    scaled = torch.where(t > 0, lf / torch.clamp_min(t, 1e-6)
                         + gumbel(keys, V), lf)
    sampled = torch.argmax(scaled, dim=-1).to(torch.int32)
    if row_valid is not None:
        sampled = torch.where(row_valid[:, None], sampled, -1)
    return sampled


def draft_acceptance(sampled: torch.Tensor, tokens: torch.Tensor,
                     anchor: torch.Tensor,
                     n_drafts: torch.Tensor) -> torch.Tensor:
    """Longest accepted draft prefix per row, on the device.

    Column ``anchor[i]`` of ``tokens`` holds the row's pending token and
    columns ``anchor+1 .. anchor+n_drafts`` its drafts; draft j is
    accepted iff it equals ``sampled[i, anchor+j]`` and every earlier
    draft was.  (B,T), (B,T), (B,), (B,) -> (B,) int32."""
    B, T = tokens.shape
    if T == 1:
        return torch.zeros((B,), dtype=torch.int32, device=tokens.device)
    j = torch.arange(T - 1, device=tokens.device)
    a = anchor.long()[:, None]
    d_cols = torch.clamp(a + 1 + j[None, :], 0, T - 1)
    c_cols = torch.clamp(a + j[None, :], 0, T - 1)
    ok = (tokens.gather(1, d_cols) == sampled.gather(1, c_cols)) \
        & (j[None, :] < n_drafts[:, None])
    return torch.cumprod(ok.to(torch.int32), dim=1).sum(dim=1).to(
        torch.int32)


def tree_acceptance(sampled: torch.Tensor, tokens: torch.Tensor,
                    parent: torch.Tensor, depth: torch.Tensor,
                    within: torch.Tensor, mask: torch.Tensor,
                    anchor: torch.Tensor):
    """Longest accepted *path* through a draft token tree, on the device.

    ``parent[b,c]`` is the column of node c's parent (-1 for non-node
    columns), ``depth[b,c]`` its depth below the anchor (0 = anchor or no
    node) and ``within[b,c,c']`` the ancestor-or-self mask of the step.
    A node is accepted iff the edge into it and into every ancestor
    matches the token sampled at the parent — in closed form through the
    ancestor mask, no sequential scan.  Children of one node carry
    distinct tokens, so accepted nodes form one chain.

    Returns ``(n_accepted (B,) int32, path_col (B,T) int32, accepted
    (B,T) bool)``: ``path_col[b,d]`` is the column of the accepted node
    at depth d (the anchor for d = 0 or d > n_accepted)."""
    B, T = tokens.shape
    node = (depth > 0) & mask
    par = parent.clamp(0, T - 1).long()
    edge_ok = torch.where(parent >= 0, tokens == sampled.gather(1, par),
                          True)
    acc = node & (edge_ok[:, None, :] | ~within).all(dim=2)
    n_acc = torch.where(acc, depth, 0).amax(dim=1).to(torch.int32)
    d = torch.arange(T, dtype=torch.int32, device=tokens.device)[None, :]
    hit = acc[:, None, :] & (depth[:, None, :] == d[:, :, None]) \
        & (d[:, :, None] > 0)                                 # (B,Td,Tc)
    # argmax takes no bool; on ties it returns the first maximal index,
    # as jnp.argmax does
    first = hit.to(torch.int32).argmax(dim=2)
    path_col = torch.where(hit.any(dim=2), first,
                           anchor.long()[:, None]).to(torch.int32)
    return n_acc, path_col, acc


def token_logprobs_at(logits: torch.Tensor,
                      tokens: torch.Tensor) -> torch.Tensor:
    """log softmax(logits) at ``tokens``; (B,T,V), (B,T) -> (B,T) f32.
    Negative tokens index from the end, as ``jnp.take_along_axis``."""
    lf = logits.float()
    logz = row_reduce.logsumexp(lf)
    idx = tokens.long() % lf.shape[-1]
    return lf.gather(-1, idx[..., None])[..., 0] - logz
