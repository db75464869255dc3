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
dtype (f32 with ``lse=True``, which also returns each row's log-sum-exp
of its visible scores (B, T, Hq) f32, -inf where it sees none).  This
follows ``_plain`` op for op (scale
``1/sqrt(float32(D))`` on the f32 query), so on the CPU the port's
forward matches the JAX package's.

Row invariance (the rule of ``kernels/row_gemm``): on the CPU, where the
port's engine runs these plain versions, a query row's output depends
only on that row, the cache and its mask row, never on the call's T, B
or heads.  A batched product would break that (BLAS's one-row routine
and PyTorch's plain loop for small batched products sum in other orders
than a product of many rows), so there both products are elementwise
products summed over D and over the slots by PyTorch's reductions,
whose order for one output depends only on the reduction's length; the
query positions go in chunks that keep the intermediate near
``CHUNK_ELEMS`` values, which changes no row.  On the card the plain
versions are the kernels' oracle, held at a tolerance, and take
batched products (cuBLAS in f32): the elementwise form would move the
whole (T, S, D) product through memory.

The split route of the kernels (the CUDA cores) has its own plain
pieces: ``split_partials`` cuts the attention of each row into
``n_split`` shares of the cache, as the kernel does (share s holds
32-slot tiles [n_tiles s / n_split, n_tiles (s + 1) / n_split) of all
n_tiles), and keeps each share's (m, l, unnormalised acc) in f32;
``merge_partials`` merges them in share order, as the merge launch does.
``split_verify_ref`` is the two together.  ``merge_lse`` merges the
``lse=True`` partials of shares of the slots held apart (the ranks of the
production layout's sequence-split cache), in share order.
"""
from __future__ import annotations

import numpy as np
import torch

NEG_INF = -1e30
CHUNK_ELEMS = 1 << 22   # values of a chunk's (rows x slots x D) product
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
                    window: int = 0, lse: bool = False):
    calls["spec_verify"] += 1
    return _masked_ref(q, k, v, pos_mask(q_pos, k_pos, window), lse)


def tree_verify_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    q_pos: torch.Tensor, k_pos: torch.Tensor,
                    tree_mask: torch.Tensor, *,
                    window: int = 0, lse: bool = False):
    """K2: K1 with ``tree_mask`` (B, T, S), bool or uint8 (0 = hidden),
    ANDed into the positional mask — a draft-tree node sees the committed
    prefix and its own ancestors, never a sibling at its position."""
    calls["tree_verify"] += 1
    return _masked_ref(q, k, v,
                       pos_mask(q_pos, k_pos, window) & tree_mask.bool(), lse)


def _chunks(T: int, per_position: int):
    """Slices of the T query positions, each holding near CHUNK_ELEMS
    values of the products (at least one position)."""
    step = max(1, CHUNK_ELEMS // max(per_position, 1))
    return [slice(t0, min(T, t0 + step)) for t0 in range(0, T, step)]


def scores(q: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """The scaled f32 scores (B, T, Hq, S) of q (B, T, Hq, D) against k
    (B, S, Hk, D), query head h on KV head h // (Hq / Hk): each the sum
    over D of f32 products, row by row alike on the CPU."""
    B, T, Hq, D = q.shape
    S, Hk = k.shape[1], k.shape[2]
    G = Hq // Hk
    if q.device.type != "cpu":
        qg = (q.float() * f32_scale(D)).reshape(B, T, Hk, G, D)
        s = torch.einsum("bqhgd,bkhd->bqhgk", qg, k.float())
        return s.reshape(B, T, Hq, S)
    qg = (q.float() * f32_scale(D)).reshape(B, T, Hk, G, 1, D)
    kt = k.float().permute(0, 2, 1, 3)[:, None, :, None]     # (B,1,Hk,1,S,D)
    return torch.cat([(qg[:, c] * kt).sum(-1) for c in
                      _chunks(T, B * Hq * S * D)], dim=1).reshape(B, T, Hq,
                                                                   S)


def weighted_values(p: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """sum over the slots of p (B, T, Hq, S) f32 times v (B, S, Hk, D):
    (B, T, Hq, D) f32, row by row alike on the CPU."""
    B, T, Hq, S = p.shape
    Hk, D = v.shape[2], v.shape[3]
    G = Hq // Hk
    if p.device.type != "cpu":
        o = torch.einsum("bqhgk,bkhd->bqhgd", p.reshape(B, T, Hk, G, S),
                         v.float())
        return o.reshape(B, T, Hq, D)
    pg = p.reshape(B, T, Hk, G, S, 1)
    vt = v.float().permute(0, 2, 1, 3)[:, None, :, None]     # (B,1,Hk,1,S,D)
    return torch.cat([(pg[:, c] * vt).sum(-2) for c in
                      _chunks(T, B * Hq * S * D)], dim=1).reshape(B, T, Hq,
                                                                   D)


def _masked_ref(q, k, v, mask, lse=False):
    m = mask[:, :, None, :]                                  # (B,T,1,S)
    s = torch.where(m, scores(q, k), NEG_INF)                # (B,T,Hq,S)
    p = torch.softmax(s, dim=-1)
    seen = m.any(dim=-1)                                     # (B,T,1)
    p = torch.where(seen[..., None], p, 0.0)
    o = weighted_values(p, v)
    if not lse:
        return o.to(q.dtype)
    lse_t = torch.where(seen, torch.logsumexp(s, dim=-1), -torch.inf)
    return o, lse_t


SPLIT_TILE = 32   # slots per tile of the kernels' split route


def split_partials(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   mask: torch.Tensor, n_split: int,
                   tile: int = SPLIT_TILE) -> tuple:
    """The attention of q over k, v under ``mask`` (B, T, S) cut into
    ``n_split`` shares of the cache: share s holds the ``tile``-slot
    tiles [n_tiles s // n_split, n_tiles (s + 1) // n_split) of its
    n_tiles (none when n_split exceeds n_tiles).  Returns (m, l, acc): m
    and l (n_split, B, T, Hq) f32 — the share's max score (NEG_INF where
    it sees no key) and its sum of exp(score - m) — and acc (n_split, B,
    T, Hq, D) f32, the unnormalised sum of exp(score - m) v.  A row's
    shares depend on S alone and its products on that row alone
    (``scores``, ``weighted_values``), so a rank's shard of the heads
    (tensor parallelism), another T or another B give bitwise those rows
    of the whole call."""
    S = k.shape[1]
    s = scores(q, k)                                         # (B,T,Hq,S)
    n_tiles = -(-S // tile)
    tile_of = torch.arange(S, device=q.device) // tile
    starts = torch.tensor([n_tiles * sp // n_split
                           for sp in range(1, n_split)],
                          dtype=torch.long, device=q.device)
    share = (tile_of[:, None] >= starts).sum(dim=1)          # (S,)
    ms, ls, accs = [], [], []
    for sp in range(n_split):
        vis = (mask & (share == sp))[:, :, None, :]          # (B,T,1,S)
        sv = torch.where(vis, s, NEG_INF)
        m = sv.max(dim=-1).values                            # (B,T,Hq)
        p = torch.where(vis, torch.exp(sv - m[..., None]), 0.0)
        ms.append(m)
        ls.append(p.sum(dim=-1))
        accs.append(weighted_values(p, v))                   # (B,T,Hq,D)
    return torch.stack(ms), torch.stack(ls), torch.stack(accs)


def merge_partials(m: torch.Tensor, l: torch.Tensor,
                   acc: torch.Tensor) -> torch.Tensor:
    """The plain version of the merge launch: shares (n, ...) merged in
    share order, out = sum_s acc_s e^(m_s - M) / sum_s l_s e^(m_s - M)
    with M the max of m_s; exactly 0 where no share saw a key (every l_s
    is 0), never NaN.  f32 out."""
    mx = m[0]
    for sp in range(1, m.shape[0]):
        mx = torch.maximum(mx, m[sp])
    lt = torch.zeros_like(l[0])
    at = torch.zeros_like(acc[0])
    for sp in range(m.shape[0]):
        c = torch.exp(m[sp] - mx)
        lt = lt + l[sp] * c
        at = at + acc[sp] * c[..., None]
    return at / torch.clamp(lt, min=1e-30)[..., None]


def split_verify_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     q_pos: torch.Tensor, k_pos: torch.Tensor,
                     n_split: int, *, window: int = 0,
                     tree_mask: torch.Tensor = None) -> torch.Tensor:
    """K1 (K2 with ``tree_mask``) computed as the split route computes
    it: ``split_partials`` then ``merge_partials``; q's dtype out."""
    mask = pos_mask(q_pos, k_pos, window)
    if tree_mask is not None:
        mask = mask & tree_mask.bool()
    return merge_partials(*split_partials(q, k, v, mask, n_split)).to(
        q.dtype)


def merge_lse(parts) -> torch.Tensor:
    """The ``lse=True`` partials ``[(o_r, lse_r), ...]`` of shares of the
    slots merged in share order: out = sum_r o_r e^(lse_r - M) / sum_r
    e^(lse_r - M), M the max of the lse_r; a share that saw no key
    (lse -inf) weighs exactly 0, and a row no share saw is 0, never NaN.
    o_r (..., D) and lse_r (...) f32; f32 out."""
    mx = parts[0][1]
    for _, lse in parts[1:]:
        mx = torch.maximum(mx, lse)
    mx = torch.where(mx == -torch.inf, 0.0, mx)
    num = torch.zeros_like(parts[0][0])
    den = torch.zeros_like(mx)
    for o, lse in parts:
        w = torch.exp(lse - mx)
        num = num + o * w[..., None]
        den = den + w
    return num / torch.clamp(den, min=1e-30)[..., None]
