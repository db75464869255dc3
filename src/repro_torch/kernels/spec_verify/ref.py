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

The split route of the kernels (decode on the CUDA cores) has its own
plain pieces: ``split_partials`` cuts the attention of each row into
``n_split`` shares of its slots, as the kernel cuts its list of needed
32-slot tiles, and keeps each share's (m, l, unnormalised acc) in f32;
``merge_partials`` merges them in share order, as the merge launch does.
``split_verify_ref`` is the two together.  ``merge_lse`` merges the
``lse=True`` partials of shares of the slots held apart (the ranks of the
production layout's sequence-split cache), in share order.
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


def _masked_ref(q, k, v, mask, lse=False):
    B, T, Hq, D = q.shape
    Hk = k.shape[2]
    G = Hq // Hk
    qg = (q.float() * f32_scale(D)).reshape(B, T, Hk, G, D)
    s = torch.einsum("bqhgd,bkhd->bhgqk", qg, k.float())    # (B,Hk,G,T,S)
    m = mask[:, None, None]
    s = torch.where(m, s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    p = torch.where(m.any(dim=-1, keepdim=True), p, 0.0)
    o = torch.einsum("bhgqk,bkhd->bqhgd", p, v.float()).reshape(B, T, Hq, D)
    if not lse:
        return o.to(q.dtype)
    seen = m.any(dim=-1)                                     # (B,Hk,G,T)
    lse_t = torch.where(seen, torch.logsumexp(s, dim=-1), -torch.inf)
    return o, lse_t.permute(0, 3, 1, 2).reshape(B, T, Hq)


SPLIT_TILE = 32   # slots per tile of the kernels' split route


def split_partials(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   mask: torch.Tensor, n_split: int,
                   tile: int = SPLIT_TILE) -> tuple:
    """The attention of q over k, v under ``mask`` (B, T, S) cut into
    ``n_split`` shares: per batch row, the in-order list of ``tile``-slot
    tiles that some query of the row may see, share s holding entries
    [n * s // n_split, n * (s + 1) // n_split) of it (empty when n_split
    exceeds n).  Returns (m, l, acc): m and l (n_split, B, T, Hq) f32 —
    the share's max score (NEG_INF where it sees no key) and its sum of
    exp(score - m) — and acc (n_split, B, T, Hq, D) f32, the unnormalised
    sum of exp(score - m) v.  Each query head's products are computed on
    their own, at shapes that do not depend on the number of heads, as
    the kernel's CTAs each take one KV head: a rank's shard of the heads
    (tensor parallelism) gives bitwise those heads of the whole call."""
    B, T, Hq, D = q.shape
    S, Hk = k.shape[1], k.shape[2]
    G = Hq // Hk
    qf = q.float() * f32_scale(D)
    kf, vf = k.float(), v.float()
    s = torch.stack([torch.einsum("bqd,bkd->bqk", qf[:, :, h].contiguous(),
                                  kf[:, :, h // G].contiguous())
                     for h in range(Hq)], dim=2)             # (B,T,Hq,S)
    n_tiles = -(-S // tile)
    seen = torch.zeros(B, n_tiles * tile, dtype=torch.bool)
    seen[:, :S] = mask.any(dim=1).cpu()
    seen = seen.reshape(B, n_tiles, tile).any(dim=-1)        # (B, n_tiles)
    share = torch.full((B, S), -1, dtype=torch.long)
    for b in range(B):
        listed = torch.nonzero(seen[b]).flatten().tolist()
        n = len(listed)
        for sp in range(n_split):
            for t in listed[n * sp // n_split:n * (sp + 1) // n_split]:
                share[b, t * tile:(t + 1) * tile] = sp
    share = share.to(q.device)
    ms, ls, accs = [], [], []
    for sp in range(n_split):
        vis = mask & (share == sp)[:, None, :]                 # (B,T,S)
        sv = torch.where(vis[:, :, None, :], s, NEG_INF)
        m = sv.max(dim=-1).values                              # (B,T,Hq)
        p = torch.where(vis[:, :, None, :], torch.exp(sv - m[..., None]),
                        0.0)
        ms.append(m)
        ls.append(p.sum(dim=-1))
        accs.append(torch.stack(
            [torch.bmm(p[:, :, h].contiguous(), vf[:, :, h // G].contiguous())
             for h in range(Hq)], dim=2))                     # (B,T,Hq,D)
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
