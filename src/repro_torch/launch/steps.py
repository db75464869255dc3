"""The engine's shard layouts: which piece of each parameter and cache
leaf a rank of a tensor-parallel group holds.

Counterpart of ``repro.launch.steps``' ``engine_param_shardings`` and
``engine_cache_shardings``.  The reference returns a ``NamedSharding``
per leaf and lets GSPMD place it; here each function takes a leaf and
returns rank r's shard (a contiguous copy, or the leaf itself where it
is replicated).  The step builders, the production ``param_shardings``
/ ``cache_shardings`` and ``lower_pair`` belong to the production
layout and have no counterpart yet.

Parameters follow ``sharding.exact_col_spec``: only column (matmul
output) dims are split, so no reduction is ever sharded — ``wq``,
``wk``, ``wv`` by heads, ``wg`` / ``wu`` (and a MoE block's shared
``sg`` / ``su``) by ``ff``, a MoE block's expert ``wg`` / ``wu`` by each
expert's hidden dim ``eff``, the untied ``unembed`` by vocab; ``wo``,
``wd``, the router, the embedding, the norms and every Mamba2 leaf stay
whole.  Attention leaves keep whole heads on a rank
(``sharding.head_shard``), where the reference may split a ``wk`` whose
columns divide mid-head and let GSPMD gather.

The cache: ``k`` / ``v`` split by KV head as the attention weights are;
``slot_pos``, ``conv`` and ``ssm`` whole.  The cross-attention memory
``cross_k`` / ``cross_v`` is split by KV head too, where the reference
replicates it: a rank's cross block reads only its heads, which the
kernel (K1) takes as contiguous rows, and the rank's own ``wk`` / ``wv``
columns make exactly those heads.  Exported blobs are gathered back to
the unsharded layout (:func:`gather_heads`), so their bytes, headers
and CRCs do not depend on tp.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.sharding import (HeadShard, ShardCtx, all_gather_parts,
                                  exact_col_spec, head_shard, split_range)

# cache and blob leaves split by KV head (head axis -2 of every one)
HEAD_LEAVES = ("k", "v", "cross_k", "cross_v")


def heads_of(cfg: ModelConfig, sctx: Optional[ShardCtx],
             rank: Optional[int] = None) -> HeadShard:
    """The attention heads rank ``rank`` (default: this one) holds."""
    if sctx is None:
        return HeadShard(0, cfg.num_heads, 0, cfg.num_kv_heads)
    return head_shard(cfg.num_heads, cfg.num_kv_heads, sctx.tp_size,
                      sctx.rank if rank is None else rank)


def _block_kind(block: dict) -> str:
    if "router" in block:
        return "moe"
    if "wq" in block:
        return "attn"
    if "wd" in block:
        return "mlp"
    return "other"


# the reference's logical axes of each split candidate (its layout)
_AXES = {("attn", "wq"): ("embed", "heads"), ("attn", "wk"): ("embed", "kv"),
         ("attn", "wv"): ("embed", "kv"), ("mlp", "wg"): ("embed", "ff"),
         ("mlp", "wu"): ("embed", "ff"), ("moe", "wg"): ("expert", "embed",
                                                         "eff"),
         ("moe", "wu"): ("expert", "embed", "eff"),
         ("moe", "sg"): ("embed", "ff"), ("moe", "su"): ("embed", "ff"),
         ("top", "unembed"): ("embed", "vocab")}


def _narrow_cols(t: torch.Tensor, lo: int, hi: int, full: int,
                 what: str) -> torch.Tensor:
    """Columns ``[lo, hi)`` of a leaf ``full`` wide; a leaf already
    ``hi - lo`` wide is taken as this rank's shard."""
    width = t.shape[-1]
    if width == full:
        return t.narrow(-1, lo, hi - lo).contiguous()
    if width == hi - lo:
        return t
    raise ValueError(f"{what}: {width} columns, want {full} or the "
                     f"shard's {hi - lo}")


def param_shard(cfg: ModelConfig, kind: str, name: str, t: torch.Tensor,
                sctx: Optional[ShardCtx]) -> torch.Tensor:
    """Rank ``sctx.rank``'s piece of one parameter leaf ``name`` of a
    block of ``kind`` ("attn", "mlp", "moe", "other"; "top" for the
    tree's own leaves)."""
    axes = _AXES.get((kind, name))
    if sctx is None or sctx.tp_size == 1 or axes is None:
        return t
    tp, r = sctx.tp_size, sctx.rank
    if kind == "attn":
        hs = heads_of(cfg, sctx)
        hd = cfg.head_dim
        lo, hi, n = (hs.q_lo, hs.q_hi, cfg.num_heads) if name == "wq" \
            else (hs.kv_lo, hs.kv_hi, cfg.num_kv_heads)
        return _narrow_cols(t, lo * hd, hi * hd, n * hd, name)
    if kind == "moe" and name in ("wg", "wu"):
        # the port's (d, E * eff): split each expert's eff columns
        E = cfg.num_experts
        eff = cfg.moe_d_ff or cfg.d_ff
        if exact_col_spec(axes, (E, t.shape[0], eff), sctx)[-1] is None:
            return t
        lo, hi = split_range(eff, tp, r)
        if t.shape[-1] == E * (hi - lo):
            return t
        if t.shape[-1] != E * eff:
            raise ValueError(f"moe {name}: {t.shape[-1]} columns, want "
                             f"{E * eff} or the shard's {E * (hi - lo)}")
        d = t.shape[0]
        return t.reshape(d, E, eff)[:, :, lo:hi].reshape(d, -1).contiguous()
    full = {"ff": (cfg.moe_d_ff or cfg.d_ff) * max(cfg.num_shared_experts, 1)
            if kind == "moe" else cfg.d_ff, "vocab": cfg.vocab_size}[axes[-1]]
    if exact_col_spec(axes, (t.shape[0], full), sctx)[-1] is None:
        return t
    lo, hi = split_range(full, tp, r)
    return _narrow_cols(t, lo, hi, full, name)


def engine_param_shards(cfg: ModelConfig, params: dict,
                        sctx: Optional[ShardCtx]) -> dict:
    """This rank's shard of a whole parameter tree (the reference's
    ``engine_param_shardings`` applied).  Leaves already at their shard
    width are kept, so a tree built for this rank (``init_params`` or
    ``bridge.params_from_jax`` with ``sctx``) passes through unchanged;
    replicated leaves are the same tensors.  ``params`` may also be one
    block or layer of a tree (an attention, MLP or MoE block)."""
    if sctx is None or sctx.tp_size == 1:
        return params

    def walk(tree, top):
        if isinstance(tree, list):
            return [walk(x, False) for x in tree]
        kind = _block_kind(tree)
        if kind == "other" and top:
            kind = "top"
        return {n: walk(v, False) if isinstance(v, (dict, list))
                else param_shard(cfg, kind, n, v, sctx)
                for n, v in tree.items()}

    return walk(params, True)


def kv_heads(cfg: ModelConfig, sctx: Optional[ShardCtx]) -> int:
    """KV heads of this rank's cache (and cross-attention memory)."""
    hs = heads_of(cfg, sctx)
    return hs.kv_hi - hs.kv_lo


def cache_shard(cfg: ModelConfig, name: str, t: torch.Tensor,
                sctx: Optional[ShardCtx]) -> torch.Tensor:
    """Rank ``sctx.rank``'s piece of a cache or blob leaf (the
    reference's ``engine_cache_shardings``): the KV heads of ``k``,
    ``v``, ``cross_k`` and ``cross_v`` (axis -2), every other leaf
    whole."""
    if sctx is None or sctx.tp_size == 1 or name not in HEAD_LEAVES:
        return t
    hs = heads_of(cfg, sctx)
    if t.shape[-2] != cfg.num_kv_heads:
        raise ValueError(f"{name}: {t.shape[-2]} KV heads, want "
                         f"{cfg.num_kv_heads}")
    return t.narrow(-2, hs.kv_lo, hs.kv_hi - hs.kv_lo)


def gather_heads(cfg: ModelConfig, name: str, t: torch.Tensor,
                 sctx: Optional[ShardCtx]) -> torch.Tensor:
    """The unsharded leaf from every rank's piece (the inverse of
    :func:`cache_shard`, a collective): each KV head taken from the first
    rank that holds it, in head order."""
    if sctx is None or sctx.tp_size == 1 or name not in HEAD_LEAVES:
        return t
    shards = [heads_of(cfg, sctx, r) for r in range(sctx.tp_size)]
    if all(s.kv_hi - s.kv_lo == cfg.num_kv_heads for s in shards):
        return t
    parts = all_gather_parts(t, sctx)
    pieces, h = [], 0
    for part, s in zip(parts, shards):
        if s.kv_hi > h:
            pieces.append(part.narrow(-2, h - s.kv_lo, s.kv_hi - h))
            h = s.kv_hi
    return torch.cat(pieces, dim=-2)
