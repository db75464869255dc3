"""Shard layouts and the step builders: which piece of each parameter and
cache leaf a rank of a tensor-parallel group holds, and the production
layout's train, prefill, serve and verify steps over those pieces.

Counterpart of ``repro.launch.steps``.  The reference returns a
``NamedSharding`` per leaf and lets GSPMD place it; here a placement
function returns the reference's spec (a tuple of mesh axes per dim,
``sharding.logical_to_spec``'s form) and a shard function takes a leaf
and returns rank r's piece (a contiguous copy, or the leaf itself where
it is replicated).

**The engine's layouts** (``engine_param_shardings``,
``engine_cache_shardings``).  Parameters follow
``sharding.exact_col_spec``: only column (matmul output) dims are split,
so no reduction is ever sharded — ``wq``, ``wk``, ``wv`` by heads,
``wg`` / ``wu`` (and a MoE block's shared ``sg`` / ``su``) by ``ff``, a
MoE block's expert ``wg`` / ``wu`` by each expert's hidden dim ``eff``,
the untied ``unembed`` by vocab; ``wo``, ``wd``, the router, the
embedding, the norms and every Mamba2 leaf stay whole.  Attention leaves
keep whole heads on a rank (``sharding.head_shard``), where the
reference may split a ``wk`` whose columns divide mid-head and let GSPMD
gather.  The cache: ``k`` / ``v`` split by KV head as the attention
weights are; ``slot_pos``, ``conv`` and ``ssm`` whole.  The
cross-attention memory ``cross_k`` / ``cross_v`` is split by KV head
too, where the reference replicates it: a rank's cross block reads only
its heads, which the kernel (K1) takes as contiguous rows, and the
rank's own ``wk`` / ``wv`` columns make exactly those heads.  Exported
blobs are gathered back to the unsharded layout (:func:`gather_heads`),
so their bytes, headers and CRCs do not depend on tp.

**The production (Megatron) layout**: :func:`param_shardings` (the
reference's specs under ``param_rules(train=)``, leaf by leaf in the
reference's tree), :func:`opt_state_specs`, :func:`cache_shardings` and
:func:`batch_shardings` are pure placement functions held to the
reference's.  :func:`param_shards` cuts rank r's piece of a parameter
tree by those rules: ``wq`` / ``wk`` / ``wv`` by head columns and ``wo``
by the matching rows (row-parallel); ``wg`` / ``wu`` by ``ff`` columns
and ``wd`` by rows; the embedding by vocab rows and an untied
``unembed`` by vocab columns; a MoE block's experts on the ``expert``
axis when E divides the group, else each expert's ``eff`` (the
used-axis fallback of ``logical_to_spec``), its shared expert's ``sg``
/ ``su`` by columns and ``sd`` by rows; the router, the norms and every
Mamba2 leaf whole.  Whole heads stay on a rank: an attention block
whose query or KV heads do not divide the group is replicated whole
(every rank runs it whole), where the reference's guard would split
``wk`` mid-head or replicate only the KV leaves; so is an MLP whose
``ff`` does not divide, and the embedding when the vocabulary does not.
In training the ``embed`` axis (d_model) of every leaf that has one is
then cut on the rank's ``data`` index (FSDP, ``param_rules(train=True)``:
:func:`data_piece`); each block gathers its pieces whole over ``data``
as it runs (``transformer._Layout.weights``).  :func:`gather_params` is
the inverse (a collective).  With the data axes over ranks a step's
inputs are the rank's rows (:func:`batch_shards`, their span under
:data:`BATCH_SPAN`, as :func:`batch_shardings` places them), and so are
the cache's (:func:`init_cache`).

The step builders are plain functions over a rank's shards and rows:
:func:`build_train_step` (GRPO loss over the whole batch, its gradient
summed over the data-parallel group, AdamW with the global norm taken
over the whole model), :func:`build_prefill_step`
(the contiguous prefill), :func:`build_serve_step` (one greedy token),
:func:`build_verify_step` (γ+1 greedy targets) and
:func:`build_tree_verify_step` (through K2), all on k ranks.  The cached
steps run on a rank's piece of the cache (:func:`init_cache`,
:func:`cache_shards`; :func:`gather_cache` is the inverse), laid out as
:func:`cache_shardings` places it: every leaf's rows over the data
axes, ``k`` / ``v`` and ``slot_pos`` split along the sequence over
``model``, each rank attending its own slots through K1 / K2 and the
ranks merging the softmax partials (``sharding.merge_ranks``).
``lower_pair`` (and ``launch/dryrun.py``) lower the steps to HLO for TPU
pod meshes and have no counterpart: a PyTorch program has no HLO to
lower.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from repro_torch.configs.base import InputShape, ModelConfig
from repro_torch.sharding import (HeadShard, ShardCtx, all_gather,
                                  all_gather_parts, all_reduce,
                                  exact_col_spec, head_shard,
                                  logical_to_spec, param_rules, split_range)

# the key of a production cache piece's span: an int64 CPU tensor
# [lo, hi, S], the rank's slots [lo, hi) of a cache of S (read on the
# host, no device sync)
SEQ_SPAN = "seq_span"
# the key of the span of a batch's (or a cache's) rows where a rank holds
# a piece of them (the data axes over ranks): an int64 CPU tensor [lo,
# hi, B], the rows [lo, hi) of B
BATCH_SPAN = "batch_span"
SPANS = (SEQ_SPAN, BATCH_SPAN)
# the step inputs split by rows (``batch_shards``)
ROW_INPUTS = ("tokens", "loss_mask", "old_logprobs", "positions",
              "advantages", "image_embeds", "audio_frames", "staleness",
              "slot_index", "mask", "within")
# the rows' dim of each cache leaf (1 where not listed)
ROW_DIM = {"slot_pos": 0}

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
    if "in_proj" in block:
        return "mamba"
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


# ---------------------------------------------------------------------------
# the production layout: placements
# ---------------------------------------------------------------------------


def _attn_axes(cfg: ModelConfig) -> dict:
    d, hd = cfg.d_model, cfg.head_dim
    return {"ln": (("norm",), (d,)),
            "wq": (("embed", "heads"), (d, cfg.num_heads * hd)),
            "wk": (("embed", "kv"), (d, cfg.num_kv_heads * hd)),
            "wv": (("embed", "kv"), (d, cfg.num_kv_heads * hd)),
            "wo": (("heads", "embed"), (cfg.num_heads * hd, d))}


def _mlp_axes(cfg: ModelConfig) -> dict:
    d, f = cfg.d_model, cfg.d_ff
    return {"ln": (("norm",), (d,)), "wg": (("embed", "ff"), (d, f)),
            "wu": (("embed", "ff"), (d, f)), "wd": (("ff", "embed"), (f, d))}


def _moe_axes(cfg: ModelConfig) -> dict:
    d, E = cfg.d_model, cfg.num_experts
    eff = cfg.moe_d_ff or cfg.d_ff
    out = {"router": (("embed", "expert"), (d, E)),
           "wg": (("expert", "embed", "eff"), (E, d, eff)),
           "wu": (("expert", "embed", "eff"), (E, d, eff)),
           "wd": (("expert", "eff", "embed"), (E, eff, d))}
    if cfg.num_shared_experts:
        sf = cfg.num_shared_experts * eff
        out.update(sg=(("embed", "ff"), (d, sf)),
                   su=(("embed", "ff"), (d, sf)),
                   sd=(("ff", "embed"), (sf, d)))
    return out


def _mamba_axes(cfg: ModelConfig) -> dict:
    d, di = cfg.d_model, cfg.d_inner
    G, N, nh = cfg.ssm_ngroups, cfg.ssm_state, cfg.ssm_nheads
    ch = di + 2 * G * N
    return {"ln": (("norm",), (d,)),
            "in_proj": (("embed", "ssm_in"), (d, 2 * di + 2 * G * N + nh)),
            "conv_w": (("conv", "ssm_in"), (cfg.ssm_conv, ch)),
            "conv_b": (("ssm_in",), (ch,)), "A_log": (("norm",), (nh,)),
            "dt_bias": (("norm",), (nh,)), "D": (("norm",), (nh,)),
            "gn": (("ssm_in",), (di,)),
            "out_proj": (("ssm_in", "embed"), (di, d))}


def _stack(n: int, tree: dict) -> dict:
    """``tree`` stacked n times: a leading "layers" axis on every leaf."""
    return {k: _stack(n, v) if isinstance(v, dict)
            else (("layers",) + v[0], (n,) + v[1]) for k, v in tree.items()}


def param_axes(cfg: ModelConfig) -> dict:
    """The reference's parameter tree (``init_params``: stacked layers,
    experts as (E, d, eff)) with each leaf's (logical axes, shape)."""
    d, V, L = cfg.d_model, cfg.vocab_size, cfg.num_layers
    out = {"embed": (("vocab", "embed"), (V, d))}
    if not cfg.tie_embeddings:
        out["unembed"] = (("embed", "vocab"), (d, V))
    out["final_ln"] = (("norm",), (d,))
    dense = {"attn": _attn_axes(cfg), "mlp": _mlp_axes(cfg)}
    at = cfg.arch_type
    if at == "dense":
        out["layers"] = _stack(L, dense)
    elif at == "moe":
        nd = cfg.first_dense_layers
        if nd:
            out["dense_layers"] = _stack(nd, dense)
        out["layers"] = _stack(L - nd, {"attn": _attn_axes(cfg),
                                        "ln2": (("norm",), (d,)),
                                        "moe": _moe_axes(cfg)})
    elif at == "ssm":
        out["layers"] = _stack(L, _mamba_axes(cfg))
    elif at == "hybrid":
        every = cfg.hybrid_attn_every
        n_cells = L // every
        out["cells"] = _stack(n_cells, {"ssm": _stack(every,
                                                      _mamba_axes(cfg))})
        if L - n_cells * every:
            out["tail"] = _stack(L - n_cells * every, _mamba_axes(cfg))
        out["shared_attn"] = _attn_axes(cfg)
        out["shared_mlp"] = _mlp_axes(cfg)
    elif at == "vlm":
        every = cfg.cross_attn_every
        out["cells"] = _stack(L // every, {"self": _stack(every, dense),
                                           "cross": _attn_axes(cfg)})
    elif at == "audio":
        out["enc_layers"] = _stack(cfg.encoder_layers, dense)
        out["dec_layers"] = _stack(L, {"attn": _attn_axes(cfg),
                                       "cross": _attn_axes(cfg),
                                       "mlp": _mlp_axes(cfg)})
    else:
        raise ValueError(at)
    return out


def _map_axes(fn, tree):
    return {k: _map_axes(fn, v) if isinstance(v, dict) else fn(*v)
            for k, v in tree.items()}


def param_shardings(cfg: ModelConfig, sctx: ShardCtx, *, train: bool) -> dict:
    """The reference's ``param_shardings``: each leaf's spec under
    ``param_rules(sctx, train)``, in the reference's tree (every layer
    list stacked).  :func:`param_shards` cuts the pieces."""
    rules = param_rules(sctx, train)
    return _map_axes(lambda axes, shape: logical_to_spec(axes, rules, sctx,
                                                         shape),
                     param_axes(cfg))


def opt_state_specs(param_specs: dict):
    """AdamW's state on its parameters' shards (the reference's
    ``opt_state_specs``): an ``OptState`` of specs, both moments sharing
    each leaf's, the step count replicated."""
    from repro_torch.training.optim import OptState
    return OptState(step=(), mu=param_specs, nu=param_specs)


def _guard(size: int, axes, sctx: ShardCtx):
    """``axes`` when they divide ``size`` and span more than one rank."""
    if axes is None:
        return None
    if isinstance(axes, str):
        axes = (axes,)
    n = 1
    for a in axes:
        n *= sctx.axis_size(a)
    if size % n == 0 and n > 1:
        return axes if len(axes) > 1 else axes[0]
    return None


def cache_shardings(cfg: ModelConfig, sctx: ShardCtx, cache_tree: dict
                    ) -> dict:
    """The production prefill / serve cache's spec per leaf name (the
    reference's ``cache_shardings``): batch over the data axes and the
    cache's sequence on ``model``.  :func:`cache_shards` cuts the pieces
    of the ``model`` axis as these specs place them, with two
    differences: ``conv`` and ``ssm`` stay whole on every rank, where the
    reference splits them by channel and by head, because the Mamba2
    weights are whole on every rank (``param_rules`` leaves them
    replicated) and each rank runs the blocks whole; and ``cross_k`` /
    ``cross_v`` hold the rank's KV heads (whole where the heads do not
    divide the group), where the reference replicates them, because a
    rank's cross block attends on its own heads, which its own ``wk`` /
    ``wv`` columns make."""
    dp = tuple(sctx.dp)

    def spec_for(key, shape):
        def b_ax(i):
            return _guard(shape[i], dp, sctx)

        def t_ax(i):
            return _guard(shape[i], sctx.tp, sctx)
        if key in ("k", "v"):
            return (None, b_ax(1), t_ax(2), None, None)
        if key == "slot_pos":
            return (b_ax(0), t_ax(1))
        if key in ("cross_k", "cross_v"):
            return (None, b_ax(1), None, None, None)
        if key == "conv":
            return (None, b_ax(1), None, t_ax(3))
        if key == "ssm":
            return (None, b_ax(1), t_ax(2), None, None)
        return ()
    return {k: spec_for(k, tuple(v.shape)) for k, v in cache_tree.items()}


def batch_shardings(cfg: ModelConfig, sctx: ShardCtx, shape: InputShape,
                    specs: dict) -> dict:
    """The spec of each input of one (arch, shape) step (the reference's
    ``batch_shardings``): ``specs`` maps names to anything with a
    ``shape`` (``cache`` to the cache's leaves)."""
    out = {}
    for key, spec in specs.items():
        if key == "cache":
            out[key] = cache_shardings(cfg, sctx, spec)
            continue
        b = _guard(spec.shape[0], tuple(sctx.dp), sctx)
        if key in ("tokens", "loss_mask", "old_logprobs", "positions"):
            out[key] = (b, None)
        elif key == "advantages":
            out[key] = (b,)
        elif key in ("image_embeds", "audio_frames"):
            out[key] = (b, None, None)
        else:
            out[key] = ()
    return out


# ---------------------------------------------------------------------------
# the production layout: a rank's pieces
# ---------------------------------------------------------------------------


class Piece(NamedTuple):
    """Where a rank's piece of a leaf (in the port's layout) lies: the
    range ``[lo, hi)`` of dim ``dim``; ``groups`` > 0 when that dim is
    ``groups`` experts side by side and the range is taken in each."""
    dim: int
    lo: int
    hi: int
    groups: int = 0


def attn_whole(cfg: ModelConfig, sctx: Optional[ShardCtx]) -> bool:
    """Whether the production layout runs an attention block whole on
    every rank: its query or KV heads do not divide the group (whole
    heads stay on a rank)."""
    tp = 1 if sctx is None else sctx.tp_size
    return tp == 1 or cfg.num_heads % tp != 0 or cfg.num_kv_heads % tp != 0


def mlp_whole(cfg: ModelConfig, sctx: Optional[ShardCtx]) -> bool:
    tp = 1 if sctx is None else sctx.tp_size
    return tp == 1 or cfg.d_ff % tp != 0


def vocab_whole(cfg: ModelConfig, sctx: Optional[ShardCtx]) -> bool:
    tp = 1 if sctx is None else sctx.tp_size
    return tp == 1 or cfg.vocab_size % tp != 0


def experts_split(cfg: ModelConfig, sctx: ShardCtx) -> str:
    """How the production layout splits a MoE block's experts: "expert"
    (E / tp whole experts a rank, when they divide) or "eff" (every
    expert's hidden dim)."""
    return "expert" if cfg.num_experts % sctx.tp_size == 0 else "eff"


def piece_of(cfg: ModelConfig, kind: str, name: str,
             sctx: Optional[ShardCtx]) -> Optional[Piece]:
    """Rank ``sctx.rank``'s piece of leaf ``name`` of a block of ``kind``
    ("attn", "mlp", "moe", "top"; "other" is whole) under the production
    rules, or None where it is whole."""
    if sctx is None or sctx.tp_size == 1:
        return None
    tp, r = sctx.tp_size, sctx.rank
    if kind == "attn" and name in ("wq", "wk", "wv", "wo"):
        if attn_whole(cfg, sctx):
            return None
        hs = heads_of(cfg, sctx)
        hd = cfg.head_dim
        lo, hi = (hs.q_lo, hs.q_hi) if name in ("wq", "wo") \
            else (hs.kv_lo, hs.kv_hi)
        return Piece(0 if name == "wo" else 1, lo * hd, hi * hd)
    if kind == "mlp" and name in ("wg", "wu", "wd"):
        if mlp_whole(cfg, sctx):
            return None
        lo, hi = split_range(cfg.d_ff, tp, r)
        return Piece(0 if name == "wd" else 1, lo, hi)
    if kind == "moe" and name in ("wg", "wu", "wd", "sg", "su", "sd"):
        E = cfg.num_experts
        eff = cfg.moe_d_ff or cfg.d_ff
        if name in ("sg", "su", "sd"):
            lo, hi = split_range(cfg.num_shared_experts * eff, tp, r)
            return Piece(0 if name == "sd" else 1, lo, hi)
        if experts_split(cfg, sctx) == "expert":
            lo, hi = split_range(E, tp, r)
            if name == "wd":
                return Piece(0, lo, hi)
            return Piece(1, lo * eff, hi * eff)
        lo, hi = split_range(eff, tp, r)
        if name == "wd":
            return Piece(1, lo, hi)
        return Piece(1, lo, hi, groups=E)
    if kind == "top" and name in ("embed", "unembed"):
        if vocab_whole(cfg, sctx):
            return None
        lo, hi = split_range(cfg.vocab_size, tp, r)
        return Piece(0 if name == "embed" else 1, lo, hi)
    return None


# the dim of the ``embed`` logical axis (d_model) in each leaf of the
# port's layout that has one: the FSDP cut of training
_EMBED_DIM = {("attn", "wq"): 0, ("attn", "wk"): 0, ("attn", "wv"): 0,
              ("attn", "wo"): 1, ("mlp", "wg"): 0, ("mlp", "wu"): 0,
              ("mlp", "wd"): 1, ("moe", "router"): 0, ("moe", "wg"): 0,
              ("moe", "wu"): 0, ("moe", "wd"): 2, ("moe", "sg"): 0,
              ("moe", "su"): 0, ("moe", "sd"): 1, ("mamba", "in_proj"): 0,
              ("mamba", "out_proj"): 1, ("top", "embed"): 1,
              ("top", "unembed"): 0}


def fsdp_size(sctx: Optional[ShardCtx]) -> int:
    """The ranks an ``embed`` dim is split over: the FSDP axis's size
    where it runs over ranks (a training context of ``launch.mesh``),
    else 1."""
    if sctx is None or sctx.fsdp is None or sctx.fsdp_group is None:
        return 1
    return sctx.axis_size(sctx.fsdp)


def data_piece(cfg: ModelConfig, kind: str, name: str,
               sctx: Optional[ShardCtx]) -> Optional[Piece]:
    """Rank ``sctx``'s piece of the ``embed`` dim of leaf ``name`` of a
    block of ``kind`` (FSDP: ``param_rules(train=True)`` puts ``embed``
    on ``data``, guarded on d_model dividing it), on its index on the
    FSDP axis; None where the leaf has no such dim, or it stays whole."""
    dim = _EMBED_DIM.get((kind, name))
    n = fsdp_size(sctx)
    if dim is None or n == 1 or cfg.d_model % n:
        return None
    lo, hi = split_range(cfg.d_model, n, sctx.axis_index(sctx.fsdp))
    return Piece(dim, lo, hi)


def _cut(t: torch.Tensor, pc: Optional[Piece]) -> torch.Tensor:
    """The piece ``pc`` of ``t``, a copy of its own (a view would keep
    the whole leaf's storage alive)."""
    if pc is None:
        return t
    if pc.groups:
        d = t.shape[0]
        return t.reshape(d, pc.groups, -1)[:, :, pc.lo:pc.hi].reshape(
            d, -1).contiguous()
    return t.narrow(pc.dim, pc.lo, pc.hi - pc.lo).clone(
        memory_format=torch.contiguous_format)


def walk_leaves(tree, fn, top: bool = True):
    """``tree`` with ``fn(leaf, kind, name)`` applied to every leaf, the
    kind of the block that holds it ("attn", "mlp", "moe", "mamba",
    "other"; "top" for the leaves of a whole tree's root, ``top``)."""
    if isinstance(tree, list):
        return [walk_leaves(x, fn, False) for x in tree]
    kind = _block_kind(tree)
    if kind == "other" and top:
        kind = "top"
    return {n: walk_leaves(v, fn, False) if isinstance(v, (dict, list))
            else fn(v, kind, n) for n, v in tree.items()}


def param_shards(cfg: ModelConfig, params: dict, sctx: Optional[ShardCtx]
                 ) -> dict:
    """This rank's pieces of a whole parameter tree under the production
    rules: the ``model`` cut (:func:`piece_of`), then in training the
    ``embed`` dim's cut on the rank's ``data`` index
    (:func:`data_piece`); whole leaves are the same tensors."""
    return walk_leaves(params, lambda t, kind, name: _cut(
        _cut(t, piece_of(cfg, kind, name, sctx)),
        data_piece(cfg, kind, name, sctx)))


def _gather_piece(t: torch.Tensor, pc: Optional[Piece], sctx) -> torch.Tensor:
    if pc is None:
        return t
    if not pc.groups:
        return all_gather(t, pc.dim, sctx)
    d = t.shape[0]
    return all_gather(t.reshape(d, pc.groups, 1, -1), 2, sctx).reshape(d, -1)


def gather_params(cfg: ModelConfig, shards: dict, sctx: Optional[ShardCtx]
                  ) -> dict:
    """The whole tree from every rank's :func:`param_shards` (a
    collective: the ``embed`` pieces gathered over ``data``, then the
    ``model`` pieces; whole leaves are returned as they are)."""
    data = None if sctx is None else sctx.over("data")
    return walk_leaves(shards, lambda t, kind, name: _gather_piece(
        _gather_piece(t.detach(), data_piece(cfg, kind, name, sctx), data),
        piece_of(cfg, kind, name, sctx), sctx))


def split_leaves(cfg: ModelConfig, params: dict, sctx: Optional[ShardCtx]
                 ) -> dict:
    """The tree with, at every leaf, the set of axes ("model", "data") on
    which a rank holds only a piece of it (empty where it is whole)."""
    return walk_leaves(params, lambda t, kind, name: frozenset(
        axis for axis, pc in (("model", piece_of(cfg, kind, name, sctx)),
                              ("data", data_piece(cfg, kind, name, sctx)))
        if pc is not None))


def production_global_norm(cfg: ModelConfig, grads: dict,
                           sctx: Optional[ShardCtx]) -> torch.Tensor:
    """The global norm of the whole model's gradient from this rank's
    pieces: a leaf's sum of squares is summed over every group it is
    split on (one all-reduce over ``model`` of the leaves split there,
    then one over ``data`` of the FSDP pieces), whole leaves count once
    (``pod`` holds copies); summed in the JAX leaf order as
    ``optim.global_norm`` sums."""
    from repro_torch.training.optim import _jax_order, jax_leaf, tree_items
    split = dict(tree_items(split_leaves(cfg, grads, sctx)))
    items = _jax_order(grads)
    sq = [torch.sum(torch.square(x.float())) for _, x in items]
    for axis, ctx in (("model", sctx),
                      ("data", None if sctx is None else sctx.over("data"))):
        cut = [i for i, (path, _) in enumerate(items) if axis in split[path]]
        if cut:
            summed = all_reduce(torch.stack([sq[i] for i in cut]), ctx)
            for j, i in enumerate(cut):
                sq[i] = summed[j]
    groups: dict = {}
    for (path, _), s in zip(items, sq):
        groups.setdefault(jax_leaf(path), []).append(s)
    leaves = [torch.stack(g).sum() if len(g) > 1 else g[0]
              for g in groups.values()]
    return torch.sqrt(torch.sum(torch.stack(leaves)))


# ---------------------------------------------------------------------------
# the production layout: the KV cache across ranks
# ---------------------------------------------------------------------------


def production(sctx: Optional[ShardCtx]) -> bool:
    """Whether ``sctx`` is the production layout's context over more than
    one rank (a ``model`` axis, or data axes, over ranks)."""
    return sctx is not None and not sctx.exact and (
        sctx.tp_size > 1 or sctx.dp_group is not None)


def batch_piece(B: int, sctx: Optional[ShardCtx]) -> tuple:
    """(lo, hi): the rows of a batch of B a rank holds: its even share on
    its place in the data-parallel group where the data axes run over
    ranks and divide B (the reference's ``_guard``), else all of them
    (the reference replicates the batch there)."""
    if sctx is None or sctx.dp_group is None:
        return 0, B
    n = sctx.dp_size()
    if n == 1 or B % n:
        return 0, B
    return split_range(B, n, sctx.dp_rank)


def rows_ctx(sctx: Optional[ShardCtx], pieces: dict) -> Optional[ShardCtx]:
    """The context a step runs ``pieces`` (a batch, or a cache) under:
    ``sctx`` where they hold a piece of the batch's rows
    (:data:`BATCH_SPAN`), else ``sctx.rows_whole()``: the rows are whole
    on every rank, and nothing is summed over the data-parallel
    group."""
    if sctx is None or sctx.dp_group is None:
        return sctx
    span = pieces.get(BATCH_SPAN)
    if span is not None and int(span[1]) - int(span[0]) != int(span[2]):
        return sctx
    return sctx.rows_whole()


def batch_shards(cfg: ModelConfig, sctx: Optional[ShardCtx], batch: dict
                 ) -> dict:
    """This rank's rows of a step's inputs (``batch``: name -> tensor
    with the rows first), as :func:`batch_shardings` places them: the
    rows :func:`batch_piece` gives of ``tokens``, ``loss_mask``,
    ``old_logprobs``, ``positions``, ``advantages`` and the modality
    inputs, and of ``staleness`` (which the reference replicates and
    GSPMD cuts where it meets the mask) and the tree-verify step's
    ``slot_index``, ``mask`` and ``within`` (``lower_pair`` places them
    on the batch axes); every other input whole.  The rows' span is put
    under :data:`BATCH_SPAN`.  Where the rows are whole on every rank,
    ``batch`` as it is."""
    B = batch["tokens"].shape[0]
    lo, hi = batch_piece(B, sctx)
    if hi - lo == B:
        return batch
    out = {k: (v[lo:hi] if k in ROW_INPUTS else v)
           for k, v in batch.items()}
    out[BATCH_SPAN] = torch.tensor([lo, hi, B], dtype=torch.int64)
    return out


def seq_piece(S: int, sctx: Optional[ShardCtx]) -> tuple:
    """(lo, hi): the slots of a cache of S a rank holds: its
    ``split_range`` where S divides the group, else all of them (the
    reference's guard replicates the cache there)."""
    if not production(sctx) or S % sctx.tp_size:
        return 0, S
    return split_range(S, sctx.tp_size, sctx.rank)


def cross_heads(cfg: ModelConfig, sctx: Optional[ShardCtx]) -> tuple:
    """(lo, hi): the KV heads of the cross-attention memory a rank
    holds under the production layout: its own where attention splits,
    all where it runs whole."""
    if not production(sctx) or attn_whole(cfg, sctx):
        return 0, cfg.num_kv_heads
    hs = heads_of(cfg, sctx)
    return hs.kv_lo, hs.kv_hi


def span_of(cache: dict) -> tuple:
    """(lo, hi, S) of a cache: a piece's span, or the whole of a cache
    with none (every rank holds it whole)."""
    span = cache.get(SEQ_SPAN)
    if span is not None:
        lo, hi, S = (int(x) for x in span)
        return lo, hi, S
    S = cache["slot_pos"].shape[1]
    return 0, S, S


def _with_scratch_copy(t: torch.Tensor, dim: int, fill) -> torch.Tensor:
    """A copy of ``t`` in a buffer one slot wider along ``dim`` (the
    scratch slot, set to ``fill``), as ``transformer.init_cache`` lays a
    cache out: the view of its first slots."""
    shape = list(t.shape)
    shape[dim] += 1
    buf = torch.full(shape, fill, dtype=t.dtype, device=t.device)
    view = buf.narrow(dim, 0, t.shape[dim])
    view.copy_(t)
    return view


# what a piece's scratch slot holds: no key, an empty position
_FILL = {"k": 0, "v": 0, "slot_pos": -1}


def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               sctx: Optional[ShardCtx], dtype=None, device=None) -> dict:
    """A rank's empty piece of the production cache of ``batch`` rows and
    ``max_len`` positions (:func:`cache_shards` of
    ``transformer.init_cache``'s): its rows (:func:`batch_piece`, every
    leaf), its slots [lo, hi) of ``k`` / ``v`` (every KV head) and
    ``slot_pos``, with its own scratch slot past its last real one;
    ``conv`` / ``ssm`` whole but for the rows; ``cross_k`` / ``cross_v``
    on the rank's KV heads; the spans under :data:`SEQ_SPAN` and
    :data:`BATCH_SPAN`.  Without a production context over ranks,
    ``transformer.init_cache`` itself."""
    from repro_torch.models import transformer
    if not production(sctx):
        return transformer.init_cache(cfg, batch, max_len, dtype, device,
                                      sctx)
    S = transformer.cache_len_for(cfg, max_len)
    lo, hi = seq_piece(S, sctx)
    b0, b1 = batch_piece(batch, sctx)
    cache = transformer.init_cache(cfg, b1 - b0, hi - lo, dtype, device)
    h0, h1 = cross_heads(cfg, sctx)
    for name in ("cross_k", "cross_v"):
        if name in cache and h1 - h0 != cfg.num_kv_heads:
            cache[name] = cache[name][..., h0:h1, :].contiguous()
    if "slot_pos" in cache:
        cache[SEQ_SPAN] = torch.tensor([lo, hi, S], dtype=torch.int64)
    if b1 - b0 != batch:
        cache[BATCH_SPAN] = torch.tensor([b0, b1, batch], dtype=torch.int64)
    return cache


def cache_shards(cfg: ModelConfig, cache: dict, sctx: Optional[ShardCtx]
                 ) -> dict:
    """This rank's piece of a whole cache (``transformer.init_cache``'s
    layout, the one-device cache), a copy: :func:`init_cache`'s layout
    holding the cache's values.  Without a production context over
    ranks, the cache itself."""
    from repro_torch.models.transformer import POSITION_DIM
    if not production(sctx):
        return cache
    out = {}
    span = None
    name0 = next(n for n in cache if n not in SPANS)
    B = cache[name0].shape[ROW_DIM.get(name0, 1)]
    b0, b1 = batch_piece(B, sctx)
    if "slot_pos" in cache:
        S = cache["slot_pos"].shape[1]
        lo, hi = seq_piece(S, sctx)
        span = torch.tensor([lo, hi, S], dtype=torch.int64)
    h0, h1 = cross_heads(cfg, sctx)
    for name, t in cache.items():
        if name in SPANS:
            continue
        t = t.narrow(ROW_DIM.get(name, 1), b0, b1 - b0)
        if name in POSITION_DIM:
            dim = POSITION_DIM[name]
            out[name] = _with_scratch_copy(t.narrow(dim, lo, hi - lo), dim,
                                           _FILL[name])
        elif name in ("cross_k", "cross_v"):
            out[name] = t[..., h0:h1, :].contiguous()
        else:
            out[name] = t.clone()
    if span is not None:
        out[SEQ_SPAN] = span
    if b1 - b0 != B:
        out[BATCH_SPAN] = torch.tensor([b0, b1, B], dtype=torch.int64)
    return out


def gather_cache(cfg: ModelConfig, shards: dict, sctx: Optional[ShardCtx]
                 ) -> dict:
    """The whole cache from every rank's piece (the inverse of
    :func:`cache_shards`, a collective): the rows gathered over the
    data-parallel group, ``k`` / ``v`` / ``slot_pos`` along the sequence
    in rank order, the cross-attention memory along its heads, in
    ``transformer.init_cache``'s layout (scratch slots included);
    ``conv`` / ``ssm`` but for their rows as they are.  A cache held
    whole on every rank comes back as it is."""
    from repro_torch.models.transformer import POSITION_DIM
    if not production(sctx):
        return shards
    out = {}
    lo, hi, S = span_of(shards) if "slot_pos" in shards else (0, 0, 0)
    rows = BATCH_SPAN in shards
    dp = sctx.over("dp")
    h0, h1 = cross_heads(cfg, sctx)
    for name, t in shards.items():
        if name in SPANS:
            continue
        if rows:
            t = all_gather(t, ROW_DIM.get(name, 1), dp)
        if name in POSITION_DIM:
            dim = POSITION_DIM[name]
            whole = t if hi - lo == S else all_gather(t, dim, sctx)
            out[name] = _with_scratch_copy(whole, dim, _FILL[name])
        elif name in ("cross_k", "cross_v") and h1 - h0 != cfg.num_kv_heads:
            out[name] = all_gather(t, -2, sctx)
        else:
            out[name] = t
    return out


# ---------------------------------------------------------------------------
# the production layout: step builders
# ---------------------------------------------------------------------------


def build_train_step(cfg: ModelConfig, sctx: Optional[ShardCtx], gcfg=None,
                     ocfg=None):
    """``train_step(params, opt_state, batch) -> (params, opt_state, loss,
    metrics)`` over this rank's pieces (:func:`param_shards` of f32
    masters that require gradients, ``optim.init_opt_state`` of them)
    and its rows of the batch (:func:`batch_shards`): ``grpo_loss`` under
    ``sctx``, its gradient (each piece's own, the whole leaves' complete
    on every rank: the forward's collectives carry their adjoints, and
    with the data axes over ranks each block's FSDP gather
    reduce-scatters its gradient over ``data`` and each leaf whole on
    ``data`` sums its own over the data-parallel group), then AdamW on
    the rank's pieces in place, clipped by the whole model's gradient
    norm (:func:`production_global_norm`).  The reference's step returns
    (params, opt_state, loss); ``metrics`` adds grad_norm and lr."""
    from repro_torch.training.grpo import GRPOConfig, grpo_loss
    from repro_torch.training.optim import (OptConfig, adamw_update,
                                            tree_items, tree_rebuild)
    gcfg = gcfg or GRPOConfig()
    ocfg = ocfg or OptConfig()

    def train_step(params, opt_state, batch: dict):
        loss, metrics = grpo_loss(cfg, params, batch, gcfg=gcfg, sctx=sctx)
        leaves = [t for _, t in tree_items(params)]
        grads = tree_rebuild(params, torch.autograd.grad(loss, leaves))
        gnorm = production_global_norm(cfg, grads, sctx)
        params, opt_state, om = adamw_update(ocfg, params, grads, opt_state,
                                             grad_norm=gnorm)
        metrics.update(om)
        return params, opt_state, loss.detach(), metrics

    return train_step


def build_prefill_step(cfg: ModelConfig, sctx: Optional[ShardCtx]):
    """``prefill_step(params, tokens, positions, cache, **aux) -> cache``:
    the production prefill, every row writing slots [start, start+T) of
    the cache (``forward(contiguous_update=True)``; start is the first
    row's, which every row shares), in place.  On k ranks ``params`` are
    the rank's :func:`param_shards` and ``cache`` its piece
    (:func:`init_cache`, :func:`cache_shards`), and with the data axes
    over ranks the inputs are the rank's rows (:func:`batch_shards`), as
    for every cached builder below."""
    from repro_torch.models.transformer import forward

    @torch.no_grad()
    def prefill_step(params, tokens, positions, cache, **aux):
        _, cache, _ = forward(cfg, params, tokens, positions, cache,
                              aux_inputs=aux or None, sctx=sctx,
                              contiguous_update=True, logits=False)
        return cache

    return prefill_step


def _greedy(logits: torch.Tensor) -> torch.Tensor:
    return torch.argmax(logits.float(), dim=-1).to(torch.int32)


def build_serve_step(cfg: ModelConfig, sctx: Optional[ShardCtx]):
    """``serve_step(params, tokens, positions, cache) -> (next token (B,)
    int32, cache)``: one token appended, the greedy next one."""
    from repro_torch.models.transformer import forward

    @torch.no_grad()
    def serve_step(params, tokens, positions, cache):
        logits, cache, _ = forward(cfg, params, tokens, positions, cache,
                                   sctx=sctx)
        return _greedy(logits[:, -1]), cache

    return serve_step


def build_verify_step(cfg: ModelConfig, sctx: Optional[ShardCtx]):
    """``verify_step(params, tokens, positions, cache) -> (targets (B, T)
    int32, cache)``: γ+1 candidates scored in one forward, the greedy
    target at each."""
    from repro_torch.models.transformer import forward

    @torch.no_grad()
    def verify_step(params, tokens, positions, cache):
        logits, cache, _ = forward(cfg, params, tokens, positions, cache,
                                   sctx=sctx)
        return _greedy(logits), cache

    return verify_step


def build_tree_verify_step(cfg: ModelConfig, sctx: Optional[ShardCtx]):
    """``tree_verify_step(params, tokens, positions, slot_index, mask,
    within, cache) -> (targets (B, T) int32, cache)``: T tree nodes a row
    in one forward (``slot_index`` their slots, ``within`` (B, T, T)
    each node's ancestors, ``mask`` the live nodes), through K2."""
    from repro_torch.models.transformer import forward

    @torch.no_grad()
    def tree_verify_step(params, tokens, positions, slot_index, mask, within,
                         cache):
        logits, cache, _ = forward(cfg, params, tokens, positions, cache,
                                   token_mask=mask, slot_index=slot_index,
                                   within_mask=within, sctx=sctx)
        return _greedy(logits), cache

    return tree_verify_step
