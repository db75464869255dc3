"""Logical-axis sharding rules and the collectives of the port's tensor
parallelism.

Counterpart of ``repro.sharding``.  The reference maps each parameter's
logical axes (``models/common.Builder``) onto the axes of a JAX
``Mesh`` and lets GSPMD insert the collectives.  The port runs SPMD over
``torch.distributed`` instead: every rank runs the same host code and
holds its own shard of each sharded tensor, so a :class:`ShardCtx` names
a process group and this rank's place in it, and a placement function
answers, for one leaf, which dimension rank r splits (or none).  The
placement functions are the reference's, guard for guard, on one
tensor-parallel axis ``"model"``: :func:`logical_to_spec` (with its
used-axis bookkeeping), :func:`param_rules`, :func:`exact_col_spec`,
:func:`head_axis`, :func:`batch_axes` and :func:`seq_axis`.  They return
tuples of axis names (``None`` for a replicated dim) where the reference
returns a ``PartitionSpec``.  The production rules (``param_rules`` with
row-parallel ``wo`` / ``wd``, ``seq_axis``, FSDP) place the production
layout (``launch.steps.param_shards``, the cache-free forward); the
engine's token-exact path uses only :func:`exact_col_spec`,
:func:`head_axis` and :func:`head_shard`.

The reference's ``resolve_shard_map`` / ``shard_map_available`` shim
across JAX versions and have no counterpart; ``constrain`` (a GSPMD
annotation) neither: the port gathers explicitly.

The collectives sit here: :func:`all_gather` concatenates every rank's
piece in rank order (the token-exact layer gathers each activation
before the matmul whose reduction would otherwise be sharded), and
:func:`check_lockstep` compares a digest of a host batch across the
ranks, so ranks whose host decisions diverged fail at once instead of
deadlocking in the next collective.

The production (Megatron) layout's collectives are autograd functions,
each with its adjoint, so a train step differentiates through them:
:func:`reduce_from_ranks` (Megatron's *g*: a sum, whose backward is the
identity; the reference's ``psum``), :func:`copy_to_ranks` (*f*: the
identity, whose backward sums; where a replicated activation enters a
column-parallel product, or a whole parameter meets a partial
gradient), :func:`gather_seq` (all-gather along the sequence, whose
backward reduce-scatters), :func:`scatter_seq` (reduce-scatter along the
sequence, the reference's ``psum_scatter``, whose backward all-gathers),
and, for a region every rank computes whole, :func:`gather_whole`
(all-gather, whose backward keeps the rank's piece) and
:func:`split_seq` (the rank's piece, whose backward all-gathers).  Each
call adds its bytes to :data:`traffic`.

The data axes (``pod``, ``data``) over ranks add three, each over the
group of its axis (``ShardCtx.over``): :func:`fsdp_gather` (an FSDP
piece of a parameter gathered whole over ``data``; its backward
reduce-scatters the gradient over ``data`` and sums it over ``pod``),
:func:`data_whole` (a parameter whole on ``data``; its backward sums
the gradient over the data-parallel group) and :func:`dp_sum` (a term
of the loss summed over the data-parallel group; its backward is the
identity).  Where a step's batch is whole on every rank
(``ShardCtx.rows_whole``) no sum runs over the data axes and an FSDP
gather's backward keeps the rank's piece.

The production layout's cached steps (no backward) hold the KV cache
split along its sequence while the weights split by heads:
:func:`gather_heads` moves a step's q and new K/V from the rank's heads
to all of them (one all-gather), and :func:`merge_ranks` merges the
ranks' attention partials (K1 / K2's ``lse=True`` outputs over each
rank's slots) in rank order and hands each rank its heads.
"""
from __future__ import annotations

import zlib
from dataclasses import dataclass, replace
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

# Logical axis vocabulary of model init (the reference's):
#   layers        stacked-layer axis (never sharded)
#   embed         d_model rows (FSDP target in train mode)
#   heads, kv     attention head dims (merged H*hd)
#   ff            MLP hidden
#   vocab         embedding rows / logits
#   expert        MoE expert axis
#   eff           per-expert hidden
#   state, conv, ssm_in   mamba dims (replicated)
#   batch, seq, cache_seq activation/cache axes

TP_AXIS = "model"


@dataclass(frozen=True)
class ShardCtx:
    """One rank's view of a tensor-parallel group.

    ``group`` is the ``torch.distributed`` process group of the
    ``tp_size`` ranks that share each sharded tensor (None when
    ``tp_size`` is 1: nothing is sent), ``rank`` this process's index in
    it; ``host_group`` carries the host-side lockstep digests (a gloo
    group: the same group when the collectives run over gloo).
    ``dp``, ``fsdp``, ``seq_shard`` and ``exact`` mean what they mean in
    the reference; ``axis_sizes`` gives the size of each mesh axis the
    production rules may name (``{"model": tp_size}`` by default), so the
    pure placement functions can be held to the reference's on any
    mesh shape.

    The data axes over ranks (``launch.mesh``): ``coords`` this rank's
    index on each of them; ``dp_group`` the data-parallel group, the
    ranks that share this one's ``model`` index (the reference's ``dp``
    axes, ``pod`` then ``data``), which sums the batch's terms and the
    gradients, ``dp_rank`` this rank's place in it (row-major over
    ``dp``); ``fsdp_group`` the ranks along the FSDP axis (``data``: the
    same ``pod`` and ``model`` index), set in training only, whose ranks
    hold the pieces of each ``embed`` dim; ``pod_group`` the ranks along
    ``pod``.  None where an axis runs on no ranks: a hand-built context
    with a larger ``data`` axis and no group is a shape for the pure
    placement functions, and a MoE layer under it runs the data shards
    one after another (``models.moe.moe_capacity``).  A step whose batch
    is whole on every rank runs under :meth:`rows_whole` (no
    ``dp_group``: nothing to sum)."""
    group: object = None
    tp_size: int = 1
    rank: int = 0
    host_group: object = None
    backend: str = "gloo"
    dp: tuple = ()
    tp: str = TP_AXIS
    fsdp: Optional[str] = None
    seq_shard: bool = True
    exact: bool = False
    axis_sizes: Tuple[Tuple[str, int], ...] = ()
    coords: Tuple[Tuple[str, int], ...] = ()
    dp_group: object = None
    dp_rank: int = 0
    fsdp_group: object = None
    pod_group: object = None

    def axis_size(self, axis: str) -> int:
        if axis == self.tp:
            return self.tp_size
        return dict(self.axis_sizes).get(axis, 1)

    def axis_index(self, axis: str) -> int:
        """This rank's index on ``axis`` (0 where it runs on no ranks)."""
        if axis == self.tp:
            return self.rank
        return dict(self.coords).get(axis, 0)

    def dp_size(self) -> int:
        s = 1
        for a in self.dp:
            s *= self.axis_size(a)
        return s

    def over(self, axis: str) -> "ShardCtx":
        """The context of this rank's group along one data axis, for the
        collectives: "dp" (the data-parallel group), "data" (the FSDP
        group) or "pod".  Its ``tp`` names the axis (the key of its
        :data:`traffic`), ``tp_size`` is the group's size (1, nothing
        sent, where the axis runs on no ranks), ``rank`` this rank's
        place in it."""
        if axis == "dp":
            group, size, index = self.dp_group, self.dp_size(), self.dp_rank
        elif axis == "pod":
            group, size, index = (self.pod_group, self.axis_size("pod"),
                                  self.axis_index("pod"))
        else:
            group = self.fsdp_group
            size = self.axis_size(self.fsdp) if self.fsdp else 1
            index = self.axis_index(self.fsdp) if self.fsdp else 0
        if group is None:
            size, index = 1, 0
        return ShardCtx(group=group, tp_size=size, rank=index,
                        backend=self.backend, tp=axis)

    def rows_whole(self) -> "ShardCtx":
        """This context for a batch whole on every rank (the reference's
        guard replicates a batch that the data axes do not divide):
        every rank computes the whole loss and gradient, so no sum runs
        over ``dp`` and an FSDP gather's backward keeps the rank's
        piece."""
        return replace(self, dp_group=None)


def _mesh_axis_size(sctx: ShardCtx, axes) -> int:
    if axes is None:
        return 1
    if isinstance(axes, str):
        axes = (axes,)
    s = 1
    for a in axes:
        s *= sctx.axis_size(a)
    return s


def logical_to_spec(axes: tuple, rules: dict, sctx: ShardCtx,
                    shape: tuple) -> tuple:
    """Map one leaf's logical axes to a spec (one entry per dim: a mesh
    axis, a tuple of them, or None) with the divisibility guards; a mesh
    axis already used by another dim of the leaf is dropped."""
    out = []
    used = set()
    for dim, name in zip(shape, axes):
        mesh_axes = rules.get(name)
        if mesh_axes is None:
            out.append(None)
            continue
        if isinstance(mesh_axes, str):
            mesh_axes = (mesh_axes,)
        mesh_axes = tuple(a for a in mesh_axes if a not in used)
        size = _mesh_axis_size(sctx, mesh_axes)
        if mesh_axes and size > 0 and dim % size == 0:
            out.append(mesh_axes if len(mesh_axes) > 1 else mesh_axes[0])
            used.update(mesh_axes)
        else:
            out.append(None)
    return tuple(out)


def param_rules(sctx: ShardCtx, train: bool) -> dict:
    """The production (Megatron) rules: heads, kv, ff, vocab, expert and
    eff on the tensor-parallel axis (``expert`` first: ``eff`` is the
    fallback when the experts do not divide it), ``embed`` on the FSDP
    axis in training."""
    tp = sctx.tp
    rules = {
        "heads": tp, "kv": tp, "ff": tp, "vocab": tp,
        "expert": tp, "eff": tp,
        "embed": None, "state": None, "conv": None, "ssm_in": None,
        "layers": None, "norm": None,
    }
    if train and sctx.fsdp:
        rules["embed"] = sctx.fsdp
    return rules


def batch_axes(sctx: Optional[ShardCtx], batch_size: int):
    """Mesh axes for the batch dim, guarded on divisibility (a shorter
    prefix of ``dp`` when the whole does not divide)."""
    if sctx is None:
        return None
    axes = tuple(sctx.dp)
    if not axes:
        return None
    size = _mesh_axis_size(sctx, axes)
    if size and batch_size % size == 0:
        return axes
    for k in range(len(axes) - 1, 0, -1):
        sub = axes[:k]
        if batch_size % _mesh_axis_size(sctx, sub) == 0:
            return sub
    return None


def seq_axis(sctx: Optional[ShardCtx], seq_len: int):
    """The tensor-parallel axis for a residual sequence dim (Megatron
    sequence sharding), when ``seq_shard`` and it divides."""
    if sctx is None or not sctx.seq_shard:
        return None
    if seq_len % sctx.tp_size == 0:
        return sctx.tp
    return None


def head_axis(sctx: Optional[ShardCtx], n_heads: int):
    """The tensor-parallel axis for an attention-head dim, guarded on
    divisibility (4 KV heads on an 8-way axis stay replicated)."""
    if sctx is None:
        return None
    if n_heads % sctx.tp_size == 0:
        return sctx.tp
    return None


# The engine's token-exact rules: a weight dim is split iff it is the
# leaf's LAST dim and one of these column (matmul-output) axes, so no
# matmul's reduction is ever sharded; the row-parallel counterparts (wo,
# wd) stay whole and the model gathers the activation before them.
_EXACT_COL_AXES = frozenset({"heads", "kv", "ff", "eff", "vocab"})


def exact_col_spec(axes: tuple, shape: tuple, sctx: ShardCtx) -> tuple:
    """Column-parallel-only spec of one parameter leaf."""
    out = [None] * len(shape)
    if axes and axes[-1] in _EXACT_COL_AXES \
            and shape[-1] % sctx.tp_size == 0:
        out[-1] = sctx.tp
    return tuple(out)


class HeadShard(NamedTuple):
    """The query heads ``[q_lo, q_hi)`` and KV heads ``[kv_lo, kv_hi)``
    one rank holds of an attention layer."""
    q_lo: int
    q_hi: int
    kv_lo: int
    kv_hi: int


def head_shard(n_heads: int, n_kv: int, tp_size: int, rank: int) -> HeadShard:
    """Rank ``rank``'s heads of an attention layer of ``n_heads`` query
    and ``n_kv`` KV heads on a ``tp_size``-way group.

    Query heads split evenly where :func:`head_axis` allows (else every
    rank holds them all).  KV heads split evenly where they divide too;
    where they do not but the query heads do (4 query / 1 KV head on 2
    ranks), rank r holds the KV heads its query heads read, ``h //
    (n_heads / n_kv)``, so each rank's kernel sees a whole ratio of query
    to KV heads — a smaller one than the layer's when a rank holds fewer
    query heads than a KV group, which gives the attention's products
    other shapes (the tokens stay the one-device ones; f32 logprobs may
    move in the last bit).  When even that leaves a ragged ratio, the
    layer is replicated.  The reference splits ``wk`` by columns whenever they
    divide, in the middle of a head if need be, and GSPMD gathers what a
    head needs; the port keeps whole heads on a rank (its contract is
    the reference's tokens, not GSPMD's layout)."""
    if tp_size == 1 or n_heads % tp_size:
        return HeadShard(0, n_heads, 0, n_kv)
    hq = n_heads // tp_size
    q_lo = rank * hq
    if n_kv % tp_size == 0:
        hk = n_kv // tp_size
        return HeadShard(q_lo, q_lo + hq, rank * hk, rank * hk + hk)
    group = n_heads // n_kv
    if group % hq == 0 or hq % group == 0:
        kv_lo = q_lo // group
        return HeadShard(q_lo, q_lo + hq, kv_lo, kv_lo + max(1, hq // group))
    return HeadShard(0, n_heads, 0, n_kv)


def split_range(n: int, tp_size: int, rank: int) -> Tuple[int, int]:
    """Rank ``rank``'s contiguous piece of a dim of ``n`` split evenly."""
    step = n // tp_size
    return rank * step, (rank + 1) * step


# ---------------------------------------------------------------------------
# collectives
# ---------------------------------------------------------------------------

# collectives since the last reset, and the bytes each rank sent into
# them (its input as sent): those of the model axis unprefixed, those of
# a data axis (``ShardCtx.over``) under its name, "data_all_gather",
# "dp_all_reduce_bytes", ...
_OPS = ("all_gather", "all_reduce", "reduce_scatter")
traffic = {"all_gather": 0, "all_gather_bytes": 0, "lockstep": 0,
           "all_reduce": 0, "all_reduce_bytes": 0, "reduce_scatter": 0,
           "reduce_scatter_bytes": 0, "head_gather": 0, "merge_ranks": 0}
traffic.update({f"{axis}_{op}{unit}": 0 for axis in ("data", "pod", "dp")
                for op in _OPS for unit in ("", "_bytes")})


def reset_traffic() -> None:
    for name in traffic:
        traffic[name] = 0


def _count(op: str, sctx: ShardCtx, t: torch.Tensor) -> None:
    """One collective ``op`` of ``sctx``'s axis, ``t`` the tensor this
    rank sent into it."""
    key = op if sctx.tp == TP_AXIS else f"{sctx.tp}_{op}"
    traffic[key] += 1
    traffic[key + "_bytes"] += t.numel() * t.element_size()


def _wire(t: torch.Tensor) -> torch.Tensor:
    """A contiguous tensor any gloo build takes, bit for bit: 2-byte
    floats travel as bytes (a gather does no arithmetic; the last dim
    doubles and halves back)."""
    t = t.contiguous()
    if t.dtype in (torch.bfloat16, torch.float16):
        return t.view(torch.uint8)
    return t


def all_gather(t: torch.Tensor, dim: int, sctx: Optional[ShardCtx]
               ) -> torch.Tensor:
    """Every rank's ``t`` concatenated along ``dim`` in rank order (``t``
    itself on a one-rank context).  Over NCCL the gather runs on the
    card; over gloo a card tensor is staged through host memory (gloo
    gathers host tensors), which costs a device->host copy per call."""
    if sctx is None or sctx.tp_size == 1:
        return t
    import torch.distributed as dist
    wire = _wire(t)
    staged = wire.device.type == "cuda" and sctx.backend == "gloo"
    src = wire.cpu() if staged else wire
    parts = [torch.empty_like(src) for _ in range(sctx.tp_size)]
    dist.all_gather(parts, src, group=sctx.group)
    out = torch.cat(parts, dim=dim)
    if staged:
        out = out.to(t.device)
    _count("all_gather", sctx, src)
    return out.view(t.dtype) if out.dtype != t.dtype else out


def whole_columns(t: torch.Tensor, full: int,
                  sctx: Optional[ShardCtx]) -> torch.Tensor:
    """``t`` (..., n) whole: gathered from every rank (in rank order) when
    it is a shard of a dim ``full`` wide.  The exact layers gather each
    activation before the matmul that would reduce over its sharded dim
    (``wo``, ``wd``, sampling), so every reduction keeps its one-device
    order (the reference's ``constrain(..., None)`` of the exact
    mode)."""
    if sctx is None or t.shape[-1] == full:
        return t
    return all_gather(t, -1, sctx)


def all_gather_parts(t: torch.Tensor, sctx: ShardCtx) -> list:
    """Every rank's ``t`` as a list in rank order (the pieces of a leaf
    whose ranks may hold overlapping ranges)."""
    if sctx.tp_size == 1:
        return [t]
    whole = all_gather(t.unsqueeze(0), 0, sctx)
    return list(whole.unbind(0))


def _host_or_card(t: torch.Tensor, sctx: ShardCtx):
    """(the tensor a collective sends, whether it was staged): gloo sums
    host tensors, so a card tensor goes through host memory there."""
    t = t.contiguous()
    staged = t.device.type == "cuda" and sctx.backend == "gloo"
    return (t.cpu() if staged else t), staged


def all_reduce(t: torch.Tensor, sctx: Optional[ShardCtx]) -> torch.Tensor:
    """The sum of every rank's ``t`` (a new tensor; ``t`` itself on a
    one-rank context)."""
    if sctx is None or sctx.tp_size == 1:
        return t
    import torch.distributed as dist
    src, staged = _host_or_card(t, sctx)
    out = src.clone() if src is t else src
    dist.all_reduce(out, group=sctx.group)
    _count("all_reduce", sctx, out)
    return out.to(t.device) if staged else out


def reduce_scatter(t: torch.Tensor, dim: int, sctx: Optional[ShardCtx]
                   ) -> torch.Tensor:
    """This rank's piece, along ``dim``, of the sum of every rank's ``t``
    (``dim`` divides evenly; rank r takes the r-th piece)."""
    if sctx is None or sctx.tp_size == 1:
        return t
    import torch.distributed as dist
    src, staged = _host_or_card(t.movedim(dim, 0), sctx)
    out = src.new_empty((src.shape[0] // sctx.tp_size,) + src.shape[1:])
    dist.reduce_scatter_tensor(out, src, group=sctx.group)
    _count("reduce_scatter", sctx, src)
    out = out.movedim(0, dim)
    return out.to(t.device) if staged else out


def piece(t: torch.Tensor, dim: int, sctx: Optional[ShardCtx]
          ) -> torch.Tensor:
    """This rank's contiguous piece of ``t`` along ``dim``."""
    if sctx is None or sctx.tp_size == 1:
        return t
    lo, hi = split_range(t.shape[dim], sctx.tp_size, sctx.rank)
    return t.narrow(dim, lo, hi - lo)


def _run(op: str, t: torch.Tensor, dim: int, sctx: ShardCtx):
    if op == "id":
        return t.view_as(t)
    if op == "sum":
        return all_reduce(t, sctx)
    if op == "gather":
        return all_gather(t, dim, sctx)
    if op == "scatter":
        return reduce_scatter(t, dim, sctx)
    return piece(t, dim, sctx).contiguous()


class _Collective(torch.autograd.Function):
    """A collective ``fwd`` whose backward is the collective ``bwd`` (its
    adjoint): "id", "sum" (all-reduce), "gather" (all-gather along
    ``dim``), "scatter" (reduce-scatter along ``dim``) or "piece" (the
    rank's slice along ``dim``)."""

    @staticmethod
    def forward(ctx, t, fwd, bwd, dim, sctx):
        ctx.back = (bwd, dim, sctx)
        return _run(fwd, t, dim, sctx)

    @staticmethod
    def backward(ctx, grad):
        bwd, dim, sctx = ctx.back
        return _run(bwd, grad, dim, sctx), None, None, None, None


def _collective(t, fwd, bwd, dim, sctx):
    if sctx is None or sctx.tp_size == 1:
        return t
    return _Collective.apply(t, fwd, bwd, dim, sctx)


def copy_to_ranks(t: torch.Tensor, sctx: Optional[ShardCtx]) -> torch.Tensor:
    """Megatron's *f*: ``t`` as it is; its gradient summed over the ranks
    (each rank's is a partial)."""
    return _collective(t, "id", "sum", 0, sctx)


def reduce_from_ranks(t: torch.Tensor, sctx: Optional[ShardCtx]
                      ) -> torch.Tensor:
    """Megatron's *g*: the sum of every rank's partial ``t``; the
    gradient passes to each rank as it is."""
    return _collective(t, "sum", "id", 0, sctx)


def gather_seq(t: torch.Tensor, sctx: Optional[ShardCtx], dim: int = 1
               ) -> torch.Tensor:
    """Every rank's sequence piece, gathered along ``dim`` in rank order,
    into a region whose gradient is a partial on each rank: the backward
    reduce-scatters it."""
    return _collective(t, "gather", "scatter", dim, sctx)


def scatter_seq(t: torch.Tensor, sctx: Optional[ShardCtx], dim: int = 1
                ) -> torch.Tensor:
    """This rank's sequence piece of the sum of every rank's partial
    ``t`` (reduce-scatter along ``dim``); the backward all-gathers."""
    return _collective(t, "scatter", "gather", dim, sctx)


def gather_whole(t: torch.Tensor, sctx: Optional[ShardCtx], dim: int = 1
                 ) -> torch.Tensor:
    """Every rank's piece gathered along ``dim`` into a region every rank
    computes whole (so each sees the whole gradient): the backward keeps
    this rank's piece of it."""
    return _collective(t, "gather", "piece", dim, sctx)


def split_seq(t: torch.Tensor, sctx: Optional[ShardCtx], dim: int = 1
              ) -> torch.Tensor:
    """This rank's piece, along ``dim``, of a ``t`` every rank holds
    whole; the backward all-gathers the pieces' gradients."""
    return _collective(t, "piece", "gather", dim, sctx)


def fsdp_gather(t: torch.Tensor, dim: int, sctx: ShardCtx) -> torch.Tensor:
    """A parameter's pieces of its ``embed`` dim ``dim`` (FSDP), gathered
    whole over the ``data`` axis in rank order, for the sub-layer that
    uses it.  The backward: each rank's gradient of the whole leaf (a
    partial, over its rows of the batch) reduce-scattered, summed, back
    to the rank's piece over ``data``, then summed over ``pod``.  Where
    the batch is whole on every rank (no ``dp_group``: each rank holds
    the whole gradient), the rank's piece of it, as :func:`gather_whole`
    keeps."""
    data = sctx.over("data")
    if sctx.dp_group is None:
        return _collective(t, "gather", "piece", dim, data)
    t = copy_to_ranks(t, sctx.over("pod"))
    return _collective(t, "gather", "scatter", dim, data)


def data_whole(t: torch.Tensor, sctx: Optional[ShardCtx]) -> torch.Tensor:
    """A parameter whole on the data axes (a norm, or a leaf whose
    ``embed`` dim the ``data`` axis does not divide): itself; its
    gradient, a partial over this rank's rows, summed over the
    data-parallel group (the identity where the batch is whole on every
    rank)."""
    if sctx is None:
        return t
    return copy_to_ranks(t, sctx.over("dp"))


def dp_sum(t: torch.Tensor, sctx: Optional[ShardCtx]) -> torch.Tensor:
    """The sum over the data-parallel group of each rank's ``t`` (a term
    of the batch's loss over the rank's rows: the loss becomes the global
    batch's); the gradient passes to each rank as it is.  ``t`` itself
    where the batch is whole on every rank."""
    if sctx is None:
        return t
    return reduce_from_ranks(t, sctx.over("dp"))


def _no_grad(what: str, *ts: torch.Tensor) -> None:
    if torch.is_grad_enabled() and any(t.requires_grad for t in ts):
        raise RuntimeError(f"{what} has no backward: the cached steps run "
                           "under torch.no_grad")


def gather_heads(ts, sctx: Optional[ShardCtx]) -> list:
    """Each of ``ts`` (..., h_r, D) tensors of one dtype holding this
    rank's heads, whole: every rank's heads in rank order along dim -2
    (one all-gather for all of them; ``ts`` themselves on one rank or no
    context).  Under ``torch.no_grad`` only."""
    ts = list(ts)
    if sctx is None or sctx.tp_size == 1:
        return ts
    _no_grad("gather_heads", *ts)
    widths = [t.shape[-2] for t in ts]
    parts = all_gather_parts(torch.cat(ts, dim=-2), sctx)
    traffic["head_gather"] += 1
    pieces = [p.split(widths, dim=-2) for p in parts]
    return [torch.cat([pc[i] for pc in pieces], dim=-2)
            for i in range(len(ts))]


def merge_ranks(o: torch.Tensor, lse: torch.Tensor, sctx: Optional[ShardCtx],
                heads: Optional[Tuple[int, int]] = None) -> torch.Tensor:
    """The attention of every rank's share of the slots from each rank's
    partials, o (B, T, H, D) f32 and its log-sum-exp (B, T, H) f32 (K1 /
    K2 with ``lse=True`` on all H heads over this rank's slots): merged
    in rank order (``spec_verify.ref.merge_lse``), so a head's result
    does not depend on the rank that merges it.  ``heads`` (lo, hi): the
    heads this rank keeps (its query heads; all when None, where
    attention runs whole on every rank).  f32 out.  One all-gather of the
    partials; under ``torch.no_grad`` only."""
    from repro_torch.kernels.spec_verify.ref import merge_lse
    if heads is not None:
        lo, hi = heads
    else:
        lo, hi = 0, o.shape[2]
    if sctx is None or sctx.tp_size == 1:
        return o[:, :, lo:hi]
    _no_grad("merge_ranks", o, lse)
    parts = all_gather_parts(torch.cat([o, lse[..., None]], dim=-1), sctx)
    traffic["merge_ranks"] += 1
    return merge_lse([(p[:, :, lo:hi, :-1], p[:, :, lo:hi, -1])
                      for p in parts])


def batch_digest(*arrays: np.ndarray) -> int:
    """CRC32 of host arrays' shapes, dtypes and bytes."""
    crc = 0
    for a in arrays:
        a = np.ascontiguousarray(a)
        crc = zlib.crc32(f"{a.shape}{a.dtype.str}".encode(), crc)
        crc = zlib.crc32(a.view(np.uint8).reshape(-1), crc)
    return crc & 0xFFFFFFFF


class LockstepError(RuntimeError):
    """The ranks of a tensor-parallel group built different host
    batches: their host decisions diverged."""


def check_lockstep(sctx: Optional[ShardCtx], digest: int) -> None:
    """Gather every rank's host-batch ``digest`` on the host group and
    raise :class:`LockstepError` on every rank unless they are equal."""
    if sctx is None or sctx.tp_size == 1:
        return
    import torch.distributed as dist
    mine = torch.tensor([digest], dtype=torch.int64)
    got = [torch.empty_like(mine) for _ in range(sctx.tp_size)]
    dist.all_gather(got, mine, group=sctx.host_group)
    traffic["lockstep"] += 1
    seen = [int(g) for g in got]
    if len(set(seen)) != 1:
        raise LockstepError(
            f"rank {sctx.rank}: host batch digests differ across the "
            f"tensor-parallel group: {seen}")
