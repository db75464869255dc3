"""Mixture-of-Experts layer of the port.

Counterpart of ``repro.models.moe``: ``init_moe``, ``_route``,
``_aux_loss``, ``moe_dense_all`` and ``_shared`` (with the engine's
exact tensor parallelism, ``sctx``), ``_capacity``, ``_moe_body`` and
every branch of ``moe_forward``.

Two paths.  With no context, and under the engine's exact one
(``sctx.exact``), every expert runs on every token and the router's
top-k weights pick what is kept (:func:`moe_dense_all`), so no token is
dropped and the tokens match the reference's.  Under the production
layout's context (``exact`` False, any number of ranks, one included)
the capacity-bounded dispatch runs (:func:`moe_capacity`): each rank
holds E / tp whole experts when they divide the group (expert
parallelism, the rank's first expert ``rank * E / tp``), else every
expert with its hidden dim ``eff`` split; routing is in f32 over every
token on every rank, each (token, k) pair takes the next slot of its
expert in flattened (token, k) order (an exclusive cumsum) and is
dropped past the capacity C, which is computed from the global E as the
reference does; the kept tokens are gathered into an (E_loc, C, d)
buffer, the experts run as batched products (:func:`bmm`: the
reference has no kernel on this layer), the k-loop combine sums in f32,
and the shared expert (its ``ff`` split over the ranks) is added before
the ranks' partial outputs are summed — all-reduced, or reduce-scattered
along the sequence when the context shards it.  The router's aux loss
is averaged over the ranks.  The data axes of the context (the
reference's ``dp``) split the batch into its shards, each with its own
capacity: where they run over ranks each rank's rows are its shard, and
the aux loss is averaged over the data-parallel group too; a hand-built
context with a larger data axis and no group runs the shards one after
another on the model group.

Layout: ``wg`` and ``wu`` are stored as ``(d, E * eff)``, expert ``e``
in columns ``e * eff .. (e + 1) * eff - 1`` (the reference's
``(E, d, eff)`` with the expert axis moved behind ``d``), so that one
product gives every expert's hidden rows; ``wd`` keeps the reference's
``(E, eff, d)``.  The router is an f32 leaf: the reference routes on
``router.astype(f32)`` of its f32 parameter, and a bf16 router would
pick other experts.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from repro_torch import sharding
from repro_torch.kernels.row_gemm.ops import row_bmm
from repro_torch.models.common import lin, records_grad


def init_moe(d: int, eff: int, n_expert: int, n_shared: int, normal):
    """Random weights at the reference's scales: ``Builder.param``'s
    default is 1/sqrt(shape[0]), so ``wg`` and ``wu`` (shape (E, d, eff)
    there) are drawn at 1/sqrt(E), ``wd`` at 1/sqrt(eff), the router at
    0.02 and the shared expert at 1/sqrt(d) and 1/sqrt(n_shared * eff).
    ``normal(shape, scale, f32=False)`` draws one leaf."""
    up = 1.0 / math.sqrt(n_expert)
    p = {"router": normal((d, n_expert), 0.02, f32=True),
         "wg": normal((d, n_expert * eff), up),
         "wu": normal((d, n_expert * eff), up),
         "wd": normal((n_expert, eff, d), 1.0 / math.sqrt(eff))}
    if n_shared:
        sf = n_shared * eff
        p["sg"] = normal((d, sf), 1.0 / math.sqrt(d))
        p["su"] = normal((d, sf), 1.0 / math.sqrt(d))
        p["sd"] = normal((sf, d), 1.0 / math.sqrt(sf))
    return p


def bmm(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """(E, M, K) @ (E, K, N): the row-invariant batched product off
    autograd (``kernels.row_gemm``), ``torch.bmm`` under it."""
    if records_grad(a, w):
        return torch.bmm(a, w)
    return row_bmm(a, w)


def _route(x_f32: torch.Tensor, router: torch.Tensor, top_k: int):
    """x (T, d) f32 -> (weights (T, k), ids (T, k), probs (T, E)).  A
    stable descending sort puts the lower expert first among equal
    probabilities, as ``jax.lax.top_k`` does."""
    probs = torch.softmax(lin(x_f32, router), dim=-1)
    w, ids = torch.sort(probs, dim=-1, descending=True, stable=True)
    w, ids = w[:, :top_k], ids[:, :top_k]
    w = w / w.sum(dim=-1, keepdim=True).clamp_min(1e-9)
    return w, ids, probs


def _one_hot(ids: torch.Tensor, n_expert: int) -> torch.Tensor:
    """(T, k) expert ids -> (T, k, E) f32 one-hot."""
    e = torch.arange(n_expert, device=ids.device)
    return (ids[..., None] == e).float()


def _aux_loss(probs: torch.Tensor, onehot: torch.Tensor) -> torch.Tensor:
    """Switch-style load-balance loss E * sum_e f_e * P_e, from the
    one-hot of the routed ids (an exact count, no atomics)."""
    T, k, E = onehot.shape
    f = onehot.sum(dim=(0, 1)) / max(T * k, 1)
    return E * torch.sum(f * probs.mean(dim=0))


def _silu(h: torch.Tensor) -> torch.Tensor:
    """``jax.nn.silu`` op for op, h * (1 / (1 + exp(-h))), each op's
    result in the activation dtype, as the reference's bf16 forward
    rounds it: with one rounded sigmoid instead, many of a bf16 MoE
    layer's outputs differ from the reference's by an ulp, and the
    layer's large outputs carry that into the logits."""
    return h * (1 / (1 + torch.exp(-h)))


def _shared(xf: torch.Tensor, p: dict, sctx=None):
    if "sg" not in p:
        return 0.0
    g = _silu(lin(xf, p["sg"])) * lin(xf, p["su"])
    return lin(sharding.whole_columns(g, p["sd"].shape[0], sctx), p["sd"])


def moe_dense_all(x: torch.Tensor, p: dict, cfg, sctx=None):
    """Exact MoE: all experts on all tokens.  x (B, S, d) -> (y, aux).

    With an ``sctx`` the up-projections run column-parallel (each
    expert's hidden dim ``eff`` split, ``launch.steps``) and the hidden
    activations are gathered before the down-projection: no capacity
    buffer, no dropped token, and bitwise the one-device output."""
    B, S, d = x.shape
    E = cfg.num_experts
    xf = x.reshape(-1, d)
    T = xf.shape[0]
    w, ids, probs = _route(xf.float(), p["router"], cfg.moe_top_k)
    onehot = _one_hot(ids, E)
    aux = _aux_loss(probs, onehot)
    # every expert's hidden rows in one product: (T, E, eff)
    h = lin(xf, p["wg"]).view(T, E, -1)
    u = lin(xf, p["wu"]).view(T, E, -1)
    g = sharding.whole_columns(_silu(h) * u, p["wd"].shape[1],
                               sctx).transpose(0, 1)
    y_all = bmm(g, p["wd"].to(x.dtype))                      # (E, T, d)
    # each (t, e) holds at most one of the token's k weights: exact
    comb = (onehot * w[..., None]).sum(dim=1)                # (T, E)
    y = bmm(comb.to(x.dtype)[:, None, :],
            y_all.transpose(0, 1))[:, 0]                     # (T, d)
    y = y + _shared(xf, p, sctx)
    return y.reshape(B, S, d), aux


def _capacity(T: int, k: int, E_loc: int, factor: float) -> int:
    """Slots per expert: T * k * factor over E_loc, plus one, rounded up
    to a multiple of 8 and at least 8 (the reference's ``_capacity``)."""
    c = int(T * k * factor) // max(E_loc, 1) + 1
    return max(8, -(-c // 8) * 8)


# when a list, every capacity dispatch appends a record of its slots and
# drops (``ids``, ``slot``, ``valid``, ``local``, ``e0``, ``E_loc``,
# ``C``, detached): the tests hold them to the reference's, the card's
# smoke run counts the drops
DISPATCH_LOG: Optional[list] = None


def dispatch_slots(ids: torch.Tensor, e0: int, E_loc: int, C: int):
    """ids (T, k) -> (slot, valid, local), each (T * k,) in flattened
    (token, k) order: ``local`` the pairs routed to this rank's experts
    ``[e0, e0 + E_loc)``, their rank in their expert by an exclusive
    cumsum, ``valid`` those ranked below C, ``slot`` = expert * C + rank
    for them and ``E_loc * C`` (the trash row) for the rest."""
    eflat = ids.reshape(-1)
    local = (eflat >= e0) & (eflat < e0 + E_loc)
    le = torch.where(local, eflat - e0, E_loc)
    onehot = (le[:, None] == torch.arange(E_loc, device=ids.device)
              ).to(torch.int64)
    pos = (torch.cumsum(onehot, dim=0) - onehot).gather(
        1, le.clamp(max=E_loc - 1)[:, None])[:, 0]
    valid = local & (pos < C)
    slot = torch.where(valid, le * C + pos, E_loc * C)
    return slot, valid, local


def _moe_body(xf: torch.Tensor, router: torch.Tensor, p: dict, cfg,
              e0: int, E_loc: int, C: int):
    """The reference's ``_moe_body`` on this rank's experts: xf (T, d)
    -> (this rank's partial output (T, d) in xf's dtype, aux f32)."""
    T, d = xf.shape
    k = cfg.moe_top_k
    w, ids, probs = _route(xf.float(), router, k)
    aux = _aux_loss(probs, _one_hot(ids, cfg.num_experts))
    slot, valid, local = dispatch_slots(ids, e0, E_loc, C)
    if DISPATCH_LOG is not None:
        DISPATCH_LOG.append(dict(ids=ids.detach(), slot=slot, valid=valid,
                                 local=local, e0=e0, E_loc=E_loc, C=C))
    # the token of each slot (T: the zero row); a kept pair's slot is its
    # own, every drop goes to the trash row, so amin is exact
    tok_idx = torch.arange(T, device=xf.device).repeat_interleave(k)
    tok = torch.full((E_loc * C + 1,), T, dtype=torch.int64,
                     device=xf.device).scatter_reduce_(
        0, slot, tok_idx, reduce="amin")
    xf_pad = torch.cat([xf, xf.new_zeros((1, d))])
    buf = xf_pad[tok[:E_loc * C]].view(E_loc, C, d)
    dt = xf.dtype
    wg = p["wg"].view(d, E_loc, -1).transpose(0, 1).to(dt)
    wu = p["wu"].view(d, E_loc, -1).transpose(0, 1).to(dt)
    g = _silu(bmm(buf, wg)) * bmm(buf, wu)
    out = bmm(g, p["wd"].to(dt)).reshape(E_loc * C, d)
    out = torch.cat([out, out.new_zeros((1, d))])
    slot_tk = slot.view(T, k)
    w_tk = torch.where(valid.view(T, k), w, torch.zeros_like(w))
    y = torch.zeros((T, d), dtype=torch.float32, device=xf.device)
    for j in range(k):
        y = y + out[slot_tk[:, j]].float() * w_tk[:, j:j + 1]
    y = y.to(dt)
    if "sg" in p:
        y = y + lin(_silu(lin(xf, p["sg"])) * lin(xf, p["su"]), p["sd"])
    return y, aux


def moe_capacity(x: torch.Tensor, p: dict, cfg, sctx):
    """The production layout's capacity-bounded dispatch (the reference's
    ``shard_map`` branches of ``moe_forward``): x (B, S, d) whole on every
    rank of the model group, ``p`` this rank's pieces
    (``launch.steps.param_shards``) -> (y, aux).  y is the summed output
    (B, S, d), or this rank's piece (B, S / tp, d) when the context
    shards the sequence and S divides.  x's gradient comes back whole on
    every rank (the ranks' partials summed).  With the data axes over
    ranks (``sctx.dp_group``) x is this rank's data shard: one dispatch
    with C from its rows, aux averaged over the data-parallel group, then
    over ``model``, as the reference's ``pmean``s average it.  A
    hand-built context with a data axis and no group (``dp_size`` > 1)
    takes each data shard's rows of x one after another, each with its
    own C, as the reference does on its (2, 2) meshes, against which the
    tests hold this loop."""
    B, S, d = x.shape
    E, tp = cfg.num_experts, sctx.tp_size
    ep = E % tp == 0
    eff = cfg.moe_d_ff or cfg.d_ff
    if not ep and (eff % tp or (cfg.num_shared_experts
                                and cfg.num_shared_experts * eff % tp)):
        raise ValueError(f"{E} experts of hidden dim {eff} split over "
                         f"{tp} ranks neither by expert nor by eff")
    dp = 1 if sctx.dp_group is not None else sctx.dp_size()
    if B % dp:
        dp = 1
    E_loc = E // tp if ep else E
    C = _capacity((B // dp) * S, cfg.moe_top_k, E, cfg.capacity_factor)
    e0 = sctx.rank * E_loc if ep else 0
    x = sharding.copy_to_ranks(x, sctx)
    router = sharding.copy_to_ranks(p["router"], sctx)
    ys, auxes = [], []
    for xb in x.chunk(dp, dim=0):
        y, aux = _moe_body(xb.reshape(-1, d), router, p, cfg, e0, E_loc, C)
        ys.append(y.view(xb.shape))
        auxes.append(aux)
    y = torch.cat(ys) if dp > 1 else ys[0]
    aux = torch.stack(auxes).mean() if dp > 1 else auxes[0]
    if sctx.dp_group is not None:
        aux = sharding.dp_sum(aux, sctx) / sctx.dp_size()
    if sctx.seq_shard and S % tp == 0:
        y = sharding.scatter_seq(y, sctx, dim=1)
    else:
        y = sharding.reduce_from_ranks(y, sctx)
    return y, sharding.reduce_from_ranks(aux, sctx) / tp


def moe_forward(x: torch.Tensor, p: dict, cfg, sctx=None):
    """x (B, S, d) -> (y, aux f32).  No context, or the engine's exact
    one: :func:`moe_dense_all` (every expert on every token; the exact
    context splits each expert's hidden dim).  The production layout's
    context (``exact`` False), at any tp: :func:`moe_capacity`."""
    if sctx is None or sctx.exact:
        return moe_dense_all(x, p, cfg, sctx)
    return moe_capacity(x, p, cfg, sctx)
