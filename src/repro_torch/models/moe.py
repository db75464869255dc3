"""Mixture-of-Experts layer of the port.

Counterpart of ``repro.models.moe``: ``init_moe``, ``_route``,
``_aux_loss``, ``moe_dense_all`` and ``_shared`` (with the engine's
exact tensor parallelism, ``sctx``), and the ``sctx is None`` and
``sctx.exact`` branches of ``moe_forward``.  As the reference serves,
every expert runs on every token and the router's top-k weights pick
what is kept, so no token is dropped and the tokens match the
reference's.  The expert products are plain matrix products (the
reference has no kernel on this layer).  The production layout's
capacity-bounded expert/tensor-parallel dispatch (``_capacity``,
``_moe_body`` and the ``shard_map`` branches of ``moe_forward``) is not
ported yet.

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

import torch

from repro_torch import sharding
from repro_torch.models.common import lin


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


def _route(x_f32: torch.Tensor, router: torch.Tensor, top_k: int):
    """x (T, d) f32 -> (weights (T, k), ids (T, k), probs (T, E)).  A
    stable descending sort puts the lower expert first among equal
    probabilities, as ``jax.lax.top_k`` does."""
    probs = torch.softmax(x_f32 @ router.float(), dim=-1)
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
    y_all = torch.bmm(g, p["wd"].to(x.dtype))                # (E, T, d)
    # each (t, e) holds at most one of the token's k weights: exact
    comb = (onehot * w[..., None]).sum(dim=1)                # (T, E)
    y = torch.bmm(comb.to(x.dtype)[:, None, :],
                  y_all.transpose(0, 1))[:, 0]               # (T, d)
    y = y + _shared(xf, p, sctx)
    return y.reshape(B, S, d), aux


def moe_forward(x: torch.Tensor, p: dict, cfg, sctx=None):
    """x (B, S, d) -> (y, aux f32).  No context: every expert on one
    device.  The engine's exact context (``sctx.exact``): the same dense
    combine with each expert's hidden dim split across the ranks.  The
    production layout's capacity-bounded expert/tensor-parallel dispatch
    (``sctx.exact`` False) is not ported yet and raises."""
    if sctx is not None and not sctx.exact:
        raise NotImplementedError(
            "the MoE layer's capacity-bounded expert/tensor-parallel "
            "dispatch (the production layout: _capacity, _moe_body, the "
            "shard_map branches) is not ported yet; the engine's exact "
            "context runs")
    return moe_dense_all(x, p, cfg, sctx)
