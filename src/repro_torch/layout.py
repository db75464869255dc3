"""The port's parameter tree against the JAX package's.

The port holds a model's layers as lists of per-layer trees
(``layers``, ``dense_layers``, ``tail``, ``enc_layers``, ``dec_layers``,
``cells`` and a cell's ``self`` / ``ssm``) and a MoE block's expert
matrices ``wg`` / ``wu`` as ``(d, E * eff)``; the JAX package stacks each
list along a leading axis (a VLM's or hybrid's cell lists twice) and
holds the experts as ``(E, d, eff)``.  :func:`jax_layout` and
:func:`port_layout` map every arch's tree one way and back; checkpoints
(``training.checkpoint``) and the parity bridge (``bridge``) use them.
"""
from __future__ import annotations

import torch

# keys whose value the port holds as a list of per-layer (or per-cell)
# trees and the JAX package as one tree stacked along a leading axis
LAYER_LISTS = ("layers", "dense_layers", "tail", "enc_layers", "dec_layers",
               "cells", "self", "ssm")
# a MoE block's expert matrices: the port's (d, E * eff), the reference's
# (E, d, eff) (models/moe.py)
EXPERT_LEAVES = ("wg", "wu")


def jax_layout(params) -> dict:
    """Port tree -> the JAX package's tree: a list of per-layer trees is
    stacked leaf by leaf along a new leading axis, and a MoE block's
    ``wg`` / ``wu`` go to ``(E, d, eff)`` (E from its router's width).
    Leaves are detached views or stacks of the port's tensors."""
    if isinstance(params, dict):
        out = {k: jax_layout(v) for k, v in params.items()}
        if "router" in params:
            E = params["router"].shape[1]
            for k in EXPERT_LEAVES:
                w = out[k]
                out[k] = w.reshape(w.shape[0], E, -1).permute(1, 0, 2)
        return out
    if isinstance(params, (list, tuple)):
        return _stack([jax_layout(p) for p in params])
    return params.detach()


def _stack(subs):
    if isinstance(subs[0], dict):
        return {k: _stack([s[k] for s in subs]) for k in subs[0]}
    return torch.stack(subs)


def _layer(tree, i: int):
    """Layer ``i`` of a stacked tree, its leaves copied."""
    if isinstance(tree, dict):
        return {k: _layer(v, i) for k, v in tree.items()}
    return tree[i].clone()


def _n_stacked(tree) -> int:
    while isinstance(tree, dict):
        tree = next(iter(tree.values()))
    return tree.shape[0]


def port_layout(tree: dict) -> dict:
    """The JAX package's tree -> the port's: the stacked trees under
    ``LAYER_LISTS`` keys become lists of per-layer trees (a cell's own
    lists too), and a MoE block's ``wg`` / ``wu`` go to ``(d, E *
    eff)``."""
    out = {}
    for k, v in tree.items():
        if k in LAYER_LISTS and isinstance(v, dict):
            out[k] = [port_layout(_layer(v, i))
                      for i in range(_n_stacked(v))]
        elif isinstance(v, dict):
            out[k] = port_layout(v)
        else:
            out[k] = v
    if "router" in tree:
        for k in EXPERT_LEAVES:
            w = out[k]
            out[k] = w.permute(1, 0, 2).reshape(w.shape[1], -1).contiguous()
    return out
