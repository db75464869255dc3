"""AdamW with global-norm clipping and a warmup-cosine schedule.

Counterpart of ``repro.training.optim``, on the port's parameter layout
(a list of per-layer dicts under ``"layers"`` where the JAX package
stacks each leaf along a leading layer axis).  Two consequences:

* Weight decay follows the JAX package's leaves: it decays every leaf of
  ndim >= 2 *there*, which includes the per-layer norms (stacked to
  (L, d)) and excludes only ``final_ln`` (d,).  The port's per-layer
  ``ln`` is 1-D, so :func:`decays` asks what its JAX leaf would be.
* :func:`global_norm` sums in the JAX leaf order, each JAX leaf's layers
  together, so it differs from the reference only in the order of sums
  within a leaf (last bits).

The step count, learning rate and bias corrections stay on the device:
no Python scalar is uploaded per step (that would be a host sync).
:func:`adamw_update` updates parameters and moments in place (JAX
returns new trees), which keeps a full-width trainer within one card.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, Iterator, List, NamedTuple, Optional, Tuple

import torch


@dataclass(frozen=True)
class OptConfig:
    lr: float = 3e-5
    beta1: float = 0.9
    beta2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.01
    grad_clip: float = 1.0
    warmup_steps: int = 10
    total_steps: int = 1000
    min_lr_frac: float = 0.1


class OptState(NamedTuple):
    step: torch.Tensor           # () int32, on the parameters' device
    mu: dict
    nu: dict


def tree_items(tree, path: Tuple = ()) -> Iterator[Tuple[tuple, torch.Tensor]]:
    """(path, leaf) pairs of a nested dict / list tree, dict keys sorted
    (the JAX package's leaf order), list items in order."""
    if isinstance(tree, dict):
        for key in sorted(tree):
            yield from tree_items(tree[key], path + (key,))
    elif isinstance(tree, (list, tuple)):
        for i, sub in enumerate(tree):
            yield from tree_items(sub, path + (i,))
    else:
        yield path, tree


def tree_rebuild(tree, leaves):
    """``leaves`` (in :func:`tree_items` order) put back into ``tree``'s
    structure."""
    flat = dict(zip((path for path, _ in tree_items(tree)), leaves))

    def build(sub, path):
        if isinstance(sub, dict):
            return {k: build(v, path + (k,)) for k, v in sub.items()}
        if isinstance(sub, (list, tuple)):
            return [build(v, path + (i,)) for i, v in enumerate(sub)]
        return flat[path]
    return build(tree, ())


def tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [tree_map(fn, v) for v in tree]
    return fn(tree)


def jax_leaf(path: tuple) -> tuple:
    """The JAX package's leaf of a port path (the layer index dropped:
    ``("layers", 3, "attn", "wq")`` -> ``("layers", "attn", "wq")``)."""
    return tuple(p for p in path if not isinstance(p, int))


def decays(path: tuple, p: torch.Tensor) -> bool:
    """Whether AdamW decays this leaf: the JAX package decays leaves of
    ndim >= 2, and its per-layer leaves carry a leading layer axis."""
    stacked = any(isinstance(x, int) for x in path)
    return p.dim() + int(stacked) >= 2


def _jax_order(tree) -> List[Tuple[tuple, torch.Tensor]]:
    """Leaves grouped by JAX leaf, in the JAX leaf order, layers in
    order within each."""
    items = list(tree_items(tree))
    return sorted(items, key=lambda it: (jax_leaf(it[0]), it[0]))


def init_opt_state(params) -> OptState:
    def zeros(p):
        return torch.zeros_like(p, dtype=torch.float32,
                                memory_format=torch.contiguous_format)
    device = next(tree_items(params))[1].device
    return OptState(step=torch.zeros((), dtype=torch.int32, device=device),
                    mu=tree_map(zeros, params), nu=tree_map(zeros, params))


def schedule(cfg: OptConfig, step: torch.Tensor) -> torch.Tensor:
    step = torch.as_tensor(step).float()
    warm = torch.clamp(step / max(cfg.warmup_steps, 1), max=1.0)
    prog = torch.clamp((step - cfg.warmup_steps)
                       / max(cfg.total_steps - cfg.warmup_steps, 1),
                       0.0, 1.0)
    cos = 0.5 * (1 + torch.cos(math.pi * prog))
    frac = cfg.min_lr_frac + (1 - cfg.min_lr_frac) * cos
    return cfg.lr * warm * frac


def global_norm(tree) -> torch.Tensor:
    groups: Dict[tuple, List[torch.Tensor]] = {}
    for path, x in _jax_order(tree):
        groups.setdefault(jax_leaf(path), []).append(
            torch.sum(torch.square(x.float())))
    leaves = [torch.stack(g).sum() if len(g) > 1 else g[0]
              for g in groups.values()]
    return torch.sqrt(torch.sum(torch.stack(leaves)))


@torch.no_grad()
def adamw_update(cfg: OptConfig, params, grads, state: OptState,
                 grad_norm: Optional[torch.Tensor] = None):
    """One AdamW step, parameters and moments updated in place.
    ``grads`` has the tree of ``params``.  Returns (params, state,
    metrics) like the JAX package (the same objects, updated).
    ``grad_norm``, when given, is the norm the step clips by (a rank's
    pieces of a sharded model: the whole model's, which
    ``launch.steps.production_global_norm`` takes); else
    :func:`global_norm` of ``grads``."""
    gnorm = global_norm(grads) if grad_norm is None else grad_norm
    scale = torch.clamp(cfg.grad_clip / (gnorm + 1e-9), max=1.0)
    state.step.add_(1)
    lr = schedule(cfg, state.step)
    b1, b2 = cfg.beta1, cfg.beta2
    stepf = state.step.float()
    bc1 = 1 - torch.pow(b1, stepf)
    bc2 = 1 - torch.pow(b2, stepf)
    flat_g = dict(tree_items(grads))
    flat_m = dict(tree_items(state.mu))
    flat_v = dict(tree_items(state.nu))
    for path, p in tree_items(params):
        g = flat_g[path].float() * scale
        m, v = flat_m[path], flat_v[path]
        m.copy_(b1 * m + (1 - b1) * g)
        v.copy_(b2 * v + (1 - b2) * torch.square(g))
        delta = (m / bc1) / (torch.sqrt(v / bc2) + cfg.eps)
        if decays(path, p):
            delta = delta + cfg.weight_decay * p.float()
        p.copy_((p.float() - lr * delta).to(p.dtype))
    return params, state, {"grad_norm": gnorm, "lr": lr}
