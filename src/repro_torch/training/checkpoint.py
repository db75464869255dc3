"""Checkpointing and the weight-update phase.

Counterpart of ``repro.training.checkpoint``.  ``save``/``restore`` use
the reference's on-disk layout, so either package reads the other's
checkpoint: one ``.npy`` per leaf of the JAX package's tree, named by its
flattened path (``layers__attn__wq.npy``), bfloat16 leaves stored as raw
bytes with their dtype in ``manifest.json``.  The port's per-layer lists
(``layers``, ``dense_layers``, ``tail``, ``enc_layers``, ``dec_layers``,
``cells`` and a cell's ``self`` / ``ssm``) are saved stacked along a
leading axis, as the JAX package holds them (a VLM's or hybrid's cell
lists twice), and a MoE block's ``wg`` / ``wu`` in the reference's
``(E, d, eff)``; restore undoes both.  Every arch's tree goes both ways
(``layout.jax_layout``, ``layout.port_layout``).

``WeightUpdater`` pushes fresh weights to the rollout instances.  The
trainer holds f32 master weights that require gradients; the instances
get a detached copy with every matrix in ``cfg.dtype`` (norms stay f32),
which is bitwise what the JAX package's per-use cast of its f32 masters
computes, and which the optimizer's in-place updates never touch.
"""
from __future__ import annotations

import json
import os
from typing import List, Optional, Tuple

import numpy as np
import torch

from repro_torch.device import DeviceLike, resolve_device, torch_dtype
from repro_torch.layout import jax_layout, port_layout
from repro_torch.training.optim import tree_items, tree_map


def _flatten(tree, prefix=""):
    out = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(_flatten(v, f"{prefix}{k}/"))
    else:
        out[prefix[:-1]] = tree
    return out


def _to_numpy(t: torch.Tensor) -> Tuple[np.ndarray, str]:
    t = t.detach().cpu().contiguous()
    if t.dtype == torch.bfloat16:
        # numpy has no bfloat16: the raw bits, as the reference stores them
        return t.view(torch.int16).numpy().view(np.uint8), "bfloat16"
    return t.numpy(), str(t.numpy().dtype)


def _from_numpy(arr: np.ndarray, dtype: str, shape) -> torch.Tensor:
    if dtype == "bfloat16":
        bits = np.ascontiguousarray(arr).view(np.int16).reshape(shape)
        return torch.from_numpy(bits.copy()).view(torch.bfloat16)
    return torch.from_numpy(np.ascontiguousarray(arr).reshape(shape).copy())


def save(path: str, params, step: int = 0,
         extra: Optional[dict] = None) -> None:
    os.makedirs(path, exist_ok=True)
    flat = _flatten(jax_layout(params))
    manifest = {"step": step, "leaves": {}, "extra": extra or {}}
    for key, val in flat.items():
        fname = key.replace("/", "__") + ".npy"
        arr, dtype = _to_numpy(val)
        np.save(os.path.join(path, fname), arr)
        manifest["leaves"][key] = {"file": fname, "shape": list(val.shape),
                                   "dtype": dtype}
    with open(os.path.join(path, "manifest.json"), "w") as f:
        json.dump(manifest, f, indent=1)


def restore(path: str, device: DeviceLike = None) -> Tuple[dict, int]:
    """-> (tree in the port's layout, step), tensors on ``device`` in the
    dtypes the checkpoint holds."""
    dev = resolve_device(device)
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    tree: dict = {}
    for key, meta in manifest["leaves"].items():
        arr = np.load(os.path.join(path, meta["file"]))
        t = _from_numpy(arr, meta["dtype"], meta["shape"]).to(dev)
        node = tree
        parts = key.split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = t
    return port_layout(tree), manifest["step"]


def serving_params(params, dtype: str):
    """A detached copy for the rollout: matrices and the embedding in
    ``dtype`` (the activation dtype), norms (1-D) in f32."""
    wdt = torch_dtype(dtype)
    return tree_map(lambda p: p.detach().to(
        torch.float32 if p.dim() == 1 else wdt, copy=True), params)


class WeightUpdater:
    """Pushes fresh training weights to rollout instances (synchronous
    RL's weight-update phase): each push hands every instance one shared
    serving copy (:func:`serving_params`), kept as ``params``."""

    def __init__(self, instances: List, link_bw: float = 50e9):
        self.instances = instances
        self.link_bw = link_bw
        self.updates = 0
        # monotonically increasing weight version; the staleness ledger
        # stamps every sampled token with the version it decoded under,
        # so version = number of pushes so far
        self.version = 0
        self.modeled_seconds = 0.0
        self.params: Optional[dict] = None

    def push(self, params) -> float:
        """Push ``params`` (the trainer's masters); returns the modeled
        broadcast seconds of the serving copy (bytes / link bandwidth)."""
        cfg = self.instances[0].cfg
        self.params = serving_params(params, cfg.dtype)
        nbytes = sum(t.numel() * t.element_size()
                     for _, t in tree_items(self.params))
        for inst in self.instances:
            inst.params = self.params
        self.updates += 1
        self.version += 1
        t = nbytes / self.link_bw  # one broadcast stage
        self.modeled_seconds += t
        return t

