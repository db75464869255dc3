"""Bridge between the JAX package's pytrees and the port's tensors.

The parity tests build the JAX package's weights, caches and KV blobs,
hand them over as numpy arrays, and hold the port against the reference
on the same state.  Nothing here imports JAX: inputs are numpy arrays
(``bfloat16`` arrays from ``ml_dtypes`` are read through float32, which
is exact), and outputs going back are numpy arrays, with bfloat16
leaves widened to float32 and their dtype named beside them.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import (DeviceLike, dtype_name, resolve_device,
                                torch_dtype)
from repro_torch.engine.engine import KVBlob
from repro_torch.launch.steps import engine_param_shards
from repro_torch.layout import jax_layout
from repro_torch.models.mamba2 import F32_PARAMS
from repro_torch.models.transformer import check_arch, init_cache


def to_tensor(a, device: torch.device, dtype=None) -> torch.Tensor:
    """numpy array (any float/int dtype, bfloat16 included) -> tensor."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(a))
    return t.to(device=device, dtype=dtype or t.dtype)


def to_numpy(t: torch.Tensor) -> np.ndarray:
    """tensor -> numpy; bfloat16 widens to float32 (exact)."""
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        t = t.float()
    return t.numpy()


def params_from_jax(cfg: ModelConfig, tree: dict, device: DeviceLike = None,
                    dtype=None, sctx=None) -> dict:
    """The JAX package's ``init_params`` tree (as numpy) -> the port's
    params.  Stacked layer leaves become per-layer weights: dense
    ``layers[i]``, moe ``dense_layers[i]`` and ``layers[j]`` (the
    experts' ``wg``/``wu`` from ``(E, d, eff)`` to the port's
    ``(d, E * eff)``, ``models.moe``), ssm ``layers[i]``, hybrid
    ``cells[c]["ssm"][j]`` and ``tail[j]``, with the one ``shared_attn`` /
    ``shared_mlp`` block held once, vlm ``cells[c]["self"][j]`` (stacked
    twice in the reference) and ``cells[c]["cross"]``, audio
    ``enc_layers[i]`` and ``dec_layers[i]``.  Matrices and the embedding
    are stored once in ``dtype`` (default ``cfg.dtype``): exact, because
    the JAX forward casts them to the activation dtype where it uses them
    (``lin``, the embed gather and the tied unembed).  Norms and the
    Mamba2 vectors stay f32, and so do the conv weights, which the
    reference uses in f32 (``causal_conv``), and the MoE router, on which
    the reference routes in f32.  With ``sctx`` (a rank of the engine's
    tensor-parallel group) the tree is that rank's shard
    (``launch.steps.engine_param_shards``), each block cut as it is
    carried over, so no rank holds a second whole copy of the model."""
    check_arch(cfg)
    dev = resolve_device(device)
    wdt = torch_dtype(dtype or cfg.dtype)

    def place(block):
        return engine_param_shards(cfg, block, sctx)

    def mat(a):
        return to_tensor(a, dev, wdt)

    def vec(a):
        return to_tensor(a, dev, torch.float32)

    def block(leaves, idx):
        return {name: (vec if name in F32_PARAMS else mat)(a[idx])
                for name, a in leaves.items()}

    def attn(t, idx=()):
        return place({"ln": vec(t["ln"][idx]), "wq": mat(t["wq"][idx]),
                      "wk": mat(t["wk"][idx]), "wv": mat(t["wv"][idx]),
                      "wo": mat(t["wo"][idx])})

    def mlp(t, idx=()):
        return place({"ln": vec(t["ln"][idx]), "wg": mat(t["wg"][idx]),
                      "wu": mat(t["wu"][idx]), "wd": mat(t["wd"][idx])})

    def experts(a):
        """(E, d, eff) -> (d, E * eff)."""
        a = np.asarray(a)
        return mat(a.transpose(1, 0, 2).reshape(a.shape[1], -1))

    def moe(t, idx):
        out = {"router": vec(t["router"][idx]), "wg": experts(t["wg"][idx]),
               "wu": experts(t["wu"][idx]), "wd": mat(t["wd"][idx])}
        for name in ("sg", "su", "sd"):
            if name in t:
                out[name] = mat(t[name][idx])
        return place(out)

    out = {"embed": mat(tree["embed"]), "final_ln": vec(tree["final_ln"])}
    if not cfg.tie_embeddings:
        out["unembed"] = mat(tree["unembed"])
        out = place(out)
    L = cfg.num_layers
    if cfg.arch_type == "dense":
        la, lm = tree["layers"]["attn"], tree["layers"]["mlp"]
        out["layers"] = [{"attn": attn(la, i), "mlp": mlp(lm, i)}
                         for i in range(L)]
    elif cfg.arch_type == "moe":
        nd = cfg.first_dense_layers
        if nd:
            dl = tree["dense_layers"]
            out["dense_layers"] = [{"attn": attn(dl["attn"], i),
                                    "mlp": mlp(dl["mlp"], i)}
                                   for i in range(nd)]
        ml = tree["layers"]
        out["layers"] = [{"attn": attn(ml["attn"], j),
                          "ln2": vec(ml["ln2"][j]), "moe": moe(ml["moe"], j)}
                         for j in range(L - nd)]
    elif cfg.arch_type == "ssm":
        out["layers"] = [block(tree["layers"], i) for i in range(L)]
    elif cfg.arch_type == "vlm":
        every, cells = cfg.cross_attn_every, tree["cells"]
        sa, sm = cells["self"]["attn"], cells["self"]["mlp"]
        out["cells"] = [
            {"self": [{"attn": attn(sa, (c, j)), "mlp": mlp(sm, (c, j))}
                      for j in range(every)],
             "cross": attn(cells["cross"], c)}
            for c in range(L // every)]
    elif cfg.arch_type == "audio":
        enc, dec = tree["enc_layers"], tree["dec_layers"]
        out["enc_layers"] = [{"attn": attn(enc["attn"], i),
                              "mlp": mlp(enc["mlp"], i)}
                             for i in range(cfg.encoder_layers)]
        out["dec_layers"] = [{"attn": attn(dec["attn"], i),
                              "cross": attn(dec["cross"], i),
                              "mlp": mlp(dec["mlp"], i)} for i in range(L)]
    else:
        every = cfg.hybrid_attn_every
        cells = tree["cells"]["ssm"]
        out["cells"] = [{"ssm": [block(cells, (c, j)) for j in range(every)]}
                        for c in range(L // every)]
        if "tail" in tree:
            n_tail = L - (L // every) * every
            out["tail"] = [block(tree["tail"], j) for j in range(n_tail)]
        out["shared_attn"] = attn(tree["shared_attn"])
        out["shared_mlp"] = mlp(tree["shared_mlp"])
    return out


def _n_layers(cfg: ModelConfig, params: dict) -> int:
    """The layer count a port tree holds (blocks of a hybrid's cells and
    tail, self layers of a VLM's cells, an audio model's decoder)."""
    if cfg.arch_type == "moe":
        return len(params.get("dense_layers", [])) + len(params["layers"])
    if cfg.arch_type == "hybrid":
        return sum(len(c["ssm"]) for c in params["cells"]) \
            + len(params.get("tail", []))
    if cfg.arch_type == "vlm":
        return sum(len(c["self"]) for c in params["cells"])
    if cfg.arch_type == "audio":
        return len(params["dec_layers"])
    return len(params["layers"])


def params_to_numpy(cfg: ModelConfig, params: dict) -> dict:
    """The port's params -> the JAX package's tree (numpy), the exact
    inverse of :func:`params_from_jax` on every arch: per-layer lists
    restacked along a leading axis (a cell's lists twice), a MoE block's
    ``wg`` / ``wu`` back to ``(E, d, eff)``
    (``layout.jax_layout``); bfloat16 leaves arrive as
    float32 (exact)."""
    check_arch(cfg)
    n = _n_layers(cfg, params)
    if n != cfg.num_layers:
        raise ValueError(f"{n} layers, config has {cfg.num_layers}")

    def numpy_tree(t):
        if isinstance(t, dict):
            return {k: numpy_tree(v) for k, v in t.items()}
        return to_numpy(t)
    return numpy_tree(jax_layout(params))


def cache_from_jax(cfg: ModelConfig, cache: Dict[str, np.ndarray],
                   device: DeviceLike = None) -> dict:
    """A reference cache (``k``/``v`` (L,B,S,Hk,D), ``slot_pos`` (B,S),
    ``conv`` (n_ssm,B,K-1,ch), ``ssm`` (n_ssm,B,nh,P,N), ``cross_k`` /
    ``cross_v`` (n_cross,B,Tm,Hk,D)) -> a port cache with the same
    contents."""
    dev = resolve_device(device)
    lead = cache["k"] if "k" in cache else cache["conv"]
    B = lead.shape[1]
    S = cache["k"].shape[2] if "k" in cache else 1
    dt = np.asarray(lead).dtype.name
    out = init_cache(cfg, B, S, dtype=dt, device=dev)
    for k, v in cache.items():
        out[k].copy_(to_tensor(v, dev))
    return out


def cache_to_numpy(cache: dict) -> Dict[str, np.ndarray]:
    return {k: to_numpy(v) for k, v in cache.items()}


def blob_from_jax(blob, device: DeviceLike = None) -> KVBlob:
    """A reference ``KVBlob`` (arrays as numpy) -> a port ``KVBlob`` with
    the same header (req_id, next_pos, nbytes, shapes, dtypes) and
    checksum stamp."""
    dev = resolve_device(device)
    arrays = {k: to_tensor(v, dev) for k, v in blob.arrays.items()}
    return KVBlob(blob.req_id, arrays, int(blob.next_pos), int(blob.nbytes),
                  blob.checksum)


def blob_to_numpy(blob: KVBlob) -> dict:
    """A port ``KVBlob`` -> its fields with numpy arrays; ``dtypes``
    names each leaf's dtype (bfloat16 leaves arrive as float32)."""
    return {"req_id": blob.req_id, "next_pos": blob.next_pos,
            "nbytes": blob.nbytes, "checksum": blob.checksum,
            "arrays": {k: to_numpy(v) for k, v in blob.arrays.items()},
            "dtypes": {k: dtype_name(v.dtype)
                       for k, v in blob.arrays.items()}}
