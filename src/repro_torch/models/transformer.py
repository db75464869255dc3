"""The config-driven model on every arch of the JAX package — dense,
MoE, SSM (Mamba2), hybrid (Zamba2), VLM (Llama-3.2-Vision) and audio
(Whisper) — with a slot-indexed KV cache, recurrent state and
cross-attention memory, and the cache-free forward (training) of each.

Counterpart of ``repro.models.transformer``: ``init_params``,
``init_cache``, ``_project_qkv``, the slot-scatter and ``ck is None``
branches of ``_self_attn``, ``_cross_attn``, ``_mlp``, ``_dense_layer``,
``_moe_layer``, ``_decoder_stack``, ``_ssm_stack``, ``_hybrid_stack``,
``build_cross_cache``, ``_vlm_stack``, ``encode_audio``,
``_audio_stack`` (Python loops over layers instead of ``lax.scan``) and
``forward``.
With a cache, one forward covers chunked prefill, decode (T=1) and
speculative verify
(T=gamma+1), and mixes them row by row under ``token_mask``.  Without
one (``cache=None``: training, on every arch) it runs a whole sequence
at positions 0..T-1: self-attention through the flash-attention kernel
(K3), causal (with the config's window); cross blocks through K3
non-causal over the image embeddings or the audio encoder's output
(``aux_inputs``); Mamba2 blocks from a zero conv history and state
through K4 and its backward; the MoE layers' router aux loss summed as
the third output.  With ``train=True`` each layer (each cell of a
hybrid or VLM model) is recomputed in the backward
(``torch.utils.checkpoint``, the JAX package's ``_remat``).

Tensor parallelism (``forward(sctx=)``).  The engine's exact context
(the exact branches of the JAX package's ``_self_attn``,
``_cross_attn``, ``_mlp`` and the MoE layer): each rank holds its shard
of the weights and of the K/V cache (``launch.steps``), and the
activations are gathered before every matmul whose reduction would
otherwise be sharded, so the logits, and the sampled tokens, are
bitwise the one-device ones.  The production (Megatron) layout's
context: the cache-free forward on the rank's ``param_shards``, with
row-parallel ``wo`` / ``wd`` and the residual stream split along the
sequence (``_Layout``), each rank on its rows of the batch with the
data axes over ranks (each block's FSDP pieces gathered over ``data``
as it runs), and the cached steps on the same layout, each
rank holding a piece of the KV cache split along its sequence
(``launch.steps.init_cache``): the step's q and new K/V gathered to
every head, each rank writing and attending its own slots through K1 /
K2's partials, the ranks' partials merged (``sharding.merge_ranks``).

The cache is updated in place, which replaces JAX's buffer donation:
``forward`` writes this step's K/V rows and slot positions into the
tensors of ``cache`` and returns the same dict.  The recurrent leaves
(``conv`` and ``ssm``) go to ``rec_out`` when it is given — the engine's
replay keeps the pre-step state that way, without a copy — and else
into the cache too.

Masked (padding) tokens: the JAX package sends them to slot ``S`` and
drops the write (``.at[...].set(mode="drop")``).  Torch has no drop mode
and boolean indexing would sync the host, so ``init_cache`` allocates
one scratch slot past the last real one in every row; the cache holds
views that hide it, and masked writes (and writes past the end of a
non-ring cache, which the JAX package drops too) land there and are
never read.
"""
from __future__ import annotations

import functools
import math
from typing import Optional

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.device import DeviceLike, resolve_device, torch_dtype
from repro_torch.launch import steps as _steps
from repro_torch.launch.steps import (attn_whole, data_piece,
                                      engine_param_shards, heads_of,
                                      kv_heads, mlp_whole, production,
                                      span_of, vocab_whole)
from repro_torch.models.attention import attention
from repro_torch.models.common import apply_rope, lin, rms_norm
from repro_torch.models.mamba2 import init_mamba_block, mamba_block
from repro_torch.models.moe import init_moe, moe_forward
from repro_torch import sharding
from repro_torch.sharding import ShardCtx

PORTED_ARCHS = ("dense", "moe", "ssm", "hybrid", "vlm", "audio")


def check_arch(cfg: ModelConfig) -> None:
    if cfg.arch_type not in PORTED_ARCHS:
        raise NotImplementedError(
            f"arch_type={cfg.arch_type!r}: the port runs {PORTED_ARCHS}")


def init_params(cfg: ModelConfig, generator: torch.Generator,
                device: DeviceLike = None, dtype=None,
                sctx: Optional[ShardCtx] = None) -> dict:
    """Random weights at the JAX package's scales (``init_params``,
    ``_init_attn``, ``_init_mlp``, ``init_mamba_block`` and
    ``Builder.param``): normals scaled by 1/sqrt(fan_in), the embedding
    by 0.02, norms at one.  Matrices and the embedding are stored in
    ``dtype`` (default ``cfg.dtype``: ``lin`` casts to it on every call
    anyway; ``"float32"`` gives a trainer's master weights); norms, the
    Mamba2 vectors and the conv weights (used in f32) in f32.

    Trees: dense ``layers[i]["attn"|"mlp"]``; moe ``dense_layers[i]``
    (``{"attn", "mlp"}``, the first ``first_dense_layers`` layers) and
    ``layers[j]`` (``{"attn", "ln2", "moe"}``, ``models.moe.init_moe``:
    its router in f32); ssm ``layers[i]`` (one Mamba2 block each);
    hybrid ``cells[c]["ssm"][j]``, ``tail[j]`` (the blocks past the last
    whole cell) and one ``shared_attn`` and ``shared_mlp``, used by every
    cell; vlm ``cells[c]`` (``{"self": [dense layer] * cross_attn_every,
    "cross": attention block}``); audio ``enc_layers[i]`` (dense layers)
    and ``dec_layers[i]`` (``{"attn", "cross", "mlp"}``).  A cross block
    is a plain attention block at the same scales (the JAX package's
    ``_init_attn(cross=True)``).  ``generator`` must live on
    ``device``.  With ``sctx`` the tree is this rank's shard
    (``launch.steps.engine_param_shards``), each layer cut as it is
    drawn, so no rank holds the whole model; the weights are the same
    draws as without it."""
    check_arch(cfg)
    dev = resolve_device(device)
    wdt = torch_dtype(dtype or cfg.dtype)
    d, hd, f = cfg.d_model, cfg.head_dim, cfg.d_ff

    def normal(shape, scale, f32=False):
        w = torch.randn(shape, generator=generator, device=dev,
                        dtype=torch.float32).mul_(scale)
        return w if f32 else w.to(wdt)

    def ones(n):
        return torch.ones(n, device=dev, dtype=torch.float32)

    def zeros(n):
        return torch.zeros(n, device=dev, dtype=torch.float32)

    def attn():
        return {"ln": ones(d),
                "wq": normal((d, cfg.num_heads * hd), 1.0 / math.sqrt(d)),
                "wk": normal((d, cfg.num_kv_heads * hd), 1.0 / math.sqrt(d)),
                "wv": normal((d, cfg.num_kv_heads * hd), 1.0 / math.sqrt(d)),
                "wo": normal((cfg.num_heads * hd, d),
                             1.0 / math.sqrt(cfg.num_heads * hd))}

    def mlp():
        return {"ln": ones(d),
                "wg": normal((d, f), 1.0 / math.sqrt(d)),
                "wu": normal((d, f), 1.0 / math.sqrt(d)),
                "wd": normal((f, d), 1.0 / math.sqrt(f))}

    def place(tree):
        return engine_param_shards(cfg, tree, sctx)

    def dense():
        return place({"attn": attn(), "mlp": mlp()})

    def block():
        return init_mamba_block(cfg, normal, ones, zeros)

    params = {"embed": normal((cfg.vocab_size, d), 0.02),
              "final_ln": ones(d)}
    if not cfg.tie_embeddings:
        params["unembed"] = normal((d, cfg.vocab_size), 1.0 / math.sqrt(d))
        params = place(params)
    L = cfg.num_layers
    if cfg.arch_type == "dense":
        params["layers"] = [dense() for _ in range(L)]
    elif cfg.arch_type == "moe":
        nd = cfg.first_dense_layers
        if nd:
            params["dense_layers"] = [dense() for _ in range(nd)]
        params["layers"] = [
            place({"attn": attn(), "ln2": ones(d),
                   "moe": init_moe(d, cfg.moe_d_ff or cfg.d_ff,
                                   cfg.num_experts, cfg.num_shared_experts,
                                   normal)})
            for _ in range(L - nd)]
    elif cfg.arch_type == "ssm":
        params["layers"] = [block() for _ in range(L)]
    elif cfg.arch_type == "hybrid":
        every = cfg.hybrid_attn_every
        n_cells = L // every
        params["cells"] = [{"ssm": [block() for _ in range(every)]}
                           for _ in range(n_cells)]
        if L - n_cells * every:
            params["tail"] = [block() for _ in range(L - n_cells * every)]
        params["shared_attn"] = place(attn())
        params["shared_mlp"] = place(mlp())
    elif cfg.arch_type == "vlm":
        every = cfg.cross_attn_every
        params["cells"] = [{"self": [dense() for _ in range(every)],
                            "cross": place(attn())}
                           for _ in range(L // every)]
    else:
        params["enc_layers"] = [dense() for _ in range(cfg.encoder_layers)]
        params["dec_layers"] = [place({"attn": attn(), "cross": attn(),
                                       "mlp": mlp()}) for _ in range(L)]
    return params


def cache_len_for(cfg: ModelConfig, requested: int) -> int:
    if cfg.sliding_window:
        return min(requested, cfg.sliding_window)
    return requested


def n_attn_layers(cfg: ModelConfig) -> int:
    if cfg.arch_type == "ssm":
        return 0
    if cfg.arch_type == "hybrid":
        return cfg.num_layers // cfg.hybrid_attn_every
    return cfg.num_layers


def n_ssm_layers(cfg: ModelConfig) -> int:
    return cfg.num_layers if cfg.arch_type in ("ssm", "hybrid") else 0


def n_cross_layers(cfg: ModelConfig) -> int:
    """Cross-attention blocks: one per VLM cell, one per audio decoder
    layer."""
    if cfg.arch_type == "vlm":
        return cfg.num_layers // cfg.cross_attn_every
    return cfg.num_layers if cfg.arch_type == "audio" else 0


def cross_len(cfg: ModelConfig) -> int:
    """Positions of the cross-attention memory: image tokens or audio
    frames."""
    return cfg.num_image_tokens if cfg.arch_type == "vlm" \
        else cfg.num_audio_frames


def init_cache(cfg: ModelConfig, batch: int, max_len: int, dtype=None,
               device: DeviceLike = None,
               sctx: Optional[ShardCtx] = None) -> dict:
    """The JAX package's cache layout.  Attention layers: zero K/V
    ``(n_attn,B,S,Hk,D)`` and ``slot_pos (B,S)`` filled with -1, each a
    view of a buffer one slot wider (the scratch slot of masked writes).
    Mamba2 blocks: the conv window ``conv (n_ssm,B,K-1,ch)`` in ``dtype``
    and the state ``ssm (n_ssm,B,nh,P,N)`` in f32, both zero.  VLM and
    audio models: the cross-attention memory ``cross_k`` / ``cross_v``
    ``(n_cross,B,Tm,Hk,D)`` in ``dtype``, zero until
    :func:`build_cross_cache` fills it.  Neither has a position axis or
    a scratch slot: nothing writes them by position.  With the engine's
    exact ``sctx`` the K/V and cross-attention leaves hold this rank's KV
    heads only (``launch.steps.kv_heads``); with the production layout's
    over ranks, the rank's piece (``launch.steps.init_cache``)."""
    check_arch(cfg)
    if production(sctx):
        return _steps.init_cache(cfg, batch, max_len, sctx, dtype, device)
    dev = resolve_device(device)
    dt = torch_dtype(dtype or cfg.dtype)
    S = cache_len_for(cfg, max_len)
    cache = {}
    n_attn = n_attn_layers(cfg)
    hk = kv_heads(cfg, sctx) if n_attn else 0
    if n_attn:
        shape = (n_attn, batch, S + 1, hk, cfg.head_dim)
        k = torch.zeros(shape, dtype=dt, device=dev)
        v = torch.zeros(shape, dtype=dt, device=dev)
        sp = torch.full((batch, S + 1), -1, dtype=torch.int32, device=dev)
        cache.update(k=k[:, :, :S], v=v[:, :, :S], slot_pos=sp[:, :S])
    n_ssm = n_ssm_layers(cfg)
    if n_ssm:
        ch = cfg.d_inner + 2 * cfg.ssm_ngroups * cfg.ssm_state
        cache["conv"] = torch.zeros((n_ssm, batch, cfg.ssm_conv - 1, ch),
                                    dtype=dt, device=dev)
        cache["ssm"] = torch.zeros(
            (n_ssm, batch, cfg.ssm_nheads, cfg.ssm_head_dim, cfg.ssm_state),
            dtype=torch.float32, device=dev)
    n_cross = n_cross_layers(cfg)
    if n_cross:
        shape = (n_cross, batch, cross_len(cfg), hk, cfg.head_dim)
        cache["cross_k"] = torch.zeros(shape, dtype=dt, device=dev)
        cache["cross_v"] = torch.zeros(shape, dtype=dt, device=dev)
    return cache


def with_scratch(t: torch.Tensor, pos_dim: int) -> torch.Tensor:
    """``t`` (a cache view from :func:`init_cache`) widened by the
    scratch slot along ``pos_dim``."""
    size = list(t.shape)
    if pos_dim == 0 or t.stride(pos_dim - 1) != \
            (size[pos_dim] + 1) * t.stride(pos_dim):
        raise ValueError("cache tensor has no scratch slot; build caches "
                         "with init_cache")
    size[pos_dim] += 1
    return t.as_strided(size, t.stride(), t.storage_offset())


POSITION_DIM = {"k": 2, "v": 2, "slot_pos": 1}


def clone_cache(cache: dict) -> dict:
    """A copy of a cache from :func:`init_cache`, scratch slots and all
    (a plain ``clone`` of the views would drop them)."""
    out = {}
    for name, t in cache.items():
        dim = POSITION_DIM.get(name)
        out[name] = t.clone() if dim is None else with_scratch(
            t, dim).clone().narrow(dim, 0, t.shape[dim])
    return out


def _project_qkv(p, xn, cfg, positions):
    """q, k, v (B, T, heads, hd): as many heads as the weights hold (all,
    or a rank's shard)."""
    B, T, _ = xn.shape
    hd = cfg.head_dim
    q = lin(xn, p["wq"]).reshape(B, T, -1, hd)
    k = lin(xn, p["wk"]).reshape(B, T, -1, hd)
    v = lin(xn, p["wv"]).reshape(B, T, -1, hd)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def _split_like(cfg, sctx):
    """The unsharded layer's head counts for K1/K2's split choice on a
    sharded layer: a head's result then does not depend on tp."""
    if sctx is None or sctx.tp_size == 1:
        return None
    return cfg.num_heads, cfg.num_kv_heads


def _out_proj(p, o, cfg, sctx):
    """x's update from the attention output o (B, T, heads, hd): the head
    shards gathered before ``wo`` (its reduction stays whole)."""
    B, T = o.shape[:2]
    o = sharding.whole_columns(o.reshape(B, T, -1),
                               cfg.num_heads * cfg.head_dim, sctx)
    return lin(o, p["wo"])


def _self_attn(p, x, cfg, positions, bidx, slots, ck, cv, slot_pos,
               allowed=None, sctx=None):
    """Slot-scatter branch: write this step's K/V rows in place, then
    attend over the whole slot cache (under ``allowed`` (B,T,S) when the
    step verifies draft trees).  Under ``sctx`` q/k/v and the cache hold
    this rank's heads (``sharding.head_shard``): the attention runs with
    no traffic, and o is gathered before ``wo``."""
    xn = rms_norm(x, p["ln"], cfg.rms_eps)
    q, k, v = _project_qkv(p, xn, cfg, positions)
    if bidx is None:
        o = _contiguous_attn(cfg, q, k, v, positions, slots, ck, cv,
                             slot_pos)
        return x + _out_proj(p, o, cfg, sctx)
    with_scratch(ck, 1)[bidx, slots] = k.to(ck.dtype)
    with_scratch(cv, 1)[bidx, slots] = v.to(cv.dtype)
    o = attention(q, ck, cv, positions, slot_pos, window=cfg.sliding_window,
                  softcap=cfg.attn_logit_softcap, allowed_mask=allowed,
                  split_like=_split_like(cfg, sctx))
    return x + _out_proj(p, o, cfg, sctx)


def _contiguous_attn(cfg, q, k, v, positions, idx, ck, cv, slot_pos):
    """The contiguous prefill's branch (the JAX package's ``slots is
    None``): every row writes the same slots.  ``idx`` (T,) the slots
    [start, start + T): K/V written there (an index copy along the
    slots, so the scratch slot is never touched), then attention over
    the whole cache through K1, whose mask (``k_pos >= 0`` and
    causality) is the JAX package's ``kv_valid`` mask.  ``idx`` None:
    the ring roll of a whole-window prefill (T >= S): the cache becomes
    the last S tokens, rolled so that position p sits at slot p % S, and
    the step attends its own pre-ring K/V through K3 (causal, the
    window; positions contiguous from the rows' shared start)."""
    if idx is None:
        S, T = ck.shape[1], k.shape[1]
        shift = (T - S) % S
        ck.copy_(torch.roll(k[:, T - S:].to(ck.dtype), shift, 1))
        cv.copy_(torch.roll(v[:, T - S:].to(cv.dtype), shift, 1))
        return attention(q, k, v, positions, positions,
                         window=cfg.sliding_window,
                         softcap=cfg.attn_logit_softcap, contiguous=True)
    ck.index_copy_(1, idx, k.to(ck.dtype))
    cv.index_copy_(1, idx, v.to(cv.dtype))
    return attention(q, ck, cv, positions, slot_pos,
                     window=cfg.sliding_window,
                     softcap=cfg.attn_logit_softcap)


def _self_attn_nocache(p, x, cfg, positions, causal=True, sctx=None):
    """The ``ck is None`` branch: self-attention over the sequence itself
    (positions 0..T-1), causal or (the audio encoder) bidirectional,
    through K3."""
    xn = rms_norm(x, p["ln"], cfg.rms_eps)
    q, k, v = _project_qkv(p, xn, cfg, positions)
    o = attention(q, k, v, positions, positions, causal=causal,
                  window=cfg.sliding_window,
                  softcap=cfg.attn_logit_softcap, contiguous=True)
    return x + _out_proj(p, o, cfg, sctx)


@functools.lru_cache(maxsize=64)
def _zero_positions(B: int, T: int, device: torch.device) -> torch.Tensor:
    """(B, T) int32 zeros, made once per shape and device: a per-call
    allocation would cost host time on every cross layer.  An engine
    meets a few widths T and one memory length, so 64 entries hold them
    all."""
    return torch.zeros((B, T), dtype=torch.int32, device=device)


def _cross_kv(p, mem, cfg):
    """K/V of one cross block from the memory (B, Tm, d), as many heads as
    the weights hold."""
    B, Tm, _ = mem.shape
    k = lin(mem, p["wk"]).reshape(B, Tm, -1, cfg.head_dim)
    v = lin(mem, p["wv"]).reshape(B, Tm, -1, cfg.head_dim)
    return k, v


def _cross_attn(p, x, cfg, k, v, sctx=None):
    """Cross-attention to static memory (image or audio embeddings) from
    its cached K/V, (B, Tm, Hk, D) each (``_cross_kv``).  No RoPE.

    The JAX package attends with ``causal=False`` at ``q_pos = k_pos =
    0``.  Through K1 that mask is ``(k_pos >= 0) & (k_pos <= q_pos)``,
    which at zero positions admits every key: the non-causal mask, with
    no check on the host (a check would sync it).  Under ``sctx`` the
    query heads and the memory's KV heads are this rank's, and o is
    gathered before ``wo``."""
    xn = rms_norm(x, p["ln"], cfg.rms_eps)
    B, T, _ = xn.shape
    q = lin(xn, p["wq"]).reshape(B, T, -1, cfg.head_dim)
    o = attention(q, k, v, _zero_positions(B, T, q.device),
                  _zero_positions(B, k.shape[1], q.device),
                  split_like=_split_like(cfg, sctx))
    return x + _out_proj(p, o, cfg, sctx)


def _swiglu(p, xn):
    """SwiGLU's hidden h = silu(xn wg) * (xn wu), before ``wd``."""
    g = lin(xn, p["wg"])
    return g * torch.sigmoid(g) * lin(xn, p["wu"])


def _mlp(p, x, cfg, sctx=None):
    """SwiGLU; under ``sctx`` the hidden h is this rank's ``ff`` columns,
    gathered before ``wd``."""
    h = _swiglu(p, rms_norm(x, p["ln"], cfg.rms_eps))
    return x + lin(sharding.whole_columns(h, cfg.d_ff, sctx), p["wd"])


def _dense_layer(p, x, cfg, positions, bidx, slots, ck, cv, slot_pos,
                 allowed=None, sctx=None):
    x = _self_attn(p["attn"], x, cfg, positions, bidx, slots, ck, cv,
                   slot_pos, allowed, sctx)
    return _mlp(p["mlp"], x, cfg, sctx)


def _moe_layer(p, x, cfg, positions, bidx, slots, ck, cv, slot_pos,
               allowed=None, sctx=None):
    x = _self_attn(p["attn"], x, cfg, positions, bidx, slots, ck, cv,
                   slot_pos, allowed, sctx)
    y, aux = moe_forward(rms_norm(x, p["ln2"], cfg.rms_eps), p["moe"], cfg,
                         sctx)
    return x + y, aux


def _decoder_stack(cfg, params, x, cache, attn_args, sctx=None):
    """Dense and MoE layers over the K/V cache: a MoE model's first
    ``first_dense_layers`` (``dense_layers``) take cache layers
    0..nd-1 and its MoE layers the rest.  Returns (x, summed aux f32)."""
    positions, bidx, slots, slot_pos, allowed = attn_args
    dense, moe = params["layers"], []
    if cfg.arch_type == "moe":
        dense, moe = params.get("dense_layers", []), params["layers"]
    aux = 0.0
    for i, p in enumerate(dense + moe):
        args = (x, cfg, positions, bidx, slots, cache["k"][i], cache["v"][i],
                slot_pos, allowed, sctx)
        if i < len(dense):
            x = _dense_layer(p, *args)
        else:
            x, a = _moe_layer(p, *args)
            aux = aux + a
    return x, aux


@torch.no_grad()
def encode_audio(cfg: ModelConfig, params: dict, frames: torch.Tensor,
                 sctx: Optional[ShardCtx] = None) -> torch.Tensor:
    """The bidirectional audio encoder over (stubbed) frame embeddings
    (B, Tf, d): each ``enc_layers`` layer attends the frames to each
    other at positions 0..Tf-1 (RoPE included), non-causal, through K3,
    then its MLP.  Without gradients (serving); the cache-free forward
    runs the same layers under autograd.  Under the engine's exact
    ``sctx`` each layer runs on this rank's heads and ``ff`` columns with
    the exact gathers; under the production layout's over ranks, on the
    rank's pieces (``_Layout``, the frames whole on every rank)."""
    if production(sctx):
        return _encode_audio(cfg, params, frames, lay=_Layout(
            cfg, sctx, frames.shape[1], False, seq=False))
    return _encode_audio(cfg, params, frames, sctx=sctx)


@torch.no_grad()
def build_cross_cache(cfg: ModelConfig, params: dict,
                      embeds: torch.Tensor,
                      sctx: Optional[ShardCtx] = None):
    """K/V of every cross block, ``(n_cross, B, Tm, Hk, D)`` each in
    ``cfg.dtype``, from the modality embeddings (B, Tm, d): the image
    embeddings themselves, or the audio encoder's output over the
    frames.  With a rank's shard of the params (``sctx``), Hk is that
    rank's KV heads (all of them where the production layout runs
    attention whole): its own ``wk`` / ``wv`` columns make them."""
    if cfg.arch_type == "vlm":
        blocks = [cell["cross"] for cell in params["cells"]]
    elif cfg.arch_type == "audio":
        embeds = encode_audio(cfg, params, embeds, sctx)
        blocks = [layer["cross"] for layer in params["dec_layers"]]
    else:
        raise ValueError(f"arch_type={cfg.arch_type!r} has no "
                         "cross-attention")
    dt = torch_dtype(cfg.dtype)
    kv = [_cross_kv(p, embeds, cfg) for p in blocks]
    return (torch.stack([k for k, _ in kv]).to(dt),
            torch.stack([v for _, v in kv]).to(dt))


def _mamba_nocache(p, x, cfg):
    """A Mamba2 block over the whole sequence: zero conv history, zero
    initial state (K4 and, under autograd, its backward)."""
    b = x.shape[0]
    ch = cfg.d_inner + 2 * cfg.ssm_ngroups * cfg.ssm_state
    conv = torch.zeros((b, cfg.ssm_conv - 1, ch), dtype=x.dtype,
                       device=x.device)
    return mamba_block(p, x, cfg, conv, None)[0]


def _enc_layer_nocache(p, x, cfg, positions, sctx=None):
    x = _self_attn_nocache(p["attn"], x, cfg, positions, causal=False,
                           sctx=sctx)
    return _mlp(p["mlp"], x, cfg, sctx)


class _Layout:
    """How the sub-layers of one cache-free forward meet the ranks of
    the production (Megatron) layout's context ``sctx``; with no context
    (or one rank) every method is the identity and each sub-layer runs
    as on one device.

    ``sp``: the residual stream is split along the sequence (the
    reference's ``seq_axis``: training, or T > 1, with ``seq_shard`` and
    T dividing), each rank holding its T / tp rows; else it is whole on
    every rank.  A split sub-layer (heads, ``ff`` or vocab divide the
    group) takes its normed input whole (:meth:`enter`: gathered along T,
    or Megatron's *f*), runs its column-parallel products on the rank's
    pieces and its row-parallel ``wo`` / ``wd`` into a partial, and
    :meth:`leave` sums the ranks' partials (reduce-scattered back to the
    rank's rows, or all-reduced); on one rank that is the sub-layer
    itself.  Under ``sp`` the norm before it sees only the rank's rows,
    so its weight's gradient is summed over the ranks (:meth:`norm`).  A
    whole sub-layer (Mamba2 blocks; attention, MLP or vocabulary that
    does not divide) runs on every rank on the whole sequence, as on one
    rank (``_ONE``), between :meth:`whole_in` and :meth:`whole_out`.

    The data axes (``data``: the context's data-parallel or FSDP group;
    also on one ``model`` rank): each rank runs its rows of the batch,
    and a block's weights enter it through :meth:`weights`, which
    gathers each FSDP piece whole over ``data`` and sums the gradient of
    each leaf whole on ``data`` over the data-parallel group."""

    def __init__(self, cfg, sctx, T, train, seq=True):
        multi = sctx is not None and sctx.tp_size > 1
        self.sctx = sctx if multi else None
        self.moe_sctx = sctx
        self.cfg = cfg
        self.data = sctx if sctx is not None and (
            sctx.fsdp_group is not None
            or (train and sctx.dp_group is not None)) else None
        self.sp = (multi and seq and (train or T > 1)
                   and sharding.seq_axis(sctx, T) is not None)
        self.attn_whole = multi and attn_whole(cfg, sctx)
        self.mlp_whole = multi and mlp_whole(cfg, sctx)
        self.vocab_whole = not multi or vocab_whole(cfg, sctx)

    def norm(self, w):
        return sharding.copy_to_ranks(w, self.sctx) if self.sp else w

    def enter(self, xn):
        if self.sp:
            return sharding.gather_seq(xn, self.sctx)
        return sharding.copy_to_ranks(xn, self.sctx)

    def leave(self, part):
        if self.sp:
            return sharding.scatter_seq(part, self.sctx)
        return sharding.reduce_from_ranks(part, self.sctx)

    def whole_in(self, x):
        return sharding.gather_whole(x, self.sctx) if self.sp else x

    def whole_out(self, x):
        return sharding.split_seq(x, self.sctx) if self.sp else x

    def memory(self, mem):
        """Cross-attention memory, whole on every rank, entering the
        rank's ``wk`` / ``wv`` columns (its gradient summed)."""
        return sharding.copy_to_ranks(mem, self.sctx)

    def leaf(self, t, kind, name):
        """One weight as a sub-layer uses it: an FSDP piece gathered over
        ``data`` (``sharding.fsdp_gather``), a leaf whole on ``data``
        with its gradient summed over the data-parallel group
        (``sharding.data_whole``)."""
        if self.data is None:
            return t
        pc = data_piece(self.cfg, kind, name, self.data)
        if pc is not None:
            return sharding.fsdp_gather(t, pc.dim, self.data)
        return sharding.data_whole(t, self.data)

    def weights(self, tree, top=False):
        """A block's weight tree (with ``top``, a whole parameter tree)
        with each leaf as :meth:`leaf` gives it; the tree itself without
        data axes over ranks."""
        if self.data is None:
            return tree
        return _steps.walk_leaves(tree, self.leaf, top=top)

    def root(self, params):
        """The parameter tree's own leaves (the embedding, ``unembed``,
        ``final_ln``) as :meth:`leaf` gives them."""
        if self.data is None:
            return params
        return {k: self.leaf(v, "top", k) for k, v in params.items()
                if not isinstance(v, (dict, list))}


# the layout of one rank: every collective the identity
_ONE = _Layout(None, None, 0, False)


def _attn_block(p, x, cfg, positions, lay, causal=True, kv=None):
    """A self-attention sub-layer of the cache-free forward (positions
    0..T-1 whole), through K3; under a split layout on the rank's heads
    with the row-parallel ``wo``.  ``kv`` (a :class:`_Cached` step, the
    layer's K and V pieces): the cached step's attention on this rank's
    slots instead (:meth:`_Cached.attend`)."""
    if lay.attn_whole:
        return lay.whole_out(_attn_block(p, lay.whole_in(x), cfg, positions,
                                         _ONE, causal, kv))
    xn = rms_norm(x, lay.norm(p["ln"]), cfg.rms_eps)
    q, k, v = _project_qkv(p, lay.enter(xn), cfg, positions)
    if kv is None:
        o = attention(q, k, v, positions, positions, causal=causal,
                      window=cfg.sliding_window,
                      softcap=cfg.attn_logit_softcap, contiguous=True)
    else:
        o = kv[0].attend(q, k, v, kv[1], kv[2], lay)
    B, T = o.shape[:2]
    return x + lay.leave(lin(o.reshape(B, T, -1), p["wo"]))


def _mlp_block(p, x, cfg, lay):
    """SwiGLU; under a split layout on the rank's ``ff`` columns with the
    row-parallel ``wd``."""
    if lay.mlp_whole:
        return lay.whole_out(_mlp_block(p, lay.whole_in(x), cfg, _ONE))
    xg = lay.enter(rms_norm(x, lay.norm(p["ln"]), cfg.rms_eps))
    return x + lay.leave(lin(_swiglu(p, xg), p["wd"]))


def _dense_block(p, x, cfg, positions, lay, kv=None):
    x = _attn_block(p["attn"], x, cfg, positions, lay, kv=kv)
    return _mlp_block(p["mlp"], x, cfg, lay)


def _moe_block(p, x, cfg, positions, lay, kv=None):
    """Attention, then the MoE layer on the normed stream, whole on every
    rank (``moe_forward``: dense with no context, the capacity dispatch
    under the production one, which hands back the rank's rows under
    ``sp``)."""
    x = _attn_block(p["attn"], x, cfg, positions, lay, kv=kv)
    xn = rms_norm(x, lay.norm(p["ln2"]), cfg.rms_eps)
    y, aux = moe_forward(lay.whole_in(xn), p["moe"], cfg, lay.moe_sctx)
    return x + y, aux


def _cross_block(p, x, cfg, mem, lay, kv=None):
    """A cross block over the memory (B, Tm, d), whole on every rank,
    through K3; under a split layout on the rank's heads.  ``kv``: the
    cached memory's K and V (the rank's KV heads of ``cross_k`` /
    ``cross_v``) instead, through K1 at zero positions
    (``_cross_attn``)."""
    if lay.attn_whole:
        return lay.whole_out(_cross_block(p, lay.whole_in(x), cfg, mem,
                                          _ONE, kv))
    xg = lay.enter(rms_norm(x, lay.norm(p["ln"]), cfg.rms_eps))
    B, T, _ = xg.shape
    q = lin(xg, p["wq"]).reshape(B, T, -1, cfg.head_dim)
    if kv is None:
        k, v = _cross_kv(p, lay.memory(mem), cfg)
        o = attention(q, k, v, _zero_positions(B, T, q.device),
                      _zero_positions(B, k.shape[1], q.device),
                      causal=False, contiguous=True)
    else:
        k, v = kv
        o = attention(q, k, v, _zero_positions(B, T, q.device),
                      _zero_positions(B, k.shape[1], q.device))
    return x + lay.leave(lin(o.reshape(B, T, -1), p["wo"]))


def _mamba_run(blocks, x, cfg, lay):
    """Mamba2 blocks, whole on the whole sequence on every rank."""
    x = lay.whole_in(x)
    for p in blocks:
        x = _mamba_nocache(p, x, cfg)
    return lay.whole_out(x)


def _hybrid_cell_nocache(cell, shared_attn, shared_mlp, x, cfg, positions,
                         lay):
    x = _mamba_run(cell["ssm"], x, cfg, lay)
    x = _attn_block(shared_attn, x, cfg, positions, lay)
    return _mlp_block(shared_mlp, x, cfg, lay)


def _vlm_cell_nocache(cell, x, cfg, positions, embeds, lay):
    for p in cell["self"]:
        x = _dense_block(p, x, cfg, positions, lay)
    return _cross_block(cell["cross"], x, cfg, embeds, lay)


def _enc_block(p, x, cfg, positions, lay):
    x = _attn_block(p["attn"], x, cfg, positions, lay, causal=False)
    return _mlp_block(p["mlp"], x, cfg, lay)


def _audio_layer_nocache(p, x, cfg, positions, enc_out, lay):
    x = _attn_block(p["attn"], x, cfg, positions, lay)
    x = _cross_block(p["cross"], x, cfg, enc_out, lay)
    return _mlp_block(p["mlp"], x, cfg, lay)


def _encode_audio(cfg, params, frames, train=False, sctx=None, lay=None):
    """The encoder: under the engine's exact ``sctx`` (serving), or a
    cache-free forward's layout ``lay`` (its frames whole on every
    rank).  The exact context is no ``_Layout``: it gathers o and h
    whole and runs ``wo`` / ``wd`` whole on every rank, so that each
    rank's output is bitwise one device's, where a layout sums the
    ranks' row-parallel partials, which rounds otherwise."""
    x = frames.to(torch_dtype(cfg.dtype))
    B, Tf, _ = x.shape
    pos = torch.arange(Tf, dtype=torch.int32, device=x.device).expand(B, Tf)
    for p in params["enc_layers"]:
        if lay is None:
            x = _remat(_enc_layer_nocache, train, p, x, cfg, pos, sctx)
        else:
            x = _remat(_enc_block, train, p, x, cfg, pos, lay, lay=lay)
    return x


def _remat(fn, train, *args, lay=None, weights=1):
    """``fn(*args)``, recomputed in the backward when ``train``.  Under a
    layout with data axes over ranks (``lay``) the first ``weights``
    arguments (weight trees) pass through ``lay.weights`` inside the
    recomputed region: a block's FSDP pieces are gathered whole as it
    runs, dropped after it, and gathered again in its recompute (in the
    same order on every rank)."""
    if lay is not None and lay.data is not None:
        fn = functools.partial(_with_weights, fn, lay, weights)
    if train:
        return checkpoint(fn, *args, use_reentrant=False)
    return fn(*args)


def _with_weights(fn, lay, n, *args):
    return fn(*[lay.weights(a) for a in args[:n]], *args[n:])


def _modality(aux_inputs, name):
    if not aux_inputs or name not in aux_inputs:
        raise ValueError(f"the cache-free forward of this arch needs "
                         f"aux_inputs[{name!r}]")
    return aux_inputs[name]


def _embed_nocache(cfg, params, tokens, lay):
    """The token embeddings: the rank's rows of the stream.  Split by
    vocabulary, each rank looks up the tokens in its rows, writes zeros
    for the rest, and the ranks' pieces are summed (an exact sum)."""
    dtype = torch_dtype(cfg.dtype)
    if lay.vocab_whole:
        return lay.whole_out(params["embed"][tokens.long()].to(dtype))
    n = params["embed"].shape[0]
    t = tokens.long() - lay.sctx.rank * n
    inside = ((t >= 0) & (t < n))[..., None].to(dtype)
    return lay.leave(params["embed"][t.clamp(0, n - 1)].to(dtype) * inside)


def _unembed_nocache(cfg, params, x, lay):
    """Logits (B, T, V), whole on every rank: a split vocabulary's pieces
    (the tied embedding's rows, or the untied ``unembed``'s columns)
    gathered along V."""
    if lay.vocab_whole:
        return _unembed(cfg, params, lay.whole_in(x))
    xn = rms_norm(x, lay.norm(params["final_ln"]), cfg.rms_eps)
    w = params["embed"].T if cfg.tie_embeddings else params["unembed"]
    part = lin(lay.enter(xn), w.to(torch_dtype(cfg.dtype)))
    return sharding.gather_whole(part, lay.sctx, dim=-1)


def _forward_nocache(cfg, params, tokens, positions, train, aux_inputs,
                     sctx=None):
    """-> (logits, aux): the layers of ``cfg.arch_type`` over positions
    0..T-1, each (or each cell) under ``_remat``; aux the MoE layers'
    summed router loss (0.0 on the other archs).  ``sctx``: the
    production layout's context (``_Layout``)."""
    B, T = tokens.shape
    want = torch.arange(T, dtype=positions.dtype, device=positions.device)
    if not torch.equal(positions, want.expand(B, T)):
        raise NotImplementedError(
            "the cache-free forward takes positions 0..T-1 in every row "
            "(the contiguous layout of the flash-attention kernel)")
    lay = _Layout(cfg, sctx, T, train)
    top = lay.root(params)
    x = _embed_nocache(cfg, top, tokens, lay)
    aux = 0.0
    at = cfg.arch_type
    if at in ("dense", "moe"):
        dense, moe = params["layers"], []
        if at == "moe":
            dense, moe = params.get("dense_layers", []), params["layers"]
        for p in dense:
            x = _remat(_dense_block, train, p, x, cfg, positions, lay,
                       lay=lay)
        auxes = []
        for p in moe:
            x, a = _remat(_moe_block, train, p, x, cfg, positions, lay,
                          lay=lay)
            auxes.append(a)
        if auxes:
            aux = torch.stack(auxes).sum()
    elif at == "ssm":
        x = lay.whole_in(x)
        for p in params["layers"]:
            x = _remat(_mamba_nocache, train, p, x, cfg, lay=lay)
        x = lay.whole_out(x)
    elif at == "hybrid":
        for cell in params["cells"]:
            x = _remat(_hybrid_cell_nocache, train, cell,
                       params["shared_attn"], params["shared_mlp"], x, cfg,
                       positions, lay, lay=lay, weights=3)
        tail = params.get("tail", [])
        if tail:
            x = lay.whole_in(x)
            for p in tail:
                x = _remat(_mamba_nocache, train, p, x, cfg, lay=lay)
            x = lay.whole_out(x)
    elif at == "vlm":
        embeds = _modality(aux_inputs, "image_embeds").to(
            torch_dtype(cfg.dtype))
        for cell in params["cells"]:
            x = _remat(_vlm_cell_nocache, train, cell, x, cfg, positions,
                       embeds, lay, lay=lay)
    else:
        frames = _modality(aux_inputs, "audio_frames")
        enc_out = _encode_audio(cfg, params, frames, train, lay=_Layout(
            cfg, sctx, frames.shape[1], train, seq=False))
        for p in params["dec_layers"]:
            x = _remat(_audio_layer_nocache, train, p, x, cfg, positions,
                       enc_out, lay, lay=lay)
    return _unembed_nocache(cfg, top, x, lay), aux


def _unembed(cfg, params, x, sctx=None):
    """Logits; an untied ``unembed`` split by vocab gives this rank's
    columns, gathered whole before sampling."""
    dtype = torch_dtype(cfg.dtype)
    x = rms_norm(x, params["final_ln"], cfg.rms_eps)
    if cfg.tie_embeddings:
        return lin(x, params["embed"].T.to(dtype))
    return sharding.whole_columns(lin(x, params["unembed"].to(dtype)),
                                  cfg.vocab_size, sctx)


def _allowed_mask(cfg, positions, slots, slot_pos, within_mask):
    """One (B,T,S) allowed-mask shared by every layer of a tree-verify
    forward: previously cached slots obey validity + causality (+ window);
    slots written by this step's columns obey ``within_mask`` (B,T,T).
    ``slots`` (B,T) are this step's write targets, S for masked columns;
    the column of each slot is scattered into a (B, S+1) buffer whose
    last column stands in for JAX's dropped writes.  The mask's rows are
    laid out a multiple of 16 bytes apart (a view of a padded buffer when
    S is not), as K2's tensor-core route reads them by TMA."""
    B, T = positions.shape
    S = slot_pos.shape[1]
    qp = positions[:, :, None]
    kp = slot_pos[:, None, :]
    base = (kp >= 0) & (kp <= qp)
    if cfg.sliding_window:
        base = base & (kp > qp - cfg.sliding_window)
    col = torch.full((B, S + 1), -1, dtype=torch.int64,
                     device=positions.device)
    col[torch.arange(B, device=positions.device)[:, None], slots] = \
        torch.arange(T, device=positions.device).expand(B, T)
    col = col[:, :S]
    idx = col.clamp(0, T - 1)[:, None, :].expand(B, T, S)
    ext = within_mask.gather(2, idx)
    pad = -S % 16
    if not pad:
        return torch.where((col >= 0)[:, None, :], ext, base)
    out = torch.zeros((B, T, S + pad), dtype=torch.bool,
                      device=positions.device)[:, :, :S]
    torch.where((col >= 0)[:, None, :], ext, base, out=out)
    return out


def _contiguous_slots(positions, slot_pos, ring, span):
    """The contiguous prefill's slots: writes ``slot_pos`` and returns
    the (T,) slot index every row writes, [start, start + T) with start
    = ``positions[0, 0]`` clamped to [0, S - T] (the JAX package's
    dynamic update slice), built on the device; or, for a ring cache's
    whole-window prefill (T >= S), rolls the last S positions into
    ``slot_pos`` and returns None.  ``span`` (lo, hi, S): ``slot_pos`` is
    a rank's piece, slots [lo, hi) of S; the index is then local, and a
    slot the piece does not hold goes to its scratch slot (hi - lo), so
    no rank needs to know how much of the window it holds."""
    lo, hi, S = span
    n = hi - lo
    T = positions.shape[1]
    if ring:
        slot_pos.copy_(torch.roll(positions[:, T - S:], (T - S) % S,
                                  1)[:, lo:hi])
        return None
    if T > S:
        raise ValueError(f"a contiguous prefill of {T} tokens does not fit "
                         f"a cache of {S} slots")
    start = positions[0, 0].long().clamp(0, S - T)
    idx = start - lo + torch.arange(T, device=positions.device)
    idx = torch.where((idx >= 0) & (idx < n), idx, n)
    with_scratch(slot_pos, 1).index_copy_(1, idx,
                                          positions.to(slot_pos.dtype))
    return idx


def _step_slots(cfg, positions, slot_pos, span, contiguous_update,
                slot_index, token_mask, within_mask):
    """One step's writes to ``slot_pos`` (in place) and what its
    attention layers need: (positions, bidx, slots, slot_pos, allowed).
    The contiguous prefill: bidx None, slots its (T,) index (None for the
    ring roll).  Else the per-row scatter: bidx (B, 1), slots (B, T) with
    masked tokens and writes past a non-ring cache at the scratch slot,
    and ``allowed`` the tree step's mask.  ``span`` (lo, hi, S): slot
    indices are local to a rank's piece [lo, hi) of S slots, and a slot
    it does not hold goes to its scratch slot too."""
    lo, hi, S = span
    n = hi - lo
    B, T = positions.shape
    ring = cfg.sliding_window > 0
    if contiguous_update and token_mask is None and (not ring or T >= S):
        return (positions, None,
                _contiguous_slots(positions, slot_pos, ring, span),
                slot_pos, None)
    if slot_index is not None:
        slots = slot_index.long()
    else:
        slots = positions.long()
        if ring:
            slots = slots % S
    keep = slots < S
    if token_mask is not None:
        keep = keep & token_mask
    if n != S:
        slots = slots - lo
        keep = keep & (slots >= 0) & (slots < n)
    slots = torch.where(keep, slots, n)
    bidx = torch.arange(B, device=positions.device)[:, None]
    with_scratch(slot_pos, 1)[bidx, slots] = positions
    allowed = None
    if within_mask is not None:
        allowed = _allowed_mask(cfg, positions, slots, slot_pos, within_mask)
    return positions, bidx, slots, slot_pos, allowed


def _ssm_stack(cfg, blocks, x, token_mask, cache, rec, first):
    """Mamba2 blocks ``first .. first+len(blocks)-1`` of the cache: each
    reads its conv window and state from ``cache`` and writes the new ones
    into ``rec`` (the cache itself, or the replay's fresh buffers)."""
    for j, p in enumerate(blocks):
        li = first + j
        x, _, _ = mamba_block(p, x, cfg, cache["conv"][li], cache["ssm"][li],
                              token_mask, conv_out=rec["conv"][li],
                              state_out=rec["ssm"][li])
    return x


def _hybrid_stack(cfg, params, x, token_mask, cache, rec, attn_args,
                  sctx=None):
    """Zamba2: each cell runs its ``hybrid_attn_every`` Mamba2 blocks,
    then the one shared attention + MLP block over that cell's K/V layer;
    the ``tail`` blocks follow the last cell.  Under ``sctx`` the Mamba2
    blocks and their state are whole on every rank (the reference's
    replicated specs) and the shared block is head- and ff-sharded."""
    every = cfg.hybrid_attn_every
    positions, bidx, slots, slot_pos, allowed = attn_args
    for c, cell in enumerate(params["cells"]):
        x = _ssm_stack(cfg, cell["ssm"], x, token_mask, cache, rec,
                       c * every)
        x = _self_attn(params["shared_attn"], x, cfg, positions, bidx, slots,
                       cache["k"][c], cache["v"][c], slot_pos, allowed, sctx)
        x = _mlp(params["shared_mlp"], x, cfg, sctx)
    return _ssm_stack(cfg, params.get("tail", []), x, token_mask, cache,
                      rec, len(params["cells"]) * every)


def _vlm_stack(cfg, params, x, cache, attn_args, sctx=None):
    """Llama-3.2-Vision: each cell runs its ``cross_attn_every`` dense
    layers on the slot cache (self layer ``c * every + j`` of ``k`` /
    ``v``), then its cross block on ``cross_k[c]`` / ``cross_v[c]``."""
    every = cfg.cross_attn_every
    positions, bidx, slots, slot_pos, allowed = attn_args
    for c, cell in enumerate(params["cells"]):
        for j, p in enumerate(cell["self"]):
            i = c * every + j
            x = _dense_layer(p, x, cfg, positions, bidx, slots,
                             cache["k"][i], cache["v"][i], slot_pos,
                             allowed, sctx)
        x = _cross_attn(cell["cross"], x, cfg, cache["cross_k"][c],
                        cache["cross_v"][c], sctx)
    return x


def _audio_stack(cfg, params, x, cache, attn_args, sctx=None):
    """Whisper's decoder: each layer's self-attention on the slot cache,
    then its cross block on the encoder's memory (``cross_k[i]`` /
    ``cross_v[i]``), then its MLP."""
    positions, bidx, slots, slot_pos, allowed = attn_args
    for i, p in enumerate(params["dec_layers"]):
        x = _self_attn(p["attn"], x, cfg, positions, bidx, slots,
                       cache["k"][i], cache["v"][i], slot_pos, allowed, sctx)
        x = _cross_attn(p["cross"], x, cfg, cache["cross_k"][i],
                        cache["cross_v"][i], sctx)
        x = _mlp(p["mlp"], x, cfg, sctx)
    return x


class _Cached:
    """One cached step of the production layout on this rank's piece of
    the KV cache: the step's slots (``_step_slots``, local to the piece)
    and, where the ranks hold shares of the slots, the context whose
    ranks' partials are merged."""

    def __init__(self, cfg, attn_args, span, sctx):
        self.cfg = cfg
        self.positions, self.bidx, self.slots, self.slot_pos, \
            self.allowed = attn_args
        self.lo, hi, self.S = span
        self.merge = sctx if hi - self.lo != self.S else None

    def attend(self, q, k, v, ck, cv, lay):
        """The attention output on q's heads (the rank's, or all where
        attention runs whole, ``lay`` then ``_ONE``): q and the new k, v
        gathered to every head (``sharding.gather_heads``), this step's
        K/V written to the slots the rank holds (the rest to its scratch
        slot), then K1 / K2 over its slots; with a merge, their partials
        (``lse=True``) merged over the ranks in rank order
        (``sharding.merge_ranks``), which hands back q's heads.  The ring
        roll of a whole-window prefill keeps the rank's slots of the
        rolled tail and attends the step's own K/V through K3, as one
        device does: nothing to merge."""
        cfg = self.cfg
        pos = self.positions
        qa, ka, va = sharding.gather_heads((q, k, v), lay.sctx)
        if self.bidx is None and self.slots is None:
            T, S, n = ka.shape[1], self.S, ck.shape[1]
            shift = (T - S) % S
            for c, t in ((ck, ka), (cv, va)):
                c.copy_(torch.roll(t[:, T - S:].to(c.dtype), shift,
                                   1)[:, self.lo:self.lo + n])
            return attention(q, k, v, pos, pos, window=cfg.sliding_window,
                             softcap=cfg.attn_logit_softcap, contiguous=True)
        for c, t in ((ck, ka), (cv, va)):
            if self.bidx is None:
                with_scratch(c, 1).index_copy_(1, self.slots, t.to(c.dtype))
            else:
                with_scratch(c, 1)[self.bidx, self.slots] = t.to(c.dtype)
        heads = None
        if lay.sctx is not None:
            hs = heads_of(cfg, lay.sctx)
            heads = (hs.q_lo, hs.q_hi)
        if self.merge is None:
            o = attention(qa, ck, cv, pos, self.slot_pos,
                          window=cfg.sliding_window,
                          softcap=cfg.attn_logit_softcap,
                          allowed_mask=self.allowed)
            return o if heads is None else o[:, :, heads[0]:heads[1]]
        o, lse = attention(qa, ck, cv, pos, self.slot_pos,
                           window=cfg.sliding_window,
                           softcap=cfg.attn_logit_softcap,
                           allowed_mask=self.allowed, lse=True)
        return sharding.merge_ranks(o, lse, self.merge, heads).to(q.dtype)


def _mamba_cached(blocks, x, cfg, lay, token_mask, cache, rec, first):
    """Mamba2 blocks over the cache's recurrent state, whole on the whole
    step on every rank (``_ssm_stack``)."""
    if not blocks:
        return x
    x = _ssm_stack(cfg, blocks, lay.whole_in(x), token_mask, cache, rec,
                   first)
    return lay.whole_out(x)


def _forward_ranks(cfg, params, tokens, cache, attn_args, token_mask, rec,
                   logits, sctx):
    """The cached forward of the production layout over ranks: the
    cache-free forward's layout (``_Layout``) with each attention layer
    on the rank's piece of the cache (:class:`_Cached`) and each cross
    block on its heads of the cached memory.  -> (logits, cache, aux)."""
    T = tokens.shape[1]
    lay = _Layout(cfg, sctx, T, False)
    top = params = lay.weights(params, top=True)
    x = _embed_nocache(cfg, top, tokens, lay)
    step = None
    if attn_args is not None:
        positions = attn_args[0]
        step = _Cached(cfg, attn_args, span_of(cache), sctx)

    def kv(i):
        return step, cache["k"][i], cache["v"][i]

    def mem(i):
        return cache["cross_k"][i], cache["cross_v"][i]

    aux = 0.0
    at = cfg.arch_type
    if at in ("dense", "moe"):
        dense, moe = params["layers"], []
        if at == "moe":
            dense, moe = params.get("dense_layers", []), params["layers"]
        for i, p in enumerate(dense + moe):
            if i < len(dense):
                x = _dense_block(p, x, cfg, positions, lay, kv(i))
            else:
                x, a = _moe_block(p, x, cfg, positions, lay, kv(i))
                aux = aux + a
    elif at == "ssm":
        x = _mamba_cached(params["layers"], x, cfg, lay, token_mask, cache,
                          rec, 0)
    elif at == "hybrid":
        every = cfg.hybrid_attn_every
        for c, cell in enumerate(params["cells"]):
            x = _mamba_cached(cell["ssm"], x, cfg, lay, token_mask, cache,
                              rec, c * every)
            x = _attn_block(params["shared_attn"], x, cfg, positions, lay,
                            kv=kv(c))
            x = _mlp_block(params["shared_mlp"], x, cfg, lay)
        x = _mamba_cached(params.get("tail", []), x, cfg, lay, token_mask,
                          cache, rec, len(params["cells"]) * every)
    elif at == "vlm":
        every = cfg.cross_attn_every
        for c, cell in enumerate(params["cells"]):
            for j, p in enumerate(cell["self"]):
                x = _dense_block(p, x, cfg, positions, lay, kv(c * every + j))
            x = _cross_block(cell["cross"], x, cfg, None, lay, mem(c))
    else:
        for i, p in enumerate(params["dec_layers"]):
            x = _attn_block(p["attn"], x, cfg, positions, lay, kv=kv(i))
            x = _cross_block(p["cross"], x, cfg, None, lay, mem(i))
            x = _mlp_block(p["mlp"], x, cfg, lay)
    if not logits:
        return None, cache, aux
    return _unembed_nocache(cfg, top, x, lay), cache, aux


def forward(cfg: ModelConfig, params: dict, tokens: torch.Tensor,
            positions: torch.Tensor, cache: Optional[dict] = None, *,
            aux_inputs: Optional[dict] = None,
            token_mask: Optional[torch.Tensor] = None,
            train: bool = False,
            contiguous_update: bool = False,
            slot_index: Optional[torch.Tensor] = None,
            within_mask: Optional[torch.Tensor] = None,
            rec_out: Optional[dict] = None,
            logits: bool = True,
            sctx: Optional[ShardCtx] = None):
    """tokens/positions (B,T) int32 -> (logits (B,T,V), cache, aux_loss).

    ``cache=None``: the cache-free (training) forward over positions
    0..T-1 (anything else raises), returning ``(logits, None, aux)``;
    ``train=True`` recomputes each layer (or cell) in the backward.  It
    takes no ``token_mask`` (``grpo_loss`` passes none) and no tree
    inputs.  VLM and audio models read ``aux_inputs["image_embeds"]``
    (B, Tm, d) or ``aux_inputs["audio_frames"]`` (B, Tf, d) there, as the
    JAX package does; with a cache ``aux_inputs`` is not read.

    Either way the third output is the MoE layers' summed load-balance
    loss (an f32 scalar; 0.0 on the other archs).  With a cache, the
    cache is updated in place and returned.  Slots come from
    positions (``positions % S`` on a ring cache for sliding-window
    configs), or from ``slot_index`` (B,T) when given.  Tree-verify
    inputs (both or neither): ``slot_index`` puts sibling draft nodes,
    which share a position, in distinct slots; ``within_mask`` (B,T,T)
    bool says which of this step's columns each query may see (ancestor
    or self for tree rows, causal order for the rest).  Every attention
    layer then attends under one allowed-mask built from it, through K2.
    Mamba2 blocks read the recurrent state from the cache and write it to
    ``rec_out`` (``{"conv", "ssm"}`` shaped like the cache's leaves) when
    given, else back into the cache.  VLM and audio models read their
    cross-attention memory from ``cross_k`` / ``cross_v`` of the cache
    (:func:`build_cross_cache`).  ``logits=False`` skips the unembed and
    returns None in their place (the engine's replay).

    ``contiguous_update=True`` (the production prefill): every row
    writes slots [start, start + T) with start = ``positions[0, 0]``
    (clamped to [0, S - T] as the JAX package's dynamic update slice
    does; taken on the device, no host sync), K/V and ``slot_pos`` alike,
    and attends the whole cache through K1; on a sliding-window (ring)
    cache with T >= S the cache becomes the last S tokens rolled to
    their slots and the step attends its own K/V through K3.  Without a
    ``token_mask`` only; a ring cache with T < S takes the slot scatter,
    as in the JAX package.

    ``sctx`` with ``exact`` (the engine's exact tensor parallelism):
    ``params`` and ``cache`` are this rank's shards (``launch.steps``);
    attention runs on the rank's heads, the MLP and MoE experts on its
    hidden columns, Mamba2 blocks whole, and every activation a
    row-parallel matmul would reduce over is gathered first (o before
    ``wo``, h before ``wd``, vocab-split logits before they are
    returned), so the logits are bitwise the one-device ones.

    ``sctx`` without ``exact`` (the production Megatron layout,
    ``launch.mesh.make_shard_ctx``): ``params`` are this rank's
    ``launch.steps.param_shards``, on any number of ranks (``_Layout``:
    the vocabulary-parallel embedding, the residual stream split along
    the sequence in training or where the context's ``seq_shard`` and T
    allow, column- then row-parallel sub-layers with their sums, Mamba2
    blocks whole on the gathered sequence, logits gathered whole), its
    MoE layers through the capacity dispatch; with the data axes over
    ranks, ``tokens`` are the rank's rows of the batch
    (``launch.steps.batch_shards``) and its MoE layers take C from them.
    With a cache on more than one rank (no gradients) ``cache`` is the
    rank's piece (``launch.steps.init_cache`` / ``cache_shards``: its
    rows over the data axes, ``k`` / ``v`` and
    ``slot_pos`` split along the sequence, ``conv`` / ``ssm`` whole,
    ``cross_k`` / ``cross_v`` on the rank's KV heads); each attention
    layer gathers the step's q and new K/V to every head, writes the
    slots the rank holds (the rest to its scratch slot), runs K1 / K2's
    partials over its slots and merges the ranks' in rank order
    (:class:`_Cached`); a cache held whole on every rank (S does not
    divide the group) is attended whole, with no merge."""
    check_arch(cfg)
    if sctx is not None and sctx.tp_size > 1 and sctx.exact \
            and cache is None:
        raise NotImplementedError(
            "the cache-free forward runs the production layout "
            "(exact=False); the engine's exact context is a cached path")
    if cache is None:
        if token_mask is not None or slot_index is not None \
                or within_mask is not None or contiguous_update:
            raise NotImplementedError(
                "the cache-free forward takes no token_mask, tree inputs "
                "or contiguous_update")
        prod = sctx if sctx is not None and not sctx.exact else None
        logits_, aux = _forward_nocache(cfg, params, tokens, positions,
                                        train, aux_inputs, prod)
        return logits_, None, aux
    if (slot_index is None) != (within_mask is None):
        raise ValueError("slot_index and within_mask come together")
    attn_args = None
    if "slot_pos" in cache:
        attn_args = _step_slots(cfg, positions, cache["slot_pos"],
                                span_of(cache), contiguous_update,
                                slot_index, token_mask, within_mask)
    rec = cache if rec_out is None else rec_out
    if production(sctx):
        return _forward_ranks(cfg, params, tokens, cache, attn_args,
                              token_mask, rec, logits,
                              _steps.rows_ctx(sctx, cache))
    dtype = torch_dtype(cfg.dtype)
    x = params["embed"][tokens.long()].to(dtype)
    aux = 0.0
    if cfg.arch_type in ("dense", "moe"):
        x, aux = _decoder_stack(cfg, params, x, cache, attn_args, sctx)
    elif cfg.arch_type == "ssm":
        x = _ssm_stack(cfg, params["layers"], x, token_mask, cache, rec, 0)
    elif cfg.arch_type == "hybrid":
        x = _hybrid_stack(cfg, params, x, token_mask, cache, rec, attn_args,
                          sctx)
    elif cfg.arch_type == "vlm":
        x = _vlm_stack(cfg, params, x, cache, attn_args, sctx)
    else:
        x = _audio_stack(cfg, params, x, cache, attn_args, sctx)
    if not logits:
        return None, cache, aux
    return _unembed(cfg, params, x, sctx), cache, aux
