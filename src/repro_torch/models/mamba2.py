"""Mamba2 (SSD) block: its parameters, the depthwise causal conv and the
block's forward.

Counterpart of ``repro.models.mamba2`` (``init_mamba_block``,
``causal_conv``, ``mamba_block``), dtype step for dtype step.  The SSD
itself is ``kernels.ssd_scan.ssd_chunk_scan``: the hand-written chunk-scan
kernel (K4) on the card, its plain version (``ssd_ref``, the JAX
package's ``ssd`` op for op) on the CPU; in training (the cache-free
forward: a zero conv history and no initial state) it is differentiated
by K4's backward.

In-place recurrent state: :func:`mamba_block` reads the conv window and
the SSM state of its layer and writes the new ones into ``conv_out`` and
``state_out`` when given (K4 writes the final state straight there;
``state_out`` may be the state it read), so a forward updates the cache
without a copy of the state.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.ssd_scan.ops import ssd_chunk_scan
from repro_torch.models.common import gated_rms_norm, lin, rms_norm

# parameters kept in f32 whatever the weight dtype: the norms and Mamba2
# vectors, and the conv weights, which the JAX package uses in f32
# (``causal_conv``); ``in_proj`` and ``out_proj`` go through ``lin``
F32_PARAMS = ("ln", "conv_w", "conv_b", "A_log", "dt_bias", "D", "gn")


def init_mamba_block(cfg: ModelConfig, normal, ones, zeros) -> dict:
    """One block's parameters at the JAX package's scales
    (``init_mamba_block``): ``normal(shape, scale)`` gives a matrix in the
    weight dtype, ``normal(shape, scale, f32=True)`` one in f32 (the conv
    weights, which the reference uses in f32), ``ones(n)`` / ``zeros(n)``
    f32 vectors."""
    d, di = cfg.d_model, cfg.d_inner
    G, N, nh = cfg.ssm_ngroups, cfg.ssm_state, cfg.ssm_nheads
    conv_ch = di + 2 * G * N
    return {
        "ln": ones(d),
        "in_proj": normal((d, 2 * di + 2 * G * N + nh), 1.0 / math.sqrt(d)),
        "conv_w": normal((cfg.ssm_conv, conv_ch),
                         1.0 / math.sqrt(cfg.ssm_conv), f32=True),
        "conv_b": zeros(conv_ch),
        "A_log": zeros(nh),            # A = -exp(A_log) = -1
        "dt_bias": zeros(nh),
        "D": ones(nh),
        "gn": ones(di),
        "out_proj": normal((di, d), 1.0 / math.sqrt(di)),
    }


def causal_conv(x: torch.Tensor, w: torch.Tensor, bias: torch.Tensor,
                cache: torch.Tensor,
                token_mask: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Depthwise causal conv.  x (b,T,ch); w (K,ch); cache (b,K-1,ch).

    ``token_mask`` (b,T) marks valid tokens, always a row prefix; the new
    window ends at each row's last valid token, taken by a gather at
    ``n_valid + arange(K-1)`` on the device (no host read), so masked
    tokens never enter the rolling conv state and a row with no valid
    token keeps its window."""
    K = w.shape[0]
    b, T, ch = x.shape
    if token_mask is not None:
        x = x * token_mask[..., None].to(x.dtype)
    xin = torch.cat([cache, x], dim=1)                 # (b, T+K-1, ch)
    out = torch.zeros((b, T, ch), dtype=torch.float32, device=x.device)
    for i in range(K):
        out = out + xin[:, i:i + T].float() * w[i].float()
    out = out + bias.float()
    if K > 1:
        if token_mask is None:
            new_cache = xin[:, -(K - 1):]
        else:
            n_valid = token_mask.to(torch.int64).sum(dim=1)           # (b,)
            idx = n_valid[:, None] + torch.arange(K - 1, device=x.device)
            new_cache = xin.gather(1, idx[:, :, None].expand(b, K - 1, ch))
    else:
        new_cache = cache
    return out.to(x.dtype), new_cache


def mamba_block(p: dict, x: torch.Tensor, cfg: ModelConfig,
                conv_cache: torch.Tensor, ssm_state: torch.Tensor,
                token_dt_mask: Optional[torch.Tensor] = None, *,
                conv_out: Optional[torch.Tensor] = None,
                state_out: Optional[torch.Tensor] = None):
    """x (b,T,d) -> (x + block(x), new conv window (b,K-1,ch), new state
    (b,nh,P,N) f32).  ``token_dt_mask`` (b,T): 0 for padding — dt is
    forced to 0 there, so padded tokens neither update the state nor
    produce output.  With ``conv_out`` / ``state_out`` the new window and
    state are written there and returned."""
    b, T, d = x.shape
    di, G, N = cfg.d_inner, cfg.ssm_ngroups, cfg.ssm_state
    nh, Pd = cfg.ssm_nheads, cfg.ssm_head_dim

    xn = rms_norm(x, p["ln"], cfg.rms_eps)
    zxbcdt = lin(xn, p["in_proj"])                     # (b,T, 2di+2GN+nh)
    z = zxbcdt[..., :di]
    xbc = zxbcdt[..., di:2 * di + 2 * G * N]
    dt_raw = zxbcdt[..., 2 * di + 2 * G * N:]
    conv, new_conv = causal_conv(xbc, p["conv_w"], p["conv_b"], conv_cache,
                                 token_dt_mask)
    if conv_out is not None:
        new_conv = conv_out.copy_(new_conv)
    cf = conv.float()
    xbc = (cf * torch.sigmoid(cf)).to(x.dtype)
    xs = xbc[..., :di]
    Bm = xbc[..., di:di + G * N].reshape(b, T, G, N)
    Cm = xbc[..., di + G * N:].reshape(b, T, G, N)
    # softplus as jax.nn.softplus computes it: logaddexp(v, 0)
    v = dt_raw.float() + p["dt_bias"].float()
    dt = v.clamp_min(0.0) + torch.log1p(torch.exp(-v.abs()))
    if token_dt_mask is not None:
        dt = dt * token_dt_mask[..., None].float()
    A = -torch.exp(p["A_log"].float())
    xh = xs.reshape(b, T, nh, Pd)
    y, S_new = ssd_chunk_scan(xh, dt, A, Bm, Cm, ssm_state, cfg.ssm_chunk,
                              out_state=state_out)
    y = y + xh.float().to(y.dtype) * p["D"].to(y.dtype)[None, None, :, None]
    y = y.reshape(b, T, di)
    y = gated_rms_norm(y, z, p["gn"], cfg.rms_eps)
    out = lin(y, p["out_proj"])
    return x + out, new_conv, S_new
