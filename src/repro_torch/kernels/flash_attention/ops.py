"""Wrapper of the flash-attention CUDA kernel (K3), forward and backward:
build, checks, launch, and the ``torch.autograd.Function`` that ties
them together.

``flash_attention(q, k, v, q_offset=, causal=, window=)`` computes the
function of ``ref.flash_attention_fwd_ref`` and is differentiable in q,
k and v.  A CPU tensor goes to the plain forward and backward; a CUDA
tensor goes to the hand-written kernels of ``csrc/flash_attention.cu``
(the forward, which also writes each row's log-sum-exp, then dQ and
dK/dV in the backward) or the wrapper raises — there is no fallback.
Inside the library the route is a fixed table of (dtype, head dim):
bf16 at D 64 and 128 runs on the tensor cores (wgmma on TMA-staged
tiles), f32 and bf16 at D 32 and 256 on the CUDA cores (:func:`route`).
The ``autograd.Function`` keeps nothing outside its ``ctx``, so it is
safe under ``torch.utils.checkpoint``'s recompute (which runs its forward
a second time).

The library is compiled at first use (``kernels/build.py``); nothing is
compiled or loaded when the module is imported.
"""
from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from repro_torch.kernels.build import KernelLibrary
from repro_torch.kernels.flash_attention.ref import (flash_attention_bwd_ref,
                                                     flash_attention_fwd_ref)
from repro_torch.kernels.spec_verify.ref import f32_scale

SOURCE = Path(__file__).resolve().parent / "csrc" / "flash_attention.cu"
HEAD_DIMS = (32, 64, 128, 256)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

# launches of each kernel since the last reset (a wrapper adds one where
# it launches its kernel, and nowhere else)
launches = {"flash_attention": 0, "flash_attention_dq": 0,
            "flash_attention_dkdv": 0}


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0


def _declare(lib: ctypes.CDLL) -> None:
    vp, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    dims = [i32] * 9          # B, Tq, Tk, Hq, Hk, D, q_offset, causal, window
    lib.flash_attention_fwd_launch.argtypes = [i32] + [vp] * 5 + dims + [
        f32, vp]
    lib.flash_attention_dq_launch.argtypes = [i32] + [vp] * 7 + dims + [
        f32, vp]
    lib.flash_attention_dkdv_launch.argtypes = [i32] + [vp] * 8 + dims + [
        f32, vp]
    for fn in (lib.flash_attention_fwd_launch, lib.flash_attention_dq_launch,
               lib.flash_attention_dkdv_launch):
        fn.restype = i32
    lib.flash_attention_route.argtypes = [i32, i32]
    lib.flash_attention_route.restype = i32
    lib.flash_attention_error_string.argtypes = [i32]
    lib.flash_attention_error_string.restype = ctypes.c_char_p


LIBRARY = KernelLibrary("flash_attention", SOURCE, _declare)
_ROUTES = {1: "cuda_cores", 2: "tensor_cores"}
# the grid's y dimension carries B * Hk (CUDA caps it at 65535)
MAX_B_HK = 65535


def route(dtype: torch.dtype, head_dim: int) -> str:
    """The library's route for (dtype, head dim): "tensor_cores" or
    "cuda_cores" (asks the built library, whose table decides)."""
    code = LIBRARY.load().flash_attention_route(_DTYPES[dtype], head_dim)
    if code not in _ROUTES:
        raise ValueError(f"flash_attention: no route for {dtype}, head dim "
                         f"{head_dim}")
    return _ROUTES[code]


def check_inputs(q, k, v, *, q_offset: int, window: int) -> None:
    """Raise on what the kernel does not take: mixed devices, a dtype
    other than float32 / bfloat16, mismatched shapes, a head dim it was
    not built for, more (batch, KV head) pairs than the grid holds,
    non-contiguous or unaligned tensors (TMA and the 16-byte loads need
    16-byte-aligned rows), a negative offset or window."""
    dev = q.device
    for name, t in (("k", k), ("v", v)):
        if t.device != dev:
            raise ValueError(f"flash_attention: {name} on {t.device}, q on "
                             f"{dev}")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash_attention: q/k/v dtypes {q.dtype}/"
                        f"{k.dtype}/{v.dtype}; want one of float32, "
                        "bfloat16")
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(f"flash_attention: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)}")
    B, _, Hq, D = q.shape
    if k.shape[0] != B or k.shape[3] != D or Hq % k.shape[2]:
        raise ValueError(f"flash_attention: q {tuple(q.shape)} vs k "
                         f"{tuple(k.shape)}")
    if D not in HEAD_DIMS:
        raise ValueError(f"flash_attention: head dim {D} not in "
                         f"{HEAD_DIMS}")
    if B * k.shape[2] > MAX_B_HK:
        raise ValueError(f"flash_attention: B * Hk = {B * k.shape[2]} "
                         f"exceeds the grid's {MAX_B_HK}")
    if q_offset < 0 or window < 0:
        raise ValueError(f"flash_attention: q_offset {q_offset}, window "
                         f"{window}; want both >= 0")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not t.is_contiguous():
            raise ValueError(f"flash_attention: {name} must be contiguous")
        # the kernels read rows as 16-byte vectors
        if t.data_ptr() % 16:
            raise ValueError(f"flash_attention: {name} must be 16-byte "
                             "aligned")


def _dims(q, k, q_offset, causal, window):
    B, Tq, Hq, D = q.shape
    Tk, Hk = k.shape[1], k.shape[2]
    return (B, Tq, Tk, Hq, Hk, D, int(q_offset), int(bool(causal)),
            int(window))


def _raise_on(lib, name: str, err: int) -> None:
    if err:
        raise RuntimeError(f"{name} launch failed: "
                           + lib.flash_attention_error_string(err).decode())


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def forward_kernel(q, k, v, *, q_offset: int = 0, causal: bool = True,
                   window: int = 0):
    """K3's forward on q's current stream -> (o, lse (B,Hq,Tq) f32)."""
    lib = LIBRARY.load()
    dims = _dims(q, k, q_offset, causal, window)
    B, Tq, Hq = q.shape[:3]
    out = torch.empty_like(q)
    lse = torch.empty((B, Hq, Tq), dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        err = lib.flash_attention_fwd_launch(
            _DTYPES[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
            out.data_ptr(), lse.data_ptr(), *dims, f32_scale(q.shape[3]),
            _stream(q))
    _raise_on(lib, "flash_attention", err)
    launches["flash_attention"] += 1
    return out, lse


def bwd_delta(o: torch.Tensor, do: torch.Tensor) -> torch.Tensor:
    """Delta = rowsum(dO * O) in f32, (B,Hq,Tq): one torch reduction."""
    return (do.float() * o.float()).sum(-1).transpose(1, 2).contiguous()


def _bwd_launch(which: str, q, k, v, do, lse, delta, outs, q_offset,
                causal, window) -> None:
    lib = LIBRARY.load()
    dims = _dims(q, k, q_offset, causal, window)
    fn = getattr(lib, f"{which}_launch")
    with torch.cuda.device(q.device):
        err = fn(_DTYPES[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
                 do.data_ptr(), lse.data_ptr(), delta.data_ptr(),
                 *[t.data_ptr() for t in outs], *dims,
                 f32_scale(q.shape[3]), _stream(q))
    _raise_on(lib, which, err)
    launches[which] += 1


def dq_kernel(q, k, v, do, lse, delta, *, q_offset: int = 0,
              causal: bool = True, window: int = 0) -> torch.Tensor:
    """K3's dQ on q's current stream (``do`` contiguous)."""
    dq = torch.empty_like(q)
    _bwd_launch("flash_attention_dq", q, k, v, do, lse, delta, (dq,),
                q_offset, causal, window)
    return dq


def dkdv_kernel(q, k, v, do, lse, delta, *, q_offset: int = 0,
                causal: bool = True, window: int = 0):
    """K3's dK/dV on q's current stream (``do`` contiguous)."""
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    _bwd_launch("flash_attention_dkdv", q, k, v, do, lse, delta, (dk, dv),
                q_offset, causal, window)
    return dk, dv


def backward_kernels(q, k, v, o, lse, do, *, q_offset: int = 0,
                     causal: bool = True, window: int = 0):
    """K3's backward on q's current stream: dQ, then dK/dV -> (dq, dk,
    dv)."""
    do = do.contiguous()
    delta = bwd_delta(o, do)
    kw = dict(q_offset=q_offset, causal=causal, window=window)
    dq = dq_kernel(q, k, v, do, lse, delta, **kw)
    dk, dv = dkdv_kernel(q, k, v, do, lse, delta, **kw)
    return dq, dk, dv


class _FlashAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, q_offset, causal, window):
        kw = dict(q_offset=q_offset, causal=causal, window=window)
        if q.device.type == "cpu":
            o, lse = flash_attention_fwd_ref(q, k, v, **kw)
        else:
            o, lse = forward_kernel(q, k, v, **kw)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.kw = kw
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        if q.device.type == "cpu":
            dq, dk, dv = flash_attention_bwd_ref(q, k, v, o, lse, do,
                                                 **ctx.kw)
        else:
            dq, dk, dv = backward_kernels(q, k, v, o, lse, do, **ctx.kw)
        return dq, dk, dv, None, None, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    q_offset: int = 0, causal: bool = True,
                    window: int = 0) -> torch.Tensor:
    """K3.  q (B,Tq,Hq,D) at positions q_offset.., k, v (B,Tk,Hk,D) at
    0..Tk-1 -> (B,Tq,Hq,D); differentiable in q, k, v."""
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"flash_attention: no kernel for device {q.device}")
    if q.device.type == "cuda":
        check_inputs(q, k, v, q_offset=q_offset, window=window)
    return _FlashAttention.apply(q, k, v, int(q_offset), bool(causal),
                                 int(window))
