"""Wrappers of the row-reduction kernels of the engine path
(``row_reduce``): build, checks, launch.

``rms_norm(x, weight, eps)`` is RMSNorm over x's last dim (``ref.
rms_norm_ref``), ``logsumexp(x)`` the log-sum-exp of the rows of f32
logits (``ref.logsumexp_ref``).  A CPU tensor goes to the plain version;
a CUDA tensor goes to the hand-written kernels in ``csrc/row_reduce.cu``
or the wrapper raises — there is no fallback.  Each row is reduced by
the same 256 threads in the same order whatever the call's row count,
so a row's result depends only on the row (a PyTorch reduction on the
card chooses its threads per row from the row count).

The kernels are compiled at first use with ``nvcc`` for ``sm_90a`` into
a shared library with a plain C interface, loaded with ``ctypes``, into
``repro_torch/kernels/_build/`` (see ``kernels/build.py``).  Nothing is
compiled or loaded when the module is imported.
"""
from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from repro_torch.kernels.build import KernelLibrary
from repro_torch.kernels.row_reduce.ref import logsumexp_ref, rms_norm_ref

SOURCE = Path(__file__).resolve().parent / "csrc" / "row_reduce.cu"
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

# launches of each kernel since the last reset (a wrapper adds one where
# it launches its kernel, and nowhere else)
launches = {"rms_norm": 0, "logsumexp": 0}


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0


def _declare(lib: ctypes.CDLL) -> None:
    vp, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.rms_norm_launch.argtypes = [i32, vp, vp, vp, i32, i32, i64,
                                    ctypes.c_float, vp]
    lib.rms_norm_launch.restype = i32
    lib.logsumexp_launch.argtypes = [vp, vp, i32, i32, i64, vp]
    lib.logsumexp_launch.restype = i32
    lib.row_reduce_error_string.argtypes = [i32]
    lib.row_reduce_error_string.restype = ctypes.c_char_p


LIBRARY = KernelLibrary("row_reduce", SOURCE, _declare)


def build() -> ctypes.CDLL:
    """Compile (once per source digest) and load the kernel library."""
    return LIBRARY.load()


def _rows(x: torch.Tensor) -> torch.Tensor:
    """x as (rows, last dim) with contiguous rows."""
    r = x.reshape(-1, x.shape[-1])
    return r if r.stride(-1) == 1 or not r.numel() else r.contiguous()


def _raise(lib, what: str, err: int) -> None:
    if err:
        raise RuntimeError(f"{what} launch failed: "
                           + lib.row_reduce_error_string(err).decode())


def rms_norm(x: torch.Tensor, weight: torch.Tensor,
             eps: float = 1e-5) -> torch.Tensor:
    """RMSNorm of x (..., d) (float32 or bfloat16) with weight (d,); x's
    dtype out."""
    if x.device.type == "cpu":
        return rms_norm_ref(x, weight, eps)
    if x.device.type != "cuda":
        raise ValueError(f"rms_norm: no kernel for device {x.device}")
    if x.dtype not in _DTYPES:
        raise TypeError(f"rms_norm: dtype {x.dtype}; want float32 or "
                        "bfloat16")
    d = x.shape[-1]
    if weight.shape != (d,) or weight.device != x.device:
        raise ValueError(f"rms_norm: weight {tuple(weight.shape)} on "
                         f"{weight.device} for x {tuple(x.shape)}")
    w = (weight if weight.dtype == torch.float32
         else weight.float()).contiguous()
    rows = _rows(x)
    out = torch.empty(x.shape, dtype=x.dtype, device=x.device)
    lib = build()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.rms_norm_launch(_DTYPES[x.dtype], rows.data_ptr(),
                                  w.data_ptr(), out.data_ptr(),
                                  rows.shape[0], d, rows.stride(0),
                                  float(eps), stream)
    _raise(lib, "rms_norm", err)
    launches["rms_norm"] += 1
    return out


def logsumexp(x: torch.Tensor) -> torch.Tensor:
    """log(sum(exp(x), -1)) of f32 x (..., V) -> (...) f32."""
    if x.device.type == "cpu":
        return logsumexp_ref(x)
    if x.device.type != "cuda":
        raise ValueError(f"logsumexp: no kernel for device {x.device}")
    if x.dtype != torch.float32:
        raise TypeError(f"logsumexp: dtype {x.dtype}; want float32")
    rows = _rows(x)
    out = torch.empty(x.shape[:-1], dtype=torch.float32, device=x.device)
    lib = build()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.logsumexp_launch(rows.data_ptr(), out.data_ptr(),
                                   rows.shape[0], x.shape[-1],
                                   rows.stride(0), stream)
    _raise(lib, "logsumexp", err)
    launches["logsumexp"] += 1
    return out
