"""Wrapper of the SSD chunk-scan CUDA kernel (K4): build, checks, launch.

``ssd_chunk_scan(x, dt, A, Bm, Cm, init_state, chunk)`` computes the
function of ``ref.ssd_ref`` (the JAX package's
``repro.kernels.ssd_scan.ops.ssd_chunk_scan``, same signature and
contract).  A CPU tensor goes to the plain version; a CUDA tensor goes
to the hand-written kernel in ``csrc/ssd_scan.cu`` or the wrapper raises
— there is no fallback.  ``out_state`` names the tensor that receives the
final state (it may be ``init_state`` itself: the model updates its
recurrent cache in place).

The kernel is compiled at first use with ``nvcc`` for ``sm_90a`` into a
shared library with a plain C interface, loaded with ``ctypes``, into
``repro_torch/kernels/_build/`` (see ``kernels/build.py``).  Nothing is
compiled or loaded when the module is imported.
"""
from __future__ import annotations

import ctypes
from pathlib import Path
from typing import Optional, Tuple

import torch

from repro_torch.kernels.build import KernelLibrary
from repro_torch.kernels.ssd_scan.ref import ssd_ref

SOURCE = Path(__file__).resolve().parent / "csrc" / "ssd_scan.cu"
MAX_CHUNK = 256
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

# launches of the kernel since the last reset (the wrapper adds one where
# it launches it, and nowhere else)
launches = {"ssd_scan": 0}


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0


def _declare(lib: ctypes.CDLL) -> None:
    vp, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.ssd_scan_launch.argtypes = [i32] + [vp] * 8 + [i32] * 7 \
        + [i64] * 11 + [vp]
    lib.ssd_scan_launch.restype = i32
    lib.ssd_scan_error_string.argtypes = [i32]
    lib.ssd_scan_error_string.restype = ctypes.c_char_p


LIBRARY = KernelLibrary("ssd_scan", SOURCE, _declare)


def build() -> ctypes.CDLL:
    """Compile (once per source digest) and load the kernel library."""
    return LIBRARY.load()


def check_inputs(x, dt, A, Bm, Cm, init_state, out_state, chunk) -> None:
    """Raise on what the kernel does not take: mixed devices, x/B/C other
    than float32 or bfloat16 (or of different dtypes), dt/A/states other
    than float32, mismatched shapes, a last dim that is not contiguous,
    states that are not contiguous, a chunk over 256.  A state too large
    for shared memory fails at launch, and the wrapper raises then."""
    dev = x.device
    named = (("dt", dt), ("A", A), ("Bm", Bm), ("Cm", Cm),
             ("init_state", init_state), ("out_state", out_state))
    for name, t in named:
        if t is not None and t.device != dev:
            raise ValueError(f"ssd_chunk_scan: {name} on {t.device}, x on "
                             f"{dev}")
    if x.dtype not in _DTYPES or Bm.dtype != x.dtype or Cm.dtype != x.dtype:
        raise TypeError(f"ssd_chunk_scan: x/B/C dtypes {x.dtype}/{Bm.dtype}/"
                        f"{Cm.dtype}; want one of float32, bfloat16")
    for name, t in named[:2] + named[4:]:
        if t is not None and t.dtype != torch.float32:
            raise TypeError(f"ssd_chunk_scan: {name} must be float32")
    if x.dim() != 4 or Bm.dim() != 4 or Cm.shape != Bm.shape:
        raise ValueError(f"ssd_chunk_scan: x {tuple(x.shape)}, B "
                         f"{tuple(Bm.shape)}, C {tuple(Cm.shape)}")
    b, T, nh, P = x.shape
    G, N = Bm.shape[2], Bm.shape[3]
    if tuple(Bm.shape[:2]) != (b, T) or nh % G or T < 1:
        raise ValueError(f"ssd_chunk_scan: x {tuple(x.shape)} vs B "
                         f"{tuple(Bm.shape)}")
    if tuple(dt.shape) != (b, T, nh) or tuple(A.shape) != (nh,):
        raise ValueError(f"ssd_chunk_scan: dt {tuple(dt.shape)}, A "
                         f"{tuple(A.shape)}")
    for name, t in (("init_state", init_state), ("out_state", out_state)):
        if t is not None and (tuple(t.shape) != (b, nh, P, N)
                              or not t.is_contiguous()):
            raise ValueError(f"ssd_chunk_scan: {name} {tuple(t.shape)} "
                             f"must be a contiguous {(b, nh, P, N)}")
    if (x.stride(3) != 1 or Bm.stride(3) != 1 or Cm.stride(3) != 1
            or dt.stride(2) != 1 or not A.is_contiguous()):
        raise ValueError("ssd_chunk_scan: x, B, C and dt need a contiguous "
                         "last dim, A contiguous")
    if not 1 <= min(chunk, T) <= MAX_CHUNK:
        raise ValueError(f"ssd_chunk_scan: chunk {min(chunk, T)} not in "
                         f"1..{MAX_CHUNK}")


def ssd_chunk_scan(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                   Bm: torch.Tensor, Cm: torch.Tensor,
                   init_state: Optional[torch.Tensor], chunk: int, *,
                   out_state: Optional[torch.Tensor] = None
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K4.  x (b,T,nh,P); dt (b,T,nh); A (nh,); Bm, Cm (b,T,G,N);
    init_state (b,nh,P,N) f32 or None -> (y (b,T,nh,P) in x's dtype,
    final state (b,nh,P,N) f32, which is ``out_state`` when given)."""
    if x.device.type == "cpu":
        y, state = ssd_ref(x, dt, A, Bm, Cm, init_state, chunk)
        if out_state is not None:
            state = out_state.copy_(state)
        return y, state
    if x.device.type != "cuda":
        raise ValueError(f"ssd_chunk_scan: no kernel for device {x.device}")
    b, T, nh, P = x.shape
    G, N = Bm.shape[2], Bm.shape[3]
    if out_state is None:
        out_state = torch.empty((b, nh, P, N), dtype=torch.float32,
                                device=x.device)
    check_inputs(x, dt, A, Bm, Cm, init_state, out_state, chunk)
    lib = build()
    y = torch.empty((b, T, nh, P), dtype=x.dtype, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.ssd_scan_launch(
            _DTYPES[x.dtype], x.data_ptr(), dt.data_ptr(), A.data_ptr(),
            Bm.data_ptr(), Cm.data_ptr(),
            None if init_state is None else init_state.data_ptr(),
            y.data_ptr(), out_state.data_ptr(), b, T, nh, P, G, N,
            min(chunk, T), x.stride(0), x.stride(1), x.stride(2),
            dt.stride(0), dt.stride(1), Bm.stride(0), Bm.stride(1),
            Bm.stride(2), Cm.stride(0), Cm.stride(1), Cm.stride(2), stream)
    if err:
        raise RuntimeError("ssd_scan launch failed: "
                           + lib.ssd_scan_error_string(err).decode())
    launches["ssd_scan"] += 1
    return y, out_state
