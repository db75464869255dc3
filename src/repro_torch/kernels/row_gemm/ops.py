"""Wrapper of the row-invariant product kernel (``row_gemm``): build,
checks, launch.

``row_gemm(a, w)`` computes ``a @ w`` for a (..., K) and w (K, N), and
``row_bmm(a, w)`` the batched (E, M, K) x (E, K, N) form, both in a's
dtype (float32 or bfloat16; w must have it too).  A CPU tensor goes to
the plain version (``ref.py``); a CUDA tensor goes to the hand-written
kernel in ``csrc/row_gemm.cu`` or the wrapper raises — there is no
fallback.  The arithmetic of one output row depends only on that row
and on K: one tile shape for every M and N, K in splits whose count is
a function of K and the dtype alone (:func:`n_split`), summed in split
order.  The port routes every product of its engine path here
(``models.common.lin``, the MoE layer's batched products); products
under autograd (the train step) stay ``torch.matmul``.

``a`` needs contiguous rows (its last stride 1; other views are copied),
``w`` contiguous columns or contiguous rows (the tied unembedding's
``embed.T``); any batch and row strides.  The splits' f32 partials live
in a workspace the wrapper allocates; a product whose workspace would
pass ``WORKSPACE_FLOATS`` runs in slices of its rows, which changes no
row's arithmetic.  A call counts one launch however many kernels it
ran.

The kernel is compiled at first use with ``nvcc`` for ``sm_90a`` into a
shared library with a plain C interface, loaded with ``ctypes``, into
``repro_torch/kernels/_build/`` (see ``kernels/build.py``).  Nothing is
compiled or loaded when the module is imported.
"""
from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from repro_torch.kernels.build import KernelLibrary
from repro_torch.kernels.row_gemm.ref import row_bmm_ref, row_gemm_ref

SOURCE = Path(__file__).resolve().parent / "csrc" / "row_gemm.cu"
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
CHUNK = {torch.bfloat16: 2048, torch.float32: 512}  # the library's kChunk*
WORKSPACE_FLOATS = 1 << 26   # 256 MB of split partials at most a launch
_ROWS = 64                   # the kernel's row tile

# launches of the kernel since the last reset (a wrapper adds one where it
# launches its kernel, and nowhere else)
launches = {"row_gemm": 0}


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0


def _declare(lib: ctypes.CDLL) -> None:
    vp, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.row_gemm_launch.argtypes = [i32, vp, vp, vp, vp, i32, i32, i32, i32,
                                    i64, i64, i64, i64, i64, i64, i64, vp]
    lib.row_gemm_launch.restype = i32
    lib.row_gemm_splits.argtypes = [i32, i32]
    lib.row_gemm_splits.restype = i32
    lib.row_gemm_error_string.argtypes = [i32]
    lib.row_gemm_error_string.restype = ctypes.c_char_p


LIBRARY = KernelLibrary("row_gemm", SOURCE, _declare)


def build() -> ctypes.CDLL:
    """Compile (once per source digest) and load the kernel library."""
    return LIBRARY.load()


def n_split(dtype: torch.dtype, K: int) -> int:
    """Splits of K of a product: ceil(K / CHUNK[dtype]), K alone (the
    library's ``row_gemm_splits``, which ``chip_smoke.py`` holds it to)."""
    return max(1, -(-K // CHUNK[dtype]))


def _check(a: torch.Tensor, w: torch.Tensor, what: str) -> None:
    if a.device != w.device:
        raise ValueError(f"{what}: a on {a.device}, w on {w.device}")
    if a.dtype not in _DTYPES or w.dtype != a.dtype:
        raise TypeError(f"{what}: dtypes {a.dtype} / {w.dtype}; want one of "
                        "float32, bfloat16, the same for both")
    if a.shape[-1] != w.shape[-2]:
        raise ValueError(f"{what}: a {tuple(a.shape)} @ w {tuple(w.shape)}")


def _w_strides(w: torch.Tensor) -> tuple:
    """(w, k stride, n stride) of the last two dims, w copied when neither
    is contiguous."""
    sk, sn = w.stride(-2), w.stride(-1)
    if sn != 1 and sk != 1:
        w = w.contiguous()
        sk, sn = w.stride(-2), w.stride(-1)
    return w, sk, sn


def _launch(a, w, out, E, M, N, K, sa_b, sa_m, sw_b, sw_k, sw_n) -> None:
    """The product of rows [0, M) of each batch, in slices of rows whose
    split workspace fits ``WORKSPACE_FLOATS``."""
    lib = build()
    code = _DTYPES[a.dtype]
    splits = n_split(a.dtype, K)
    rows = M
    if splits > 1:
        fit = WORKSPACE_FLOATS // max(splits * E * N, 1)
        rows = min(M, max(_ROWS, fit // _ROWS * _ROWS))
    es = a.element_size()
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream(a.device).cuda_stream
        for m0 in range(0, M, rows):
            mc = min(rows, M - m0)
            ws = (torch.empty(splits * E * mc * N, dtype=torch.float32,
                              device=a.device) if splits > 1 else None)
            err = lib.row_gemm_launch(
                code, a.data_ptr() + m0 * sa_m * es, w.data_ptr(),
                out.data_ptr() + m0 * N * es,
                None if ws is None else ws.data_ptr(), E, mc, N, K, sa_b,
                sa_m, sw_b, sw_k, sw_n, M * N, N, stream)
            if err:
                raise RuntimeError("row_gemm launch failed: "
                                   + lib.row_gemm_error_string(err).decode())


def row_gemm(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """a (..., K) @ w (K, N) -> (..., N) in a's dtype, row-invariant."""
    if a.device.type == "cpu":
        return row_gemm_ref(a, w)
    if a.device.type != "cuda":
        raise ValueError(f"row_gemm: no kernel for device {a.device}")
    _check(a, w, "row_gemm")
    if w.dim() != 2:
        raise ValueError(f"row_gemm: w {tuple(w.shape)} is not a matrix")
    K, N = w.shape
    a2 = a.reshape(-1, K)
    if a2.stride(-1) != 1 and a2.numel():
        a2 = a2.contiguous()
    M = a2.shape[0]
    out = torch.empty((M, N), dtype=a.dtype, device=a.device)
    w, sk, sn = _w_strides(w)
    _launch(a2, w, out, 1, M, N, K, 0, a2.stride(0), 0, sk, sn)
    launches["row_gemm"] += 1
    return out.reshape(*a.shape[:-1], N)


def row_bmm(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """a (E, M, K) @ w (E, K, N) -> (E, M, N) in a's dtype,
    row-invariant; a and w may be strided views (``transpose`` of a
    contiguous tensor)."""
    if a.device.type == "cpu":
        return row_bmm_ref(a, w)
    if a.device.type != "cuda":
        raise ValueError(f"row_bmm: no kernel for device {a.device}")
    _check(a, w, "row_bmm")
    if a.dim() != 3 or w.dim() != 3 or a.shape[0] != w.shape[0]:
        raise ValueError(f"row_bmm: a {tuple(a.shape)}, w {tuple(w.shape)}")
    E, M, K = a.shape
    N = w.shape[2]
    if a.stride(-1) != 1 and a.numel():
        a = a.contiguous()
    out = torch.empty((E, M, N), dtype=a.dtype, device=a.device)
    w, sk, sn = _w_strides(w)
    _launch(a, w, out, E, M, N, K, a.stride(0), a.stride(1), w.stride(0),
            sk, sn)
    launches["row_gemm"] += 1
    return out
