"""Wrappers of the spec-verify (K1) and tree-verify (K2) CUDA kernels:
build, checks, routes, launch.

``spec_verify(q, k, v, q_pos, k_pos, window=)`` computes the function of
``ref.spec_verify_ref``, ``tree_verify(q, k, v, q_pos, k_pos, tree_mask,
window=)`` that of ``ref.tree_verify_ref``.  A CPU tensor goes to the
plain version; a CUDA tensor goes to the hand-written kernels in
``csrc/spec_verify.cu`` or the wrapper raises — there is no fallback.

Inside the library the route of a call is a fixed table of (dtype,
head dim), the same for K1 and K2 and at every T (:func:`plan`): bf16 at
D 64 / 128 on the tensor cores (wgmma on TMA-staged tiles); f32 and the
other head dims on the CUDA cores, where the cache is cut into
``n_split`` shares of a fixed number of slots (a function of S alone)
merged by a second launch in split order.  So a query row's arithmetic
depends only on that row and the cache, never on the call's T, B or
heads: a decode gives the bits of the first position of a verify, a
slot alone those it gets among eight (the row-invariance rule of
``kernels/row_gemm``).  The wrapper allocates the split workspace; a
call counts one launch however many kernels it ran.  A call on a rank's
shard of a layer's heads (tensor parallelism) may pass
``split_like=(Hq, Hk)``, the unsharded layer's head counts, and gets the
unsharded call's n_split (the same: it depends on S alone).

``lse=True`` asks every route for the softmax's partials: the output in
f32 and each row's log-sum-exp (B, T, Hq) f32, -inf where a row sees no
key (its output 0).  A rank that holds a share of the cache's slots
(the production layout) merges the ranks' partials with
``ref.merge_lse``.

The kernels are compiled at first use with ``nvcc`` for ``sm_90a`` into a
shared library with a plain C interface, loaded with ``ctypes``, into
``repro_torch/kernels/_build/`` (listed in ``.gitignore``; see
``kernels/build.py``).  Nothing is compiled or loaded when the module is
imported.
"""
from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from repro_torch.kernels.build import KernelLibrary
from repro_torch.kernels.spec_verify.ref import (f32_scale, spec_verify_ref,
                                                 tree_verify_ref)

SOURCE = Path(__file__).resolve().parent / "csrc" / "spec_verify.cu"
HEAD_DIMS = (32, 64, 128, 256)
MAX_SPLITS = 8          # the library's kMaxSplits
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

# launches of each kernel since the last reset (a wrapper adds one where
# it launches its kernel, and nowhere else)
launches = {"spec_verify": 0, "tree_verify": 0}


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0


# the library's route codes
ROUTES = {1: "cuda_cores", 2: "tensor_cores"}
_ROUTE_CODES = {None: 0, "cuda_cores": 1, "tensor_cores": 2}


def _declare(lib: ctypes.CDLL) -> None:
    vp, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.spec_verify_launch.argtypes = [
        i32, vp, vp, vp, vp, vp, vp, vp, vp, i32, i32, i32, i32, i32, i32,
        i64, i64, i32, ctypes.c_float, i32, i32, vp]
    lib.spec_verify_launch.restype = i32
    lib.tree_verify_launch.argtypes = [
        i32, vp, vp, vp, vp, vp, vp, vp, vp, vp, i32, i32, i32, i32, i32,
        i32, i64, i64, i64, i64, i32, ctypes.c_float, i32, i32, vp]
    lib.tree_verify_launch.restype = i32
    lib.spec_verify_route.argtypes = [i32] * 6
    lib.spec_verify_route.restype = i32
    lib.spec_verify_splits.argtypes = [i32] * 8
    lib.spec_verify_splits.restype = i32
    lib.spec_verify_error_string.argtypes = [i32]
    lib.spec_verify_error_string.restype = ctypes.c_char_p


LIBRARY = KernelLibrary("spec_verify", SOURCE, _declare)


def build() -> ctypes.CDLL:
    """Compile (once per source digest) and load the kernel library."""
    return LIBRARY.load()


_PLANS = {}


def plan(dtype: torch.dtype, B: int, T: int, Hq: int, Hk: int, D: int,
         S: int, route: str = None, n_split: int = None) -> tuple:
    """(route, n_split) of a call of this shape: the library's table (the
    route from dtype and D, n_split from S), or ``route``
    ("cuda_cores" / "tensor_cores") and ``n_split`` where the shape can
    take them; n_split is 1 on the tensor cores, and at most
    ``MAX_SPLITS`` on the CUDA cores.  Kept per shape, so the hot path
    asks the library once."""
    key = (dtype, B, T, Hq, Hk, D, S, route, n_split)
    got = _PLANS.get(key)
    if got is None:
        lib = build()
        want = _ROUTE_CODES[route]
        code = lib.spec_verify_route(_DTYPES[dtype], D, T, Hq, Hk, want)
        if code not in ROUTES:
            raise ValueError(f"spec_verify: no route for {dtype}, head dim "
                             f"{D}, T={T}, Hq={Hq}, Hk={Hk}"
                             + (f" on {route}" if route else ""))
        n = n_split or lib.spec_verify_splits(_DTYPES[dtype], D, B, T, Hq,
                                              Hk, S, want)
        if not 1 <= n <= (MAX_SPLITS if ROUTES[code] == "cuda_cores"
                          else 1):
            raise ValueError(f"spec_verify: {ROUTES[code]} cannot split "
                             f"the cache into {n}")
        got = _PLANS[key] = (ROUTES[code], n)
    return got


def split_of(dtype: torch.dtype, B: int, T: int, D: int, S: int,
             split_like) -> int:
    """n_split for a call on a shard of a layer whose unsharded head
    counts are ``split_like`` (Hq, Hk); None without one."""
    if split_like is None:
        return None
    return plan(dtype, B, T, split_like[0], split_like[1], D, S)[1]


def check_tensor_cores(q, tree_mask=None) -> None:
    """Raise on what the tensor-core route cannot take: TMA reads q, and
    K2's mask, as tiles, so q needs a 16-byte-aligned base and the mask a
    16-byte-aligned base and batch and row strides that are multiples of
    16 bytes (the K/V conditions are ``check_inputs``' own)."""
    if q.data_ptr() % 16:
        raise ValueError("spec_verify (tensor cores): q must start on a "
                         "16-byte boundary")
    if tree_mask is not None and (tree_mask.data_ptr() % 16
                                  or tree_mask.stride(0) % 16
                                  or tree_mask.stride(1) % 16):
        raise ValueError("tree_verify (tensor cores): the mask's base and "
                         "its batch and row strides must be multiples of "
                         f"16 bytes; got strides {tree_mask.stride()}")


def check_inputs(q, k, v, q_pos, k_pos) -> None:
    """Raise on what the kernel does not take: mixed devices, a dtype
    other than float32 / bfloat16 (int32 positions), mismatched shapes,
    a head dim it was not built for, non-contiguous or unaligned rows
    (what the tensor-core route asks besides: ``check_tensor_cores``)."""
    dev = q.device
    for name, t in (("k", k), ("v", v), ("q_pos", q_pos), ("k_pos", k_pos)):
        if t.device != dev:
            raise ValueError(f"spec_verify: {name} on {t.device}, q on {dev}")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"spec_verify: q/k/v dtypes {q.dtype}/{k.dtype}/"
                        f"{v.dtype}; want one of float32, bfloat16")
    if q_pos.dtype != torch.int32 or k_pos.dtype != torch.int32:
        raise TypeError("spec_verify: q_pos and k_pos must be int32")
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(f"spec_verify: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)}")
    B, T, Hq, D = q.shape
    _, S, Hk, Dk = k.shape
    if k.shape[0] != B or Dk != D or Hq % Hk:
        raise ValueError(f"spec_verify: q {tuple(q.shape)} vs k "
                         f"{tuple(k.shape)}")
    if tuple(q_pos.shape) != (B, T) or tuple(k_pos.shape) != (B, S):
        raise ValueError(f"spec_verify: q_pos {tuple(q_pos.shape)}, k_pos "
                         f"{tuple(k_pos.shape)}; want {(B, T)}, {(B, S)}")
    if D not in HEAD_DIMS:
        raise ValueError(f"spec_verify: head dim {D} not in {HEAD_DIMS}")
    if not q.is_contiguous() or not q_pos.is_contiguous():
        raise ValueError("spec_verify: q and q_pos must be contiguous")
    if k.stride()[1:] != (Hk * D, D, 1) or v.stride() != k.stride():
        raise ValueError("spec_verify: k/v need contiguous (S, Hk, D) rows "
                         f"and equal strides; got {k.stride()}, "
                         f"{v.stride()}")
    if k_pos.stride(1) != 1:
        raise ValueError("spec_verify: k_pos rows must be contiguous")
    # the kernel reads K/V rows as 16-byte vectors
    if (k.data_ptr() % 16 or v.data_ptr() % 16
            or k.stride(0) * k.element_size() % 16):
        raise ValueError("spec_verify: k/v rows must be 16-byte aligned")


def check_tree_mask(q, k, tree_mask) -> None:
    """Raise on a tree mask K2 does not take: another device, a dtype
    other than bool / uint8, a shape other than (B, T, S), rows that are
    not contiguous (what the tensor-core route asks besides:
    ``check_tensor_cores``)."""
    if tree_mask.device != q.device:
        raise ValueError(f"tree_verify: tree_mask on {tree_mask.device}, q "
                         f"on {q.device}")
    if tree_mask.dtype not in (torch.bool, torch.uint8):
        raise TypeError(f"tree_verify: tree_mask dtype {tree_mask.dtype}; "
                        "want bool or uint8")
    want = (q.shape[0], q.shape[1], k.shape[1])
    if tuple(tree_mask.shape) != want:
        raise ValueError(f"tree_verify: tree_mask {tuple(tree_mask.shape)}; "
                         f"want {want}")
    if tree_mask.stride(2) != 1:
        raise ValueError("tree_verify: tree_mask rows must be contiguous")


def _launch(name: str, q, k, v, q_pos, k_pos, tree_mask, window,
            route: str = None, n_split: int = None, lse: bool = False):
    """Launch K1 (``tree_mask`` None) or K2 on q's current stream, on the
    table's route or on ``route``, in the table's shares or ``n_split``;
    raise on what that route cannot take and on a refused launch.  With
    ``lse``: (out in f32, the rows' log-sum-exp (B, T, Hq) f32)."""
    B, T, Hq, D = q.shape
    S, Hk = k.shape[1], k.shape[2]
    how, n_split = plan(q.dtype, B, T, Hq, Hk, D, S, route, n_split)
    if how == "tensor_cores":
        check_tensor_cores(q, tree_mask)
    lib = build()
    out = torch.empty(q.shape, dtype=torch.float32 if lse else q.dtype,
                      device=q.device)
    lse_t = (torch.empty((B, T, Hq), dtype=torch.float32, device=q.device)
             if lse else None)
    lse_p = None if lse_t is None else lse_t.data_ptr()
    # the splits' (acc, m, l) in f32, merged into out by the second launch
    ws = (torch.empty(n_split * B * T * Hq * (D + 2), dtype=torch.float32,
                      device=q.device) if n_split > 1 else None)
    part = None if ws is None else ws.data_ptr()
    scale = f32_scale(D)
    code = _ROUTE_CODES[route]
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        head = (_DTYPES[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
                q_pos.data_ptr(), k_pos.data_ptr())
        if tree_mask is None:
            err = lib.spec_verify_launch(
                *head, out.data_ptr(), lse_p, part, B, T, S, Hq, Hk, D,
                k.stride(0),
                k_pos.stride(0), int(window), scale, code, n_split, stream)
        else:
            err = lib.tree_verify_launch(
                *head, tree_mask.data_ptr(), out.data_ptr(), lse_p, part, B,
                T, S, Hq, Hk, D, k.stride(0), k_pos.stride(0),
                tree_mask.stride(0),
                tree_mask.stride(1), int(window), scale, code, n_split,
                stream)
    if err:
        raise RuntimeError(f"{name} launch failed: "
                           + lib.spec_verify_error_string(err).decode())
    launches[name] += 1
    return out if lse_t is None else (out, lse_t)


def spec_verify(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                q_pos: torch.Tensor, k_pos: torch.Tensor, *,
                window: int = 0, split_like=None, lse: bool = False):
    """K1.  q (B,T,Hq,D); k, v (B,S,Hk,D); q_pos (B,T), k_pos (B,S)
    int32; ``split_like`` (Hq, Hk) of the unsharded layer when q, k, v
    are a rank's head shard.  ``lse``: returns (out f32, log-sum-exp
    (B,T,Hq) f32)."""
    if q.device.type == "cpu":
        return spec_verify_ref(q, k, v, q_pos, k_pos, window=window, lse=lse)
    if q.device.type != "cuda":
        raise ValueError(f"spec_verify: no kernel for device {q.device}")
    check_inputs(q, k, v, q_pos, k_pos)
    return _launch("spec_verify", q, k, v, q_pos, k_pos, None, window,
                   n_split=split_of(q.dtype, q.shape[0], q.shape[1],
                                    q.shape[3], k.shape[1], split_like),
                   lse=lse)


def tree_verify(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                q_pos: torch.Tensor, k_pos: torch.Tensor,
                tree_mask: torch.Tensor, *,
                window: int = 0, split_like=None, lse: bool = False):
    """K2: K1's arguments plus ``tree_mask`` (B,T,S) bool or uint8, ANDed
    into the positional mask."""
    if q.device.type == "cpu":
        return tree_verify_ref(q, k, v, q_pos, k_pos, tree_mask,
                               window=window, lse=lse)
    if q.device.type != "cuda":
        raise ValueError(f"tree_verify: no kernel for device {q.device}")
    check_inputs(q, k, v, q_pos, k_pos)
    check_tree_mask(q, k, tree_mask)
    return _launch("tree_verify", q, k, v, q_pos, k_pos, tree_mask, window,
                   n_split=split_of(q.dtype, q.shape[0], q.shape[1],
                                    q.shape[3], k.shape[1], split_like),
                   lse=lse)


def launch_on_route(route: str, q, k, v, q_pos, k_pos, tree_mask=None, *,
                    window: int = 0, lse: bool = False):
    """K1 (or K2, given ``tree_mask``) on CUDA tensors on ``route``
    whatever the table says: for checking both routes of a shape on the
    card and timing one against the other.  The port never calls it."""
    check_inputs(q, k, v, q_pos, k_pos)
    if tree_mask is not None:
        check_tree_mask(q, k, tree_mask)
    name = "spec_verify" if tree_mask is None else "tree_verify"
    return _launch(name, q, k, v, q_pos, k_pos, tree_mask, window, route,
                   lse=lse)
