"""Wrapper of the SSD chunk-scan CUDA kernel (K4): build, checks, routes,
launch.

``ssd_chunk_scan(x, dt, A, Bm, Cm, init_state, chunk)`` computes the
function of ``ref.ssd_ref`` (the JAX package's
``repro.kernels.ssd_scan.ops.ssd_chunk_scan``, same signature and
contract).  A CPU tensor goes to the plain version; a CUDA tensor goes
to the hand-written kernels in ``csrc/ssd_scan.cu`` or the wrapper raises
— there is no fallback.  ``out_state`` names the tensor that receives the
final state (it may be ``init_state`` itself: the model updates its
recurrent cache in place).

Inside the library the route of a call is a fixed table of its shape
(dtype, T, P, N) (:func:`plan`): steps up to T = 16 (decode among them)
take the recurrent route, one pass per token on the state in registers
(every dtype), wider bf16 steps the tensor cores (``mma.sync``), the
rest the CUDA cores; each route splits the state's P rows over
``n_split`` CTAs, a function of the shape, and its results are bitwise
the same whatever ``n_split`` is.  A shape no route takes (N not a
multiple of 4) is refused.  A call counts one launch whatever it runs.

Training differentiates it: where autograd records (grad mode on and an
input that requires a gradient), ``ssd_chunk_scan`` is a
``torch.autograd.Function`` whose forward is K4 and whose backward is
:func:`ssd_scan_bwd`, K4's backward (``csrc/ssd_scan_bwd.cu``, which the
port adds: the JAX package differentiates its plain ``ssd`` by
autodiff), or on a CPU tensor their plain versions (``ref.ssd_ref`` and
``ref.ssd_bwd_ref``).  The Function keeps nothing outside its ``ctx``,
so ``torch.utils.checkpoint``'s recompute may run its forward again.
The backward's route is a table of (dtype, P, N, Q) (:func:`plan_bwd`):
bf16 takes the tensor cores, f32 the CUDA cores (which also take bf16
when forced, :func:`launch_bwd_on_route`); P must be a multiple of 32
and N of 16, both up to 128.  Its only workspace is per chunk and per
row, never a Q x Q matrix (:func:`bwd_scratch_floats`).

The kernels are compiled at first use with ``nvcc`` for ``sm_90a`` into
shared libraries with a plain C interface (one for the forward, one for
the backward), loaded with ``ctypes``, into
``repro_torch/kernels/_build/`` (see ``kernels/build.py``).  Nothing is
compiled or loaded when the module is imported.
"""
from __future__ import annotations

import ctypes
from pathlib import Path
from typing import Optional, Tuple

import torch

from repro_torch.kernels.build import KernelLibrary
from repro_torch.kernels.ssd_scan.ref import (BLOCK, BWD_ROUTES,
                                              ssd_bwd_ref, ssd_bwd_split_ref,
                                              ssd_ref, ssd_split_ref)

SOURCE = Path(__file__).resolve().parent / "csrc" / "ssd_scan.cu"
BWD_SOURCE = Path(__file__).resolve().parent / "csrc" / "ssd_scan_bwd.cu"
MAX_CHUNK = 256
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

# launches of the kernel since the last reset (the wrapper adds one where
# it launches it, and nowhere else)
launches = {"ssd_scan": 0, "ssd_scan_bwd": 0}


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0


# the library's route codes
ROUTES = {1: "recurrent", 2: "tensor_cores", 3: "cuda_cores"}
_ROUTE_CODES = {None: 0, "recurrent": 1, "tensor_cores": 2, "cuda_cores": 3}
# the tensor-core kernel's instances, (N, rows of the state per CTA)
TC_INSTANCES = [(n, pt) for n in (16, 32, 64, 128) for pt in (16, 32, 64)
                if (n // 8) * (pt // 16) % 8 == 0]


def _declare(lib: ctypes.CDLL) -> None:
    vp, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.ssd_scan_launch.argtypes = [i32] + [vp] * 8 + [i32] * 7 \
        + [i64] * 11 + [i32, i32, vp]
    lib.ssd_scan_launch.restype = i32
    lib.ssd_scan_route.argtypes = [i32] * 5
    lib.ssd_scan_route.restype = i32
    lib.ssd_scan_splits.argtypes = [i32] * 7
    lib.ssd_scan_splits.restype = i32
    lib.ssd_scan_split_ok.argtypes = [i32] * 6
    lib.ssd_scan_split_ok.restype = i32
    lib.ssd_scan_error_string.argtypes = [i32]
    lib.ssd_scan_error_string.restype = ctypes.c_char_p


def _declare_bwd(lib: ctypes.CDLL) -> None:
    vp, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.ssd_scan_bwd_launch.argtypes = [i32] + [vp] * 15 + [i32] * 7 \
        + [i64] * 14 + [i32, i32, vp]
    lib.ssd_scan_bwd_launch.restype = i32
    lib.ssd_scan_bwd_route.argtypes = [i32] * 5
    lib.ssd_scan_bwd_route.restype = i32
    lib.ssd_scan_bwd_error_string.argtypes = [i32]
    lib.ssd_scan_bwd_error_string.restype = ctypes.c_char_p


LIBRARY = KernelLibrary("ssd_scan", SOURCE, _declare)
BWD_LIBRARY = KernelLibrary("ssd_scan_bwd", BWD_SOURCE, _declare_bwd)


def build() -> ctypes.CDLL:
    """Compile (once per source digest) and load the kernel library."""
    return LIBRARY.load()


_PLANS = {}


def plan(dtype: torch.dtype, b: int, T: int, nh: int, P: int, N: int,
         route: str = None, n_split: int = None) -> tuple:
    """(route, n_split) of a call of this shape: the library's table, or
    ``route`` ("recurrent" / "tensor_cores" / "cuda_cores") and ``n_split``
    where the shape can take them.  Kept per shape, so the hot path asks
    the library once."""
    key = (dtype, b, T, nh, P, N, route, n_split)
    got = _PLANS.get(key)
    if got is None:
        lib = build()
        want = _ROUTE_CODES[route]
        code = lib.ssd_scan_route(_DTYPES[dtype], T, P, N, want)
        if code not in ROUTES:
            raise ValueError(f"ssd_chunk_scan: no route for {dtype}, T={T}, "
                             f"P={P}, N={N}"
                             + (f" on {route}" if route else ""))
        n = n_split or lib.ssd_scan_splits(_DTYPES[dtype], b, T, nh, P, N,
                                           code)
        if not lib.ssd_scan_split_ok(code, _DTYPES[dtype], T, P, N, n):
            raise ValueError(f"ssd_chunk_scan: {ROUTES[code]} cannot split "
                             f"P={P} (T={T}, N={N}) into {n}")
        got = _PLANS[key] = (ROUTES[code], n)
    return got


def routes_of(dtype: torch.dtype, T: int, P: int, N: int) -> tuple:
    """Every route a shape can take, the table's first."""
    lib = build()
    first = ROUTES[lib.ssd_scan_route(_DTYPES[dtype], T, P, N, 0)]
    return (first,) + tuple(
        r for code, r in ROUTES.items() if r != first
        and lib.ssd_scan_route(_DTYPES[dtype], T, P, N, code) == code)


def split_options(route: str, dtype: torch.dtype, T: int, P: int,
                  N: int) -> tuple:
    """The n_split values (powers of two) ``route`` can take at this
    shape."""
    lib = build()
    code = _ROUTE_CODES[route]
    return tuple(n for n in (1 << k for k in range(P.bit_length()))
                 if lib.ssd_scan_split_ok(code, _DTYPES[dtype], T, P, N, n))


def check_inputs(x, dt, A, Bm, Cm, init_state, out_state, chunk) -> None:
    """Raise on what the kernel does not take: mixed devices, x/B/C other
    than float32 or bfloat16 (or of different dtypes), dt/A/states other
    than float32, mismatched shapes, a last dim that is not contiguous,
    states that are not contiguous or do not start on a 16-byte boundary
    (every route moves the state in 16-byte vectors), a chunk over 256.
    A state too large for shared memory fails at launch, and the wrapper
    raises then."""
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
        if t is not None and t.data_ptr() % 16:
            raise ValueError(f"ssd_chunk_scan: {name} starts at an address "
                             f"{t.data_ptr() % 16} bytes past a 16-byte "
                             f"boundary; the state moves in 16-byte vectors")
    if (x.stride(3) != 1 or Bm.stride(3) != 1 or Cm.stride(3) != 1
            or dt.stride(2) != 1 or not A.is_contiguous()):
        raise ValueError("ssd_chunk_scan: x, B, C and dt need a contiguous "
                         "last dim, A contiguous")
    if not 1 <= min(chunk, T) <= MAX_CHUNK:
        raise ValueError(f"ssd_chunk_scan: chunk {min(chunk, T)} not in "
                         f"1..{MAX_CHUNK}")


def _launch(x, dt, A, Bm, Cm, init_state, chunk, out_state, route=None,
            n_split=None):
    """K4 on x's current stream, on the table's route and split or on the
    given ones; raise on a shape the route cannot take and on a refused
    launch."""
    b, T, nh, P = x.shape
    G, N = Bm.shape[2], Bm.shape[3]
    if out_state is None:
        out_state = torch.empty((b, nh, P, N), dtype=torch.float32,
                                device=x.device)
    check_inputs(x, dt, A, Bm, Cm, init_state, out_state, chunk)
    how, n = plan(x.dtype, b, T, nh, P, N, route, n_split)
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
            Bm.stride(2), Cm.stride(0), Cm.stride(1), Cm.stride(2),
            _ROUTE_CODES[how], n, stream)
    if err:
        raise RuntimeError(f"ssd_scan launch failed ({how}, n_split {n}): "
                           + lib.ssd_scan_error_string(err).decode())
    launches["ssd_scan"] += 1
    return y, out_state


def _check_grad_state(name: str, t, shape) -> None:
    if t is not None and (tuple(t.shape) != shape or not t.is_contiguous()
                          or t.dtype != torch.float32 or t.data_ptr() % 16):
        raise ValueError(f"ssd_scan_bwd: {name} must be a contiguous f32 "
                         f"{shape} on a 16-byte boundary")


# the backward's route codes (K4's forward's names)
_BWD_CODES = {None: 0, "tensor_cores": 2, "cuda_cores": 3}
_BWD_PLANS = {}


def plan_bwd(dtype: torch.dtype, P: int, N: int, Q: int,
             route: str = None) -> str:
    """The backward's route at this shape: the library's table, or
    ``route`` ("tensor_cores" / "cuda_cores") where the shape can take it;
    raise where it cannot.  Kept per shape."""
    key = (dtype, P, N, Q, route)
    got = _BWD_PLANS.get(key)
    if got is None:
        if route not in _BWD_CODES:
            raise ValueError(f"ssd_scan_bwd: no route {route!r}; want one "
                             f"of {BWD_ROUTES}")
        code = BWD_LIBRARY.load().ssd_scan_bwd_route(
            _DTYPES[dtype], P, N, Q, _BWD_CODES[route])
        if not code:
            raise ValueError(f"ssd_scan_bwd: no route for {dtype}, P={P}, "
                             f"N={N}, Q={Q}" + (f" on {route}" if route
                                                else ""))
        got = _BWD_PLANS[key] = ROUTES[code]
    return got


def bwd_routes_of(dtype: torch.dtype, P: int, N: int, Q: int) -> tuple:
    """Every route the backward can take at this shape, the table's
    first."""
    first = plan_bwd(dtype, P, N, Q)
    lib = BWD_LIBRARY.load()
    return (first,) + tuple(
        r for r in BWD_ROUTES if r != first and lib.ssd_scan_bwd_route(
            _DTYPES[dtype], P, N, Q, _BWD_CODES[r]))


# the backward's rows and cols grids: at least two CTAs per SM of 132
TARGET_CTAS = 264


def heads_per_cta(b: int, T: int, nh: int, G: int, chunk: int) -> int:
    """Heads one rows or cols CTA of the backward takes: the group's,
    halved while the (batch row, chunk, group, block) grid would not fill
    the card twice over."""
    Q = min(chunk, T)
    base = b * -(-T // Q) * G * -(-Q // BLOCK)
    hs = nh // G
    while base * (nh // G // hs) < TARGET_CTAS and hs % 2 == 0:
        hs //= 2
    return hs


def bwd_scratch_floats(b: int, T: int, nh: int, P: int, G: int, N: int,
                       chunk: int) -> int:
    """f32 elements of the backward's workspace, in the library's order:
    the chunk states S_c and their gradients dS_c (b, nc, nh, P, N) each;
    cs and dt (b, nc, nh, Qs) each, Qs = the chunk in whole blocks of 64;
    G's row and column sums per tile (b, nc, nh, tiles, 64) each; Mg^T C
    and Mg B per tile (b, nc, G, tiles, 64, N) each; the boundary terms
    per slice of heads (b, nc, G, blocks, 2, slices, 64, N); v and u (b,
    nc, nh, 2, Qs); dA's parts (b, nc, nh).  Nothing of it is Q x Q."""
    Q = min(chunk, T)
    nc, nbq = -(-T // Q), -(-Q // BLOCK)
    ntq, Qs = nbq * (nbq + 1) // 2, nbq * BLOCK
    bch, bcg = b * nc * nh, b * nc * G
    slices = nh // G // heads_per_cta(b, T, nh, G, chunk)
    return (2 * bch * P * N + 2 * bch * Qs + 2 * bch * ntq * BLOCK
            + 2 * bcg * ntq * BLOCK * N + bcg * nbq * 2 * slices * BLOCK * N
            + 2 * bch * Qs + bch)


def _launch_bwd(x, dt, A, Bm, Cm, init_state, chunk, dy, dstate,
                route=None):
    """K4's backward on x's current stream, on the table's route or the
    given one -> (dx, ddt, dA, dBm, dCm, dinit or None); raise on what it
    does not take and on a refused launch."""
    check_inputs(x, dt, A, Bm, Cm, init_state, None, chunk)
    b, T, nh, P = x.shape
    G, N = Bm.shape[2], Bm.shape[3]
    if dy.dtype != x.dtype or tuple(dy.shape) != (b, T, nh, P) \
            or dy.device != x.device:
        raise ValueError(f"ssd_scan_bwd: dy {tuple(dy.shape)} {dy.dtype}; "
                         f"want x's {(b, T, nh, P)} {x.dtype}")
    dy = dy if dy.stride(3) == 1 else dy.contiguous()
    _check_grad_state("dstate", dstate, (b, nh, P, N))
    Q = min(chunk, T)
    how = plan_bwd(x.dtype, P, N, Q, route)
    lib = BWD_LIBRARY.load()
    dev, f32 = x.device, torch.float32

    def empty(*shape, dtype=f32):
        return torch.empty(shape, dtype=dtype, device=dev)
    dx = empty(b, T, nh, P, dtype=x.dtype)
    ddt, dA = empty(b, T, nh), empty(nh)
    dB, dC = empty(b, T, G, N), empty(b, T, G, N)
    dinit = None if init_state is None else empty(b, nh, P, N)
    scratch = empty(bwd_scratch_floats(b, T, nh, P, G, N, chunk))

    def ptr(t):
        return None if t is None else t.data_ptr()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.ssd_scan_bwd_launch(
            _DTYPES[x.dtype], *map(ptr, (
                x, dt, A, Bm, Cm, init_state, dy, dstate, dx, ddt, dA, dB,
                dC, dinit, scratch)),
            b, T, nh, P, G, N, Q, x.stride(0), x.stride(1), x.stride(2),
            dy.stride(0), dy.stride(1), dy.stride(2), dt.stride(0),
            dt.stride(1), Bm.stride(0), Bm.stride(1), Bm.stride(2),
            Cm.stride(0), Cm.stride(1), Cm.stride(2),
            heads_per_cta(b, T, nh, G, chunk), _BWD_CODES[how], stream)
    if err:
        raise RuntimeError(f"ssd_scan_bwd launch failed ({how}): "
                           + lib.ssd_scan_bwd_error_string(err).decode())
    launches["ssd_scan_bwd"] += 1
    return dx, ddt, dA, dB, dC, dinit


def ssd_scan_bwd(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                 Bm: torch.Tensor, Cm: torch.Tensor,
                 init_state: Optional[torch.Tensor], chunk: int,
                 dy: torch.Tensor, dstate: Optional[torch.Tensor] = None):
    """K4's backward: the gradients of ``ssd_chunk_scan``'s (y, final
    state) given ``dy`` (b,T,nh,P) in x's dtype and ``dstate``
    (b,nh,P,N) f32 or None (zero) -> (dx in x's dtype, ddt, dA, dBm,
    dCm f32, dinit f32 or None when ``init_state`` is None).  A CPU
    tensor goes to ``ref.ssd_bwd_ref``, a CUDA tensor to the kernel."""
    if x.device.type == "cpu":
        return ssd_bwd_ref(x, dt, A, Bm, Cm, init_state, chunk, dy, dstate)
    if x.device.type != "cuda":
        raise ValueError(f"ssd_scan_bwd: no kernel for device {x.device}")
    return _launch_bwd(x, dt, A, Bm, Cm, init_state, chunk, dy, dstate)


def _forward(x, dt, A, Bm, Cm, init_state, chunk, out_state):
    """K4 on a CUDA tensor, its plain version ``ssd_ref`` on a CPU one."""
    if x.device.type == "cpu":
        y, state = ssd_ref(x, dt, A, Bm, Cm, init_state, chunk)
        if out_state is not None:
            state = out_state.copy_(state)
        return y, state
    if x.device.type != "cuda":
        raise ValueError(f"ssd_chunk_scan: no kernel for device {x.device}")
    return _launch(x, dt, A, Bm, Cm, init_state, chunk, out_state)


class _SSDScan(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dt, A, Bm, Cm, init_state, chunk):
        ctx.set_materialize_grads(False)
        y, state = _forward(x, dt, A, Bm, Cm, init_state, chunk, None)
        ctx.save_for_backward(x, dt, A, Bm, Cm, init_state)
        ctx.chunk = chunk
        return y, state

    @staticmethod
    def backward(ctx, dy, dstate):
        x, dt, A, Bm, Cm, init_state = ctx.saved_tensors
        if dy is None:
            dy = torch.zeros_like(x)
        grads = ssd_scan_bwd(x, dt, A, Bm, Cm, init_state, ctx.chunk, dy,
                             dstate)
        return (*grads, None)


def ssd_chunk_scan(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                   Bm: torch.Tensor, Cm: torch.Tensor,
                   init_state: Optional[torch.Tensor], chunk: int, *,
                   out_state: Optional[torch.Tensor] = None
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K4.  x (b,T,nh,P); dt (b,T,nh); A (nh,); Bm, Cm (b,T,G,N);
    init_state (b,nh,P,N) f32 or None -> (y (b,T,nh,P) in x's dtype,
    final state (b,nh,P,N) f32, which is ``out_state`` when given).
    Differentiable (K4's backward) where autograd records; ``out_state``
    (an in-place update, the cached path's) is then refused."""
    if out_state is None:
        return _SSDScan.apply(x, dt, A, Bm, Cm, init_state, chunk)
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad
            for t in (x, dt, A, Bm, Cm, init_state)):
        raise ValueError("ssd_chunk_scan: out_state (an in-place state "
                         "update) is not differentiable")
    return _forward(x, dt, A, Bm, Cm, init_state, chunk, out_state)


def launch_on_route(route: str, x, dt, A, Bm, Cm, init_state, chunk, *,
                    out_state=None, n_split: int = None):
    """K4 on CUDA tensors on ``route`` at ``n_split`` (None: the route's
    own) whatever the table says: for checking every route and split of a
    shape on the card and timing one against another.  On CPU tensors,
    the plain version of that route's decomposition
    (``ref.ssd_split_ref``); a name that is no route raises.  The port
    never calls it."""
    if x.device.type == "cpu":
        y, state = ssd_split_ref(x, dt, A, Bm, Cm, init_state, chunk,
                                 n_split or 1, route=route)
        if out_state is not None:
            state = out_state.copy_(state)
        return y, state
    return _launch(x, dt, A, Bm, Cm, init_state, chunk, out_state, route,
                   n_split)


def launch_bwd_on_route(route: str, x, dt, A, Bm, Cm, init_state, chunk,
                        dy, dstate=None):
    """K4's backward on CUDA tensors on ``route`` ("tensor_cores" /
    "cuda_cores") whatever the table says: for checking every route of a
    shape on the card and timing one against another.  On CPU tensors,
    the plain version of that route's decomposition
    (``ref.ssd_bwd_split_ref``); a name that is no route raises.  The port
    never calls it."""
    if x.device.type == "cpu":
        return ssd_bwd_split_ref(x, dt, A, Bm, Cm, init_state, chunk, dy,
                                 dstate, route=route)
    if route not in BWD_ROUTES:
        raise ValueError(f"ssd_scan_bwd: no route {route!r}; want one of "
                         f"{BWD_ROUTES}")
    return _launch_bwd(x, dt, A, Bm, Cm, init_state, chunk, dy, dstate,
                       route)
