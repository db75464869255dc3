"""The decomposition of K4 (the SSD chunk scan) in plain PyTorch against
the JAX package: ``ssd_split_ref`` — the state's P rows cut into n_split
slices, each computed from its own columns of x and rows of the state, in
the form of each of the kernel's routes: the recurrent route's one pass
per token, S_new = exp(dt A) S + (dt x) (x) B, y = S_new . C, and the
other routes' chunks — held against ``ssd_ref``,
``repro.models.mamba2.ssd`` and the Pallas op
``repro.kernels.ssd_scan.ops.ssd_chunk_scan`` in interpret mode, on
numpy-seeded inputs at f32 (1e-5, absolute and relative), at the tiny
configs' SSD heads and at zamba2-1.2b's and mamba2-370m's with b = 2.
Also: the result is bitwise independent of n_split, a row whose dt is 0
throughout keeps its state bit for bit, the wrapper's forced routes run
their own route's decomposition for CPU tensors, and the wrapper refuses
states the kernel's 16-byte vectors cannot move.  The CUDA kernels run
only on the card, where ``chip_smoke.py`` holds every route and n_split
to the plain version."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.ssd_scan.ops import ssd_chunk_scan as jax_pallas
from repro.models.mamba2 import ssd as jax_ssd
from repro_torch.bridge import to_numpy
from repro_torch.kernels.ssd_scan import ops
from repro_torch.kernels.ssd_scan.ref import FORMS, ssd_ref, ssd_split_ref

torch.set_num_threads(2)

TOL = 1e-5
# name: (nh, P, G, N) of the SSD heads, b = 2
HEADS = {"tiny": (8, 32, 1, 16),
         "zamba2-1.2b": (64, 64, 1, 64),
         "mamba2-370m": (32, 64, 1, 128)}
# T, chunk: decode, the engine's verify widths, a prefill chunk, and
# calls of several chunks (whole, and with the last one padded)
WIDTHS = [(1, 256), (5, 256), (9, 256), (64, 256), (48, 16), (40, 16)]
# one route of each form: the recurrent route's one pass per token, and
# the chunked form the tensor cores and the CUDA cores compute
ROUTE_FORMS = ("recurrent", "tensor_cores")


def _inputs(seed, T, nh, P, G, N, b=2, with_init=True):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(b, T, nh, P)).astype(np.float32)
    dt = rng.uniform(0.01, 0.2, size=(b, T, nh)).astype(np.float32)
    A = -rng.uniform(0.5, 1.5, size=(nh,)).astype(np.float32)
    Bm = rng.normal(size=(b, T, G, N)).astype(np.float32)
    Cm = rng.normal(size=(b, T, G, N)).astype(np.float32)
    S0 = rng.normal(size=(b, nh, P, N)).astype(np.float32) \
        if with_init else None
    return x, dt, A, Bm, Cm, S0


def _t(a):
    return None if a is None else torch.from_numpy(a)


def _j(a):
    return None if a is None else jnp.asarray(a)


def _close(got, want):
    np.testing.assert_allclose(to_numpy(got), np.asarray(want), atol=TOL,
                               rtol=TOL)


@pytest.mark.parametrize("T,chunk", WIDTHS)
@pytest.mark.parametrize("heads", list(HEADS))
def test_split_decomposition_matches_references(heads, T, chunk):
    """Each form at n_split = 2 (the split a mamba2 step takes at T = 1)
    against the plain SSD, the JAX model's SSD and the Pallas op; a call
    whose last chunk is padded against the plain SSD alone (both JAX
    functions pad a (b, T, nh) dt with a two-axis pad width and take
    whole chunks only)."""
    nh, P, G, N = HEADS[heads]
    args = _inputs(T + N, T, nh, P, G, N, with_init=T != 9)
    yr, sr = ssd_ref(*map(_t, args), chunk)
    whole = T % min(chunk, T) == 0
    want = [(to_numpy(yr), to_numpy(sr))]
    for fn in (jax_ssd, jax_pallas) if whole else ():
        want.append(fn(*map(_j, args), chunk))
    for route in ROUTE_FORMS:
        y, s = ssd_split_ref(*map(_t, args), chunk, n_split=2, route=route)
        for yw, sw in want:
            _close(y, yw)
            _close(s, sw)


@pytest.mark.parametrize("T,chunk", [(1, 256), (9, 256), (40, 16)])
@pytest.mark.parametrize("heads", list(HEADS))
def test_split_bitwise_independent_of_n_split(heads, T, chunk):
    """Each state row's arithmetic does not depend on the slice it lies
    in: every n_split gives the same bits."""
    nh, P, G, N = HEADS[heads]
    args = list(map(_t, _inputs(T, T, nh, P, G, N)))
    for route in ROUTE_FORMS:
        y1, s1 = ssd_split_ref(*args, chunk, n_split=1, route=route)
        for n in (2, 4, P // 8):
            y, s = ssd_split_ref(*args, chunk, n_split=n, route=route)
            assert torch.equal(y, y1) and torch.equal(s, s1), (route, n)


@pytest.mark.parametrize("T", [1, 9])
@pytest.mark.parametrize("heads", list(HEADS))
def test_split_zero_dt_row_keeps_state(heads, T):
    """A row whose dt is 0 throughout (an inactive slot) keeps its state
    bit for bit; a row with dt 0 from some step on (padded tokens) ends
    with the state of its shorter call."""
    nh, P, G, N = HEADS[heads]
    x, dt, A, Bm, Cm, S0 = map(_t, _inputs(7, T, nh, P, G, N, b=3))
    dt[1] = 0.0
    if T > 1:
        dt[2, 4:] = 0.0
    for route in ROUTE_FORMS:
        _, s = ssd_split_ref(x, dt, A, Bm, Cm, S0, 256, n_split=2,
                             route=route)
        assert torch.equal(s[1], S0[1]) and not torch.equal(s[0], S0[0])
        if T > 1:
            _, s4 = ssd_split_ref(x[2:, :4], dt[2:, :4], A, Bm[2:, :4],
                                  Cm[2:, :4], S0[2:], 256, n_split=2,
                                  route=route)
            assert torch.equal(s[2:], s4), route


@pytest.mark.parametrize("route", ["recurrent", "tensor_cores",
                                   "cuda_cores"])
def test_forced_route_on_cpu_runs_the_decomposition(route):
    """``ops.launch_on_route`` runs, for CPU tensors, the plain version of
    the decomposition of the route it is asked for (the one-pass form on
    the recurrent route, the chunked form on the others), ``out_state`` in
    place included, and that agrees with the plain SSD, the JAX model's
    SSD and the Pallas op."""
    nh, P, G, N = HEADS["tiny"]
    raw = _inputs(3, 9, nh, P, G, N)
    args = list(map(_t, raw))
    state = args[5].clone()
    y, s = ops.launch_on_route(route, *args[:5], state, 256,
                               out_state=state, n_split=4)
    assert s is state
    own = ssd_split_ref(*args, 256, n_split=4, route=route)
    assert torch.equal(y, own[0]) and torch.equal(s, own[1])
    yr, sr = ssd_ref(*args, 256)
    for yw, sw in [(to_numpy(yr), to_numpy(sr))] + [
            fn(*map(_j, raw), 256) for fn in (jax_ssd, jax_pallas)]:
        _close(y, yw)
        _close(s, sw)


def test_forced_route_names_are_the_kernels_routes():
    """The plain decomposition knows exactly the library's routes, and a
    forced route that is none of them raises on CPU tensors too."""
    assert set(FORMS) == set(ops.ROUTES.values())
    nh, P, G, N = HEADS["tiny"]
    args = list(map(_t, _inputs(2, 3, nh, P, G, N)))
    for route in (None, "one_cta_per_head"):
        with pytest.raises(ValueError, match="no route"):
            ops.launch_on_route(route, *args, 256)


def test_wrapper_refuses_misaligned_states():
    """Every route moves the state in 16-byte vectors: a contiguous state
    view that starts off a 16-byte boundary is refused by name, as
    ``init_state`` and as ``out_state``."""
    nh, P, G, N = HEADS["tiny"]
    x, dt, A, Bm, Cm, S0 = map(_t, _inputs(5, 1, nh, P, G, N))
    ops.check_inputs(x, dt, A, Bm, Cm, S0, S0, 256)
    flat = torch.zeros(S0.numel() + 4, dtype=torch.float32)
    shift = (-flat.data_ptr() // 4) % 4            # to a 16-byte boundary
    for off in (1, 2, 3):
        view = flat[(shift + off) % 4:][:S0.numel()].view(S0.shape)
        assert view.is_contiguous() and view.data_ptr() % 16
        for named in ("init_state", "out_state"):
            states = (view, S0) if named == "init_state" else (S0, view)
            with pytest.raises(ValueError, match=f"{named} starts at"):
                ops.check_inputs(x, dt, A, Bm, Cm, *states, 256)


def test_split_refuses_a_split_that_does_not_divide_p():
    nh, P, G, N = HEADS["tiny"]
    with pytest.raises(ValueError, match="not divisible"):
        ssd_split_ref(*map(_t, _inputs(1, 1, nh, P, G, N)), 256, n_split=3)
