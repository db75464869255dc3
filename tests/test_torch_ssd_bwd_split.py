"""K4's backward as its kernel decomposes it, in plain PyTorch:
``ref.ssd_bwd_split_ref(..., route=)`` — each chunk in blocks of 64 steps
and only its causal, in-range tiles, C B^T once per group, M summed over
the group's heads in head order before its products with B and C, the
boundary terms summed over heads in order — on both of the backward's
routes.  The CUDA-core route (f32) is held to ``ref.ssd_bwd_ref``, to
autograd through the plain forward ``ssd_ref`` and to ``jax.grad`` of the
JAX package's ``repro.models.mamba2.ssd`` at 1e-4 of each gradient's
scale; the tensor-core route (bf16 inputs, every f32 operand of a product
rounded to hi + lo bf16 as the kernel feeds it) to the f32 plain version
on the same inputs by the card's scaled measure (rms(err) / rms(ref) <=
5e-3, max|err| / max|ref| <= 2^-6), with the two planted faults of
``chip_smoke.py::ssd_bwd_check`` failing it.  Cases: one and two groups
(several heads a group in both), T on and off the chunk and Q = T, with
and without an initial state, a nonzero final-state gradient, zero-dt
steps and a zero-dt row; the tiny configs' heads and both models' at
b = 2, T = 300; strong decay (exp of a block's summed decay past f32's
range).  The measure ``chip_smoke.py`` holds the tensor-core route to the
CUDA-core route with on the card is shown to catch a route that drops the
lo halves.  Inputs from numpy seeds.  The CUDA kernels run only on the
card, where ``chip_smoke.py`` holds each route to the plain version."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from repro.models.mamba2 import ssd as jssd
from repro_torch.kernels.ssd_scan import ops, ref

torch.set_num_threads(2)
# f32 on both sides, summed in other orders: 1e-4 of each gradient's
# scale, tests/test_kernels.py's SSD tolerance
TOL = 1e-4
# the card's scaled measure of a bf16 route against the f32 plain version
REL_RMS_TOL, REL_MAX_TOL = 5e-3, 2 ** -6
NAMES = ("dx", "ddt", "dA", "dB", "dC", "dinit")

# (b, T, nh, P, G, N, chunk): the tiny configs' heads on the chunk, off it
# and one short chunk (Q = T); two groups of two heads on and off the
# chunk; both models' heads at b = 2, T = 300 (a chunk of 256 and a
# ragged one of 44) and one short chunk
TINY = [(2, 64, 8, 32, 1, 16, 32), (2, 45, 8, 32, 1, 16, 32),
        (2, 20, 8, 32, 1, 16, 32), (3, 48, 4, 16, 2, 16, 16),
        (2, 37, 4, 16, 2, 32, 16)]
MODELS = [(2, 300, 32, 64, 1, 128, 256), (2, 300, 64, 64, 1, 64, 256),
          (2, 130, 32, 64, 1, 128, 256)]
# strong decay (dt in (1, 3), A = -1; a block's summed decay past f32's
# exp range): two groups and mamba2's heads, in chunks of two and four
# blocks
STRONG = [(2, 300, 8, 32, 2, 32, 128, "strong"),
          (2, 300, 32, 64, 1, 128, 256, "strong")]


def _ids(c):
    return f"b{c[0]}-T{c[1]}-nh{c[2]}-P{c[3]}-G{c[4]}-N{c[5]}-Q{c[6]}" + (
        "-strong" if c[7:] else "")


def _inputs(b, T, nh, P, G, N, seed, init, strong=False):
    """x, dt, A, B, C, S0, dy, dstate as numpy f32: dt in (0.01, 0.3)
    with five zero steps in row 0 and the last row all zero (an inactive
    slot), A in (-1.5, -0.5); ``strong``: dt in (1, 3), A = -1."""
    rng = np.random.default_rng(seed)
    f = np.float32
    x = rng.normal(size=(b, T, nh, P)).astype(f)
    dt = rng.uniform(0.01, 0.3, size=(b, T, nh)).astype(f)
    A = -rng.uniform(0.5, 1.5, size=(nh,)).astype(f)
    if strong:
        dt = rng.uniform(1.0, 3.0, size=(b, T, nh)).astype(f)
        A = -np.ones((nh,), f)
    dt[0, T // 3:T // 3 + 5] = 0.0
    dt[-1] = 0.0
    Bm = rng.normal(size=(b, T, G, N)).astype(f)
    Cm = rng.normal(size=(b, T, G, N)).astype(f)
    S0 = rng.normal(size=(b, nh, P, N)).astype(f) if init else None
    dy = rng.normal(size=(b, T, nh, P)).astype(f)
    dS = rng.normal(size=(b, nh, P, N)).astype(f)
    return x, dt, A, Bm, Cm, S0, dy, dS


def _t(a):
    return None if a is None else torch.from_numpy(a)


def _close(got, want, what, tol=TOL):
    want = np.asarray(want, np.float32)
    got = got.detach().float().numpy()
    assert np.isfinite(got).all(), f"{what}: not finite"
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max())
    assert err <= tol * scale, f"{what}: {err:.3e} > {tol} x {scale:.3e}"


def _scaled_err(out, ref32):
    e = out.float() - ref32
    return (float(e.pow(2).mean().sqrt() / ref32.pow(2).mean().sqrt()),
            float(e.abs().max() / ref32.abs().max()))


def _scaled_ok(errs):
    return errs[0] <= REL_RMS_TOL and errs[1] <= REL_MAX_TOL


def _autograd(x, dt, A, Bm, Cm, S0, chunk, dy, dS):
    ins = [torch.from_numpy(a).requires_grad_() for a in (x, dt, A, Bm, Cm)]
    s0 = None if S0 is None else torch.from_numpy(S0).requires_grad_()
    y, S = ref.ssd_ref(*ins, s0, chunk)
    loss = (y * _t(dy)).sum() + (S * _t(dS)).sum()
    grads = torch.autograd.grad(loss, ins + ([s0] if s0 is not None else []))
    return list(grads) + ([None] if s0 is None else [])


@pytest.mark.parametrize("init", [False, True], ids=["zero", "init"])
@pytest.mark.parametrize("case", TINY + MODELS + STRONG, ids=_ids)
def test_cuda_cores_route_matches_plain_and_autograd(case, init):
    """Finite gradients within 1e-4 of scale; under strong decay dA at
    ``chip_smoke.SSD_DA_STRONG_TOL`` (a sum of large terms of both
    signs, on which f32 plain versions land ~1e-4 apart)."""
    b, T, nh, P, G, N, chunk, *strong = case
    x, dt, A, Bm, Cm, S0, dy, dS = _inputs(b, T, nh, P, G, N, 7, init,
                                           bool(strong))
    args = tuple(map(_t, (x, dt, A, Bm, Cm, S0)))
    got = ref.ssd_bwd_split_ref(*args, chunk, _t(dy), _t(dS),
                                route="cuda_cores")
    want = ref.ssd_bwd_ref(*args, chunk, _t(dy), _t(dS))
    auto = _autograd(x, dt, A, Bm, Cm, S0, chunk, dy, dS)
    for name, g, w, v in zip(NAMES, got, want, auto):
        assert (g is None) == (w is None) == (v is None), name
        if g is None:
            continue
        assert g.dtype == torch.float32 and g.shape == w.shape, name
        tol = chip_smoke.SSD_DA_STRONG_TOL if strong and name == "dA" \
            else TOL
        _close(g, w.numpy(), f"{name} against ssd_bwd_ref", tol)
        _close(g, v.numpy(), f"{name} against autograd", tol)
    # without a final-state gradient (training's case) the zero-dt row
    # gives x and B no gradient (every term of theirs carries a dt_j), and
    # C none either without an initial state (y = 0 there)
    got0 = ref.ssd_bwd_split_ref(*args, chunk, _t(dy), route="cuda_cores")
    zero = (("dx", got0[0]), ("dB", got0[3])) + (
        (("dC", got0[4]),) if S0 is None else ())
    for name, g in zero:
        assert float(g[-1].abs().max()) == 0.0, name


@pytest.mark.parametrize("init", [False, True], ids=["zero", "init"])
@pytest.mark.parametrize("case", [c for c in TINY if c[1] % min(c[6], c[1])
                                  == 0], ids=_ids)
def test_cuda_cores_route_matches_jax_grad(case, init):
    """Against ``jax.grad`` of the reference's ``ssd`` (whole chunks: its
    dt pad takes two axes)."""
    b, T, nh, P, G, N, chunk = case
    x, dt, A, Bm, Cm, S0, dy, dS = _inputs(b, T, nh, P, G, N, 11, init)

    def loss(*a):
        y, S = jssd(*a[:5], a[5] if init else None, chunk)
        return (y * dy).sum() + (S * dS).sum()
    args = (x, dt, A, Bm, Cm) + ((S0,) if init else ())
    want = jax.grad(loss, argnums=tuple(range(len(args))))(
        *map(jnp.asarray, args))
    got = ref.ssd_bwd_split_ref(*map(_t, (x, dt, A, Bm, Cm, S0)), chunk,
                                _t(dy), _t(dS), route="cuda_cores")
    for name, g, w in zip(NAMES, got, want):
        _close(g, w, name)


def _bf16(*arrays):
    return [None if a is None else torch.from_numpy(a).to(torch.bfloat16)
            for a in arrays]


@pytest.mark.parametrize("init", [False, True], ids=["zero", "init"])
@pytest.mark.parametrize("case", TINY + MODELS + STRONG, ids=_ids)
def test_tensor_core_route_passes_the_scaled_check(case, init):
    """bf16 x, B, C, dy (exact inputs of the tensor cores) and f32 dt, A,
    states: the emulated route within the card's scaled measure of the
    f32 plain version on the same inputs; the same route fed a planted
    fault (the last step's dy dropped; the initial state, or else the
    first chunk's output state, ignored) fails it."""
    b, T, nh, P, G, N, chunk, *strong = case
    x, dt, A, Bm, Cm, S0, dy, dS = _inputs(b, T, nh, P, G, N, 13, init,
                                           bool(strong))
    xb, Bb, Cb, dyb = _bf16(x, Bm, Cm, dy)
    dt_, A_, S0_, dS_ = map(_t, (dt, A, S0, dS))
    want = ref.ssd_bwd_ref(xb.float(), dt_, A_, Bb.float(), Cb.float(), S0_,
                           chunk, dyb.float(), dS_)
    got = ref.ssd_bwd_split_ref(xb, dt_, A_, Bb, Cb, S0_, chunk, dyb, dS_,
                                route="tensor_cores")
    assert got[0].dtype == torch.bfloat16
    for name, g, w in zip(NAMES, got, want):
        if g is not None:
            e = _scaled_err(g, w)
            assert _scaled_ok(e), f"{name}: {e[0]:.2e}/{e[1]:.2e}"
    # the planted faults, each run through the route
    dy_cut = dyb.clone()
    dy_cut[:, -1] = 0
    faults = {"last step's dy dropped": (ref.ssd_bwd_split_ref(
        xb, dt_, A_, Bb, Cb, S0_, chunk, dy_cut, dS_,
        route="tensor_cores"), want)}
    if init:
        faults["initial state ignored"] = (ref.ssd_bwd_split_ref(
            xb, dt_, A_, Bb, Cb, None, chunk, dyb, dS_,
            route="tensor_cores"), want)
    elif T > chunk:
        cut = ref.ssd_bwd_split_ref(
            xb[:, chunk:], dt_[:, chunk:], A_, Bb[:, chunk:], Cb[:, chunk:],
            None, chunk, dyb[:, chunk:], dS_, route="tensor_cores")
        faults["the first chunk's state ignored"] = (
            cut, [w if w is None or w.dim() == 1 else w[:, chunk:]
                  for w in want])
    for fname, (fgot, fwant) in faults.items():
        errs = [_scaled_err(f, w) for f, w in zip(fgot, fwant)
                if f is not None and w is not None]
        assert not all(map(_scaled_ok, errs)), fname


def test_tensor_core_rounding_is_what_the_route_adds():
    """The tensor-core route differs from the CUDA-core route on the same
    bf16 inputs only by its hi + lo operands: the two agree to the
    rounding of 16 bits (about 2^-16 of scale), and not bitwise."""
    b, T, nh, P, G, N, chunk = 2, 45, 8, 32, 1, 16, 32
    x, dt, A, Bm, Cm, S0, dy, dS = _inputs(b, T, nh, P, G, N, 17, True)
    xb, Bb, Cb, dyb = _bf16(x, Bm, Cm, dy)
    args = (xb.float(), _t(dt), _t(A), Bb.float(), Cb.float(), _t(S0),
            chunk, dyb.float(), _t(dS))
    tc = ref.ssd_bwd_split_ref(*args, route="tensor_cores")
    cc = ref.ssd_bwd_split_ref(*args, route="cuda_cores")
    diff = [float((a - c).abs().max() / c.abs().max())
            for a, c in zip(tc, cc) if a is not None]
    assert 0.0 < max(diff) < 2 ** -12, diff


@pytest.mark.parametrize("case", [TINY[1], STRONG[0]], ids=_ids)
def test_route_gap_catches_dropped_lo_halves(case, monkeypatch):
    """``chip_smoke._route_gaps``, the card's measure of the tensor-core
    route against the CUDA-core route on the same bf16 inputs: the
    emulated route within ``ROUTE_GAP_TOL`` in every gradient; the same
    route fed only the hi halves of its f32 operands beyond it in dx (W^T),
    dB and dC (Mg) and ddt (S, dS)."""
    b, T, nh, P, G, N, chunk, *strong = case
    x, dt, A, Bm, Cm, S0, dy, _ = _inputs(b, T, nh, P, G, N, 29, True,
                                          bool(strong))
    xb, Bb, Cb, dyb = _bf16(x, Bm, Cm, dy)
    args = (xb, _t(dt), _t(A), Bb, Cb, _t(S0), chunk, dyb)
    cc = ref.ssd_bwd_split_ref(*args, route="cuda_cores")
    tc = ref.ssd_bwd_split_ref(*args, route="tensor_cores")
    gaps = chip_smoke._route_gaps(torch, tc, cc)
    assert max(gaps.values()) <= chip_smoke.ROUTE_GAP_TOL, gaps
    monkeypatch.setattr(ref, "_hilo", lambda t: t.to(torch.bfloat16).float())
    hi = ref.ssd_bwd_split_ref(*args, route="tensor_cores")
    gaps = chip_smoke._route_gaps(torch, hi, cc)
    for name in ("dx", "ddt", "dB", "dC"):
        assert gaps[name] > chip_smoke.ROUTE_GAP_TOL, (name, gaps)


def test_launch_bwd_on_route_runs_the_route_on_the_cpu():
    """``ops.launch_bwd_on_route`` on CPU tensors is the route's plain
    decomposition; a name that is no route raises; the port's own entry
    point ``ssd_scan_bwd`` keeps the plain backward ``ssd_bwd_ref``."""
    b, T, nh, P, G, N, chunk = 2, 37, 4, 16, 2, 32, 16
    x, dt, A, Bm, Cm, S0, dy, dS = _inputs(b, T, nh, P, G, N, 19, True)
    args = tuple(map(_t, (x, dt, A, Bm, Cm, S0)))
    for route in ref.BWD_ROUTES:
        got = ops.launch_bwd_on_route(route, *args, chunk, _t(dy), _t(dS))
        want = ref.ssd_bwd_split_ref(*args, chunk, _t(dy), _t(dS),
                                     route=route)
        for name, g, w in zip(NAMES, got, want):
            assert torch.equal(g, w), (route, name)
    with pytest.raises(ValueError, match="no route"):
        ops.launch_bwd_on_route("recurrent", *args, chunk, _t(dy))
    n0 = ref.calls["ssd_bwd"]
    ops.ssd_scan_bwd(*args, chunk, _t(dy), _t(dS))
    assert ref.calls["ssd_bwd"] == n0 + 1


def test_scratch_has_no_q_by_q_matrix():
    """The backward's workspace at the trainers' shape (16 rows of 448
    tokens, a chunk of 256) is per chunk and per row: far below one f32
    Q x Q matrix per (row, chunk, head), the workspace it replaced."""
    for nh, P, N in ((32, 64, 128), (64, 64, 64)):
        floats = ops.bwd_scratch_floats(16, 448, nh, P, 1, N, 256)
        qq = 16 * 2 * nh * 3 * 256 * 256
        assert floats * 4 < qq * 4 / 4, (nh, floats)
        # S_c and dS_c are at least half of it
        assert floats < 2 * (2 * 16 * 2 * nh * P * N)
