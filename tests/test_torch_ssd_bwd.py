"""K4's backward: its plain version ``ref.ssd_bwd_ref`` (the kernel's
oracle on the card) against autograd through the plain forward
``ssd_ref`` and against ``jax.grad`` of the JAX package's plain ``ssd``
(``repro.models.mamba2.ssd``, which the reference differentiates in
training), with T on and off the chunk, with and without an initial
state, with zero-dt steps and a zero-dt row; and ``ssd_chunk_scan`` as an
autograd Function on a CPU tensor.  Inputs from numpy seeds, f32."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models.mamba2 import ssd as jssd
from repro_torch.kernels.ssd_scan import ops, ref

torch.set_num_threads(2)
# f32 on both sides, summed in other orders: 1e-4 of each gradient's
# scale, tests/test_kernels.py's SSD tolerance
TOL = 1e-4
NAMES = ("dx", "ddt", "dA", "dB", "dC", "dinit")


def _inputs(b, T, nh, P, G, N, seed, init):
    """x, dt, A, B, C, S0, dy, dstate as numpy f32: dt in (0.01, 0.3)
    with five zero steps in row 0 and the last row all zero (an inactive
    slot), A in (-1.5, -0.5)."""
    rng = np.random.default_rng(seed)
    f = np.float32
    x = rng.normal(size=(b, T, nh, P)).astype(f)
    dt = rng.uniform(0.01, 0.3, size=(b, T, nh)).astype(f)
    dt[0, T // 3:T // 3 + 5] = 0.0
    if b > 1:
        dt[-1] = 0.0
    A = -rng.uniform(0.5, 1.5, size=(nh,)).astype(f)
    Bm = rng.normal(size=(b, T, G, N)).astype(f)
    Cm = rng.normal(size=(b, T, G, N)).astype(f)
    S0 = rng.normal(size=(b, nh, P, N)).astype(f) if init else None
    dy = rng.normal(size=(b, T, nh, P)).astype(f)
    dS = rng.normal(size=(b, nh, P, N)).astype(f)
    return x, dt, A, Bm, Cm, S0, dy, dS


def _t(a):
    return None if a is None else torch.from_numpy(a)


def _close(got, want, what):
    want = np.asarray(want, np.float32)
    got = got.detach().float().numpy()
    scale = max(float(np.abs(want).max()), 1e-30)
    assert float(np.abs(got - want).max()) <= TOL * scale, what


def _autograd(x, dt, A, Bm, Cm, S0, chunk, dy, dS):
    ins = [torch.from_numpy(a).requires_grad_() for a in (x, dt, A, Bm, Cm)]
    s0 = None if S0 is None else torch.from_numpy(S0).requires_grad_()
    y, S = ref.ssd_ref(*ins, s0, chunk)
    loss = (y * _t(dy)).sum() + ((S * _t(dS)).sum() if dS is not None
                                 else 0.0)
    grads = torch.autograd.grad(loss, ins + ([s0] if s0 is not None else []))
    return list(grads) + ([None] if s0 is None else [])


# (b, T, nh, P, G, N, chunk): tiny heads on and off the chunk (one and
# several chunks, a ragged last one), one chunk shorter than the chunk
# size (Q = T, the training batch's case), two groups
CASES = [(2, 64, 8, 32, 1, 16, 32), (2, 45, 8, 32, 1, 16, 32),
         (2, 20, 4, 8, 1, 16, 32), (3, 48, 4, 8, 2, 8, 16),
         (2, 37, 4, 8, 2, 8, 16)]


@pytest.mark.parametrize("init", [False, True], ids=["zero", "init"])
@pytest.mark.parametrize("case", CASES, ids=lambda c: f"T{c[1]}-Q{c[6]}")
def test_ssd_bwd_ref_matches_autograd(case, init):
    b, T, nh, P, G, N, chunk = case
    x, dt, A, Bm, Cm, S0, dy, dS = _inputs(b, T, nh, P, G, N, 7, init)
    n0 = ref.calls["ssd_bwd"]
    got = ref.ssd_bwd_ref(*map(_t, (x, dt, A, Bm, Cm, S0)), chunk, _t(dy),
                          _t(dS))
    assert ref.calls["ssd_bwd"] == n0 + 1
    want = _autograd(x, dt, A, Bm, Cm, S0, chunk, dy, dS)
    for name, g, w in zip(NAMES, got, want):
        assert (g is None) == (w is None), name
        if g is not None:
            assert g.dtype == torch.float32 and g.shape == w.shape, name
            _close(g, w.numpy(), name)
    # without a final-state gradient (training's case)
    got0 = ref.ssd_bwd_ref(*map(_t, (x, dt, A, Bm, Cm, S0)), chunk, _t(dy))
    want0 = _autograd(x, dt, A, Bm, Cm, S0, chunk, dy, None)
    for name, g, w in zip(NAMES, got0, want0):
        if g is not None:
            _close(g, w.numpy(), name)


@pytest.mark.parametrize("init", [False, True], ids=["zero", "init"])
@pytest.mark.parametrize("case", [c for c in CASES
                                  if c[1] % min(c[6], c[1]) == 0],
                         ids=lambda c: f"T{c[1]}-Q{c[6]}")
def test_ssd_bwd_ref_matches_jax_grad(case, init):
    """Against ``jax.grad`` of the reference's ``ssd`` (whole chunks: its
    dt pad takes two axes, so a ragged T meets ``ssd_ref`` alone)."""
    b, T, nh, P, G, N, chunk = case
    x, dt, A, Bm, Cm, S0, dy, dS = _inputs(b, T, nh, P, G, N, 11, init)

    def loss(*a):
        y, S = jssd(*a[:5], a[5] if init else None, chunk)
        return (y * dy).sum() + (S * dS).sum()
    args = (x, dt, A, Bm, Cm) + ((S0,) if init else ())
    want = jax.grad(loss, argnums=tuple(range(len(args))))(
        *map(jnp.asarray, args))
    got = ref.ssd_bwd_ref(*map(_t, (x, dt, A, Bm, Cm, S0)), chunk, _t(dy),
                          _t(dS))
    for name, g, w in zip(NAMES, got, want):
        _close(g, w, name)


def test_zero_dt_steps_and_padding():
    """A ragged T gives gradients of T steps only, equal to those of the
    same sequence padded by hand with dt = x = B = C = dy = 0, whose
    padded steps get zero gradients; a row whose dt is zero throughout
    (y = 0 there) gives x, B and C no gradient."""
    b, T, nh, P, G, N, chunk = 2, 45, 4, 8, 1, 16, 16
    x, dt, A, Bm, Cm, _, dy, _ = _inputs(b, T, nh, P, G, N, 3, False)
    got = ref.ssd_bwd_ref(*map(_t, (x, dt, A, Bm, Cm)), None, chunk, _t(dy))
    assert got[0].shape == (b, T, nh, P) and got[1].shape == (b, T, nh)
    pad = -T % chunk

    def padded(a):
        return np.pad(a, [(0, 0), (0, pad)] + [(0, 0)] * (a.ndim - 2))
    full = ref.ssd_bwd_ref(*map(_t, (padded(x), padded(dt), A, padded(Bm),
                                     padded(Cm))), None, chunk,
                           _t(padded(dy)))
    for name, g, w in zip(NAMES[:5], got, full):
        if name != "dA":
            assert float(w[:, T:].abs().max()) == 0.0, name
            w = w[:, :T]
        _close(g, w.numpy(), name)
    # the last row has dt = 0 throughout: y = 0 there, so x, B and C get
    # no gradient from it
    for name, g in (("dx", got[0]), ("dB", got[3]), ("dC", got[4])):
        assert float(g[-1].abs().max()) == 0.0, name


def test_ssd_chunk_scan_is_differentiable_on_the_cpu():
    """Under autograd, ``ssd_chunk_scan`` is the Function whose backward
    is ``ssd_scan_bwd`` (the plain version on a CPU tensor): its
    gradients are ``ssd_bwd_ref``'s; ``out_state`` is refused there; and
    with no input that requires a gradient the plain path runs as
    before."""
    b, T, nh, P, G, N, chunk = 2, 40, 4, 8, 1, 16, 16
    x, dt, A, Bm, Cm, S0, dy, dS = _inputs(b, T, nh, P, G, N, 5, True)
    ins = [torch.from_numpy(a).requires_grad_()
           for a in (x, dt, A, Bm, Cm, S0)]
    n0 = dict(ref.calls)
    y, S = ops.ssd_chunk_scan(*ins[:5], ins[5], chunk)
    grads = torch.autograd.grad((y * _t(dy)).sum() + (S * _t(dS)).sum(),
                                ins)
    assert ref.calls["ssd"] == n0["ssd"] + 1
    assert ref.calls["ssd_bwd"] == n0["ssd_bwd"] + 1
    want = ref.ssd_bwd_ref(*map(_t, (x, dt, A, Bm, Cm, S0)), chunk, _t(dy),
                           _t(dS))
    for name, g, w in zip(NAMES, grads, want):
        assert torch.equal(g, w), name
    with pytest.raises(ValueError, match="out_state"):
        ops.ssd_chunk_scan(*ins[:5], None, chunk,
                           out_state=torch.zeros(b, nh, P, N))
    with torch.no_grad():
        y2, _ = ops.ssd_chunk_scan(*ins[:5], ins[5], chunk)
    assert torch.equal(y2, y.detach())
    assert ops.ssd_scan_bwd(*map(_t, (x, dt, A, Bm, Cm)), None, chunk,
                            _t(dy))[5] is None
    with pytest.raises(ValueError, match="no kernel"):
        ops.ssd_scan_bwd(*[t.to("meta") for t in map(
            _t, (x, dt, A, Bm, Cm))], None, chunk, _t(dy).to("meta"))
