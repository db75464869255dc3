"""K1 and K2's partials (``lse=True``) in plain PyTorch against the JAX
package: the slot cache cut into 2 and 4 contiguous shares (as the
production layout's ranks hold it), each share's attention run with
``lse=True`` and the shares merged in order by ``ref.merge_lse``, held
against ``spec_verify_ref`` / ``tree_verify_ref`` of
``src/repro/kernels/spec_verify/ref.py`` on the same numpy-seeded inputs
at ``tests/test_kernels.py``'s 2e-5 at f32.  Cases: slots permuted at
random, shares that see no key (their lse -inf, their weight exactly 0),
a row that sees no key in any share and a query that sees none (0, never
NaN), a window, a tree mask.  The log-sum-exp itself is held to numpy's
over the visible scores.  The CUDA kernels' partials run only on the
card, where ``chip_smoke.py`` holds every route to these plain
versions."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.spec_verify.ref import spec_verify_ref as jax_ref
from repro.kernels.spec_verify.ref import tree_verify_ref as jax_tree_ref
from repro_torch.bridge import to_numpy
from repro_torch.kernels.spec_verify import ops
from repro_torch.kernels.spec_verify.ref import (merge_lse, pos_mask,
                                                 spec_verify_ref,
                                                 tree_verify_ref)

torch.set_num_threads(2)
TOL = 2e-5
# B, T, S, Hq, Hk, D, window (tests/test_kernels.py VERIFY_CASES)
CASES = [
    (2, 5, 256, 4, 2, 64, 0),
    (1, 1, 128, 8, 8, 128, 0),
    (3, 9, 384, 4, 1, 64, 0),
    (2, 4, 256, 4, 2, 64, 64),
]
IDS = ["gqa", "decode", "mqa", "window"]


def _inputs(case, seed, layout):
    """"permuted": live slots anywhere, the last row's cache empty and
    the first query of the first row at position -1 (it sees nothing);
    "front": the live slots are the first ones, so the later shares see
    no key at all."""
    B, T, S, Hq, Hk, D, _ = case
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(B, T, Hq, D)).astype(np.float32)
    k = rng.normal(size=(B, S, Hk, D)).astype(np.float32)
    v = rng.normal(size=(B, S, Hk, D)).astype(np.float32)
    base = rng.integers(20, 60, size=(B, 1))
    q_pos = (base + np.arange(T)[None]).astype(np.int32)
    k_pos = np.full((B, S), -1, np.int32)
    for b in range(B):
        n = min(int(base[b, 0]) + T, S)
        sl = rng.permutation(S)[:n] if layout == "permuted" else np.arange(n)
        k_pos[b, sl] = np.arange(n)
    if layout == "permuted":
        if B > 1:
            k_pos[-1] = -1
        q_pos[0, 0] = -1
    return q, k, v, q_pos, k_pos


def _shares(n, S):
    return [(S * i // n, S * (i + 1) // n) for i in range(n)]


def _merged(q, k, v, qp, kp, n, *, window, tree=None):
    """Each share's plain partials, and their merge in share order."""
    t = [torch.from_numpy(np.ascontiguousarray(a)) for a in (q, k, v, qp, kp)]
    parts = []
    for lo, hi in _shares(n, k.shape[1]):
        args = (t[0], t[1][:, lo:hi], t[2][:, lo:hi], t[3],
                t[4][:, lo:hi].contiguous())
        if tree is None:
            parts.append(spec_verify_ref(*args, window=window, lse=True))
        else:
            mask = torch.from_numpy(np.ascontiguousarray(tree[:, :, lo:hi]))
            parts.append(tree_verify_ref(*args, mask, window=window,
                                         lse=True))
    return parts, merge_lse(parts)


def _lse_numpy(q, k, mask):
    """log sum exp of each row's visible scores, -inf where none."""
    B, T, Hq, D = q.shape
    rep = Hq // k.shape[2]
    kf = np.repeat(k, rep, axis=2).astype(np.float64)
    s = np.einsum("bthd,bshd->bths", q.astype(np.float64), kf)
    s = s * np.float64(np.float32(1.0) / np.sqrt(np.float32(D)))
    s = np.where(mask[:, :, None, :], s, -np.inf)
    m = s.max(axis=-1, keepdims=True)
    safe = np.where(np.isfinite(m), m, 0.0)
    with np.errstate(divide="ignore"):
        return (np.log(np.exp(s - safe).sum(-1)) + safe[..., 0])


@pytest.mark.parametrize("layout", ["permuted", "front"])
@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_spec_verify_partials_merge_to_reference(case, n, layout):
    """K1's plain partials over n shares, merged: the reference within
    2e-5; each share's lse the numpy log-sum-exp of what it sees."""
    window = case[6]
    q, k, v, qp, kp = _inputs(case, 7 * n + case[1], layout)
    parts, got = _merged(q, k, v, qp, kp, n, window=window)
    want = np.asarray(jax_ref(jnp.asarray(q), jnp.asarray(k),
                              jnp.asarray(v), jnp.asarray(qp),
                              jnp.asarray(kp), window=window))
    got = to_numpy(got)
    assert not np.isnan(got).any()
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)
    for (lo, hi), (o, lse) in zip(_shares(n, k.shape[1]), parts):
        assert o.dtype == torch.float32 and lse.dtype == torch.float32
        assert lse.shape == q.shape[:3]
        mask = to_numpy(pos_mask(torch.from_numpy(qp),
                                 torch.from_numpy(kp[:, lo:hi].copy()),
                                 window))
        want_lse = _lse_numpy(q, k[:, lo:hi], mask)
        blind = ~mask.any(-1)                                  # (B, T)
        assert np.isneginf(to_numpy(lse)[blind]).all()
        assert (to_numpy(o)[blind] == 0).all()
        np.testing.assert_allclose(to_numpy(lse)[~blind], want_lse[~blind],
                                   rtol=TOL, atol=TOL)
    if layout == "front":
        # the last share holds no live slot: it weighs nothing
        assert np.isneginf(to_numpy(parts[-1][1])).all()
    if layout == "permuted":
        # the empty row and the blind query: exactly 0
        assert (got[0, 0] == 0).all()
        if q.shape[0] > 1:
            assert (got[-1] == 0).all()


def _tree(B, T, S, seed):
    """Each query's tree mask over the slots: the committed slots, then
    the step's own nodes (slots S - T ..) a random ancestor chain."""
    rng = np.random.default_rng(seed)
    mask = np.ones((B, T, S), bool)
    for b in range(B):
        parent = [-1] + [int(rng.integers(0, c)) for c in range(1, T)]
        mask[b, :, S - T:] = False
        for c in range(T):
            j = c
            while j >= 0:
                mask[b, c, S - T + j] = True
                j = parent[j]
    return mask


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("case", [CASES[0], CASES[2], CASES[3]],
                         ids=["gqa", "mqa", "window"])
def test_tree_verify_partials_merge_to_reference(case, n):
    """K2's plain partials over n shares under a tree mask, merged: the
    reference's ``tree_verify_ref`` within 2e-5, no NaN."""
    B, T, S, Hq, Hk, D, window = case
    q, k, v, qp, kp = _inputs(case, 3 * n + T, "permuted")
    tree = _tree(B, T, S, n)
    _, got = _merged(q, k, v, qp, kp, n, window=window, tree=tree)
    want = np.asarray(jax_tree_ref(jnp.asarray(q), jnp.asarray(k),
                                   jnp.asarray(v), jnp.asarray(qp),
                                   jnp.asarray(kp), jnp.asarray(tree),
                                   window=window))
    got = to_numpy(got)
    assert not np.isnan(got).any()
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)


def test_merge_lse_weighs_blind_shares_zero():
    """A share with lse -inf adds nothing, whatever its o holds; a row no
    share saw merges to 0; one share merges to itself."""
    rng = np.random.default_rng(0)
    o = [torch.from_numpy(rng.normal(size=(2, 3, 4, 8)).astype(np.float32))
         for _ in range(3)]
    lse = [torch.from_numpy(rng.normal(size=(2, 3, 4)).astype(np.float32))
           for _ in range(3)]
    lse[1][0] = -torch.inf
    got = merge_lse(list(zip(o, lse)))
    want = merge_lse([(o[0][0], lse[0][0]), (o[2][0], lse[2][0])])
    assert torch.equal(got[0], want)
    blind = [(torch.zeros(1, 8), torch.full((1,), -torch.inf))] * 2
    assert (merge_lse(blind) == 0).all()
    assert torch.allclose(merge_lse([(o[0], lse[0])]), o[0], rtol=0,
                          atol=1e-6)


def test_wrappers_return_partials_on_the_cpu():
    """``ops.spec_verify`` / ``ops.tree_verify`` with ``lse=True`` hand a
    CPU tensor's call to the plain version and return (o f32, lse), a
    bf16 query's output in f32."""
    q, k, v, qp, kp = _inputs(CASES[0], 1, "permuted")
    t = [torch.from_numpy(a) for a in (q, k, v, qp, kp)]
    qb = t[0].to(torch.bfloat16)
    kb, vb = t[1].to(torch.bfloat16), t[2].to(torch.bfloat16)
    o, lse = ops.spec_verify(qb, kb, vb, t[3], t[4], lse=True)
    want_o, want_lse = spec_verify_ref(qb, kb, vb, t[3], t[4], lse=True)
    assert o.dtype == torch.float32 and torch.equal(o, want_o)
    assert torch.equal(lse, want_lse)
    plain = spec_verify_ref(qb, kb, vb, t[3], t[4])
    assert torch.equal(o.to(torch.bfloat16), plain)
    tree = torch.from_numpy(_tree(2, 5, 256, 0))
    o, lse = ops.tree_verify(t[0], t[1], t[2], t[3], t[4], tree, lse=True)
    want_o, want_lse = tree_verify_ref(t[0], t[1], t[2], t[3], t[4], tree,
                                       lse=True)
    assert torch.equal(o, want_o) and torch.equal(lse, want_lse)
