"""Row invariance of the port's engine path on the CPU: the bits of one
output row depend only on that row's inputs and the reduction's length,
never on the call's other rows, its columns or its width.

The plain versions the CPU runs (the card runs their kernels, held to
the same property by ``chip_smoke.py``): ``row_gemm``'s product and
batched product (``kernels/row_gemm/ref.py``) across row counts
(hypothesis over 1..64), column slices and weight layouts, and within
2e-5 of the JAX package's ``x @ w``; the row reductions (RMSNorm, the
logits' log-sum-exp); K1 / K2 (``spec_verify_ref``, ``tree_verify_ref``,
the split route's pieces and the ``lse`` partials) across B and T; and
the cached forward of tiny granite and tiny moonshot (``chip_smoke.
row_probe``): a slot alone against the same slot among four, a decode
against the first position of a verify, bitwise, with the decode's
logits held to the reference's at its tolerances."""
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from repro.models import forward as jforward
from repro.models import init_cache as jinit_cache
from repro_torch.kernels.row_gemm import ref as rg_ref
from repro_torch.kernels.row_gemm.ops import row_bmm, row_gemm
from repro_torch.kernels.row_reduce import ref as rr_ref
from repro_torch.kernels.row_reduce.ops import logsumexp, rms_norm
from repro_torch.kernels.spec_verify.ref import (merge_partials, pos_mask,
                                                 spec_verify_ref,
                                                 split_partials,
                                                 tree_verify_ref)
from repro_torch.models import common

sys.path.insert(0, str(Path(__file__).resolve().parent))
sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke  # noqa: E402
from _torch_rec import MODEL_TOL, close, model_pair  # noqa: E402

torch.set_num_threads(2)
DTYPES = (torch.float32, torch.bfloat16)
# (K, N) of the tiny configs' products (d 128, heads 4 x 32, kv 2 x 32,
# d_ff 256, vocab 512; moonshot's experts 4 x 64) and one past BLOCK,
# which the plain version cuts into blocks
WIDTHS = [(128, 128), (128, 64), (128, 256), (256, 128), (128, 512),
          (64, 128), (128, 4), (4, 128), (1100, 700)]


def _normal(rng, shape, dtype):
    return torch.from_numpy(rng.standard_normal(shape).astype(np.float32)
                            ).to(dtype)


@settings(max_examples=40, deadline=None)
@given(M=st.integers(1, 64), width=st.sampled_from(WIDTHS),
       dtype=st.sampled_from(DTYPES), seed=st.integers(0, 2 ** 16))
def test_row_gemm_rows_equal_rows_alone(M, width, dtype, seed):
    """Every row of an M-row product equals that row computed alone and
    inside a 64-row product."""
    K, N = width
    rng = np.random.default_rng(seed)
    a = _normal(rng, (64, K), dtype)
    w = _normal(rng, (K, N), dtype)
    part = rg_ref.row_gemm_ref(a[:M], w)
    assert torch.equal(part, rg_ref.row_gemm_ref(a, w)[:M])
    for r in {0, M // 2, M - 1}:
        assert torch.equal(part[r:r + 1], rg_ref.row_gemm_ref(a[r:r + 1], w))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("width", WIDTHS)
def test_row_gemm_column_slices_and_layouts(width, dtype):
    """``x @ W[:, cols]`` equals ``(x @ W)[:, cols]`` for the column
    shards of tp = 2 and 4, and a k-contiguous W (the tied
    unembedding's ``embed.T``) gives the bits of the same W contiguous."""
    K, N = width
    rng = np.random.default_rng(K * N)
    a = _normal(rng, (9, K), dtype)
    w = _normal(rng, (K, N), dtype)
    whole = rg_ref.row_gemm_ref(a, w)
    for tp in (2, 4):
        cuts = np.linspace(0, N, tp + 1).astype(int)
        for lo, hi in zip(cuts[:-1], cuts[1:]):
            got = rg_ref.row_gemm_ref(a, w[:, lo:hi].contiguous())
            assert torch.equal(got, whole[:, lo:hi]), (tp, lo)
    assert torch.equal(rg_ref.row_gemm_ref(a, w.T.contiguous().T), whole)


@pytest.mark.parametrize("width", WIDTHS)
def test_row_gemm_matches_jax(width):
    """The plain product within 2e-5 of the JAX package's ``x @ w`` on
    the same numpy-seeded f32 inputs, one row and many."""
    K, N = width
    rng = np.random.default_rng(7)
    a = (rng.standard_normal((33, K)) / np.sqrt(K)).astype(np.float32)
    w = rng.standard_normal((K, N)).astype(np.float32)
    want = np.asarray(jnp.asarray(a) @ jnp.asarray(w))
    for rows in (slice(0, 1), slice(0, 33)):
        got = rg_ref.row_gemm_ref(torch.from_numpy(a[rows]),
                                  torch.from_numpy(w)).numpy()
        np.testing.assert_allclose(got, want[rows], atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("dtype", DTYPES)
def test_row_bmm_rows_batches_and_views(dtype):
    """The batched form: each (batch, row) of a call equals it alone,
    inside fewer batches and inside fewer rows, on the MoE layer's
    strided views (a transposed hidden state, a transposed stack of
    expert outputs), and within 2e-5 of ``torch.bmm`` in f32."""
    rng = np.random.default_rng(3)
    E, T, d, eff = 4, 12, 128, 64
    g = _normal(rng, (T, E, eff), dtype).transpose(0, 1)    # (E, T, eff)
    wd = _normal(rng, (E, eff, d), dtype)
    y = rg_ref.row_bmm_ref(g, wd)
    assert torch.equal(rg_ref.row_bmm_ref(g[:2, :5], wd[:2]), y[:2, :5])
    for e, t in ((0, 0), (3, 11), (1, 6)):
        assert torch.equal(rg_ref.row_bmm_ref(g[e:e + 1, t:t + 1],
                                              wd[e:e + 1]),
                           y[e:e + 1, t:t + 1])
    comb = _normal(rng, (T, 1, E), dtype)
    y_all = y.transpose(0, 1)                                # (T, E, d)
    mix = rg_ref.row_bmm_ref(comb, y_all)
    assert torch.equal(rg_ref.row_bmm_ref(comb[3:4], y_all[3:4]), mix[3:4])
    if dtype == torch.float32:
        torch.testing.assert_close(y, torch.bmm(g, wd), atol=2e-5,
                                   rtol=2e-5)


def test_cpu_wrappers_run_the_plain_versions():
    """On CPU tensors ``lin`` (off autograd), ``row_gemm``, ``row_bmm``,
    ``rms_norm`` and ``logsumexp`` run the plain versions (their call
    counts move); under autograd ``lin`` and ``rms_norm`` stay PyTorch's
    operations (the train step), with the same values."""
    rng = np.random.default_rng(1)
    x = _normal(rng, (3, 5, 128), torch.float32)
    w = _normal(rng, (128, 64), torch.float32)
    ln = _normal(rng, (128,), torch.float32)
    n = dict(rg_ref.calls), dict(rr_ref.calls)
    with torch.no_grad():
        y = common.lin(x, w)
        z = common.rms_norm(x, ln)
    assert torch.equal(y, row_gemm(x, w))
    assert torch.equal(row_bmm(x, w.expand(3, 128, 64)), y)
    assert torch.equal(z, rms_norm(x, ln))
    assert torch.equal(logsumexp(x), torch.logsumexp(x, dim=-1))
    assert rg_ref.calls["row_gemm"] - n[0]["row_gemm"] == 3
    assert rr_ref.calls["rms_norm"] - n[1]["rms_norm"] == 2
    assert rr_ref.calls["logsumexp"] - n[1]["logsumexp"] == 1
    wg = w.clone().requires_grad_()
    lg = ln.clone().requires_grad_()
    n = dict(rg_ref.calls), dict(rr_ref.calls)
    yg = common.lin(x, wg)
    zg = common.rms_norm(x, lg)
    assert yg.grad_fn is not None and zg.grad_fn is not None
    assert (dict(rg_ref.calls), dict(rr_ref.calls)) == n
    torch.testing.assert_close(yg.detach(), y, atol=2e-5, rtol=2e-5)
    assert torch.equal(zg.detach(), z)


def test_row_reductions_and_exp_row_by_row():
    """RMSNorm and the log-sum-exp of each row equal the row's alone and
    inside other row counts (bf16 and f32; vocabularies off a multiple
    of the vector width), and ``exp``'s vector routine equals its scalar
    tail, on which the plain log-sum-exp's invariance rests."""
    rng = np.random.default_rng(2)
    for dtype in DTYPES:
        x = _normal(rng, (70, 128), dtype)
        ln = _normal(rng, (128,), torch.float32)
        whole = rr_ref.rms_norm_ref(x, ln)
        for M in (1, 2, 9, 33):
            assert torch.equal(rr_ref.rms_norm_ref(x[:M], ln), whole[:M])
            assert torch.equal(rr_ref.rms_norm_ref(x[M - 1:M], ln),
                               whole[M - 1:M])
    for V in (512, 1000, 163):
        lg = _normal(rng, (300, V), torch.float32) * 4
        whole = rr_ref.logsumexp_ref(lg)
        for M in (1, 8, 72, 264):
            assert torch.equal(rr_ref.logsumexp_ref(lg[:M]), whole[:M])
            assert torch.equal(rr_ref.logsumexp_ref(lg[M - 1:M]),
                               whole[M - 1:M])
    v = torch.from_numpy(rng.standard_normal(4096).astype(np.float32) * 20)
    vec = torch.exp(v)
    assert all(torch.equal(torch.exp(v[i:i + 1]), vec[i:i + 1])
               for i in range(0, 4096, 7))


def _verify_inputs(dtype, B=4, T=33, S=160, Hq=4, Hk=2, D=32, seed=0):
    """q, k, v, q_pos, k_pos and a tree mask: each row's cache holds its
    positions 0..n-1 (half the rows on permuted slots), its queries the
    next T positions, a query that sees no key in the last row."""
    rng = np.random.default_rng(seed)
    q = _normal(rng, (B, T, Hq, D), dtype)
    k = _normal(rng, (B, S, Hk, D), dtype)
    v = _normal(rng, (B, S, Hk, D), dtype)
    n = rng.integers(40, S - T, size=B)
    k_pos = np.full((B, S), -1, np.int32)
    for b in range(B):
        slots = rng.permutation(S)[:n[b] + T] if b % 2 else \
            np.arange(n[b] + T)
        k_pos[b, slots] = np.arange(n[b] + T)
    q_pos = (n[:, None] + np.arange(T)[None]).astype(np.int32)
    q_pos[B - 1, 0] = -1
    tree = rng.random((B, T, S)) < 0.8
    return (q, k, v, torch.from_numpy(q_pos), torch.from_numpy(k_pos),
            torch.from_numpy(tree))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("kind", ["k1", "k2", "lse", "split"])
def test_verify_first_query_across_batch_and_width(kind, dtype):
    """Each row's first query of K1 (``lse`` partials too), K2 and the
    split route's shares merged (n_split 1, 3, 8) is bitwise the same at
    B 1, 2, 4 and T 1, 2, 9, 33."""
    q, k, v, qp, kp, tree = _verify_inputs(dtype)

    def call(B, T, n_split=1):
        args = (q[:B, :T], k[:B], v[:B], qp[:B, :T], kp[:B])
        if kind == "k2":
            return tree_verify_ref(*args, tree[:B, :T])
        if kind == "lse":
            return torch.cat([x.reshape(B, T, -1) for x in
                              spec_verify_ref(*args, lse=True)], dim=-1)
        if kind == "split":
            return merge_partials(*split_partials(
                q[:B, :T], k[:B], v[:B], pos_mask(qp[:B, :T], kp[:B]),
                n_split))
        return spec_verify_ref(*args)
    for n_split in ((1, 3, 8) if kind == "split" else (1,)):
        base = call(4, 33, n_split)[:, 0]
        for B in (1, 2, 4):
            for T in (1, 2, 9, 33):
                got = call(B, T, n_split)[:, 0]
                assert torch.equal(got, base[:B]), (B, T, n_split)


MODELS = ["granite-3-8b", "moonshot-v1-16b-a3b"]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", MODELS)
def test_cached_forward_rows_are_invariant(arch, dtype):
    """The cached forward (``chip_smoke.row_probe``, the reference's tiny
    weights): every product, norm, RoPE, attention, routing and expert
    output, the logits and their log-sum-exp of a slot alone equal that
    slot's among four, and a decode's those of the first position of a
    verify of 9, bitwise."""
    m = model_pair(arch, dtype)
    pr = chip_smoke.row_probe(torch, np, m.tcfg, m.tp, device="cpu", B=4,
                              S=128)
    assert pr["ops"] > 20
    assert pr["alone"] == [] and pr["verify"] == [], pr


@pytest.mark.parametrize("arch", MODELS)
def test_probe_logits_match_the_reference(arch):
    """The probe's decode logits (f32) against the reference's forward on
    the same prefill and decode, at ``MODEL_TOL``."""
    m = model_pair(arch, "float32")
    pr = chip_smoke.row_probe(torch, np, m.tcfg, m.tp, device="cpu", B=4,
                              S=128)
    tok, pos, mask, pending, vpos = chip_smoke.probe_inputs(np, m.tcfg, 4,
                                                            5)
    jc = jinit_cache(m.jcfg, 4, 128)
    _, jc, _ = jforward(m.jcfg, m.jp, jnp.asarray(tok), jnp.asarray(pos),
                        jc, token_mask=jnp.asarray(mask))
    want, _, _ = jforward(m.jcfg, m.jp, jnp.asarray(pending[:, :1]),
                          jnp.asarray(vpos[:, :1]), jc)
    close(pr["logits"], np.asarray(want), MODEL_TOL["float32"])
