"""K3 (flash attention) of the PyTorch port against the JAX package: the
port's plain forward and backward — what its wrapper and
``autograd.Function`` run on a CPU tensor — against the Pallas kernel in
interpret mode, ``flash_attention_ref`` and ``jax.grad`` of the
reference's own attention.  The CUDA kernels run only on the card, where
``chip_smoke.py`` holds them to these plain versions."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention.kernel import flash_attention_pallas
from repro.kernels.flash_attention.ref import flash_attention_ref
from repro.models.attention import attention as jax_attention
from repro_torch.bridge import to_numpy
from repro_torch.kernels.flash_attention import ops
from repro_torch.kernels.flash_attention.ref import (flash_attention_bwd_ref,
                                                     flash_attention_fwd_ref)
from repro_torch.models.attention import attention

torch.set_num_threads(2)

# B, Tq, Tk, Hq, Hk, D, q_offset, causal, window (tests/test_kernels.py
# FLASH_CASES: q_offset, Tq != Tk, window, non-causal, GQA)
FLASH_CASES = [
    (2, 128, 128, 4, 2, 64, 0, True, 0),
    (1, 256, 256, 4, 4, 128, 0, True, 0),
    (2, 100, 260, 8, 2, 64, 160, True, 0),
    (1, 128, 384, 4, 1, 64, 256, True, 128),
    (1, 7, 128, 2, 2, 64, 121, True, 0),
    (2, 64, 64, 4, 2, 64, 0, False, 0),
]
# tests/test_kernels.py's tolerances: sums in another order (f32), and
# bf16 outputs rounded at other places than the Pallas kernel's
DTYPES = {"float32": (jnp.float32, torch.float32, 2e-5),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, 3e-2)}
# f32 gradients: the plain backward and JAX's autodiff sum the same
# products in another order, so they agree to f32 rounding over up to a
# few thousand terms
GRAD_TOL = 2e-5


def _inputs(case, seed):
    B, Tq, Tk, Hq, Hk, D = case[:6]
    rng = np.random.default_rng(seed)
    return [rng.normal(size=s).astype(np.float32)
            for s in ((B, Tq, Hq, D), (B, Tk, Hk, D), (B, Tk, Hk, D),
                      (B, Tq, Hq, D))]


def _kw(case):
    return dict(q_offset=case[6], causal=case[7], window=case[8])


@pytest.mark.parametrize("case", FLASH_CASES)
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_plain_forward_matches_pallas_and_ref(case, dtype):
    jdt, tdt, tol = DTYPES[dtype]
    q, k, v, _ = _inputs(case, seed=sum(case[:6]))
    jq, jk, jv = (jnp.asarray(x, jdt) for x in (q, k, v))
    want = np.asarray(flash_attention_pallas(
        jq, jk, jv, block_q=64, block_k=64, interpret=True, **_kw(case)),
        np.float32)
    ref = np.asarray(flash_attention_ref(jq, jk, jv, **_kw(case)),
                     np.float32)
    got, lse = flash_attention_fwd_ref(
        *(torch.from_numpy(x).to(tdt) for x in (q, k, v)), **_kw(case))
    assert got.dtype == tdt and lse.dtype == torch.float32
    np.testing.assert_allclose(to_numpy(got), want, atol=tol, rtol=tol)
    np.testing.assert_allclose(to_numpy(got), ref, atol=tol, rtol=tol)
    assert torch.isfinite(lse).all()        # every row of these sees a key


def test_rows_that_see_nothing_give_zero():
    """Queries 200..263 over keys 0..99 with window 128: the first rows
    see keys 73..99, the rest nothing.  Those give 0 as the Pallas kernel
    and ``_plain`` do (``flash_attention_ref`` gives the mean of v), an
    LSE of -inf, and no gradient."""
    case = (1, 64, 100, 4, 2, 64, 200, True, 128)
    q, k, v, do = _inputs(case, seed=3)
    kw = _kw(case)
    tq, tk, tv, tdo = (torch.from_numpy(x) for x in (q, k, v, do))
    o, lse = flash_attention_fwd_ref(tq, tk, tv, **kw)
    blind = ~torch.isfinite(lse)                          # (B, Hq, Tq)
    assert 0 < int(blind.sum()) < blind.numel()
    assert float(o.transpose(1, 2)[blind].abs().max()) == 0.0
    want = np.asarray(flash_attention_pallas(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), block_q=64,
        block_k=64, interpret=True, **kw))
    np.testing.assert_allclose(to_numpy(o), want, atol=2e-5, rtol=2e-5)
    dq, dk, dv = flash_attention_bwd_ref(tq, tk, tv, o, lse, tdo, **kw)
    assert float(dq.transpose(1, 2)[blind].abs().max()) == 0.0
    assert torch.isfinite(dk).all() and torch.isfinite(dv).all()


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_autograd_function_on_cpu_is_the_plain_forward(dtype):
    case = FLASH_CASES[2]
    tdt = DTYPES[dtype][1]
    q, k, v, _ = (torch.from_numpy(x).to(tdt)
                  for x in _inputs(case, seed=5))
    got = ops.flash_attention(q, k, v, **_kw(case))
    want, _ = flash_attention_fwd_ref(q, k, v, **_kw(case))
    assert torch.equal(got, want)


def _jax_grads(q, k, v, do, kw):
    """jax.grad of the reference's ``repro.models.attention.attention``
    (``_plain``, or ``_flash`` at Tq >= 1024 and Tk >= 2048) at
    contiguous positions."""
    B, Tq = q.shape[:2]
    Tk = k.shape[1]
    q_pos = jnp.broadcast_to(kw["q_offset"] + jnp.arange(Tq), (B, Tq))
    k_pos = jnp.broadcast_to(jnp.arange(Tk), (B, Tk))

    def f(q, k, v):
        o = jax_attention(q, k, v, q_pos, k_pos, causal=kw["causal"],
                          window=kw["window"])
        return jnp.sum(o * do)
    return [np.asarray(g) for g in jax.grad(f, argnums=(0, 1, 2))(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))]


@pytest.mark.parametrize("case", FLASH_CASES + [
    (1, 1024, 2048, 2, 1, 32, 1024, True, 0)],
    ids=[str(i) for i in range(len(FLASH_CASES))] + ["flash-path"])
def test_plain_backward_matches_jax_grad_and_autograd(case):
    q, k, v, do = _inputs(case, seed=11 + case[1])
    kw = _kw(case)
    want = _jax_grads(q, k, v, do, kw)
    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    tdo = torch.from_numpy(do)
    o = ops.flash_attention(tq, tk, tv, **kw)
    got = torch.autograd.grad(o, (tq, tk, tv), tdo)
    for name, g, w in zip("qkv", got, want):
        np.testing.assert_allclose(g.numpy(), w, atol=GRAD_TOL,
                                   rtol=GRAD_TOL, err_msg=f"d{name}")
    # the same gradients by torch autograd through the plain forward's ops
    o2, _ = flash_attention_fwd_ref(tq, tk, tv, **kw)
    auto = torch.autograd.grad(o2, (tq, tk, tv), tdo)
    for name, g, w in zip("qkv", got, auto):
        np.testing.assert_allclose(g.numpy(), w.numpy(), atol=GRAD_TOL,
                                   rtol=GRAD_TOL, err_msg=f"d{name}")


def test_cache_free_attention_goes_to_k3_and_refuses_masks():
    case = FLASH_CASES[0]
    q, k, v, _ = (torch.from_numpy(x) for x in _inputs(case, seed=7))
    B, T = q.shape[:2]
    pos = torch.arange(T, dtype=torch.int32).expand(B, T)
    got = attention(q, k, v, pos, pos, contiguous=True)
    want, _ = flash_attention_fwd_ref(q, k, v)
    assert torch.equal(got, want)
    with pytest.raises(NotImplementedError):
        attention(q, k, v, pos, pos, contiguous=True,
                  kv_valid=torch.ones(B, T, dtype=torch.bool))
    with pytest.raises(NotImplementedError):
        attention(q, k, v, pos, pos, contiguous=True, softcap=30.0)


def test_check_inputs_refuses_what_the_kernel_does_not_take():
    q = torch.zeros(1, 8, 4, 64)
    k = torch.zeros(1, 8, 2, 64)
    ops.check_inputs(q, k, k, q_offset=0, window=0)
    with pytest.raises(TypeError):
        ops.check_inputs(q.half(), k.half(), k.half(), q_offset=0,
                         window=0)
    with pytest.raises(ValueError, match="head dim"):
        ops.check_inputs(q[..., :48], k[..., :48], k[..., :48], q_offset=0,
                         window=0)
    with pytest.raises(ValueError, match="contiguous"):
        ops.check_inputs(q.transpose(1, 2), k, k, q_offset=0, window=0)
    with pytest.raises(ValueError, match="q_offset"):
        ops.check_inputs(q, k, k, q_offset=-1, window=0)
    with pytest.raises(ValueError):
        ops.check_inputs(q, torch.zeros(1, 8, 3, 64), torch.zeros(1, 8, 3, 64),
                         q_offset=0, window=0)


def test_library_digest_follows_included_headers(tmp_path):
    """``KernelLibrary.path`` digests the source and every header it
    includes (followed recursively, resolved as nvcc does): editing a
    header gives a new library path, so a stale build is never reused;
    editing a file nobody includes does not."""
    from repro_torch.kernels.build import KernelLibrary, sources_of
    (tmp_path / "csrc").mkdir()
    src = tmp_path / "csrc" / "k.cu"
    src.write_text('#include <cuda_runtime.h>\n#include "../inc/a.cuh"\n')
    (tmp_path / "inc").mkdir()
    (tmp_path / "inc" / "a.cuh").write_text('#include "b.cuh"\n// a\n')
    (tmp_path / "inc" / "b.cuh").write_text("// b\n")
    (tmp_path / "inc" / "other.cuh").write_text("// unused\n")
    assert [p.name for p in sources_of(src)] == ["k.cu", "a.cuh", "b.cuh"]
    lib = KernelLibrary("k", src, lambda _: None)
    first = lib.path()
    (tmp_path / "inc" / "other.cuh").write_text("// still unused\n")
    assert lib.path() == first
    (tmp_path / "inc" / "b.cuh").write_text("// b, edited\n")
    second = lib.path()
    assert second != first
    (tmp_path / "inc" / "a.cuh").write_text('#include "b.cuh"\n// a, edited\n')
    assert lib.path() not in (first, second)
    # K3's own source reaches the shared Hopper header
    assert "hopper.cuh" in [p.name for p in sources_of(ops.SOURCE)]


def _aligned(shape, dtype=torch.float32):
    return torch.zeros(shape, dtype=dtype)


def _misaligned(shape, dtype=torch.bfloat16):
    n = int(np.prod(shape))
    return torch.zeros(n + 1, dtype=dtype)[1:].view(shape)   # 2 bytes off


@pytest.mark.parametrize("make, error, reason", [
    (lambda: (_misaligned((1, 8, 4, 64)), _aligned((1, 8, 2, 64),
                                                   torch.bfloat16)),
     ValueError, "16-byte aligned"),
    (lambda: (_aligned((1, 4, 8, 64)).transpose(1, 2),
              _aligned((1, 8, 2, 64))), ValueError, "contiguous"),
    (lambda: (_aligned((1, 8, 4, 48)), _aligned((1, 8, 2, 48))),
     ValueError, "head dim 48"),
    (lambda: (_aligned((1, 8, 4, 512)), _aligned((1, 8, 2, 512))),
     ValueError, "head dim 512"),
    (lambda: (_aligned((65536, 1, 1, 64)), _aligned((65536, 1, 1, 64))),
     ValueError, "grid"),
    (lambda: (_aligned((1, 8, 4, 64), torch.float16),
              _aligned((1, 8, 2, 64), torch.float16)), TypeError,
     "float32, bfloat16"),
    (lambda: (_aligned((1, 8, 4, 64)), _aligned((1, 8, 3, 64))),
     ValueError, "vs k"),
], ids=["misaligned", "non-contiguous", "head-dim-48", "head-dim-512",
        "grid", "float16", "heads-not-grouped"])
def test_check_inputs_names_the_reason(make, error, reason):
    """What neither route of the kernels takes is refused before a launch,
    with the reason in the message: TMA and the 16-byte loads need
    contiguous, 16-byte-aligned rows; the library is built for head dims
    32, 64, 128 and 256; the grid holds at most 65535 (batch, KV head)
    pairs; the dtype is float32 or bfloat16; Hq is a multiple of Hk."""
    q, k = make()
    with pytest.raises(error, match=reason):
        ops.check_inputs(q, k, k, q_offset=0, window=0)
