"""K1 (spec-verify attention) of the PyTorch port against the JAX
package: the port's plain version — what its wrapper runs on a CPU tensor
— against ``spec_verify_ref`` and the Pallas kernel in interpret mode, on
the cases of ``tests/test_kernels.py`` plus rows with no visible key, at
that file's tolerances (2e-5 at f32, 3e-2 at bf16).  The CUDA kernel
itself runs only on the card, where ``chip_smoke.py`` holds it to this
plain version."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.spec_verify.kernel import spec_verify_pallas
from repro.kernels.spec_verify.ref import spec_verify_ref as jax_ref
from repro_torch.bridge import to_numpy
from repro_torch.kernels.spec_verify import ops
from repro_torch.kernels.spec_verify.ref import spec_verify_ref

torch.set_num_threads(2)

# B, T, S, Hq, Hk, D, window (tests/test_kernels.py VERIFY_CASES)
VERIFY_CASES = [
    (2, 5, 256, 4, 2, 64, 0),
    (1, 1, 128, 8, 8, 128, 0),
    (3, 9, 384, 4, 1, 64, 0),
    (2, 4, 256, 4, 2, 64, 64),
]
DTYPES = {"float32": (jnp.float32, torch.float32, 2e-5),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, 3e-2)}


def _inputs(case, seed, empty_rows):
    B, T, S, Hq, Hk, D, _ = case
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(B, T, Hq, D)).astype(np.float32)
    k = rng.normal(size=(B, S, Hk, D)).astype(np.float32)
    v = rng.normal(size=(B, S, Hk, D)).astype(np.float32)
    base = rng.integers(50, 150, size=(B, 1))
    q_pos = (base + np.arange(T)[None]).astype(np.int32)
    k_pos = np.full((B, S), -1, np.int32)
    for b in range(B):
        sl = rng.permutation(S)[:min(int(base[b, 0]) + T, S)]
        k_pos[b, sl] = np.arange(len(sl))
    if empty_rows:
        k_pos[-1] = -1            # a row whose cache is empty
        q_pos[0, 0] = -1          # a query before every key
    return q, k, v, q_pos, k_pos


@pytest.mark.parametrize("empty_rows", [False, True])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("case", VERIFY_CASES)
def test_plain_matches_jax(case, dtype, empty_rows):
    jdt, tdt, tol = DTYPES[dtype]
    q, k, v, q_pos, k_pos = _inputs(case, 7, empty_rows)
    win = case[-1]
    jargs = (jnp.asarray(q, jdt), jnp.asarray(k, jdt), jnp.asarray(v, jdt),
             jnp.asarray(q_pos), jnp.asarray(k_pos))
    want_ref = np.asarray(jax_ref(*jargs, window=win), np.float32)
    want_pallas = np.asarray(spec_verify_pallas(
        *jargs, window=win, block_k=64, interpret=True), np.float32)
    targs = [torch.from_numpy(a) for a in (q, k, v, q_pos, k_pos)]
    targs[:3] = [t.to(tdt) for t in targs[:3]]
    got = ops.spec_verify(*targs, window=win)
    assert got.dtype == tdt and got.shape == targs[0].shape
    got = to_numpy(got)
    np.testing.assert_allclose(got, want_ref, atol=tol, rtol=tol)
    np.testing.assert_allclose(got, want_pallas, atol=tol, rtol=tol)
    if empty_rows:
        assert not got[-1].any() and not got[0, 0].any()


def test_cpu_calls_are_not_launches():
    q, k, v, q_pos, k_pos = (torch.from_numpy(a) for a in
                             _inputs(VERIFY_CASES[0], 1, False))
    n0 = dict(ops.launches)
    a = ops.spec_verify(q, k, v, q_pos, k_pos)
    assert ops.launches == n0
    assert torch.equal(a, spec_verify_ref(q, k, v, q_pos, k_pos))


def test_other_devices_raise():
    q, k, v, q_pos, k_pos = (torch.from_numpy(a).to("meta") for a in
                             _inputs(VERIFY_CASES[0], 1, False))
    with pytest.raises(ValueError, match="no kernel for device"):
        ops.spec_verify(q, k, v, q_pos, k_pos)


def _good():
    return [torch.from_numpy(a) for a in _inputs(VERIFY_CASES[0], 2, False)]


def _bad_cases():
    B, T, S, Hq, Hk, D, _ = VERIFY_CASES[0]
    q, k, v, qp, kp = _good()
    return {
        "dtype_f16": (TypeError, [q.half(), k.half(), v.half(), qp, kp]),
        "mixed_dtype": (TypeError, [q, k.bfloat16(), v, qp, kp]),
        "pos_int64": (TypeError, [q, k, v, qp.long(), kp]),
        "rank": (ValueError, [q[0], k, v, qp, kp]),
        "batch": (ValueError, [q[:1], k, v, qp[:1], kp]),
        "head_dim": (ValueError, [q[..., :48].contiguous(),
                                  k[..., :48].contiguous(),
                                  v[..., :48].contiguous(), qp, kp]),
        "gqa": (ValueError, [q[:, :, :3].contiguous(), k, v, qp, kp]),
        "q_pos_shape": (ValueError, [q, k, v, qp[:, :1], kp]),
        "k_pos_shape": (ValueError, [q, k, v, qp, kp[:, :8]]),
        "q_strided": (ValueError, [q.transpose(1, 2).contiguous()
                                   .transpose(1, 2), k, v, qp, kp]),
        "kv_strided": (ValueError, [q, k.transpose(1, 2).contiguous()
                                    .transpose(1, 2), v, qp, kp]),
        "kv_mismatch": (ValueError, [q, k, v[:, :S // 2], qp, kp]),
        "kv_misaligned": (ValueError, [
            q, torch.empty(k.numel() + 1)[1:].view(k.shape), v, qp, kp]),
    }


@pytest.mark.parametrize("name", sorted(_bad_cases()))
def test_wrapper_input_checks(name):
    exc, args = _bad_cases()[name]
    with pytest.raises(exc):
        ops.check_inputs(*args)


def test_wrapper_accepts_cache_views():
    """The engine passes per-layer views of a cache with a hidden scratch
    slot: strided in batch, contiguous in (S, Hk, D)."""
    from repro_torch.configs import get_tiny_config
    from repro_torch.models import init_cache
    cfg = get_tiny_config("granite-3-8b")
    cache = init_cache(cfg, 3, 16, device="cpu")
    B, S = 3, 16
    q = torch.zeros(B, 2, cfg.num_heads, cfg.head_dim, dtype=torch.bfloat16)
    ops.check_inputs(q, cache["k"][0], cache["v"][0],
                     torch.zeros(B, 2, dtype=torch.int32), cache["slot_pos"])
    assert cache["k"][0].stride(0) != S * cfg.num_kv_heads * cfg.head_dim
