"""The port's model (configs, common, transformer) against the JAX
package on granite-3-8b tiny, with the reference's own weights
(``init_params(cfg, PRNGKey(1))``) carried over by the bridge: logits and
caches of a padded prefill chunk, a decode step and a verify step, at
1e-5 (f32) and 3e-2 (bf16), plus a sliding-window ring cache."""
import dataclasses
from dataclasses import replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as jcfgs
from repro.models import common as jcommon
from repro.models import forward as jforward
from repro.models import init_cache as jinit_cache
from repro.models import init_params as jinit_params
import repro_torch.configs as tcfgs
from repro_torch.bridge import (cache_from_jax, cache_to_numpy,
                                params_from_jax, to_numpy)
from repro_torch.models import common as tcommon
from repro_torch.models import forward, init_cache, init_params

torch.set_num_threads(2)
ARCH = "granite-3-8b"
TOL = {"float32": 1e-5, "bfloat16": 3e-2}


@pytest.fixture(scope="module")
def jax_params():
    cfg = jcfgs.get_tiny_config(ARCH)
    params, _ = jinit_params(cfg, jax.random.PRNGKey(1))
    return params, jax.tree.map(np.asarray, params)


def test_configs_equal_the_reference():
    archs = [ARCH, "mamba2-370m", "zamba2-1.2b", "moonshot-v1-16b-a3b",
             "deepseek-moe-16b", "mixtral-8x7b", "yi-6b", "phi4-mini-3.8b",
             "llama-3.2-vision-11b", "whisper-tiny"]
    assert tcfgs.list_archs() == sorted(archs) == jcfgs.list_archs()
    for arch in archs:
        for get in ("get_config", "get_tiny_config"):
            ref = getattr(jcfgs, get)(arch)
            port = getattr(tcfgs, get)(arch)
            assert dataclasses.asdict(port) == dataclasses.asdict(ref), \
                (arch, get)
            assert port.head_dim == ref.head_dim
            assert (port.d_inner, port.ssm_nheads) == \
                (ref.d_inner, ref.ssm_nheads)


def test_norm_and_rope_match():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 5, 4, 32)).astype(np.float32)
    w = rng.normal(size=(32,)).astype(np.float32)
    pos = rng.integers(0, 5000, size=(2, 5)).astype(np.int32)
    for jdt, tdt, tol in ((jnp.float32, torch.float32, 1e-6),
                          (jnp.bfloat16, torch.bfloat16, 1e-2)):
        want = np.asarray(jcommon.rms_norm(jnp.asarray(x, jdt),
                                           jnp.asarray(w)), np.float32)
        got = to_numpy(tcommon.rms_norm(torch.from_numpy(x).to(tdt),
                                        torch.from_numpy(w)))
        np.testing.assert_allclose(got, want, atol=tol, rtol=tol)
        want = np.asarray(jcommon.apply_rope(
            jnp.asarray(x, jdt), jnp.asarray(pos), 10_000.0), np.float32)
        got = to_numpy(tcommon.apply_rope(torch.from_numpy(x).to(tdt),
                                          torch.from_numpy(pos), 10_000.0))
        np.testing.assert_allclose(got, want, atol=tol * 10, rtol=tol)


def test_seeded_init_shapes_and_scales(jax_params):
    """The port's own init has the bridged reference's tree, dtypes and
    scales, and is a pure function of the generator's seed."""
    cfg = tcfgs.get_tiny_config(ARCH)
    ref = params_from_jax(cfg, jax_params[1], device="cpu")
    a = init_params(cfg, torch.Generator().manual_seed(3), device="cpu")
    b = init_params(cfg, torch.Generator().manual_seed(3), device="cpu")
    flat = [(("embed",), a["embed"], ref["embed"], b["embed"]),
            (("final_ln",), a["final_ln"], ref["final_ln"], b["final_ln"])]
    for i, layer in enumerate(a["layers"]):
        for blk, leaves in layer.items():
            for name, t in leaves.items():
                flat.append(((i, blk, name), t, ref["layers"][i][blk][name],
                             b["layers"][i][blk][name]))
    assert len(a["layers"]) == cfg.num_layers
    for key, t, r, t2 in flat:
        assert t.shape == r.shape and t.dtype == r.dtype, key
        assert torch.equal(t, t2), key
        ts, rs = t.float().std().item(), r.float().std().item()
        assert abs(ts - rs) <= 0.15 * rs + 1e-6, (key, ts, rs)


def _steps():
    """(tokens, positions, mask) of a padded prefill chunk (row 1 half
    padded, row 2 all padding), a decode step and a verify step."""
    rng = np.random.default_rng(0)
    B, V = 3, 512
    steps = []
    tok = rng.integers(0, V, (B, 8)).astype(np.int32)
    pos = np.tile(np.arange(8, dtype=np.int32), (B, 1))
    mask = np.ones((B, 8), bool)
    mask[1, 5:] = False
    mask[2] = False
    steps.append((tok, pos, mask))
    nxt = np.array([8, 5, 0], np.int32)
    steps.append((rng.integers(0, V, (B, 1)).astype(np.int32),
                  nxt[:, None].copy(), np.ones((B, 1), bool)))
    tok = rng.integers(0, V, (B, 4)).astype(np.int32)
    pos = (nxt + 1)[:, None] + np.arange(4, dtype=np.int32)[None]
    mask = np.ones((B, 4), bool)
    mask[0, 3] = False
    steps.append((tok, pos.astype(np.int32), mask))
    return steps


def _run_both(cfg, jparams, nparams, steps, B, S):
    tparams = params_from_jax(cfg, nparams, device="cpu")
    jc = jinit_cache(cfg, B, S)
    tc = init_cache(cfg, B, S, device="cpu")
    for tok, pos, mask in steps:
        lj, jc, _ = jforward(cfg, jparams, jnp.asarray(tok),
                             jnp.asarray(pos), jc,
                             token_mask=jnp.asarray(mask))
        lt, tc2, _ = forward(cfg, tparams, torch.from_numpy(tok),
                             torch.from_numpy(pos), tc,
                             token_mask=torch.from_numpy(mask))
        assert tc2 is tc                 # updated in place
        yield np.asarray(lj, np.float32), to_numpy(lt), jc, tc


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_forward_matches_jax(dtype, jax_params):
    cfg = replace(tcfgs.get_tiny_config(ARCH), dtype=dtype)
    jcfg = replace(jcfgs.get_tiny_config(ARCH), dtype=dtype)
    tol = TOL[dtype]
    n = 0
    for lj, lt, jc, tc in _run_both(jcfg, jax_params[0], jax_params[1],
                                    _steps(), B=3, S=32):
        assert lt.shape == lj.shape
        np.testing.assert_allclose(lt, lj, atol=tol, rtol=tol)
        got = cache_to_numpy(tc)
        assert set(got) == set(jc)
        np.testing.assert_array_equal(got["slot_pos"],
                                      np.asarray(jc["slot_pos"]))
        for k in ("k", "v"):
            np.testing.assert_allclose(got[k], np.asarray(jc[k], np.float32),
                                       atol=tol, rtol=tol)
        n += 1
    assert n == 3


def test_bridged_cache_continues(jax_params):
    """A cache filled by the reference, carried over by the bridge,
    continues in the port as it does in the reference."""
    cfg = replace(tcfgs.get_tiny_config(ARCH), dtype="float32")
    jcfg = replace(jcfgs.get_tiny_config(ARCH), dtype="float32")
    (tok, pos, mask), *rest = _steps()
    _, jc, _ = jforward(jcfg, jax_params[0], jnp.asarray(tok),
                        jnp.asarray(pos), jinit_cache(jcfg, 3, 32),
                        token_mask=jnp.asarray(mask))
    tc = cache_from_jax(cfg, jax.tree.map(np.asarray, jc), device="cpu")
    np.testing.assert_array_equal(cache_to_numpy(tc)["k"],
                                  np.asarray(jc["k"]))
    tparams = params_from_jax(cfg, jax_params[1], device="cpu")
    for tok, pos, mask in rest:
        lj, jc, _ = jforward(jcfg, jax_params[0], jnp.asarray(tok),
                             jnp.asarray(pos), jc,
                             token_mask=jnp.asarray(mask))
        lt, tc, _ = forward(cfg, tparams, torch.from_numpy(tok),
                            torch.from_numpy(pos), tc,
                            token_mask=torch.from_numpy(mask))
        np.testing.assert_allclose(to_numpy(lt), np.asarray(lj),
                                   atol=1e-5, rtol=1e-5)


def test_ring_cache_matches_jax(jax_params):
    """Sliding window: slots are ``positions % S`` and writes wrap."""
    cfg = replace(tcfgs.get_tiny_config(ARCH), dtype="float32",
                  sliding_window=12)
    jcfg = replace(jcfgs.get_tiny_config(ARCH), dtype="float32",
                   sliding_window=12)
    rng = np.random.default_rng(1)
    steps = []
    for c in range(4):                   # 4 chunks of 6 -> wraps twice
        tok = rng.integers(0, 512, (2, 6)).astype(np.int32)
        pos = (6 * c + np.arange(6, dtype=np.int32))[None].repeat(2, 0)
        mask = np.ones((2, 6), bool)
        mask[1, 4:] = c < 3
        steps.append((tok, pos, mask))
    n = 0
    for lj, lt, jc, tc in _run_both(jcfg, jax_params[0], jax_params[1],
                                    steps, B=2, S=64):
        assert tc["slot_pos"].shape[1] == 12
        np.testing.assert_allclose(lt, lj, atol=1e-5, rtol=1e-5)
        np.testing.assert_array_equal(to_numpy(tc["slot_pos"]),
                                      np.asarray(jc["slot_pos"]))
        n += 1
    assert n == 4


def test_unported_paths_raise():
    cfg = tcfgs.get_tiny_config(ARCH)
    params = init_params(cfg, torch.Generator().manual_seed(0),
                         device="cpu")
    tok = torch.zeros((1, 2), dtype=torch.int32)
    with pytest.raises(NotImplementedError):
        forward(cfg, params, tok, tok, None)
    # the contiguous prefill and the cached forward under the production
    # layout's context across ranks run (tests/test_torch_production_
    # steps.py, test_torch_production_cache.py), and so do its data axes
    # over ranks (tests/test_torch_data_axis*.py); what its meshes refuse
    # is a process group whose size is not the mesh's
    from repro_torch.launch import mesh
    orig = mesh._world
    mesh._world = lambda: 3
    try:
        with pytest.raises(ValueError, match="exactly 2 ranks, not 3"):
            mesh.small_mesh(2)
    finally:
        mesh._world = orig
    # VLM and audio models: their cache-free forward needs the image
    # embeddings or audio frames, and RLTrainer refuses them, as the
    # reference's fails on them (its batch carries neither)
    from repro_torch.data.tasks import make_task
    from repro_torch.training import RLConfig, RLTrainer
    pos = torch.arange(2, dtype=torch.int32)[None]
    for arch in ("llama-3.2-vision-11b", "whisper-tiny"):
        other = tcfgs.get_tiny_config(arch)
        p = init_params(other, torch.Generator().manual_seed(0),
                        device="cpu")
        with pytest.raises(ValueError, match="aux_inputs"):
            forward(other, p, pos, pos, None)
        task = make_task("copy", other.vocab_size, prompt_len=4,
                         response_len=4)
        with pytest.raises(NotImplementedError, match="VLM or audio"):
            RLTrainer(other, task, RLConfig(device="cpu"), params=p)
