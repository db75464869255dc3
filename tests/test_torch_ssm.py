"""The port's SSM slice against the JAX package on the CPU: the plain
SSD (K4's CPU path) against ``ssd_ref`` and the Pallas kernel in
interpret mode; ``causal_conv``, ``gated_rms_norm`` and ``mamba_block``;
``forward`` on mamba2-370m tiny; token-exact ``Instance`` runs in the
linear, tree (chains), sync and per-slot modes, where rejected drafts
make the engine replay the recurrent state; KV blobs whose recurrent
leaves cross both ways; a token-exact ``SeerRollout``; and the replay
rules: bitwise a no-op when its mask equals the first pass's, decided on
the host without a sync.  All at f32, with the reference's weights."""
from dataclasses import replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_rec import (blobs_cross, fused_vs_sync, load_models, pair,
                        rollout_matches, run_side_by_side)
from repro.kernels.ssd_scan.ops import ssd_chunk_scan as jssd_pallas
from repro.kernels.ssd_scan.ref import ssd_ref as jssd_ref
from repro.models import common as jcommon
from repro.models import forward as jforward
from repro.models import init_cache as jinit_cache
from repro.models import mamba2 as jmamba
from repro_torch.bridge import to_numpy
from repro_torch.kernels.ssd_scan import ops as ssd_ops
from repro_torch.models import common as tcommon
from repro_torch.models import forward, init_cache, init_params
from repro_torch.models import mamba2 as tmamba
from repro_torch.training.loop import RLConfig, RLTrainer

torch.set_num_threads(2)
ARCH = "mamba2-370m"
# tests/test_kernels.py's SSD_CASES: b, T, nh, P, G, N, chunk, with_init
SSD_CASES = [
    (2, 128, 4, 64, 1, 128, 64, False),
    (1, 96, 8, 32, 2, 64, 32, True),
    (2, 32, 2, 64, 1, 128, 128, True),
    (1, 256, 4, 64, 4, 32, 64, False),
]


@pytest.fixture(scope="module")
def m():
    return load_models(ARCH)


def _ssd_inputs(seed, b, T, nh, P, G, N, with_init):
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


@pytest.mark.parametrize("case", SSD_CASES)
def test_plain_ssd_matches_reference_and_pallas(case):
    *shape, chunk, with_init = case
    args = _ssd_inputs(sum(shape), *shape, with_init)
    y, s = ssd_ops.ssd_chunk_scan(*map(_t, args), chunk)
    for fn in (jssd_ref, jssd_pallas):
        yr, sr = fn(*map(_j, args), chunk)
        np.testing.assert_allclose(to_numpy(y), np.asarray(yr), atol=1e-4)
        np.testing.assert_allclose(to_numpy(s), np.asarray(sr), atol=1e-4)


def test_plain_ssd_chunk_independence():
    args = _ssd_inputs(3, 1, 192, 2, 32, 1, 64, True)
    outs = [ssd_ops.ssd_chunk_scan(*map(_t, args), c) for c in (32, 64, 192)]
    for y, s in outs[1:]:
        np.testing.assert_allclose(to_numpy(y), to_numpy(outs[0][0]),
                                   atol=2e-4)
        np.testing.assert_allclose(to_numpy(s), to_numpy(outs[0][1]),
                                   atol=2e-4)


def test_plain_ssd_masked_rows_and_out_state():
    """Rows whose dt is 0 keep their state exactly; ``out_state`` may be
    the initial state itself (the in-place update of the cache)."""
    x, dt, A, Bm, Cm, S0 = map(_t, _ssd_inputs(5, 3, 33, 4, 16, 1, 16, True))
    dt[1] = 0.0
    dt[2, 20:] = 0.0
    y, s = ssd_ops.ssd_chunk_scan(x, dt, A, Bm, Cm, S0, 256)
    assert torch.equal(s[1], S0[1]) and not torch.equal(s[0], S0[0])
    y20, s20 = ssd_ops.ssd_chunk_scan(x[2:, :20], dt[2:, :20], A, Bm[2:, :20],
                                      Cm[2:, :20], S0[2:], 256)
    assert torch.equal(s[2:], s20)
    inplace = S0.clone()
    y2, s2 = ssd_ops.ssd_chunk_scan(x, dt, A, Bm, Cm, inplace, 256,
                                    out_state=inplace)
    assert s2 is inplace and torch.equal(s2, s) and torch.equal(y2, y)


def test_wrapper_checks():
    x, dt, A, Bm, Cm, S0 = map(_t, _ssd_inputs(1, 1, 9, 2, 16, 1, 16, True))
    ssd_ops.check_inputs(x, dt, A, Bm, Cm, S0, S0, 256)
    bad = [(x.double(), dt, A, Bm, Cm, S0, S0, 256),
           (x, dt.bfloat16(), A, Bm, Cm, S0, S0, 256),
           (x, dt, A, Bm[:, :, :, :8], Cm, S0, S0, 256),
           (x, dt, A, Bm, Cm, S0.transpose(2, 3), S0, 256),
           (x, dt, A, Bm, Cm, S0, S0, 0),
           (x.transpose(2, 3), dt, A, Bm, Cm, S0, S0, 256)]
    for args in bad:
        with pytest.raises((TypeError, ValueError)):
            ssd_ops.check_inputs(*args)
    with pytest.raises(ValueError, match="no kernel"):
        ssd_ops.ssd_chunk_scan(x.to("meta"), dt.to("meta"), A.to("meta"),
                               Bm.to("meta"), Cm.to("meta"), None, 256)


@pytest.mark.parametrize("masked", [False, True])
def test_causal_conv_exact(masked):
    rng = np.random.default_rng(7)
    b, T, ch, K = 3, 6, 24, 4
    x = rng.normal(size=(b, T, ch)).astype(np.float32)
    w = rng.normal(size=(K, ch)).astype(np.float32)
    bias = rng.normal(size=(ch,)).astype(np.float32)
    cache = rng.normal(size=(b, K - 1, ch)).astype(np.float32)
    mask = (np.arange(T)[None] < np.asarray([6, 2, 0])[:, None]) \
        if masked else None
    want = jmamba.causal_conv(*map(_j, (x, w, bias, cache, mask)))
    got = tmamba.causal_conv(*map(_t, (x, w, bias, cache, mask)))
    for a, b_ in zip(want, got):
        np.testing.assert_array_equal(to_numpy(b_), np.asarray(a))
    if masked:      # a row with no valid token keeps its window
        np.testing.assert_array_equal(to_numpy(got[1][2]), cache[2])


def test_gated_rms_norm():
    rng = np.random.default_rng(2)
    x, z = (rng.normal(size=(2, 5, 64)).astype(np.float32) for _ in "xz")
    w = rng.normal(size=(64,)).astype(np.float32)
    for jdt, tdt, tol in ((jnp.float32, torch.float32, 1e-6),
                          (jnp.bfloat16, torch.bfloat16, 1e-2)):
        want = jcommon.gated_rms_norm(jnp.asarray(x, jdt), jnp.asarray(z, jdt),
                                      jnp.asarray(w))
        got = tcommon.gated_rms_norm(torch.from_numpy(x).to(tdt),
                                     torch.from_numpy(z).to(tdt),
                                     torch.from_numpy(w))
        assert got.dtype == tdt
        np.testing.assert_allclose(to_numpy(got), np.asarray(want, np.float32),
                                   atol=tol, rtol=tol)


def test_mamba_block(m):
    """One block with a carried conv window and state, padded rows
    included, at f32."""
    cfg = m.tcfg
    rng = np.random.default_rng(4)
    b, T = 3, 7
    ch = cfg.d_inner + 2 * cfg.ssm_ngroups * cfg.ssm_state
    x = rng.normal(size=(b, T, cfg.d_model)).astype(np.float32)
    conv = rng.normal(size=(b, cfg.ssm_conv - 1, ch)).astype(np.float32)
    ssm = rng.normal(size=(b, cfg.ssm_nheads, cfg.ssm_head_dim,
                           cfg.ssm_state)).astype(np.float32)
    mask = np.arange(T)[None] < np.asarray([7, 3, 0])[:, None]
    jp = jax.tree.map(lambda a: a[0], m.jp["layers"])
    want = jmamba.mamba_block(jp, *map(_j, (x,)), m.jcfg, *map(
        _j, (conv, ssm, mask)))
    got = tmamba.mamba_block(m.tp["layers"][0], _t(x), cfg,
                             *map(_t, (conv, ssm, mask)))
    for a, b_ in zip(want, got):
        np.testing.assert_allclose(to_numpy(b_), np.asarray(a), atol=1e-5,
                                   rtol=1e-5)
    np.testing.assert_array_equal(to_numpy(got[2][2]), ssm[2])


def test_forward_logits_and_caches(m):
    """Prefill chunks with padded rows, a decode step and a verify step
    through ``forward``: logits and every cache leaf equal the
    reference's (a pure-SSM cache has no ``slot_pos``)."""
    B, S = 3, 64
    jc = jinit_cache(m.jcfg, B, S)
    tc = init_cache(m.tcfg, B, S, device="cpu")
    assert sorted(tc) == ["conv", "ssm"] and tc["ssm"].dtype == torch.float32
    rng = np.random.default_rng(0)
    start = np.zeros(B, np.int64)
    for T, n in ((8, [8, 5, 0]), (8, [3, 8, 8]), (1, [1, 1, 1]),
                 (5, [5, 2, 1])):
        toks = rng.integers(0, m.tcfg.vocab_size, size=(B, T)).astype(np.int32)
        pos = (start[:, None] + np.arange(T)[None]).astype(np.int32)
        mask = np.arange(T)[None] < np.asarray(n)[:, None]
        jl, jc, _ = jforward(m.jcfg, m.jp, jnp.asarray(toks), jnp.asarray(pos),
                             jc, token_mask=jnp.asarray(mask))
        tl, tc2, _ = forward(m.tcfg, m.tp, *map(_t, (toks, pos)), tc,
                             token_mask=_t(mask))
        assert tc2 is tc
        np.testing.assert_allclose(to_numpy(tl)[mask], np.asarray(jl)[mask],
                                   atol=1e-5, rtol=1e-5)
        for k in tc:
            np.testing.assert_allclose(to_numpy(tc[k]), np.asarray(jc[k]),
                                       atol=1e-5, rtol=1e-5)
        start += np.asarray(n)


@pytest.mark.parametrize("temp", [0.0, 1.0])
@pytest.mark.parametrize("mode", ["linear", "tree", "sync"])
def test_instances_token_exact(m, temp, mode):
    kw = {"linear": {}, "tree": {"spec_mode": "tree"},
          "sync": {"prefill_mode": "sync"}}[mode]
    port = run_side_by_side(m, temp, syncs_per_step=2 if mode == "sync"
                            else 1, **kw)
    if mode != "sync":
        assert port.steps.replays > 0


@pytest.mark.parametrize("migration_mode", ["batched", "perslot"])
def test_blobs_cross_both_ways(m, migration_mode):
    blobs_cross(m, 1.0, migration_mode)


def test_fused_step_equals_sync_oracle(m):
    steps, replays = fused_vs_sync(m, "linear")
    assert steps > 5 and replays > 0


def test_rollout_token_exact(m):
    tro = rollout_matches(m, 1.0)
    assert tro.steps.replays > 0


def test_replay_with_equal_mask_is_bitwise(m):
    """A replay whose mask equals the first pass's (every draft accepted)
    leaves the cache bitwise as the first pass alone leaves it."""
    from repro_torch.engine import StepFunctions
    from repro_torch.engine.sampling import position_keys, prng_key
    from repro_torch.models.transformer import clone_cache
    cfg, steps = m.tcfg, StepFunctions(m.tcfg)
    B, T = 3, 5
    cache = init_cache(cfg, B, 64, device="cpu")
    rng = np.random.default_rng(9)
    forward(cfg, m.tp, torch.from_numpy(rng.integers(0, 512, size=(B, 8)
                                                     ).astype(np.int32)),
            torch.arange(8, dtype=torch.int32).expand(B, 8), cache,
            token_mask=torch.ones((B, 8), dtype=torch.bool))
    toks = torch.from_numpy(rng.integers(0, 512, size=(B, T)).astype(np.int32))
    pos = (8 + torch.arange(T, dtype=torch.int32)).expand(B, T).contiguous()
    mask = torch.ones((B, T), dtype=torch.bool)
    keys = position_keys(prng_key(0), torch.zeros(B, dtype=torch.int32), pos)
    temps = torch.zeros(B)
    rows = torch.zeros(B, dtype=torch.bool)    # no sample rows: all kept
    zero = torch.zeros(B, dtype=torch.int32)
    fn = steps.fused_step(T)
    a, b = clone_cache(cache), clone_cache(cache)
    fn(m.tp, a, toks, pos, mask, keys, temps, rows, zero, zero, False)
    fn(m.tp, b, toks, pos, mask, keys, temps, rows, zero, zero, True)
    assert steps.replays == 1
    for k in a:
        assert torch.equal(a[k], b[k]), k


def test_replay_decided_on_the_host(m, monkeypatch):
    """The fused step gets ``replay`` from the host: true exactly in the
    steps where some row carries drafts, and no tensor is read for it."""
    _, port = pair(m)
    flags = []
    fn_of = port.steps.fused_step

    def spy(T, sctx=None):
        fn = fn_of(T, sctx)

        def wrapped(*args):
            flags.append(args[-1])
            return fn(*args)
        return wrapped
    monkeypatch.setattr(port.steps, "fused_step", spy)
    from repro_torch.engine import EngineSeq
    port.admit(EngineSeq("a", "g", [1, 2, 3], seed=1, temperature=0.0,
                         max_new_tokens=8))
    port.run_step()                  # prefill
    port.run_step({0: [4, 5]})       # verify with drafts
    port.run_step()                  # decode
    assert flags == [False, True, False]


def test_trainer_refuses_ssm(m):
    """The trainer no longer refuses an SSM model (K4 has its backward):
    ``RLTrainer`` takes it, and a train forward's gradient runs through
    K4's backward (its plain version here) once per Mamba2 block.  Still
    refused: a cache-free forward at positions other than 0..T-1
    (tests/test_torch_train_loop.py holds the trainer to the
    reference's)."""
    from repro_torch.data.tasks import make_task
    from repro_torch.kernels.ssd_scan import ref as ssd_ref
    from repro_torch.training.optim import tree_items
    task = make_task("copy", m.tcfg.vocab_size, prompt_len=4,
                     response_len=4)
    tr = RLTrainer(m.tcfg, task, RLConfig(device="cpu"), params=m.tp)
    with pytest.raises(NotImplementedError, match="positions 0..T-1"):
        forward(m.tcfg, m.tp, torch.zeros((1, 2), dtype=torch.int32),
                torch.zeros((1, 2), dtype=torch.int32), None)
    pos = torch.arange(4, dtype=torch.int32)[None]
    n0 = ssd_ref.calls["ssd_bwd"]
    logits, _, _ = forward(m.tcfg, tr.params, pos, pos, None, train=True)
    leaves = [t for _, t in tree_items(tr.params)]
    grads = torch.autograd.grad(logits.float().square().mean(), leaves)
    assert ssd_ref.calls["ssd_bwd"] - n0 == m.tcfg.num_layers
    assert all(bool(torch.isfinite(g).all()) for g in grads)


def test_moe_still_refused():
    """Every arch is served and trained now; what the port still refuses
    is an arch it does not know, and the cache-free forward of a VLM or
    audio model without its image embeddings or audio frames (the
    reference asserts they are there)."""
    from repro_torch.configs import get_tiny_config
    unknown = replace(get_tiny_config(ARCH), arch_type="diffusion")
    with pytest.raises(NotImplementedError):
        init_cache(unknown, 1, 8, device="cpu")
    with pytest.raises(NotImplementedError):
        init_params(unknown, torch.Generator().manual_seed(0), device="cpu")
    for arch in ("llama-3.2-vision-11b", "whisper-tiny"):
        cfg = get_tiny_config(arch)
        params = init_params(cfg, torch.Generator().manual_seed(0),
                             device="cpu")
        tok = torch.arange(2, dtype=torch.int32)[None]
        with pytest.raises(ValueError, match="aux_inputs"):
            forward(cfg, params, tok, tok, None)
