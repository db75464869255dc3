"""The production layout's one-rank paths against the JAX package:
``forward(contiguous_update=True)`` (the production prefill) and the four
cached step builders of ``launch/steps.py`` on one rank, and the
meshes' refusal of a process group of another size.  The cached paths
across ranks are ``tests/test_torch_production_cache.py``'s, with the
data axes over ranks ``tests/test_torch_data_axis_cache.py``'s.

Tiny configs at f32 with the reference's weights (``init_params(cfg,
PRNGKey(1))`` through the bridge), caches from each package's
``init_cache``.

* The contiguous prefill (the counterparts of ``tests/test_perf_paths.py``
  ``:26``, ``:63`` and ``:100``): two chunks (start 0, then start 8) on
  granite, the VLM and zamba2 tiny — logits at 2e-5 of scale,
  ``slot_pos`` equal, K/V at 2e-5 of scale against the reference's (two
  packages' f32 projections do not round alike) and bitwise the port's
  own slot-scatter path (the same projections written another way); a
  start near the end clamped as the reference's dynamic update slice
  clamps it; the whole-window ring roll on mixtral tiny with
  ``sliding_window=8`` through K3 (no K1 launch), the scatter path
  through K1.  The scratch slot stays untouched.
* ``build_prefill_step`` then ``build_serve_step`` (four greedy
  decodes), ``build_verify_step`` (γ = 3) and ``build_tree_verify_step``
  (a three-path tree through K2), with no context and on a one-rank
  production context, against the reference's builders with
  ``sctx=None``: greedy tokens exact, ``slot_pos`` equal."""
from dataclasses import replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as jcfgs
import repro_torch.configs as tcfgs
from repro.launch import steps as jsteps
from repro.models import build_cross_cache as jbuild_cross_cache
from repro.models import forward as jforward
from repro.models import init_cache as jinit_cache
from repro.models import init_params as jinit_params
from repro_torch.bridge import params_from_jax, to_numpy
from repro_torch.kernels.flash_attention import ref as flash_ref
from repro_torch.kernels.spec_verify import ref as sv_ref
from repro_torch.launch import steps as tsteps
from repro_torch.launch.mesh import make_shard_ctx, small_mesh
from repro_torch.models.transformer import (build_cross_cache, forward,
                                            init_cache, n_attn_layers,
                                            n_cross_layers, with_scratch)
from repro_torch.sharding import ShardCtx

torch.set_num_threads(2)
TOL = 2e-5


def _models(arch, **over):
    jcfg = replace(jcfgs.get_tiny_config(arch), dtype="float32", **over)
    tcfg = replace(tcfgs.get_tiny_config(arch), dtype="float32", **over)
    jp, _ = jinit_params(jcfg, jax.random.PRNGKey(1))
    tp = params_from_jax(tcfg, jax.tree.map(np.asarray, jp), device="cpu")
    return jcfg, tcfg, jp, tp


def _close(got, want, what):
    want = np.asarray(want, np.float32)
    scale = max(float(np.abs(want).max()), 1.0)
    np.testing.assert_allclose(np.asarray(got, np.float32), want, rtol=TOL,
                               atol=TOL * scale, err_msg=what)


def _caches(jcfg, tcfg, jp, tp, B, S, rng):
    """Each package's empty cache (a VLM's cross memory built from the
    same seeded image embeddings)."""
    jc = jinit_cache(jcfg, B, S)
    tc = init_cache(tcfg, B, S, device="cpu")
    if jcfg.arch_type == "vlm":
        emb = rng.normal(size=(B, jcfg.num_image_tokens,
                               jcfg.d_model)).astype(np.float32)
        jc["cross_k"], jc["cross_v"] = jbuild_cross_cache(jcfg, jp,
                                                          jnp.asarray(emb))
        k, v = build_cross_cache(tcfg, tp, torch.from_numpy(emb))
        tc["cross_k"].copy_(k)
        tc["cross_v"].copy_(v)
    return jc, tc


def _clone(cache):
    from repro_torch.models.transformer import clone_cache
    return clone_cache(cache)


@pytest.mark.parametrize("arch", ["granite-3-8b", "llama-3.2-vision-11b",
                                  "zamba2-1.2b"])
def test_contiguous_update_matches_reference(arch):
    """Two chunks (start 0, then 8) of the production prefill: the
    reference's logits and cache, the port's scatter path's K/V bit for
    bit, K1 once an attention layer (self or cross) a chunk."""
    jcfg, tcfg, jp, tp = _models(arch)
    B, T, S = 2, 16, 32
    rng = np.random.default_rng(0)
    tok = rng.integers(0, jcfg.vocab_size, (B, T)).astype(np.int32)
    pos = np.broadcast_to(np.arange(T), (B, T)).astype(np.int32)
    jc, tc = _caches(jcfg, tcfg, jp, tp, B, S, rng)
    scatter = _clone(tc)
    for lo, hi in ((0, 8), (8, 16)):
        t, p = tok[:, lo:hi], pos[:, lo:hi]
        jl, jc, _ = jforward(jcfg, jp, jnp.asarray(t), jnp.asarray(p), jc,
                             contiguous_update=True)
        n0 = sv_ref.calls["spec_verify"]
        tl, tc, _ = forward(tcfg, tp, torch.from_numpy(t),
                            torch.from_numpy(p), tc, contiguous_update=True)
        assert sv_ref.calls["spec_verify"] - n0 == \
            n_attn_layers(tcfg) + n_cross_layers(tcfg)
        sl, scatter, _ = forward(tcfg, tp, torch.from_numpy(t),
                                 torch.from_numpy(p), scatter)
        _close(to_numpy(tl), jl, f"logits {lo}")
        np.testing.assert_array_equal(to_numpy(tc["slot_pos"]),
                                      np.asarray(jc["slot_pos"]))
        for key in ("k", "v"):
            _close(to_numpy(tc[key]), jc[key], f"{key} {lo}")
            assert torch.equal(tc[key], scatter[key])
        assert torch.equal(tl, sl)
    assert (to_numpy(with_scratch(tc["slot_pos"], 1))[:, S] == -1).all()
    assert not with_scratch(tc["k"], 2)[:, :, S].any()


def test_contiguous_update_start_clamped():
    """A chunk whose slots would run past the cache starts where the
    reference's dynamic update slice puts it (S - T), without a host
    read of the start."""
    jcfg, tcfg, jp, tp = _models("granite-3-8b")
    B, T, S = 2, 8, 32
    rng = np.random.default_rng(4)
    tok = rng.integers(0, jcfg.vocab_size, (B, T)).astype(np.int32)
    pos = (28 + np.arange(T, dtype=np.int32))[None].repeat(B, 0)
    jc, tc = _caches(jcfg, tcfg, jp, tp, B, S, rng)
    jl, jc, _ = jforward(jcfg, jp, jnp.asarray(tok), jnp.asarray(pos), jc,
                         contiguous_update=True)
    tl, tc, _ = forward(tcfg, tp, torch.from_numpy(tok),
                        torch.from_numpy(pos), tc, contiguous_update=True)
    want = np.asarray(jc["slot_pos"])
    np.testing.assert_array_equal(to_numpy(tc["slot_pos"]), want)
    assert (want[:, S - T:] == pos).all()
    _close(to_numpy(tl), jl, "logits")
    _close(to_numpy(tc["k"]), jc["k"], "k")


def test_ring_prefill_roll_matches_reference():
    """A whole-window prefill (T = 3 x the window) on a ring cache: the
    cache holds the last S tokens rolled to their slots, as the
    reference's; attention over the step's own K/V through K3."""
    jcfg, tcfg, jp, tp = _models("mixtral-8x7b", sliding_window=8)
    B, T = 2, 24
    rng = np.random.default_rng(2)
    tok = rng.integers(0, jcfg.vocab_size, (B, T)).astype(np.int32)
    pos = np.broadcast_to(np.arange(T), (B, T)).astype(np.int32)
    jl, jc, _ = jforward(jcfg, jp, jnp.asarray(tok), jnp.asarray(pos),
                         jinit_cache(jcfg, B, T), contiguous_update=True)
    tc = init_cache(tcfg, B, T, device="cpu")
    k0, f0 = sv_ref.calls["spec_verify"], flash_ref.calls["forward"]
    tl, tc, _ = forward(tcfg, tp, torch.from_numpy(tok),
                        torch.from_numpy(pos), tc, contiguous_update=True)
    assert sv_ref.calls["spec_verify"] == k0
    assert flash_ref.calls["forward"] - f0 == tcfg.num_layers
    assert tc["slot_pos"].shape[1] == 8
    np.testing.assert_array_equal(to_numpy(tc["slot_pos"]),
                                  np.asarray(jc["slot_pos"]))
    _close(to_numpy(tl), jl, "logits")
    for key in ("k", "v"):
        _close(to_numpy(tc[key]), jc[key], key)
    assert (to_numpy(with_scratch(tc["slot_pos"], 1))[:, 8] == -1).all()


def three_path_tree(first, pos0, B, vocab):
    """A tree of 7 nodes a row: a root (``first``, at ``pos0``) with three
    children, each with one child: (tokens, positions, slot_index, mask,
    within) as numpy; row 1's last node is masked."""
    parent = [-1, 0, 0, 0, 1, 2, 3]
    depth = [0, 1, 1, 1, 2, 2, 2]
    n = len(parent)
    within = np.zeros((n, n), bool)
    for i in range(n):
        j = i
        while j >= 0:
            within[i, j] = True
            j = parent[j]
    toks = np.stack([[first[b]] + [(first[b] + 7 * i + b) % vocab
                                   for i in range(1, n)] for b in range(B)])
    pos = (pos0 + np.array(depth, np.int32))[None].repeat(B, 0)
    slots = (pos0 + np.arange(n, dtype=np.int32))[None].repeat(B, 0)
    mask = np.ones((B, n), bool)
    mask[1, -1] = False
    return (toks.astype(np.int32), pos, slots, mask,
            np.broadcast_to(within, (B, n, n)).copy())


def _builder_run(api, cfg, params, cache, tok, sctx):
    """Prefill, four greedy decodes, a γ = 3 verify and a tree verify:
    every greedy token, and slot_pos after each step (numpy)."""
    B, T = tok.shape
    pos = np.broadcast_to(np.arange(T), (B, T)).astype(np.int32)
    cache = api.prefill(cfg, sctx)(params, api.t(tok), api.t(pos), cache)
    out = {"slot_pos": [api.n(cache["slot_pos"])], "serve": []}
    nxt, p = tok[:, -1], T
    serve = api.serve(cfg, sctx)
    for _ in range(4):
        got, cache = serve(params, api.t(nxt[:, None]),
                           api.t(np.full((B, 1), p, np.int32)), cache)
        nxt = api.n(got).astype(np.int32)
        out["serve"].append(nxt.tolist())
        p += 1
    cand = np.stack([nxt, (nxt + 1) % cfg.vocab_size, nxt, nxt], 1)
    vpos = (p + np.arange(4, dtype=np.int32))[None].repeat(B, 0)
    got, cache = api.verify(cfg, sctx)(params, api.t(cand.astype(np.int32)),
                                       api.t(vpos), cache)
    out["verify"] = api.n(got).tolist()
    out["slot_pos"].append(api.n(cache["slot_pos"]))
    tt, tpos, slots, mask, within = three_path_tree(nxt, p + 4, B,
                                                    cfg.vocab_size)
    got, cache = api.tree(cfg, sctx)(params, api.t(tt), api.t(tpos),
                                     api.t(slots), api.t(mask),
                                     api.t(within), cache)
    out["tree"] = api.n(got).tolist()
    out["slot_pos"].append(api.n(cache["slot_pos"]))
    return out


class _Api:
    def __init__(self, mod, t, n):
        self.prefill = mod.build_prefill_step
        self.serve = mod.build_serve_step
        self.verify = mod.build_verify_step
        self.tree = mod.build_tree_verify_step
        self.t, self.n = t, n


@pytest.mark.parametrize("ctx", ["none", "one-rank"])
def test_cached_builders_match_reference(ctx):
    """The four cached builders on one rank: the reference's greedy
    tokens (serve, verify targets, tree targets) and ``slot_pos``."""
    jcfg, tcfg, jp, tp = _models("granite-3-8b")
    B, T, S = 2, 16, 64
    tok = np.random.default_rng(3).integers(
        0, jcfg.vocab_size, (B, T)).astype(np.int32)
    japi = _Api(jsteps, jnp.asarray, np.asarray)
    # a copy: the port updates its cache in place, and to_numpy shares a
    # CPU tensor's memory
    tapi = _Api(tsteps, torch.from_numpy, lambda t: to_numpy(t).copy())
    want = _builder_run(japi, jcfg, jp, jinit_cache(jcfg, B, S), tok, None)
    sctx = None if ctx == "none" else make_shard_ctx(small_mesh(1),
                                                     train=False)
    got = _builder_run(tapi, tcfg, tp, init_cache(tcfg, B, S, device="cpu"),
                       tok, sctx)
    for key in ("serve", "verify", "tree"):
        assert got[key] == want[key], key
    for a, b in zip(got["slot_pos"], want["slot_pos"]):
        np.testing.assert_array_equal(a, b)


def test_cached_paths_refused_across_ranks(monkeypatch):
    """The four cached builders take a production context over ranks
    now (``tests/test_torch_production_cache.py`` runs them on 2 and 4),
    and ``init_cache`` under it allocates a rank's piece: half the slots
    of each of ``k``, ``v`` and ``slot_pos`` and a scratch slot past
    them, every KV head, its span; under data axes over ranks, the
    rank's rows too.  The meshes take a process group of exactly their
    ranks: one of another size raises.  The cache-free forward under the
    engine's exact context is no path."""
    cfg = tcfgs.get_tiny_config("granite-3-8b")
    params = init_params_tiny(cfg)
    tok = torch.arange(4, dtype=torch.int32)[None]
    prod = ShardCtx(tp_size=2, rank=1, exact=False)
    for build in (tsteps.build_prefill_step, tsteps.build_serve_step,
                  tsteps.build_verify_step, tsteps.build_tree_verify_step):
        assert callable(build(cfg, prod))
    piece = init_cache(cfg, 1, 8, device="cpu", sctx=prod)
    assert piece["k"].shape[2] == 4 and piece["slot_pos"].shape == (1, 4)
    assert piece["k"].shape[3] == cfg.num_kv_heads
    assert piece[tsteps.SEQ_SPAN].tolist() == [4, 8, 8]
    assert (with_scratch(piece["slot_pos"], 1) == -1).all()
    rows = init_cache(cfg, 4, 8, device="cpu", sctx=replace(
        prod, dp=("data",), axis_sizes=(("data", 2),),
        coords=(("data", 1),), dp_group=object(), dp_rank=1))
    assert rows["k"].shape[1] == 2 and rows["slot_pos"].shape == (2, 4)
    assert rows[tsteps.BATCH_SPAN].tolist() == [2, 4, 4]
    from repro_torch.launch import mesh
    monkeypatch.setattr(mesh, "_world", lambda: 4)
    with pytest.raises(ValueError, match="exactly 2 ranks, not 4"):
        mesh.make_mesh((1, 2), ("data", "model"))
    with pytest.raises(NotImplementedError, match="exact"):
        forward(cfg, params, tok, tok, None,
                sctx=ShardCtx(tp_size=2, exact=True))


def init_params_tiny(cfg):
    from repro_torch.models.transformer import init_params
    return init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
