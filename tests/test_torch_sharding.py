"""The port's placement rules (``repro_torch.sharding``) and the engine's
shard layouts (``repro_torch.launch.steps``) against the reference's
``repro.sharding`` and ``repro.launch.steps`` on real JAX meshes (the
test process forces 8 CPU devices), and the launch checks of
``repro_torch.launch.mesh``.

Every placement function gives the reference's spec on the same axes,
shapes and mesh sizes — with the divisibility guards and the used-axis
drop — over every leaf of every arch's tiny params.  The shard that
``launch.steps`` gives rank r of each leaf is that leaf's slice under the
reference's ``exact_col_spec``, except where the reference cuts an
attention weight in the middle of a head (its columns divide tp, its
heads do not): the port keeps whole heads on a rank there
(``sharding.head_shard``), and the test holds it to exactly those
heads."""
from dataclasses import replace

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_tiny_config as jget_tiny
from repro.launch.steps import engine_cache_shardings as jcache_shardings
from repro.models import init_cache as jinit_cache
from repro.models import init_params as jinit_params
from repro.sharding import ShardCtx as JShardCtx
from repro.sharding import batch_axes as jbatch_axes
from repro.sharding import exact_col_spec as jexact_col_spec
from repro.sharding import head_axis as jhead_axis
from repro.sharding import logical_to_spec as jlogical_to_spec
from repro.sharding import param_rules as jparam_rules
from repro.sharding import seq_axis as jseq_axis
from repro_torch import sharding as S
from repro_torch.bridge import params_from_jax, to_numpy
from repro_torch.configs import get_tiny_config
from repro_torch.engine import Instance, StepFunctions
from repro_torch.launch import steps as L
from repro_torch.launch.mesh import engine_group
from repro_torch.layout import jax_layout
from repro_torch.models import init_cache

torch.set_num_threads(2)

ARCHS = ["granite-3-8b", "yi-6b", "phi4-mini-3.8b", "moonshot-v1-16b-a3b",
         "deepseek-moe-16b", "mixtral-8x7b", "mamba2-370m", "zamba2-1.2b",
         "llama-3.2-vision-11b", "whisper-tiny"]
# (data, model) mesh shapes: the engine's 1-D meshes and production ones
MESHES = [(1, 1), (1, 2), (1, 4), (1, 8), (2, 4), (4, 2), (8, 1)]


def _ctxs(shape, **kw):
    """The reference's ShardCtx on a (data, model) mesh and the port's
    on the same axis sizes."""
    data, model = shape
    mesh = jax.make_mesh((data, model), ("data", "model"))
    j = JShardCtx(mesh=mesh, dp=kw.get("dp", ("data",)), tp="model",
                  fsdp=kw.get("fsdp"), seq_shard=kw.get("seq_shard", True),
                  exact=kw.get("exact", False))
    t = S.ShardCtx(tp_size=model, dp=kw.get("dp", ("data",)),
                   fsdp=kw.get("fsdp"), seq_shard=kw.get("seq_shard", True),
                   exact=kw.get("exact", False),
                   axis_sizes=(("data", data),))
    return j, t


def _axes_leaves(axes, params, path=()):
    """(path, logical axes, shape) of every leaf of a reference tree."""
    if isinstance(axes, tuple):
        yield path, axes, tuple(params.shape)
        return
    for k in axes:
        yield from _axes_leaves(axes[k], params[k], path + (k,))


@pytest.fixture(scope="module")
def trees():
    out = {}
    for arch in ARCHS:
        cfg = replace(jget_tiny(arch), dtype="float32")
        params, axes = jinit_params(cfg, jax.random.PRNGKey(1))
        out[arch] = (cfg, params, axes)
    return out


@pytest.mark.parametrize("mesh", MESHES)
def test_logical_to_spec_and_param_rules_match_reference(trees, mesh):
    """``param_rules`` (serving and training, with and without FSDP) and
    ``logical_to_spec`` give the reference's spec for every leaf of every
    arch's tiny params, and on the used-axis cases (an expert axis that
    divides takes the tensor-parallel axis, then ``eff`` may not)."""
    for fsdp in (None, "data"):
        j, t = _ctxs(mesh, fsdp=fsdp)
        for train in (False, True):
            jr, tr = jparam_rules(j, train), S.param_rules(t, train)
            assert jr == tr
            for cfg, params, axes in trees.values():
                for path, ax, shape in _axes_leaves(axes, params):
                    want = tuple(jlogical_to_spec(ax, jr, j.mesh, shape))
                    assert S.logical_to_spec(ax, tr, t, shape) == want, path
            for shape in [(8, 16, 32), (6, 16, 32), (8, 6, 32), (1, 4, 4)]:
                ax = ("expert", "embed", "eff")
                want = tuple(jlogical_to_spec(ax, jr, j.mesh, shape))
                assert S.logical_to_spec(ax, tr, t, shape) == want, shape
            rules = dict(tr, embed=("data", "model"))
            for shape in [(8, 16), (6, 16), (16, 6)]:
                ax = ("embed", "ff")
                want = tuple(jlogical_to_spec(ax, rules, j.mesh, shape))
                assert S.logical_to_spec(ax, rules, t, shape) == want


@pytest.mark.parametrize("mesh", MESHES)
def test_exact_col_spec_and_guards_match_reference(trees, mesh):
    """``exact_col_spec`` on every leaf of every arch, and ``head_axis``,
    ``batch_axes`` and ``seq_axis`` over a range of sizes and contexts."""
    j, t = _ctxs(mesh, exact=True)
    for cfg, params, axes in trees.values():
        for path, ax, shape in _axes_leaves(axes, params):
            want = tuple(jexact_col_spec(ax, shape, j))
            assert S.exact_col_spec(ax, shape, t) == want, path
    for n in range(1, 34):
        assert S.head_axis(t, n) == jhead_axis(j, n)
        for seq_shard in (False, True):
            js, ts = _ctxs(mesh, seq_shard=seq_shard)
            assert S.seq_axis(ts, n) == jseq_axis(js, n)
        for dp in ((), ("data",)):
            jd, td = _ctxs(mesh, dp=dp)
            assert S.batch_axes(td, n) == jbatch_axes(jd, n)
    assert S.head_axis(None, 4) is None and S.seq_axis(None, 4) is None
    assert S.batch_axes(None, 4) is None


def test_batch_axes_prefix_fallback_matches_reference():
    """A (pod, data) batch that only the shorter prefix divides."""
    mesh = jax.make_mesh((2, 2, 2), ("pod", "data", "model"))
    j = JShardCtx(mesh=mesh, dp=("pod", "data"))
    t = S.ShardCtx(tp_size=2, dp=("pod", "data"),
                   axis_sizes=(("pod", 2), ("data", 2)))
    for n in range(1, 12):
        assert S.batch_axes(t, n) == jbatch_axes(j, n), n


def _port_ctx(tp, rank):
    return S.ShardCtx(tp_size=tp, rank=rank, exact=True, seq_shard=False)


def _whole_heads(cfg, name, tp, rank, leaf):
    """The columns of the heads ``head_shard`` gives the rank."""
    hs = S.head_shard(cfg.num_heads, cfg.num_kv_heads, tp, rank)
    lo, hi = (hs.q_lo, hs.q_hi) if name == "wq" else (hs.kv_lo, hs.kv_hi)
    return leaf[..., lo * cfg.head_dim:hi * cfg.head_dim]


@pytest.mark.parametrize("arch", ARCHS)
def test_engine_param_shards_are_the_reference_slices(trees, arch):
    """Rank r's shard of every leaf (built leaf by leaf by the bridge with
    the rank's context) is the reference's ``exact_col_spec`` slice of
    that leaf at tp 2 and 4 — or, for an attention weight the reference
    cuts mid-head, the rank's whole heads — and a leaf the reference
    keeps whole is whole."""
    jcfg, params, axes = trees[arch]
    tcfg = replace(get_tiny_config(arch), dtype="float32")
    np_tree = jax.tree.map(np.asarray, params)
    split_seen = 0
    for tp in (2, 4):
        j, _ = _ctxs((1, tp), exact=True)
        for rank in range(tp):
            sctx = _port_ctx(tp, rank)
            shard = params_from_jax(tcfg, np_tree, device="cpu", sctx=sctx)
            ported = jax_layout(shard)
            for path, ax, shape in _axes_leaves(axes, np_tree):
                leaf = np_tree
                got = ported
                for k in path:
                    leaf, got = leaf[k], got[k]
                got = to_numpy(got)
                spec = jexact_col_spec(ax, shape, j)
                want = leaf
                if spec[-1] is not None:
                    w = shape[-1] // tp
                    want = leaf[..., rank * w:(rank + 1) * w]
                name = path[-1]
                heads = ax[-1] in ("heads", "kv")
                hd = tcfg.head_dim
                mid_head = heads and (
                    (shape[-1] // tp) % hd
                    or tcfg.num_heads % tp
                    or (ax[-1] == "kv" and tcfg.num_kv_heads % tp))
                if mid_head:
                    want = _whole_heads(tcfg, name, tp, rank, leaf)
                np.testing.assert_array_equal(got, want,
                                              err_msg=f"{path} tp={tp}")
                split_seen += got.shape != leaf.shape
    if arch != "mamba2-370m":
        assert split_seen > 0


@pytest.mark.parametrize("arch", [a for a in ARCHS if a != "mamba2-370m"])
def test_engine_cache_shards_match_reference(trees, arch):
    """``k`` / ``v`` are split by KV head exactly where the reference's
    ``engine_cache_shardings`` splits them (``head_axis``); every other
    leaf the reference replicates is whole, except the cross-attention
    memory, which the port splits by KV head like ``k`` / ``v``.  A
    rank's ``init_cache`` has the shapes of its shards."""
    jcfg, _, _ = trees[arch]
    tcfg = replace(get_tiny_config(arch), dtype="float32")
    jcache = jax.tree.map(np.asarray, jinit_cache(jcfg, 2, 16))
    rng = np.random.default_rng(0)
    full = {k: rng.normal(size=v.shape).astype(np.float32)
            for k, v in jcache.items()}
    for tp in (2, 4):
        j, _ = _ctxs((1, tp), exact=True)
        specs = jcache_shardings(j, jcache)
        for rank in range(tp):
            sctx = _port_ctx(tp, rank)
            mine = init_cache(tcfg, 2, 16, device="cpu", sctx=sctx)
            assert sorted(mine) == sorted(full)
            hs = S.head_shard(tcfg.num_heads, tcfg.num_kv_heads, tp, rank)
            for name, leaf in full.items():
                got = to_numpy(L.cache_shard(tcfg, name,
                                             torch.from_numpy(leaf), sctx))
                assert got.shape == tuple(mine[name].shape), name
                spec = tuple(specs[name].spec)
                if name in ("k", "v") and spec[3] is not None:
                    w = leaf.shape[3] // tp
                    want = leaf[:, :, :, rank * w:(rank + 1) * w]
                elif name in L.HEAD_LEAVES:
                    want = leaf[..., hs.kv_lo:hs.kv_hi, :]
                else:
                    assert all(s is None for s in spec), name
                    want = leaf
                np.testing.assert_array_equal(got, want, err_msg=name)


@pytest.mark.parametrize("hq,hk", [(4, 2), (4, 1), (3, 1), (3, 3), (32, 8),
                                   (32, 4), (24, 8), (16, 16), (12, 3)])
def test_head_shard_keeps_whole_ratios(hq, hk):
    """Every rank's query heads read only its KV heads at a whole ratio;
    the query heads cover the layer once (or the layer is whole on every
    rank), and the KV heads cover it in order."""
    for tp in (1, 2, 4, 8):
        shards = [S.head_shard(hq, hk, tp, r) for r in range(tp)]
        whole = shards[0] == (0, hq, 0, hk)
        if not whole:
            assert [s.q_lo for s in shards] == [r * hq // tp
                                                for r in range(tp)]
            assert shards[-1].q_hi == hq
        seen = set()
        for s in shards:
            nq, nk = s.q_hi - s.q_lo, s.kv_hi - s.kv_lo
            assert nq % nk == 0
            for h in range(s.q_lo, s.q_hi):
                kv = h // (hq // hk)
                assert s.kv_lo <= kv < s.kv_hi
                assert kv - s.kv_lo == (h - s.q_lo) // (nq // nk)
            seen.update(range(s.kv_lo, s.kv_hi))
        assert seen == set(range(hk))


def test_engine_group_needs_its_ranks():
    """``engine_group`` keeps the reference's ``tp must be >= 1`` error,
    gives tp=1 a one-rank context, and refuses a degree this process's
    group cannot hold with the launch hint; so does ``Instance(tp=)``."""
    with pytest.raises(ValueError, match="tp must be >= 1"):
        engine_group(0)
    one = engine_group(1)
    assert one.tp_size == 1 and one.group is None and one.exact
    assert engine_group(1) is one
    with pytest.raises(ValueError, match="launch one process per rank"):
        engine_group(2)
    cfg = replace(get_tiny_config("granite-3-8b"), dtype="float32")
    from repro_torch.models import init_params
    params = init_params(cfg, torch.Generator().manual_seed(0),
                         device="cpu")
    with pytest.raises(ValueError, match="needs 2 ranks"):
        Instance(cfg, params, StepFunctions(cfg), device="cpu", tp=2)


def test_init_params_shards_are_the_whole_draws():
    """``init_params(sctx=)`` draws the same weights as without a
    context and keeps rank r's shard of each."""
    cfg = replace(get_tiny_config("moonshot-v1-16b-a3b"), dtype="float32")
    whole = init_params_seeded(cfg, None)
    for rank in range(2):
        sctx = _port_ctx(2, rank)
        got = init_params_seeded(cfg, sctx)
        want = L.engine_param_shards(cfg, whole, sctx)
        flat_g, flat_w = _flat(got), _flat(want)
        assert sorted(flat_g) == sorted(flat_w)
        for k in flat_w:
            assert torch.equal(flat_g[k], flat_w[k]), k
        assert flat_g["layers.0.moe.wg"].shape[1] * 2 == \
            _flat(whole)["layers.0.moe.wg"].shape[1]


def init_params_seeded(cfg, sctx):
    from repro_torch.models import init_params
    return init_params(cfg, torch.Generator().manual_seed(3), device="cpu",
                       sctx=sctx)


def _flat(tree, prefix=""):
    out = {}
    items = tree.items() if isinstance(tree, dict) else enumerate(tree)
    for k, v in items:
        key = f"{prefix}{k}"
        if isinstance(v, (dict, list)):
            out.update(_flat(v, key + "."))
        else:
            out[key] = v
    return out
