"""The production layout's placements (``repro_torch.launch.steps``:
``param_shardings``, ``opt_state_specs``, ``cache_shardings``,
``batch_shardings``, and ``param_shards``' pieces) and meshes
(``repro_torch.launch.mesh``: ``make_production_mesh``, ``small_mesh``,
``make_shard_ctx``) against the reference's, on the (data, model) mesh
shapes of 8 CPU devices (the test process forces 8).

Every spec is the reference's, leaf by leaf, in the reference's tree
(the port's specs are tuples of mesh axes, the reference's
``PartitionSpec``s padded to the leaf's rank).  A rank's piece of each
parameter is the reference spec's slice on the ``model`` axis, except
where the port keeps a leaf whole: an attention block whose query or
KV heads do not divide the ranks (the reference may split ``wk`` in
the middle of a head) and the router (the reference's MoE body takes it
whole)."""
from dataclasses import replace

import jax
import numpy as np
import pytest
import torch

from repro.configs import INPUT_SHAPES
from repro.configs import get_tiny_config as jget_tiny
from repro.launch import steps as jsteps
from repro.launch.mesh import make_shard_ctx as jmake_shard_ctx
from repro.models import init_params as jinit_params
from repro.models import input_specs as jinput_specs
from repro_torch.bridge import params_from_jax
from repro_torch.configs import get_tiny_config
from repro_torch.launch import steps as L
from repro_torch.launch.mesh import (Mesh, make_production_mesh,
                                     make_shard_ctx, small_mesh)
from repro_torch.layout import jax_layout
from repro_torch.sharding import ShardCtx

ARCHS = ["granite-3-8b", "yi-6b", "phi4-mini-3.8b", "moonshot-v1-16b-a3b",
         "deepseek-moe-16b", "mixtral-8x7b", "mamba2-370m", "zamba2-1.2b",
         "llama-3.2-vision-11b", "whisper-tiny"]
MESHES = [(1, 1), (1, 2), (1, 4), (1, 8), (2, 4), (4, 2), (8, 1)]


def _ctxs(shape, train):
    data, model = shape
    mesh = jax.make_mesh(shape, ("data", "model"))
    return (jmake_shard_ctx(mesh, train=train),
            make_shard_ctx(Mesh(shape, ("data", "model")), train=train))


def _spec(ps, ndim):
    """A ``PartitionSpec`` as the port's tuple of ``ndim`` entries."""
    out = tuple(ps) + (None,) * (ndim - len(ps))
    return tuple(tuple(a) if isinstance(a, list) else a for a in out)


def _flat(tree, path=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _flat(tree[k], path + (k,))
    else:
        yield path, tree


@pytest.mark.parametrize("train", [False, True], ids=["serve", "train"])
@pytest.mark.parametrize("mesh", MESHES)
def test_param_and_opt_specs_match_reference(mesh, train):
    """``param_shardings`` and ``opt_state_specs`` give the reference's
    spec for every leaf of every arch (FSDP of the embedding rows on
    ``data`` in training)."""
    jctx, tctx = _ctxs(mesh, train)
    for arch in ARCHS:
        cfg = get_tiny_config(arch)
        jspecs, _ = jsteps.param_shardings(jget_tiny(arch), jctx,
                                           train=train)
        tspecs = L.param_shardings(cfg, tctx, train=train)
        want = dict(_flat(jax.tree.map(
            lambda s: _spec(s.sharding.spec, len(s.shape)), jspecs,
            is_leaf=lambda s: hasattr(s, "sharding"))))
        got = dict(_flat(tspecs))
        assert got == want, arch
        jopt = jsteps.opt_state_specs(jspecs)
        topt = L.opt_state_specs(tspecs)
        assert _spec(jopt.step.sharding.spec if jopt.step.sharding else (),
                     0) == topt.step
        assert dict(_flat(topt.mu)) == want == dict(_flat(topt.nu))
        jmu = jax.tree.map(lambda s: _spec(s.sharding.spec, len(s.shape)),
                           jopt.mu, is_leaf=lambda s: hasattr(s, "sharding"))
        assert dict(_flat(jmu)) == want


@pytest.mark.parametrize("mesh", MESHES)
def test_cache_and_batch_shardings_match_reference(mesh):
    """``batch_shardings`` (and ``cache_shardings`` within it) at every
    input shape of the reference, train and serve contexts, every
    arch."""
    for train in (False, True):
        jctx, tctx = _ctxs(mesh, train)
        for arch in ARCHS:
            jcfg, tcfg = jget_tiny(arch), get_tiny_config(arch)
            for shape in INPUT_SHAPES.values():
                if (shape.mode == "train") != train:
                    continue
                specs = jinput_specs(jcfg, shape)
                want = jsteps.batch_shardings(jcfg, jctx, shape, specs)
                got = L.batch_shardings(tcfg, tctx, shape, specs)
                assert sorted(got) == sorted(want)
                for key, sh in want.items():
                    if key == "cache":
                        for name, s in sh.items():
                            n = len(specs["cache"][name].shape)
                            assert got[key][name] == _spec(s.spec, n), \
                                (arch, shape.name, name)
                    else:
                        n = len(specs[key].shape)
                        assert got[key] == _spec(sh.spec, n) or (
                            sh.spec == jax.sharding.PartitionSpec()
                            and got[key] == ()), (arch, shape.name, key)


def _pieces_jax_layout(tree):
    """A rank's pieces in the reference's layout (``jax_layout``, with a
    MoE block's ``wg`` / ``wu`` split by its piece of ``wd``'s experts,
    not the router's width)."""
    if isinstance(tree, dict) and "router" in tree:
        out = {k: jax_layout(v) for k, v in tree.items()}
        e = tree["wd"].shape[0]
        for k in ("wg", "wu"):
            w = tree[k].detach()
            out[k] = w.reshape(w.shape[0], e, -1).permute(1, 0, 2)
        return out
    if isinstance(tree, dict):
        return {k: _pieces_jax_layout(v) for k, v in tree.items()}
    if isinstance(tree, list):
        subs = [_pieces_jax_layout(x) for x in tree]
        return jax.tree.map(lambda *xs: torch.stack(xs), *subs)
    return tree.detach()


def _whole_leaf(cfg, path, tp):
    """Leaves the port keeps whole where the reference's spec splits."""
    if path[-1] == "router":
        return True
    if path[-1] in ("wq", "wk", "wv", "wo"):
        return cfg.num_heads % tp != 0 or cfg.num_kv_heads % tp != 0
    return False


@pytest.mark.parametrize("arch", ARCHS)
def test_param_shards_are_the_reference_slices(arch):
    """Each rank's piece of every leaf at tp = 2 and 4 is the reference
    spec's slice along ``model`` (whole heads kept; the router whole)."""
    jcfg = replace(jget_tiny(arch), dtype="float32")
    cfg = replace(get_tiny_config(arch), dtype="float32")
    jp, _ = jinit_params(jcfg, jax.random.PRNGKey(1))
    ref = dict(_flat(jax.tree.map(np.asarray, jp)))
    params = params_from_jax(cfg, jax.tree.map(np.asarray, jp), device="cpu")
    for tp in (2, 4):
        jctx, _ = _ctxs((1, tp), False)
        specs, _ = jsteps.param_shardings(jcfg, jctx, train=False)
        specs = dict(_flat(jax.tree.map(
            lambda s: _spec(s.sharding.spec, len(s.shape)), specs,
            is_leaf=lambda s: hasattr(s, "sharding"))))
        for r in range(tp):
            sctx = ShardCtx(tp_size=tp, rank=r)
            got = dict(_flat(_pieces_jax_layout(
                L.param_shards(cfg, params, sctx))))
            assert sorted(got) == sorted(ref)
            for path, whole in ref.items():
                want = whole
                if not _whole_leaf(cfg, path, tp):
                    for dim, ax in enumerate(specs[path]):
                        if ax == "model":
                            n = whole.shape[dim] // tp
                            want = np.take(want, range(r * n, (r + 1) * n),
                                           axis=dim)
                np.testing.assert_array_equal(got[path].numpy(), want,
                                              err_msg=f"{path} rank {r}")


def test_production_meshes_need_their_ranks():
    """The production meshes are shapes that refuse a process group with
    too few ranks, as the reference's ``_check_devices`` refuses too few
    devices; a one-rank mesh runs here, and its context is the
    reference's."""
    with pytest.raises(ValueError, match="256 ranks"):
        make_production_mesh()
    with pytest.raises(ValueError, match="512 ranks"):
        make_production_mesh(multi_pod=True)
    with pytest.raises(ValueError, match="2 ranks"):
        small_mesh(2)
    mesh = small_mesh()
    assert mesh.shape == (1, 1) and mesh.axis_names == ("data", "model")
    for train in (False, True):
        for prefill_sp in (False, True):
            jmesh = jax.make_mesh((1, 1), ("data", "model"))
            want = jmake_shard_ctx(jmesh, train=train,
                                   seq_shard_prefill=prefill_sp)
            got = make_shard_ctx(mesh, train=train,
                                 seq_shard_prefill=prefill_sp)
            assert (got.dp, got.tp, got.fsdp, got.seq_shard, got.exact) == \
                (want.dp, want.tp, want.fsdp, want.seq_shard, want.exact)
            assert got.tp_size == want.tp_size == 1
    multi = make_shard_ctx(Mesh((2, 16, 16), ("pod", "data", "model")),
                           train=True)
    assert multi.dp == ("pod", "data") and multi.dp_size() == 32
    assert multi.tp_size == 16 and multi.fsdp == "data"
