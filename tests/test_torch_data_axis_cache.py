"""The production layout's four cached step builders with the data axes
over ranks, against the JAX package: the batch and the cache's rows split
over ``data`` (each rank on its rows), on top of the cache's sequence
split over ``model``, on the meshes (2, 2) and (4, 1) over ("data",
"model").

A module fixture spawns one gloo group of four ranks (the CPU, one
thread each; the rank code is ``tests/_torch_data_axis.py``) while this
process runs the reference's builders, jitted, under ``make_shard_ctx``
of a ``jax.sharding.Mesh`` of four host devices of the same shape (the
logits of each builder's ``forward`` call returned beside its outputs).
The weights are the reference's (``init_params(cfg, PRNGKey(1))`` at
f32); every step's inputs are drawn from a seed.  Each case runs a
contiguous prefill, three greedy decodes, a verify of γ + 1 = 4 and a
three-path tree verify on granite and moonshot (whose capacity dispatch
takes C from each data shard's rows) of 4 rows: on every rank its rows'
logits within 1e-5 of scale, its greedy tokens exact where the
reference's top-2 margin is above that, the cache gathered from every
rank with ``slot_pos`` exact and K/V within 1e-5 of scale."""
import pickle
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import _torch_data_axis as W
import test_torch_train_archs as TA
from repro.launch import steps as jsteps
from repro.launch.mesh import make_shard_ctx as jmake_shard_ctx
from repro.models import init_cache as jinit_cache
from repro_torch.launch.mesh import spawn
from repro_torch.models.transformer import n_attn_layers

TOL = TA.TOL


def _reference(key, step_inputs, monkeypatch):
    """The case through the reference's jitted builders on its mesh: per
    step the tokens, the logits and the cache (numpy)."""
    arch, shape, B, S, _ = W.CACHE_CASES[key]
    jcfg, _, jp, _ = TA.arch_model(arch)
    n = int(np.prod(shape))
    mesh = jax.sharding.Mesh(np.array(jax.devices()[:n]).reshape(shape),
                             W.DD)
    sctx = jmake_shard_ctx(mesh, train=False)
    box = {}
    real = jsteps.forward

    def recorder(*args, **kw):
        out = real(*args, **kw)
        box["logits"] = out[0]
        return out
    monkeypatch.setattr(jsteps, "forward", recorder)
    build = {"prefill": jsteps.build_prefill_step(jcfg, sctx),
             "serve": jsteps.build_serve_step(jcfg, sctx),
             "verify": jsteps.build_verify_step(jcfg, sctx),
             "tree": jsteps.build_tree_verify_step(jcfg, sctx)}
    fns = {kind: jax.jit(lambda *a, f=f: (f(*a), box["logits"]))
           for kind, f in build.items()}
    out = []
    try:
        with mesh:
            cache = jinit_cache(jcfg, B, S)
            for kind, args in step_inputs:
                got, logits = fns[kind](jp, *[jnp.asarray(a) for a in args],
                                        cache)
                if kind == "prefill":
                    cache, tokens = got, None
                else:
                    tokens, cache = got
                    tokens = np.asarray(tokens)
                out.append({"tokens": tokens, "logits": np.asarray(logits),
                            "cache": {k: np.asarray(v)
                                      for k, v in cache.items()}})
    finally:
        monkeypatch.undo()
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(reference results, [rank results])."""
    tmp = tmp_path_factory.mktemp("data_axis_cache")
    mp = pytest.MonkeyPatch()
    inp = {"cache": {}}
    for i, (key, (arch, _, B, _, T)) in enumerate(W.CACHE_CASES.items()):
        jcfg, _, _, np_params = TA.arch_model(arch)
        inp["cache"][key] = {"params": np_params,
                             "steps": W.cache_steps(jcfg, B, T, seed=i)}
    with open(tmp / "inputs.pkl", "wb") as f:
        pickle.dump(inp, f)
    errors = []

    def go():
        try:
            spawn(W.rank_main, W.WORLD, backend="gloo", device="cpu",
                  args=(str(tmp / "inputs.pkl"), str(tmp)))
        except Exception as e:          # re-raised below
            errors.append(e)
    thread = threading.Thread(target=go)
    thread.start()
    ref = {key: _reference(key, c["steps"], mp)
           for key, c in inp["cache"].items()}
    thread.join(timeout=900)
    assert not thread.is_alive(), "the ranks did not finish"
    if errors:
        raise errors[0]
    ranks = []
    for r in range(W.WORLD):
        with open(tmp / f"rank{r}.pkl", "rb") as f:
            ranks.append(pickle.load(f))
    return ref, ranks


@pytest.mark.parametrize("key", list(W.CACHE_CASES))
def test_cached_builders_over_data_match_reference(runs, key):
    """Every step on every rank: its rows' logits within 1e-5 of scale,
    its greedy tokens exact above the reference's top-2 margin, the
    cache gathered whole (``slot_pos`` exact, K/V within 1e-5 of
    scale)."""
    ref, ranks = runs
    want = ref[key]
    held = 0
    for r, rank in enumerate(ranks):
        got = rank["cache"][key]
        assert len(got) == len(want)
        for s, (g, w) in enumerate(zip(got, want)):
            what = f"rank {r} step {s}"
            lo, hi = g["rows"]
            wl = w["logits"][lo:hi]
            TA._close(g["logits"], wl, f"{what} logits")
            assert sorted(g["cache"]) == sorted(w["cache"])
            for name, wv in w["cache"].items():
                gv = g["cache"][name]
                assert gv.shape == wv.shape, (what, name)
                if name == "slot_pos":
                    np.testing.assert_array_equal(gv, wv, err_msg=what)
                else:
                    TA._close(gv, wv, f"{what} {name}")
            if w["tokens"] is None:
                continue
            lg = wl if w["tokens"].ndim == 2 else wl[:, -1]
            top = np.sort(lg.astype(np.float64), axis=-1)
            sure = top[..., -1] - top[..., -2] > TOL * max(
                float(np.abs(w["logits"]).max()), 1.0)
            np.testing.assert_array_equal(g["tokens"][sure],
                                          w["tokens"][lo:hi][sure],
                                          err_msg=what)
            held += int(sure.sum())
    assert held > 0


@pytest.mark.parametrize("key", list(W.CACHE_CASES))
def test_cached_rows_and_collectives(runs, key):
    """Each rank ran B / data rows (its place on the data axis), every
    rank the same collectives: a merge of the ranks' partials per
    attention layer and step where the cache's sequence is split over
    ``model``, none at (4, 1); each MoE layer's aux averaged over the
    data-parallel group once a step; nothing else over the data axes."""
    arch, shape, B, S, _ = W.CACHE_CASES[key]
    ranks = runs[1]
    data, model = shape
    for r, rank in enumerate(ranks):
        d = r // model
        n = B // data
        assert all(step["rows"] == (d * n, d * n + n)
                   for step in rank["cache"][key])
    traffic = [rank["traffic"][key] for rank in ranks]
    assert all(t == traffic[0] for t in traffic)
    t = traffic[0]
    cfg = W.port_cfg(arch)
    n_steps = 3 + W.DECODES
    assert t["merge_ranks"] == (n_attn_layers(cfg) * n_steps
                                if model > 1 else 0)
    moe_layers = cfg.num_layers - cfg.first_dense_layers \
        if cfg.num_experts else 0
    assert t["dp_all_reduce"] == moe_layers * n_steps
    for name in ("data_all_gather", "data_reduce_scatter", "dp_all_gather",
                 "pod_all_reduce"):
        assert t[name] == 0, name
