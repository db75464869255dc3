"""The production (Megatron) layout's KV cache across ranks on torch
ranks against the JAX package: the four cached step builders of
``launch/steps.py`` at tp = 2 and tp = 4, each rank on its pieces of the
weights and of the cache (``k`` / ``v`` / ``slot_pos`` split along the
sequence, K1 / K2's partials merged across the ranks).

A module fixture spawns one gloo group per tp (the CPU, one thread a
rank; the rank code is ``tests/_torch_production_cache.py``), both at
once, while this process runs the reference.  The weights are the
reference's (``init_params(cfg, PRNGKey(1))`` at f32); every step's
inputs are drawn from a seed, so no step's input depends on a model
output.  Each case runs a contiguous prefill, four greedy decodes, a
verify of γ + 1 = 4 and a three-path tree verify, on:

* granite (heads divide at tp = 2; attention whole at 4, its cache still
  split), moonshot (the capacity dispatch), zamba2 (the window as the
  cache: a whole-window prefill's ring roll through K3, steps that wrap
  the ring, Mamba2 blocks whole), llama-3.2-vision (cross blocks on the
  rank's heads of ``cross_k`` / ``cross_v``), whisper (3 heads:
  attention whole; the audio encoder on the rank's pieces) and mamba2
  (no K/V);
* granite with a prefill window [16, 28) that spans the ranks' pieces,
  with ``seq_shard_prefill=True`` (the residual split along the
  sequence where T divides), and with S = 31 (divides no group: the
  cache whole on every rank, no merge).

Held against the reference's one-device builders (``sctx=None``; for
MoE the reference's builders under a one-device production context,
``Mesh((1, 1))``, whose capacity dispatch drops tokens as the port's
does), on every rank: each step's logits (the builders' own ``forward``
calls) within 1e-5 of scale (the ranks' merge and row-parallel sums run
in other orders), the cache gathered by ``gather_cache`` after each
step — ``slot_pos`` exactly, K/V and the recurrent state within 1e-5 of
scale — and every greedy token exact where the reference's top-2 margin
is above that tolerance.  Every rank ran the same collectives."""
import pickle
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import _torch_production_cache as W
import test_torch_train_archs as TA
from repro.launch import steps as jsteps
from repro.launch.mesh import make_shard_ctx as jmake_shard_ctx
from repro.models import build_cross_cache as jbuild_cross_cache
from repro.models import init_cache as jinit_cache
from repro_torch.launch.mesh import spawn

TPS = (2, 4)
TOL = TA.TOL


class _Recorder:
    """The reference's ``forward`` as its builders call it, keeping the
    logits (the prefill builder drops them)."""

    def __init__(self, fn):
        self.fn, self.logits = fn, []

    def __call__(self, *args, **kw):
        out = self.fn(*args, **kw)
        self.logits.append(np.asarray(out[0]))
        return out


def _reference(key, jp, steps, aux, monkeypatch):
    """The case through the reference's builders: per step the tokens,
    the logits and the cache (numpy)."""
    arch, over, B, S, *_ = W.CASES[key]
    jcfg, *_ = TA.arch_model(arch, tuple(over.items()))
    cache = jinit_cache(jcfg, B, S)
    if aux is not None:
        cache["cross_k"], cache["cross_v"] = jbuild_cross_cache(
            jcfg, jp, jnp.asarray(aux))
    sctx, mesh = None, None
    if jcfg.num_experts:
        mesh = jax.sharding.Mesh(np.array(jax.devices()[:1]).reshape(1, 1),
                                 ("data", "model"))
        sctx = jmake_shard_ctx(mesh, train=False)
    rec = _Recorder(jsteps.forward)
    monkeypatch.setattr(jsteps, "forward", rec)
    build = {"prefill": jsteps.build_prefill_step(jcfg, sctx),
             "serve": jsteps.build_serve_step(jcfg, sctx),
             "verify": jsteps.build_verify_step(jcfg, sctx),
             "tree": jsteps.build_tree_verify_step(jcfg, sctx)}
    out = []
    try:
        if mesh is not None:
            mesh.__enter__()
        for kind, args in steps:
            got = build[kind](jp, *[jnp.asarray(a) for a in args], cache)
            if kind == "prefill":
                cache, tokens = got, None
            else:
                tokens, cache = got
                tokens = np.asarray(tokens)
            out.append({"tokens": tokens, "logits": rec.logits[-1],
                        "cache": {k: np.asarray(v)
                                  for k, v in cache.items()}})
    finally:
        if mesh is not None:
            mesh.__exit__(None, None, None)
        monkeypatch.undo()
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """{"ref": {case: steps}, tp: [rank results]}."""
    mp = pytest.MonkeyPatch()
    inp = {}
    for i, (key, (arch, over, B, S, T, start, _)) in enumerate(
            W.CASES.items()):
        jcfg, _, jp, np_params = TA.arch_model(arch, tuple(over.items()))
        steps, aux = W.case_steps(jcfg, B, S, T, start, seed=i)
        inp[key] = {"params": np_params, "steps": steps, "aux": aux,
                    "jp": jp}
    dirs, threads, errors = {}, [], []
    for tp in TPS:
        dirs[tp] = tmp_path_factory.mktemp(f"cache_tp{tp}")
        with open(dirs[tp] / "inputs.pkl", "wb") as f:
            pickle.dump({k: {n: v for n, v in c.items() if n != "jp"}
                         for k, c in inp.items()}, f)

        def go(tp=tp):
            try:
                spawn(W.rank_main, tp, backend="gloo", device="cpu",
                      args=(str(dirs[tp] / "inputs.pkl"), str(dirs[tp])))
            except Exception as e:          # re-raised below
                errors.append(e)
        threads.append(threading.Thread(target=go))
        threads[-1].start()
    out = {"ref": {key: _reference(key, c["jp"], c["steps"], c["aux"], mp)
                   for key, c in inp.items()}}
    for t in threads:
        t.join(timeout=900)
        assert not t.is_alive(), "the ranks did not finish"
    if errors:
        raise errors[0]
    for tp in TPS:
        out[tp] = []
        for r in range(tp):
            with open(dirs[tp] / f"rank{r}.pkl", "rb") as f:
                out[tp].append(pickle.load(f))
    return out


def _close(got, want, what):
    TA._close(got, want, what)


@pytest.mark.parametrize("key", list(W.CASES))
@pytest.mark.parametrize("tp", TPS)
def test_cached_builders_across_ranks_match_reference(runs, tp, key):
    """Every step on every rank: logits within 1e-5 of scale, the
    gathered cache (``slot_pos`` exact, K/V and recurrent state within
    1e-5 of scale), greedy tokens exact above the reference's top-2
    margin."""
    want = runs["ref"][key]
    held = 0
    for r, rank in enumerate(runs[tp]):
        got = rank["runs"][key]
        assert len(got) == len(want)
        for s, (g, w) in enumerate(zip(got, want)):
            what = f"tp={tp} rank {r} step {s}"
            _close(g["logits"], w["logits"], f"{what} logits")
            for name, wv in w["cache"].items():
                gv = g["cache"][name]
                assert gv.shape == wv.shape, (what, name)
                if name == "slot_pos":
                    np.testing.assert_array_equal(gv, wv, err_msg=what)
                else:
                    _close(gv, wv, f"{what} {name}")
            if w["tokens"] is None:
                continue
            lg = w["logits"] if w["tokens"].ndim == 2 else \
                w["logits"][:, -1]
            top = np.sort(lg.astype(np.float64), axis=-1)
            margin = top[..., -1] - top[..., -2]
            scale = max(float(np.abs(w["logits"]).max()), 1.0)
            sure = margin > TOL * scale
            np.testing.assert_array_equal(g["tokens"][sure],
                                          w["tokens"][sure], err_msg=what)
            held += int(sure.sum())
    assert held > 0


@pytest.mark.parametrize("tp", TPS)
def test_collectives_across_ranks(runs, tp):
    """Every rank ran the same collectives; a cache split along the
    sequence merges the ranks' partials once an attention layer a step
    (none for a cache whole on every rank, none without attention), and
    the step's q / K / V are gathered to every head where the heads
    split (granite at tp = 2)."""
    ranks = runs[tp]
    for key in W.CASES:
        traffic = [r["traffic"][key] for r in ranks]
        assert all(t == traffic[0] for t in traffic), key
        t = traffic[0]
        arch, over, *_ = W.CASES[key]
        cfg = W.port_cfg(arch, over)
        from repro_torch.models.transformer import n_attn_layers
        n_steps = 3 + W.DECODES
        n_attn = n_attn_layers(cfg)
        if key == "granite-odd" or not n_attn:
            assert t["merge_ranks"] == 0, key
        elif key == "zamba2":
            # the ring roll attends its own K/V: no merge in the prefill
            assert t["merge_ranks"] == n_attn * (n_steps - 1), key
        else:
            assert t["merge_ranks"] == n_attn * n_steps, key
        if key == "granite" and tp == 2:
            assert t["head_gather"] == n_attn * n_steps
        if key == "whisper":
            assert t["head_gather"] == 0
