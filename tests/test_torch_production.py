"""The production (Megatron) layout on torch ranks against the JAX
package: the cache-free forward, ``grpo_loss`` with every gradient,
``build_train_step`` and the MoE layer's capacity dispatch.

A module fixture spawns one gloo group of two ranks (the CPU, one thread
each; the rank code is ``tests/_torch_production.py``) while this
process runs the reference.  The weights are the reference's
(``init_params(cfg, PRNGKey(1))`` at f32), each rank holding its pieces
(``launch.steps.param_shards``); gradients and parameters come back
gathered.

* The cache-free forward's logits, ``grpo_loss``, its metrics and every
  gradient leaf at tp = 2, with the residual stream split along the
  sequence and without, on dense granite, MoE moonshot, the VLM (cross
  blocks), hybrid zamba2 and whisper (3 heads: its attention whole on
  every rank; the encoder's output entering each rank's cross
  columns), against the reference's one-device
  ``forward`` / ``grpo_loss`` / ``jax.grad`` at 1e-5 of each term's
  scale (a row-parallel sum is not bitwise).  The MoE model's oracle is
  the reference's jitted run under a one-device production context
  (``Mesh((1, 1))``): its capacity dispatch drops tokens on this batch,
  as the port's does at tp = 2 (the dispatch is the same at every tp),
  so ``sctx=None`` (every expert on every token) is not its oracle.
* ``build_train_step`` at tp = 2 for two AdamW steps against the
  reference's (``build_train_step(cfg, None)``; moonshot under the
  one-device production context, as above): losses, grad norms and the
  gathered parameters at 1e-5 of scale.
* ``moe_forward`` under the production context against the reference's
  on ``Mesh((1, 1))`` (this process, one rank), ``(1, 2)`` and
  ``(2, 2)``-shaped meshes (the ranks; the data axis's shards run one
  after another on the model group), with and without ``seq_shard``
  (reduce-scatter or all-reduce), expert-parallel and with the ``eff``
  fallback (3 experts on 2 ranks), and with ``capacity_factor`` lowered
  until tokens drop: outputs at 2e-5 of scale, aux at 1e-6, the routed
  experts, slot assignment and dropped (token, k) pairs exactly those of
  the reference's rule (``_moe_body``: rank in expert by the exclusive
  cumsum in flattened (token, k) order, dropped past C) on the
  reference's routing."""
import functools
import pickle
import threading
from dataclasses import replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_production as W
import test_torch_train_archs as TA
from repro.configs import get_tiny_config as jget_tiny
from repro.launch.mesh import make_shard_ctx as jmake_shard_ctx
from repro.launch.steps import build_train_step as jbuild_train_step
from repro.models import forward as jforward
from repro.models import init_params as jinit_params
from repro.models import moe as jmoe
from repro.sharding import ShardCtx as JShardCtx
from repro.training import grpo as jgrpo
from repro.training import optim as joptim
from repro_torch.bridge import params_from_jax, to_numpy
from repro_torch.launch.mesh import spawn
from repro_torch.models import moe as tmoe
from repro_torch.sharding import ShardCtx

TP = 2
# f32 on both sides, summed in other orders (row-parallel sums): 1e-5 of
# each term's scale; a MoE layer alone at 2e-5 of its output's scale
TOL = TA.TOL
MOE_TOL = 2e-5
AUX_TOL = 1e-6
# (arch, overrides, mesh (data, model), seq_shard) of the MoE cases
MOE_CASES = {
    "ep-1x1-seq": ("moonshot-v1-16b-a3b", {}, (1, 1), True),
    "ep-1x1": ("moonshot-v1-16b-a3b", {}, (1, 1), False),
    "ep-1x2-seq": ("moonshot-v1-16b-a3b", {}, (1, 2), True),
    "ep-1x2": ("moonshot-v1-16b-a3b", {}, (1, 2), False),
    "ep-2x2-seq": ("moonshot-v1-16b-a3b", {}, (2, 2), True),
    "ep-2x2": ("moonshot-v1-16b-a3b", {}, (2, 2), False),
    "eff-1x2-seq": ("moonshot-v1-16b-a3b", {"num_experts": 3}, (1, 2), True),
    "eff-1x2": ("moonshot-v1-16b-a3b", {"num_experts": 3}, (1, 2), False),
    "mixtral-1x2-seq": ("mixtral-8x7b", {}, (1, 2), True),
    "drops-1x1": ("moonshot-v1-16b-a3b", {"capacity_factor": 0.5}, (1, 1),
                  False),
    "drops-1x2-seq": ("moonshot-v1-16b-a3b", {"capacity_factor": 0.5},
                      (1, 2), True),
    "drops-2x2": ("moonshot-v1-16b-a3b", {"capacity_factor": 0.5}, (2, 2),
                  False),
    "drops-eff-1x2": ("moonshot-v1-16b-a3b",
                      {"num_experts": 3, "capacity_factor": 0.5}, (1, 2),
                      False),
}
MOE_B, MOE_S = 4, 8


@functools.lru_cache(maxsize=None)
def _moe_params_cached(arch, over):
    cfg = replace(jget_tiny(arch), dtype="float32", **dict(over))
    params, _ = jinit_params(cfg, jax.random.PRNGKey(1))
    return cfg, params


def _moe_params(arch, over):
    return _moe_params_cached(arch, tuple(sorted(over.items())))


def _moe_inputs():
    out = {}
    for i, (name, (arch, over, mesh, seq)) in enumerate(MOE_CASES.items()):
        cfg, params = _moe_params(arch, over)
        x = np.random.default_rng(10 + i).normal(
            size=(MOE_B, MOE_S, cfg.d_model)).astype(np.float32)
        out[name] = {"arch": arch, "overrides": over, "layer": 0,
                     "params": jax.tree.map(np.asarray, params), "x": x,
                     "seq_shard": seq, "data": mesh[0]}
    return out


def _reference_moe(case, mesh_shape):
    """The reference's ``moe_forward`` on a (data, model) mesh, its routed
    ids on each data shard, and the slots its rule gives them."""
    cfg, params = _moe_params(case["arch"], case["overrides"])
    block = jax.tree.map(lambda a: a[0], params["layers"]["moe"])
    mesh = jax.make_mesh(mesh_shape, ("data", "model"))
    sctx = JShardCtx(mesh=mesh, dp=("data",), seq_shard=case["seq_shard"])
    y, aux = jax.jit(lambda x, p: jmoe.moe_forward(x, p, cfg, sctx))(
        jnp.asarray(case["x"]), block)
    route = jax.jit(lambda x, r: jmoe._route(x, r, cfg.moe_top_k)[1])
    ids = [np.asarray(route(jnp.asarray(xb.reshape(-1, cfg.d_model)),
                            block["router"]))
           for xb in np.split(case["x"], mesh_shape[0])]
    C = jmoe._capacity(MOE_B // mesh_shape[0] * MOE_S, cfg.moe_top_k,
                       cfg.num_experts, cfg.capacity_factor)
    return {"y": np.asarray(y), "aux": float(aux), "ids": ids, "C": C,
            "cfg": cfg}


def _rule(ids, E, C):
    """The reference's slot rule on one data shard's ids (T, k), all
    experts on one rank: (slot, valid), flattened (token, k) order."""
    e = ids.reshape(-1)
    onehot = (e[:, None] == np.arange(E)[None]).astype(np.int64)
    pos = np.take_along_axis(np.cumsum(onehot, 0) - onehot, e[:, None],
                             1)[:, 0]
    valid = pos < C
    return np.where(valid, e * C + pos, E * C), valid


def _port_moe_one_rank(case):
    """The port's layer on one rank (the (1, 1) mesh), in this process."""
    cfg = W.port_cfg(case["arch"], case["overrides"])
    block = params_from_jax(cfg, case["params"], device="cpu")[
        "layers"][0]["moe"]
    sctx = ShardCtx(tp_size=1, dp=("data",), seq_shard=case["seq_shard"],
                    axis_sizes=(("data", case["data"]),))
    tmoe.DISPATCH_LOG = []
    with torch.no_grad():
        y, aux = tmoe.moe_forward(torch.from_numpy(case["x"]), block, cfg,
                                  sctx)
    recs = [{k: (to_numpy(v) if isinstance(v, torch.Tensor) else v)
             for k, v in r.items()} for r in tmoe.DISPATCH_LOG]
    tmoe.DISPATCH_LOG = None
    return [{"y": to_numpy(y), "aux": float(aux), "records": recs}]


def _production_oracle(arch):
    """The reference's jitted ``grpo_loss`` value and gradient under a
    one-device production context (the capacity dispatch)."""
    jcfg, _, jp, _ = TA.arch_model(arch)
    batch = TA._batch(jcfg, 2)
    mesh = jax.sharding.Mesh(np.array(jax.devices()[:1]).reshape(1, 1),
                             ("data", "model"))
    sctx = jmake_shard_ctx(mesh, train=True)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    with mesh:
        (loss, met), grads = jax.jit(jax.value_and_grad(
            lambda p: jgrpo.grpo_loss(jcfg, p, jb, sctx=sctx),
            has_aux=True))(jp)
        logits = jax.jit(lambda p: jforward(
            jcfg, p, jb["tokens"], jnp.broadcast_to(
                jnp.arange(batch["tokens"].shape[1]), batch["tokens"].shape),
            sctx=sctx, train=True)[0])(jp)
    return loss, met, grads, logits, sctx, mesh


def _reference_model(key):
    arch, _ = W.MODEL_ARCHS[key]
    jcfg, _, jp, _ = TA.arch_model(arch)
    if jcfg.num_experts:
        loss, met, grads, logits, _, _ = _production_oracle(arch)
    else:
        loss, met, grads, batch = TA.jax_loss_and_grads(arch)
        B, S = batch["tokens"].shape
        aux = {k: jnp.asarray(v) for k, v in batch.items()
               if k in ("image_embeds", "audio_frames")} or None
        logits = jforward(jcfg, jp, jnp.asarray(batch["tokens"]),
                          jnp.broadcast_to(jnp.arange(S), (B, S)),
                          aux_inputs=aux, train=True)[0]
    return {"loss": float(loss), "metrics": {k: float(v)
                                             for k, v in met.items()},
            "grads": grads, "logits": np.asarray(logits)}


def _reference_train(key):
    arch, _ = W.MODEL_ARCHS[key]
    jcfg, _, jp, _ = TA.arch_model(arch)
    batches = [{k: jnp.asarray(v) for k, v in TA._batch(jcfg, s).items()}
               for s in (2, 3)]
    state = joptim.init_opt_state(jp)
    losses = []
    if jcfg.num_experts:
        *_, sctx, mesh = _production_oracle(arch)
        step = jax.jit(jbuild_train_step(jcfg, sctx))
        with mesh:
            for b in batches:
                jp, state, loss = step(jp, state, b)
                losses.append(float(loss))
    else:
        step = jbuild_train_step(jcfg, None)
        for b in batches:
            jp, state, loss = step(jp, state, b)
            losses.append(float(loss))
    return {"losses": losses, "params": jp}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(reference results, [rank results], port one-rank MoE runs)."""
    tmp = tmp_path_factory.mktemp("production")
    inp = {"params": {}, "batches": {}, "train_batches": {}}
    for key, (arch, _) in W.MODEL_ARCHS.items():
        jcfg, _, _, np_params = TA.arch_model(arch)
        inp["params"][key] = np_params
        inp["batches"][key] = TA._batch(jcfg, 2)
        inp["train_batches"][key] = [TA._batch(jcfg, s) for s in (2, 3)]
    moe_inp = _moe_inputs()
    inp["moe"] = {n: c for n, c in moe_inp.items()
                  if MOE_CASES[n][2][1] == TP}
    with open(tmp / "inputs.pkl", "wb") as f:
        pickle.dump(inp, f)
    errors = []

    def go():
        try:
            spawn(W.rank_main, TP, backend="gloo", device="cpu",
                  args=(str(tmp / "inputs.pkl"), str(tmp)))
        except Exception as e:          # re-raised below
            errors.append(e)
    thread = threading.Thread(target=go)
    thread.start()
    ref = {"models": {k: _reference_model(k) for k in W.MODEL_ARCHS},
           "train": {k: _reference_train(k) for k in W.TRAIN_STEP_ARCHS},
           "moe": {n: _reference_moe(c, MOE_CASES[n][2])
                   for n, c in moe_inp.items()}}
    one = {n: _port_moe_one_rank(c) for n, c in moe_inp.items()
           if MOE_CASES[n][2][1] == 1}
    thread.join(timeout=900)
    assert not thread.is_alive(), "the ranks did not finish"
    if errors:
        raise errors[0]
    ranks = []
    for r in range(TP):
        with open(tmp / f"rank{r}.pkl", "rb") as f:
            ranks.append(pickle.load(f))
    return ref, ranks, one


@pytest.mark.parametrize("sp", [True, False], ids=["seq-shard", "no-seq"])
@pytest.mark.parametrize("key", list(W.MODEL_ARCHS))
def test_forward_loss_and_gradients_tp2(runs, key, sp):
    """Logits, ``grpo_loss``, its metrics and every gradient leaf at
    tp = 2 against the reference's one-device run, on both ranks."""
    ref, ranks, _ = runs
    want = ref["models"][key]
    for rank in ranks:
        got = rank["models"][key, sp]
        TA._close(got["logits"], want["logits"], "logits")
        TA._close(got["loss"], want["loss"], "loss")
        assert sorted(got["metrics"]) == sorted(want["metrics"])
        for name, v in want["metrics"].items():
            TA._close(got["metrics"][name], v, name)
        TA.assert_tree_close(got["grads"], want["grads"], what="grad")
        assert got["loss"] == ranks[0]["models"][key, sp]["loss"]
    if key == "moonshot":
        # the capacity dispatch dropped tokens here (the reason the
        # oracle is the reference's production run, not sctx=None)
        assert sum(r["models"][key, sp]["drops"] for r in ranks) > 0


@pytest.mark.parametrize("sp", [True, False], ids=["seq-shard", "no-seq"])
def test_collectives_by_layout(runs, sp):
    """The split residual stream moves its sums as reduce-scatters, the
    whole one as all-reduces; every rank ran the same collectives."""
    _, ranks, _ = runs
    for key in W.MODEL_ARCHS:
        traffic = [r["traffic"][key, sp] for r in ranks]
        assert traffic[0] == traffic[1]
        t = traffic[0]
        assert t["all_gather"] > 0
        if sp:
            assert t["reduce_scatter"] > 0 and t["reduce_scatter_bytes"] > 0
        else:
            assert t["reduce_scatter"] == 0 and t["all_reduce"] > 0


@pytest.mark.parametrize("key", W.TRAIN_STEP_ARCHS)
def test_train_step_tp2_matches_reference(runs, key):
    """Two ``build_train_step`` steps at tp = 2 (sequence-sharded): the
    reference's losses, and its parameters after them, gathered."""
    ref, ranks, _ = runs
    want = ref["train"][key]
    for rank in ranks:
        got = rank["train"][key]
        for a, b in zip(got["losses"], want["losses"]):
            TA._close(a, b, "loss")
        assert got["grad_norms"][0] > 0
        TA.assert_tree_close(got["params"], want["params"], what="params")


def _moe_results(runs, name):
    ref, ranks, one = runs
    mesh = MOE_CASES[name][2]
    got = one[name] if mesh[1] == 1 else [r["moe"][name] for r in ranks]
    return ref["moe"][name], got, mesh


@pytest.mark.parametrize("name", list(MOE_CASES))
def test_moe_capacity_output_matches_reference(runs, name):
    """Each rank's output (its sequence piece when the sum is
    reduce-scattered) and the averaged aux loss."""
    want, got, (data, model) = _moe_results(runs, name)
    y = want["y"]
    scale = max(float(np.abs(y).max()), 1.0)
    for r, g in enumerate(got):
        part = y
        if MOE_CASES[name][3] and model > 1:
            n = MOE_S // model
            part = y[:, r * n:(r + 1) * n]
        np.testing.assert_allclose(g["y"], part, rtol=MOE_TOL,
                                   atol=MOE_TOL * scale)
        np.testing.assert_allclose(g["aux"], want["aux"], rtol=0,
                                   atol=AUX_TOL)


@pytest.mark.parametrize("name", list(MOE_CASES))
def test_moe_dispatch_slots_and_drops_exact(runs, name):
    """The routed experts, every kept pair's slot and the set of dropped
    (token, k) pairs, over every rank and data shard, are exactly the
    reference's rule on the reference's routing; the drop cases drop."""
    want, got, (data, model) = _moe_results(runs, name)
    cfg = want["cfg"]
    E, C = cfg.num_experts, want["C"]
    for shard in range(data):
        ids = want["ids"][shard]
        slot, valid = _rule(ids, E, C)
        dropped = set(np.flatnonzero(~valid))
        seen_drops, kept = set(), 0
        for g in got:
            rec = g["records"][shard]
            assert rec["C"] == C
            np.testing.assert_array_equal(rec["ids"], ids)
            e0, E_loc = rec["e0"], rec["E_loc"]
            local = rec["local"]
            np.testing.assert_array_equal(
                local, (ids.reshape(-1) >= e0) & (ids.reshape(-1) < e0
                                                  + E_loc))
            mine = local & rec["valid"]
            np.testing.assert_array_equal(
                rec["slot"][mine], slot[mine] - e0 * C)
            np.testing.assert_array_equal(rec["valid"], local & valid)
            seen_drops |= set(np.flatnonzero(local & ~rec["valid"]))
            kept += int(mine.sum())
        assert seen_drops == dropped
        if E_loc == E:
            kept //= len(got)
        assert kept == int(valid.sum())
        if name.startswith("drops"):
            assert dropped
