"""The port's MoE layer and MoE models against the JAX package on the
CPU, on the three MoE tiny configs (moonshot-v1-16b-a3b and
deepseek-moe-16b: a first dense layer and a shared expert; mixtral-8x7b:
no shared expert, a 64-slot ring cache for its window), with the
reference's weights (``init_params(cfg, PRNGKey(1))``) carried over by
the bridge: the router, load-balance loss and all-expert layer on the
same inputs (f32 at 1e-5 with equal expert ids, bf16 at 3e-2), top-k
ties, the init scales of every MoE leaf, ``forward``'s logits, caches and
aux over prefill, decode and verify steps at f32, and at bf16 every
layer of the forward on the port's own hidden state; plus the dense
yi-6b and phi4-mini-3.8b tiny configs (G = 4 and G = 3 at head dim
32).

Each tolerance (1e-5 at f32, 3e-2 at bf16) is taken of the compared
tensor's own scale as well as of each element (``close``'s
``of_scale``): at the reference's init scales an MoE layer's outputs
reach ~100 and nearly cancel in places, so rounding at the terms' scale
(1e-7 in f32, an ulp of 0.25-0.5 in bf16) is far above an element's own
tolerance there."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as jcfgs
import repro_torch.configs as tcfgs
from _torch_rec import (MODEL_TOL, close, forward_layers_match_bf16,
                        forward_steps, model_pair)
from repro.models import forward as jforward
from repro.models import init_cache as jinit_cache
from repro.models import moe as jmoe
from repro_torch.bridge import cache_from_jax, cache_to_numpy, to_numpy
from repro_torch.models import forward, init_cache, init_params
from repro_torch.models import moe as tmoe

torch.set_num_threads(2)
MOE = ["moonshot-v1-16b-a3b", "deepseek-moe-16b", "mixtral-8x7b"]
DENSE = ["yi-6b", "phi4-mini-3.8b"]
TOL = MODEL_TOL


@pytest.fixture(scope="module")
def models():
    cache = {}

    def get(arch, dtype):
        if (arch, dtype) not in cache:
            cache[arch, dtype] = model_pair(arch, dtype)
        return cache[arch, dtype]
    return get


def _jlayer(tree, i):
    return jax.tree.map(lambda a: a[i], tree)


# ------------------------------------------------------------ the layer ----


@pytest.mark.parametrize("dtype", sorted(TOL))
@pytest.mark.parametrize("arch", MOE)
def test_moe_layer_matches_jax(models, arch, dtype):
    """``_route``, ``_aux_loss`` and ``moe_dense_all`` on the same
    inputs (unit normals, the scale of the normed hidden state the layer
    takes): the same expert ids, weights, probabilities and loss, and the
    output within 1e-5 (f32) or 3e-2 (bf16) (``close``, of the scale)."""
    m = models(arch, dtype)
    jcfg, jp, tcfg, tp = m.jcfg, m.jp, m.tcfg, m.tp
    jdt, tdt = jnp.dtype(dtype), getattr(torch, dtype)
    tol = TOL[dtype]
    rng = np.random.default_rng(0)
    x = rng.normal(size=(3, 7, tcfg.d_model)).astype(np.float32)
    jl, tl = _jlayer(jp["layers"]["moe"], 0), tp["layers"][0]["moe"]
    assert tl["router"].dtype == torch.float32
    assert tl["wg"].dtype == tdt and tl["wd"].dtype == tdt
    xj, xt = jnp.asarray(x, jdt), torch.from_numpy(x).to(tdt)
    xf = xj.reshape(-1, tcfg.d_model).astype(jnp.float32)
    w, ids, probs = jmoe._route(xf, jl["router"], jcfg.moe_top_k)
    tw, tids, tprobs = tmoe._route(xt.reshape(-1, tcfg.d_model).float(),
                                   tl["router"], tcfg.moe_top_k)
    np.testing.assert_array_equal(to_numpy(tids), np.asarray(ids))
    np.testing.assert_allclose(to_numpy(tw), np.asarray(w), atol=1e-6,
                               rtol=1e-6)
    np.testing.assert_allclose(to_numpy(tprobs), np.asarray(probs),
                               atol=1e-6, rtol=1e-6)
    aux = jmoe._aux_loss(probs, ids, jcfg.num_experts)
    taux = tmoe._aux_loss(tprobs, tmoe._one_hot(tids, tcfg.num_experts))
    assert abs(float(taux) - float(aux)) <= 1e-6 * abs(float(aux))
    y, ya = jax.jit(lambda x, p: jmoe.moe_dense_all(x, p, jcfg))(xj, jl)
    ty, tya = tmoe.moe_forward(xt, tl, tcfg)
    assert ty.dtype == tdt and ty.shape == xt.shape
    assert tya.dtype == torch.float32
    close(to_numpy(ty), y, tol, of_scale=True)
    assert abs(float(tya) - float(ya)) <= tol * abs(float(ya))
    assert ("sg" in tl) == bool(tcfg.num_shared_experts)


@pytest.mark.parametrize("tie", ["all", "pair"])
def test_route_ties_pick_the_lower_expert(tie):
    """Equal probabilities: the lower expert first, as ``lax.top_k``."""
    rng = np.random.default_rng(1)
    d, E, k = 16, 6, 3
    router = rng.normal(size=(d, E)).astype(np.float32)
    if tie == "all":
        router[:] = 0.0
    else:
        router[:, 4] = router[:, 1]
        router[:, 5] = router[:, 2]
    x = rng.normal(size=(5, d)).astype(np.float32)
    _, ids, _ = jmoe._route(jnp.asarray(x), jnp.asarray(router), k)
    _, tids, _ = tmoe._route(torch.from_numpy(x), torch.from_numpy(router),
                             k)
    np.testing.assert_array_equal(to_numpy(tids), np.asarray(ids))
    if tie == "all":
        assert (to_numpy(tids) == np.arange(k)).all()


def test_tensor_parallel_and_training_refused(models):
    """The production layout's capacity dispatch (a context that is not
    the engine's exact one) runs now, on one rank too, where it keeps
    every token at the default capacity and equals the dense combine
    (tests/test_torch_production.py holds it to the reference's on 1, 2
    and 2 x 2 ranks), and a cached MoE forward under that context across
    ranks runs too (tests/test_torch_production_cache.py).  A data axis
    over ranks is not refused either: with a data-parallel group the
    layer takes its rows as the rank's data shard, one dispatch with C
    from them and the aux loss averaged over the group, where a context
    with the data axis and no group runs the shards one after another
    (tests/test_torch_data_axis.py holds both to the reference's meshes).
    Training is not refused
    either: the cache-free forward gives logits and the router's aux
    loss, and ``RLTrainer`` takes the model
    (tests/test_torch_train_archs.py and test_torch_train_loop.py hold
    both to the reference)."""
    from repro_torch.sharding import ShardCtx
    m = models("moonshot-v1-16b-a3b", "float32")
    tcfg, tp = m.tcfg, m.tp
    x = torch.from_numpy(np.random.default_rng(0).normal(
        size=(1, 2, tcfg.d_model)).astype(np.float32))
    block = tp["layers"][0]["moe"]
    y, aux = tmoe.moe_forward(x, block, tcfg,
                              sctx=ShardCtx(tp_size=1, exact=False))
    dense_y, dense_aux = tmoe.moe_dense_all(x, block, tcfg)
    np.testing.assert_allclose(to_numpy(y), to_numpy(dense_y), rtol=1e-5,
                               atol=1e-5)
    assert float(aux) == float(dense_aux)
    from repro_torch import sharding
    x2 = torch.cat([x, x.flip(1)])
    summed = []
    orig = sharding.dp_sum
    sharding.dp_sum = lambda t, ctx: summed.append(float(t)) or t * 2
    try:
        runs = {}
        for name, group in (("loop", None), ("ranks", object())):
            tmoe.DISPATCH_LOG = []
            ctx = ShardCtx(tp_size=1, exact=False, dp=("data",),
                           axis_sizes=(("data", 2),), dp_group=group)
            with torch.no_grad():
                runs[name] = tmoe.moe_forward(x2, block, tcfg, sctx=ctx)
            runs[name] += ([r["C"] for r in tmoe.DISPATCH_LOG],)
    finally:
        sharding.dp_sum = orig
        tmoe.DISPATCH_LOG = None
    C = tmoe._capacity
    k, E, cf = tcfg.moe_top_k, tcfg.num_experts, tcfg.capacity_factor
    assert runs["loop"][2] == [C(2, k, E, cf)] * 2
    assert runs["ranks"][2] == [C(4, k, E, cf)]
    assert len(summed) == 1
    assert float(runs["ranks"][1]) == summed[0]
    pos = torch.arange(2, dtype=torch.int32)[None]
    logits, cache, aux = forward(tcfg, tp, pos, pos, None)
    assert cache is None and logits.shape == (1, 2, tcfg.vocab_size)
    assert float(aux) > 0
    from repro_torch.data.tasks import make_task
    from repro_torch.training.loop import RLConfig, RLTrainer
    task = make_task("copy", tcfg.vocab_size, prompt_len=4, response_len=4)
    tr = RLTrainer(tcfg, task, RLConfig(device="cpu"), params=tp)
    assert tr.params["layers"][0]["moe"]["router"].requires_grad


# ------------------------------------------------------------- the init ----


@pytest.mark.parametrize("arch", MOE)
def test_init_scales_match_the_reference(models, arch):
    """The port's seeded init has the bridged reference's tree, shapes,
    dtypes and scales, leaf for leaf; ``wg``/``wu`` at the reference's
    1/sqrt(E) (``Builder.param``'s 1/sqrt(shape[0]) of (E, d, eff)), the
    router in f32."""
    m = models(arch, "bfloat16")
    jp, tcfg, ref = m.jp, m.tcfg, m.tp
    a = init_params(tcfg, torch.Generator().manual_seed(3), device="cpu")
    b = init_params(tcfg, torch.Generator().manual_seed(3), device="cpu")

    def leaves(tree, path=()):
        if isinstance(tree, dict):
            for k, v in tree.items():
                yield from leaves(v, path + (k,))
        elif isinstance(tree, list):
            for i, v in enumerate(tree):
                yield from leaves(v, path + (i,))
        else:
            yield path, tree

    got, want, again = (dict(leaves(t)) for t in (a, ref, b))
    assert sorted(got, key=str) == sorted(want, key=str)
    nd = tcfg.first_dense_layers
    assert len(a.get("dense_layers", [])) == nd
    assert len(a["layers"]) == tcfg.num_layers - nd
    for key, t in got.items():
        r = want[key]
        assert t.shape == r.shape and t.dtype == r.dtype, key
        assert torch.equal(t, again[key]), key
        ts, rs = t.float().std().item(), r.float().std().item()
        assert abs(ts - rs) <= 0.15 * rs + 1e-6, (key, ts, rs)
    E = tcfg.num_experts
    moe = a["layers"][0]["moe"]
    assert moe["router"].dtype == torch.float32
    assert moe["wg"].shape == (tcfg.d_model, E * tcfg.moe_d_ff)
    for name in ("wg", "wu"):
        assert abs(moe[name].float().std().item() - E ** -0.5) <= \
            0.05 * E ** -0.5, name
        ref_std = float(np.std(np.asarray(jp["layers"]["moe"][name])))
        assert abs(ref_std - E ** -0.5) <= 0.05 * E ** -0.5, name


# ----------------------------------------------------------- forward ----


@pytest.mark.parametrize("arch", MOE)
def test_forward_matches_jax_f32(models, arch):
    """Logits, every cache leaf and the summed aux loss of ``forward``
    within 1e-5 of the reference's, step after step on one cache (the
    ring wraps on mixtral's 64-slot window)."""
    m = models(arch, "float32")
    jcfg, jp, tcfg, tp = m.jcfg, m.jp, m.tcfg, m.tp
    B, S = 3, 96
    jc = jinit_cache(jcfg, B, S)
    tc = cache_from_jax(tcfg, jax.tree.map(np.asarray, jc), device="cpu")
    assert tc["slot_pos"].shape[1] == (64 if tcfg.sliding_window else S)
    for tok, pos, mask in forward_steps(tcfg.vocab_size, long=True, seed=2):
        lj, jc, aj = jforward(jcfg, jp, jnp.asarray(tok), jnp.asarray(pos),
                              jc, token_mask=jnp.asarray(mask))
        lt, tc2, at = forward(tcfg, tp, torch.from_numpy(tok),
                              torch.from_numpy(pos), tc,
                              token_mask=torch.from_numpy(mask))
        assert tc2 is tc
        close(to_numpy(lt)[mask], np.asarray(lj)[mask], 1e-5,
              of_scale=True)
        got = cache_to_numpy(tc)
        np.testing.assert_array_equal(got["slot_pos"],
                                      np.asarray(jc["slot_pos"]))
        for k in ("k", "v"):
            close(got[k], jc[k], 1e-5, err_msg=k, of_scale=True)
        assert at.dtype == torch.float32
        assert abs(float(at) - float(aj)) <= 1e-5 * abs(float(aj))
    if tcfg.sliding_window:
        assert pos.max() >= 64


@pytest.mark.parametrize("arch", MOE)
def test_forward_layers_match_jax_bf16(models, arch):
    """bf16, layer by layer: each dense and MoE layer of the reference
    (``_dense_layer``, ``_moe_layer``) runs on the port's own hidden state
    and cache in front of that layer, and the port's layer must give the
    same output, K/V and aux within 3e-2; so must the final norm and
    unembed.  (The whole-model comparison cannot hold 3e-2 in bf16: the
    reference's own bf16 forward differs from its f32 forward by more
    than that, the large MoE outputs carrying one-ulp differences of the
    attention into the logits, and a near-tied router flips an expert;
    so does the reference's own jitted layer against its eager one.  The
    reference runs eagerly here, as its ``forward`` does when called.)"""
    m = models(arch, "bfloat16")
    nd = m.tcfg.first_dense_layers
    layers = [(f"layer {i} (dense)", "dense", _jlayer(m.jp["dense_layers"], i),
               m.tp["dense_layers"][i], i) for i in range(nd)]
    layers += [(f"layer {nd + j} (moe)", "moe", _jlayer(m.jp["layers"], j),
                m.tp["layers"][j], nd + j)
               for j in range(m.tcfg.num_layers - nd)]
    forward_layers_match_bf16(m, layers, S=96, long=True, seed=2,
                              of_scale=True)


# --------------------------------------------------- dense: yi, phi4 ----


@pytest.mark.parametrize("dtype", sorted(TOL))
@pytest.mark.parametrize("arch", DENSE)
def test_dense_configs_forward_matches_jax(models, arch, dtype):
    """yi-6b tiny (4/1 heads of 32: G = 4) and phi4-mini-3.8b tiny (3/1
    heads of 32: G = 3, tied embeddings): logits and caches of prefill,
    decode and verify steps within 1e-5 (f32) and 3e-2 (bf16)."""
    m = models(arch, dtype)
    jcfg, jp, tcfg, tp = m.jcfg, m.jp, m.tcfg, m.tp
    assert tcfg.num_heads // tcfg.num_kv_heads == \
        {"yi-6b": 4, "phi4-mini-3.8b": 3}[arch]
    tol = TOL[dtype]
    B, S = 3, 32
    jc = jinit_cache(jcfg, B, S)
    tc = init_cache(tcfg, B, S, device="cpu")
    for tok, pos, mask in forward_steps(tcfg.vocab_size, seed=2):
        lj, jc, _ = jforward(jcfg, jp, jnp.asarray(tok), jnp.asarray(pos),
                             jc, token_mask=jnp.asarray(mask))
        lt, _, aux = forward(tcfg, tp, torch.from_numpy(tok),
                             torch.from_numpy(pos), tc,
                             token_mask=torch.from_numpy(mask))
        assert aux == 0.0
        close(to_numpy(lt)[mask], np.asarray(lj, np.float32)[mask], tol,
              of_scale=True)
        got = cache_to_numpy(tc)
        np.testing.assert_array_equal(got["slot_pos"],
                                      np.asarray(jc["slot_pos"]))
        for k in ("k", "v"):
            close(got[k], jc[k], tol, err_msg=k, of_scale=True)


def test_full_configs_count_the_reference_params():
    """The full configs' analytic parameter counts (moonshot: the card's
    slice) equal the reference's."""
    for arch in MOE + DENSE:
        t, j = tcfgs.get_config(arch), jcfgs.get_config(arch)
        assert (t.num_params(), t.active_params()) == \
            (j.num_params(), j.active_params())


@pytest.mark.parametrize("tp", [1, 2])
@pytest.mark.parametrize("arch", MOE + DENSE)
def test_cost_model_matches_the_reference(arch, tp):
    """``core/sdmodel.py`` prices the new configs as the reference does:
    parameter and K/V bytes, FLOPs, the MoE all-to-all and the step,
    prefill and tree-verify times the rollout and scheduler read."""
    from repro.core.sdmodel import TPU_V5E as JHW
    from repro.core.sdmodel import ForwardCostModel as JCost
    from repro_torch.core.sdmodel import TPU_V5E, ForwardCostModel
    j = JCost(jcfgs.get_config(arch), JHW, tp=tp)
    t = ForwardCostModel(tcfgs.get_config(arch), TPU_V5E, tp=tp)
    assert (t.param_bytes(), t.active_param_bytes(), t.kv_bytes_per_token(),
            t.flops_per_token(), t.collective_bytes(96)) == \
        (j.param_bytes(), j.active_param_bytes(), j.kv_bytes_per_token(),
         j.flops_per_token(), j.collective_bytes(96))
    for B, T, ctx in ((8, 1, 300.0), (8, 9, 450.0), (1, 64, 0.0)):
        assert t.step_time(B, T, ctx) == j.step_time(B, T, ctx)
        assert t.tree_verify_time(B, T, ctx) == j.tree_verify_time(B, T, ctx)
    assert t.prefill_time(384) == j.prefill_time(384)
