"""The production (Megatron) layout with its data axes over ranks,
against the JAX package: ``build_train_step`` with FSDP of the ``embed``
axis over ``data`` and the batch split over ``pod`` and ``data``, on the
meshes (2, 2) and (4, 1) over ("data", "model") and (2, 2, 1) over
("pod", "data", "model").

A module fixture spawns one gloo group of four ranks (the CPU, one
thread each; the rank code is ``tests/_torch_data_axis.py``), which lays
out every case's mesh in turn, while this process runs the reference's
jitted ``build_train_step`` under ``make_shard_ctx`` of a
``jax.sharding.Mesh`` of four host devices of the same shape
(``jax.make_mesh`` gives Explicit axes, under which the reference's
``with_sharding_constraint`` raises).  The weights are the reference's
(``init_params(cfg, PRNGKey(1))`` at f32), each rank holding its pieces.

* Two AdamW steps on granite tiny on all three meshes and on a batch of
  6 rows, which divides no data size (the reference's guard replicates
  it: every rank computes the whole batch, nothing is summed); moonshot
  tiny at (2, 2) and (4, 1) is ``tests/test_torch_data_axis_moe.py``'s,
  with this file's checks (the two files run on two workers): losses,
  ``grad_norm``,
  ``pg_loss``, ``mean_ratio``, ``clip_frac``, ``mean_adv``, ``aux`` and
  the parameters gathered after each step at 1e-5 of scale (sums in
  other orders); every dispatch's slots and drops exactly the
  reference's rule on the rank's data shard.
* Placement: each rank's mesh coordinates are the reference mesh's
  (``Mesh.devices``), its pieces of every leaf the reference's
  ``param_shardings`` indices of its device, and the collectives of a
  step by axis as derived from the config."""
import pickle
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import _torch_data_axis as W
import test_torch_train_archs as TA
from repro.launch.mesh import make_shard_ctx as jmake_shard_ctx
from repro.launch.steps import build_train_step as jbuild_train_step
from repro.launch.steps import param_shardings as jparam_shardings
from repro.models import moe as jmoe
from repro.training import grpo as jgrpo
from repro.training import optim as joptim
from repro_torch.bridge import params_from_jax, to_numpy
from repro_torch.launch import mesh as tmesh
from repro_torch.launch import steps as tsteps
from repro_torch.launch.mesh import spawn
from repro_torch.sharding import ShardCtx

TOL = TA.TOL
MESHES = [((2, 2), W.DD), ((4, 1), W.DD), ((2, 2, 1), W.PDM)]
METRICS = ("grad_norm", "pg_loss", "mean_ratio", "clip_frac", "mean_adv",
           "aux_loss")


def _jmesh(shape, axes):
    n = int(np.prod(shape))
    return jax.sharding.Mesh(np.array(jax.devices()[:n]).reshape(shape),
                             axes)


def _batches(key):
    arch, _, _, B = W.TRAIN_CASES[key]
    jcfg, *_ = TA.arch_model(arch)
    return [W.make_batch(jcfg, B, s) for s in (2, 3)]


def _reference_train(key):
    """The reference's jitted ``build_train_step`` on the case's mesh for
    two steps: losses, parameters after each, and each step's metrics and
    gradient norm from its jitted ``grpo_loss`` gradient at the step's
    parameters."""
    arch, shape, axes, _ = W.TRAIN_CASES[key]
    jcfg, _, jp, _ = TA.arch_model(arch)
    mesh = _jmesh(shape, axes)
    sctx = jmake_shard_ctx(mesh, train=True)
    step = jax.jit(jbuild_train_step(jcfg, sctx))

    def loss_metrics(p, b):
        (loss, met), grads = jax.value_and_grad(
            lambda q: jgrpo.grpo_loss(jcfg, q, b, sctx=sctx),
            has_aux=True)(p)
        return dict(met, grad_norm=joptim.global_norm(grads))
    metrics_fn = jax.jit(loss_metrics)
    state = joptim.init_opt_state(jp)
    out = {"losses": [], "metrics": [], "params": []}
    with mesh:
        for b in _batches(key):
            jb = {k: jnp.asarray(v) for k, v in b.items()}
            out["metrics"].append({k: float(v) for k, v in
                                   metrics_fn(jp, jb).items()})
            jp, state, loss = step(jp, state, jb)
            out["losses"].append(float(loss))
            out["params"].append(jax.tree.map(np.asarray, jp))
    return out


GRANITE = [k for k in W.TRAIN_CASES if k.startswith("granite")]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(reference results, [rank results]) of the granite cases."""
    return run_cases(tmp_path_factory, GRANITE)


def run_cases(tmp_path_factory, keys):
    """The train cases ``keys`` on four gloo ranks, with the reference's
    steps run here meanwhile: (reference results, [rank results])."""
    tmp = tmp_path_factory.mktemp("data_axis")
    inp = {"train": {}}
    for key in keys:
        arch = W.TRAIN_CASES[key][0]
        inp["train"][key] = {"params": TA.arch_model(arch)[3],
                             "batches": _batches(key)}
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
    ref = {key: _reference_train(key) for key in keys}
    thread.join(timeout=900)
    assert not thread.is_alive(), "the ranks did not finish"
    if errors:
        raise errors[0]
    ranks = []
    for r in range(W.WORLD):
        with open(tmp / f"rank{r}.pkl", "rb") as f:
            ranks.append(pickle.load(f))
    return ref, ranks


@pytest.mark.parametrize("key", GRANITE)
def test_train_step_matches_reference(runs, key):
    check_train_step(runs, key)


@pytest.mark.parametrize("key", GRANITE)
def test_train_metrics_match_reference(runs, key):
    check_train_metrics(runs, key)


@pytest.mark.parametrize("key", GRANITE)
def test_batch_rows_over_the_data_axes(runs, key):
    check_batch_rows(runs, key)


@pytest.mark.parametrize("key", GRANITE)
def test_collectives_by_axis(runs, key):
    check_collectives(runs, key)


def check_train_step(runs, key):
    """Two AdamW steps: the reference's losses and its parameters after
    each step, gathered from every rank's pieces, on every rank."""
    ref, ranks = runs
    want = ref[key]
    for r, rank in enumerate(ranks):
        got = rank["train"][key]
        for s in range(W.TRAIN_STEPS):
            TA._close(got["losses"][s], want["losses"][s], f"rank {r} loss")
            TA.assert_tree_close(got["params"][s], want["params"][s],
                                 what=f"rank {r} step {s} params")
        assert got["losses"] == ranks[0]["train"][key]["losses"]


def check_train_metrics(runs, key):
    """Each step's grad norm (the one AdamW clips by), ``pg_loss``,
    ``mean_ratio``, ``clip_frac``, ``mean_adv`` and the router's aux
    loss: the whole batch's on every rank."""
    ref, ranks = runs
    for r, rank in enumerate(ranks):
        for s, (got, want) in enumerate(zip(rank["train"][key]["metrics"],
                                            ref[key]["metrics"])):
            for name in METRICS:
                TA._close(got[name], want[name], f"rank {r} step {s} {name}")
    assert ref[key]["metrics"][0]["grad_norm"] > 0


def check_batch_rows(runs, key):
    """A rank runs B / dp rows where the data axes divide B, else all of
    them."""
    _, shape, axes, B = W.TRAIN_CASES[key]
    dp = int(np.prod([n for a, n in zip(axes, shape) if a != "model"]))
    want = B // dp if B % dp == 0 else B
    for rank in runs[1]:
        assert rank["train"][key]["rows"] == [want] * W.TRAIN_STEPS


def check_dispatch(runs, key):
    """Every dispatch record of the first step (forward and recompute) on
    every rank: C from the rank's data shard (the reference's
    ``_capacity`` of its rows), the slots and drops of its routed ids
    exactly the reference's rule (rank in expert by the exclusive cumsum
    in flattened (token, k) order, dropped past C)."""
    arch, shape, axes, B = W.TRAIN_CASES[key]
    jcfg, *_ = TA.arch_model(arch)
    dp = shape[0]
    S = _batches(key)[0]["tokens"].shape[1]
    C = jmoe._capacity(B // dp * S, jcfg.moe_top_k, jcfg.num_experts,
                       jcfg.capacity_factor)
    E = jcfg.num_experts
    for rank in runs[1]:
        records = rank["train"][key]["records"]
        assert records
        for rec in records:
            assert rec["C"] == C
            ids = rec["ids"]
            assert ids.shape == (B // dp * S, jcfg.moe_top_k)
            slot, valid = _rule(ids, E, C)
            e0, E_loc = rec["e0"], rec["E_loc"]
            flat = ids.reshape(-1)
            np.testing.assert_array_equal(
                rec["local"], (flat >= e0) & (flat < e0 + E_loc))
            np.testing.assert_array_equal(rec["valid"], rec["local"] & valid)
            mine = rec["local"] & valid
            np.testing.assert_array_equal(rec["slot"][mine],
                                          slot[mine] - e0 * C)


def _rule(ids, E, C):
    """The reference's slot rule on one data shard's ids (T, k), all
    experts on one rank: (slot, valid), flattened (token, k) order."""
    e = ids.reshape(-1)
    onehot = (e[:, None] == np.arange(E)[None]).astype(np.int64)
    pos = np.take_along_axis(np.cumsum(onehot, 0) - onehot, e[:, None],
                             1)[:, 0]
    valid = pos < C
    return np.where(valid, e * C + pos, E * C), valid


def _port_ctx(shape, axes, r):
    """Rank r's training context on a mesh of ``shape`` as
    ``make_shard_ctx`` builds it, with stand-ins for its groups (the
    pieces read no group)."""
    at = dict(zip(axes, tmesh.rank_coords(shape, r)))
    size = dict(zip(axes, shape))
    dp = tuple(a for a in ("pod", "data") if a in axes)
    dp_rank = 0
    for a in dp:
        dp_rank = dp_rank * size[a] + at[a]
    group = object()
    return ShardCtx(tp_size=size["model"], rank=at["model"], dp=dp,
                    fsdp="data", axis_sizes=tuple((a, size[a]) for a in dp),
                    coords=tuple((a, at[a]) for a in dp),
                    dp_group=group, dp_rank=dp_rank,
                    fsdp_group=group if size["data"] > 1 else None)


@pytest.mark.parametrize("shape,axes", MESHES,
                         ids=["2x2", "4x1", "2x2x1"])
def test_rank_coords_match_reference_mesh(runs, shape, axes):
    """Rank r sits where device r sits in the reference's
    ``jax.sharding.Mesh(np.array(devices).reshape(shape), axes)``, and
    each rank's mesh carries those coordinates."""
    jm = _jmesh(shape, axes)
    devices = jax.devices()[:int(np.prod(shape))]
    for r, dev in enumerate(devices):
        want = tuple(int(i) for i in np.argwhere(jm.devices == dev)[0])
        assert tmesh.rank_coords(shape, r) == want
        assert runs[1][r]["coords"][shape, axes] == want


@pytest.mark.parametrize("arch", ["granite-3-8b", "moonshot-v1-16b-a3b"])
@pytest.mark.parametrize("shape,axes", MESHES,
                         ids=["2x2", "4x1", "2x2x1"])
def test_pieces_match_reference_param_shardings(shape, axes, arch):
    """Each rank's piece of every leaf (``param_shards``, the ``model``
    cut then the ``embed`` dim's on ``data``) is the block of the
    reference's leaf that ``param_shardings(train=True)`` gives its
    device: for granite compared leaf by leaf on the values (each layer
    of the stacked leaf), for every arch the ``data`` cut present
    exactly where the reference's spec names ``data``."""
    jcfg, tcfg, _, np_params = TA.arch_model(arch)
    jm = _jmesh(shape, axes)
    jsctx = jmake_shard_ctx(jm, train=True)
    specs, _ = jparam_shardings(jcfg, jsctx, train=True)
    whole = params_from_jax(tcfg, np_params, device="cpu")
    devices = jax.devices()[:int(np.prod(shape))]
    for r, dev in enumerate(devices):
        ctx = _port_ctx(shape, axes, r)
        split = dict(_paths(tsteps.split_leaves(tcfg, whole, ctx)))
        for jpath, spec in jax.tree_util.tree_leaves_with_path(specs):
            names = [k.key for k in jpath]
            has_data = any(a == "data" or (isinstance(a, tuple)
                                           and "data" in a)
                           for a in spec.sharding.spec)
            port = [v for p, v in split.items()
                    if [x for x in p if not isinstance(x, int)] == names]
            assert port, names
            for axes_split in port:
                assert ("data" in axes_split) == has_data, (names, r)
        if arch != "granite-3-8b":
            continue
        pieces = dict(_paths(tsteps.param_shards(tcfg, whole, ctx)))
        for jpath, spec in jax.tree_util.tree_leaves_with_path(specs):
            names = [k.key for k in jpath]
            full = np.asarray(_get(np_params, names))
            index = spec.sharding.devices_indices_map(full.shape)[dev]
            if names[0] == "layers":
                for i in range(full.shape[0]):
                    got = to_numpy(pieces[(names[0], i, *names[1:])])
                    np.testing.assert_array_equal(got, full[i][index[1:]])
            else:
                got = to_numpy(pieces[tuple(names)])
                np.testing.assert_array_equal(got, full[index])


def _get(tree, names):
    for n in names:
        tree = tree[n]
    return tree


def _paths(tree, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _paths(v, path + (k,))
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _paths(v, path + (i,))
    else:
        yield path, tree


def _want_traffic(key):
    """A train step's collectives by axis, derived from the config: each
    block's FSDP pieces gathered twice (its forward and its recompute)
    and the root's once, each gather reduce-scattered once in the
    backward (and then summed over ``pod``); each leaf whole on ``data``
    summed once over the data-parallel group in the backward, the loss's
    sums once, each MoE layer's aux once (its recompute stops at the
    last tensor the backward needs, before the aux's sum); the grad
    norm's squares once over ``data``.
    Where the batch is whole on every rank nothing is summed over
    ``dp`` and an FSDP gather's backward keeps the rank's piece."""
    arch, shape, axes, B = W.TRAIN_CASES[key]
    cfg = W.port_cfg(arch)
    size = dict(zip(axes, shape))
    dp = size["data"] * size.get("pod", 1)
    split = B % dp == 0
    tree = tsteps.param_axes(cfg)
    block = top = whole_block = whole_top = 0
    for path, (logical, _) in _axes_leaves(tree):
        n = 1
        if path[0] in ("layers", "dense_layers"):
            n = (cfg.num_layers - cfg.first_dense_layers
                 if path[0] == "layers" and cfg.num_experts
                 else cfg.first_dense_layers if path[0] == "dense_layers"
                 else cfg.num_layers)
        fsdp = "embed" in logical and cfg.d_model % size["data"] == 0 \
            and size["data"] > 1
        if len(path) == 1:
            top += n * fsdp
            whole_top += n * (not fsdp)
        else:
            block += n * fsdp
            whole_block += n * (not fsdp)
    moe_layers = (cfg.num_layers - cfg.first_dense_layers) \
        if cfg.num_experts else 0
    want = {"data_all_gather": 2 * block + top,
            "data_reduce_scatter": (block + top) if split else 0,
            "pod_all_reduce": (block + top) if split and size.get("pod", 1)
            > 1 else 0,
            "dp_all_reduce": (whole_block + whole_top + 1 + moe_layers)
            if split else 0}
    if size["data"] > 1:
        want["data_all_reduce"] = 1
    return want


def _axes_leaves(tree, path=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _axes_leaves(v, path + (k,))
        else:
            yield path + (k,), v


def check_collectives(runs, key):
    """Every rank ran the same collectives in each step; those of the
    data axes are the counts derived from the config."""
    ranks = runs[1]
    want = _want_traffic(key)
    for s in range(W.TRAIN_STEPS):
        traffic = [r["train"][key]["traffic"][s] for r in ranks]
        assert all(t == traffic[0] for t in traffic)
        for name, n in want.items():
            assert traffic[0][name] == n, (name, traffic[0][name], n)
        for name in ("data_all_gather", "data_reduce_scatter",
                     "dp_all_reduce"):
            assert (traffic[0][name + "_bytes"] > 0) == (traffic[0][name]
                                                         > 0)
