"""The rank side of the data-axis tests (``tests/test_torch_data_axis.py``,
``test_torch_data_axis_moe.py`` and ``test_torch_data_axis_cache.py``):
the production layout with
its data axes over ranks — ``build_train_step`` (FSDP of the ``embed``
axis over ``data``, the batch split over ``pod`` and ``data``) and the
four cached step builders (the batch and the cache's rows split over
the data axes) — on one gloo group of four ranks laid out as each case's
mesh.

Nothing here imports JAX: the ranks are fresh processes started by
``repro_torch.launch.mesh.spawn``, which import this module by name.
The test process writes the reference's weights and every input (numpy)
to ``inputs.pkl``; each rank builds every case's mesh in the same order
(``launch.mesh.small_mesh`` for ("data", "model"), ``make_mesh`` for
the three axes), cuts its pieces of the weights, of the
batch (``launch.steps.batch_shards``) and of the cache, runs the case on
the CPU at f32 and writes back what it saw (``rank{r}.pkl``): the
parameters gathered whole, the metrics, its dispatch records, its rows'
logits and tokens, the cache gathered whole, and the collectives."""
import pickle
from dataclasses import replace
from pathlib import Path

import numpy as np

WORLD = 4
DD = ("data", "model")
PDM = ("pod", "data", "model")
# train cases: (arch, mesh shape, mesh axes, batch rows)
TRAIN_CASES = {
    "granite-2x2": ("granite-3-8b", (2, 2), DD, 4),
    "granite-4x1": ("granite-3-8b", (4, 1), DD, 4),
    "granite-2x2x1": ("granite-3-8b", (2, 2, 1), PDM, 4),
    # 6 rows divide no data size of the mesh: the batch whole on every rank
    "granite-4x1-b6": ("granite-3-8b", (4, 1), DD, 6),
    "moonshot-2x2": ("moonshot-v1-16b-a3b", (2, 2), DD, 4),
    "moonshot-4x1": ("moonshot-v1-16b-a3b", (4, 1), DD, 4),
}
TRAIN_STEPS = 2
# cached cases: (arch, mesh shape, B, S, prefill T)
CACHE_CASES = {
    "granite-2x2": ("granite-3-8b", (2, 2), 4, 32, 12),
    "granite-4x1": ("granite-3-8b", (4, 1), 4, 32, 12),
    "moonshot-2x2": ("moonshot-v1-16b-a3b", (2, 2), 4, 32, 12),
    "moonshot-4x1": ("moonshot-v1-16b-a3b", (4, 1), 4, 32, 12),
}


def port_cfg(arch):
    from repro_torch.configs import get_tiny_config
    return replace(get_tiny_config(arch), dtype="float32")


def make_batch(cfg, B, seed):
    """A GRPO batch of B sequences of 24 tokens (responses from position
    8, two shorter), old logprobs near the policy's."""
    rng = np.random.default_rng(seed)
    S = 24
    mask = np.zeros((B, S), np.float32)
    mask[:, 8:] = 1.0
    mask[1, 20:] = 0.0
    mask[3, 15:] = 0.0
    return {"tokens": rng.integers(0, cfg.vocab_size, size=(B, S)).astype(
                np.int32),
            "loss_mask": mask,
            "old_logprobs": (-np.log(cfg.vocab_size)
                             + rng.normal(0, 0.3, size=(B, S))
                             ).astype(np.float32),
            "advantages": rng.normal(size=(B,)).astype(np.float32),
            "rewards": rng.random(B).astype(np.float32)}


def _numpy_records(records):
    import torch
    from repro_torch.bridge import to_numpy
    return [{k: (to_numpy(v).copy() if isinstance(v, torch.Tensor) else v)
             for k, v in r.items()} for r in records]


def train_case(cfg, tree, batches, sctx):
    """``build_train_step`` for ``len(batches)`` AdamW steps on this
    rank's pieces and rows: per step the loss, the metrics, the
    parameters after it (gathered whole) and the MoE dispatch records of
    the first step."""
    import torch
    from repro_torch import sharding
    from repro_torch.bridge import params_from_jax, params_to_numpy
    from repro_torch.launch import steps
    from repro_torch.models import moe
    from repro_torch.training.optim import init_opt_state, tree_map
    whole = params_from_jax(cfg, tree, device="cpu", dtype="float32")
    params = tree_map(lambda p: p.detach().clone().requires_grad_(),
                      steps.param_shards(cfg, whole, sctx))
    state = init_opt_state(params)
    step = steps.build_train_step(cfg, sctx)
    out = {"losses": [], "metrics": [], "params": [], "records": None,
           "rows": [], "traffic": []}
    for i, batch in enumerate(batches):
        tb = steps.batch_shards(cfg, sctx, {k: torch.from_numpy(v)
                                            for k, v in batch.items()})
        out["rows"].append(int(tb["tokens"].shape[0]))
        moe.DISPATCH_LOG = []
        sharding.reset_traffic()
        params, state, loss, met = step(params, state, tb)
        out["traffic"].append(dict(sharding.traffic))
        if i == 0:
            out["records"] = _numpy_records(moe.DISPATCH_LOG)
        moe.DISPATCH_LOG = None
        out["losses"].append(float(loss))
        out["metrics"].append({k: float(v) for k, v in met.items()})
        out["params"].append(params_to_numpy(
            cfg, steps.gather_params(cfg, params, sctx)))
    return out


def _tree_steps(first, pos0, B, vocab):
    """The tree-verify step's inputs: 7 nodes a row (a root with three
    two-node paths), row 1's last node masked."""
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
    return (toks.astype(np.int32), pos.astype(np.int32),
            slots.astype(np.int32), mask,
            np.broadcast_to(within, (B, n, n)).copy())


DECODES = 3
GAMMA = 3
# the names of each step's inputs, as ``launch.steps.batch_shards`` cuts
# them
STEP_INPUTS = {"prefill": ("tokens", "positions"),
               "serve": ("tokens", "positions"),
               "verify": ("tokens", "positions"),
               "tree": ("tokens", "positions", "slot_index", "mask",
                        "within")}


def cache_steps(cfg, B, T, seed):
    """Every step's inputs, numpy, drawn from a seed: [(kind, args)] — a
    contiguous prefill of T from position 0, ``DECODES`` decodes, a
    verify of ``GAMMA`` + 1 and a three-path tree."""
    rng = np.random.default_rng(seed)
    V = cfg.vocab_size
    pos = np.arange(T, dtype=np.int32)[None].repeat(B, 0)
    out = [("prefill", (rng.integers(0, V, (B, T)).astype(np.int32), pos))]
    p = T
    for _ in range(DECODES):
        out.append(("serve", (rng.integers(0, V, (B, 1)).astype(np.int32),
                              np.full((B, 1), p, np.int32))))
        p += 1
    n = GAMMA + 1
    out.append(("verify", (rng.integers(0, V, (B, n)).astype(np.int32),
                           (p + np.arange(n, dtype=np.int32))[None].repeat(
                               B, 0))))
    p += n
    out.append(("tree", _tree_steps(rng.integers(0, V, B), p, B, V)))
    return out


class _Recorder:
    """A stand-in for ``transformer.forward`` that asks for the logits
    (the prefill builder wants none) and keeps them."""

    def __init__(self, fn):
        self.fn, self.logits = fn, []

    def __call__(self, *args, **kw):
        want = kw.pop("logits", True)
        logits, cache, aux = self.fn(*args, **kw)
        self.logits.append(logits)
        return (logits if want else None), cache, aux


def cache_case(cfg, tree, B, S, step_inputs, sctx):
    """The case's steps through the four cached builders on this rank's
    rows: per step its rows, the builder's tokens, its ``forward``
    call's logits and the cache gathered whole; and the collectives of
    the builder calls."""
    import torch
    from repro_torch import sharding
    from repro_torch.bridge import params_from_jax, to_numpy
    from repro_torch.launch import steps
    from repro_torch.models import transformer
    whole = params_from_jax(cfg, tree, device="cpu")
    params = steps.param_shards(cfg, whole, sctx)
    cache = steps.init_cache(cfg, B, S, sctx, device="cpu")
    rec = _Recorder(transformer.forward)
    real, transformer.forward = transformer.forward, rec
    try:
        build = {"prefill": steps.build_prefill_step(cfg, sctx),
                 "serve": steps.build_serve_step(cfg, sctx),
                 "verify": steps.build_verify_step(cfg, sctx),
                 "tree": steps.build_tree_verify_step(cfg, sctx)}
    finally:
        transformer.forward = real
    out = []
    seen = dict.fromkeys(sharding.traffic, 0)
    for kind, args in step_inputs:
        named = dict(zip(STEP_INPUTS[kind], (
            torch.from_numpy(np.ascontiguousarray(a)) for a in args)))
        mine = steps.batch_shards(cfg, sctx, named)
        sharding.reset_traffic()
        got = build[kind](params, *[mine[k] for k in STEP_INPUTS[kind]],
                          cache)
        for k, v in sharding.traffic.items():
            seen[k] += v
        if kind == "prefill":
            cache, tokens = got, None
        else:
            tokens, cache = got
            tokens = to_numpy(tokens).copy()
        span = mine.get(steps.BATCH_SPAN)
        rows = (0, B) if span is None else (int(span[0]), int(span[1]))
        whole_c = steps.gather_cache(cfg, cache, sctx)
        out.append({"rows": rows, "tokens": tokens,
                    "logits": to_numpy(rec.logits[-1]).copy(),
                    "cache": {k: to_numpy(v).copy()
                              for k, v in whole_c.items()
                              if k not in steps.SPANS}})
    return out, seen


def rank_main(rank, world, device, in_file, out_dir):
    """A rank of the group: every case of ``inputs.pkl`` (its "train"
    and / or "cache" cases) on its mesh, with the rank's coordinates and
    each case's collectives, written to ``out_dir/rank{rank}.pkl``."""
    from repro_torch.launch.mesh import make_mesh, make_shard_ctx, small_mesh

    def mesh_of(shape, axes):
        mesh = (small_mesh(shape[1]) if axes == DD
                else make_mesh(shape, axes))
        assert mesh.shape == shape and mesh.axis_names == axes
        return mesh
    with open(in_file, "rb") as f:
        inp = pickle.load(f)
    out = {"train": {}, "cache": {}, "traffic": {}, "coords": {}}
    for key, case in inp.get("train", {}).items():
        arch, shape, axes, _ = TRAIN_CASES[key]
        mesh = mesh_of(shape, axes)
        out["coords"][shape, axes] = mesh.coords
        sctx = make_shard_ctx(mesh, train=True)
        out["train"][key] = train_case(port_cfg(arch), case["params"],
                                       case["batches"], sctx)
    for key, case in inp.get("cache", {}).items():
        arch, shape, B, S, _ = CACHE_CASES[key]
        mesh = mesh_of(shape, DD)
        out["coords"][shape, DD] = mesh.coords
        sctx = make_shard_ctx(mesh, train=False)
        out["cache"][key], out["traffic"][key] = cache_case(
            port_cfg(arch), case["params"], B, S, case["steps"], sctx)
    with open(Path(out_dir) / f"rank{rank}.pkl", "wb") as f:
        pickle.dump(out, f)
