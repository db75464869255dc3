"""The rank side of ``tests/test_torch_production_cache.py``: the
production layout's four cached step builders on a gloo group of ranks,
each rank on its pieces of the weights (``launch.steps.param_shards``)
and of the cache (``launch.steps.init_cache``), handing back what it saw
(``rank{r}.pkl``).

Nothing here imports JAX: the ranks are fresh processes started by
``repro_torch.launch.mesh.spawn``, which import this module by name.
The test process writes the reference's weights and every step's inputs
(numpy, drawn from a seed: no step's input depends on a model output) to
``inputs.pkl``; each rank runs every case on the CPU at f32 and writes
back, for each step, the greedy tokens the builder returned, the logits
its ``forward`` call computed, and the cache gathered whole
(``launch.steps.gather_cache``)."""
import pickle
from dataclasses import replace
from pathlib import Path

import numpy as np

# case: (arch, config overrides, B, S, prefill T, prefill start,
# seq_shard_prefill)
CASES = {
    "granite": ("granite-3-8b", {}, 2, 32, 12, 0, False),
    "moonshot": ("moonshot-v1-16b-a3b", {}, 2, 32, 12, 0, False),
    # the window (64) is the cache: a whole-window prefill takes the ring
    # roll, and the steps after it wrap around the ring (96 tokens: the
    # reference's SSD takes a whole number of its 32-token chunks)
    "zamba2": ("zamba2-1.2b", {}, 2, 64, 96, 0, False),
    "vlm": ("llama-3.2-vision-11b", {}, 2, 32, 12, 0, False),
    "whisper": ("whisper-tiny", {}, 2, 32, 12, 0, False),
    "mamba2": ("mamba2-370m", {}, 2, 32, 12, 0, False),
    # a prefill window [16, 28) across the ranks' pieces
    "granite-span": ("granite-3-8b", {}, 2, 48, 12, 16, False),
    "granite-seq": ("granite-3-8b", {}, 2, 32, 12, 0, True),
    # S divides neither 2 nor 4: the cache is whole on every rank
    "granite-odd": ("granite-3-8b", {}, 2, 31, 12, 0, False),
}
DECODES = 4
GAMMA = 3


def port_cfg(arch, overrides):
    from repro_torch.configs import get_tiny_config
    return replace(get_tiny_config(arch), dtype="float32", **overrides)


def three_path_tree(first, pos0, B, vocab, S, ring):
    """7 nodes a row: a root (``first``, at ``pos0``) with three children,
    each with one child: (tokens, positions, slot_index, mask, within);
    row 1's last node is masked; the slots follow ``pos0`` (mod S on a
    ring cache)."""
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
    if ring:
        slots = slots % S
    mask = np.ones((B, n), bool)
    mask[1, -1] = False
    return (toks.astype(np.int32), pos.astype(np.int32),
            slots.astype(np.int32), mask,
            np.broadcast_to(within, (B, n, n)).copy())


def case_steps(cfg, B, S, T, start, seed):
    """Every step's inputs, numpy: [(kind, args)] with kind "prefill",
    "serve", "verify" or "tree"; plus the modality input of a VLM or
    audio model (or None)."""
    rng = np.random.default_rng(seed)
    V = cfg.vocab_size
    pos = (start + np.arange(T, dtype=np.int32))[None].repeat(B, 0)
    out = [("prefill", (rng.integers(0, V, (B, T)).astype(np.int32), pos))]
    p = start + T
    for _ in range(DECODES):
        out.append(("serve", (rng.integers(0, V, (B, 1)).astype(np.int32),
                              np.full((B, 1), p, np.int32))))
        p += 1
    n = GAMMA + 1
    out.append(("verify", (rng.integers(0, V, (B, n)).astype(np.int32),
                           (p + np.arange(n, dtype=np.int32))[None].repeat(
                               B, 0))))
    p += n
    out.append(("tree", three_path_tree(rng.integers(0, V, B), p, B, V, S,
                                        cfg.sliding_window > 0)))
    aux = None
    if cfg.arch_type == "vlm":
        aux = rng.normal(size=(B, cfg.num_image_tokens,
                               cfg.d_model)).astype(np.float32)
    elif cfg.arch_type == "audio":
        aux = rng.normal(size=(B, cfg.num_audio_frames,
                               cfg.d_model)).astype(np.float32)
    return out, aux


class _Recorder:
    """A stand-in for a module's ``forward`` that calls the real one with
    logits (the prefill builder asks for none) and keeps them."""

    def __init__(self, fn):
        self.fn, self.logits = fn, []

    def __call__(self, *args, **kw):
        want = kw.pop("logits", True)
        logits, cache, aux = self.fn(*args, **kw)
        self.logits.append(logits)
        return (logits if want else None), cache, aux


def _numpy_cache(cache):
    from repro_torch.bridge import to_numpy
    from repro_torch.launch.steps import SEQ_SPAN
    return {k: to_numpy(v).copy() for k, v in cache.items() if k != SEQ_SPAN}


def run_case(key, params_np, steps, aux, sctx):
    """The case's steps through the port's builders under ``sctx``: per
    step the builder's tokens, the logits of its ``forward`` call and the
    gathered cache (numpy)."""
    import torch
    from repro_torch.bridge import params_from_jax, to_numpy
    from repro_torch.launch import steps as tsteps
    from repro_torch.models import transformer
    arch, over, B, S, *_ = CASES[key]
    cfg = port_cfg(arch, over)
    whole = params_from_jax(cfg, params_np, device="cpu")
    params = tsteps.param_shards(cfg, whole, sctx)
    cache = tsteps.init_cache(cfg, B, S, sctx, device="cpu")
    if aux is not None:
        k, v = transformer.build_cross_cache(cfg, params,
                                             torch.from_numpy(aux), sctx)
        cache["cross_k"].copy_(k)
        cache["cross_v"].copy_(v)
    rec = _Recorder(transformer.forward)
    real, transformer.forward = transformer.forward, rec
    try:
        build = {"prefill": tsteps.build_prefill_step(cfg, sctx),
                 "serve": tsteps.build_serve_step(cfg, sctx),
                 "verify": tsteps.build_verify_step(cfg, sctx),
                 "tree": tsteps.build_tree_verify_step(cfg, sctx)}
    finally:
        transformer.forward = real
    out = []
    for kind, args in steps:
        targs = [torch.from_numpy(np.ascontiguousarray(a)) for a in args]
        got = build[kind](params, *targs, cache)
        if kind == "prefill":
            cache, tokens = got, None
        else:
            tokens, cache = got
            tokens = to_numpy(tokens).copy()
        out.append({"tokens": tokens,
                    "logits": to_numpy(rec.logits[-1]).copy(),
                    "cache": _numpy_cache(tsteps.gather_cache(cfg, cache,
                                                              sctx))})
    return out


def rank_main(rank, world, device, in_file, out_dir):
    """A rank of the tests' group: every case at tp = ``world``, written
    to ``out_dir/rank{rank}.pkl``, with each case's collectives."""
    from repro_torch import sharding
    from repro_torch.launch.mesh import make_shard_ctx, small_mesh
    with open(in_file, "rb") as f:
        inp = pickle.load(f)
    mesh = small_mesh(world)
    out = {"runs": {}, "traffic": {}}
    for key, case in inp.items():
        sctx = make_shard_ctx(mesh, train=False,
                              seq_shard_prefill=CASES[key][6])
        sharding.reset_traffic()
        out["runs"][key] = run_case(key, case["params"], case["steps"],
                                    case["aux"], sctx)
        out["traffic"][key] = dict(sharding.traffic)
    with open(Path(out_dir) / f"rank{rank}.pkl", "wb") as f:
        pickle.dump(out, f)
