"""Tree speculation in the PyTorch port against the JAX package, on
granite-3-8b tiny with the reference's weights: K2's plain version (what
its wrapper runs on a CPU tensor) against ``tree_verify_ref`` and the
Pallas kernel in interpret mode; the tree-verify ``forward`` on the
engine's own tree batches (branching trees, prefill rows, a tail-fused
row, a ring cache), including the check that the mask it builds is a
subset of the positional one; ``tree_acceptance``; and tree-mode
``Instance``s stepped beside the reference's, token-exact at f32, with
one host sync per fused step and the fused step equal to the sync oracle
run from the same state."""
import copy
from dataclasses import replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_tiny_config as jget_tiny
from repro.engine import EngineSeq as JSeq
from repro.engine import Instance as JInstance
from repro.engine import StepFunctions as JSteps
from repro.engine import build_token_tree as jbuild_token_tree
from repro.engine import chain_tree as jchain_tree
from repro.engine.sampling import tree_acceptance as jtree_acceptance
from repro.kernels.spec_verify.kernel import tree_verify_pallas
from repro.kernels.spec_verify.ref import tree_verify_ref as jax_tree_ref
from repro.models import forward as jforward
from repro.models import init_params as jinit_params
from repro_torch.bridge import cache_to_numpy, params_from_jax, to_numpy
from repro_torch.configs import get_tiny_config
from repro_torch.engine import (EngineSeq, Instance, StepFunctions,
                                build_token_tree, chain_tree)
from repro_torch.engine.sampling import tree_acceptance
from repro_torch.kernels.spec_verify import ops
from repro_torch.kernels.spec_verify.ref import (pos_mask, spec_verify_ref,
                                                 tree_verify_ref)
from repro_torch.models import forward
from repro_torch.models.transformer import _allowed_mask, clone_cache

torch.set_num_threads(2)
ARCH = "granite-3-8b"
VOCAB = 512
DTYPES = {"float32": (jnp.float32, torch.float32, 2e-5),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, 3e-2)}
# B, T, S, Hq, Hk, D, window (tests/test_kernels.py, tree cases)
TREE_CASES = [(2, 5, 256, 4, 2, 64, 0), (1, 8, 128, 8, 8, 128, 0),
              (2, 4, 256, 4, 1, 64, 96)]
INST = dict(max_slots=3, cache_len=64, prefill_chunk=8, gamma_max=4,
            base_seed=7)


# ---------------------------------------------------------------- K2 --------


def _tree_case(case, seed):
    """tests/test_kernels.py's random tree layout: siblings at duplicate
    positions, node c at slot anchor+c, the ancestor mask over a
    committed prefix."""
    B, T, S, Hq, Hk, D, _ = case
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(B, T, Hq, D)).astype(np.float32)
    k = rng.normal(size=(B, S, Hk, D)).astype(np.float32)
    v = rng.normal(size=(B, S, Hk, D)).astype(np.float32)
    q_pos = np.zeros((B, T), np.int32)
    tree = np.zeros((B, T, S), bool)
    k_pos = np.full((B, S), -1, np.int32)
    for b, anchor in enumerate(rng.integers(40, 90, B)):
        k_pos[b, :anchor + 1] = np.arange(anchor + 1)
        parent = [-1] + [int(rng.integers(0, j)) for j in range(1, T)]
        depth = [0]
        for j in range(1, T):
            depth.append(depth[parent[j]] + 1)
        for j in range(T):
            q_pos[b, j] = anchor + depth[j]
            tree[b, j, :anchor + 1] = True
            node = j
            while node >= 0:
                tree[b, j, anchor + node] = True
                node = parent[node]
            k_pos[b, anchor + j] = q_pos[b, j]
    return q, k, v, q_pos, k_pos, tree


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("case", TREE_CASES)
def test_tree_plain_matches_jax(case, dtype):
    jdt, tdt, tol = DTYPES[dtype]
    q, k, v, q_pos, k_pos, tree = _tree_case(case, 3)
    win = case[-1]
    jargs = (jnp.asarray(q, jdt), jnp.asarray(k, jdt), jnp.asarray(v, jdt),
             jnp.asarray(q_pos), jnp.asarray(k_pos), jnp.asarray(tree))
    want_ref = np.asarray(jax_tree_ref(*jargs, window=win), np.float32)
    want_pallas = np.asarray(tree_verify_pallas(
        *jargs, window=win, block_k=64, interpret=True), np.float32)
    t = [torch.from_numpy(a) for a in (q, k, v, q_pos, k_pos, tree)]
    t[:3] = [x.to(tdt) for x in t[:3]]
    n0 = dict(ops.launches)
    got = ops.tree_verify(*t, window=win)
    assert ops.launches == n0                 # a CPU call is no launch
    assert got.dtype == tdt and got.shape == t[0].shape
    got = to_numpy(got)
    np.testing.assert_allclose(got, want_ref, atol=tol, rtol=tol)
    np.testing.assert_allclose(got, want_pallas, atol=tol, rtol=tol)
    # under an all-true mask K2 is K1, bit for bit
    ones = torch.ones_like(t[5])
    assert torch.equal(ops.tree_verify(*t[:5], ones, window=win),
                       spec_verify_ref(*t[:5], window=win))
    # a uint8 mask is the same mask
    assert torch.equal(tree_verify_ref(*t[:5], t[5].to(torch.uint8),
                                       window=win),
                       tree_verify_ref(*t[:5], t[5], window=win))


BAD_TREE_MASKS = {
    "dtype_int32": (TypeError, lambda tm: tm.int()),
    "shape": (ValueError, lambda tm: tm[:, :1]),
    "strided": (ValueError,
                lambda tm: tm.transpose(1, 2).contiguous().transpose(1, 2)),
    "device": (ValueError, lambda tm: tm.to("meta")),
}


@pytest.mark.parametrize("name", sorted(BAD_TREE_MASKS))
def test_tree_mask_checks(name):
    q, k, _, _, _, tm = (torch.from_numpy(a) for a in
                         _tree_case(TREE_CASES[0], 1))
    exc, bad = BAD_TREE_MASKS[name]
    with pytest.raises(exc):
        ops.check_tree_mask(q, k, bad(tm))
    ops.check_tree_mask(q, k, tm)
    ops.check_tree_mask(q, k, tm.to(torch.uint8))


def test_tree_other_devices_raise():
    args = [torch.from_numpy(a).to("meta")
            for a in _tree_case(TREE_CASES[0], 1)]
    with pytest.raises(ValueError, match="no kernel for device"):
        ops.tree_verify(*args)


# ------------------------------------------------------- tree acceptance ----


@pytest.mark.parametrize("seed", range(4))
def test_tree_acceptance_matches_jax(seed):
    """Random trees over a 3-token vocabulary (so edges often match),
    laid out as the engine lays them out, some rows fused after a prefill
    chunk (anchor > 0), some without a tree."""
    rng = np.random.default_rng(seed)
    B, T = 6, 12
    tokens = rng.integers(0, 3, (B, T)).astype(np.int32)
    sampled = rng.integers(0, 3, (B, T)).astype(np.int32)
    parent = np.full((B, T), -1, np.int32)
    depth = np.zeros((B, T), np.int32)
    within = np.zeros((B, T, T), bool)
    mask = np.zeros((B, T), bool)
    anchor = np.zeros((B,), np.int32)
    for b in range(B):
        a = int(rng.integers(0, 3)) if b % 3 == 2 else 0
        anchor[b] = a
        paths = [rng.integers(0, 3, rng.integers(1, 5)).tolist()
                 for _ in range(int(rng.integers(0, 4)))]
        t = build_token_tree(paths, max_nodes=T - 1 - a)
        mask[b, :a + 1 + len(t)] = True
        within[b, :a + 1, :a + 1] = np.tril(np.ones((a + 1, a + 1), bool))
        tokens[b, a + 1:a + 1 + len(t)] = t.tokens
        for j, anc in enumerate(t.ancestors_or_self()):
            c = a + 1 + j
            parent[b, c] = a if t.parent[j] < 0 else a + 1 + t.parent[j]
            depth[b, c] = t.depth[j]
            within[b, c, a] = True
            for x in anc:
                within[b, c, a + 1 + x] = True
    args = (sampled, tokens, parent, depth, within, mask, anchor)
    want = [np.asarray(x) for x in
            jtree_acceptance(*(jnp.asarray(a) for a in args))]
    got = [to_numpy(x) for x in
           tree_acceptance(*(torch.from_numpy(a) for a in args))]
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g, w)
    assert got[0].dtype == np.int32 and got[1].dtype == np.int32


# ------------------------------------------------------ models, instances ---


@pytest.fixture(scope="module")
def models():
    jcfg = replace(jget_tiny(ARCH), dtype="float32")
    tcfg = replace(get_tiny_config(ARCH), dtype="float32")
    jp, _ = jinit_params(jcfg, jax.random.PRNGKey(1))
    tp = params_from_jax(tcfg, jax.tree.map(np.asarray, jp), device="cpu")
    return jcfg, jp, tcfg, tp


def _branch_drafts(seqs, oracle):
    """slot -> build_token_tree([bad, good]): ``good`` continues the
    no-draft stream, ``bad`` is it perturbed (the trunk, rank 0)."""
    out = {}
    for i, s in enumerate(seqs):
        good = oracle[i][len(s.generated):len(s.generated) + 2]
        if s.finished or s.prefilling or not good:
            continue
        out[i] = [[(x + 7) % VOCAB for x in good], good]
    return out


PROMPTS = [[5, 9, 2, 7, 1], list(range(3, 16)), [40 + i for i in range(20)]]


def _seqs(cls, temp, n=16):
    return [cls(f"r{i}", "g0", list(p), seed=11 + i, temperature=temp,
                max_new_tokens=n) for i, p in enumerate(PROMPTS)]


@pytest.fixture(scope="module")
def oracles(models):
    """Each request's tokens from a draft-free reference run."""
    jcfg, jp, _, _ = models
    out = {}
    for temp in (0.0, 1.0):
        ref = JInstance(jcfg, jp, JSteps(jcfg), **INST)
        seqs = _seqs(JSeq, temp)
        for s in seqs:
            ref.admit(s)
        while not all(s.finished for s in seqs):
            ref.run_step()
        out[temp] = [s.generated for s in seqs]
    return out


def _forward_both(jcfg, jp, tcfg, tp, inst, bt):
    """The reference's and the port's tree forward on one batch from one
    cache state; returns both logits, the port's cache after it and the
    mask the port built."""
    cache = clone_cache(inst.cache)
    jc = {k: jnp.asarray(v) for k, v in cache_to_numpy(cache).items()}
    lj, jc, _ = jforward(jcfg, jp, jnp.asarray(bt.tokens),
                         jnp.asarray(bt.positions), jc,
                         token_mask=jnp.asarray(bt.mask),
                         slot_index=jnp.asarray(bt.slot_index),
                         within_mask=jnp.asarray(bt.within))
    t = {k: torch.from_numpy(np.asarray(getattr(bt, k))) for k in
         ("tokens", "positions", "mask", "slot_index", "within")}
    lt, cache, _ = forward(tcfg, tp, t["tokens"], t["positions"], cache,
                           token_mask=t["mask"], slot_index=t["slot_index"],
                           within_mask=t["within"])
    S = cache["slot_pos"].shape[1]
    slots = torch.where(t["mask"] & (t["slot_index"] < S),
                        t["slot_index"].long(), S)
    allowed = _allowed_mask(tcfg, t["positions"], slots, cache["slot_pos"],
                            t["within"])
    return np.asarray(lj), to_numpy(lt), jc, cache, allowed


@pytest.mark.parametrize("window", [0, 24])
def test_tree_forward_matches_jax(models, oracles, window):
    """Tree batches from the port's ``_build_tree_batch`` while three
    requests prefill, decode and verify branching trees: logits within
    1e-5 of the reference's, the same ``slot_pos`` and K/V, and the
    allowed-mask a subset of the positional mask.  ``window`` 24 is a
    ring cache of 24 slots."""
    jcfg, jp, tcfg, tp = models
    jcfg, tcfg = (replace(c, sliding_window=window) for c in (jcfg, tcfg))
    inst = Instance(tcfg, tp, StepFunctions(tcfg), device="cpu",
                    spec_mode="tree", max_slots=3, cache_len=64,
                    prefill_chunk=8, gamma_max=6, base_seed=7)
    seqs = _seqs(EngineSeq, 1.0, n=20)
    inst.admit(seqs[0])
    seen = {"branch": 0, "prefill": 0, "fused": 0}
    for step in range(24):
        if step == 2:
            inst.admit(seqs[1])
            inst.admit(seqs[2])
        if all(s.finished for s in seqs if s in inst.slots):
            break
        drafts = {i: build_token_tree(p) for i, p in
                  _branch_drafts(seqs, oracles[1.0]).items()}
        plan = inst._prefill_plan()
        bt = inst._build_tree_batch(inst.decode_slots(), plan, drafts)
        seen["branch"] += sum(not t.is_chain() for t in bt.trees.values()
                              if len(t))
        seen["prefill"] += len(plan)
        seen["fused"] += len(bt.fused)
        lj, lt, jc, tc, allowed = _forward_both(jcfg, jp, tcfg, tp, inst, bt)
        rows = bt.mask.any(axis=1)
        np.testing.assert_allclose(lt[rows], lj[rows], atol=1e-5, rtol=1e-5)
        got = cache_to_numpy(tc)
        np.testing.assert_array_equal(got["slot_pos"],
                                      np.asarray(jc["slot_pos"]))
        for k in ("k", "v"):
            np.testing.assert_allclose(got[k], np.asarray(jc[k]), atol=1e-5,
                                       rtol=1e-5)
        positional = pos_mask(torch.from_numpy(bt.positions),
                              tc["slot_pos"], window)
        assert not (allowed & ~positional).any()
        inst.run_step(drafts)
    assert seen["branch"] and seen["prefill"] and seen["fused"], seen


@pytest.mark.parametrize("temp", [0.0, 1.0])
def test_tree_instances_token_exact(models, oracles, temp):
    """Branching ``[bad, good]`` drafts through reference and port
    tree-mode instances: the same tokens, logprobs and accept counts at
    every step, one host sync per fused step, rescues along the side
    branch, and the same step kinds and tree counters."""
    jcfg, jp, tcfg, tp = models
    ref = JInstance(jcfg, jp, JSteps(jcfg), spec_mode="tree", **INST)
    port = Instance(tcfg, tp, StepFunctions(tcfg), device="cpu",
                    spec_mode="tree", **INST)
    jseqs, tseqs = _seqs(JSeq, temp), _seqs(EngineSeq, temp)
    assert [ref.admit(s) for s in jseqs] == [port.admit(s) for s in tseqs]
    rescues = 0
    while not all(s.finished for s in tseqs):
        paths = _branch_drafts(tseqs, oracles[temp])
        h0 = port.steps.host_syncs
        ticket = port.dispatch_step({i: build_token_tree(p)
                                     for i, p in paths.items()})
        assert port.steps.host_syncs == h0
        got = port.commit_step(ticket)
        assert port.steps.host_syncs == h0 + 1
        want = ref.run_step({i: jbuild_token_tree(p)
                             for i, p in paths.items()})
        assert sorted(got) == sorted(want)
        for i in got:
            assert got[i][0] == want[i][0] and got[i][2] == want[i][2]
            np.testing.assert_allclose(got[i][1], want[i][1], atol=1e-5)
            a = got[i][2]
            if a and i in paths and got[i][0][:a] == paths[i][1][:a]:
                rescues += 1
        assert port.steps.invocations < 100
    assert [s.generated for s in tseqs] == [s.generated for s in jseqs]
    assert rescues > 0
    assert dict(port.steps.invocations_by_kind) == \
        dict(ref.steps.invocations_by_kind)
    for name in ("tree_steps", "tree_nodes", "tree_branch_nodes"):
        assert getattr(port, name) == getattr(ref, name) > 0, name


def test_chain_trees_equal_linear(models, oracles):
    """Chain trees in tree mode commit what the same drafts commit on the
    port's linear path, with the reference's tree mode alongside."""
    jcfg, jp, tcfg, tp = models
    runs = {}
    for mode in ("linear", "tree", "ref-tree"):
        if mode == "ref-tree":
            inst = JInstance(jcfg, jp, JSteps(jcfg), spec_mode="tree",
                             **INST)
            seqs, chain = _seqs(JSeq, 1.0), jchain_tree
        else:
            inst = Instance(tcfg, tp, StepFunctions(tcfg), device="cpu",
                            spec_mode=mode, **INST)
            seqs, chain = _seqs(EngineSeq, 1.0), chain_tree
        for s in seqs:
            inst.admit(s)
        while not all(s.finished for s in seqs):
            d = {i: oracles[1.0][i][len(s.generated):len(s.generated) + 3]
                 for i, s in enumerate(seqs)
                 if not s.finished and not s.prefilling}
            inst.run_step({i: chain(x) for i, x in d.items()}
                          if mode != "linear" else d)
        runs[mode] = ([s.generated for s in seqs], inst.steps_run)
    assert runs["tree"] == runs["linear"] == runs["ref-tree"]


def _snapshot(inst):
    shadow = copy.copy(inst)
    shadow.cache = clone_cache(inst.cache)
    shadow.slots = [copy.deepcopy(s) for s in inst.slots]
    shadow.steps = StepFunctions(inst.cfg)
    return shadow


def test_sync_tree_equals_fused_tree(models, oracles):
    """At every step the sync oracle's tree step, run on a snapshot of the
    instance, commits what the fused step commits and leaves the same
    cache: ``slot_pos`` equal, K/V equal at every committed slot."""
    _, _, tcfg, tp = models
    inst = Instance(tcfg, tp, StepFunctions(tcfg), device="cpu",
                    spec_mode="tree", **INST)
    seqs = _seqs(EngineSeq, 1.0)
    for s in seqs:
        inst.admit(s)
    compacted = 0
    while not all(s.finished for s in seqs):
        drafts = {i: build_token_tree(p) for i, p in
                  _branch_drafts(seqs, oracles[1.0]).items()}
        shadow = _snapshot(inst)
        want = shadow._run_step_sync_tree(drafts)
        got = inst.run_step(drafts)
        assert shadow.steps.host_syncs == 2
        assert {i: (t, a) for i, (t, _, a) in got.items()} == \
            {i: (t, a) for i, (t, _, a) in want.items()}
        sp = inst.cache["slot_pos"]
        assert torch.equal(sp, shadow.cache["slot_pos"])
        live = sp >= 0
        for k in ("k", "v"):
            assert torch.equal(inst.cache[k][:, live],
                               shadow.cache[k][:, live])
        compacted += sum(a for _, _, a in got.values())
        assert inst.steps_run < 100
    assert compacted > 0
