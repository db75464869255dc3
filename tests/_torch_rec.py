"""Shared harness of the port's SSM, hybrid, MoE, VLM and audio parity
tests (``test_torch_ssm.py``, ``test_torch_hybrid.py``,
``test_torch_moe_engine.py``, ``test_torch_vlm.py``,
``test_torch_audio.py``): the reference's weights carried over by the
bridge, port and reference ``Instance``s stepped side by side with the
same drafts (chains, or branching trees on attention-only models), KV
blobs crossing between the two, and a fused step held against the sync
oracle run on a snapshot of the same instance.  VLM and audio instances
are built on seeded random image embeddings or audio frames
(``modality_embeds``): with the frontends' zero stub every cross K/V is
0 and the cross blocks add exactly 0, which would hide a wrong cross
path.  Everything at f32 on the CPU."""
import copy
import types
from dataclasses import replace

import jax
import numpy as np
import torch

from repro.configs import get_tiny_config as jget_tiny
from repro.core import SeerRollout as JRollout
from repro.core import make_groups as jmake_groups
from repro.engine import EngineSeq as JSeq
from repro.engine import Instance as JInstance
from repro.engine import StepFunctions as JSteps
from repro.engine import build_token_tree as jbuild_token_tree
from repro.models import build_cross_cache as jbuild_cross_cache
from repro.models import forward as jforward
from repro.models import init_cache as jinit_cache
from repro.models import init_params as jinit_params
from repro.models import modality_inputs as jmodality_inputs
from repro.models import transformer as jtr
from repro_torch.bridge import (blob_from_jax, params_from_jax, to_numpy,
                                to_tensor)
from repro_torch.configs import get_tiny_config
from repro_torch.core import SeerRollout, make_groups
from repro_torch.device import torch_dtype
from repro_torch.engine import (EngineSeq, Instance, StepFunctions,
                                build_token_tree)
from repro_torch.models import forward, init_cache, init_params
from repro_torch.models import transformer as ttr
from repro_torch.models.model import modality_inputs
from repro_torch.models.transformer import (build_cross_cache, clone_cache,
                                            cross_len, n_cross_layers,
                                            n_ssm_layers, with_scratch)

PROMPTS = [[5, 9, 2, 7, 1], list(range(3, 16)), [40 + i for i in range(20)]]
INST = dict(max_slots=3, cache_len=64, prefill_chunk=8, gamma_max=4,
            base_seed=7)
ROLLOUT = dict(n_instances=2, max_slots=2, cache_len=128, chunk_size=8,
               policy="seer", spec_decode=True, prefill_chunk=4)


def random_embeds(cfg, batch, seed=0):
    """Seeded random modality embeddings (batch, Tm, d_model), f32 numpy:
    image embeddings of a VLM, audio frames of an audio model."""
    rng = np.random.default_rng(seed)
    return rng.normal(size=(batch, cross_len(cfg), cfg.d_model)).astype(
        np.float32)


def load_models(arch, **over):
    """(jcfg, jax params, port cfg, port params, shared JAX steps, the
    instances' modality embeddings or None) at f32; the JAX
    StepFunctions is shared so its jitted steps compile once."""
    jcfg = replace(jget_tiny(arch), dtype="float32", **over)
    tcfg = replace(get_tiny_config(arch), dtype="float32", **over)
    jp, _ = jinit_params(jcfg, jax.random.PRNGKey(1))
    tp = params_from_jax(tcfg, jax.tree.map(np.asarray, jp), device="cpu")
    embeds = random_embeds(tcfg, INST["max_slots"]) \
        if n_cross_layers(tcfg) else None
    return types.SimpleNamespace(jcfg=jcfg, jp=jp, tcfg=tcfg, tp=tp,
                                 jsteps=JSteps(jcfg), embeds=embeds)


def pair(m, embeds=None, **kw):
    """A reference and a port instance of the same settings; a VLM or
    audio pair on ``embeds`` (default ``m.embeds``)."""
    kw = dict(INST, **kw)
    jkw, tkw = dict(kw), dict(kw)
    embeds = m.embeds if embeds is None else embeds
    if embeds is not None:
        jkw["modality_embeds"] = jax.numpy.asarray(embeds)
        tkw["modality_embeds"] = torch.from_numpy(embeds)
    return (JInstance(m.jcfg, m.jp, m.jsteps, **jkw),
            Instance(m.tcfg, m.tp, StepFunctions(m.tcfg), device="cpu",
                     **tkw))


def seqs(cls, temp, n=16):
    return [cls(f"r{i}", "g0", list(p), seed=11 + i, temperature=temp,
                max_new_tokens=n) for i, p in enumerate(PROMPTS)]


def oracle_stream(m, temp, n=16):
    """Seq 0's tokens from a draft-free reference run."""
    ref, _ = pair(m)
    s = seqs(JSeq, temp, n)[0]
    ref.admit(s)
    while not s.finished:
        ref.run_step()
    return s.generated


def drafts(tseqs, slots, oracle, it, vocab):
    """Oracle drafts for seq 0 (accepted), garbage for seq 1 every other
    step (rejected: the state must be replayed), none for seq 2."""
    out = {}
    s0, s1 = tseqs[0], tseqs[1]
    if not s0.finished and not s0.prefilling:
        k = len(s0.generated)
        if oracle[k:k + 3]:
            out[slots[0]] = list(oracle[k:k + 3])
    if not s1.finished and not s1.prefilling and it % 2 and s1.generated:
        out[slots[1]] = [(s1.generated[-1] + 13) % vocab] * 2
    return out


def compare_results(want, got, tol=1e-5):
    assert sorted(want) == sorted(got)
    for slot in want:
        assert want[slot][0] == got[slot][0] and \
            want[slot][2] == got[slot][2], (slot, want[slot], got[slot])
        np.testing.assert_allclose(got[slot][1], want[slot][1], atol=tol,
                                   rtol=tol)


def compare_caches(jcache, tcache, tol=1e-4):
    assert sorted(jcache) == sorted(tcache)
    for k in jcache:
        want = np.asarray(jcache[k], np.float32)
        got = to_numpy(tcache[k]).astype(np.float32)
        if k == "slot_pos":
            np.testing.assert_array_equal(got, want)
        else:
            np.testing.assert_allclose(got, want, atol=tol, rtol=tol,
                                       err_msg=k)


def run_side_by_side(m, temp, syncs_per_step=1, **kw):
    """Step a reference and a port instance with the same drafts until
    every request finishes; every step's tokens, accept counts and
    logprobs equal, ``syncs_per_step`` host syncs per step, the same step
    kinds, and the recurrent caches equal at the end."""
    oracle = oracle_stream(m, temp)
    ref, port = pair(m, **kw)
    j0 = dict(ref.steps.invocations_by_kind)     # the shared JAX steps'
    jseqs, tseqs = seqs(JSeq, temp), seqs(EngineSeq, temp)
    jslots = [ref.admit(s) for s in jseqs]
    tslots = [port.admit(s) for s in tseqs]
    assert jslots == tslots
    it = accepted = rejected = 0
    while not all(s.finished for s in tseqs):
        d = drafts(tseqs, tslots, oracle, it, m.tcfg.vocab_size)
        h0 = port.steps.host_syncs
        got = port.commit_step(port.dispatch_step(d))
        assert port.steps.host_syncs == h0 + syncs_per_step
        want = ref.run_step(d)
        compare_results(want, got)
        for slot, (_, _, a) in got.items():
            accepted += a
            rejected += a < len(d.get(slot, []))
        it += 1
        assert it < 200
    for js, ts in zip(jseqs, tseqs):
        assert js.generated == ts.generated
    assert dict(port.steps.invocations_by_kind) == {
        k: n - j0.get(k, 0) for k, n in ref.steps.invocations_by_kind.items()
        if n > j0.get(k, 0)}
    compare_caches(ref.cache, port.cache)
    assert accepted > 0 and rejected > 0
    return port


def _np_blob(blob):
    return types.SimpleNamespace(
        req_id=blob.req_id, next_pos=blob.next_pos, nbytes=blob.nbytes,
        checksum=blob.checksum,
        arrays={k: np.asarray(v) for k, v in blob.arrays.items()})


def blobs_cross(m, temp, migration_mode):
    """Blobs exported by each side carry the other's header CRC, nbytes
    and contents (recurrent state and cross-attention memory whole); the
    reference's blob resumes in the port as in the reference, and the
    port's in the reference.  A VLM or audio blob resumes on instances
    built on other embeddings (the slots' order reversed), so the
    resumed stream holds only if the import wrote the blob's memory."""
    kw = dict(migration_mode=migration_mode)
    ref, port = pair(m, **kw)
    js, ts = seqs(JSeq, temp, n=20)[1], seqs(EngineSeq, temp, n=20)[1]
    ref.admit(js)
    port.admit(ts)
    while len(ts.generated) < 6:
        port.run_step()
        ref.run_step()
    assert ts.generated == js.generated

    def export(inst):
        if migration_mode == "batched":
            inst.release_async(0)
            (blob,) = inst.flush_exports().values()
            return blob.stamp_checksum()
        return inst.release(0).stamp_checksum()

    jb, tb = export(ref), export(port)
    assert tb.header_crc() == jb.header_crc() and tb.nbytes == jb.nbytes
    assert set(tb.arrays) == set(jb.arrays)
    if n_ssm_layers(m.tcfg):
        assert {"ssm", "conv"} <= set(tb.arrays)
    other = None
    if n_cross_layers(m.tcfg):
        assert {"cross_k", "cross_v"} <= set(tb.arrays)
        other = np.ascontiguousarray(m.embeds[::-1])
    for k, v in jb.arrays.items():
        np.testing.assert_allclose(to_numpy(tb.arrays[k]), np.asarray(
            v, np.float32), atol=1e-4, rtol=1e-4, err_msg=k)

    def resume(inst, cls, blob):
        seq = cls(js.req_id, js.group_id, list(js.prompt), seed=js.seed,
                  temperature=temp, max_new_tokens=20)
        seq.generated, seq.logprobs = list(js.generated), list(js.logprobs)
        seq.last_token, seq.next_pos = js.last_token, js.next_pos
        inst.admit(seq, blob)
        while not seq.finished:
            inst.run_step()
        return seq.generated

    ref2, port2 = pair(m, other, **kw)
    want = resume(ref2, JSeq, jb)
    got = resume(port2, EngineSeq, blob_from_jax(_np_blob(jb), device="cpu"))
    assert got == want and len(got) == 20
    # the port's blob, read back by the reference
    tnp = types.SimpleNamespace(
        req_id=tb.req_id, next_pos=tb.next_pos, nbytes=tb.nbytes,
        checksum=tb.checksum,
        arrays={k: jax.numpy.asarray(to_numpy(v))
                for k, v in tb.arrays.items()})
    ref3, _ = pair(m, other, **kw)
    tblob_in_ref = type(jb)(tnp.req_id, tnp.arrays, tnp.next_pos,
                            tnp.nbytes, tnp.checksum)
    assert tblob_in_ref.header_crc() == jb.header_crc()
    assert resume(ref3, JSeq, tblob_in_ref) == want


def rollout_summary(ro, res):
    st = res.stats
    return {"responses": res.responses(), "steps": st.steps,
            "tokens": st.tokens, "chunks": st.chunks,
            "migrations": st.migrations, "drafted": st.drafted,
            "accepted": st.accepted, "host_syncs": ro.steps.host_syncs,
            "kinds": dict(ro.steps.invocations_by_kind)}


def rollout_matches(m, temp, **kw):
    gkw = dict(group_size=2, max_new_tokens=20, seed=5, temperature=temp)
    prompts = [p[:10] for p in PROMPTS]
    jro = JRollout(m.jcfg, m.jp, **ROLLOUT, **kw)
    tro = SeerRollout(m.tcfg, m.tp, device="cpu", **ROLLOUT, **kw)
    want = rollout_summary(jro, jro.run(jmake_groups(prompts, **gkw)))
    res = tro.run(make_groups(prompts, **gkw))
    got = rollout_summary(tro, res)
    assert got == want
    assert all(g.all_finished for g in res.groups)
    assert got["migrations"] > 0
    return tro


def snapshot(inst):
    """A copy of ``inst`` sharing nothing the next step writes."""
    shadow = copy.copy(inst)
    shadow.cache = clone_cache(inst.cache)
    shadow.slots = [copy.deepcopy(x) for x in inst.slots]
    shadow.steps = StepFunctions(inst.cfg)
    return shadow


def fused_vs_sync(m, spec_mode, temp=1.0):
    """Once the prompts are prefilled (the fused path packs the pending
    token behind a slot's last prefill chunk, the linear oracle does
    not), at every step the fused step against the sync oracle run on a
    snapshot of the same state: the same tokens and accept counts and a
    bitwise equal cache (``ssm``, ``conv``, K/V, ``slot_pos``).  Returns
    (steps, fused replays)."""
    oracle = oracle_stream(m, temp)
    _, inst = pair(m, spec_mode=spec_mode)
    tseqs = seqs(EngineSeq, temp)
    slots = [inst.admit(s) for s in tseqs]
    while inst.prefilling_slots():
        inst.run_step()
    it = 0
    while not all(s.finished for s in tseqs):
        d = drafts(tseqs, slots, oracle, it, m.tcfg.vocab_size)
        shadow = snapshot(inst)
        want = shadow._run_step_sync(d)
        got = inst.commit_step(inst.dispatch_step(d))
        assert {i: (t, a) for i, (t, _, a) in got.items()} == \
            {i: (t, a) for i, (t, _, a) in want.items()}, it
        for k, t in inst.cache.items():
            assert torch.equal(t, shadow.cache[k]), (it, k)
        it += 1
        assert it < 200
    return it, inst.steps.replays


# ------------------------------------------------ branching draft trees ----


def oracle_streams(m, temp, n=16):
    """Every request's tokens from a draft-free reference run."""
    ref, _ = pair(m)
    ss = seqs(JSeq, temp, n)
    for s in ss:
        ref.admit(s)
    while not all(s.finished for s in ss):
        ref.run_step()
    return [s.generated for s in ss]


def branch_paths(tseqs, streams, vocab):
    """slot -> [bad, good] draft paths: ``good`` continues the no-draft
    stream, ``bad`` is it perturbed (the trunk, rank 0)."""
    out = {}
    for i, s in enumerate(tseqs):
        good = streams[i][len(s.generated):len(s.generated) + 2]
        if s.finished or s.prefilling or not good:
            continue
        out[i] = [[(x + 7) % vocab for x in good], good]
    return out


def tree_side_by_side(m, temp):
    """Branching ``[bad, good]`` drafts through reference and port
    tree-mode instances: the same tokens, logprobs and accept counts at
    every step, one host sync per fused step, accepts along the side
    branch, and the same step kinds and tree counters."""
    streams = oracle_streams(m, temp)
    ref, port = pair(m, spec_mode="tree")
    j0 = dict(ref.steps.invocations_by_kind)
    jseqs, tseqs = seqs(JSeq, temp), seqs(EngineSeq, temp)
    assert [ref.admit(s) for s in jseqs] == [port.admit(s) for s in tseqs]
    rescues = 0
    while not all(s.finished for s in tseqs):
        paths = branch_paths(tseqs, streams, m.tcfg.vocab_size)
        h0 = port.steps.host_syncs
        got = port.commit_step(port.dispatch_step(
            {i: build_token_tree(p) for i, p in paths.items()}))
        assert port.steps.host_syncs == h0 + 1
        want = ref.run_step({i: jbuild_token_tree(p)
                             for i, p in paths.items()})
        compare_results(want, got)
        for i, (toks, _, a) in got.items():
            if a and i in paths and toks[:a] == paths[i][1][:a]:
                rescues += 1
        assert port.steps.invocations < 100
    assert [s.generated for s in tseqs] == [s.generated for s in jseqs]
    assert rescues > 0
    assert dict(port.steps.invocations_by_kind) == {
        k: n - j0.get(k, 0) for k, n in ref.steps.invocations_by_kind.items()
        if n > j0.get(k, 0)}
    for name in ("tree_steps", "tree_nodes", "tree_branch_nodes"):
        assert getattr(port, name) == getattr(ref, name) > 0, name
    compare_caches(ref.cache, port.cache)


def fused_tree_vs_sync(m, temp=1.0):
    """At every step the sync oracle's tree step, run on a snapshot of
    the instance, commits what the fused tree step commits and leaves the
    same ``slot_pos`` and bitwise equal K/V at every committed slot.
    Returns the tokens accepted."""
    streams = oracle_streams(m, temp)
    _, inst = pair(m, spec_mode="tree")
    tseqs = seqs(EngineSeq, temp)
    for s in tseqs:
        inst.admit(s)
    accepted = 0
    while not all(s.finished for s in tseqs):
        drafts = {i: build_token_tree(p) for i, p in
                  branch_paths(tseqs, streams, m.tcfg.vocab_size).items()}
        shadow = snapshot(inst)
        want = shadow._run_step_sync_tree(drafts)
        got = inst.run_step(drafts)
        assert {i: (t, a) for i, (t, _, a) in got.items()} == \
            {i: (t, a) for i, (t, _, a) in want.items()}
        sp = inst.cache["slot_pos"]
        assert torch.equal(sp, shadow.cache["slot_pos"])
        live = sp >= 0
        for k in ("k", "v"):
            assert torch.equal(inst.cache[k][:, live],
                               shadow.cache[k][:, live])
        accepted += sum(a for _, _, a in got.values())
        assert inst.steps_run < 100
    return accepted


# ------------------------------------------------ model-level parity ----

# tolerances of tests/test_torch_model.py
MODEL_TOL = {"float32": 1e-5, "bfloat16": 3e-2}


def model_pair(arch, dtype, **over):
    """The reference's tiny config (with ``over``) and weights at
    ``dtype`` and the port's (bridged) beside them."""
    jcfg = replace(jget_tiny(arch), dtype=dtype, **over)
    tcfg = replace(get_tiny_config(arch), dtype=dtype, **over)
    jp, _ = jinit_params(jcfg, jax.random.PRNGKey(1))
    tp = params_from_jax(tcfg, jax.tree.map(np.asarray, jp), device="cpu")
    return types.SimpleNamespace(jcfg=jcfg, jp=jp, tcfg=tcfg, tp=tp)


def both(a, dtype):
    """A numpy array as a JAX array and a tensor of ``dtype``, rounded
    the same way."""
    return (jax.numpy.asarray(a, jax.numpy.dtype(dtype)),
            to_tensor(a, torch.device("cpu"), torch_dtype(dtype)))


def close(got, want, tol, err_msg="", of_scale=False):
    """|got - want| <= tol * (|want| + 1) elementwise; with ``of_scale``
    the absolute part is tol * max(1, max |want|), the tensor's own scale
    (a MoE layer's outputs reach ~100 and nearly cancel in places, so
    rounding at the terms' scale is far above an element's own
    tolerance there)."""
    want = np.asarray(want, np.float32)
    got = got if isinstance(got, np.ndarray) else to_numpy(got)
    atol = tol * max(1.0, float(np.abs(want).max())) if of_scale else tol
    np.testing.assert_allclose(np.asarray(got, np.float32), want,
                               atol=atol, rtol=tol, err_msg=err_msg)


def forward_steps(vocab, long=False, seed=0):
    """(tokens, positions, mask) for B = 3 rows: padded prefill chunks (a
    row half padded, a row all padding), a decode step and a verify step;
    with ``long`` the prefill runs past a 64-slot ring."""
    rng = np.random.default_rng(seed)
    B = 3
    chunks = [(24, [24, 20, 0]), (24, [24, 24, 10]), (24, [24, 24, 24])] \
        if long else [(8, [8, 5, 0])]
    steps, start = [], np.zeros(B, np.int64)
    for T, n in chunks + [(1, [1, 1, 1]), (4, [3, 4, 4])]:
        tok = rng.integers(0, vocab, (B, T)).astype(np.int32)
        pos = (start[:, None] + np.arange(T)[None]).astype(np.int32)
        mask = np.arange(T)[None] < np.asarray(n)[:, None]
        steps.append((tok, pos, mask))
        start += np.asarray(n)
    return steps


def _caches(m, dtype, B, S):
    """Reference and port caches whose cross-attention memory each
    package built from the same seeded embeddings."""
    je, te = both(random_embeds(m.tcfg, B, seed=4), dtype)
    jc = jinit_cache(m.jcfg, B, S)
    jc["cross_k"], jc["cross_v"] = jbuild_cross_cache(m.jcfg, m.jp, je)
    tc = init_cache(m.tcfg, B, S, device="cpu")
    tc["cross_k"], tc["cross_v"] = build_cross_cache(m.tcfg, m.tp, te)
    return jc, tc


def forward_matches(m, dtype, S=32):
    """A padded prefill chunk, a decode and a verify step on caches
    holding the same cross-attention memory: logits and every cache leaf
    (``cross_k`` / ``cross_v`` included) within ``MODEL_TOL``,
    ``slot_pos`` exact."""
    tol = MODEL_TOL[dtype]
    jc, tc = _caches(m, dtype, 3, S)
    compare_caches(jc, tc, tol)
    for tok, pos, mask in forward_steps(m.tcfg.vocab_size):
        lj, jc, _ = jforward(m.jcfg, m.jp, jax.numpy.asarray(tok),
                             jax.numpy.asarray(pos), jc,
                             token_mask=jax.numpy.asarray(mask))
        lt, tc2, _ = forward(m.tcfg, m.tp, torch.from_numpy(tok),
                             torch.from_numpy(pos), tc,
                             token_mask=torch.from_numpy(mask))
        assert tc2 is tc                 # updated in place
        close(lt, lj, tol)
        compare_caches(jc, tc, tol)


def cross_sublayers(m):
    """A VLM's or an audio model's decoder sub-layers in order, for
    ``forward_layers_match_bf16``: a dense layer or self-attention on K/V
    layer i (``dense``, ``self``), a cross block on memory layer i
    (``cross``), an MLP (``mlp``)."""
    def jat(tree, *idx):
        return jax.tree.map(lambda a: a[idx], tree)
    out = []
    if m.tcfg.arch_type == "vlm":
        every = m.tcfg.cross_attn_every
        for c, cell in enumerate(m.tp["cells"]):
            for j, p in enumerate(cell["self"]):
                out.append((f"cell {c} layer {j}", "dense",
                            jat(m.jp["cells"]["self"], c, j), p,
                            c * every + j))
            out.append((f"cell {c} cross", "cross",
                        jat(m.jp["cells"]["cross"], c), cell["cross"], c))
        return out
    dec = m.jp["dec_layers"]
    for i, p in enumerate(m.tp["dec_layers"]):
        out += [(f"layer {i} attn", "self", jat(dec["attn"], i), p["attn"],
                 i),
                (f"layer {i} cross", "cross", jat(dec["cross"], i),
                 p["cross"], i),
                (f"layer {i} mlp", "mlp", jat(dec["mlp"], i), p["mlp"], i)]
    return out


def _sublayer_pair(m, kind, pj, pt, x, tc, i, targs, jargs):
    """One sub-layer of each package on the same bf16 input ``x``: (port
    output, reference output, [(leaf, port K/V, reference K/V)], (port
    aux, reference aux))."""
    def j(t):
        return jax.numpy.asarray(to_numpy(t), jax.numpy.bfloat16)
    xj = j(x)
    if kind == "cross":
        mem = (tc["cross_k"][i], tc["cross_v"][i])
        return (ttr._cross_attn(pt, x, m.tcfg, *mem),
                jtr._cross_attn(pj, xj, m.jcfg, tuple(map(j, mem)),
                                True)[0], [], (0.0, 0.0))
    if kind == "mlp":
        return (ttr._mlp(pt, x, m.tcfg), jtr._mlp(pj, xj, m.jcfg), [],
                (0.0, 0.0))
    tkv = (tc["k"][i], tc["v"][i], tc["slot_pos"])
    jkv = (j(tc["k"][i]), j(tc["v"][i]))
    jpos, jslots, jsp, jmask = jargs
    aux = (0.0, 0.0)
    if kind == "moe":
        xt, at = ttr._moe_layer(pt, x, m.tcfg, *targs, *tkv)
        yj, nk, nv, aj = jtr._moe_layer(pj, xj, m.jcfg, jpos, jslots, *jkv,
                                        jsp, jmask, None)
        aux = (float(at), float(aj))
    else:
        fn = {"dense": "_dense_layer", "self": "_self_attn"}[kind]
        xt = getattr(ttr, fn)(pt, x, m.tcfg, *targs, *tkv)
        yj, nk, nv = getattr(jtr, fn)(pj, xj, m.jcfg, jpos, jslots, *jkv,
                                      jsp, jmask)
    return xt, yj, [("k", tc["k"][i], nk), ("v", tc["v"][i], nv)], aux


def forward_layers_match_bf16(m, sublayers, S=32, long=False, seed=0,
                              of_scale=False):
    """bf16, sub-layer by sub-layer over ``forward_steps(long, seed)`` on
    a cache of S slots (a ring of S on a sliding window; a VLM's or an
    audio model's holding the cross memory both packages built from the
    same seeded embeddings): each of the reference's ``sublayers`` (name,
    kind, reference params, port params, cache layer; kind ``dense``,
    ``moe``, ``self``, ``cross`` or ``mlp``) runs eagerly on the port's
    own hidden state and cache in front of it, and the port's must give
    the same output, K/V and summed aux within 3e-2 (``close``, of the
    tensor's scale with ``of_scale``); so must the final norm and
    unembed."""
    tol = MODEL_TOL["bfloat16"]
    jnp = jax.numpy
    B = 3
    if m.tcfg.arch_type in ("vlm", "audio"):
        _, tc = _caches(m, "bfloat16", B, S)
    else:
        tc = init_cache(m.tcfg, B, S, device="cpu")
    Sc, ring = tc["slot_pos"].shape[1], bool(m.tcfg.sliding_window)
    for tok, pos, mask in forward_steps(m.tcfg.vocab_size, long, seed):
        t_pos, t_mask = torch.from_numpy(pos), torch.from_numpy(mask)
        jpos, jmask = jnp.asarray(pos), jnp.asarray(mask)
        # the step's slots and slot positions, as both forwards make them
        jslots = jnp.where(jmask, jpos % Sc if ring else jpos, Sc)
        jsp = jnp.asarray(to_numpy(tc["slot_pos"])).at[
            jnp.arange(B)[:, None], jslots].set(jpos, mode="drop")
        slots = t_pos.long() % Sc if ring else t_pos.long()
        slots = torch.where((slots < Sc) & t_mask, slots, Sc)
        bidx = torch.arange(B)[:, None]
        with_scratch(tc["slot_pos"], 1)[bidx, slots] = t_pos
        np.testing.assert_array_equal(to_numpy(tc["slot_pos"]),
                                      np.asarray(jsp))
        x = m.tp["embed"][torch.from_numpy(tok).long()].to(torch.bfloat16)
        aux_t, aux_j = 0.0, 0.0
        for name, kind, pj, pt, i in sublayers:
            xt, yj, kv, (at, aj) = _sublayer_pair(
                m, kind, pj, pt, x, tc, i, (t_pos, bidx, slots),
                (jpos, jslots, jsp, jmask))
            aux_t, aux_j = aux_t + at, aux_j + aj
            close(to_numpy(xt)[mask], np.asarray(yj, np.float32)[mask], tol,
                  name, of_scale)
            for leaf, t, want in kv:
                close(t, want, tol, f"{name} {leaf}", of_scale)
            x = xt
        assert abs(aux_t - aux_j) <= tol * abs(aux_j)
        w = m.jp["embed"].T if m.jcfg.tie_embeddings else m.jp["unembed"]
        lj = jtr.rms_norm(jnp.asarray(to_numpy(x), jnp.bfloat16),
                          m.jp["final_ln"], m.jcfg.rms_eps) @ \
            w.astype(jnp.bfloat16)
        lt = ttr._unembed(m.tcfg, m.tp, x)
        close(to_numpy(lt)[mask], np.asarray(lj, np.float32)[mask], tol,
              "unembed", of_scale)


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, path + (k,))
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _leaves(v, path + (i,))
    else:
        yield path, tree


def init_tree_matches(mp):
    """The port's own init has the bridged reference's tree, dtypes and
    scales, and is a pure function of the generator's seed; the bridge
    carries every element of the reference's stacked tree."""
    a = init_params(mp.tcfg, torch.Generator().manual_seed(3), device="cpu")
    b = dict(_leaves(init_params(mp.tcfg, torch.Generator().manual_seed(3),
                                 device="cpu")))
    ref = dict(_leaves(mp.tp))
    got = dict(_leaves(a))
    assert sorted(got, key=str) == sorted(ref, key=str)
    assert sum(t.numel() for t in ref.values()) == sum(
        np.size(x) for x in jax.tree.leaves(mp.jp))
    for key, t in got.items():
        r = ref[key]
        assert t.shape == r.shape and t.dtype == r.dtype, key
        assert torch.equal(t, b[key]), key
        ts, rs = t.float().std().item(), r.float().std().item()
        assert abs(ts - rs) <= 0.15 * rs + 1e-6, (key, ts, rs)
    return a


def modality_stub_matches(mp, name):
    """The zero frontend stub: the reference's key, shape and dtype."""
    (want,) = jmodality_inputs(mp.jcfg, 2).values()
    got = modality_inputs(mp.tcfg, 2, device="cpu")
    assert list(got) == [name]
    assert tuple(got[name].shape) == want.shape == \
        (2, cross_len(mp.tcfg), mp.tcfg.d_model)
    assert got[name].dtype == torch_dtype(mp.tcfg.dtype)
    assert not got[name].any()


def first_cross_block(mp):
    """(reference params, port params) of the first cross block."""
    if mp.tcfg.arch_type == "vlm":
        return (jax.tree.map(lambda a: a[0], mp.jp["cells"]["cross"]),
                mp.tp["cells"][0]["cross"])
    return (jax.tree.map(lambda a: a[0], mp.jp["dec_layers"]["cross"]),
            mp.tp["dec_layers"][0]["cross"])


def cross_attn_matches(mp, dtype):
    """One cross block on seeded hidden states against the reference's
    call on the memory itself: the port's K/V of the memory
    (``_cross_kv``), and its block over those K/V and over the
    reference's."""
    tol = MODEL_TOL[dtype]
    rng = np.random.default_rng(2)
    jx, tx = both(rng.normal(size=(3, 5, mp.tcfg.d_model)), dtype)
    je, te = both(random_embeds(mp.tcfg, 3, seed=1), dtype)
    jp, tp = first_cross_block(mp)
    want, jk, jv = jtr._cross_attn(jp, jx, mp.jcfg, je, False)
    k, v = ttr._cross_kv(tp, te, mp.tcfg)
    close(k, jk, tol)
    close(v, jv, tol)
    close(ttr._cross_attn(tp, tx, mp.tcfg, k, v), want, tol)
    tk, tv = (to_tensor(np.asarray(a, np.float32), torch.device("cpu"),
                        te.dtype) for a in (jk, jv))
    close(ttr._cross_attn(tp, tx, mp.tcfg, tk, tv), want, tol)


def build_cross_cache_matches(mp, dtype):
    """K/V of every cross block from seeded embeddings (an audio model's
    through its encoder), in ``cfg.dtype``.  An audio model in bf16 is
    held stage by stage: the reference's K/V projected from the port's
    encoder output (the encoder is held on its own), as the reference's
    own jitted and eager bf16 encoders give K/V more than 3e-2 apart."""
    je, te = both(random_embeds(mp.tcfg, 3, seed=1), dtype)
    tk, tv = build_cross_cache(mp.tcfg, mp.tp, te)
    if mp.tcfg.arch_type == "audio" and dtype == "bfloat16":
        mem = jax.numpy.asarray(to_numpy(ttr.encode_audio(mp.tcfg, mp.tp,
                                                          te)), je.dtype)
        shape = mem.shape[:2] + (mp.tcfg.num_kv_heads, mp.tcfg.head_dim)
        blocks = [jax.tree.map(lambda a: a[i], mp.jp["dec_layers"]["cross"])
                  for i in range(mp.tcfg.num_layers)]
        jk, jv = (jax.numpy.stack([jtr.lin(mem, p[w]).reshape(shape)
                                   for p in blocks]) for w in ("wk", "wv"))
    else:
        jk, jv = jbuild_cross_cache(mp.jcfg, mp.jp, je)
    assert tuple(tk.shape) == jk.shape == (
        n_cross_layers(mp.tcfg), 3, cross_len(mp.tcfg),
        mp.tcfg.num_kv_heads, mp.tcfg.head_dim)
    assert tk.dtype == tv.dtype == torch_dtype(dtype)
    close(tk, jk, MODEL_TOL[dtype])
    close(tv, jv, MODEL_TOL[dtype])
