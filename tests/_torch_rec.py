"""Shared harness of the port's SSM, hybrid and MoE parity tests
(``test_torch_ssm.py``, ``test_torch_hybrid.py``,
``test_torch_moe_engine.py``): the reference's weights carried over by
the bridge, port and reference ``Instance``s stepped side by side with
the same drafts (chains, or branching trees on attention-only models),
KV blobs crossing between the two, and a fused step held against the
sync oracle run on a snapshot of the same instance.  Everything at f32
on the CPU."""
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
from repro.models import init_params as jinit_params
from repro_torch.bridge import blob_from_jax, params_from_jax, to_numpy
from repro_torch.configs import get_tiny_config
from repro_torch.core import SeerRollout, make_groups
from repro_torch.engine import (EngineSeq, Instance, StepFunctions,
                                build_token_tree)
from repro_torch.models.transformer import clone_cache, n_ssm_layers

PROMPTS = [[5, 9, 2, 7, 1], list(range(3, 16)), [40 + i for i in range(20)]]
INST = dict(max_slots=3, cache_len=64, prefill_chunk=8, gamma_max=4,
            base_seed=7)
ROLLOUT = dict(n_instances=2, max_slots=2, cache_len=128, chunk_size=8,
               policy="seer", spec_decode=True, prefill_chunk=4)


def load_models(arch, **over):
    """(jcfg, jax params, port cfg, port params, shared JAX steps) at f32;
    the JAX StepFunctions is shared so its jitted steps compile once."""
    jcfg = replace(jget_tiny(arch), dtype="float32", **over)
    tcfg = replace(get_tiny_config(arch), dtype="float32", **over)
    jp, _ = jinit_params(jcfg, jax.random.PRNGKey(1))
    tp = params_from_jax(tcfg, jax.tree.map(np.asarray, jp), device="cpu")
    return types.SimpleNamespace(jcfg=jcfg, jp=jp, tcfg=tcfg, tp=tp,
                                 jsteps=JSteps(jcfg))


def pair(m, **kw):
    kw = dict(INST, **kw)
    return (JInstance(m.jcfg, m.jp, m.jsteps, **kw),
            Instance(m.tcfg, m.tp, StepFunctions(m.tcfg), device="cpu", **kw))


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
    and contents (recurrent leaves whole); the reference's blob resumes
    in the port as in the reference, and the port's in the reference."""
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

    ref2, port2 = pair(m, **kw)
    want = resume(ref2, JSeq, jb)
    got = resume(port2, EngineSeq, blob_from_jax(_np_blob(jb), device="cpu"))
    assert got == want and len(got) == 20
    # the port's blob, read back by the reference
    tnp = types.SimpleNamespace(
        req_id=tb.req_id, next_pos=tb.next_pos, nbytes=tb.nbytes,
        checksum=tb.checksum,
        arrays={k: jax.numpy.asarray(to_numpy(v))
                for k, v in tb.arrays.items()})
    ref3, _ = pair(m, **kw)
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
