"""The port's sync oracle and per-slot migration against the JAX package,
and ``SeerRollout`` in tree and sync modes, on granite-3-8b tiny at f32
with the reference's weights: ``prefill_mode="sync"`` instances stepped
side by side token-exact with two host syncs per step; per-slot KV blobs
with the reference's header CRC, ``nbytes`` and migration counters, that
resume token-exact across the two; whole rollouts with equal responses,
steps, migrations and tree counters."""
import types
from dataclasses import replace

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_tiny_config as jget_tiny
from repro.core import SeerRollout as JRollout
from repro.core import make_groups as jmake_groups
from repro.engine import EngineSeq as JSeq
from repro.engine import Instance as JInstance
from repro.engine import StepFunctions as JSteps
from repro.engine import build_token_tree as jbuild_token_tree
from repro.models import init_params as jinit_params
from repro_torch.bridge import blob_from_jax, params_from_jax
from repro_torch.configs import get_tiny_config
from repro_torch.core import SeerRollout, make_groups
from repro_torch.engine import (EngineSeq, Instance, StepFunctions,
                                build_token_tree)

torch.set_num_threads(2)
ARCH = "granite-3-8b"
VOCAB = 512
PROMPTS = [[5, 9, 2, 7, 1], list(range(3, 16)), [40 + i for i in range(20)]]
INST = dict(max_slots=3, cache_len=64, prefill_chunk=8, gamma_max=4,
            base_seed=7)


@pytest.fixture(scope="module")
def models():
    jcfg = replace(jget_tiny(ARCH), dtype="float32")
    tcfg = replace(get_tiny_config(ARCH), dtype="float32")
    jp, _ = jinit_params(jcfg, jax.random.PRNGKey(1))
    tp = params_from_jax(tcfg, jax.tree.map(np.asarray, jp), device="cpu")
    return jcfg, jp, tcfg, tp


def _seqs(cls, temp, n=16):
    return [cls(f"r{i}", "g0", list(p), seed=11 + i, temperature=temp,
                max_new_tokens=n) for i, p in enumerate(PROMPTS)]


def _drafts(seqs, it):
    """Draft paths per decoding slot: the last token repeated (often
    accepted by the tiny model) and, every other step, a second path."""
    out = {}
    for i, s in enumerate(seqs):
        if s.finished or s.prefilling or not s.generated:
            continue
        g = s.generated[-1]
        out[i] = [[g, g], [(g + 3) % VOCAB]] if it % 2 else [[g, g, g]]
    return out


@pytest.mark.parametrize("spec_mode,temp", [("linear", 0.0),
                                            ("tree", 1.0)])
def test_sync_instances_token_exact(models, spec_mode, temp):
    """``prefill_mode="sync"``: admit-time prefill, acceptance on the
    host, the same tokens as the reference at every step, two host syncs
    per step and the same step kinds (``prefill``, ``step``,
    ``tree_ref``)."""
    jcfg, jp, tcfg, tp = models
    ref = JInstance(jcfg, jp, JSteps(jcfg), prefill_mode="sync",
                    spec_mode=spec_mode, **INST)
    port = Instance(tcfg, tp, StepFunctions(tcfg), device="cpu",
                    prefill_mode="sync", spec_mode=spec_mode, **INST)
    assert port.migration_mode == ref.migration_mode == "perslot"
    assert not port.admit_into_draining
    jseqs, tseqs = _seqs(JSeq, temp), _seqs(EngineSeq, temp)
    assert [ref.admit(s) for s in jseqs] == [port.admit(s) for s in tseqs]
    assert port.prefill_tokens == ref.prefill_tokens > 0
    it = 0
    while not all(s.finished for s in tseqs):
        paths = _drafts(tseqs, it)
        if spec_mode == "tree":
            td = {i: build_token_tree(p) for i, p in paths.items()}
            jd = {i: jbuild_token_tree(p) for i, p in paths.items()}
        else:
            td = jd = {i: p[0] for i, p in paths.items()}
        h0 = port.steps.host_syncs
        got = port.commit_step(port.dispatch_step(td))
        assert port.steps.host_syncs == h0 + 2
        want = ref.run_step(jd)
        assert sorted(got) == sorted(want)
        for i in got:
            assert got[i][0] == want[i][0] and got[i][2] == want[i][2]
            np.testing.assert_allclose(got[i][1], want[i][1], atol=1e-5)
        it += 1
        assert it < 100
    assert [s.generated for s in tseqs] == [s.generated for s in jseqs]
    assert dict(port.steps.invocations_by_kind) == \
        dict(ref.steps.invocations_by_kind)
    assert port.steps.host_syncs == ref.steps.host_syncs
    assert (port.tree_nodes, port.tree_branch_nodes) == \
        (ref.tree_nodes, ref.tree_branch_nodes)
    if spec_mode == "tree":
        assert port.steps.invocations_by_kind.get("tree_ref:5", 0) > 0


def _np_blob(blob):
    return types.SimpleNamespace(
        req_id=blob.req_id, next_pos=blob.next_pos, nbytes=blob.nbytes,
        checksum=blob.checksum,
        arrays={k: np.asarray(v) for k, v in blob.arrays.items()})


@pytest.mark.parametrize("temp", [0.0, 1.0])
def test_perslot_blobs_cross_token_exact(models, temp):
    """Per-slot export from each side has the other's header CRC and
    ``nbytes``; a reference blob imported per-slot into the port resumes
    as it resumes in the reference; the per-slot migration counters
    match."""
    jcfg, jp, tcfg, tp = models
    kw = dict(INST, migration_mode="perslot")
    src = {"ref": JInstance(jcfg, jp, JSteps(jcfg), **kw),
           "port": Instance(tcfg, tp, StepFunctions(tcfg), device="cpu",
                            **kw)}
    seqs = {"ref": _seqs(JSeq, temp, n=20)[1],
            "port": _seqs(EngineSeq, temp, n=20)[1]}
    blobs = {}
    for side, inst in src.items():
        assert not inst.admit_into_draining
        inst.admit(seqs[side])
        while len(seqs[side].generated) < 6:
            inst.run_step()
        with pytest.raises(RuntimeError, match="migration_mode='batched'"):
            inst.release_async(0)
        blobs[side] = inst.release(0).stamp_checksum()
    assert seqs["port"].generated == seqs["ref"].generated
    assert blobs["port"].header_crc() == blobs["ref"].header_crc()
    assert blobs["port"].nbytes == blobs["ref"].nbytes
    assert src["port"].steps.migration_calls_by_kind == \
        src["ref"].steps.migration_calls_by_kind

    s = seqs["ref"]

    def resume(inst, cls, blob):
        seq = cls(s.req_id, s.group_id, list(s.prompt), seed=s.seed,
                  temperature=temp, max_new_tokens=20)
        seq.generated, seq.logprobs = list(s.generated), list(s.logprobs)
        seq.last_token, seq.next_pos = s.last_token, s.next_pos
        inst.admit(seq, blob)
        while not seq.finished:
            inst.run_step()
        return seq.generated

    ref = JInstance(jcfg, jp, JSteps(jcfg), **kw)
    port = Instance(tcfg, tp, StepFunctions(tcfg), device="cpu", **kw)
    want = resume(ref, JSeq, blobs["ref"])
    got = resume(port, EngineSeq,
                 blob_from_jax(_np_blob(blobs["ref"]), device="cpu"))
    assert got == want and len(got) == 20
    assert port.slots_imported == ref.slots_imported == 1
    assert port.steps.migration_calls_by_kind == \
        ref.steps.migration_calls_by_kind
    assert port.steps.migration_calls_by_kind["import_perslot"] > 0


def test_mode_checks(models):
    _, _, tcfg, tp = models
    for kw in ({"migration_mode": "perslot", "admit_into_draining": True},
               {"prefill_mode": "sync", "admit_into_draining": True},
               {"spec_mode": "dag"}, {"prefill_mode": "eager"},
               {"migration_mode": "lazy"}):
        with pytest.raises(ValueError):
            Instance(tcfg, tp, StepFunctions(tcfg), device="cpu", **kw)


# the reference's tree micro-benchmark regime (bench_engine_tree): a
# 12-token vocabulary and a 2-token CST lookup, so the group's suffix tree
# offers several continuations and the drafts branch
SMALL_VOCAB = 12
ROLLOUT = dict(n_instances=2, max_slots=2, cache_len=128, chunk_size=8,
               policy="seer", spec_decode=True, prefill_chunk=4,
               base_seed=7, cst_lookup_max=2)
RO_PROMPTS = [[(13 * g + j) % (SMALL_VOCAB - 2) + 1 for j in range(10)]
              for g in range(2)]


@pytest.fixture(scope="module")
def small_models():
    jcfg = replace(jget_tiny(ARCH), dtype="float32", vocab_size=SMALL_VOCAB)
    tcfg = replace(get_tiny_config(ARCH), dtype="float32",
                   vocab_size=SMALL_VOCAB)
    jp, _ = jinit_params(jcfg, jax.random.PRNGKey(1))
    tp = params_from_jax(tcfg, jax.tree.map(np.asarray, jp), device="cpu")
    return jcfg, jp, tcfg, tp


def _summary(ro, res):
    st = res.stats
    return {"responses": res.responses(), "steps": st.steps,
            "tokens": st.tokens, "migrations": st.migrations,
            "chunks": st.chunks, "drafted": st.drafted,
            "accepted": st.accepted, "host_syncs": ro.steps.host_syncs,
            "kinds": dict(ro.steps.invocations_by_kind),
            "tree_nodes": sum(i.tree_nodes for i in ro.instances),
            "tree_branch_nodes": sum(i.tree_branch_nodes
                                     for i in ro.instances)}


MODES = {"tree": {"spec_mode": "tree", "multipath_top_k": 3},
         "sync": {"prefill_mode": "sync"},
         "sync-tree": {"prefill_mode": "sync", "spec_mode": "tree",
                       "multipath_top_k": 3}}


@pytest.mark.parametrize("mode", sorted(MODES))
def test_rollout_modes_match_reference(small_models, mode):
    """``SeerRollout`` with tree speculation (three draft paths), the sync
    oracle (per-slot migration), or both: the reference's responses,
    step, migration and tree counts, in a warm pass and in a second pass
    on the same groups after ``reset_acceptance_profile``, which drafts
    from the first pass's streams."""
    jcfg, jp, tcfg, tp = small_models
    kw = MODES[mode]
    gkw = dict(group_size=4, max_new_tokens=20, seed=5, temperature=1.0)
    jro = JRollout(jcfg, jp, **ROLLOUT, **kw)
    tro = SeerRollout(tcfg, tp, device="cpu", **ROLLOUT, **kw)
    migrations = accepted = 0
    for _ in range(2):
        want = _summary(jro, jro.run(jmake_groups(RO_PROMPTS, **gkw)))
        res = tro.run(make_groups(RO_PROMPTS, **gkw))
        got = _summary(tro, res)
        assert got == want
        assert all(g.all_finished for g in res.groups)
        migrations += got["migrations"]
        accepted += got["accepted"]
        jro.reset_acceptance_profile()
        tro.reset_acceptance_profile()
    assert migrations > 0 and accepted > 0
    assert (got["tree_branch_nodes"] > 0) == ("tree" in mode)
    syncs_per_step = 2 if mode.startswith("sync") else 1
    assert got["host_syncs"] == syncs_per_step * sum(
        n for k, n in got["kinds"].items() if not k.startswith("prefill"))
