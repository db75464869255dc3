"""The port's ``Instance`` against the JAX package's, stepped side by side
on granite-3-8b tiny at f32 with the reference's weights: token-exact at
temperatures 0 and 1 with drafts, one host sync per step, and KV blobs
that cross between the two (same header CRC, same ``nbytes``) and resume
token-exact."""
import types
from dataclasses import replace

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_tiny_config as jget_tiny
from repro.engine import EngineSeq as JSeq
from repro.engine import Instance as JInstance
from repro.engine import StepFunctions as JSteps
from repro.models import init_params as jinit_params
from repro_torch.bridge import blob_from_jax, blob_to_numpy, params_from_jax
from repro_torch.configs import get_tiny_config
from repro_torch.engine import EngineSeq, Instance, StepFunctions

torch.set_num_threads(2)
ARCH = "granite-3-8b"
PROMPTS = [[5, 9, 2, 7, 1], list(range(3, 16)), [40 + i for i in range(20)]]
INST = dict(max_slots=3, cache_len=64, prefill_chunk=8, gamma_max=4,
            base_seed=7)


@pytest.fixture(scope="module")
def models():
    out = {}
    for dtype in ("float32", "bfloat16"):
        jcfg = replace(jget_tiny(ARCH), dtype=dtype)
        tcfg = replace(get_tiny_config(ARCH), dtype=dtype)
        jp, _ = jinit_params(jcfg, jax.random.PRNGKey(1))
        tp = params_from_jax(tcfg, jax.tree.map(np.asarray, jp),
                             device="cpu")
        out[dtype] = (jcfg, jp, tcfg, tp)
    return out


def _pair(models, dtype="float32"):
    jcfg, jp, tcfg, tp = models[dtype]
    ref = JInstance(jcfg, jp, JSteps(jcfg), **INST)
    port = Instance(tcfg, tp, StepFunctions(tcfg), device="cpu", **INST)
    return ref, port


def _seqs(cls, temp, n=24):
    return [cls(f"r{i}", "g0", list(p), seed=11 + i, temperature=temp,
                max_new_tokens=n) for i, p in enumerate(PROMPTS)]


def _oracle(models, temp):
    """Seq 0's tokens from a draft-free reference run."""
    ref, _ = _pair(models)
    s = _seqs(JSeq, temp)[0]
    ref.admit(s)
    while not s.finished:
        ref.run_step()
    return s.generated


def _drafts(seqs, slots, oracle, it, vocab):
    """Oracle drafts for seq 0 (accepted), garbage for seq 1 every other
    step (rejected), none for seq 2."""
    out = {}
    s0, s1 = seqs[0], seqs[1]
    if not s0.finished and not s0.prefilling:
        k = len(s0.generated)
        out[slots[0]] = list(oracle[k:k + 3])
    if not s1.finished and not s1.prefilling and it % 2 and s1.generated:
        out[slots[1]] = [(s1.generated[-1] + 13) % vocab] * 2
    return out


def _compare(a, b):
    assert sorted(a) == sorted(b)
    for slot in a:
        ta, la, na = a[slot]
        tb, lb, nb = b[slot]
        assert ta == tb and na == nb, slot
        np.testing.assert_allclose(la, lb, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("temp", [0.0, 1.0])
def test_instances_token_exact(models, temp):
    oracle = _oracle(models, temp)
    ref, port = _pair(models)
    jseqs, tseqs = _seqs(JSeq, temp), _seqs(EngineSeq, temp)
    jslots = [ref.admit(s) for s in jseqs]
    tslots = [port.admit(s) for s in tseqs]
    assert jslots == tslots
    it, accepted, kinds = 0, 0, set()
    while not all(s.finished for s in tseqs):
        drafts = _drafts(tseqs, tslots, oracle, it, 512)
        h0 = port.steps.host_syncs
        ticket = port.dispatch_step(drafts)
        assert port.steps.host_syncs == h0
        got = port.commit_step(ticket)
        assert port.steps.host_syncs == h0 + 1
        want = ref.run_step(drafts)
        _compare(want, got)
        accepted += sum(v[2] for v in got.values())
        kinds.add(ticket.T)
        it += 1
        assert it < 200
    for js_, ts_ in zip(jseqs, tseqs):
        assert js_.generated == ts_.generated
        np.testing.assert_allclose(js_.logprobs, ts_.logprobs, atol=1e-5)
    assert accepted > 0 and len(kinds) >= 3, (accepted, kinds)
    assert dict(port.steps.invocations_by_kind) == \
        dict(ref.steps.invocations_by_kind)


def _np_blob(blob):
    return types.SimpleNamespace(
        req_id=blob.req_id, next_pos=blob.next_pos, nbytes=blob.nbytes,
        checksum=blob.checksum,
        arrays={k: np.asarray(v) for k, v in blob.arrays.items()})


def _run_until(inst, seqs, n_steps):
    for _ in range(n_steps):
        inst.run_step()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_exported_blobs_match(models, dtype):
    """release() (per-slot) and release_async()+flush_exports() (batched,
    overlapped with the next step) give blobs with the reference's
    header CRC, nbytes and contents."""
    ref, port = _pair(models, dtype)
    jseqs, tseqs = _seqs(JSeq, 1.0), _seqs(EngineSeq, 1.0)
    for s in jseqs:
        ref.admit(s)
    for s in tseqs:
        port.admit(s)
    _run_until(ref, jseqs, 6)
    _run_until(port, tseqs, 6)
    jb = {0: ref.release(0).stamp_checksum()}
    tb = {0: port.release(0).stamp_checksum()}
    ref.release_async(1)
    port.release_async(1)
    jt, tt = ref.dispatch_step(), port.dispatch_step()
    jb.update(enumerate(ref.flush_exports().values(), 1))
    tb.update(enumerate(port.flush_exports().values(), 1))
    ref.commit_step(jt)
    port.commit_step(tt)
    assert port.export_overlapped_slots == ref.export_overlapped_slots == 1
    tol = 1e-5 if dtype == "float32" else 3e-2
    for i in (0, 1):
        want, got = jb[i], tb[i]
        assert got.header_crc() == want.header_crc()
        assert got.nbytes == want.nbytes
        assert got.checksum == want.checksum
        g = blob_to_numpy(got)
        assert g["dtypes"]["k"] == dtype
        for k, v in want.arrays.items():
            np.testing.assert_allclose(g["arrays"][k],
                                       np.asarray(v, np.float32),
                                       atol=tol, rtol=tol)


@pytest.mark.parametrize("temp", [0.0, 1.0])
def test_reference_blob_resumes_in_port(models, temp):
    """A blob exported by a reference Instance, imported into a port
    Instance, continues token-exact with the reference resuming it."""
    jcfg, jp, tcfg, tp = models["float32"]
    src = JInstance(jcfg, jp, JSteps(jcfg), **INST)
    s = _seqs(JSeq, temp, n=20)[1]
    src.admit(s)
    while len(s.generated) < 6:
        src.run_step()
    blob = src.release(0).stamp_checksum()
    tblob = blob_from_jax(_np_blob(blob), device="cpu")
    assert tblob.header_crc() == blob.header_crc() == tblob.checksum
    assert tblob.nbytes == blob.nbytes

    def resume(inst, cls, b):
        seq = cls(s.req_id, s.group_id, list(s.prompt), seed=s.seed,
                  temperature=temp, max_new_tokens=20)
        seq.generated, seq.logprobs = list(s.generated), list(s.logprobs)
        seq.last_token, seq.next_pos = s.last_token, s.next_pos
        inst.admit(seq, b)
        while not seq.finished:
            inst.run_step()
        return seq.generated

    want = resume(JInstance(jcfg, jp, JSteps(jcfg), **INST), JSeq, blob)
    port = Instance(tcfg, tp, StepFunctions(tcfg), device="cpu", **INST)
    got = resume(port, EngineSeq, tblob)
    assert got == want and len(got) == 20
    assert port.slots_imported == 1


def test_takeover_cancel_and_crash_match(models):
    """Admission into a draining slot (takeover), cancelling a queued
    blob import and losing the instance go as in the reference."""
    ref, port = _pair(models)
    jseqs, tseqs = _seqs(JSeq, 1.0), _seqs(EngineSeq, 1.0)
    for inst, seqs in ((ref, jseqs), (port, tseqs)):
        for s in seqs:
            inst.admit(s)
        _run_until(inst, seqs, 4)
        inst.release_async(0)
    extra = {cls: cls("r9", "g1", [7, 8, 9], seed=3, temperature=1.0,
                      max_new_tokens=8) for cls in (JSeq, EngineSeq)}
    assert ref.admit(extra[JSeq]) == port.admit(extra[EngineSeq]) == 0
    assert ref.takeover_admits == port.takeover_admits == 1
    _compare(ref.run_step(), port.run_step())
    jb, tb = ref.flush_exports(), port.flush_exports()
    assert {k: b.header_crc() for k, b in jb.items()} == \
        {k: b.header_crc() for k, b in tb.items()}

    def readmit(inst, cls, seq):
        blob = inst.release(2)
        again = cls(seq.req_id, seq.group_id, list(seq.prompt),
                    seed=seq.seed, temperature=1.0, max_new_tokens=24)
        again.generated = list(seq.generated)
        again.last_token, again.next_pos = seq.last_token, seq.next_pos
        inst.admit(again, blob)
        return inst.cancel_pending_imports()

    assert readmit(ref, JSeq, jseqs[2]) == readmit(port, EngineSeq,
                                                   tseqs[2]) == [2]
    jv, tv = ref.crash(), port.crash()
    assert [s.req_id for s in jv] == [s.req_id for s in tv]
    assert not port.alive and port.free_slots() == 0
    with pytest.raises(RuntimeError):
        port.dispatch_step()


def test_unported_modes_raise(models):
    """Tensor parallelism runs now (tests/test_torch_tp.py); tp=2 in a
    process that is no rank of a two-rank group raises the launch
    hint."""
    _, _, tcfg, tp = models["float32"]
    with pytest.raises(ValueError, match="launch one process per rank"):
        Instance(tcfg, tp, StepFunctions(tcfg), device="cpu", tp=2)
