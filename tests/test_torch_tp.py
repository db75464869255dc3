"""The port's tensor-parallel engine against the JAX package's
one-device run: the counterparts of ``tests/test_tp_engine.py`` and of
``tests/test_faults.py``'s tp2 crash case.

The ranks are real processes: a module fixture spawns one gloo group of
two ranks and one of four (``repro_torch.launch.mesh.spawn``, the CPU,
one thread each) while this process runs the reference's ``tp=None``
cases with JAX; each rank runs every case of ``tests/_torch_tp.py`` on
the reference's tiny weights at f32 and hands back what it saw.  The
oracle is the reference's ``tp=None`` run, which the reference's own tp
tests cannot replace here (its mesh code fails under this jax).

* tp = 1 is bitwise the port's ``tp=None``: tokens, logprobs, engine
  steps, host syncs — and those tokens are the reference's.
* tp = 2 is token-exact against the reference in plain decode, linear
  and tree speculation (logprobs bitwise the port's ``tp=None``), with
  at most one host sync per step on each rank.
* Blobs exported at tp = 1 and 2 carry the reference's header, nbytes
  and CRC, and the port's ``tp=None`` bytes; a request migrating
  tp 2 -> 1 -> 2 -> None continues token-exact from blob hits.
* Crash recovery at tp = 2 (pooled blob and lost pool) and a whole
  ``SeerRollout(tp=2)`` give the reference's responses and counters.
* One tp = 4 group (granite tiny: one query head per rank, two ranks per
  KV head) is token-exact.
* Every rank of a group built the same host batches (lockstep digests).
"""
import pickle
import threading
import types
from dataclasses import replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import _torch_tp as W
from repro.configs import get_tiny_config as jget_tiny
from repro.core import SeerRollout as JRollout
from repro.core import make_groups as jmake_groups
from repro.core.faults import FaultEvent as JFaultEvent
from repro.core.faults import FaultInjector as JFaultInjector
from repro.engine import EngineSeq as JSeq
from repro.engine import Instance as JInstance
from repro.engine import StepFunctions as JSteps
from repro.engine import build_token_tree as jbuild_token_tree
from repro.engine import chain_tree as jchain_tree
from repro.models import init_params as jinit_params
from repro_torch.launch.mesh import spawn

TP = 2


def _jax_api():
    return types.SimpleNamespace(
        Instance=JInstance, EngineSeq=JSeq, StepFunctions=JSteps,
        SeerRollout=JRollout, make_groups=jmake_groups,
        FaultInjector=JFaultInjector, FaultEvent=JFaultEvent,
        build_token_tree=jbuild_token_tree, chain_tree=jchain_tree,
        inst_kw={}, tensor=jnp.asarray, numpy=np.asarray)


def _reference(models):
    """The JAX package's tp=None run of every case."""
    api = _jax_api()
    out = {"pair": {}, "tree": {}, "migrate": {}}
    for arch, (cfg, params) in models.items():
        steps = JSteps(cfg)
        out["pair"][arch] = {
            "linear": W.run_pair(api, cfg, params, steps, None),
            "plain": W.run_pair(api, cfg, params, steps, None, gamma_max=0)}
        if arch in W.TREE_ARCHS:
            out["tree"][arch] = W.run_tree(api, cfg, params, steps, None)
        if arch in W.MIGRATE_ARCHS:
            out["migrate"][arch] = W.migrate(api, cfg, params, steps, [None])
        if arch == "granite-3-8b":
            out["blob"] = W.export_after(api, cfg, params, steps, None)
            out["faults"] = W.fault_run(api, cfg, params, steps)
            out["rollout"] = W.rollout_run(api, cfg, params)
    return out


def _spawn_in_thread(world, params_file, out_dir, errors):
    def go():
        try:
            spawn(W.rank_main, world, backend="gloo", device="cpu",
                  args=(str(params_file), str(out_dir)))
        except Exception as e:          # re-raised by the fixture
            errors.append(e)
    t = threading.Thread(target=go)
    t.start()
    return t


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(reference results, [rank results] of the tp=2 group, [rank
    results] of the tp=4 group)."""
    tmp = tmp_path_factory.mktemp("tp")
    models, trees = {}, {}
    for arch in W.ARCHS:
        cfg = replace(jget_tiny(arch), dtype="float32")
        params, _ = jinit_params(cfg, jax.random.PRNGKey(1))
        models[arch] = (cfg, params)
        trees[arch] = jax.tree.map(np.asarray, params)
    groups = {}
    errors = []
    for world, archs in ((TP, W.ARCHS), (4, ["granite-3-8b"])):
        d = tmp / f"tp{world}"
        d.mkdir()
        with open(d / "params.pkl", "wb") as f:
            pickle.dump({a: trees[a] for a in archs}, f)
        groups[world] = (d, _spawn_in_thread(world, d / "params.pkl", d,
                                             errors))
    ref = _reference(models)
    ranks = {}
    for world, (d, thread) in groups.items():
        thread.join(timeout=900)
        assert not thread.is_alive(), f"tp={world} group did not finish"
        if errors:
            raise errors[0]
        ranks[world] = []
        for r in range(world):
            with open(d / f"rank{r}.pkl", "rb") as f:
                ranks[world].append(pickle.load(f))
    return ref, ranks[TP], ranks[4]


@pytest.mark.parametrize("arch", W.ARCHS)
def test_tp1_bit_identical_to_unmeshed(runs, arch):
    """tp=1 changes nothing: tokens, logprobs, host syncs and steps equal
    the port's tp=None run, whose tokens and steps are the reference's."""
    ref, ranks, _ = runs
    for rank in ranks:
        got = rank["pair"][arch]
        for mode in ("linear", "plain"):
            one, none = dict(got[1][mode]), dict(got[None][mode])
            one.pop("lockstep")
            none.pop("lockstep")
            assert one == none, mode
            assert none["tokens"] == ref["pair"][arch][mode]["tokens"]
            assert none["steps"] == ref["pair"][arch][mode]["steps"]
            assert got[1][mode]["lockstep"] == (0, 0)


@pytest.mark.parametrize("arch", W.ARCHS)
def test_tp2_token_exact_plain_and_linear_spec(runs, arch):
    """tp=2 samples the reference's tokens in linear speculation (with
    the same accept/reject steps) and in plain decode; its logprobs are
    bitwise the port's tp=None ones."""
    ref, ranks, _ = runs
    for rank in ranks:
        got = rank["pair"][arch]
        for mode in ("linear", "plain"):
            want = ref["pair"][arch][mode]
            assert got[TP][mode]["tokens"] == want["tokens"], mode
            assert got[TP][mode]["steps"] == want["steps"], mode
            assert got[TP][mode]["logprobs"] == got[None][mode]["logprobs"]


@pytest.mark.parametrize("arch", W.TREE_ARCHS)
def test_tp2_token_exact_tree_spec(runs, arch):
    """tp=2 through the fused tree step — branching trees whose side
    branch holds the oracle's tokens, oracle chains, no drafts — commits
    exactly the reference's linear tokens."""
    ref, ranks, _ = runs
    want = ref["tree"][arch]["tokens"]
    for rank in ranks:
        for drafts, got in rank["tree"][arch].items():
            assert got["tokens"] == want, drafts


def test_tp2_at_most_one_host_sync_per_step(runs):
    """Sharding adds no host sync: every step of every tp=2 run reads
    back one result block on each rank."""
    _, ranks, _ = runs
    for rank in ranks:
        for arch, got in rank["pair"].items():
            for mode in ("linear", "plain"):
                assert set(got[TP][mode]["syncs"]) == {1}, (arch, mode)


def test_blob_headers_tp_invariant(runs):
    """The same request exported at tp=2 and tp=1 gives the reference's
    blob header (next_pos, nbytes, shapes, dtypes, CRC) and the port's
    tp=None array bytes: the export gathers the head shards."""
    ref, ranks, _ = runs
    want = ref["blob"]
    for rank in ranks:
        mine = rank["blob"][None]
        for tp in (1, TP):
            got = rank["blob"][tp]
            assert got["generated"] == want["generated"]
            for key in ("next_pos", "nbytes", "crc", "shapes", "dtypes"):
                assert got[key] == want[key], (tp, key)
            assert sorted(got["arrays"]) == sorted(want["arrays"])
            for name, a in mine["arrays"].items():
                np.testing.assert_array_equal(got["arrays"][name], a)


@pytest.mark.parametrize("arch", W.MIGRATE_ARCHS)
def test_cross_tp_migration_token_exact(runs, arch):
    """A request migrating tp=2 -> 1 -> 2 -> None continues exactly on
    the reference's unmigrated tokens, every import a blob hit."""
    ref, ranks, _ = runs
    want = ref["migrate"][arch]["tokens"]
    for rank in ranks:
        got = rank["migrate"][arch]
        assert got["oracle"]["tokens"] == want
        assert got["hopped"]["tokens"] == want
        assert got["hopped"]["prefills"] == [0, 0, 0]


def test_crash_recovery_token_lossless_tp2(runs):
    """tp=2 instances crash and the victims resume (pooled blob, or
    rewind and replay when the pool is lost) on the reference's
    no-fault tokens."""
    ref, ranks, _ = runs
    want = ref["faults"]["responses"]
    for rank in ranks:
        faults = rank["faults"]
        assert faults["nofault"]["responses"] == want
        recovered = 0
        for tick, lose_pool, got in faults["cases"]:
            assert got["responses"] == want, (tick, lose_pool)
            assert got["crashes"] == 1
            recovered += got["recovered"]
            if lose_pool:
                assert got["via_blob"] == 0
        assert recovered > 0


def test_rollout_tp2_matches_reference(runs):
    """``SeerRollout(tp=2)``: the reference's responses and every
    ``RolloutStats`` counter (wall clock aside), the port's tp=None step
    kinds, and one host sync a step."""
    ref, ranks, _ = runs
    want = ref["rollout"]
    for rank in ranks:
        got = rank["rollout"][TP]
        assert got["responses"] == want["responses"]
        assert got["stats"] == want["stats"]
        assert got["kinds"] == rank["rollout"][None]["kinds"]
        assert got["host_syncs"] == got["stats"]["steps"]


def test_tp4_token_exact(runs):
    """Four ranks (one query head each, two ranks reading each KV head)
    sample the reference's tokens in linear and plain decode.  A rank
    holding fewer query heads than a KV group attends with another
    query-to-KV ratio than one device (here 1 for 2), so its attention's
    products have another shape — on the CPU a decode step's becomes a
    matrix-vector product — and the f32 logprobs may differ from the
    port's tp=None ones in the last bits (held at 1e-6); the tokens do
    not."""
    ref, _, ranks4 = runs
    want = ref["pair"]["granite-3-8b"]
    for rank in ranks4:
        got = rank["pair"]["granite-3-8b"][4]
        mine = rank["pair"]["granite-3-8b"][None]
        for mode in ("linear", "plain"):
            assert got[mode]["tokens"] == want[mode]["tokens"], mode
            assert got[mode]["steps"] == want[mode]["steps"], mode
            for a, b in zip(got[mode]["logprobs"], mine[mode]["logprobs"]):
                np.testing.assert_allclose(a, b, rtol=0, atol=1e-6)


def _lockstep_records(rank):
    recs = []
    for arch, got in sorted(rank["pair"].items()):
        for t in sorted(k for k in got if k not in (None, 1)):
            recs += [got[t][m]["lockstep"] for m in ("linear", "plain")]
    for arch, got in sorted(rank["tree"].items()):
        recs += [got[d]["lockstep"] for d in sorted(got)]
    if "faults" in rank:
        recs += rank["faults"]["nofault"]["lockstep"]
        for _, _, got in rank["faults"]["cases"]:
            recs += got["lockstep"]
        recs += rank["rollout"][TP]["lockstep"]
    return recs


def test_ranks_in_lockstep(runs):
    """Every rank of a group uploaded the same host batches: the running
    digests of every instance are equal across ranks (each upload was
    also compared across the group as it happened), and tp>1 instances
    checked at every upload."""
    _, ranks, ranks4 = runs
    for group in (ranks, ranks4):
        recs = [_lockstep_records(r) for r in group]
        assert all(r == recs[0] for r in recs[1:])
        assert all(checks > 0 for checks, _ in recs[0])
        traffic = [r["traffic"] for r in group]
        assert all(t == traffic[0] for t in traffic[1:])
        assert traffic[0]["all_gather"] > 0
