"""``SeerRollout.run`` of the port against the JAX package's on
granite-3-8b tiny at f32 with the reference's weights: two instances, a
chunk size small enough that requests migrate through the pool, grouped
speculative decoding on.  Responses, step, chunk and migration counts,
draft statistics and host syncs are equal at temperatures 0 and 1."""
from dataclasses import replace

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_tiny_config as jget_tiny
from repro.core import SeerRollout as JRollout
from repro.core import make_groups as jmake_groups
from repro.models import init_params as jinit_params
from repro_torch.bridge import params_from_jax
from repro_torch.configs import get_tiny_config
from repro_torch.core import SeerRollout, make_groups

torch.set_num_threads(2)
ARCH = "granite-3-8b"
PROMPTS = [[3, 1, 4, 1, 5, 9, 2, 6], [5, 9, 2, 6, 5, 3],
           [2, 7, 1, 8, 2, 8, 1, 8, 2, 8]]
ROLLOUT = dict(n_instances=2, max_slots=2, cache_len=128, chunk_size=8,
               policy="seer", spec_decode=True, prefill_chunk=4)


@pytest.fixture(scope="module")
def models():
    jcfg = replace(jget_tiny(ARCH), dtype="float32")
    tcfg = replace(get_tiny_config(ARCH), dtype="float32")
    jp, _ = jinit_params(jcfg, jax.random.PRNGKey(1))
    tp = params_from_jax(tcfg, jax.tree.map(np.asarray, jp), device="cpu")
    return jcfg, jp, tcfg, tp


def _summary(ro, res):
    st = res.stats
    return {"responses": res.responses(), "steps": st.steps,
            "tokens": st.tokens, "chunks": st.chunks,
            "migrations": st.migrations, "drafted": st.drafted,
            "accepted": st.accepted, "pool_hits": st.pool_hits,
            "host_syncs": ro.steps.host_syncs,
            "fused": dict(ro.steps.invocations_by_kind)}


@pytest.mark.parametrize("temp", [0.0, 1.0])
def test_rollout_matches_reference(models, temp):
    jcfg, jp, tcfg, tp = models
    kw = dict(group_size=2, max_new_tokens=24, seed=5, temperature=temp)
    jro = JRollout(jcfg, jp, **ROLLOUT)
    want = _summary(jro, jro.run(jmake_groups(PROMPTS, **kw)))
    tro = SeerRollout(tcfg, tp, device="cpu", **ROLLOUT)
    res = tro.run(make_groups(PROMPTS, **kw))
    got = _summary(tro, res)
    assert got == want
    assert all(g.all_finished for g in res.groups)
    assert got["migrations"] > 0 and got["chunks"] > 0
    assert got["host_syncs"] == got["steps"]
    if temp == 0.0:
        assert got["accepted"] > 0


def test_tracer_and_tp_raise(models):
    """Tensor parallelism needs its ranks: tp=2 outside a two-rank group
    raises the launch hint (tests/test_torch_tp.py runs it in one); a
    tracer runs, and a traced run is the untraced run bit for bit (its
    trace is held to the reference's in tests/test_torch_obs.py)."""
    from repro_torch.obs import Tracer
    _, _, tcfg, tp = models
    with pytest.raises(ValueError, match="launch one process per rank"):
        SeerRollout(tcfg, tp, device="cpu", tp=2, **ROLLOUT)
    kw = dict(group_size=2, max_new_tokens=8, seed=5, temperature=1.0)
    tr = Tracer()
    runs = []
    for tracer in (None, tr):
        ro = SeerRollout(tcfg, tp, device="cpu", tracer=tracer, **ROLLOUT)
        runs.append(_summary(ro, ro.run(make_groups(PROMPTS, **kw))))
    assert runs[1] == runs[0]
    assert runs[1]["host_syncs"] == runs[1]["steps"]
    names = {e["name"] for e in tr.events()}
    assert {"step_dispatch", "step_commit"} <= names


def test_topology_aware_placement_matches_reference(models):
    """Two nodes x two instances (tests/test_migration.py's
    topology-aware case): blind and topology-aware placement give the
    same responses, each run's ``pool.stats()`` equals the reference's,
    and ranking placements by modeled transfer cost moves fewer bytes
    across the fabric (152,144 blind, 128,500 aware)."""
    jcfg, jp, tcfg, tp = models
    prompts = [[(7 * g + j) % 19 + 2 for j in range(8 + 2 * g)]
               for g in range(4)]
    kw = dict(n_instances=4, max_slots=1, cache_len=96, chunk_size=6,
              prefill_chunk=8, n_nodes=2, policy="seer", spec_decode=False,
              base_seed=7)
    got, want = {}, {}
    for aware in (False, True):
        jro = JRollout(jcfg, jp, topology_aware=aware, **kw)
        jres = jro.run(jmake_groups(prompts, group_size=2,
                                    max_new_tokens=16, seed=5))
        tro = SeerRollout(tcfg, tp, device="cpu", topology_aware=aware, **kw)
        assert {i.node for i in tro.instances} == {"n0", "n1"}
        tres = tro.run(make_groups(prompts, group_size=2, max_new_tokens=16,
                                   seed=5))
        want[aware] = (jres.responses(), jro.pool.stats())
        got[aware] = (tres.responses(), tro.pool.stats())
        assert got[aware] == want[aware]
    assert got[True][0] == got[False][0]
    assert got[False][1]["cross_node_bytes"] == 152144
    assert got[True][1]["cross_node_bytes"] == 128500
