"""The port's flight recorder (``repro_torch.obs``) against the JAX
package's ``repro.obs`` on the same inputs: the tracer's clocks, event
resolution and Chrome JSON, span conservation and tail attribution on
synthetic timelines, and the traces of real runs on granite-3-8b tiny at
f32 with the reference's weights — the ``bench_observability`` workload
(the port's Chrome JSON equal to the reference's, event for event,
ticks, modeled seconds and args included; traced = untraced bit for bit,
one host sync per engine step), a crash schedule's recovery spans, the
engine's dispatch and commit instants, a traced ``RLTrainer`` stream
and the cluster simulator."""
import dataclasses
import json

import pytest

import _torch_serving as h
import chip_smoke
import repro.obs as jobs
import repro_torch.obs as tobs
from repro.obs import trace as jtrace
from repro_torch.obs import trace as ttrace

PACKAGES = {"jax": jobs, "port": tobs}


def _clock_script(obs):
    """test_obs.py's clock sequence on one package's ``Tracer``."""
    tr = obs.Tracer()
    tr.begin_tick(0)
    tr.instant("a", "instance", "inst0", x=1)
    tr.advance_tick(0.5)
    tr.begin_tick(1)
    tr.advance_tick(0.25)
    tr.span("decode", "request", "r0", 0, 2)
    tr.span("sim", "request", "r1", 0, 1, t0=3.0, t1=4.5)
    tr.instant("fault_crash", "fault", "inst1", tick=1, lose_pool=True,
               count=1)
    tr.span("queue", "request", "r2", 1, 3, tenant="a", group="g0")
    return tr


def test_tracer_clock_and_event_resolution_match_reference():
    jt, tt = _clock_script(jobs), _clock_script(tobs)
    assert [tt.tick_time(t) for t in (0, 1, 2, 99)] == \
        [jt.tick_time(t) for t in (0, 1, 2, 99)] == [0.0, 0.5, 0.75, 0.75]
    assert tt.events() == jt.events()
    assert ttrace.SCHEMA_KEYS == jtrace.SCHEMA_KEYS
    assert ttrace.CATEGORIES == jtrace.CATEGORIES
    assert ttrace.schema_keys(tt.events()) == sorted(ttrace.SCHEMA_KEYS)


def test_chrome_json_and_round_trip_match_reference():
    jt, tt = _clock_script(jobs), _clock_script(tobs)
    doc = json.loads(json.dumps(tt.to_chrome()))
    assert json.dumps(tt.to_chrome(), sort_keys=True) == \
        json.dumps(jt.to_chrome(), sort_keys=True)
    assert tobs.Tracer.from_chrome(doc) == tt.events()
    assert jobs.Tracer.from_chrome(doc) == tt.events()


def _timelines(obs):
    """Synthetic timelines of test_obs.py: a tiling one, one with a gap,
    a finished one without spans, 20 with a decode tail, a shed one."""
    def tl(rid, spans, tenant="-", finished=True):
        t = obs.RequestTimeline(req_id=rid, tenant=tenant, finished=finished)
        t.spans_s = list(spans)
        t.segments = [(ph, int(a), int(b)) for ph, a, b in spans]
        if spans:
            t.submit_tick, t.end_tick = int(spans[0][1]), int(spans[-1][2])
        return t
    tls = {"ok": tl("ok", [("queue", 0.0, 1.0), ("decode", 1.0, 4.0)]),
           "gap": tl("gap", [("queue", 0.0, 1.0), ("decode", 2.0, 4.0)]),
           "empty": tl("empty", [])}
    for i in range(20):
        tls[f"r{i}"] = tl(f"r{i}", [("queue", 0.0, 0.5),
                                    ("recovery", 0.5, 0.75),
                                    ("decode", 0.75, 1.0 + i)],
                          tenant="a" if i % 2 else "b")
    tls["shed"] = obs.RequestTimeline(req_id="shed", shed=True)
    return tls


@pytest.mark.parametrize("subset", ["all", "conserved_only"])
def test_conservation_and_tail_attribution_match_reference(subset):
    jt, tt = _timelines(jobs), _timelines(tobs)
    if subset == "conserved_only":
        jt = {k: v for k, v in jt.items() if k not in ("gap", "empty")}
        tt = {k: v for k, v in tt.items() if k not in ("gap", "empty")}
    for k in tt:
        assert tt[k].conserved() == jt[k].conserved(), k
        assert tt[k].phase_seconds() == jt[k].phase_seconds(), k
    rep, jrep = tobs.tail_attribution(tt), jobs.tail_attribution(jt)
    assert rep == jrep
    assert rep["conserved"] == (subset == "conserved_only")
    assert rep["shed"] == 1
    assert tobs.format_attribution(rep) == jobs.format_attribution(jrep)
    assert tobs.PHASES == jobs.PHASES


# -- the bench_observability workload ----------------------------------------


@pytest.fixture(scope="module")
def traces():
    return {w: h.workload("trace", w) for w in ("jax", "port")}


def test_traced_rollout_chrome_json_equals_the_reference(traces):
    port, ref = traces["port"], traces["jax"]
    assert port["events"] == ref["events"] > 0
    assert json.dumps(port["chrome"], sort_keys=True) == \
        json.dumps(ref["chrome"], sort_keys=True)
    assert port["attribution"] == ref["attribution"]
    assert port["attribution_text"] == ref["attribution_text"]
    assert h.timeless(port) == h.timeless(ref)


def test_traced_rollout_is_untraced_bit_for_bit(traces):
    port = traces["port"]
    assert port["bit_identical"]
    for which in ("untraced", "traced", "traced_again"):
        assert port[which]["host_syncs"] == port[which]["engine_steps"] > 0
    assert port["finished"] == chip_smoke.BENCH_GROUPS * \
        chip_smoke.BENCH_GROUP_SIZE
    for k in ("conserved", "tick_tiling_exact", "chrome_roundtrip",
              "chrome_deterministic", "schema_ok", "phases_ok"):
        assert port[k], k
    assert port["attribution"]["phase_totals_s"]["decode"] > 0.0


def _crash_trace(which):
    api, cfg, params = h.side(which)
    steps = h.step_functions(which)
    oracle = chip_smoke.bench_rollout(api, cfg, params, 2, steps=steps).run(
        chip_smoke.bench_groups(api, cfg)).responses()
    tr = api.Tracer()
    inj = api.FaultInjector([api.FaultEvent(
        tick=2, kind="crash", instance_id="inst0", lose_pool=True)])
    res = chip_smoke.bench_rollout(api, cfg, params, 2, tracer=tr,
                                   fault_injector=inj, steps=steps).run(
        chip_smoke.bench_groups(api, cfg))
    return oracle, res, tr.events()


def test_crash_schedule_records_the_reference_recovery_spans():
    oracle, res, evs = _crash_trace("port")
    _, jres, jevs = _crash_trace("jax")
    assert res.responses() == oracle == jres.responses()
    assert res.stats.instance_crashes == 1
    assert evs == jevs
    crashes = [e for e in evs if e["name"] == "fault_crash"]
    assert [(e["track"], e["tick0"]) for e in crashes] == [("inst0", 2)]
    recov = [e for e in evs if e["name"] == "recovery" and e["ph"] == "i"]
    assert len(recov) == res.stats.recovered_requests > 0
    assert all(e["args"]["kind"] in ("blob", "replay") for e in recov)
    rep = tobs.tail_attribution(tobs.timelines_from_events(evs))
    assert rep["conserved"] and rep["phase_totals_s"]["recovery"] > 0.0


def _instance_events(which):
    """One traced ``Instance`` stepped to the end of a request."""
    if which == "jax":
        from repro.engine import EngineSeq, Instance
        kw = {}
    else:
        from repro_torch.engine import EngineSeq, Instance
        kw = {"device": "cpu"}
    _, cfg, params = h.side(which)
    steps = h.step_functions(which)
    syncs0 = steps.host_syncs
    inst = Instance(cfg, params, steps, max_slots=2, cache_len=64,
                    gamma_max=0, prefill_chunk=4, base_seed=7,
                    instance_id="inst3", **kw)
    inst.tracer = PACKAGES[which].Tracer()
    s = EngineSeq("r0", "g0", [2, 3, 4, 5, 6, 7], seed=3, max_new_tokens=8)
    inst.admit(s)
    n = 0
    while not s.finished:
        inst.run_step()
        n += 1
    return inst.tracer.events(), n, steps.host_syncs - syncs0, s.generated


def test_engine_dispatch_and_commit_instants_match_reference():
    evs, n, syncs, gen = _instance_events("port")
    jevs, jn, _, jgen = _instance_events("jax")
    assert (evs, n, gen) == (jevs, jn, jgen)
    assert syncs == n
    names = [e["name"] for e in evs]
    assert names == ["step_dispatch", "step_commit"] * n
    assert set(evs[0]["args"]) == {"decode_rows", "prefill_rows",
                                   "prefill_tokens"}
    assert evs[0]["args"]["prefill_rows"] == 1
    assert {e["track"] for e in evs} == {"inst3"}


# -- the trainer and the simulator --------------------------------------------


def _trainer_trace(which):
    from test_torch_training import RL_KW, _cfgs, _port_params, _task
    import jax
    import numpy as np
    jcfg, tcfg = _cfgs(vocab=32)
    from repro.models import init_params as jinit_params
    jp, _ = jinit_params(jcfg, jax.random.PRNGKey(1))
    kw = dict(RL_KW, iterations=2, async_overlap=True, staleness_bound=1)
    if which == "jax":
        from repro.data.tasks import make_task
        from repro.training.loop import RLConfig, RLTrainer
        tr = jobs.Tracer()
        trainer = RLTrainer(jcfg, _task(make_task),
                            RLConfig(**kw, tracer=tr), params=jp)
    else:
        from repro_torch.data.tasks import make_task
        from repro_torch.training.loop import RLConfig, RLTrainer
        tr = tobs.Tracer()
        trainer = RLTrainer(tcfg, _task(make_task),
                            RLConfig(**kw, tracer=tr, device="cpu"),
                            params=_port_params(
                                tcfg, jax.tree.map(np.asarray, jp)))
    hist = trainer.run()
    return tr.events(), [(x.iteration, x.tokens) for x in hist]


def test_traced_trainer_emits_the_reference_train_iteration_events():
    evs, hist = _trainer_trace("port")
    jevs, jhist = _trainer_trace("jax")
    assert hist == jhist
    its = [e for e in evs if e["name"] == "train_iteration"]
    assert [(e["track"], e["cat"], e["args"]) for e in its] == \
        [(e["track"], e["cat"], e["args"]) for e in jevs
         if e["name"] == "train_iteration"]
    assert [e["args"]["iteration"] for e in its] == [0, 1]
    assert evs == jevs


def _sim_trace(which):
    if which == "jax":
        from repro.configs import get_config
        from repro.core.simulator import ClusterSimulator, SimConfig
        from repro.data.workload import MOONLIGHT, make_workload
    else:
        from repro_torch.configs import get_config
        from repro_torch.core.simulator import ClusterSimulator, SimConfig
        from repro_torch.data.workload import MOONLIGHT, make_workload
    spec = dataclasses.replace(MOONLIGHT, n_requests=16, group_size=4,
                               n_instances=2, max_gen_length=4096,
                               mean_gen_length=1000)
    tr = PACKAGES[which].Tracer()
    res = ClusterSimulator(
        get_config("yi-6b"), spec,
        SimConfig(mode="divided", policy="seer", max_slots=8,
                  chips_per_instance=1, kv_capacity_tokens=30_000,
                  chunk_size=512, fault_rate=0.05, seed=3),
        tracer=tr).run(make_workload(spec, seed=3))
    return tr.events(), res.total_time


def test_simulator_emits_the_reference_trace():
    evs, t = _sim_trace("port")
    jevs, jt = _sim_trace("jax")
    assert t == jt
    assert evs == jevs
    assert ttrace.schema_keys(evs) == sorted(ttrace.SCHEMA_KEYS)
    rep = tobs.tail_attribution(tobs.timelines_from_events(evs))
    assert rep["requests"] == 16 and rep["conserved"]
