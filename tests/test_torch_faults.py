"""The port's fault paths against the JAX package's on granite-3-8b tiny
at f32 with the reference's weights: the ``bench_engine_faults``
workload (a crash, a short stall, a long stall the watchdog escalates, a
fetch failing past its retries, a corrupt blob) with the reference's
responses and every recovery counter, and ``tokens_lost == 0`` against
the no-fault oracle; crashes at fixed ticks in linear and tree
speculation (``top_k`` 2), with and without the pool; a stall that waits
out, a watchdog escalation, fetch retries, a corrupt blob and
degradation; ``fail_instance`` and the raise when every instance is
dead; the trainer under a crash, equal to the reference's under the
same crash and to its own no-fault run; and the bounded-staleness
trainer under a crash that replays tokens kept across a refresh."""
import functools

import pytest

import _torch_serving as h
import chip_smoke

@pytest.fixture(scope="module")
def faults():
    return {w: h.workload("faults", w) for w in ("jax", "port")}


def test_engine_faults_workload_matches_reference(faults):
    port, ref = faults["port"], faults["jax"]
    assert port["schedule"] == ref["schedule"]
    assert port["responses"] == ref["responses"]
    for which in ("oracle", "faulted", "repeat"):
        assert h.timeless(port[which]) == h.timeless(ref[which]), which
    assert port["recovery_paths"] == ref["recovery_paths"]
    assert h.timeless(port) == h.timeless(ref)


def test_engine_faults_are_lossless_and_fire_every_path(faults):
    port = faults["port"]
    assert port["tokens_lost"] == 0 and port["lost_by_request"] == {}
    assert port["responses"]["faulted"] == port["responses"]["oracle"]
    assert port["lengths_equal"] and port["repeat_identical"]
    fr = port["faulted"]
    for k in ("instance_crashes", "recovered_via_blob",
              "recovered_via_replay", "watchdog_escalations",
              "corrupt_blobs", "fetch_degraded", "recovery_replay_tokens"):
        assert fr[k] > 0, k
    for which in ("oracle", "faulted", "repeat"):
        assert port[which]["host_syncs"] == port[which]["engine_steps"] > 0
    assert {p for ps in port["recovery_paths"].values() for p in ps} == \
        {"blob", "replay"}


@functools.lru_cache(maxsize=None)
def _run(which, events=(), **kw):
    """One run of the faults workload's groups (12 new tokens) on 2
    instances with caches of 64; ``events``: (tick, kind, instance_id,
    ticks, count, lose_pool) tuples.  -> (responses, stats without the
    wall)."""
    api, cfg, params = h.side(which)
    inj = api.FaultInjector([
        api.FaultEvent(tick=t, kind=k, instance_id=i, ticks=n, count=c,
                       lose_pool=lp) for t, k, i, n, c, lp in events]) \
        if events else None
    ro = chip_smoke.bench_rollout(api, cfg, params, 2, cache_len=64,
                                  fault_injector=inj,
                                  steps=h.step_functions(which), **kw)
    res = ro.run(api.make_groups(chip_smoke.bench_prompts(cfg),
                                 group_size=2, max_new_tokens=12,
                                 seed=chip_smoke.BENCH_SEED))
    snap = res.stats.snapshot()
    snap.pop("wall_seconds")
    return res.responses(), snap


def _both(events=(), **kw):
    """The port's run, checked equal to the reference's and lossless
    against the port's no-fault oracle of the same settings."""
    got, stats = _run("port", events, **kw)
    want, jstats = _run("jax", events, **kw)
    oracle, _ = _run("port", (), **kw)
    assert got == want == oracle
    assert stats == jstats
    return stats


SPEC = {"linear": dict(spec_decode=True, spec_mode="linear",
                       multipath_top_k=1, gamma_max=4),
        "tree": dict(spec_decode=True, spec_mode="tree", multipath_top_k=2,
                     gamma_max=4)}


# (spec mode, crash tick of inst0, lose_pool)
CRASHES = [("linear", 2, False), ("linear", 7, True), ("linear", 11, False),
           ("tree", 3, False), ("tree", 7, True)]


def _crash(mode, tick, lose_pool):
    return _both(((tick, "crash", "inst0", 1, 1, lose_pool),), **SPEC[mode])


@pytest.mark.parametrize("mode,tick,lose_pool", CRASHES)
def test_crash_at_fixed_tick_matches_reference(mode, tick, lose_pool):
    st = _crash(mode, tick, lose_pool)
    assert st["instance_crashes"] == 1
    assert st["recovered_requests"] == \
        st["recovered_via_blob"] + st["recovered_via_replay"] > 0
    if lose_pool:
        assert st["recovered_via_blob"] == 0


def test_crash_ticks_take_both_recovery_paths():
    paths = [_crash(*c) for c in CRASHES]
    assert sum(s["recovered_via_blob"] for s in paths) > 0
    assert sum(s["recovered_via_replay"] for s in paths) > 0


def test_short_stall_waits_out_like_the_reference():
    st = _both(((3, "stuck", "inst0", 2, 1, False),))
    assert st["stuck_ticks"] > 0
    assert st["watchdog_escalations"] == st["instance_crashes"] == 0


def test_watchdog_escalates_a_long_stall_like_the_reference():
    st = _both(((4, "stuck", "inst0", 30, 1, False),))
    assert st["watchdog_escalations"] == st["instance_crashes"] == 1
    assert st["recovered_requests"] > 0


def test_fetch_retry_corrupt_blob_and_degrade_like_the_reference():
    st = _both(((2, "fetch_fail", None, 1, 2, False),
                (6, "corrupt", None, 1, 1, False),
                (9, "fetch_fail", None, 1, 3, False)))
    assert st["fetch_failures"] >= 2 and st["corrupt_blobs"] >= 1
    assert st["fetch_degraded"] >= 1
    assert st["fetch_backoff_seconds"] > 0.0
    assert st["instance_crashes"] == 0


def test_fail_instance_hook_and_all_dead_raise():
    api, cfg, params = h.side("port")
    ro = chip_smoke.bench_rollout(api, cfg, params, 2, cache_len=64,
                                  steps=h.step_functions("port"))
    with pytest.raises(RuntimeError, match="outside an active"):
        ro.fail_instance("inst0")
    stream = ro.run_stream(api.make_groups(
        chip_smoke.bench_prompts(cfg), group_size=2, max_new_tokens=12,
        seed=chip_smoke.BENCH_SEED))
    for kind, _ in stream:
        assert kind != "result", "the stream yielded no mid-run event"
        ro.fail_instance("inst0")
        ro.fail_instance("inst0")          # already dead: a no-op
        assert not ro.instances[0].alive
        with pytest.raises(RuntimeError, match="all instances dead"):
            ro.fail_instance("inst1")
        break
    stream.close()
    st = _both(((5, "crash", "inst1", 1, 1, False),))
    assert st["instance_crashes"] == 1


def _trainer(which="port", crash_tick=None, **kw):
    """The trainer of tests/test_torch_training.py (vocab 32, copy task)
    in the port or the reference ("jax") on the reference's weights, 2
    iterations without drafting, crashing inst0 at ``crash_tick`` of each
    rollout; -> (history, the responses the reward worker saw, the
    rollout's logprobs by request, trainer)."""
    import jax
    import numpy as np
    from repro.models import init_params as jinit_params
    from test_torch_training import RL_KW, _cfgs, _port_params, _record, _task
    jcfg, tcfg = _cfgs(vocab=32)
    jp, _ = jinit_params(jcfg, jax.random.PRNGKey(1))
    if which == "jax":
        from repro.core.faults import FaultEvent, FaultInjector
        from repro.data.tasks import make_task
        from repro.training.loop import RLConfig, RLTrainer
        cfg, params, dev = jcfg, jp, {}
    else:
        from repro_torch.core.faults import FaultEvent, FaultInjector
        from repro_torch.data.tasks import make_task
        from repro_torch.training.loop import RLConfig, RLTrainer
        cfg, dev = tcfg, {"device": "cpu"}
        params = _port_params(tcfg, jax.tree.map(np.asarray, jp))
    inj = FaultInjector([FaultEvent(tick=crash_tick, kind="crash",
                                    instance_id="inst0")]) \
        if crash_tick is not None else None
    args = dict(RL_KW, iterations=2, chunk_size=4, spec_decode=False,
                fault_injector=inj, **dev)
    args.update(kw)
    tr = RLTrainer(cfg, _task(make_task), RLConfig(**args), params=params)
    responses = _record(tr)
    sampled, sample = [], tr._sample_groups

    def keep(it):
        groups = sample(it)
        sampled.extend(groups)
        return groups
    tr._sample_groups = keep
    hist = tr.run()
    logprobs = {r.req_id: [float(x) for x in r.logprobs]
                for g in sampled for r in g.requests}
    return hist, responses, logprobs, tr


def _history_close(got, want, tokens=True):
    """Histories of two trainers at the port's port-to-reference
    tolerance (tests/test_torch_training.py); ``tokens``: the decoded
    token counts equal too (a crash's replay decodes more)."""
    from test_torch_training import TOL, _loss_close
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert (a.iteration, a.mean_reward) == (b.iteration, b.mean_reward)
        assert a.tokens == b.tokens or not tokens
        _loss_close(a.loss, b.loss)
        assert abs(a.metrics["grad_norm"] - b.metrics["grad_norm"]) <= \
            TOL * b.metrics["grad_norm"]


def _logprobs_close(got, want):
    assert got.keys() == want.keys()
    for rid in want:
        assert len(got[rid]) == len(want[rid]), rid
        assert max((abs(a - b) for a, b in zip(got[rid], want[rid])),
                   default=0.0) <= 1e-5, rid


def test_trainer_under_a_crash_matches_the_no_fault_run():
    """Under the same crash the port's trainer gives the reference's
    responses exactly, and its losses, grad norms and rollout logprobs
    (the recovered requests' included) at the port's port-to-reference
    tolerance.  Against its own no-fault run, tokens and rewards are
    exact, and both iterations' losses, metrics and every rollout
    logprob are bitwise equal, as the reference asserts of itself
    (``tests/test_faults.py``): a crash replay keeps the logprobs its
    tokens were recorded with (the params have not changed), and with
    one instance down the next iteration's steps batch other rows, which
    changes no row's bits, since the engine path's products, norms and
    attention are row-invariant (``kernels/row_gemm``)."""
    h0, r0, lp0, _ = _trainer()
    h1, r1, lp1, tr1 = _trainer(crash_tick=4)
    jh1, jr1, jlp1, jtr1 = _trainer("jax", crash_tick=4)
    assert r1 == jr1 == r0
    _history_close(h1, jh1)
    _logprobs_close(lp1, jlp1)
    assert [i.crashes for i in tr1.rollout.instances] == \
        [i.crashes for i in jtr1.rollout.instances]
    assert sum(i.crashes for i in tr1.rollout.instances) >= 1
    _history_close(h1, h0, tokens=False)
    _logprobs_close(lp1, lp0)
    assert [h.mean_reward for h in h1] == [h.mean_reward for h in h0]
    assert [(h.loss, h.metrics) for h in h1] == \
        [(h.loss, h.metrics) for h in h0]
    for it in ("it0-", "it1-"):
        rids = [rid for rid in lp0 if rid.startswith(it)]
        assert rids and all(lp1[rid] == lp0[rid] for rid in rids), it
    assert lp1 == lp0
    assert not tr1.rollout._replay_logprobs
    h2, r2, _, tr2 = _trainer(crash_tick=4, async_overlap=True,
                              staleness_bound=1)
    assert len(h2) == 2
    assert sum(i.crashes for i in tr2.rollout.instances) >= 1
    assert tr2.ledger.total_tokens() == sum(len(v) for v in r2.values())
    assert tr2.ledger.max_staleness <= 1


def test_stream_trainer_crash_after_a_refresh_matches_reference():
    """The bounded-staleness trainer (bound 1, refresh mode "keep") with
    6 groups, so that iteration 1's requests still decode when iteration
    0's weights refresh the instances; the crash at tick 57 then replays
    requests that hold tokens sampled under both param versions.  Their
    replay recomputes the logprobs under the live params, as the
    reference's does: responses exact; losses, grad norms and rollout
    logprobs at the port-to-reference tolerance (logprobs kept from the
    old params would be ~6e-4 off)."""
    kw = dict(crash_tick=57, async_overlap=True, staleness_bound=1,
              n_groups=6)
    h, r, lp, tr = _trainer(**kw)
    jh, jr, jlp, jtr = _trainer("jax", **kw)
    assert r == jr
    _history_close(h, jh)
    _logprobs_close(lp, jlp)
    assert [i.crashes for i in tr.rollout.instances] == \
        [i.crashes for i in jtr.rollout.instances] == [1, 0]
    assert tr.ledger.max_staleness == 1 and tr.ledger.total_tokens(1) > 0
