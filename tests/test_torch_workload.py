"""The port's open-loop serving front end (``repro_torch.core.workload``)
against the JAX package's ``repro.core.workload`` on the same seeded
inputs: Poisson arrivals (with a rate schedule), trace replay, the
tenant rate limiter, nearest-rank percentiles and the feed's tick-by-tick
release, parametrised over seeds and rates; then the ``bench_serving``
workload on granite-3-8b tiny at f32 with the reference's weights — the
closed-loop equivalence of a t = 0 trace, and ``serve``'s reports at the
calibration rate, 1x and 2x, equal to the reference's field for field
(host walls aside)."""
import dataclasses
import math

import pytest

import _torch_serving as h
import chip_smoke
import repro.core.workload as jw
import repro_torch.core.workload as tw

PACKAGES = {"jax": jw, "port": tw}
TENANTS = (("a", 2.0, 200.0), ("b", 1.0, 200.0))


def _tenants(w, tenants=TENANTS):
    return tuple(w.TenantSpec(n, weight=wt, token_rate=r)
                 for n, wt, r in tenants)


def _trace(w, rate, n, seed, schedule=None):
    lengths = w.LengthSampler(prompt_len=8, prompt_jitter=4, gen_mean=16,
                              gen_sigma=0.7)
    return w.PoissonArrivals(rate, n, seed=seed, tenants=_tenants(w),
                             lengths=lengths, rate_schedule=schedule).trace()


def _tuples(trace):
    return [dataclasses.astuple(a) for a in trace]


@pytest.mark.parametrize("rate", [0.2, 1.0, 8.0])
@pytest.mark.parametrize("seed", [0, 7, 4099])
def test_poisson_arrivals_match_reference(seed, rate):
    got = _trace(tw, rate, 40, seed)
    assert _tuples(got) == _tuples(_trace(jw, rate, 40, seed))
    assert [a.index for a in got] == list(range(40))
    assert all(a.t < b.t for a, b in zip(got, got[1:]))


@pytest.mark.parametrize("seed", [3, 11])
def test_rate_schedule_matches_reference(seed):
    sched = ((10.0, 50.0), (30.0, 5.0))
    got = _trace(tw, 0.5, 400, seed, schedule=sched)
    assert _tuples(got) == _tuples(_trace(jw, 0.5, 400, seed,
                                          schedule=sched))
    pre = [b.t - a.t for a, b in zip(got, got[1:]) if b.t < 10.0]
    post = [b.t - a.t for a, b in zip(got, got[1:]) if a.t >= 10.0]
    assert pre and post
    assert sum(pre) / len(pre) > 10 * sum(post) / len(post)


@pytest.mark.parametrize("seed", [1, 5])
def test_trace_arrivals_round_trip_matches_reference(seed):
    for w in (tw, jw):
        tr = _trace(w, 1.0, 30, seed)
        replay = w.TraceArrivals(tr)
        assert replay.trace() == tr
        assert sorted(t.name for t in replay.tenants) == \
            sorted({a.tenant for a in tr})
    assert _tuples(tw.TraceArrivals(_trace(tw, 1.0, 30, seed)).trace()) == \
        _tuples(jw.TraceArrivals(_trace(jw, 1.0, 30, seed)).trace())


def _releases(w, seed, rate, burst_s):
    tenants = (w.TenantSpec("a", token_rate=rate),
               w.TenantSpec("b", weight=0.5, token_rate=rate / 2))
    proc = w.PoissonArrivals(rate / 10.0, 60, seed=seed, tenants=tenants,
                             lengths=w.LengthSampler(prompt_len=5,
                                                     gen_mean=5))
    q = w.ArrivalQueue(proc.trace(),
                       w.TenantRateLimiter(tenants, burst_s=burst_s), 2)
    out, now = [], 0.0
    while not q.empty and now < 1e4:
        out += [(now, a.index, a.tenant) for a in q.release_ready(now)]
        nxt = q.next_release_time(now)
        out.append(("next", nxt, q.pending_count()))
        now = max(now + 1e-3, nxt if nxt is not None else now + 1e-3)
    return out


@pytest.mark.parametrize("rate,burst_s", [(50.0, 0.5), (200.0, 1.0),
                                          (200.0, 2.0)])
def test_rate_limiter_releases_match_reference(rate, burst_s):
    got = _releases(tw, 17, rate, burst_s)
    assert got == _releases(jw, 17, rate, burst_s)
    assert len([r for r in got if r[0] != "next"]) == 60


def test_rate_limiter_spends_match_reference():
    calls = [("release_time", "slow", 50.0, 0.0),
             ("try_spend", "slow", 50.0, 0.0),
             ("try_spend", "slow", 5.0, 0.5),
             ("release_time", "slow", 5.0, 0.5),
             ("try_spend", "fast", 1e6, 0.6),
             ("try_spend", "slow", 1.0, 60.0)]
    out = {}
    for name, w in PACKAGES.items():
        lim = w.TenantRateLimiter((w.TenantSpec("slow", token_rate=1.0),
                                   w.TenantSpec("fast")), burst_s=2.0)
        out[name] = [getattr(lim, f)(t, n, now) for f, t, n, now in calls]
    assert out["port"] == out["jax"]
    assert out["port"][1] is True and out["port"][2] is False


@pytest.mark.parametrize("xs", [[], [3.0], list(range(1, 101)),
                                [5.0, 1.0, 1.0, 9.0, 2.5] * 7,
                                [math.inf, 1.0, 2.0]])
def test_latency_percentiles_match_reference(xs):
    assert tw.latency_percentiles(xs) == jw.latency_percentiles(xs)


def _polls(w, seed, tps):
    feed = w.ArrivalFeed(w.PoissonArrivals(0.7, 20, seed=seed,
                                           tenants=_tenants(w)),
                         vocab_size=64, group_size=2, ticks_per_second=tps,
                         seed=seed)
    out, tick = [], 0
    while not feed.exhausted() and tick < 10_000:
        for arr, g in feed.poll(tick):
            out.append((tick, dataclasses.astuple(arr), g.group_id,
                        [(r.req_id, r.prompt, r.seed, r.max_new_tokens)
                         for r in g.requests]))
        tick += 1
    return out


@pytest.mark.parametrize("seed,tps", [(0, 1.0), (9, 2.0), (123, 0.5)])
def test_feed_poll_matches_reference(seed, tps):
    got = _polls(tw, seed, tps)
    assert got == _polls(jw, seed, tps)
    assert sorted(g[1][1] for g in got) == list(range(20))
    assert all(t / tps + 1e-9 >= arr[0] for t, arr, _, _ in got)


def test_arrival_spec_process_matches_reference():
    specs = [w.ArrivalSpec(rate=2.0, seed=4, tenants=TENANTS,
                           rate_schedule=((5.0, 8.0),))
             for w in (tw, jw)]
    got, want = (s.process(25, w.LengthSampler(gen_mean=32, gen_sigma=0.5))
                 .trace() for s, w in zip(specs, (tw, jw)))
    assert _tuples(got) == _tuples(want)
    assert [t.name for t in specs[0].tenant_specs()] == ["a", "b"]


# -- the bench_serving workload ------------------------------------------------


@pytest.fixture(scope="module")
def serving():
    return {w: h.workload("serving", w) for w in ("jax", "port")}


def test_closed_loop_equivalence(serving):
    port, ref = serving["port"], serving["jax"]
    assert port["closed_loop_equivalent"] and ref["closed_loop_equivalent"]
    assert h.timeless(port["closed_loop"]) == h.timeless(ref["closed_loop"])
    assert port["responses"] == ref["responses"]
    assert port["sustainable_rate_groups_per_tick"] == \
        ref["sustainable_rate_groups_per_tick"]
    assert port["slo_deadline_s"] == ref["slo_deadline_s"]


@pytest.mark.parametrize("run", ["calibration", "one_x", "two_x",
                                 "two_x_repeat"])
def test_serve_report_matches_reference(serving, run):
    port, ref = serving["port"][run], serving["jax"][run]
    assert h.timeless(port) == h.timeless(ref)
    assert port["host_syncs"] == port["engine_steps"] > 0
    assert port["offered_groups"] == chip_smoke.SERVE_GROUPS


def test_serving_sheds_only_under_overload_and_repeats(serving):
    port = serving["port"]
    assert port["one_x"]["shed_groups"] == 0
    assert port["one_x"]["admitted_groups"] == chip_smoke.SERVE_GROUPS
    assert 1 <= port["two_x"]["shed_groups"] < chip_smoke.SERVE_GROUPS
    assert port["deterministic"]
    assert port["two_x"]["latency_ticks"]["p50"] <= \
        port["two_x"]["latency_ticks"]["p999"] < math.inf
    assert h.timeless(port) == h.timeless(serving["jax"])
