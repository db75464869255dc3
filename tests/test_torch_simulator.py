"""The port's workload generator (``repro_torch.data.workload``) and
cluster simulator (``repro_torch.core.simulator``) against the JAX
package's on the same seeds: ``make_workload``'s arrays for each
``WorkloadSpec`` at a small scale, ``length_stats`` and
``group_token_streams``; then ``SimResult`` field for field for fixed
(seed, ``SimConfig``) in group, request, divided (context-aware and
not), grouped-SD, StreamRL, partial, faulted, open-loop and overlapped
runs."""
import dataclasses

import numpy as np
import pytest

import repro.configs as jconfigs
import repro.core.simulator as jsim
import repro.data.workload as jwl
import repro_torch.configs as tconfigs
import repro_torch.core.simulator as tsim
import repro_torch.data.workload as twl

SPECS = ("moonlight", "qwen2-vl-72b", "kimi-k2")


def _small(wl, name, **kw):
    return dataclasses.replace(wl.WORKLOADS[name], **dict(dict(
        n_requests=64, max_gen_length=4096, mean_gen_length=1000), **kw))


@pytest.mark.parametrize("seed", [0, 5])
@pytest.mark.parametrize("name", SPECS)
def test_make_workload_matches_reference(name, seed):
    got = twl.make_workload(_small(twl, name), seed=seed, with_tokens=True,
                            vocab=512)
    want = jwl.make_workload(_small(jwl, name), seed=seed, with_tokens=True,
                             vocab=512)
    assert got.lengths.dtype == want.lengths.dtype
    np.testing.assert_array_equal(got.lengths, want.lengths)
    assert got.tokens == want.tokens
    assert got.n_groups == want.n_groups == 64 // got.spec.group_size
    assert got.stats() == want.stats()
    cut = twl.make_workload(_small(twl, name), seed=seed, n_groups=3)
    np.testing.assert_array_equal(cut.lengths, want.lengths[:3])


@pytest.mark.parametrize("name", SPECS)
def test_presets_and_length_stats_match_reference(name):
    assert dataclasses.asdict(twl.WORKLOADS[name]) == \
        dataclasses.asdict(jwl.WORKLOADS[name])
    spec = twl.WORKLOADS[name]
    lt = twl.sample_lengths(spec, np.random.default_rng(3))
    lj = jwl.sample_lengths(jwl.WORKLOADS[name], np.random.default_rng(3))
    np.testing.assert_array_equal(lt, lj)
    assert twl.length_stats(lt) == jwl.length_stats(lj)


@pytest.mark.parametrize("seed,similarity", [(1, 0.85), (2, 0.3)])
def test_group_token_streams_match_reference(seed, similarity):
    lens = [37, 200, 5, 96]
    kw = dict(vocab=300, similarity=similarity, segment=16)
    got = twl.group_token_streams(np.random.default_rng(seed), 4, lens,
                                  **kw)
    want = jwl.group_token_streams(np.random.default_rng(seed), 4, lens,
                                   **kw)
    assert got == want
    assert [len(t) for t in got] == lens


# (SimConfig fields, the arrival spec's fields or None); the spec is
# moonlight at 48 requests on 2 instances, yi-6b on one chip each
CASES = {
    "group": dict(mode="group", policy="fifo"),
    "request": dict(mode="request", policy="fifo"),
    "divided": dict(mode="divided", policy="seer"),
    "divided_nocontext": dict(mode="divided", policy="nocontext"),
    "divided_grouped_sd": dict(mode="divided", policy="seer",
                               sd="grouped"),
    "streamrl": dict(mode="streamrl", policy="fifo"),
    "partial": dict(mode="partial", policy="fifo", over_issue=2.0),
    "faults": dict(mode="divided", policy="seer", fault_rate=0.05,
                   mttr_ticks=8, seed=3),
    "open_loop": dict(mode="divided", policy="seer", sd="none",
                      arrival=dict(rate=0.05, seed=3,
                                   tenants=(("a", 2.0, 1e7),
                                            ("b", 1.0, 1e7)),
                                   slo_deadline_s=30.0)),
    "overlap": dict(mode="divided", policy="seer", async_overlap=True,
                    barrier_reclaim=0.75, final_chunk_inplace=True),
}


def _sim(pkg, cfgs, wl, case, seed):
    kw = dict(max_slots=16, chips_per_instance=1, kv_capacity_tokens=40_000,
              chunk_size=512)
    kw.update(CASES[case])
    if "arrival" in kw:
        from importlib import import_module
        w = import_module(pkg.__name__.replace("simulator", "workload"))
        kw["arrival"] = w.ArrivalSpec(**kw["arrival"])
    spec = dataclasses.replace(wl.MOONLIGHT, n_requests=48, group_size=4,
                               n_instances=2, max_gen_length=8192,
                               mean_gen_length=2000)
    return pkg.ClusterSimulator(cfgs.get_config("yi-6b"), spec,
                                pkg.SimConfig(**kw)).run(
        wl.make_workload(spec, seed=seed))


@pytest.mark.parametrize("seed", [0, 11])
@pytest.mark.parametrize("case", list(CASES))
def test_sim_result_matches_reference(case, seed):
    got = _sim(tsim, tconfigs, twl, case, seed)
    want = _sim(jsim, jconfigs, jwl, case, seed)
    for f in dataclasses.fields(want):
        a, b = getattr(got, f.name), getattr(want, f.name)
        if isinstance(b, np.ndarray):
            assert a.dtype == b.dtype, f.name
            np.testing.assert_array_equal(a, b, err_msg=f.name)
        else:
            assert a == b, f.name
    assert got.mean_acceptance_len == want.mean_acceptance_len
    assert got.n_requests > 0 and got.total_time > 0.0
    if case == "open_loop":
        assert got.extras["serving"]["offered_groups"] == 12
    if case == "faults":
        assert got.extras["fault_events"] > 0


def test_sim_arrival_requires_divided_mode():
    from repro_torch.core.workload import ArrivalSpec
    spec = dataclasses.replace(twl.MOONLIGHT, n_requests=16, n_instances=2)
    sim = tsim.ClusterSimulator(
        tconfigs.get_config("yi-6b"), spec,
        tsim.SimConfig(arrival=ArrivalSpec(rate=1.0), mode="group",
                       policy="fifo", max_slots=48, chips_per_instance=1,
                       kv_capacity_tokens=150_000))
    with pytest.raises(ValueError):
        sim.run(twl.make_workload(spec, seed=0))
