"""Harness of the port's serving, fault and tracing tests: granite-3-8b
tiny at f32 in both packages, the reference's weights
(``init_params(cfg, PRNGKey(1))``) carried across by the bridge, and the
reference's three real-engine workloads (``bench_engine_faults``,
``bench_observability``, ``bench_serving``) as ``chip_smoke.py`` restates
them on a package's API, here run on the JAX package and on the port on
the CPU."""
import dataclasses
import functools
import sys
import types
from pathlib import Path

import jax
import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
import chip_smoke  # noqa: E402

torch.set_num_threads(2)
ARCH = "granite-3-8b"


@functools.lru_cache(maxsize=None)
def models():
    """(jcfg, jax params, port cfg, port params) of the tiny model."""
    from repro.configs import get_tiny_config as jget_tiny
    from repro.models import init_params as jinit_params
    from repro_torch.bridge import params_from_jax
    from repro_torch.configs import get_tiny_config
    jcfg = dataclasses.replace(jget_tiny(ARCH), dtype="float32")
    tcfg = dataclasses.replace(get_tiny_config(ARCH), dtype="float32")
    jp, _ = jinit_params(jcfg, jax.random.PRNGKey(1))
    tp = params_from_jax(tcfg, jax.tree.map(np.asarray, jp), device="cpu")
    return jcfg, jp, tcfg, tp


def reference_api():
    """The JAX package's counterparts of ``chip_smoke.port_api``."""
    from repro.core import (ArrivalFeed, LengthSampler, PoissonArrivals,
                            SeerRollout, TenantSpec, TraceArrivals,
                            make_groups, serve)
    from repro.core.faults import FaultEvent, FaultInjector
    from repro.engine import StepFunctions
    from repro.obs import (PHASES, Tracer, format_attribution,
                           tail_attribution, timelines_from_events)
    from repro.obs.trace import SCHEMA_KEYS, schema_keys
    return types.SimpleNamespace(
        SeerRollout=SeerRollout, make_groups=make_groups,
        FaultEvent=FaultEvent, FaultInjector=FaultInjector,
        ArrivalFeed=ArrivalFeed, LengthSampler=LengthSampler,
        PoissonArrivals=PoissonArrivals, TenantSpec=TenantSpec,
        TraceArrivals=TraceArrivals, serve=serve,
        StepFunctions=StepFunctions, PHASES=PHASES, Tracer=Tracer,
        format_attribution=format_attribution,
        tail_attribution=tail_attribution,
        timelines_from_events=timelines_from_events,
        SCHEMA_KEYS=SCHEMA_KEYS, schema_keys=schema_keys)


def side(which: str):
    """(api, cfg, params) of the reference ("jax") or the port ("port",
    on the CPU)."""
    jcfg, jp, tcfg, tp = models()
    if which == "jax":
        return reference_api(), jcfg, jp
    return chip_smoke.port_api("cpu"), tcfg, tp


@functools.lru_cache(maxsize=None)
def step_functions(which: str):
    """One side's ``StepFunctions``, shared by the runs of a test file
    (the reference's compiled step shapes are cached there)."""
    api, cfg, _ = side(which)
    return api.StepFunctions(cfg)


@functools.lru_cache(maxsize=None)
def workload(name: str, which: str) -> dict:
    """One of ``chip_smoke``'s workloads ("faults", "trace", "serving")
    on one side, run once per process."""
    fn = {"faults": chip_smoke.faults_workload,
          "trace": chip_smoke.trace_workload,
          "serving": chip_smoke.serving_workload}[name]
    return fn(*side(which), steps=step_functions(which))


def timeless(x):
    """``x`` without its host-clock fields (``wall_s``)."""
    if isinstance(x, dict):
        return {k: timeless(v) for k, v in x.items() if k != "wall_s"}
    if isinstance(x, list):
        return [timeless(v) for v in x]
    return x
