"""Open-loop serving front-end: trace-driven arrivals for the rollout.

Everything upstream of this module is closed-loop — a fixed request list
drains to empty.  A production Seer deployment instead faces *traffic*:
prompts arrive continuously, tenants compete for token budget, and under
overload the scheduler must choose between queueing (blowing the SLO for
everyone) and shedding (bounding latency for the admitted).  This module
is that front-end, in three layers:

* :class:`ArrivalProcess` — a seeded source of :class:`Arrival` events
  (Helix-style rate source + length sampler).  ``PoissonArrivals`` draws
  exponential inter-arrival gaps from a piecewise-constant rate
  schedule; ``TraceArrivals`` replays a recorded trace exactly, so any
  generated trace round-trips (record once, replay forever).
* :class:`TenantRateLimiter` + :class:`ArrivalQueue` — client-side
  per-tenant token buckets (runcue-style rate limiting): an arrival is
  *released* to the scheduler at ``max(arrival time, bucket release)``;
  a throttled head blocks only its own tenant.  Budget is spent at
  release (offered load is metered whether or not the server later
  sheds — client-side limits do not refund on 503).
* :class:`ArrivalFeed` — binds a trace to ``SeerRollout.run_stream``:
  the rollout polls the feed at every tick boundary (the same
  no-ticket-in-flight contract as ``inject()``) and offers released
  groups to the scheduler's SLO-aware admission
  (:meth:`~repro_torch.core.scheduler.Scheduler.offer_group`: queue vs shed
  on the modeled total-delay).  The feed keeps the graceful-
  overload books: per-tenant goodput, shed counts, queue depths and
  per-request latency percentiles in ticks.

Everything here is a pure function of (seed, config): arrival times,
tenant draws, prompt tokens, release order and therefore — because the
scheduler's deadline test is itself deterministic — every shedding
decision.  The overload fuzz and the bench determinism gate both lean
on that invariant.

The simulator tier consumes the same :class:`ArrivalSpec` /
:class:`ArrivalQueue` machinery (``SimConfig.arrival``) so cluster-scale
p50/p99/p999 under overload stays a few seconds of wall time.
"""
from __future__ import annotations

import math
import random
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

from repro_torch.core.request import Group, make_groups

__all__ = [
    "Arrival", "TenantSpec", "LengthSampler", "ArrivalProcess",
    "PoissonArrivals", "TraceArrivals", "TenantRateLimiter",
    "ArrivalQueue", "ArrivalFeed", "ArrivalSpec", "latency_percentiles",
    "serve",
]


@dataclass(frozen=True)
class Arrival:
    """One offered group: arrival time (modeled seconds since stream
    start), a dense index (names the group and seeds its prompt), the
    owning tenant, and the sampled shape."""
    t: float
    index: int
    tenant: str
    prompt_len: int
    max_new_tokens: int


@dataclass(frozen=True)
class TenantSpec:
    """One traffic source.  ``weight`` biases the arrival process's
    tenant draw; ``token_rate`` is the client-side budget in tokens per
    second (prompt + requested decode, summed over the group) — infinite
    by default, i.e. no throttling."""
    name: str
    weight: float = 1.0
    token_rate: float = math.inf


DEFAULT_TENANT = TenantSpec("default")


class LengthSampler:
    """Helix-style length model: bounded-uniform prompt lengths and
    lognormal (heavy-tailed) generation lengths, clipped to
    ``[gen_min, gen_max]`` — the same shape family as the Table 3
    workloads in :mod:`repro_torch.data.workload`, but per-arrival."""

    def __init__(self, *, prompt_len: int = 64, prompt_jitter: int = 0,
                 gen_mean: int = 128, gen_sigma: float = 0.0,
                 gen_min: int = 1, gen_max: Optional[int] = None):
        if prompt_len <= 0:
            raise ValueError("prompt_len must be positive")
        self.prompt_len = prompt_len
        self.prompt_jitter = max(0, prompt_jitter)
        self.gen_mean = gen_mean
        self.gen_sigma = gen_sigma
        self.gen_min = max(1, gen_min)
        self.gen_max = gen_max if gen_max is not None \
            else max(gen_mean * 4, gen_min)

    def sample(self, rng: random.Random) -> Tuple[int, int]:
        plen = self.prompt_len
        if self.prompt_jitter:
            plen += rng.randrange(self.prompt_jitter + 1)
        if self.gen_sigma > 0.0:
            mu = math.log(max(self.gen_mean, 1)) - self.gen_sigma ** 2 / 2
            glen = int(round(rng.lognormvariate(mu, self.gen_sigma)))
        else:
            glen = self.gen_mean
        return plen, min(max(glen, self.gen_min), self.gen_max)


class ArrivalProcess:
    """Base: a deterministic, materializable source of arrivals."""

    def trace(self) -> List[Arrival]:
        raise NotImplementedError

    @property
    def tenants(self) -> Tuple[TenantSpec, ...]:
        return (DEFAULT_TENANT,)


class PoissonArrivals(ArrivalProcess):
    """Seeded Poisson arrivals with a piecewise-constant rate source.

    ``rate`` is group arrivals per second; ``rate_schedule`` (optional)
    is ``[(t_start, rate), ...]`` breakpoints — the Helix trace-generator
    idiom of a time-varying arrival-rate source — overriding ``rate``
    from each breakpoint on.  Tenants are drawn by weight from the same
    seeded stream, so the full trace (times, tenants, lengths) is a pure
    function of (seed, config)."""

    def __init__(self, rate: float, n: int, *, seed: int = 0,
                 tenants: Sequence[TenantSpec] = (DEFAULT_TENANT,),
                 lengths: Optional[LengthSampler] = None,
                 rate_schedule: Optional[
                     Sequence[Tuple[float, float]]] = None):
        if rate <= 0.0 and not rate_schedule:
            raise ValueError("arrival rate must be positive")
        if not tenants:
            raise ValueError("need at least one tenant")
        self.rate = rate
        self.n = int(n)
        self.seed = seed
        self._tenants = tuple(tenants)
        self.lengths = lengths or LengthSampler()
        self.rate_schedule = tuple(sorted(rate_schedule or ()))
        self._trace: Optional[List[Arrival]] = None

    @property
    def tenants(self) -> Tuple[TenantSpec, ...]:
        return self._tenants

    def _rate_at(self, t: float) -> float:
        r = self.rate
        for t0, r0 in self.rate_schedule:
            if t >= t0:
                r = r0
        return max(r, 1e-12)

    def trace(self) -> List[Arrival]:
        if self._trace is None:
            rng = random.Random(self.seed * 0x9E3779B1 + 0x7F4A7C15)
            weights = [max(ts.weight, 0.0) for ts in self._tenants]
            out: List[Arrival] = []
            t = 0.0
            for i in range(self.n):
                t += rng.expovariate(self._rate_at(t))
                tenant = rng.choices(self._tenants, weights=weights)[0]
                plen, glen = self.lengths.sample(rng)
                out.append(Arrival(t=t, index=i, tenant=tenant.name,
                                   prompt_len=plen, max_new_tokens=glen))
            self._trace = out
        return list(self._trace)


class TraceArrivals(ArrivalProcess):
    """Replay a recorded trace exactly (arrivals sorted by time; the
    round-trip ``TraceArrivals(p.trace()).trace() == p.trace()`` is a
    property-tested identity)."""

    def __init__(self, trace: Sequence[Arrival],
                 tenants: Sequence[TenantSpec] = ()):
        self._trace = sorted(trace, key=lambda a: (a.t, a.index))
        if tenants:
            self._tenants = tuple(tenants)
        else:
            seen: Dict[str, TenantSpec] = {}
            for a in self._trace:
                seen.setdefault(a.tenant, TenantSpec(a.tenant))
            self._tenants = tuple(seen.values()) or (DEFAULT_TENANT,)

    @property
    def tenants(self) -> Tuple[TenantSpec, ...]:
        return self._tenants

    def trace(self) -> List[Arrival]:
        return list(self._trace)


class TenantRateLimiter:
    """Per-tenant token buckets (client-side rate limiting).

    Each tenant's bucket refills at ``token_rate`` tokens/s up to
    ``token_rate * burst_s`` capacity.  ``release_time`` answers when a
    spend of ``tokens`` could happen; ``try_spend`` performs it.  The
    guarantee the property suite pins: tokens released for one tenant
    over ANY window ``[t, t+w]`` never exceed ``burst + rate * w``
    (provided no single spend exceeds the burst capacity; a larger
    spend is allowed once the bucket is full and drives the level
    negative, delaying later releases until the deficit refills —
    long-window rates still converge to ``token_rate``)."""

    def __init__(self, tenants: Sequence[TenantSpec], *,
                 burst_s: float = 1.0):
        self.burst_s = burst_s
        self._rate: Dict[str, float] = {}
        self._cap: Dict[str, float] = {}
        self._level: Dict[str, float] = {}
        self._t: Dict[str, float] = {}
        for ts in tenants:
            self._rate[ts.name] = ts.token_rate
            cap = ts.token_rate * burst_s if math.isfinite(ts.token_rate) \
                else math.inf
            self._cap[ts.name] = cap
            self._level[ts.name] = cap
            self._t[ts.name] = 0.0

    def _refill(self, tenant: str, now: float) -> float:
        rate = self._rate.get(tenant, math.inf)
        if not math.isfinite(rate):
            return math.inf
        dt = max(0.0, now - self._t[tenant])
        self._level[tenant] = min(self._cap[tenant],
                                  self._level[tenant] + rate * dt)
        self._t[tenant] = now
        return self._level[tenant]

    def release_time(self, tenant: str, tokens: float, now: float) -> float:
        """Earliest ``t >= now`` at which ``tokens`` could be spent."""
        rate = self._rate.get(tenant, math.inf)
        if not math.isfinite(rate):
            return now
        level = self._refill(tenant, now)
        need = min(float(tokens), self._cap[tenant])
        if level >= need:
            return now
        return now + (need - level) / max(rate, 1e-12)

    def try_spend(self, tenant: str, tokens: float, now: float) -> bool:
        """Spend ``tokens`` if the bucket allows it at ``now``."""
        rate = self._rate.get(tenant, math.inf)
        if not math.isfinite(rate):
            return True
        level = self._refill(tenant, now)
        need = min(float(tokens), self._cap[tenant])
        if level < need - 1e-9:
            return False
        self._level[tenant] = level - float(tokens)
        return True


def _group_tokens(arr: Arrival, group_size: int) -> int:
    """Token demand one offered group places on its tenant's budget."""
    return (arr.prompt_len + arr.max_new_tokens) * group_size


class ArrivalQueue:
    """Per-tenant FIFO release logic shared by the engine feed and the
    simulator: an arrival is *releasable* once the clock passes both its
    arrival time and its tenant's rate-limiter release; a throttled head
    blocks only its own tenant.  Releases spend the bucket (offered
    load is metered client-side, shed or not)."""

    def __init__(self, trace: Sequence[Arrival],
                 limiter: TenantRateLimiter, group_size: int):
        self.limiter = limiter
        self.group_size = group_size
        self._pending: List[Arrival] = sorted(
            trace, key=lambda a: (a.t, a.index))
        self._heads: Dict[str, int] = {}

    @property
    def empty(self) -> bool:
        return not self._pending

    def pending_count(self) -> int:
        return len(self._pending)

    def release_ready(self, now: float) -> List[Arrival]:
        """Pop every arrival releasable at ``now``, in (t, index) order
        (per-tenant FIFO: a throttled arrival blocks its tenant's later
        arrivals but nobody else's)."""
        out: List[Arrival] = []
        blocked: set = set()
        keep: List[Arrival] = []
        for i, arr in enumerate(self._pending):
            if arr.t > now + 1e-12:
                keep.extend(self._pending[i:])
                break
            if arr.tenant in blocked:
                keep.append(arr)
                continue
            toks = _group_tokens(arr, self.group_size)
            if self.limiter.try_spend(arr.tenant, toks, now):
                out.append(arr)
            else:
                blocked.add(arr.tenant)
                keep.append(arr)
        self._pending = keep
        return out

    def next_release_time(self, now: float) -> Optional[float]:
        """Earliest future time any pending arrival becomes releasable
        (a lower bound: later spends can only push releases later)."""
        best: Optional[float] = None
        seen: set = set()
        for arr in self._pending:
            if arr.tenant in seen:
                continue
            seen.add(arr.tenant)
            toks = _group_tokens(arr, self.group_size)
            t = max(arr.t, self.limiter.release_time(
                arr.tenant, toks, max(now, arr.t)))
            if best is None or t < best:
                best = t
        return best


def latency_percentiles(xs: Sequence[float]) -> Dict[str, float]:
    """p50/p99/p999 by nearest-rank on a sorted copy (pure python, no
    interpolation: deterministic across numpy versions).  Empty input
    reports ``inf`` so a gate on finiteness fails loudly instead of
    passing on a run that completed nothing."""
    if not xs:
        return {"p50": math.inf, "p99": math.inf, "p999": math.inf}
    s = sorted(xs)
    n = len(s)

    def rank(q: float) -> float:
        return s[min(n - 1, max(0, math.ceil(q * n) - 1))]

    return {"p50": rank(0.50), "p99": rank(0.99), "p999": rank(0.999)}


class ArrivalFeed:
    """Binds an arrival trace to one ``SeerRollout.run_stream`` run.

    The rollout polls the feed at every tick boundary — the same
    no-step-ticket-in-flight contract as ``inject()`` — converting ticks
    to modeled seconds via ``ticks_per_second``.  Released groups are
    offered to the scheduler's SLO admission; the feed records the
    outcome and keeps the overload accounting (latency in ticks, shed
    counts, per-tenant goodput, queue depths).

    ``groups`` may pre-build the offered :class:`Group` objects (one per
    arrival, in trace order) — the closed-loop equivalence tests feed
    the legacy fixed list through a t=0 trace this way.  Otherwise
    groups are built deterministically from (seed, arrival index):
    prompt tokens from a per-arrival ``random.Random``, request seeds
    via :func:`make_groups`.
    """

    def __init__(self, process: ArrivalProcess, *, vocab_size: int = 0,
                 group_size: int = 2, ticks_per_second: float = 1.0,
                 temperature: float = 1.0,
                 stop_token: Optional[int] = None, seed: int = 0,
                 prefix: str = "srv", burst_s: float = 1.0,
                 groups: Optional[Sequence[Group]] = None):
        if ticks_per_second <= 0.0:
            raise ValueError("ticks_per_second must be positive")
        trace = process.trace()
        if groups is not None and len(groups) != len(trace):
            raise ValueError("pre-built groups must match the trace 1:1")
        if groups is None and vocab_size < 3:
            raise ValueError("vocab_size needed to synthesize prompts")
        self.process = process
        self.group_size = group_size
        self.ticks_per_second = ticks_per_second
        self.temperature = temperature
        self.stop_token = stop_token
        self.seed = seed
        self.prefix = prefix
        self.vocab_size = vocab_size
        self.limiter = TenantRateLimiter(process.tenants, burst_s=burst_s)
        self.queue = ArrivalQueue(trace, self.limiter, group_size)
        self._prebuilt = list(groups) if groups is not None else None
        self._released: List[Tuple[Arrival, Group]] = []
        # -- accounting ----------------------------------------------------
        self.admitted: List[int] = []       # arrival indices, admit order
        self.shed: List[int] = []           # arrival indices, shed order
        self._tenant_of: Dict[str, str] = {}       # group_id -> tenant
        self._admit_tick: Dict[str, int] = {}      # req_id -> tick
        self._latency_ticks: List[float] = []
        self._per_tenant: Dict[str, Dict[str, float]] = {
            ts.name: {"arrived": 0, "admitted": 0, "shed": 0,
                      "goodput_tokens": 0}
            for ts in process.tenants
        }
        self.queue_depth_peak = 0
        self._depth_sum = 0
        self._depth_samples = 0
        self.last_tick = 0
        # optional flight-recorder hook (repro_torch.obs.Tracer) — set by
        # run_stream; admit/shed outcomes emit per-tenant instants
        self.tracer = None

    # -- trace -> groups ---------------------------------------------------

    def _build_group(self, arr: Arrival) -> Group:
        if self._prebuilt is not None:
            return self._prebuilt[arr.index]
        rng = random.Random(self.seed * 0x51ED2701 + arr.index * 7919 + 5)
        prompt = [rng.randrange(1, self.vocab_size - 1)
                  for _ in range(arr.prompt_len)]
        [g] = make_groups([prompt], self.group_size,
                          max_new_tokens=arr.max_new_tokens,
                          temperature=self.temperature,
                          stop_token=self.stop_token,
                          seed=self.seed * 31 + arr.index,
                          prefix=f"{self.prefix}{arr.index}_")
        return g

    # -- rollout-facing hooks (tick clock) ---------------------------------

    def exhausted(self) -> bool:
        return self.queue.empty and not self._released

    def poll(self, tick: int) -> List[Tuple[Arrival, Group]]:
        """Arrivals released by this tick, as (arrival, group) pairs.
        Called once per tick boundary by the stream loop."""
        now = tick / self.ticks_per_second
        out = self._released
        self._released = []
        for arr in self.queue.release_ready(now + 1e-9):
            out.append((arr, self._build_group(arr)))
        return out

    def note_admitted(self, arr: Arrival, g: Group, tick: int) -> None:
        pt = self._per_tenant[arr.tenant]
        pt["arrived"] += 1
        pt["admitted"] += 1
        self.admitted.append(arr.index)
        self._tenant_of[g.group_id] = arr.tenant
        for r in g.requests:
            self._admit_tick[r.req_id] = tick
        if self.tracer is not None:
            self.tracer.instant("arrival_admit", "feed", arr.tenant,
                                tick=tick, group=g.group_id,
                                index=arr.index)

    def note_shed(self, arr: Arrival, g: Group, tick: int) -> None:
        pt = self._per_tenant[arr.tenant]
        pt["arrived"] += 1
        pt["shed"] += 1
        self.shed.append(arr.index)
        if self.tracer is not None:
            self.tracer.instant("arrival_shed", "feed", arr.tenant,
                                tick=tick, group=g.group_id,
                                index=arr.index)

    def note_request_finished(self, req_id: str, group_id: str,
                              tick: int, tokens: int) -> None:
        t0 = self._admit_tick.get(req_id)
        if t0 is None:
            return
        self._latency_ticks.append(float(tick - t0))
        tenant = self._tenant_of.get(group_id)
        if tenant is not None:
            self._per_tenant[tenant]["goodput_tokens"] += tokens

    def note_tick(self, tick: int, queue_depth: int) -> None:
        self.last_tick = tick
        self.queue_depth_peak = max(self.queue_depth_peak, queue_depth)
        self._depth_sum += queue_depth
        self._depth_samples += 1

    # -- reporting ---------------------------------------------------------

    def report(self) -> dict:
        elapsed = max(self.last_tick + 1, 1)
        per_tenant = {}
        for name, pt in self._per_tenant.items():
            per_tenant[name] = dict(
                pt, goodput_tokens_per_tick=pt["goodput_tokens"] / elapsed)
        lat = latency_percentiles(self._latency_ticks)
        return {
            "offered_groups": len(self.admitted) + len(self.shed),
            "admitted_groups": len(self.admitted),
            "shed_groups": len(self.shed),
            "shed_indices": list(self.shed),
            "elapsed_ticks": elapsed,
            "latency_ticks": lat,
            "completed_requests": len(self._latency_ticks),
            "goodput_tokens_per_tick":
                sum(pt["goodput_tokens"]
                    for pt in self._per_tenant.values()) / elapsed,
            "per_tenant": per_tenant,
            "queue_depth_peak": self.queue_depth_peak,
            "queue_depth_mean":
                self._depth_sum / max(self._depth_samples, 1),
        }


def serve(rollout, feed: ArrivalFeed, *,
          slo_deadline_s: Optional[float] = None,
          progress_every: int = 0) -> dict:
    """Drive one open-loop serving run to completion.

    Returns the feed's overload report plus the final
    :class:`~repro_torch.core.rollout.RolloutResult` under ``"result"``."""
    result = None
    for kind, payload in rollout.run_stream(
            [], progress_every=progress_every, arrivals=feed,
            slo_deadline_s=slo_deadline_s):
        if kind == "result":
            result = payload
    rep = feed.report()
    rep["result"] = result
    return rep


@dataclass(frozen=True)
class ArrivalSpec:
    """Declarative arrival config threaded through ``SimConfig`` (frozen
    so ``dataclasses.replace`` on SimConfig stays cheap and hashable-ish).

    ``tenants`` is ``((name, weight, token_rate), ...)``; empty means one
    unlimited tenant.  ``slo_deadline_s`` feeds the scheduler's queue-vs-
    shed deadline test (None = queue forever, never shed)."""
    rate: float
    seed: int = 0
    tenants: Tuple[Tuple[str, float, float], ...] = ()
    slo_deadline_s: Optional[float] = None
    burst_s: float = 1.0
    rate_schedule: Tuple[Tuple[float, float], ...] = ()

    def tenant_specs(self) -> Tuple[TenantSpec, ...]:
        if not self.tenants:
            return (DEFAULT_TENANT,)
        return tuple(TenantSpec(n, w, r) for n, w, r in self.tenants)

    def process(self, n: int,
                lengths: Optional[LengthSampler] = None) -> PoissonArrivals:
        return PoissonArrivals(
            self.rate, n, seed=self.seed, tenants=self.tenant_specs(),
            lengths=lengths or LengthSampler(),
            rate_schedule=self.rate_schedule or None)
