"""Deterministic fault injection for the divided-rollout engine.

A :class:`FaultInjector` holds a seeded schedule of :class:`FaultEvent`s
keyed by *tick index* of the stream loop.  ``SeerRollout`` consults the
injector exactly once per tick (``begin_tick``), at the tick boundary
where no :class:`StepTicket` is in flight, so a faulted run is fully
replayable: the same schedule against the same workload produces the
same crashes, the same recoveries, and — the invariant everything here
exists to test — the same tokens as a no-fault oracle run.

Event kinds
-----------
``crash``
    The named instance dies at the top of the tick.  Its KV cache, any
    draining export buffers and in-flight bookkeeping are lost; every
    live request on it is reconstructed by the rollout's recovery path
    (pool blob when one exists at the request's chunk boundary,
    otherwise rewind-to-prompt + replay via the ``reval_queue``).  With
    ``lose_pool=True`` the victims' pool entries are dropped too,
    forcing the replay path.
``stuck``
    The named instance stops making progress for ``ticks`` ticks (a
    hung worker, not a dead one).  The stream loop's watchdog counts
    ticks an instance holds work without progressing and escalates a
    stuck instance to a crash after ``watchdog_ticks``.
``fetch_fail`` / ``corrupt``
    The next ``count`` pool fetches (optionally restricted to
    ``req_id``) fail outright / return a blob whose checksum does not
    match.  The rollout retries with modeled backoff and, after its
    retry budget, degrades to replay-based recovery.

Events are armed at their tick and, for the fetch kinds, stay armed
until consumed — a fetch at tick 7 can be failed by an event armed at
tick 5 if no fetch happened in between, which keeps schedules
meaningful on workloads whose fetch timing shifts.  Armed fetch events
are consumed *oldest first, one per fetch attempt* (retries included),
so two fetch events arming on the same tick land on successive retries
of one fetch rather than on two distinct fetches; the constructor
warns (``RuntimeWarning``) when a schedule does that.
"""
from __future__ import annotations

import random
import warnings
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence

FAULT_KINDS = ("crash", "stuck", "fetch_fail", "corrupt")


@dataclass(frozen=True)
class FaultEvent:
    """One scheduled fault.  ``tick`` is the stream-loop tick index."""

    tick: int
    kind: str                       # one of FAULT_KINDS
    instance_id: Optional[str] = None   # crash/stuck target
    ticks: int = 1                  # stuck duration
    req_id: Optional[str] = None    # fetch_fail/corrupt filter (None = any)
    count: int = 1                  # number of fetches affected
    lose_pool: bool = False         # crash: drop victims' pool entries too

    def __post_init__(self) -> None:
        if self.kind not in FAULT_KINDS:
            raise ValueError(f"unknown fault kind: {self.kind!r}")
        if self.kind in ("crash", "stuck") and self.instance_id is None:
            raise ValueError(f"{self.kind} event needs instance_id")


@dataclass
class _ArmedFetch:
    kind: str
    req_id: Optional[str]
    remaining: int


class FaultInjector:
    """Replayable fault schedule, consumed by ``SeerRollout.run_stream``.

    The injector is single-use per stream: tick arming and fetch-event
    consumption are stateful.  Build a fresh injector (or call
    ``reset()``) for each run you want to compare.
    """

    def __init__(self, events: Sequence[FaultEvent] = ()):  # noqa: D107
        self.events: List[FaultEvent] = list(events)
        self._by_tick: Dict[int, List[FaultEvent]] = {}
        for ev in self.events:
            self._by_tick.setdefault(ev.tick, []).append(ev)
        for tick, evs in sorted(self._by_tick.items()):
            fetchy = [ev for ev in evs
                      if ev.kind in ("fetch_fail", "corrupt")]
            if len(fetchy) > 1:
                # gotcha: same-tick fetch events arm together, and
                # fetch_outcome consumes oldest-first per retry — so the
                # SECOND event here only fires once the first's count is
                # exhausted, which usually means on retries of the SAME
                # fetch, not on a later fetch as schedules tend to
                # intend.  Legal (consumption order is documented and
                # pinned by tests) but rarely what you want.
                warnings.warn(
                    f"FaultInjector: {len(fetchy)} fetch-kind events "
                    f"({', '.join(ev.kind for ev in fetchy)}) arm on the "
                    f"same tick {tick}; they are consumed oldest-first "
                    "per fetch attempt, so later events land on retries "
                    "of the same fetch — stagger ticks if each event "
                    "should hit a distinct fetch", RuntimeWarning,
                    stacklevel=2)
        self._armed: List[_ArmedFetch] = []
        self.fired: List[FaultEvent] = []
        # optional flight-recorder hook (repro_torch.obs.Tracer) — set by
        # run_stream; each armed event emits a fault_<kind> instant
        self.tracer = None

    def reset(self) -> None:
        self._armed = []
        self.fired = []

    # -- stream-loop hooks -------------------------------------------------
    def begin_tick(self, tick: int) -> List[FaultEvent]:
        """Arm this tick's events.  Returns the crash/stuck events for the
        rollout to apply; fetch events are retained internally and consumed
        through :meth:`fetch_outcome`."""
        out: List[FaultEvent] = []
        for ev in self._by_tick.get(tick, ()):  # schedule order is stable
            self.fired.append(ev)
            if self.tracer is not None:
                self.tracer.instant(
                    f"fault_{ev.kind}", "fault",
                    ev.instance_id or "pool", tick=tick,
                    lose_pool=ev.lose_pool, count=ev.count)
            if ev.kind in ("fetch_fail", "corrupt"):
                self._armed.append(_ArmedFetch(ev.kind, ev.req_id, ev.count))
            else:
                out.append(ev)
        return out

    def fetch_outcome(self, req_id: str) -> str:
        """Outcome for one pool-fetch attempt: "ok", "fail" or "corrupt".

        Consumes one unit from the oldest armed fetch event matching
        ``req_id`` (events with ``req_id=None`` match any request)."""
        for armed in self._armed:
            if armed.remaining <= 0:
                continue
            if armed.req_id is not None and armed.req_id != req_id:
                continue
            armed.remaining -= 1
            return "fail" if armed.kind == "fetch_fail" else "corrupt"
        return "ok"

    # -- schedule generation ----------------------------------------------
    @classmethod
    def seeded(cls, seed: int, instance_ids: Sequence[str], horizon: int, *,
               crash_rate: float = 0.0, stuck_rate: float = 0.0,
               fetch_fail_rate: float = 0.0, corrupt_rate: float = 0.0,
               stuck_ticks: int = 2, max_crashes: Optional[int] = None,
               lose_pool_frac: float = 0.0) -> "FaultInjector":
        """Generate a deterministic schedule over ``horizon`` ticks.

        Per tick, each live-looking fault class fires with its rate;
        crash victims are drawn round-robin-free from ``instance_ids``
        but never the last remaining instance (a schedule that kills
        every instance is not recoverable by construction and raises in
        the rollout instead)."""
        rng = random.Random(seed)
        alive = list(instance_ids)
        events: List[FaultEvent] = []
        crashes = 0
        budget = (len(alive) - 1 if max_crashes is None
                  else min(max_crashes, len(alive) - 1))
        for tick in range(horizon):
            if crashes < budget and rng.random() < crash_rate:
                victim = alive.pop(rng.randrange(len(alive)))
                events.append(FaultEvent(
                    tick=tick, kind="crash", instance_id=victim,
                    lose_pool=rng.random() < lose_pool_frac))
                crashes += 1
            if alive and rng.random() < stuck_rate:
                events.append(FaultEvent(
                    tick=tick, kind="stuck",
                    instance_id=rng.choice(alive), ticks=stuck_ticks))
            if rng.random() < fetch_fail_rate:
                events.append(FaultEvent(tick=tick, kind="fetch_fail",
                                         count=1 + rng.randrange(2)))
            if rng.random() < corrupt_rate:
                events.append(FaultEvent(tick=tick, kind="corrupt"))
        return cls(events)
