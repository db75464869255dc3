"""Tick-boundary event tracer for the rollout engine and the simulator.

Design constraints (the whole reason this module exists as its own
layer instead of ``print`` calls):

* **Zero extra host syncs.**  Every value an event carries is host-side
  metadata the stream loop already holds (slot counts, req ids, modeled
  seconds).  No hook may touch a device tensor — the engine's
  1-host-sync-per-step contract is enforced by transfer-guard tests
  with a tracer attached.
* **Two clocks, both deterministic.**  Events are stamped in stream-loop
  *ticks* (the engine's only real notion of time) and in *modeled
  seconds* derived from :class:`~repro_torch.core.sdmodel.ForwardCostModel`.
  Wall-clock never appears: a trace is a pure function of
  (seed, config), so two runs of the same config serialize identically
  — the bit-determinism gate in ``check_bench``.
* **One schema for engine and simulator.**  The simulator emits the
  same :class:`TraceEvent` shape with explicit modeled timestamps, so
  the two tiers' traces are directly diffable.

The engine tier records ticks and resolves modeled seconds lazily
through the tracer's cumulative tick table (:meth:`Tracer.advance_tick`
appends one modeled-step duration per tick).  The mapping is monotone
and additive, so span conservation proved in ticks carries over to
seconds.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional

#: Event categories — the fixed vocabulary both tiers emit.
CATEGORIES = ("request", "instance", "scheduler", "pool", "fault",
              "feed", "train")

#: Keys every serialized event carries (the cross-tier schema).
SCHEMA_KEYS = ("name", "cat", "ph", "track", "tick0", "tick1",
               "t0", "t1", "args")


@dataclass
class TraceEvent:
    """One recorded event.

    ``ph`` follows the Chrome trace-event phase vocabulary: ``"X"`` is a
    complete span over ``[tick0, tick1)``, ``"i"`` an instant at
    ``tick0``.  ``t0``/``t1`` are modeled seconds; ``None`` means
    "resolve from the tracer's tick table at export time" (the engine
    tier), an explicit float is kept verbatim (the simulator tier).
    """

    name: str
    cat: str
    ph: str
    track: str
    tick0: int
    tick1: int
    t0: Optional[float] = None
    t1: Optional[float] = None
    args: dict = field(default_factory=dict)


class Tracer:
    """Append-only event recorder with a cumulative modeled clock.

    The stream loop calls :meth:`begin_tick` at each tick boundary and
    :meth:`advance_tick` with the tick's modeled duration at its end;
    hooks anywhere in between stamp events with :attr:`cur_tick`
    implicitly.  ``events()`` returns the resolved, serializable view;
    ``to_chrome()``/``from_chrome()`` round-trip Perfetto-loadable
    Chrome trace-event JSON.
    """

    def __init__(self) -> None:
        self._events: List[TraceEvent] = []
        # _tick_t[k] = modeled seconds at the START of tick k; grown by
        # one entry per advance_tick, so after N ticks it has N+1 points
        self._tick_t: List[float] = [0.0]
        self.cur_tick: int = 0

    def __len__(self) -> int:
        return len(self._events)

    # -- modeled clock -----------------------------------------------------

    def begin_tick(self, tick: int) -> None:
        """Tick boundary: subsequent events default to this tick."""
        self.cur_tick = int(tick)

    def advance_tick(self, dt: float) -> None:
        """End of tick: append its modeled duration to the clock table."""
        self._tick_t.append(self._tick_t[-1] + max(float(dt), 0.0))

    def tick_time(self, tick: int) -> float:
        """Modeled seconds at the start of ``tick`` (clamped to the
        recorded range, so late ticks saturate at the run's end)."""
        i = min(max(int(tick), 0), len(self._tick_t) - 1)
        return self._tick_t[i]

    # -- recording ---------------------------------------------------------

    def instant(self, name: str, cat: str, track: str, *,
                tick: Optional[int] = None,
                t: Optional[float] = None, **args) -> None:
        k = self.cur_tick if tick is None else int(tick)
        self._events.append(TraceEvent(
            name=name, cat=cat, ph="i", track=str(track),
            tick0=k, tick1=k, t0=t, t1=t, args=args))

    def span(self, name: str, cat: str, track: str,
             tick0: int, tick1: int, *,
             t0: Optional[float] = None, t1: Optional[float] = None,
             **args) -> None:
        self._events.append(TraceEvent(
            name=name, cat=cat, ph="X", track=str(track),
            tick0=int(tick0), tick1=int(tick1), t0=t0, t1=t1, args=args))

    # -- export ------------------------------------------------------------

    def events(self) -> List[dict]:
        """Resolved, serializable events (insertion order).

        Tick-stamped events get their modeled seconds from the tick
        table here; explicitly-timed events keep their floats.  The
        returned dicts all carry exactly :data:`SCHEMA_KEYS`.
        """
        out = []
        for e in self._events:
            t0 = e.t0 if e.t0 is not None else self.tick_time(e.tick0)
            t1 = e.t1 if e.t1 is not None else self.tick_time(e.tick1)
            out.append({
                "name": e.name, "cat": e.cat, "ph": e.ph,
                "track": e.track, "tick0": e.tick0, "tick1": e.tick1,
                "t0": t0, "t1": t1, "args": dict(e.args),
            })
        return out

    def to_chrome(self) -> dict:
        """Chrome trace-event JSON (Perfetto-loadable).

        Tracks map to threads of one process; modeled seconds map to
        microsecond ``ts``.  The exact resolved event (ticks and float
        seconds) rides along in ``args`` so :meth:`from_chrome` is a
        lossless inverse of :meth:`events`.
        """
        tids: Dict[str, int] = {}
        trace_events = []
        for e in self.events():
            tid = tids.setdefault(e["track"], len(tids) + 1)
            args = dict(e["args"])
            args.update(track=e["track"], tick0=e["tick0"],
                        tick1=e["tick1"], t0=e["t0"], t1=e["t1"])
            ev = {"name": e["name"], "cat": e["cat"], "ph": e["ph"],
                  "pid": 1, "tid": tid,
                  "ts": e["t0"] * 1e6, "args": args}
            if e["ph"] == "X":
                ev["dur"] = max(e["t1"] - e["t0"], 0.0) * 1e6
            else:
                ev["s"] = "t"
            trace_events.append(ev)
        meta = [{"name": "thread_name", "ph": "M", "pid": 1, "tid": tid,
                 "args": {"name": track}}
                for track, tid in tids.items()]
        return {"traceEvents": meta + trace_events,
                "displayTimeUnit": "ms"}

    @staticmethod
    def from_chrome(obj: dict) -> List[dict]:
        """Rebuild the :meth:`events` view from Chrome JSON."""
        out = []
        for ev in obj.get("traceEvents", []):
            if ev.get("ph") == "M":
                continue
            args = dict(ev.get("args", {}))
            track = args.pop("track")
            tick0 = args.pop("tick0")
            tick1 = args.pop("tick1")
            t0 = args.pop("t0")
            t1 = args.pop("t1")
            out.append({
                "name": ev["name"], "cat": ev["cat"], "ph": ev["ph"],
                "track": track, "tick0": tick0, "tick1": tick1,
                "t0": t0, "t1": t1, "args": args,
            })
        return out


def schema_keys(events: List[dict]) -> List[str]:
    """Sorted union of top-level keys across ``events`` — the
    engine-vs-simulator schema-diff primitive."""
    keys = set()
    for e in events:
        keys.update(e.keys())
    return sorted(keys)
