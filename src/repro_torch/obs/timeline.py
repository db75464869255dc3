"""Per-request phase timelines and tail-latency attribution.

A request's life in divided rollout is a sequence of *phases*:

``queue``     buffered in the scheduler (offer -> admit, or between
              chunks while other requests hold the slots)
``prefill``   its slot is running prefill chunks (first admission or a
              pool-miss re-prefill)
``decode``    decode/verify steps (speculative or plain)
``migrate``   released at a chunk boundary: KV export, pool residence
              and the re-admission fetch
``stuck``     placed on a hung instance (fault injection / watchdog
              window)
``recovery``  lost to an instance crash, waiting to be reconstructed
              (blob resume or rewind+replay)
``refresh``   re-anchoring after an in-flight weight refresh (the
              re-prefill / revalidation window)

The :class:`TimelineRecorder` classifies every live request into
exactly one phase per stream-loop tick (``end_tick``), which makes the
**span-conservation invariant** hold by construction: each finished
request's phase durations tile its wall interval exactly, in ticks and
— through the tracer's monotone tick->seconds table — in modeled
seconds.  ``tail_attribution`` then decomposes p99/p999 and the
last-10% tail window into these phases; the report is the flight
recorder's answer to "*why* is the tail long", not just "how long".
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

from repro_torch.obs.trace import Tracer

#: The closed phase vocabulary.  Both tiers' request spans must draw
#: their names from this tuple (the bench's schema-match gate).
PHASES = ("queue", "prefill", "decode", "migrate", "stuck", "recovery",
          "refresh")


@dataclass
class RequestTimeline:
    """One request's reconstructed timeline.

    ``segments`` are ``(phase, tick0, tick1)`` half-open tick spans;
    ``spans_s`` the matching ``(phase, t0, t1)`` modeled-second spans.
    ``end_tick`` is exclusive (the tick after the finishing tick);
    ``None`` while the request is still open (or was shed).
    """

    req_id: str
    group_id: str = ""
    tenant: str = "-"
    submit_tick: int = 0
    end_tick: Optional[int] = None
    finished: bool = False
    shed: bool = False
    segments: List[Tuple[str, int, int]] = field(default_factory=list)
    spans_s: List[Tuple[str, float, float]] = field(default_factory=list)

    @property
    def wall_ticks(self) -> int:
        if self.end_tick is None:
            return 0
        return self.end_tick - self.submit_tick

    @property
    def wall_seconds(self) -> float:
        if not self.spans_s:
            return 0.0
        return self.spans_s[-1][2] - self.spans_s[0][1]

    def phase_seconds(self) -> Dict[str, float]:
        out: Dict[str, float] = {}
        for ph, t0, t1 in self.spans_s:
            out[ph] = out.get(ph, 0.0) + (t1 - t0)
        return out

    def conserved(self, rel: float = 1e-9) -> bool:
        """Phase durations tile the wall interval: contiguous spans,
        summing to the wall in modeled seconds (and, when the segments
        carry real ticks, exactly in ticks)."""
        if not self.spans_s:
            return not self.finished
        for (_, _, a1), (_, b0, _) in zip(self.spans_s, self.spans_s[1:]):
            if abs(b0 - a1) > rel * max(abs(a1), 1.0):
                return False
        total = sum(t1 - t0 for _, t0, t1 in self.spans_s)
        wall = self.wall_seconds
        return abs(total - wall) <= rel * max(abs(wall), 1.0)


class _Rec:
    __slots__ = ("req_id", "group_id", "tenant", "submit_tick", "pending",
                 "refresh_flag", "segs", "closed", "finished", "shed",
                 "end_tick")

    def __init__(self, req_id: str, group_id: str, tenant: str,
                 submit_tick: int):
        self.req_id = req_id
        self.group_id = group_id
        self.tenant = tenant
        self.submit_tick = submit_tick
        self.pending: str = "queue"   # phase while not placed on a slot
        self.refresh_flag = False     # next prefill window is a re-anchor
        self.segs: List[List] = []    # [phase, tick0, tick1] run-length
        self.closed = False
        self.finished = False
        self.shed = False
        self.end_tick: Optional[int] = None


class TimelineRecorder:
    """Tick-boundary request-lifecycle recorder.

    The rollout calls the ``on_*`` hooks as lifecycle transitions
    happen (all host-side, all at points where no step ticket is in
    flight) and :meth:`end_tick` once per tick with the placed
    requests' engine states; the recorder turns that into run-length
    phase segments and, at :meth:`finalize`, emits one ``"X"`` span per
    segment (cat ``"request"``, track = req id) into the tracer.
    """

    def __init__(self, tracer: Tracer):
        self.tracer = tracer
        self._recs: Dict[str, _Rec] = {}

    # -- lifecycle hooks ---------------------------------------------------

    def on_submit(self, req_id: str, group_id: str, tick: int,
                  tenant: str = "-") -> None:
        if req_id in self._recs:
            return
        self._recs[req_id] = _Rec(req_id, group_id, tenant, tick)

    def on_admit(self, req_id: str, instance_id: str, tick: int) -> None:
        rec = self._recs.get(req_id)
        if rec is None:
            return
        rec.pending = "queue"
        self.tracer.instant("admit", "request", req_id, tick=tick,
                            instance=instance_id)

    def on_release(self, req_id: str, tick: int) -> None:
        """Chunk boundary: the request left its slot; until the next
        admission its time is migration (export + pool + fetch)."""
        rec = self._recs.get(req_id)
        if rec is not None:
            rec.pending = "migrate"

    def on_renew(self, req_id: str, tick: int) -> None:
        """Final-chunk in-place renewal — no phase change, but worth an
        instant (the request skipped a migrate window)."""
        self.tracer.instant("inplace_renew", "request", req_id, tick=tick)

    def on_crash(self, req_id: str, tick: int, kind: str) -> None:
        """The request's instance died; ``kind`` is the recovery path
        ("blob" resume or rewind+"replay")."""
        rec = self._recs.get(req_id)
        if rec is not None:
            rec.pending = "recovery"
        self.tracer.instant("recovery", "request", req_id, tick=tick,
                            kind=kind)

    def on_refresh(self, req_ids: Sequence[str], tick: int) -> None:
        """In-flight weight refresh: each live request's next prefill
        window is a re-anchor, classified ``refresh`` not ``prefill``."""
        for rid in req_ids:
            rec = self._recs.get(rid)
            if rec is not None and not rec.closed:
                rec.refresh_flag = True

    def on_finish(self, req_id: str, tick: int) -> None:
        rec = self._recs.get(req_id)
        if rec is None or rec.closed:
            return
        # the finishing tick was a decode/verify step (finish only
        # happens at a commit); end_tick skips closed records
        self._append(rec, "decode", tick)
        rec.closed = True
        rec.finished = True
        rec.end_tick = tick + 1
        self.tracer.instant("finish", "request", req_id, tick=tick,
                            group=rec.group_id)

    def on_shed(self, req_id: str, group_id: str, tick: int,
                tenant: str = "-") -> None:
        rec = self._recs.setdefault(
            req_id, _Rec(req_id, group_id, tenant, tick))
        rec.closed = True
        rec.shed = True
        self.tracer.instant("shed", "request", req_id, tick=tick,
                            group=group_id, tenant=tenant)

    # -- per-tick classification -------------------------------------------

    def end_tick(self, tick: int, placed: Dict[str, str]) -> None:
        """Classify every open request into exactly one phase for
        ``tick``.  ``placed`` maps req_id -> engine state ("prefill" |
        "decode" | "stuck") for requests currently holding a slot;
        everything else gets its pending reason."""
        for rec in self._recs.values():
            if rec.closed or rec.submit_tick > tick:
                continue
            phase = placed.get(rec.req_id) or rec.pending
            if rec.refresh_flag:
                if phase == "prefill":
                    phase = "refresh"
                elif phase == "decode":
                    rec.refresh_flag = False
            self._append(rec, phase, tick)

    @staticmethod
    def _append(rec: _Rec, phase: str, tick: int) -> None:
        if rec.segs and rec.segs[-1][0] == phase \
                and rec.segs[-1][2] == tick:
            rec.segs[-1][2] = tick + 1
        else:
            # gaps cannot occur (every tick classifies every open
            # request exactly once); if bookkeeping ever broke that,
            # the conservation check downstream flags it rather than
            # this silently papering over it
            rec.segs.append([phase, tick, tick + 1])

    # -- emission ----------------------------------------------------------

    def finalize(self) -> None:
        """Emit every record's phase segments as request spans."""
        for rec in self._recs.values():
            for phase, a, b in rec.segs:
                self.tracer.span(phase, "request", rec.req_id, a, b,
                                 tenant=rec.tenant, group=rec.group_id)


# -- reconstruction ----------------------------------------------------------


def timelines_from_events(events: Sequence[dict]
                          ) -> Dict[str, RequestTimeline]:
    """Rebuild per-request timelines from resolved trace events (either
    tier's; ``Tracer.events()`` or ``Tracer.from_chrome`` output)."""
    out: Dict[str, RequestTimeline] = {}

    def rec(rid: str) -> RequestTimeline:
        return out.setdefault(rid, RequestTimeline(req_id=rid))

    for e in events:
        if e["cat"] != "request":
            continue
        rid = e["track"]
        if e["ph"] == "X":
            tl = rec(rid)
            tl.segments.append((e["name"], e["tick0"], e["tick1"]))
            tl.spans_s.append((e["name"], e["t0"], e["t1"]))
            tl.tenant = e["args"].get("tenant", tl.tenant)
            tl.group_id = e["args"].get("group", tl.group_id)
        elif e["name"] == "finish":
            tl = rec(rid)
            tl.finished = True
            tl.end_tick = e["tick0"] + 1
        elif e["name"] == "shed":
            tl = rec(rid)
            tl.shed = True
            tl.tenant = e["args"].get("tenant", tl.tenant)
    for tl in out.values():
        tl.segments.sort(key=lambda s: s[1])
        tl.spans_s.sort(key=lambda s: s[1])
        if tl.segments:
            tl.submit_tick = tl.segments[0][1]
            if tl.finished and tl.end_tick is None:
                tl.end_tick = tl.segments[-1][2]
    return out


# -- tail attribution --------------------------------------------------------


def _pct(xs: Sequence[float], q: float) -> float:
    """Nearest-rank percentile (matches the serving bench's idiom)."""
    if not xs:
        return 0.0
    s = sorted(xs)
    k = min(len(s) - 1, max(0, math.ceil(q * len(s)) - 1))
    return s[k]


def _cohort(tls: Sequence[RequestTimeline], threshold: float) -> dict:
    cohort = [tl for tl in tls if tl.wall_seconds >= threshold]
    phases: Dict[str, float] = {}
    for tl in cohort:
        for ph, secs in tl.phase_seconds().items():
            phases[ph] = phases.get(ph, 0.0) + secs
    total = sum(phases.values())
    return {
        "n": len(cohort),
        "threshold_s": threshold,
        "phases": {ph: {"seconds": secs,
                        "frac": secs / max(total, 1e-12)}
                   for ph, secs in sorted(phases.items())},
    }


def tail_attribution(timelines: Dict[str, RequestTimeline]) -> dict:
    """Decompose tail latency into phases.

    Over the finished timelines: wall-latency percentiles, the
    all-requests per-phase totals, and per-phase decompositions of the
    p99 cohort, the p999 cohort and the last-10% tail window (requests
    at or above p90 wall latency).  ``conserved`` is the
    span-conservation invariant over every finished request.
    """
    done = [tl for tl in timelines.values() if tl.finished]
    walls = [tl.wall_seconds for tl in done]
    phases: Dict[str, float] = {}
    for tl in done:
        for ph, secs in tl.phase_seconds().items():
            phases[ph] = phases.get(ph, 0.0) + secs
    return {
        "requests": len(done),
        "shed": sum(1 for tl in timelines.values() if tl.shed),
        "conserved": all(tl.conserved() for tl in done),
        "wall_s": {"p50": _pct(walls, 0.50), "p90": _pct(walls, 0.90),
                   "p99": _pct(walls, 0.99), "p999": _pct(walls, 0.999),
                   "max": max(walls, default=0.0)},
        "phase_totals_s": dict(sorted(phases.items())),
        "cohorts": {
            "p99": _cohort(done, _pct(walls, 0.99)),
            "p999": _cohort(done, _pct(walls, 0.999)),
            "tail10": _cohort(done, _pct(walls, 0.90)),
        },
        "per_tenant": {
            tenant: {
                "n": len(ws),
                "p99_s": _pct(ws, 0.99),
            }
            for tenant, ws in sorted(_by_tenant(done).items())
        },
    }


def _by_tenant(done: Sequence[RequestTimeline]
               ) -> Dict[str, List[float]]:
    out: Dict[str, List[float]] = {}
    for tl in done:
        out.setdefault(tl.tenant, []).append(tl.wall_seconds)
    return out


def format_attribution(report: dict) -> str:
    """Human-readable attribution table (trace_report.py / --trace)."""
    lines = []
    w = report["wall_s"]
    lines.append(f"requests={report['requests']} shed={report['shed']} "
                 f"conserved={report['conserved']}")
    lines.append(f"wall_s  p50={w['p50']:.6g}  p90={w['p90']:.6g}  "
                 f"p99={w['p99']:.6g}  p999={w['p999']:.6g}  "
                 f"max={w['max']:.6g}")
    cols = [ph for ph in PHASES
            if any(ph in report["cohorts"][c]["phases"]
                   for c in report["cohorts"])
            or ph in report["phase_totals_s"]]
    header = f"{'cohort':>8} {'n':>5} " + \
        " ".join(f"{ph:>9}" for ph in cols)
    lines.append(header)
    lines.append("-" * len(header))
    total = sum(report["phase_totals_s"].values())
    row = f"{'all':>8} {report['requests']:>5} " + " ".join(
        f"{report['phase_totals_s'].get(ph, 0.0) / max(total, 1e-12):>8.1%}"
        for ph in cols)
    lines.append(row)
    for name in ("tail10", "p99", "p999"):
        c = report["cohorts"][name]
        row = f"{name:>8} {c['n']:>5} " + " ".join(
            f"{c['phases'].get(ph, {}).get('frac', 0.0):>8.1%}"
            for ph in cols)
        lines.append(row)
    if report["per_tenant"]:
        lines.append("per-tenant p99_s: " + "  ".join(
            f"{t}={v['p99_s']:.6g} (n={v['n']})"
            for t, v in report["per_tenant"].items()))
    return "\n".join(lines)
