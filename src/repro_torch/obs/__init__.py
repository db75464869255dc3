"""Flight-recorder observability for the Seer rollout stack.

``repro_torch.obs`` is a zero-extra-host-sync tracing layer: every event is
host-side metadata recorded at stream-loop tick boundaries (the same
no-step-ticket-in-flight contract as ``inject()``/``refresh_params()``),
so tracing never adds a device read and a traced run is bit-identical —
tokens, steps, host syncs — to an untraced one.

* :mod:`repro_torch.obs.trace` — the :class:`~repro_torch.obs.trace.Tracer`
  (span/instant events, tick + modeled-seconds clocks, Chrome
  trace-event JSON export).
* :mod:`repro_torch.obs.timeline` — per-request phase timelines
  (:class:`~repro_torch.obs.timeline.RequestTimeline`), the tick-boundary
  :class:`~repro_torch.obs.timeline.TimelineRecorder`, and the
  tail-latency attribution report.
"""
from repro_torch.obs.trace import TraceEvent, Tracer
from repro_torch.obs.timeline import (PHASES, RequestTimeline, TimelineRecorder,
                                format_attribution, tail_attribution,
                                timelines_from_events)

__all__ = [
    "TraceEvent", "Tracer", "PHASES", "RequestTimeline",
    "TimelineRecorder", "tail_attribution", "timelines_from_events",
    "format_attribution",
]
