"""Context-aware scheduling on top of divided rollout (paper Alg. 2).

The scheduler is invoked whenever an instance has head-room; it returns a
``(request, instance)`` decision.  Policies:

* ``seer``      — Alg. 2: speculative requests first (SFS by generated
                  length), then approximate LFS on L̂_g, with a starvation
                  safeguard that occasionally serves the most underserved
                  group (§3.3).
* ``fifo``      — submission order (veRL-style round-robin baseline).
* ``sfs``/``lfs`` — shortest/longest-first on *true* lengths (oracle
                  variants; ``lfs`` is the paper's Oracle in Fig. 10).
* ``nocontext`` — divided rollout without length context (Fig. 10's
                  No-Context): FIFO pick, load-balanced placement.

Instance choice (SELECTINSTANCE) is KV-usage aware: the least-loaded
instance that can hold the chunk's worst-case footprint.
"""
from __future__ import annotations

import dataclasses
import heapq
from dataclasses import dataclass, field
from typing import (Callable, Dict, List, Optional, Protocol, Sequence,
                    Tuple)

from repro_torch.core.context import ContextManager
from repro_torch.core.request import Group, ReqState, RolloutRequest


@dataclass
class InstanceView:
    """What the global scheduler sees of one inference instance."""
    instance_id: str
    free_slots: int
    kv_free_tokens: int            # KV head-room in tokens
    active_requests: int = 0
    # prefill tokens queued but not yet written (batched prefill): KV
    # accounting already covers their footprint, but each queued token is
    # a step of compute the instance owes before its decode rows speed up
    queued_prefill_tokens: int = 0
    # which host the instance lives on: placements on the node already
    # holding a request's KV blob skip the inter-node fabric hop
    node: str = "n0"


class Scheduler:
    """Ready requests are tracked incrementally (token-validated lazy
    heaps / per-group buckets) so each pick is O(log N) for the static-key
    policies and O(#groups) for seer's dynamic-L̂ scan — the naive rebuild
    + full scan per pick was the simulator's bottleneck at production
    request counts.  Callers must hand a request back via :meth:`requeue`
    when its chunk ends (rather than flipping ``state`` directly)."""

    def __init__(self, groups: Sequence[Group], ctx: ContextManager, *,
                 policy: str = "seer", chunk_size: int = 512,
                 starvation_every: int = 16,
                 oracle_lengths: Optional[Dict[str, int]] = None,
                 fetch_cost: Optional[
                     Callable[[RolloutRequest, str], float]] = None,
                 rank_mode: str = "total_delay",
                 queue_cost_per_token: float = 0.0,
                 slo_deadline_s: Optional[float] = None):
        self.policy = policy
        self.chunk_size = chunk_size
        self.ctx = ctx
        # (request, node) -> modeled seconds to bring the request's KV
        # blob to that node (0 when it has none).  None = topology-blind
        # placement (pure load balance)
        self.fetch_cost = fetch_cost
        if rank_mode not in ("total_delay", "lexicographic"):
            raise ValueError(f"rank_mode={rank_mode!r}")
        # placement ranking: "total_delay" folds fetch cost and queue
        # delay into ONE modeled unit (seconds); "lexicographic" keeps
        # the old cost-then-headroom key for the topology bench
        # comparison
        self.rank_mode = rank_mode
        # modeled seconds each queued prefill token delays a newly
        # placed chunk by (marginal mixed-step cost); 0 = queue depth
        # doesn't enter the delay ranking
        self.queue_cost_per_token = queue_cost_per_token
        # SLO-aware admission (open-loop serving): an offered group is
        # shed instead of queued when its modeled admission delay — the
        # same total-delay unit select_instance ranks placements by,
        # plus the ready-buffer backlog ahead of it — exceeds this
        # deadline.  None = queue forever (the closed-loop default);
        # the decision is a pure function of scheduler state, so a
        # seeded arrival trace sheds identically on every run.
        self.slo_deadline_s = slo_deadline_s
        # optional flight-recorder hook (repro_torch.obs.Tracer) — set by
        # run_stream; offer/select decisions emit instant events
        self.tracer = None
        self.shed_groups = 0
        self.shed_requests = 0
        # modeled delay of every offer_group decision, in offer order
        # (admitted and shed alike) — the serving bench derives its SLO
        # deadline from the 1x run's spread
        self.offer_delays: List[float] = []
        self.groups: Dict[str, Group] = {}
        self._starvation_every = starvation_every
        self._decisions = 0
        self._oracle = oracle_lengths or {}
        self._submit_order: Dict[str, int] = {}
        # incremental ready-tracking (token-validated entries)
        self._token: Dict[str, int] = {}
        self._heap: List[tuple] = []                # fifo / sfs / lfs
        self._spec_ready: Dict[str, RolloutRequest] = {}   # seer probes
        self._buckets: Dict[str, List[tuple]] = {}  # gid -> (submit, tok, r)
        self.add_groups(groups)

    def add_groups(self, groups: Sequence[Group]) -> None:
        """Submit more groups mid-run (bounded-staleness tail packing):
        next-epoch prompts join the ready buffer behind the existing
        submit order and compete for slots through the normal admission
        path — RollPacker-style bubble filling, no special casing."""
        n = len(self._submit_order)
        for g in groups:
            self.groups[g.group_id] = g
            self.ctx.register_group(g)
            for r in g.requests:
                self._submit_order[r.req_id] = n
                n += 1
                self._insert(r)

    # -- candidate pools -------------------------------------------------------

    def _ready(self) -> List[RolloutRequest]:
        out = []
        for g in self.groups.values():
            for r in g.requests:
                if r.state in (ReqState.PENDING, ReqState.READY):
                    out.append(r)
        return out

    def _insert(self, r: RolloutRequest) -> None:
        tok = self._token.get(r.req_id, 0) + 1
        self._token[r.req_id] = tok
        p = self.policy
        so = self._submit_order[r.req_id]
        if p == "seer":
            if r.speculative:
                self._spec_ready[r.req_id] = r
            else:
                heapq.heappush(
                    self._buckets.setdefault(r.group_id, []), (so, tok, r))
        elif p in ("fifo", "nocontext"):
            heapq.heappush(self._heap, (so, tok, r))
        elif p == "sfs":
            heapq.heappush(self._heap, (self._true_len(r), so, tok, r))
        elif p == "lfs":
            heapq.heappush(self._heap, (-self._true_len(r), so, tok, r))
        else:
            raise ValueError(p)

    def requeue(self, r: RolloutRequest) -> None:
        """Hand a request back to the buffer (chunk ended / not placed)."""
        r.state = ReqState.READY
        self._insert(r)

    def _valid(self, r: RolloutRequest, tok: int) -> bool:
        return self._token.get(r.req_id) == tok and not r.finished \
            and r.state in (ReqState.PENDING, ReqState.READY)

    def _take(self, r: RolloutRequest) -> RolloutRequest:
        # invalidate any other live entries for this request
        self._token[r.req_id] = self._token.get(r.req_id, 0) + 1
        self._spec_ready.pop(r.req_id, None)
        return r

    def _clean_bucket(self, gid: str) -> Optional[tuple]:
        """Drop stale head entries; return the valid head or None."""
        b = self._buckets.get(gid)
        while b:
            so, tok, r = b[0]
            if self._valid(r, tok):
                return b[0]
            heapq.heappop(b)
        if b is not None and not b:
            self._buckets.pop(gid, None)
        return None

    # -- Alg. 2 ------------------------------------------------------------------

    def pick_request(self) -> Optional[RolloutRequest]:
        # count only decisions that yield a request (starvation cadence)
        self._decisions += 1
        r = self._pick()
        if r is None:
            self._decisions -= 1
        return r

    def _pick(self) -> Optional[RolloutRequest]:
        if self.policy == "seer":
            return self._pick_seer()
        while self._heap:
            entry = heapq.heappop(self._heap)
            r, tok = entry[-1], entry[-2]
            if self._valid(r, tok):
                return self._take(r)
        return None

    def _true_len(self, r: RolloutRequest) -> int:
        return self._oracle.get(r.req_id, r.max_new_tokens)

    def _spec_candidates(self) -> List[RolloutRequest]:
        stale = [rid for rid, r in self._spec_ready.items()
                 if r.finished or r.state not in (ReqState.PENDING,
                                                  ReqState.READY)]
        for rid in stale:
            del self._spec_ready[rid]
        return list(self._spec_ready.values())

    def _pick_seer(self) -> Optional[RolloutRequest]:
        spec = self._spec_candidates()
        # starvation safeguard: periodically serve the least-served group
        if self._starvation_every and \
                self._decisions % self._starvation_every == 0:
            cands: List[RolloutRequest] = list(spec)
            for gid in list(self._buckets):
                head = self._clean_bucket(gid)
                if head is not None:
                    cands.append(head[-1])
            if cands:
                starved = min(
                    cands,
                    key=lambda r: (self.ctx.group_progress(r.group_id),
                                   self._submit_order[r.req_id]))
                return self._take(starved)
            return None
        # 1) high-priority queue: speculative requests, shortest-first on
        #    the length generated so far (PICKSFS)
        if spec:
            best = min(spec, key=lambda r: (r.gen_len,
                                            self._submit_order[r.req_id]))
            return self._take(best)
        # 2) the rest: approximate longest-first on L̂_g (PICKLFS).
        #    Unknown groups have L̂_g = max_gen_length => scheduled first.
        #    O(#groups): within a group every request shares L̂_g, so only
        #    bucket heads compete (tie-break: smallest submit order).
        best_key, best_head = None, None
        for gid in list(self._buckets):
            head = self._clean_bucket(gid)
            if head is None:
                continue
            key = (self.ctx.estimate(gid), -head[0])
            if best_key is None or key > best_key:
                best_key, best_head = key, head
        if best_head is not None:
            return self._take(best_head[-1])
        return None

    # -- chunk sizing + instance choice (Alg. 2 lines 16-17) --------------------

    def chunk_tokens(self, r: RolloutRequest) -> int:
        return min(self.chunk_size, r.remaining_tokens)

    def select_instance(self, instances: Sequence[InstanceView],
                        r: RolloutRequest) -> Optional[str]:
        """Cheapest-to-reach, then least-loaded instance with room for
        the chunk's footprint.

        With a ``fetch_cost`` oracle the primary key is the modeled
        transfer cost of bringing the request's KV blob to the
        candidate's node — the node already holding the blob wins over a
        cross-node hop (ICI-vs-PCIe asymmetry), and fresh requests
        (cost 0 everywhere) fall through to pure load balance.  Load is
        KV head-room net of queued prefill: a pool miss dumps the
        request's whole context back onto the prefill queue, so an
        instance with a deep backlog is busier than its KV occupancy
        alone suggests (the admission itself is still immediate — queued
        prefill rides along with mixed steps)."""
        need = len(r.prompt) + r.gen_len + self.chunk_tokens(r)
        best, best_key = None, None
        for iv in instances:
            if iv.free_slots <= 0:
                continue
            if iv.kv_free_tokens < need:
                continue
            cost = self.fetch_cost(r, iv.node) if self.fetch_cost else 0.0
            effective_free = iv.kv_free_tokens - iv.queued_prefill_tokens
            if self.rank_mode == "total_delay":
                # ONE modeled unit: seconds until the chunk actually
                # runs = blob transfer + serialization behind the
                # queued prefill backlog.  A tiny fetch saving can no
                # longer beat a deep queue (and vice versa) the way the
                # lexicographic key allowed; head-room only tie-breaks.
                delay = cost + iv.queued_prefill_tokens \
                    * self.queue_cost_per_token
                key = (-delay, effective_free)
            # lexicographic (legacy): an overloaded instance (prefill
            # backlog >= KV head-room) never wins on locality alone — a
            # tiny blob-transfer saving must not serialize the chunk
            # behind a deep queue while a less-loaded peer sits idle.
            # Under saturation (every candidate overloaded) load stays
            # primary and locality demotes to the tie-break.
            elif effective_free > 0:
                key = (1, -cost, effective_free)
            else:
                key = (0, effective_free, -cost)
            if best_key is None or key > best_key:
                best, best_key = iv.instance_id, key
        if best is not None and self.tracer is not None:
            self.tracer.instant("select", "scheduler", "scheduler",
                                req=r.req_id, instance=best)
        return best

    def predict_resume_node(self, instances: Sequence[InstanceView],
                            r: RolloutRequest,
                            home_node: str) -> Optional[str]:
        """Node the scheduler expects ``r``'s next chunk to resume on —
        the placement-aware *export* oracle.

        Mirrors :meth:`select_instance`'s ranking with the cost the
        scheduler WILL see if the blob stays home (0 on the releasing
        node, one fabric hop elsewhere) — so the blob moves exactly
        when the real admission would place the resume off-home anyway:
        home instances slot-saturated (e.g. taken over the moment they
        drained) or overloaded (prefill backlog >= KV head-room) while
        a foreign node has an open, fit instance.  Then the fabric leg
        is paid at export time, batched inside the overlap window,
        instead of stalling the admission-path fetch.  A blob whose
        home still wins stays put (moving on a load hunch just
        ping-pongs bytes).  Returns None (keep home) when home wins or
        nothing fits."""
        need = len(r.prompt) + r.gen_len + self.chunk_tokens(r)
        best, best_key = None, None
        for iv in instances:
            if iv.kv_free_tokens < need:
                continue
            cost = 0.0 if iv.node == home_node else 1.0
            effective_free = iv.kv_free_tokens - iv.queued_prefill_tokens
            if effective_free > 0 and iv.free_slots > 0:
                key = (1, -cost, effective_free)
            else:
                key = (0, min(effective_free, 0), -cost,
                       effective_free)
            if best_key is None or key > best_key:
                best, best_key = iv.node, key
        return None if best == home_node else best

    def plan_admissions(self, instances: Sequence[InstanceView]
                        ) -> List[Tuple[RolloutRequest, str]]:
        """Batch of (request, instance) decisions for one scheduling
        cycle, grouped so same-node (and within a node, same-instance)
        migrations land together — the engine imports all of an
        instance's arriving KV blobs in one batched scatter instead of
        one per admission, and a node's arrivals batch their fabric
        transfers.  Views are decremented locally as requests are
        planned (free slots, KV head-room net of the chunk's worst-case
        footprint), mirroring the one-at-a-time loop this replaces."""
        views = {v.instance_id: dataclasses.replace(v)
                 for v in instances}
        plan: List[Tuple[RolloutRequest, str]] = []
        while True:
            open_views = [v for v in views.values() if v.free_slots > 0]
            if not open_views:
                break
            r = self.pick_request()
            if r is None:
                break
            iid = self.select_instance(open_views, r)
            if iid is None:
                self.requeue(r)   # no instance can host it this cycle
                break
            v = views[iid]
            v.free_slots -= 1
            v.active_requests += 1
            v.kv_free_tokens -= len(r.prompt) + r.gen_len \
                + self.chunk_tokens(r)
            plan.append((r, iid))
        plan.sort(key=lambda p: (views[p[1]].node, p[1]))
        return plan

    # -- SLO-aware admission (open-loop serving) ---------------------------------

    def ready_backlog_tokens(self) -> int:
        """Chunk tokens buffered ahead of a new offer (ready requests
        not yet running) — the queue component of the admission delay."""
        return sum(min(self.chunk_size, r.remaining_tokens)
                   for r in self._ready())

    def modeled_admission_delay(self, instances: Sequence[InstanceView],
                                r: RolloutRequest) -> float:
        """Modeled seconds before a newly offered request's first chunk
        would run: the total-delay placement unit (KV-fetch cost +
        the target's queued-prefill serialization) for the best
        candidate instance, plus the ready-buffer backlog draining in
        parallel across the fleet.  This is the deadline test's input —
        deliberately the same currency ``select_instance`` ranks
        placements by, so queue-vs-shed and placement agree on what
        "busy" means."""
        n = max(len(instances), 1)
        backlog = self.ready_backlog_tokens() * self.queue_cost_per_token / n
        # in-flight chunks also stand ahead of the offer once every slot
        # is taken: charge the mean remaining chunk as queued work
        occupied = sum(iv.active_requests for iv in instances)
        has_free = any(iv.free_slots > 0 for iv in instances)
        if not has_free:
            backlog += occupied * self.chunk_size \
                * self.queue_cost_per_token / n
        best = None
        for iv in instances:
            cost = self.fetch_cost(r, iv.node) if self.fetch_cost else 0.0
            delay = cost + iv.queued_prefill_tokens \
                * self.queue_cost_per_token
            if best is None or delay < best:
                best = delay
        return (best or 0.0) + backlog

    def offer_group(self, g: Group,
                    instances: Sequence[InstanceView]) -> bool:
        """Open-loop admission: queue ``g`` (True) or shed it (False).

        With no ``slo_deadline_s`` every offer queues — bit-identical to
        :meth:`add_groups` — but the modeled delay is still recorded in
        ``offer_delays``, so a deadline-free calibration run can derive
        a realistic deadline for the gated runs.  Otherwise the group is
        shed when its modeled admission delay exceeds the deadline; shed
        groups never enter the buffer (``all_finished`` ignores them)
        and only the counters remember them."""
        if g.requests:
            delay = self.modeled_admission_delay(instances, g.requests[0])
            self.offer_delays.append(delay)
            if self.slo_deadline_s is not None \
                    and delay > self.slo_deadline_s:
                self.shed_groups += 1
                self.shed_requests += len(g.requests)
                if self.tracer is not None:
                    self.tracer.instant(
                        "offer", "scheduler", "scheduler",
                        group=g.group_id, delay_s=delay, admitted=False)
                return False
            if self.tracer is not None:
                self.tracer.instant(
                    "offer", "scheduler", "scheduler",
                    group=g.group_id, delay_s=delay, admitted=True)
        self.add_groups([g])
        return True

    # -- lifecycle callbacks -----------------------------------------------------

    def on_finished(self, r: RolloutRequest) -> None:
        self.ctx.update_estimate(r.group_id, r.gen_len)

    @property
    def all_finished(self) -> bool:
        return all(g.all_finished for g in self.groups.values())

    def pending_count(self) -> int:
        return sum(1 for g in self.groups.values()
                   for r in g.requests if not r.finished)

    def ready_count(self) -> int:
        """Unfinished requests sitting in the buffer (not running) —
        the streaming loop's tail-bubble probe: free slots + an empty
        buffer means injected next-epoch prompts would be admitted."""
        return len(self._ready())
