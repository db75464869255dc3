"""Divided rollout runtime — the real-engine tier of Seer, in PyTorch.

Counterpart of ``repro.core.rollout``: the same closed loop, scheduler,
pool, DGDS drafting and chunk migration, driving the port's
:class:`~repro_torch.engine.engine.Instance`s.  Instances live on
``cuda`` unless the rollout is built with ``device="cpu"``.  The cost
model that sizes the adaptive prefill budget stays ``TPU_V5E`` so the
step plan matches the JAX package's.  The flight recorder (``tracer``,
a :class:`~repro_torch.obs.trace.Tracer`), open-loop arrivals
(``run_stream(arrivals=)``, an
:class:`~repro_torch.core.workload.ArrivalFeed`) and the fault paths run
as in the reference.  With ``tp=k`` every instance is sharded over the
same k ranks (``launch.mesh.engine_group``), each rank of the group
running this same rollout in lockstep (SPMD over ``torch.distributed``:
the engine gathers what every rank must agree on), and the cost model
is ``ForwardCostModel(cfg, TPU_V5E, tp=k)``, as in the reference.

Drives a pool of :class:`~repro_torch.engine.engine.Instance`s through one
synchronous rollout iteration:

1. whenever an instance has a free slot, ask the :class:`Scheduler`
   (Alg. 2) for the next request + placement; admit it with a KV blob
   fetched from the :class:`GlobalKVPool` (divided rollout's stateless
   migration — a pool hit skips re-prefill);
2. every engine tick, compute MBA draft budgets (γ_h, γ_l) from current
   high/low-priority batch sizes and online β estimates, pull drafts for
   each active request from the instance's DGDS client, and run the
   fused decode/verify step; with ``spec_mode="tree"`` each request's
   budget γ is further split across candidate paths by marginal benefit
   (``mba_tree_paths``: trunk depth vs the online per-branch rescue
   rates in ``ContextManager.branch_beta``), the paths are merged into
   one token tree and verified in a single fused tree step at the same
   draft-token budget;
3. stream new tokens to the DGDS master (``update_cst``), update
   acceptance statistics, and when a request's *chunk* budget is exhausted
   release its slot, export the KV blob to the pool and requeue it.

The loop is synchronous and deterministic (Python-level), which is what
lets the losslessness tests assert token-exact equality with plain
autoregressive decoding.
"""
from __future__ import annotations

import dataclasses
import time
import zlib
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

from repro_torch.configs.base import ModelConfig
from repro_torch.core.context import ContextManager
from repro_torch.core.dgds import DraftClient, DraftServer, SpeculationArgs
from repro_torch.core.faults import FaultInjector
from repro_torch.core.kvpool import GlobalKVPool
from repro_torch.core.mba import MBAConfig, mba_speculation, mba_tree_paths
from repro_torch.core.request import Group, ReqState, RolloutRequest
from repro_torch.core.scheduler import InstanceView, Scheduler
from repro_torch.core.sdmodel import (ForwardCostModel, SDThroughputModel,
                                      TPU_V5E)
from repro_torch.device import DeviceLike
from repro_torch.engine.engine import (BlobCorruptionError, EngineSeq,
                                       Instance, StepFunctions)
from repro_torch.launch.steps import engine_param_shards
from repro_torch.engine.token_tree import TokenTree, build_token_tree


def _stat(default, doc: str):
    """A documented counter field.  Every ``RolloutStats`` field carries
    a one-line ``doc`` in its metadata; the reflection test in
    ``tests/test_obs.py`` pins that every field is documented AND still
    read somewhere outside its definition (dead counters rot silently
    otherwise — this is the audit, mechanized)."""
    return field(default=default, metadata={"doc": doc})


@dataclass
class RolloutStats:
    steps: int = _stat(0, "fused engine steps committed")
    tokens: int = _stat(0, "tokens committed across all requests")
    drafted: int = _stat(0, "CST draft tokens submitted to verify steps")
    accepted: int = _stat(0, "draft tokens accepted by verification")
    chunks: int = _stat(0, "request chunks completed (releases + renewals)")
    migrations: int = _stat(0, "chunk re-admissions on a different instance")
    pool_hits: int = _stat(0, "KV-pool fetches that found a blob")
    pool_misses: int = _stat(0, "KV-pool fetches that re-prefilled instead")
    inplace_renewals: int = _stat(
        0, "final chunks renewed in place (no pool round-trip)")
    wall_seconds: float = _stat(0.0, "host wall-clock of the whole run")
    # -- streaming / bounded-staleness accounting --------------------------
    refreshes: int = _stat(0, "in-flight weight refreshes survived")
    injected_groups: int = _stat(0, "groups injected mid-stream")
    # prefix revalidation (truncate-mode refresh): old-params tokens
    # replayed as verify drafts under the new params.  Excluded from
    # drafted/accepted — they would pollute the β acceptance profile
    # MBA budgets are driven by.
    reval_tokens: int = _stat(0, "old-params tokens replayed as drafts")
    reval_accepted: int = _stat(0, "replayed tokens re-accepted in bulk")
    overlap_steps: int = _stat(
        0, "steps whose batch mixed inject epochs (tail packing)")
    reclaimed_rows: int = _stat(
        0, "newer-epoch rows run inside the would-be tail bubble")
    # -- fault tolerance ---------------------------------------------------
    ticks: int = _stat(0, "stream-loop ticks run (fault-schedule axis)")
    instance_crashes: int = _stat(0, "instances declared dead")
    stuck_ticks: int = _stat(0, "ticks a hung instance sat on live work")
    watchdog_escalations: int = _stat(0, "stuck instances escalated to crash")
    recovered_requests: int = _stat(0, "live requests reconstructed")
    recovered_via_blob: int = _stat(0, "resumed from the pooled chunk blob")
    recovered_via_replay: int = _stat(0, "rewound + replayed as drafts")
    recovery_redecode_tokens: int = _stat(
        0, "in-chunk tokens re-decoded (blob path)")
    recovery_replay_tokens: int = _stat(
        0, "tokens replayed as verify drafts")
    faulted_remaining_tokens: int = _stat(
        0, "victims' remaining decode budget at crash")
    fetch_failures: int = _stat(0, "injected pool-fetch failures retried")
    fetch_degraded: int = _stat(0, "fetches that gave up -> replay recovery")
    corrupt_blobs: int = _stat(0, "checksum-rejected fetched blobs")
    fetch_backoff_seconds: float = _stat(0.0, "modeled retry backoff")
    # -- open-loop serving (run_stream(arrivals=...)) ----------------------
    idle_ticks: int = _stat(0, "ticks with nothing running, arrivals due")
    # largest modeled admission delay seen at an offer (0 when no SLO
    # offers happened) — benches calibrate slo_deadline_s from a
    # deadline-free run's value
    offer_delay_max: float = _stat(0.0, "max modeled admission delay offered")

    @property
    def mean_acceptance(self) -> float:
        return self.accepted / max(self.drafted, 1)

    def snapshot(self) -> dict:
        """The unified stats surface: every counter by its field name,
        plus derived values.  Benches and gates consume this instead of
        ad-hoc attribute reads, so the JSON key set is pinned to the
        dataclass by construction."""
        out = dataclasses.asdict(self)
        out["mean_acceptance"] = self.mean_acceptance
        return out

    # alias: dict-shaped consumers (bench records) read as_dict()
    as_dict = snapshot


@dataclass
class RolloutResult:
    groups: List[Group]
    stats: RolloutStats
    ctx_stats: dict
    pool_stats: dict
    dgds_stats: dict

    def responses(self) -> Dict[str, List[int]]:
        return {r.req_id: list(r.generated)
                for g in self.groups for r in g.requests}

    def snapshot(self) -> dict:
        """One nested dict for every stats surface the rollout exposes:
        ``rollout`` (RolloutStats), ``context`` (ContextManager),
        ``pool`` (GlobalKVPool) and ``dgds`` (DraftServer)."""
        return {
            "rollout": self.stats.snapshot(),
            "context": dict(self.ctx_stats),
            "pool": dict(self.pool_stats),
            "dgds": dict(self.dgds_stats),
        }


class SeerRollout:
    """One model's rollout subsystem: instances + pool + DGDS + scheduler."""

    def __init__(self, cfg: ModelConfig, params, *,
                 n_instances: int = 2, max_slots: int = 4,
                 cache_len: int = 1024, chunk_size: int = 128,
                 prefill_chunk: int = 64,
                 prefill_mode: str = "batched",
                 prefill_budget: Optional[int] = None,
                 migration_mode: Optional[str] = None,
                 n_nodes: int = 1, topology_aware: bool = True,
                 placement_aware_export: bool = True,
                 final_chunk_inplace: bool = False,
                 admit_into_draining: Optional[bool] = None,
                 policy: str = "seer", spec_decode: bool = True,
                 spec_mode: str = "linear",
                 multipath_top_k: int = 1,
                 gamma_max: int = 8, lam: float = 2.0,
                 fetch_interval: int = 1, cst_depth: int = 12,
                 cst_lookup_max: int = 8,
                 pool_dram_gb: float = 4.0, base_seed: int = 0,
                 oracle_lengths: Optional[Dict[str, int]] = None,
                 admission_rank: str = "total_delay",
                 fault_injector: Optional[FaultInjector] = None,
                 watchdog_ticks: int = 3,
                 fetch_retries: int = 3,
                 fetch_backoff_s: float = 0.05,
                 tp: Optional[int] = None,
                 tracer=None,
                 steps: Optional[StepFunctions] = None,
                 device: DeviceLike = None):
        self.cfg = cfg
        self.chunk_size = chunk_size
        self.policy = policy
        self.spec_decode = spec_decode
        if spec_mode not in ("linear", "tree"):
            raise ValueError(f"spec_mode={spec_mode!r}")
        # "tree": multi-path CST drafts are merged into token trees and
        # verified in one fused step ("linear" stays the oracle).
        # Branching within a step needs attention-only layers — SSM and
        # hybrid scans are linear in the step's columns — so those
        # archs degrade to single-path trees (same drafts as linear).
        self.spec_mode = spec_mode
        self.tree_branching = spec_mode == "tree" and \
            cfg.arch_type not in ("ssm", "hybrid")
        self.multipath_top_k = multipath_top_k
        self.mba_cfg = MBAConfig(gamma_max=min(gamma_max, 8), lam=lam)
        self.oracle_lengths = oracle_lengths
        # placements ranked by modeled blob-transfer cost (prefer the
        # node already holding the KV blob) vs pure load balance
        self.topology_aware = topology_aware
        # placement-aware export: released blobs land on the node the
        # scheduler expects to resume the chunk on, not the releasing
        # node (pays the fabric leg at export, inside the overlap
        # window, instead of at fetch time on the admission path)
        self.placement_aware_export = placement_aware_export \
            and topology_aware
        # eviction-aware export: a request whose remaining budget fits
        # one chunk renews in place instead of round-tripping the pool.
        # Opt-in: renewal is SFS-biased (near-finished requests keep
        # slots longer work could take), so it trades scheduling
        # fidelity for pool churn — worth it when migration dominates
        self.final_chunk_inplace = final_chunk_inplace
        # callers may pass a shared StepFunctions so several rollouts of
        # the same config reuse compiled step/migration shapes
        self.steps = steps if steps is not None else StepFunctions(cfg)
        # every instance runs the same tp degree: equal-tp instances
        # share one engine group (cached per degree) and one set of step
        # functions in self.steps (keyed by the degree); the weights are
        # cut to this rank's shard once, for all of them
        self.tp = tp
        params = self._rank_params(params)
        fwd = ForwardCostModel(cfg, TPU_V5E, tp=tp or 1)
        n_nodes = max(1, min(n_nodes, n_instances))
        self.instances = [
            Instance(cfg, params, self.steps, max_slots=max_slots,
                     cache_len=cache_len, prefill_chunk=prefill_chunk,
                     prefill_mode=prefill_mode,
                     prefill_budget=prefill_budget,
                     migration_mode=migration_mode,
                     spec_mode=spec_mode,
                     cost_model=fwd,
                     gamma_max=gamma_max, instance_id=f"inst{i}",
                     node=f"n{i * n_nodes // n_instances}",
                     admit_into_draining=admit_into_draining,
                     base_seed=base_seed, tp=tp,
                     device=device)
            for i in range(n_instances)
        ]
        self.pool = GlobalKVPool(dram_capacity=int(pool_dram_gb * (1 << 30)))
        self.server = DraftServer(max_depth=cst_depth)
        self.clients = {
            inst.instance_id: DraftClient(self.server,
                                          fetch_interval=fetch_interval)
            for inst in self.instances
        }
        # longest CST suffix match used for drafting.  Short lookups
        # trade per-request precision for cross-request sharing: more
        # contexts collide across the group, so the CST sees several
        # continuations per match — the branch diversity tree mode
        # feeds on (and the ambiguity linear mode suffers under)
        self.cst_lookup_max = cst_lookup_max
        self.cache_len = cache_len
        self.ctx = ContextManager(max_gen_length=cache_len)
        self.sd_model = SDThroughputModel(fwd)
        # admission ranking: "total_delay" folds the blob fetch cost and
        # the target's queued-prefill delay into one modeled unit;
        # "lexicographic" keeps the legacy cost-then-headroom key for
        # the topology bench comparison
        self.admission_rank = admission_rank
        # modeled marginal seconds one queued prefill token adds to a
        # mixed step — converts queue depth into the same unit as the
        # pool's fetch cost for total-delay ranking
        base = fwd.step_time(1, 1, 0.0)
        mixed = fwd.mixed_step_time(1, 1, chunk_size, 0.0)
        self._queue_cost_per_token = max(0.0, mixed - base) \
            / max(chunk_size, 1)
        # req_id -> (instance, slot, chunk_tokens_left)
        self._placements: Dict[str, tuple] = {}
        self._reqs: Dict[str, RolloutRequest] = {}
        # -- streaming / bounded-staleness state --------------------------
        # current weight version the instances decode under; bumped by
        # refresh_params so the staleness ledger can stamp every
        # committed token with the version it was sampled at
        self.param_version = 0
        # live-stream handles (None outside run_stream): mid-run
        # injection and refresh talk to the active scheduler/stats
        self._stream_sched: Optional[Scheduler] = None
        self._stream_stats: Optional[RolloutStats] = None
        self._stream_groups: Optional[Dict[str, Group]] = None
        # next-epoch tagging: requests injected mid-stream carry the
        # inject generation, so ticks whose batch mixes epochs can be
        # counted (the reclaimed-bubble currency of tail packing)
        self._epoch = 0
        self._req_epoch: Dict[str, int] = {}
        self._injected_since_bubble = False
        # truncate-mode refresh: released (buffered) requests rewound to
        # their prompt stash the old-params generation here; _admit
        # feeds it back as the slot's prefix-revalidation queue
        self._pending_rewind: Dict[str, List[int]] = {}
        # crash replay under unchanged params: the tokens and the
        # logprobs the request had recorded before the crash; the commit
        # puts these logprobs back in place of the verify step's
        # recomputed ones while the replayed tokens come back unchanged,
        # so a crash leaves the trainer's inputs as they were
        self._replay_logprobs: Dict[str, Tuple[List[int], List[float]]] = {}
        # -- fault tolerance --------------------------------------------
        # deterministic fault schedule consumed at tick boundaries (one
        # injector per stream: its armed state is stateful).  Settable
        # between streams (benches warm up fault-free, then arm).
        self.faults = fault_injector
        # ticks a stuck instance may sit on live work before the
        # watchdog declares it dead and recovers its requests (0
        # disables escalation — a stuck instance just waits out)
        self.watchdog_ticks = watchdog_ticks
        # pool-fetch retry budget + modeled exponential backoff base.
        # Backoff is accounted (fetch_backoff_seconds), never slept:
        # pool transfers are modeled seconds too, and real sleeps would
        # perturb the deterministic tick structure the schedules key on.
        self.fetch_retries = fetch_retries
        self.fetch_backoff_s = fetch_backoff_s
        self._stuck_until: Dict[str, int] = {}   # instance_id -> tick
        self._watchdog: Dict[str, int] = {}      # consecutive stuck ticks
        self._cur_tick = 0
        self._stream_drained = False
        # -- observability ----------------------------------------------
        # optional repro_torch.obs.trace.Tracer: all hooks are host-side
        # metadata recorded at tick boundaries — tracing adds ZERO
        # device reads, and a traced run is bit-identical (tokens,
        # steps, host syncs) to an untraced one.  Settable between
        # runs, like ``faults``.
        self.tracer = tracer
        self._fwd = fwd              # modeled-clock source for the tracer
        self._stream_rec = None      # live TimelineRecorder (in-stream)

    # -- scheduling glue ---------------------------------------------------------

    def _is_stuck(self, inst: Instance) -> bool:
        return self._stuck_until.get(inst.instance_id, 0) > self._cur_tick

    def _views(self) -> List[InstanceView]:
        # dead and currently-stuck instances take no placements: the
        # scheduler only ever sees capacity that can actually step
        return [
            InstanceView(
                instance_id=inst.instance_id,
                free_slots=inst.free_slots(),
                kv_free_tokens=inst.kv_capacity_tokens()
                - inst.kv_used_tokens(),
                active_requests=len(inst.active_slots()),
                queued_prefill_tokens=inst.queued_prefill_tokens(),
                node=inst.node)
            for inst in self.instances
            if inst.alive and not self._is_stuck(inst)
        ]

    def _fetch_cost(self, r: RolloutRequest, node: str) -> float:
        """Modeled seconds to bring ``r``'s KV blob to ``node`` — the
        scheduler's topology-ranking oracle (0 for fresh requests)."""
        return self.pool.peek_fetch_cost(r.req_id, node)

    def reset_acceptance_profile(self) -> None:
        """Start a fresh acceptance profile (β, per-branch β) for a new
        RL iteration while the DGDS CSTs persist — the paper's online
        context reuse across steps keeps drafting context, but the
        policy model has moved, so stale acceptance statistics would
        mis-drive MBA (a collapsed β from an earlier iteration can pin
        γ at 0 and never recover: with no drafts there are no trials to
        raise it).

        Resets IN PLACE: replacing ``self.ctx`` wholesale (the old
        behaviour) silently detached any live :class:`Scheduler` — mid-
        stream refreshes would keep feeding L̂_g updates and acceptance
        stats into an orphaned manager while admission ordering read the
        new, empty one."""
        self.ctx.reset_acceptance()

    def measured_export_overlap(self) -> float:
        """Fraction of exported slots whose gather was dispatched while
        a step was in flight — feeds ``SimConfig.migration_overlap`` so
        divided-mode simulator timings track the engine."""
        exported = sum(i.slots_exported for i in self.instances)
        overlapped = sum(i.export_overlapped_slots for i in self.instances)
        return overlapped / max(exported, 1)

    def _inst(self, instance_id: str) -> Instance:
        return next(i for i in self.instances
                    if i.instance_id == instance_id)

    def _admit(self, sched: Scheduler, r: RolloutRequest,
               instance_id: str, stats: RolloutStats) -> None:
        inst = self._inst(instance_id)
        seq = EngineSeq(
            req_id=r.req_id, group_id=r.group_id, prompt=list(r.prompt),
            seed=r.seed, temperature=r.temperature,
            max_new_tokens=r.max_new_tokens, stop_token=r.stop_token)
        seq.generated = list(r.generated)
        seq.logprobs = list(r.logprobs)
        seq.last_token = r.last_token
        seq.next_pos = r.next_pos
        blob = None
        if r.next_pos > 0:
            blob = self._pool_fetch(r, inst, stats)
        slot = inst.admit(seq, blob)
        if r.instance_id is not None and r.instance_id != instance_id:
            r.migrations += 1
            stats.migrations += 1
        r.instance_id = instance_id
        r.state = ReqState.RUNNING
        if r.t_first_scheduled is None:
            r.t_first_scheduled = time.monotonic()
        chunk = sched.chunk_tokens(r)
        self._placements[r.req_id] = (inst, slot, seq, chunk)
        if self._stream_rec is not None:
            self._stream_rec.on_admit(r.req_id, instance_id,
                                      self._cur_tick)
        rewound = self._pending_rewind.pop(r.req_id, None)
        if rewound:
            # truncate-mode refresh rewound this buffered request to its
            # prompt; replay the old-params generation as verify drafts
            # so the still-valid prefix is re-accepted in bulk
            seq.reval_queue = list(rewound)
        self.clients[instance_id].register_group(r.group_id)

    def _pool_fetch(self, r: RolloutRequest, inst: Instance,
                    stats: RolloutStats) -> Optional["object"]:
        """Fetch ``r``'s KV blob with retry-with-backoff and checksum
        validation.  Injected fetch failures and corrupt blobs are
        retried up to ``fetch_retries`` times (backoff is modeled, not
        slept — it lands in ``fetch_backoff_seconds`` next to the
        pool's own modeled transfer time); when the budget is exhausted
        the fetch *degrades*: the entry is dropped and the admit takes
        the pool-miss path, re-prefilling ``[0, next_pos)`` from the
        tokens the host already holds — slower, but token-lossless."""
        for attempt in range(max(1, self.fetch_retries)):
            outcome = "ok" if self.faults is None \
                else self.faults.fetch_outcome(r.req_id)
            if outcome == "fail":
                stats.fetch_failures += 1
                stats.fetch_backoff_seconds += \
                    self.fetch_backoff_s * (2 ** attempt)
                continue
            blob = self.pool.get(r.req_id, node=inst.node)
            if blob is None:
                stats.pool_misses += 1
                return None
            if outcome == "corrupt":
                # fault injection tampers the FETCHED copy's stamp (the
                # pool keeps the intact entry, so a retry can succeed)
                blob = dataclasses.replace(
                    blob, checksum=(blob.checksum or 0) ^ 0x5A5A5A5A)
            try:
                blob.verify_checksum()
            except BlobCorruptionError:
                stats.corrupt_blobs += 1
                stats.fetch_backoff_seconds += \
                    self.fetch_backoff_s * (2 ** attempt)
                continue
            stats.pool_hits += 1
            return blob
        stats.fetch_degraded += 1
        stats.pool_misses += 1
        self.pool.drop(r.req_id)
        return None

    def _sync_back(self, r: RolloutRequest, seq: EngineSeq) -> None:
        r.generated = list(seq.generated)
        r.logprobs = list(seq.logprobs)
        r.last_token = seq.last_token
        r.next_pos = seq.next_pos

    def _release(self, r: RolloutRequest, stats: RolloutStats,
                 export: bool) -> None:
        """Immediate (per-slot) release — finished requests, and the
        whole path when the instance runs ``migration_mode="perslot"``."""
        inst, slot, seq, _ = self._placements.pop(r.req_id)
        self._sync_back(r, seq)
        blob = inst.release(slot, export=export)
        if export and blob is not None:
            self.pool.put(blob, node=inst.node)
        stats.chunks += 1
        r.chunks_run += 1
        if export and self._stream_rec is not None:
            self._stream_rec.on_release(r.req_id, self._cur_tick)

    def _begin_release(self, r: RolloutRequest, stats: RolloutStats
                       ) -> None:
        """Chunk exhausted: release the seq from stepping now, defer the
        KV export to the next tick's :meth:`_flush_releases` — the
        batched gather is dispatched right after the next step so blob
        materialization overlaps device compute.  The request is
        requeued only once its blob is in the pool."""
        inst, slot, seq, _ = self._placements.pop(r.req_id)
        self._sync_back(r, seq)
        inst.release_async(slot)
        stats.chunks += 1
        r.chunks_run += 1
        if self._stream_rec is not None:
            self._stream_rec.on_release(r.req_id, self._cur_tick)

    def _flush_releases(self, inst: Instance, sched: Scheduler) -> int:
        """Export the instance's draining slots (one batched gather),
        put the blobs in the pool and hand the requests back to the
        scheduler.  Returns the number of slots freed.

        With placement-aware export each blob is homed on the node the
        scheduler expects to resume the chunk on
        (:meth:`~repro_torch.core.scheduler.Scheduler.predict_resume_node`):
        the fabric leg is paid at export time — inside the batched
        overlap window — instead of stalling the admission that fetches
        it (``export_placed_remote`` in pool stats counts the moves)."""
        blobs = inst.flush_exports()
        if not blobs:
            return 0
        placements = None
        if self.placement_aware_export:
            views = self._views()
            placements = {}
            for req_id in blobs:
                node = sched.predict_resume_node(
                    views, self._reqs[req_id], inst.node)
                placements[req_id] = node or inst.node
        self.pool.put_batch(list(blobs.values()), node=inst.node,
                            placements=placements)
        for req_id in blobs:
            sched.requeue(self._reqs[req_id])
        return len(blobs)

    # -- fault recovery ----------------------------------------------------

    def fail_instance(self, instance_id: str, *,
                      lose_pool: bool = False) -> None:
        """Kill an instance NOW and recover its requests (test/ops
        hook).  Legal at any :meth:`run_stream` yield point — the same
        no-ticket-in-flight contract as :meth:`inject` and
        :meth:`refresh_params`.  ``lose_pool=True`` also drops the
        victims' pool entries, forcing replay-based recovery."""
        if self._stream_sched is None:
            raise RuntimeError(
                "fail_instance() outside an active run_stream()")
        for i in self.instances:
            if i.step_in_flight:
                raise RuntimeError(
                    "fail_instance() with a step ticket in flight")
        inst = self._inst(instance_id)
        if not inst.alive:
            return
        self._crash_instance(inst, self._stream_sched, self._stream_stats,
                             lose_pool=lose_pool)

    def _crash_instance(self, inst: Instance, sched: Scheduler,
                        stats: RolloutStats, *,
                        lose_pool: bool = False) -> None:
        """Declare ``inst`` dead and reconstruct every live request it
        held, token-losslessly:

        * **blob path** — the pool still holds the request's blob at its
          last chunk boundary (``peek_next_pos == r.next_pos``; pool
          entries survive fetches, so this is the common case).  The
          request stays at the boundary the host already synced; the
          in-chunk tokens lost with the cache re-decode bit-identically
          (position-keyed sampling) on the next instance, and their
          ledger entries are trimmed so the re-decode re-records them.
        * **replay path** — no usable blob (never exported, export
          buffer lost with the crash, stale boundary, or
          ``lose_pool``).  Rewind to the prompt and stash the full
          generation (plus any pending revalidation tail) in
          ``_pending_rewind``: the next admission replays it as verify
          drafts, the ``reval_queue`` path.  ``version_runs`` is
          preserved whole — replayed tokens keep the param versions
          they were originally sampled under, so the trainer's
          staleness ledger stays sound for partially-recovered groups.

        Re-decoded tokens re-feed ``update_cst``; duplicate CST updates
        only perturb draft scores, never sampled tokens, so the
        losslessness guarantee holds.  Recovered requests re-enter
        through ``Scheduler.select_instance`` like any released chunk."""
        victims: List[Tuple[RolloutRequest, Optional[EngineSeq]]] = []
        for rid in [rid for rid, pl in self._placements.items()
                    if pl[0] is inst]:
            _, _, seq, _ = self._placements.pop(rid)
            victims.append((self._reqs[rid], seq))
        seen = {r.req_id for r, _ in victims}
        for seq in inst._draining.values():
            # draining seqs left placements at release; the host synced
            # their state then, but their export was still pending
            if seq.req_id not in seen:
                victims.append((self._reqs[seq.req_id], seq))
                seen.add(seq.req_id)
        for rid in inst._export_buffer:
            # gathered-early blobs (takeover snapshots) die with the
            # instance before reaching the pool; their requests were
            # synced at release but never requeued
            if rid not in seen and rid in self._reqs:
                victims.append((self._reqs[rid], None))
                seen.add(rid)
        inst.crash()
        stats.instance_crashes += 1
        self._watchdog.pop(inst.instance_id, None)
        self._stuck_until.pop(inst.instance_id, None)
        if not any(i.alive for i in self.instances):
            raise RuntimeError(
                "all instances dead: no capacity left to recover onto")
        for r, seq in victims:
            if r.finished:
                continue
            gen_now = len(seq.generated) if seq is not None \
                else len(r.generated)
            stats.faulted_remaining_tokens += \
                max(0, r.max_new_tokens - gen_now)
            blob_pos = self.pool.peek_next_pos(r.req_id)
            if lose_pool:
                self.pool.drop(r.req_id)
                blob_pos = None
            pending_reval = bool(seq is not None and seq.reval_queue)
            if blob_pos is not None and blob_pos == r.next_pos \
                    and r.next_pos > 0 and not pending_reval:
                stats.recovered_via_blob += 1
                stats.recovery_redecode_tokens += \
                    max(0, gen_now - len(r.generated))
                r.trim_version_runs(len(r.generated))
                if self._stream_rec is not None:
                    self._stream_rec.on_crash(r.req_id, self._cur_tick,
                                              "blob")
            else:
                stats.recovered_via_replay += 1
                tail = list(seq.reval_queue) if pending_reval else []
                if seq is not None:
                    self._sync_back(r, seq)
                self.pool.drop(r.req_id)
                replay = list(r.generated) + tail
                if replay:
                    self._pending_rewind[r.req_id] = replay
                self._keep_logprobs(r, replay)
                stats.recovery_replay_tokens += len(replay)
                r.generated = []
                r.logprobs = []
                r.last_token = r.prompt[-1]
                r.next_pos = len(r.prompt) - 1
                if self._stream_rec is not None:
                    self._stream_rec.on_crash(r.req_id, self._cur_tick,
                                              "replay")
            stats.recovered_requests += 1
            sched.requeue(r)

    def _keep_logprobs(self, r: RolloutRequest, replay: List[int]) -> None:
        """Record the logprobs of a crash replay's tokens: those ``r``
        holds, then those of an earlier crash replay that this one cut
        short (its unreplayed tail comes back in ``replay``).  Only where
        every token of ``r`` was sampled under the live params: a token
        kept across a refresh (mode "keep") carries the old params'
        logprob, and its replay recomputes it under the new ones."""
        old = self._replay_logprobs.pop(r.req_id, None)
        versions = {v for v, _ in r.version_runs}.union(r.token_versions())
        if versions - {self.param_version}:
            return
        lps = list(r.logprobs)
        if old is not None:
            toks, olps = old
            n = len(lps)
            while n < min(len(replay), len(olps)) and toks[n] == replay[n]:
                lps.append(olps[n])
                n += 1
        if lps:
            self._replay_logprobs[r.req_id] = (replay[:len(lps)], lps)

    def _restore_logprobs(self, seq: EngineSeq, n_new: int) -> None:
        """After a commit of ``n_new`` tokens: where they replay a
        crashed request's tokens unchanged, put back the logprobs it had
        recorded; the first token that differs ends the record."""
        rec = self._replay_logprobs.get(seq.req_id)
        if rec is None:
            return
        toks, lps = rec
        end = len(seq.generated)
        for k in range(end - n_new, min(end, len(toks))):
            if seq.generated[k] != toks[k]:
                del self._replay_logprobs[seq.req_id]
                return
            seq.logprobs[k] = lps[k]
        if end >= len(toks):
            del self._replay_logprobs[seq.req_id]

    # -- drafts --------------------------------------------------------------------

    def _collect_drafts(self, inst: Instance) -> Dict[int, List[int]]:
        # still-prefilling slots have no pending token to verify against —
        # only decode-ready slots draw drafts
        active = inst.decode_slots()
        drafts: Dict[int, List[int]] = {}
        # prefix revalidation first (independent of spec_decode): a slot
        # re-anchored by a truncate-mode weight refresh replays its
        # old-params generation as the draft chain, so the still-valid
        # prefix is re-accepted a verify step at a time instead of one
        # decode step per token
        reval = set()
        for i in active:
            seq = inst.slots[i]
            if seq.reval_queue:
                drafts[i] = list(seq.reval_queue[:inst.gamma_max])
                reval.add(i)
        if not self.spec_decode:
            return drafts
        active = [i for i in active if i not in reval]
        if not active:
            return drafts
        b_h = sum(1 for i in active
                  if self._reqs[inst.slots[i].req_id].speculative)
        b_l = len(active) - b_h
        # context of the verifying batch only: kv_used_tokens() also
        # counts still-prefilling slots' full footprints, which would
        # inflate mean_ctx and suppress MBA draft budgets mid-admission
        mean_ctx = sum(min(inst.slots[i].next_pos, inst.cache_len)
                       for i in active) / max(len(active), 1)
        # beta_padded(γ_max) yields positions 1..γ_max plus the terminal
        # 0 the MBA marginal-benefit loop reads at γ_max+1
        beta = self.ctx.beta_padded(self.mba_cfg.gamma_max)
        gamma_h, gamma_l = mba_speculation(
            b_h, b_l, beta, self.sd_model, self.ctx.alpha, mean_ctx,
            self.mba_cfg)
        if gamma_h == 0 and gamma_l == 0:
            return drafts
        use_tree = self.spec_mode == "tree"
        gids, pats, args, order = [], [], [], []
        for i in active:
            seq = inst.slots[i]
            r = self._reqs[seq.req_id]
            g = gamma_h if r.speculative else gamma_l
            if g <= 0:
                continue
            gids.append(r.group_id)
            # context = everything up to and including the pending token
            pats.append((seq.prompt + seq.generated)[-16:])
            if use_tree:
                # split the SAME per-request token budget γ across tree
                # paths by marginal benefit (trunk depth vs a branch's
                # online rescue rate); non-branching archs get the whole
                # budget as one chain
                budgets = mba_tree_paths(
                    g, beta, self.ctx.branch_beta,
                    self.multipath_top_k if self.tree_branching else 1,
                    self.mba_cfg.gamma_max)
                args.append(SpeculationArgs(
                    max_spec_tokens=max(budgets, default=0),
                    top_k=max(len(budgets), 1), path_budgets=budgets,
                    pattern_lookup_max=self.cst_lookup_max))
            else:
                args.append(SpeculationArgs(
                    max_spec_tokens=g, top_k=self.multipath_top_k,
                    pattern_lookup_max=self.cst_lookup_max))
            order.append(i)
        if not gids:
            return drafts
        paths = self.clients[inst.instance_id].batch_speculate(
            gids, pats, args)
        for i, ps in zip(order, paths):
            if use_tree:
                tree = build_token_tree(
                    [p.tokens for p in ps if p.tokens],
                    max_nodes=self.mba_cfg.gamma_max)
                if len(tree):
                    drafts[i] = tree
            else:
                best = max(ps, key=lambda p: p.score)
                if best.tokens:
                    drafts[i] = best.tokens
        return drafts

    # -- mid-stream control (injection / weight refresh) -------------------------

    def inject(self, groups: Sequence[Group]) -> None:
        """Add next-epoch groups to the live stream (RollPacker-style
        tail packing): the requests enter the scheduler's buffer and ride
        the existing ``plan_admissions`` / mixed-prefill path into
        whatever slots the current epoch's tail leaves idle.  Only legal
        at a :meth:`run_stream` yield point (no step ticket in flight)."""
        if self._stream_sched is None:
            raise RuntimeError("inject() outside an active run_stream()")
        if self._stream_drained:
            # the final ("result", ...) event is out: the loop will
            # never tick again, so groups added now would silently
            # vanish (the scheduler buffers them, nobody drains them)
            raise RuntimeError(
                "inject() into a drained stream: the final result was "
                "already yielded; start a new run_stream() instead")
        now = time.monotonic()
        self._epoch += 1
        for g in groups:
            self._stream_groups[g.group_id] = g
            for r in g.requests:
                r.t_submitted = now
                self._reqs[r.req_id] = r
                self._req_epoch[r.req_id] = self._epoch
        self._stream_sched.add_groups(list(groups))
        self._stream_stats.injected_groups += len(groups)
        self._injected_since_bubble = True
        if self.tracer is not None:
            self.tracer.instant("inject", "train", "trainer",
                                tick=self._cur_tick,
                                groups=len(groups), epoch=self._epoch)
            if self._stream_rec is not None:
                for g in groups:
                    for r in g.requests:
                        self._stream_rec.on_submit(
                            r.req_id, g.group_id, self._cur_tick)

    def _rank_params(self, params):
        """The weights as this rank holds them: its shard of the tp
        group's layout (cut once and shared by every instance), or the
        tree itself without tp."""
        if self.tp is None:
            return params
        from repro_torch.launch.mesh import engine_group
        return engine_param_shards(self.cfg, params, engine_group(self.tp))

    def refresh_params(self, params, *, version: Optional[int] = None,
                       mode: str = "keep") -> None:
        """Swap model weights while requests are in flight.

        Only legal at a :meth:`run_stream` yield point (no step ticket
        in flight).  Every KV byte in the system was computed under the
        old params, so all of it is invalidated: pending blob imports
        are cancelled, draining exports are flushed straight back to the
        scheduler (never pooled), every pooled blob is dropped, and each
        live slot is *revalidated*:

        * ``mode="keep"`` — the committed tokens are kept; the slot
          re-anchors by re-prefilling its full prefix under the new
          params (the engine's pool-miss path).  Decoding resumes from
          the same position; the staleness ledger records which tokens
          predate the refresh.
        * ``mode="truncate"`` — the slot rewinds to its prompt and the
          old generation is replayed as verify drafts
          (``EngineSeq.reval_queue``): the prefix the new params agree
          with is re-accepted in bulk, the first divergence truncates
          the rest.  Position-keyed sampling makes the result bit-exact
          with a fresh run under the new params.

        The acceptance profile resets in place (β statistics gathered
        under the old policy must not drive the new version's MBA
        budgets); DGDS CSTs persist — online context reuse across
        versions is the paper's core bet, and drafts never change
        sampled tokens.
        """
        if mode not in ("keep", "truncate"):
            raise ValueError(f"refresh mode={mode!r}")
        for inst in self.instances:
            if inst.step_in_flight:
                raise RuntimeError(
                    "refresh_params() with a step ticket in flight")
        params = self._rank_params(params)
        # a replay under the new params recomputes its logprobs
        self._replay_logprobs.clear()
        self.param_version = self.param_version + 1 \
            if version is None else int(version)
        sched = self._stream_sched
        for inst in self.instances:
            if not inst.alive:
                # a crashed instance holds nothing: its requests were
                # already recovered (and will re-prefill/replay under
                # whatever params are live at their next admission)
                continue
            # old-params KV must never land in the new-params cache
            inst.cancel_pending_imports()
            # draining slots: materialise the export (frees the slot)
            # but requeue the request with its blob dropped — it will
            # re-prefill under the new params at its next admission
            blobs = inst.flush_exports()
            for req_id in blobs:
                if sched is not None:
                    sched.requeue(self._reqs[req_id])
            inst.params = params
            for slot in inst.active_slots():
                self._revalidate_slot(inst, slot, mode)
        for req_id in list(self._reqs):
            self.pool.drop(req_id)
        if mode == "truncate":
            # buffered (released, not-yet-readmitted) requests rewind to
            # their prompt too; the old generation is stashed and
            # replayed as verify drafts when the request is re-admitted
            for r in self._reqs.values():
                if not r.finished and r.req_id not in self._placements \
                        and r.generated:
                    self._pending_rewind[r.req_id] = list(r.generated)
                    r.generated = []
                    r.logprobs = []
                    r.last_token = r.prompt[-1]
                    r.next_pos = len(r.prompt) - 1
                    r.version_runs = []
        self.reset_acceptance_profile()
        if self._stream_stats is not None:
            self._stream_stats.refreshes += 1
        if self.tracer is not None:
            self.tracer.instant("refresh_params", "train", "trainer",
                                tick=self._cur_tick,
                                version=self.param_version, mode=mode)
            if self._stream_rec is not None:
                self._stream_rec.on_refresh(
                    [rid for rid, r in self._reqs.items()
                     if not r.finished], self._cur_tick)

    def _revalidate_slot(self, inst: Instance, slot: int,
                         mode: str) -> None:
        """Re-anchor one live slot after a weight refresh (see
        :meth:`refresh_params`)."""
        seq = inst.slots[slot]
        r = self._reqs.get(seq.req_id)
        if mode == "truncate" and seq.generated:
            seq.reval_queue = list(seq.generated)
            seq.generated = []
            seq.logprobs = []
            seq.last_token = seq.prompt[-1]
            seq.next_pos = len(seq.prompt) - 1
            seq.prefill_queue = list(seq.prompt[:-1])
            seq.prefill_pos = 0
            if r is not None:
                r.generated = []
                r.logprobs = []
                r.last_token = seq.last_token
                r.next_pos = seq.next_pos
                r.version_runs = []
                if r.req_id in self._placements:
                    sched = self._stream_sched
                    chunk = sched.chunk_tokens(r) if sched is not None \
                        else min(self.chunk_size, r.remaining_tokens)
                    self._placements[r.req_id] = (inst, slot, seq, chunk)
        else:
            # keep: same committed prefix, new params — requeue a full
            # re-prefill of [0, next_pos) exactly like the engine's
            # pool-miss path (covers mid-prefill slots too: the queue is
            # rebuilt from position 0)
            seq.prefill_queue = list(
                (seq.prompt + seq.generated)[:seq.next_pos])
            seq.prefill_pos = 0
        inst._clear_slot_cache(slot)

    # -- the main loop ---------------------------------------------------------------

    def run(self, groups: Sequence[Group],
            progress_every: int = 0) -> RolloutResult:
        """Drain :meth:`run_stream` to completion — the synchronous
        barrier view (bit-exact with the pre-streaming loop; the
        bound-0 equivalence tests gate it)."""
        result = None
        for kind, payload in self.run_stream(groups,
                                             progress_every=progress_every):
            if kind == "result":
                result = payload
        return result

    def run_stream(self, groups: Sequence[Group], progress_every: int = 0,
                   *, arrivals=None,
                   slo_deadline_s: Optional[float] = None):
        """Generator-shaped rollout: yields ``(kind, payload)`` events.

        * ``("group", Group)`` — a GRPO group just finished (all its
          requests done); streamed to the trainer as it completes
          instead of waiting for the barrier.
        * ``("bubble", info)`` — the tick ended with idle capacity the
          scheduler cannot fill (``info`` carries ``free_slots``,
          ``pending``, ``stalled``): the tail-packing window.  The
          consumer may :meth:`inject` next-epoch groups here.  With
          ``stalled=True`` nothing is running *or* placeable — if the
          consumer does not inject, the capacity-deadlock guard raises
          exactly as the barrier loop did.
        * ``("result", RolloutResult)`` — final event; aggregate stats
          over everything the stream ran (injected groups included).

        Every yield happens with no step ticket in flight, so
        :meth:`inject` and :meth:`refresh_params` are legal at ANY yield
        point, not just bubbles.

        ``arrivals`` (an :class:`~repro_torch.core.workload.ArrivalFeed`)
        switches the loop open-loop: the feed is polled at every tick
        boundary — the same no-ticket-in-flight contract as
        :meth:`inject` — and released groups go through the scheduler's
        SLO admission (queue vs shed on the modeled total-delay vs
        ``slo_deadline_s``).  The loop then outlives the current work:
        ticks with nothing running advance the arrival clock
        (``idle_ticks``) until the trace is exhausted AND everything
        admitted finished.  With ``arrivals=None`` every branch below is
        a no-op and the run is bit-identical to the closed-loop path.
        """
        t0 = time.monotonic()
        stats = RolloutStats()
        sched = Scheduler(list(groups), self.ctx, policy=self.policy,
                          chunk_size=self.chunk_size,
                          oracle_lengths=self.oracle_lengths,
                          fetch_cost=(self._fetch_cost
                                      if self.topology_aware else None),
                          rank_mode=self.admission_rank,
                          queue_cost_per_token=self._queue_cost_per_token,
                          slo_deadline_s=slo_deadline_s)
        all_groups = {g.group_id: g for g in groups}
        self._stream_sched = sched
        self._stream_stats = stats
        self._stream_groups = all_groups
        self._stream_drained = False
        self._stuck_until = {}
        self._watchdog = {}
        self._cur_tick = 0
        self._reqs = {r.req_id: r for g in groups for r in g.requests}
        self._req_epoch = {rid: self._epoch for rid in self._reqs}
        yielded: set = set()
        for r in self._reqs.values():
            r.t_submitted = t0

        # observability: propagate the tracer (or clear a previous
        # run's) through every collaborator and open the per-request
        # timeline recorder.  All hooks downstream are guarded on the
        # attribute being non-None, so the untraced path is untouched.
        tr = self.tracer
        for inst in self.instances:
            inst.tracer = tr
        self.pool.tracer = tr
        sched.tracer = tr
        if self.faults is not None:
            self.faults.tracer = tr
        if arrivals is not None:
            arrivals.tracer = tr
        rec = None
        if tr is not None:
            from repro_torch.obs.timeline import TimelineRecorder
            rec = TimelineRecorder(tr)
            for g in groups:
                for r in g.requests:
                    rec.on_submit(r.req_id, g.group_id, 0)
        self._stream_rec = rec

        try:
            yield from self._stream_loop(sched, stats, all_groups,
                                         yielded, t0, progress_every,
                                         feed=arrivals)
        finally:
            self._stream_sched = None
            self._stream_stats = None
            self._stream_groups = None
            self._stream_rec = None

    def _stream_loop(self, sched: Scheduler, stats: RolloutStats,
                     all_groups: Dict[str, Group], yielded: set,
                     t0: float, progress_every: int, feed=None):
        tr = self.tracer
        rec = self._stream_rec
        while not sched.all_finished or \
                (feed is not None and not feed.exhausted()):
            # 0) tick boundary: apply this tick's scheduled faults.  No
            # ticket is in flight, so a crash here is indistinguishable
            # from one at a yield point — the deterministic injection
            # point that makes fault schedules replayable.  Trace
            # recording shares exactly this contract: every event below
            # is host-side metadata stamped between tickets.
            tick = stats.ticks
            stats.ticks += 1
            self._cur_tick = tick
            if tr is not None:
                tr.begin_tick(tick)
            if feed is not None:
                # 0b) open-loop arrivals: released groups enter through
                # the scheduler's SLO admission at the tick boundary —
                # the same no-ticket-in-flight contract as inject(), so
                # an open-loop run replays exactly from (seed, config).
                # Feed-admitted groups stay in the CURRENT inject epoch:
                # they are this iteration's traffic, not next-epoch tail
                # packing, so overlap accounting is untouched.
                now = time.monotonic()
                for arr, g in feed.poll(tick):
                    if sched.offer_group(g, self._views()):
                        all_groups[g.group_id] = g
                        for r in g.requests:
                            r.t_submitted = now
                            self._reqs[r.req_id] = r
                            self._req_epoch[r.req_id] = self._epoch
                            if rec is not None:
                                rec.on_submit(r.req_id, g.group_id,
                                              tick, tenant=arr.tenant)
                        feed.note_admitted(arr, g, tick)
                    else:
                        if rec is not None:
                            for r in g.requests:
                                rec.on_shed(r.req_id, g.group_id, tick,
                                            tenant=arr.tenant)
                        feed.note_shed(arr, g, tick)
                feed.note_tick(tick, sched.ready_count())
            if self.faults is not None:
                for ev in self.faults.begin_tick(tick):
                    if ev.kind == "crash":
                        inst = self._inst(ev.instance_id)
                        if inst.alive:
                            self._crash_instance(inst, sched, stats,
                                                 lose_pool=ev.lose_pool)
                    elif ev.kind == "stuck":
                        self._stuck_until[ev.instance_id] = max(
                            self._stuck_until.get(ev.instance_id, 0),
                            tick + ev.ticks)

            # 1) step every instance — dispatch all device work first
            # (JAX async dispatch); everything below until the commits
            # runs in the overlap window behind it.  Drafts for this
            # tick see the CST as of the previous tick, which cannot
            # change sampled outputs (the losslessness guarantee:
            # drafts affect only acceptance).
            any_active = False
            any_blocked = False
            tickets = []
            tick_dt = 0.0     # modeled seconds this tick covers
            for inst in self.instances:
                if not inst.alive:
                    continue
                if self._is_stuck(inst):
                    # hung worker: no dispatch this tick (and no
                    # placements — _views hides it).  Its capacity comes
                    # back when it unsticks, so it always counts as
                    # blocked for the deadlock guard.  The watchdog
                    # counts consecutive ticks it sits on live work and
                    # escalates to a crash (recovering its requests on
                    # healthy instances) at watchdog_ticks; a shorter
                    # hang just waits out — trivially lossless.
                    any_blocked = True
                    if inst.active_slots() or inst.draining_slots() \
                            or inst.pending_takeovers():
                        stats.stuck_ticks += 1
                        wd = self._watchdog.get(inst.instance_id, 0) + 1
                        self._watchdog[inst.instance_id] = wd
                        if self.watchdog_ticks \
                                and wd >= self.watchdog_ticks:
                            stats.watchdog_escalations += 1
                            if tr is not None:
                                tr.instant("watchdog_escalation",
                                           "fault", inst.instance_id,
                                           stuck_ticks=wd)
                            self._crash_instance(inst, sched, stats)
                    continue
                self._watchdog.pop(inst.instance_id, None)
                ticket, drafts, cost_in = None, {}, None
                if inst.active_slots() or inst.pending_takeovers():
                    drafts = self._collect_drafts(inst)
                    if tr is not None:
                        # modeled-clock inputs, captured BEFORE dispatch
                        # consumes the prefill queues (host-side reads
                        # only — the tracer never touches the device)
                        dec = inst.decode_slots()
                        cost_in = (
                            len(dec),
                            sum(min(inst.slots[i].next_pos,
                                    inst.cache_len) for i in dec),
                            max((len(drafts.get(i, [])) for i in dec),
                                default=0),
                            sum(min(len(inst.slots[i].prefill_queue),
                                    inst.prefill_chunk)
                                for i in inst.prefilling_slots()))
                    ticket = inst.dispatch_step(drafts)
                if ticket is None:
                    continue
                any_active = True
                tickets.append((inst, drafts, ticket))
                if tr is not None and cost_in is not None:
                    n_dec, ctx_sum, gamma, pf_tokens = cost_in
                    mean_ctx = ctx_sum / max(n_dec, 1)
                    tick_dt = max(tick_dt, self._fwd.mixed_step_time(
                        max(n_dec, 1), 1 + gamma, pf_tokens, mean_ctx))
                if self._epoch:
                    # tail-packing currency: a step whose batch mixes
                    # inject epochs is running next-iteration rows in
                    # what would have been the barrier's tail bubble
                    eps = [self._req_epoch.get(inst.slots[i].req_id, 0)
                           for i in inst.active_slots()]
                    if len(set(eps)) > 1:
                        lo = min(eps)
                        stats.overlap_steps += 1
                        stats.reclaimed_rows += \
                            sum(1 for e in eps if e > lo)

            # 2) fill free capacity while the steps are in flight — one
            # batched scheduling cycle whose host work (scheduler picks,
            # pool fetches, queue appends) overlaps device compute.
            # Admissions run BEFORE the export flush so a slot released
            # last tick is still draining here: taking it over enqueues
            # its snapshot gather behind the in-flight step (takeover-
            # aware overlap) instead of stalling the next dispatch.
            # Same-instance arrivals share one batched KV import
            # (flushed by the instance at its next dispatch).
            admitted = 0
            for r, iid in sched.plan_admissions(
                    [v for v in self._views() if v.free_slots > 0]):
                self._admit(sched, r, iid, stats)
                admitted += 1

            # 3) flush the deferred KV exports (chunks released last
            # tick): the batched gather is enqueued behind the step it
            # overlaps and the host moves on.  A second scheduling pass
            # fills the just-freed slots in the same window — without
            # it every freed slot would sit out a tick and admissions
            # would mostly see a single candidate instance, starving
            # the topology ranking of real placement choices.
            freed = 0
            for inst in self.instances:
                if not inst.alive or self._is_stuck(inst):
                    continue
                freed += self._flush_releases(inst, sched)
            if freed:
                for r, iid in sched.plan_admissions(
                        [v for v in self._views() if v.free_slots > 0]):
                    self._admit(sched, r, iid, stats)
                    admitted += 1

            # 4) commit results and run chunk/finish bookkeeping;
            # finished groups are buffered and yielded only after every
            # ticket committed (no step in flight at any yield point)
            finished_groups: List[Group] = []
            for inst, drafts, ticket in tickets:
                out = inst.commit_step(ticket)
                stats.steps += 1
                for slot, (new_toks, _lps, n_acc) in out.items():
                    seq = inst.slots[slot]
                    r = self._reqs[seq.req_id]
                    d = drafts.get(slot, [])
                    n_draft = len(d)
                    stats.tokens += len(new_toks)
                    if new_toks:
                        self._restore_logprobs(seq, len(new_toks))
                    # staleness ledger: note only genuinely-new tokens.
                    # Replayed/re-decoded tokens from crash recovery are
                    # already recorded under the param versions they
                    # were originally sampled at; the ledger catches up
                    # to len(seq.generated) and then records normally
                    # (at the crossover commit, only the truly-new
                    # suffix of new_toks is noted).
                    fresh = len(seq.generated) - r.version_tokens_recorded()
                    if fresh > 0:
                        r.note_version_tokens(self.param_version,
                                              min(fresh, len(new_toks)))
                    if seq.reval_queue:
                        # prefix revalidation: the drafts came from the
                        # old-params generation, not the CST.  Excluded
                        # from the β profile (they measure old-policy
                        # agreement, not CST quality).  Consume the
                        # re-accepted prefix; any divergence — a
                        # rejected draft, or a bonus token that departs
                        # from the old trajectory — drops the rest.
                        stats.reval_tokens += n_draft
                        stats.reval_accepted += n_acc
                        q = seq.reval_queue
                        if seq.finished or n_acc < n_draft \
                                or len(q) == n_draft:
                            seq.reval_queue = []
                        elif new_toks and q[n_draft] == new_toks[-1]:
                            del q[:n_draft + 1]
                        else:
                            seq.reval_queue = []
                    else:
                        stats.drafted += n_draft
                        stats.accepted += n_acc
                        if n_draft and isinstance(d, TokenTree):
                            # per-branch β: attribute the accepted chain
                            # to the beam rank that drafted it (trunk
                            # misses count against the trunk)
                            self.ctx.record_tree_verification(
                                d.winner_rank(new_toks[:n_acc]),
                                d.max_depth, n_acc, n_ranks=len(d.paths))
                        elif n_draft:
                            self.ctx.record_verification(n_draft, n_acc)
                    if new_toks:
                        # stable speculator id: python str hash is
                        # randomized per process (PYTHONHASHSEED), which
                        # made DGDS ids — and draft paths — nondeterministic
                        self.server.update_cst(
                            r.group_id,
                            zlib.crc32(r.req_id.encode()) & 0x7FFFFFFF,
                            len(seq.generated) - len(new_toks), new_toks)
                # 3) chunk / finish bookkeeping
                for slot in list(inst.active_slots()):
                    seq = inst.slots[slot]
                    r = self._reqs[seq.req_id]
                    _, _, _, chunk = self._placements[r.req_id]
                    consumed = len(seq.generated) - len(r.generated)
                    if seq.finished:
                        self._release(r, stats, export=False)
                        self.pool.drop(r.req_id)
                        r.finish(time.monotonic())
                        sched.on_finished(r)
                        if rec is not None:
                            rec.on_finish(r.req_id, tick)
                        if feed is not None:
                            feed.note_request_finished(
                                r.req_id, r.group_id, tick,
                                len(r.generated))
                        g = all_groups.get(r.group_id)
                        if g is not None and g.all_finished \
                                and r.group_id not in yielded:
                            yielded.add(r.group_id)
                            finished_groups.append(g)
                    elif consumed >= chunk:
                        remaining = r.max_new_tokens - len(seq.generated)
                        if self.final_chunk_inplace and \
                                0 < remaining <= self.chunk_size:
                            # eviction-aware export: the request fits its
                            # final chunk budget — renew in place, skip
                            # the pool round-trip (the blob would be
                            # fetched once and dropped)
                            self._sync_back(r, seq)
                            self._placements[r.req_id] = \
                                (inst, slot, seq, remaining)
                            stats.chunks += 1
                            stats.inplace_renewals += 1
                            r.chunks_run += 1
                            if rec is not None:
                                rec.on_renew(r.req_id, tick)
                        elif inst.migration_mode == "batched":
                            self._begin_release(r, stats)
                        else:
                            self._release(r, stats, export=True)
                            sched.requeue(r)

            # 5) stream finished groups (every ticket has committed —
            # no step in flight, so consumers may inject/refresh here)
            for g in finished_groups:
                yield ("group", g)

            free = sum(v.free_slots for v in self._views())
            if not any_active and not any_blocked and not freed \
                    and not admitted and not sched.all_finished:
                # nothing running, nothing freed, nothing admitted and
                # nothing placeable.  Give the consumer one injection
                # window (next-epoch work may fit where this epoch's
                # chunks cannot); without an injection this is the same
                # capacity deadlock the barrier loop raised on.
                self._injected_since_bubble = False
                yield ("bubble", {"free_slots": free,
                                  "pending": sched.pending_count(),
                                  "stalled": True})
                if not self._injected_since_bubble:
                    raise RuntimeError(
                        "rollout stalled: no instance can hold the "
                        "next chunk")
            elif free > 0 and sched.ready_count() == 0 \
                    and not sched.all_finished:
                # the tail bubble: idle capacity, but every pending
                # request is already placed — only next-epoch injection
                # can fill these slots
                yield ("bubble", {"free_slots": free,
                                  "pending": sched.pending_count(),
                                  "stalled": False})
            elif feed is not None and not any_active and not any_blocked \
                    and sched.all_finished:
                # open-loop idle gap: nothing to run yet, but the
                # arrival trace has more traffic — the tick clock keeps
                # advancing so future arrivals come due
                stats.idle_ticks += 1
            if progress_every and stats.steps % progress_every == 0:
                done = len(self._reqs) - sched.pending_count()
                print(f"[rollout] steps={stats.steps} done={done}/"
                      f"{len(self._reqs)} tokens={stats.tokens} "
                      f"acc={stats.mean_acceptance:.2f}")

            # end of tick: classify every open request into exactly one
            # phase (span conservation holds by construction — one
            # segment per live request per tick) and advance the
            # modeled clock by the tick's widest dispatched step (an
            # idle tick costs one nominal decode step).
            if tr is not None:
                if rec is not None:
                    placed = {}
                    for rid, (inst, slot, _seq, _c) in \
                            self._placements.items():
                        if self._is_stuck(inst):
                            placed[rid] = "stuck"
                        elif slot in inst.decode_slots():
                            placed[rid] = "decode"
                        else:
                            placed[rid] = "prefill"
                    rec.end_tick(tick, placed)
                tr.advance_tick(tick_dt if tick_dt > 0.0
                                else self._fwd.step_time(1, 1, 0.0))

        stats.wall_seconds = time.monotonic() - t0
        stats.offer_delay_max = max(sched.offer_delays, default=0.0)
        if rec is not None:
            rec.finalize()
        result = RolloutResult(
            groups=list(all_groups.values()), stats=stats,
            ctx_stats=self.ctx.stats(), pool_stats=self.pool.stats(),
            dgds_stats=self.server.stats())
        for gid, g in all_groups.items():
            # groups that were already finished at submit time (or empty)
            # never pass through the commit loop — flush them here
            if gid not in yielded and g.all_finished:
                yielded.add(gid)
                yield ("group", g)
        # past this yield the loop never ticks again: inject() checks
        # the flag and raises instead of letting groups vanish
        self._stream_drained = True
        yield ("result", result)
