"""Discrete-event cluster simulator for production-scale rollout.

Replays a Table-3-style workload (thousands of requests, 32-96k max
generation lengths) over N inference instances with an analytic roofline
cost model (:mod:`repro_torch.core.sdmodel`), reproducing the paper's
experiments that cannot run on one CPU: end-to-end throughput (Fig. 7),
tail time (Fig. 8/9), the ablation (Table 4), context-vs-oracle (Fig. 10),
SD strategies (Fig. 11) and Partial Rollout (Fig. 12).

Simulation granularity is a *segment*: a run of decode steps on one
instance during which batch composition is constant.  Segment duration
integrates the cost model at the KV-midpoint; events (request finished /
chunk exhausted / KV exhausted / refill) bound each segment.  All
scheduling code is shared with the real-engine tier where possible — the
Scheduler and ContextManager drive both.

Scheduling modes
----------------
* ``group``     — veRL baseline: a group is atomic; groups round-robin over
                  instances at submit; no migration; KV exhaustion preempts
                  the youngest requests (re-prefill on resume).
* ``request``   — Roll-Flash prompt replication: requests round-robin over
                  instances; still no migration.
* ``divided``   — chunk-level global scheduling via the shared Scheduler
                  (policies: fifo/nocontext, seer, lfs=oracle, sfs) with the
                  global KV pool making migration stateless.
* ``streamrl``  — StreamRL-Oracle skewness-aware bucketing: requests
                  bucketed by true length; long buckets get dedicated
                  instances with reduced concurrency.
* ``partial``   — Partial Rollout (APRIL-style): over-issue ``over_issue``x
                  requests, stop at the target count, defer the rest.

Speculative decoding modes: ``none``, ``suffix`` (per-request CST),
``grouped`` (Seer DGDS CST), ``grouped+multipath``, ``grouped+tree``
(multi-path drafts verified as one token tree per request — equal
draft-token budget, branch rescues raise accepted tokens/forward),
``draft_model``, ``mtp`` — each an (acceptance-profile, draft-cost)
pair; grouped modes' acceptance grows with the number of completed
group references (Table 2).
"""
from __future__ import annotations

import heapq
import math
import random
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.configs.base import ModelConfig
from repro_torch.core.context import ContextManager
from repro_torch.core.mba import MBAConfig, mba_speculation, mba_tree_paths
from repro_torch.core.request import Group, ReqState, RolloutRequest
from repro_torch.core.scheduler import InstanceView, Scheduler
from repro_torch.core.sdmodel import (H800, ForwardCostModel, HardwareSpec,
                                SDThroughputModel)
from repro_torch.core.workload import (Arrival, ArrivalQueue, ArrivalSpec,
                                 TenantRateLimiter, latency_percentiles)
from repro_torch.data.workload import Workload, WorkloadSpec


# ---------------------------------------------------------------------------
# speculative decoding strategy models
# ---------------------------------------------------------------------------

# Table 2 (linear drafting): mean acceptance length incl. bonus vs number of
# completed grouped references.  Multi-path factors from the same table.
_TABLE2_REFS = np.array([0, 1, 5, 15], dtype=float)
_TABLE2_ACCLEN = np.array([1.70, 2.04, 2.32, 2.53])
_MULTIPATH_FACTOR = {1: 1.0, 2: 1.063, 4: 1.126}   # 2.69/2.53, 2.85/2.53


def _acclen_to_alpha(acc_len: float, gamma: int) -> float:
    """Invert E[tokens] = (1-a^{γ+1})/(1-a) for a (bisection)."""
    acc_len = min(acc_len, gamma + 0.999)
    lo, hi = 1e-6, 0.999
    for _ in range(50):
        mid = (lo + hi) / 2
        e = (1 - mid ** (gamma + 1)) / (1 - mid)
        if e < acc_len:
            lo = mid
        else:
            hi = mid
    return (lo + hi) / 2


@dataclass(frozen=True)
class SDStrategy:
    name: str                       # none|suffix|grouped|draft_model|mtp
    gamma_max: int = 8
    top_k: int = 1                  # multi-path width (grouped only)
    adaptive: bool = True           # adapt gamma to batch (Seer MBA)
    draft_flops_per_token: float = 0.0   # separate-draft-model cost
    draft_param_bytes: float = 0.0  # draft model weights (memory-bound
    #                                 at rollout-tail batch sizes — the
    #                                 paper's "excessive draft overhead")
    alpha_fixed: Optional[float] = None  # fixed acceptance (draft/mtp)
    # tree verification: the per-request token budget is split across
    # candidate paths (mba_tree_paths) and the whole tree verifies in
    # one forward — same forward cost as a linear chain of equal token
    # budget, higher expected acceptance.  branch_rescue[r] is the
    # static Table-2-style probability that the sampled chain leaves
    # the trunk and follows the rank-r beam (the engine tier measures
    # this online via ContextManager.branch_beta; the simulator uses
    # the profile below)
    tree: bool = False
    branch_rescue: tuple = (1.0, 0.30, 0.15, 0.08)

    def alpha(self, n_refs: int, gamma: int) -> float:
        if self.name == "none":
            return 0.0
        if self.alpha_fixed is not None:
            return self.alpha_fixed
        if self.name == "suffix":
            acc = _TABLE2_ACCLEN[0]          # self-reference only
        else:                                 # grouped
            acc = float(np.interp(n_refs, _TABLE2_REFS, _TABLE2_ACCLEN))
            if not self.tree:
                # tree mode models branch uplift explicitly via
                # expected_tokens_tree; applying the Table-2 best-path
                # multipath factor too would double-count it
                acc *= _MULTIPATH_FACTOR.get(self.top_k, 1.0)
        return _acclen_to_alpha(acc, gamma)


def sd_strategy(name: str, cfg: ModelConfig) -> SDStrategy:
    if name == "none":
        return SDStrategy("none", gamma_max=0)
    if name == "suffix":
        # SuffixDecoding baseline: γ_max=16, per-request history only
        return SDStrategy("suffix", gamma_max=16)
    if name == "grouped":
        return SDStrategy("grouped", gamma_max=8)
    if name == "grouped+multipath":
        return SDStrategy("grouped", gamma_max=8, top_k=4)
    if name == "grouped+tree":
        # multi-path drafts verified as one token tree per request —
        # same draft-token budget and forward shape as grouped linear,
        # side branches salvage steps the trunk loses
        return SDStrategy("grouped", gamma_max=8, top_k=4, tree=True)
    if name == "draft_model":
        # dedicated ~7B draft: high acceptance, heavy draft cost — each of
        # the γ sequential draft steps streams the full 14 GB of bf16
        # draft weights (memory-bound at tail batch sizes)
        return SDStrategy("draft_model", gamma_max=3,
                          draft_flops_per_token=2 * 7e9,
                          draft_param_bytes=2 * 7e9,
                          alpha_fixed=0.75)
    if name == "mtp":
        # MTP head ≈ one extra layer of the target (~1B slice), γ=1
        return SDStrategy("mtp", gamma_max=1, draft_flops_per_token=2 * 1e9,
                          draft_param_bytes=2 * 1e9,
                          alpha_fixed=0.80)
    raise ValueError(name)


# ---------------------------------------------------------------------------
# simulated instance
# ---------------------------------------------------------------------------


@dataclass
class SimSeq:
    req: RolloutRequest
    true_len: int                  # total tokens this request will emit
    ctx: float                     # current KV length (prompt + generated)
    chunk_left: int                # tokens left in the scheduled chunk
    frac: float = 0.0              # fractional token carry (SD)

    @property
    def total_left(self) -> int:
        return self.true_len - self.req.gen_len


class SimInstance:
    def __init__(self, iid: str, kv_capacity: int, max_slots: int,
                 node: str = "n0"):
        self.iid = iid
        self.node = node
        self.kv_capacity = kv_capacity
        self.max_slots = max_slots
        self.running: Dict[str, SimSeq] = {}
        self.queue: List[RolloutRequest] = []   # local queue (group modes)
        self.preempted: List[SimSeq] = []
        self.busy_time = 0.0
        # when this instance last finished productive work — the gap to
        # the fleet-wide end time is its barrier stall (tail idle a
        # bounded-staleness overlap would fill with next-iteration work)
        self.last_busy_end = 0.0
        self.overhead = 0.0          # prefill/pool time owed to next segment
        # prefill tokens folded into the next segment's mixed steps
        # (divided mode: the engine batches admission prefill into decode
        # forwards instead of running serial chunk forwards); ctxsum
        # carries sum(L_i^2/2) so the attention term charges each
        # admission its own mean context, not the aggregated backlog's
        self.prefill_backlog = 0.0
        self.prefill_backlog_ctxsum = 0.0
        # KV blobs moved through the global pool since the last segment
        # (imports on admission + exports on chunk release): stall is
        # charged once per segment via the batched/overlapped migration
        # model, mirroring the engine's one-gather-per-batch dispatch
        self.mig_blobs = 0
        self.mig_bytes = 0.0
        # subset of mig_bytes that crossed the inter-node fabric
        # (fetches whose blob lived on another node's tiers)
        self.mig_cross_bytes = 0.0
        self.tokens_out = 0.0
        self.preemptions = 0

    def kv_used(self) -> float:
        return sum(s.ctx for s in self.running.values())

    def kv_free(self) -> float:
        return self.kv_capacity - self.kv_used()

    def free_slots(self) -> int:
        return self.max_slots - len(self.running)


# ---------------------------------------------------------------------------
# the simulator
# ---------------------------------------------------------------------------


@dataclass
class SimConfig:
    mode: str = "divided"           # group|request|divided|streamrl|partial
    policy: str = "seer"            # divided-mode scheduler policy
    sd: str = "none"
    chunk_size: int = 2048          # divided-rollout chunk (tokens)
    max_slots: int = 256
    kv_capacity_tokens: Optional[int] = None   # default: from HBM budget
    hw: HardwareSpec = H800
    chips_per_instance: int = 8
    # per-instance tensor-parallel degree (the engine's column-parallel
    # head/ff mesh): divides the compute/HBM roofline like extra chips
    # but adds ForwardCostModel's collective term (activation
    # all-gathers, MoE all-to-all) to every modeled forward
    tp: int = 1
    hbm_per_chip: float = 80e9
    mba_lam: float = 2.0
    segment_cap: int = 1024         # max tokens per segment (model refresh)
    over_issue: float = 2.0         # partial-rollout over-issue factor
    partial_defer_frac: float = 0.0  # set >0 in partial mode automatically
    pool_net_bw: float = 25e9       # KV pool fetch bandwidth (bytes/s)
    # topology: instances are spread over ``nodes`` hosts (contiguous
    # blocks); a fetch whose blob lives on another node pays a second
    # wire leg at ``pool_cross_bw`` (the inter-node fabric hop), and the
    # topology-aware scheduler ranks placements to avoid it
    nodes: int = 1
    pool_cross_bw: float = 12e9
    topology_aware: bool = True
    # eviction-aware export: a request whose remaining length fits one
    # chunk renews in place instead of round-tripping the pool (mirrors
    # SeerRollout.final_chunk_inplace).  Off by default: renewal is
    # SFS-biased — near-finished requests hoard slots that LFS-style
    # policies would hand to longer requests — so it trades tail
    # latency for pool churn; enable when migration cost dominates.
    final_chunk_inplace: bool = False
    # batched+overlapped KV migration (the engine's batched path): one
    # launch per migration batch and ``migration_overlap`` of the wire
    # time hidden under device compute.  batched_migration=False +
    # migration_overlap=0.0 models per-slot moves (one launch
    # per blob, serialized on the step stream).
    batched_migration: bool = True
    migration_overlap: float = 0.75
    streamrl_buckets: int = 4
    seed: int = 0
    # engines accept/commit on device (the engine tier's fused step);
    # set False to model a host-accept loop paying a blocking
    # device->host sync per step (HardwareSpec.host_sync_overhead)
    fused_accept: bool = True
    # admission ranking for the divided-mode scheduler: "total_delay"
    # folds KV-fetch time and the queued-prefill backlog into one
    # modeled-delay unit; "lexicographic" is the legacy two-level key
    admission_rank: str = "total_delay"
    # bounded-staleness rollout<->train overlap: instances that drain
    # early no longer idle at the iteration barrier — next-iteration
    # prompts pack the tail.  barrier_reclaim is the fraction of the
    # measured barrier stall (per-instance tail idle) the overlap
    # actually recovers; calibrate with with_measured_barrier().
    async_overlap: bool = False
    barrier_reclaim: float = 1.0
    # fault injection (cluster-scale recovery-overhead prediction): each
    # completed segment fails with probability fault_rate (seeded,
    # deterministic — the sim-side mirror of the engine's
    # FaultInjector).  A failed segment's decoded tokens are lost with
    # the worker: every running request requeues and resumes from its
    # last chunk-boundary blob (token-lossless by the engine's recovery
    # invariant — only time is lost), and the instance sits out
    # mttr_ticks modeled decode steps of downtime before its next
    # segment.  fault_* extras report events, redone work, downtime and
    # the overhead fraction the recovery adds.
    fault_rate: float = 0.0
    mttr_ticks: int = 8
    # open-loop serving (divided mode only): instead of submitting the
    # whole workload at t=0, groups are offered at their seeded arrival
    # times (Poisson rate source + per-tenant token-rate limits) through
    # the scheduler's SLO admission (queue vs shed on the modeled
    # total-delay vs ``arrival.slo_deadline_s``).  Cluster-scale
    # latency percentiles, shed counts and per-tenant goodput land in
    # ``SimResult.extras["serving"]``; shedding decisions are a pure
    # function of (seed, config) — the overload-determinism invariant.
    arrival: Optional[ArrivalSpec] = None

    def with_measured_overlap(self, fraction: float) -> "SimConfig":
        """Calibrate ``migration_overlap`` from an engine's measured
        export-overlap fraction
        (:meth:`~repro_torch.core.rollout.SeerRollout.measured_export_overlap`)
        so divided-mode sim migration stalls track the engine."""
        import dataclasses as _dc
        return _dc.replace(
            self, migration_overlap=min(max(float(fraction), 0.0), 1.0))

    def with_measured_barrier(self, fraction: float) -> "SimConfig":
        """Calibrate the async-overlap reclaim fraction from an engine's
        measured tail-packing efficiency (reclaimed rows per overlap
        step, :class:`~repro_torch.core.rollout.RolloutStats`), enabling
        ``async_overlap`` so barrier-stall accounting reports reclaimed
        instance-seconds and the effective iteration time."""
        import dataclasses as _dc
        return _dc.replace(
            self, async_overlap=True,
            barrier_reclaim=min(max(float(fraction), 0.0), 1.0))


@dataclass
class SimResult:
    total_time: float
    tokens: float
    n_requests: int
    completion_times: np.ndarray       # per request
    output_lengths: np.ndarray
    preemptions: int
    migrations: int
    idle_frac: float
    tokens_per_sec: float
    tail_time: float                   # t_end - t(90% completed)
    tail_frac: float
    drafted: float = 0.0
    accepted: float = 0.0
    instance_finish_spread: float = 0.0
    extras: dict = field(default_factory=dict)

    @property
    def mean_acceptance_len(self) -> float:
        """Mean accepted+bonus per verify step."""
        return self.extras.get("mean_acc_len", 0.0)


class ClusterSimulator:
    def __init__(self, cfg: ModelConfig, spec: WorkloadSpec,
                 sim: SimConfig, *, tracer=None):
        self.cfg = cfg
        self.spec = spec
        self.sim = sim
        # optional flight recorder (repro_torch.obs.Tracer): the sim emits the
        # SAME event schema as the engine tier — request phase spans
        # drawn from repro_torch.obs.timeline.PHASES with explicit modeled
        # timestamps ("tick" is the event-heap pop ordinal)
        self.tracer = tracer
        self._tl = None
        self._tl_tick = 0
        self.fwd = ForwardCostModel(cfg, sim.hw,
                                    chips=sim.chips_per_instance,
                                    tp=sim.tp)
        self.sd_model = SDThroughputModel(self.fwd)
        self.strategy = sd_strategy(sim.sd, cfg)
        kvb = self.fwd.kv_bytes_per_token()
        if sim.kv_capacity_tokens is not None:
            self.kv_capacity = sim.kv_capacity_tokens
        else:
            budget = sim.chips_per_instance * sim.tp \
                * sim.hbm_per_chip * 0.9 - self.fwd.param_bytes()
            self.kv_capacity = int(max(budget, 1e9) / max(kvb, 1))
        self.kv_bytes_per_token = kvb
        worst = spec.prompt_len + spec.max_gen_length
        if self.kv_capacity < worst:
            raise ValueError(
                f"instance KV capacity ({self.kv_capacity} tokens) cannot "
                f"hold one max-length request ({worst} tokens); increase "
                f"chips_per_instance or set kv_capacity_tokens")

    # -- setup ------------------------------------------------------------------

    def _build_requests(self, wl: Workload
                        ) -> Tuple[List[Group], Dict[str, int]]:
        groups: List[Group] = []
        true_len: Dict[str, int] = {}
        for gi in range(wl.n_groups):
            gid = f"g{gi}"
            reqs = []
            for ri in range(self.spec.group_size):
                r = RolloutRequest(
                    req_id=f"{gid}.r{ri}", group_id=gid,
                    prompt=[0] * self.spec.prompt_len, seed=0,
                    max_new_tokens=self.spec.max_gen_length,
                    speculative=(ri == 0), gen_count=0)
                true_len[r.req_id] = int(wl.lengths[gi, ri])
                reqs.append(r)
            groups.append(Group(gid, reqs))
        return groups, true_len

    # -- segment execution --------------------------------------------------------

    def _gamma_for(self, inst: SimInstance, ctxmgr: ContextManager,
                   n_refs: float) -> Tuple[int, int]:
        """Draft lengths (γ_h, γ_l) for the instance's current batch."""
        st = self.strategy
        if st.name == "none" or not inst.running:
            return 0, 0
        B = len(inst.running)
        b_h = sum(1 for s in inst.running.values() if s.req.speculative)
        b_l = B - b_h
        mean_ctx = inst.kv_used() / B
        alpha = st.alpha(int(n_refs), st.gamma_max)
        if not st.adaptive:
            return st.gamma_max, st.gamma_max
        if st.name in ("draft_model", "mtp"):
            g = self.sd_model.optimal_gamma(B, alpha, mean_ctx, st.gamma_max)
            return g, g
        # Seer MBA (Alg. 1) with β from the acceptance profile
        beta = [alpha ** (i + 1) for i in range(st.gamma_max + 1)]
        g_h, g_l = mba_speculation(
            b_h, b_l, beta, self.sd_model, alpha, mean_ctx,
            MBAConfig(gamma_max=st.gamma_max, lam=self.sim.mba_lam))
        return g_h, g_l

    def _drain_migration(self, inst: SimInstance) -> float:
        """Charge the instance's accrued migration transfers (batched,
        overlap-discounted) and reset the counters."""
        if not inst.mig_blobs:
            return 0.0
        stall = self.fwd.migration_stall(
            inst.mig_blobs, inst.mig_bytes, self.sim.pool_net_bw,
            cross_bytes=inst.mig_cross_bytes,
            cross_bw=self.sim.pool_cross_bw,
            batched=self.sim.batched_migration,
            overlap_frac=self.sim.migration_overlap)
        self._seg_stats["mig_time"] += stall
        self._seg_stats["mig_bytes"] += inst.mig_bytes
        self._seg_stats["mig_cross_bytes"] += inst.mig_cross_bytes
        self._seg_stats["mig_batches"] += 1
        inst.mig_blobs = 0
        inst.mig_bytes = 0.0
        inst.mig_cross_bytes = 0.0
        return stall

    def _segment(self, inst: SimInstance, ctxmgr: ContextManager,
                 group_refs: Dict[str, int]) -> Tuple[float, int]:
        """Compute (duration_seconds, tokens_per_request) for the next
        segment on this instance.  Returns (0, 0) if idle."""
        B = len(inst.running)
        if B == 0:
            # an instance whose last chunk just exported still owes the
            # transfer: account it now (and carry it as overhead in case
            # the instance runs again) instead of dropping it
            inst.overhead += self._drain_migration(inst)
            return 0.0, 0
        seqs = list(inst.running.values())
        n_event = min(min(s.chunk_left, s.total_left) for s in seqs)
        n_event = max(1, min(n_event, self.sim.segment_cap))
        # KV exhaustion bound
        kv_free = inst.kv_free()
        n_kv = int(kv_free // B) if B else n_event
        preempt = False
        if n_kv < n_event:
            n_event = max(1, n_kv)
            preempt = n_kv <= 1
        st = self.strategy
        mean_refs = np.mean([group_refs.get(s.req.group_id, 0)
                             for s in seqs]) if seqs else 0
        g_h, g_l = self._gamma_for(inst, ctxmgr, mean_refs)
        mean_ctx = inst.kv_used() / B + n_event / 2
        if st.name == "none" or (g_h == 0 and g_l == 0):
            t_step = self.fwd.step_time(B, 1, mean_ctx,
                                        fused_accept=self.sim.fused_accept)
            tok_per_step = 1.0
            gamma_mean = 0.0
        else:
            b_h = sum(1 for s in seqs if s.req.speculative)
            b_l = B - b_h
            gamma_mean = (b_h * g_h + b_l * g_l) / B
            alpha = st.alpha(int(mean_refs), int(max(g_h, g_l, 1)))
            if st.tree and gamma_mean >= 1:
                # tree verification: split the same token budget across
                # paths and salvage trunk misses with side branches —
                # the forward (γ_mean+1 scored tokens) is unchanged
                g = int(round(gamma_mean))
                beta = [alpha ** (i + 1) for i in range(st.gamma_max + 1)]
                budgets = mba_tree_paths(g, beta,
                                         list(st.branch_rescue),
                                         st.top_k, st.gamma_max)
                tok_per_step = self.sd_model.expected_tokens_tree(
                    alpha, budgets, list(st.branch_rescue))
            else:
                tok_per_step = self.sd_model.expected_tokens(
                    alpha, int(round(gamma_mean)))
            t_step = self.fwd.step_time(B, int(round(gamma_mean)) + 1,
                                        mean_ctx,
                                        fused_accept=self.sim.fused_accept)
            t_step += self.sd_model.draft_time(B, int(round(gamma_mean)))
            if st.draft_flops_per_token or st.draft_param_bytes:
                # γ sequential draft forwards: roofline of compute (all B
                # requests) vs streaming the draft weights once per step
                t_comp = (B * st.draft_flops_per_token) / \
                    (self.sim.chips_per_instance * self.sim.hw.peak_flops
                     * 0.4)
                t_mem = st.draft_param_bytes / \
                    (self.sim.chips_per_instance * self.sim.hw.hbm_bw * 0.7)
                t_step += gamma_mean * max(t_comp, t_mem)
        steps = max(1, math.ceil(n_event / tok_per_step))
        dur = steps * t_step
        if inst.prefill_backlog > 0:
            # queued admission prefill rides along with the segment's
            # forwards: charge the marginal mixed-step cost (extra scored
            # tokens + KV writes) rather than serial per-chunk forwards
            # with their own weight streams and launch overheads
            tpr = 1 if gamma_mean == 0 else int(round(gamma_mean)) + 1
            pctx = inst.prefill_backlog_ctxsum / inst.prefill_backlog
            dur += self.fwd.mixed_step_time(
                B, tpr, inst.prefill_backlog, mean_ctx,
                prefill_ctx=pctx) \
                - self.fwd.forward_time(B, tpr, mean_ctx)
            inst.prefill_backlog = 0.0
            inst.prefill_backlog_ctxsum = 0.0
        # migrations since the last segment: one batched transfer,
        # overlap_frac of the wire time hidden under this segment's
        # compute (the engine dispatches the gather behind the step)
        dur += self._drain_migration(inst)
        self._seg_stats["steps"] += steps * B
        self._seg_stats["drafted"] += steps * B * gamma_mean
        self._seg_stats["accepted"] += steps * B * (tok_per_step - 1.0)
        return dur, n_event

    # -- main loop ------------------------------------------------------------------

    def run(self, wl: Workload, *, n_target: Optional[int] = None
            ) -> SimResult:
        sim = self.sim
        groups, true_len = self._build_requests(wl)
        all_reqs = [r for g in groups for r in g.requests]
        n_requests = len(all_reqs)
        n_target = n_target or n_requests
        if sim.mode == "partial":
            n_target = int(n_requests / sim.over_issue)

        ctxmgr = ContextManager(self.spec.max_gen_length)
        policy = sim.policy if sim.mode == "divided" else "fifo"
        chunk = sim.chunk_size if sim.mode == "divided" \
            else self.spec.max_gen_length
        n_inst = self.spec.n_instances
        nodes = max(1, min(sim.nodes, n_inst))
        instances = [SimInstance(f"i{k}", self.kv_capacity, sim.max_slots,
                                 node=f"n{k * nodes // n_inst}")
                     for k in range(n_inst)]
        self._node_of = {i.iid: i.node for i in instances}
        fetch_cost = self._make_fetch_cost() \
            if (sim.mode == "divided" and sim.topology_aware) else None
        # queued-prefill delay per token for the total-delay ranking:
        # the marginal mixed-step cost of folding one chunk token into a
        # decode forward (same unit the engine tier derives)
        q_cost = max(0.0, self.fwd.mixed_step_time(1, 1, chunk, 0.0)
                     - self.fwd.step_time(1, 1, 0.0)) / max(chunk, 1)
        # open-loop arrivals: groups are NOT pre-buffered — each is
        # offered to the scheduler's SLO admission at its (seeded)
        # release time.  Arrival times/tenants come from the spec's
        # Poisson process; the token demand each group places on its
        # tenant's rate limiter uses the workload's real shape (prompt
        # plus mean true generation length), so client-side metering
        # matches the work actually offered.
        arrival_q = None
        if sim.arrival is not None:
            if sim.mode != "divided":
                raise ValueError("SimConfig.arrival requires divided mode")
            proc = sim.arrival.process(len(groups))
            trace = [Arrival(t=a.t, index=a.index, tenant=a.tenant,
                             prompt_len=self.spec.prompt_len,
                             max_new_tokens=int(round(float(
                                 np.mean(wl.lengths[a.index])))))
                     for a in proc.trace()]
            limiter = TenantRateLimiter(sim.arrival.tenant_specs(),
                                        burst_s=sim.arrival.burst_s)
            arrival_q = ArrivalQueue(trace, limiter, self.spec.group_size)
        sched = Scheduler([] if arrival_q is not None else groups,
                          ctxmgr, policy=policy, chunk_size=chunk,
                          oracle_lengths=(true_len if policy in
                                          ("lfs", "sfs") else None),
                          fetch_cost=fetch_cost,
                          rank_mode=sim.admission_rank,
                          queue_cost_per_token=q_cost,
                          slo_deadline_s=(sim.arrival.slo_deadline_s
                                          if sim.arrival else None))
        self._assign_static(groups, instances, true_len)

        # -- flight recorder ------------------------------------------------
        # Same event schema as the engine tier, explicit modeled
        # timestamps.  Per request ONE phase span is open at any time
        # (start time/tick + its phase in "pending"); every lifecycle
        # transition closes it at `now` and opens the next, so a
        # finished request's spans tile [submit, completion) exactly —
        # the engine TimelineRecorder's conservation invariant.
        tr = self.tracer
        self._tl = None if tr is None else {
            "last": {}, "tick": {}, "pending": {}, "tenant": {}}
        self._tl_tick = 0
        if tr is not None:
            sched.tracer = tr
            if arrival_q is None:
                # closed loop: every request is buffered at t=0
                for r in all_reqs:
                    self._tl["last"][r.req_id] = 0.0
                    self._tl["tick"][r.req_id] = 0
                    self._tl["pending"][r.req_id] = "queue"

        group_refs: Dict[str, int] = {}     # completed requests per group
        self._seg_stats = {"steps": 0.0, "drafted": 0.0, "accepted": 0.0,
                           "mig_time": 0.0, "mig_bytes": 0.0,
                           "mig_cross_bytes": 0.0, "mig_batches": 0.0}
        completion: Dict[str, float] = {}
        inst_of: Dict[str, int] = {}
        migrations = 0
        now = 0.0
        finished = 0
        # event heap: (time, seq#, instance index); index -1 marks an
        # arrival-release event (open-loop mode)
        heap: List[Tuple[float, int, int]] = []
        ctr = 0
        # -- open-loop accounting ------------------------------------------
        idle_set: set = set()          # parked instances (no heap entry)
        admitted_reqs = 0              # dynamic finish target
        t_admit: Dict[str, float] = {}
        tenant_of: Dict[str, str] = {}
        shed_idx: List[int] = []
        srv_offered = srv_admitted = srv_shed = 0
        qd_peak, qd_sum, qd_samples = 0, 0.0, 0
        srv_tenants: Dict[str, Dict[str, float]] = {}
        if arrival_q is not None:
            srv_tenants = {ts.name: {"arrived": 0, "admitted": 0,
                                     "shed": 0, "goodput_tokens": 0.0}
                           for ts in sim.arrival.tenant_specs()}
            # every instance starts parked; arrivals wake them
            idle_set = set(range(len(instances)))
            for inst in instances:
                inst._seg = (0.0, 0.0, 0)
            nx = arrival_q.next_release_time(0.0)
            heapq.heappush(heap, (max(nx or 0.0, 0.0), ctr, -1))
            ctr += 1
        else:
            for k, inst in enumerate(instances):
                self._fill(inst, sched, instances, now, true_len)
                dur, n = self._segment(inst, ctxmgr, group_refs)
                dur += inst.overhead
                inst.overhead = 0.0
                inst._seg = (now, dur, n)
                heapq.heappush(heap, (now + (dur if n else 1e-3), ctr, k))
                ctr += 1

        idle_wakes = 0
        fault_rng = random.Random(sim.seed * 9176 + 11)
        fault_events = 0
        fault_lost = 0.0
        fault_down = 0.0
        while heap:
            if arrival_q is not None:
                # dynamic target: everything admitted so far, plus what
                # the still-pending arrivals could admit (shed groups
                # leave the target)
                n_target = admitted_reqs + self.spec.group_size * \
                    arrival_q.pending_count()
            if finished >= n_target:
                break
            now, _, k = heapq.heappop(heap)
            self._tl_tick += 1
            if k < 0:
                # arrival-release event: offer every releasable group
                # through the SLO admission, wake parked instances if
                # anything was admitted, schedule the next release
                woke = False
                for arr in arrival_q.release_ready(now + 1e-9):
                    g = groups[arr.index]
                    views = [InstanceView(i.iid, i.free_slots(),
                                          int(i.kv_free()),
                                          active_requests=len(i.running),
                                          queued_prefill_tokens=int(
                                              i.prefill_backlog),
                                          node=i.node)
                             for i in instances]
                    srv_offered += 1
                    pt = srv_tenants.setdefault(
                        arr.tenant, {"arrived": 0, "admitted": 0,
                                     "shed": 0, "goodput_tokens": 0.0})
                    pt["arrived"] += 1
                    if sched.offer_group(g, views):
                        srv_admitted += 1
                        pt["admitted"] += 1
                        tenant_of[g.group_id] = arr.tenant
                        for r in g.requests:
                            t_admit[r.req_id] = now
                            if self._tl is not None:
                                self._tl["last"][r.req_id] = now
                                self._tl["tick"][r.req_id] = self._tl_tick
                                self._tl["pending"][r.req_id] = "queue"
                                self._tl["tenant"][r.req_id] = arr.tenant
                        admitted_reqs += len(g.requests)
                        woke = True
                    else:
                        srv_shed += 1
                        pt["shed"] += 1
                        shed_idx.append(arr.index)
                        if tr is not None:
                            for r in g.requests:
                                tr.instant(
                                    "shed", "request", r.req_id,
                                    tick=self._tl_tick, t=now,
                                    group=g.group_id, tenant=arr.tenant)
                depth = sched.ready_count()
                qd_peak = max(qd_peak, depth)
                qd_sum += depth
                qd_samples += 1
                if woke and idle_set:
                    for ki in sorted(idle_set):
                        heapq.heappush(heap, (now, ctr, ki))
                        ctr += 1
                    idle_set.clear()
                nx = arrival_q.next_release_time(now)
                if nx is not None:
                    heapq.heappush(heap, (max(nx, now + 1e-9), ctr, -1))
                    ctr += 1
                continue
            if idle_wakes > 200 * n_requests:
                raise RuntimeError("simulation livelock (nothing placeable)")
            inst = instances[k]
            t0, dur, n_tok = inst._seg
            if n_tok and sim.fault_rate > 0.0 \
                    and fault_rng.random() < sim.fault_rate:
                # instance crash at segment end: the segment burned its
                # wall time but its tokens are lost with the worker.
                # Every running request requeues (recovering from its
                # last chunk-boundary pool blob — lossless, so lengths
                # are simply re-decoded later) and the instance idles
                # mttr_ticks modeled decode steps before its next
                # segment.
                inst.busy_time += dur
                inst.last_busy_end = now
                fault_events += 1
                fault_lost += dur
                downtime = sim.mttr_ticks * dur / max(n_tok, 1)
                fault_down += downtime
                inst.overhead += downtime
                for rid in list(inst.running):
                    s = inst.running.pop(rid)
                    sched.requeue(s.req)
                    s.req.instance_id = inst.iid
                    if sim.mode == "divided":
                        # the re-admission re-fetches the boundary blob
                        inst.mig_blobs += 1
                        inst.mig_bytes += s.ctx * self.kv_bytes_per_token
                    if self._tl is not None:
                        # the burned segment (and the wait until the
                        # re-admission) is time lost to the fault
                        self._tl_close(s.req, now, "recovery",
                                       phase="recovery")
                        tr.instant("recovery", "request", rid,
                                   tick=self._tl_tick, t=now,
                                   kind="blob")
                n_tok = 0
            if n_tok:
                inst.busy_time += dur
                inst.last_busy_end = now
                for rid in list(inst.running):
                    s = inst.running[rid]
                    take = min(n_tok, s.total_left, s.chunk_left)
                    s.req.gen_count += take      # lengths only, no tokens
                    s.ctx += take
                    s.chunk_left -= take
                    inst.tokens_out += take
                    if self._tl is not None:
                        # segment end: close the open span (its phase is
                        # "prefill" for a fresh admission's first
                        # segment, "decode" after) and keep decoding
                        self._tl_close(s.req, now, "decode")
                    if s.total_left <= 0:
                        del inst.running[rid]
                        s.req.finish(now)
                        sched.on_finished(s.req)
                        completion[rid] = now
                        inst_of[rid] = k
                        group_refs[s.req.group_id] = \
                            group_refs.get(s.req.group_id, 0) + 1
                        finished += 1
                        if self._tl is not None:
                            self._tl["last"].pop(rid, None)
                            tr.instant("finish", "request", rid,
                                       tick=self._tl_tick, t=now,
                                       group=s.req.group_id)
                    elif s.chunk_left <= 0:
                        if sim.final_chunk_inplace and \
                                sim.mode == "divided" and \
                                0 < s.total_left <= sim.chunk_size:
                            # eviction-aware export: the request fits
                            # its final chunk budget — renew in place,
                            # skip the pool round-trip (mirrors
                            # SeerRollout.final_chunk_inplace)
                            s.chunk_left = s.total_left
                            continue
                        # chunk exhausted -> back to the global buffer;
                        # the KV blob export (put) moves bytes too —
                        # charged with the batched/overlapped model at
                        # this instance's next segment
                        del inst.running[rid]
                        sched.requeue(s.req)
                        s.req.instance_id = inst.iid
                        if sim.mode == "divided":
                            inst.mig_blobs += 1
                            inst.mig_bytes += s.ctx * \
                                self.kv_bytes_per_token
                        if self._tl is not None:
                            # off-slot until re-admission: export +
                            # pool residence + fetch = migrate window
                            self._tl["pending"][rid] = "migrate"
                # KV-pressure preemption (non-divided modes only)
                if sim.mode in ("group", "request", "streamrl", "partial") \
                        and inst.kv_free() < len(inst.running):
                    self._preempt(inst)
            migrations += self._fill(inst, sched, instances, now,
                                     true_len)
            if idle_set:
                # _fill may cross-admit onto a parked instance (the
                # topology ranking can prefer it); give it a heap entry
                # or its segment would never run
                for ki in [ki for ki in sorted(idle_set)
                           if instances[ki].running]:
                    idle_set.discard(ki)
                    heapq.heappush(heap, (now, ctr, ki))
                    ctr += 1
            dur, n = self._segment(inst, ctxmgr, group_refs)
            dur += inst.overhead
            inst.overhead = 0.0
            inst._seg = (now, dur, n)
            if n:
                heapq.heappush(heap, (now + dur, ctr, k))
                idle_wakes = 0
            else:
                # idle: wake up shortly to re-check the buffer
                if sched.pending_count() > (0 if sim.mode != "partial"
                                            else n_requests - n_target):
                    heapq.heappush(heap, (now + 0.05, ctr, k))
                    idle_wakes += 1
                elif arrival_q is not None and not arrival_q.empty:
                    # open-loop idle gap: no spin — the next arrival
                    # event wakes the park (keeps cluster-scale runs
                    # cheap through sparse traffic)
                    idle_set.add(k)
            ctr += 1
            if not heap and finished < n_target:
                raise RuntimeError("simulation stalled")

        t_end = now
        comp = np.array([completion[r] for r in sorted(completion)])
        out_lens = np.array([r.gen_len for r in all_reqs
                             if r.req_id in completion])
        done_lens = np.array(sorted(completion.values()))
        t90 = done_lens[int(0.9 * (len(done_lens) - 1))] \
            if len(done_lens) else 0.0
        busy = sum(i.busy_time for i in instances)
        idle = 1.0 - busy / max(t_end * len(instances), 1e-9)
        tokens = sum(i.tokens_out for i in instances)
        # inter-instance imbalance: spread of last-completion times
        last_by_inst = {}
        for rid, t in completion.items():
            ki = inst_of[rid]
            last_by_inst[ki] = max(last_by_inst.get(ki, 0.0), t)
        spread = (max(last_by_inst.values()) - min(last_by_inst.values())) \
            / max(t_end, 1e-9) if len(last_by_inst) > 1 else 0.0
        steps = max(self._seg_stats["steps"], 1.0)
        # barrier-stall accounting: instance-seconds of tail idle between
        # each instance's last productive segment and the iteration
        # barrier.  async_overlap models bounded-staleness tail packing —
        # barrier_reclaim of that stall is filled with next-iteration
        # work, shrinking the amortized per-iteration wall time by the
        # reclaimed seconds spread over the fleet.
        barrier_stall = sum(max(0.0, t_end - i.last_busy_end)
                            for i in instances)
        reclaimed = barrier_stall * sim.barrier_reclaim \
            if sim.async_overlap else 0.0
        effective_time = t_end - reclaimed / max(len(instances), 1)
        res = SimResult(
            total_time=t_end, tokens=tokens, n_requests=len(completion),
            completion_times=comp, output_lengths=out_lens,
            preemptions=sum(i.preemptions for i in instances),
            migrations=migrations, idle_frac=idle,
            tokens_per_sec=tokens / max(t_end, 1e-9),
            tail_time=t_end - t90,
            tail_frac=(t_end - t90) / max(t_end, 1e-9),
            drafted=self._seg_stats["drafted"],
            accepted=self._seg_stats["accepted"],
            instance_finish_spread=spread,
            extras={
                "mean_acc_len": 1.0 + self._seg_stats["accepted"] / steps,
                "pool_transfer_time": self._seg_stats["mig_time"],
                "migration_bytes": self._seg_stats["mig_bytes"],
                "migration_cross_bytes":
                    self._seg_stats["mig_cross_bytes"],
                "migration_batches": self._seg_stats["mig_batches"],
                "barrier_stall_seconds": barrier_stall,
                "barrier_stall_reclaimed": reclaimed,
                "effective_time": effective_time,
                "fault_events": fault_events,
                "fault_lost_seconds": fault_lost,
                "fault_downtime_seconds": fault_down,
                "fault_recovery_seconds": fault_lost + fault_down,
                "fault_overhead_frac":
                    (fault_lost + fault_down) / max(busy, 1e-9),
            })
        if arrival_q is not None:
            # graceful-overload accounting: per-request latency is
            # admit -> completion in modeled seconds; goodput counts
            # only tokens of requests that finished (shed work is not
            # goodput by construction — it never ran)
            req_map = {r.req_id: r for r in all_reqs}
            lat = [completion[rid] - t_admit[rid]
                   for rid in completion if rid in t_admit]
            horizon = max(t_end, 1e-9)
            good_total = 0.0
            for rid in completion:
                r = req_map[rid]
                tn = tenant_of.get(r.group_id)
                if tn is not None:
                    srv_tenants[tn]["goodput_tokens"] += r.gen_len
                    good_total += r.gen_len
            per_tenant = {
                name: dict(pt, goodput_tokens_per_sec=(
                    pt["goodput_tokens"] / horizon))
                for name, pt in srv_tenants.items()}
            res.extras["serving"] = {
                "offered_groups": srv_offered,
                "admitted_groups": srv_admitted,
                "shed_groups": srv_shed,
                "shed_indices": shed_idx,
                "latency_s": latency_percentiles(lat),
                "completed_requests": len(lat),
                "goodput_tokens_per_sec": good_total / horizon,
                "per_tenant": per_tenant,
                "queue_depth_peak": qd_peak,
                "queue_depth_mean": qd_sum / max(qd_samples, 1),
                "offer_delay_max": max(sched.offer_delays, default=0.0),
            }
        return res

    # -- placement -----------------------------------------------------------------

    def _make_fetch_cost(self):
        """(request, node) -> modeled seconds to bring its KV blob to
        that node — the scheduler's topology-ranking oracle.  The blob
        lives on the node of the instance that ran the last chunk; a
        cross-node placement pays the extra fabric leg."""
        def fetch_cost(r: RolloutRequest, node: str) -> float:
            if r.gen_len <= 0 or r.instance_id is None:
                return 0.0
            nbytes = (len(r.prompt) + r.gen_len) * self.kv_bytes_per_token
            t = nbytes / max(self.sim.pool_net_bw, 1.0)
            if self._node_of.get(r.instance_id, node) != node:
                t += nbytes / max(self.sim.pool_cross_bw, 1.0)
            return t
        return fetch_cost

    def _assign_static(self, groups: List[Group],
                       instances: List[SimInstance],
                       true_len: Dict[str, int]) -> None:
        """Static placement for the non-divided modes."""
        sim = self.sim
        if sim.mode == "group":
            for gi, g in enumerate(groups):
                inst = instances[gi % len(instances)]
                inst.queue.extend(g.requests)
        elif sim.mode in ("request", "partial"):
            i = 0
            for g in groups:
                for r in g.requests:
                    instances[i % len(instances)].queue.append(r)
                    i += 1
        elif sim.mode == "streamrl":
            # oracle skewness-aware bucketing: requests sorted by true
            # length, split into equal-*work* buckets; each bucket gets an
            # instance share proportional to its work; the longest bucket
            # runs with reduced concurrency (less preemption)
            reqs = sorted((r for g in groups for r in g.requests),
                          key=lambda r: -true_len[r.req_id])
            nb = max(1, min(self.sim.streamrl_buckets, len(instances)))
            total_work = sum(true_len[r.req_id] for r in reqs)
            buckets_reqs: List[List[RolloutRequest]] = [[] for _ in range(nb)]
            acc, bi = 0.0, 0
            for r in reqs:
                buckets_reqs[bi].append(r)
                acc += true_len[r.req_id]
                if acc >= total_work * (bi + 1) / nb and bi < nb - 1:
                    bi += 1
            # instance shares proportional to bucket work
            shares = [max(1, round(len(instances) *
                                   sum(true_len[r.req_id] for r in b)
                                   / total_work)) for b in buckets_reqs]
            while sum(shares) > len(instances):
                shares[shares.index(max(shares))] -= 1
            while sum(shares) < len(instances):
                shares[shares.index(min(shares))] += 1
            off = 0
            for bi, (breqs, sh) in enumerate(zip(buckets_reqs, shares)):
                binst = instances[off:off + sh]
                off += sh
                for j, r in enumerate(breqs):
                    binst[j % len(binst)].queue.append(r)
                if bi == 0:   # longest bucket: reduce concurrency
                    for inst in binst:
                        inst.max_slots = max(8, inst.max_slots // 2)

    def _fill(self, inst: SimInstance, sched: Scheduler,
              instances: List[SimInstance], now: float,
              true_len: Dict[str, int]) -> int:
        """Admit work onto ``inst``.  Returns cross-instance migrations;
        their transfer stall lands on the target instance's
        ``mig_blobs``/``mig_bytes`` and is charged at its next
        segment."""
        sim = self.sim
        migrations = 0
        if sim.mode == "divided":
            while inst.free_slots() > 0:
                r = sched.pick_request()
                if r is None:
                    break
                views = [InstanceView(i.iid, i.free_slots(),
                                      int(i.kv_free()),
                                      active_requests=len(i.running),
                                      queued_prefill_tokens=int(
                                          i.prefill_backlog),
                                      node=i.node)
                         for i in instances]
                target = sched.select_instance(views, r)
                if target != inst.iid:
                    # not for us this cycle; put it back
                    sched.requeue(r)
                    if target is None:
                        break
                    ti = next(i for i in instances if i.iid == target)
                    migrations += self._admit(ti, r, sched, true_len,
                                              now)
                    continue
                migrations += self._admit(inst, r, sched, true_len, now)
        else:
            # instance-local queue (resume preempted first)
            while inst.free_slots() > 0 and \
                    (inst.preempted or inst.queue):
                if inst.preempted:
                    s = inst.preempted.pop(0)
                    if inst.kv_free() < s.ctx + 64:
                        inst.preempted.insert(0, s)
                        break
                    # re-prefill its whole context
                    inst.overhead += self.fwd.prefill_time(int(s.ctx))
                    inst.running[s.req.req_id] = s
                    continue
                r = inst.queue[0]
                need = len(r.prompt) + 64
                if inst.kv_free() < need:
                    break
                inst.queue.pop(0)
                if r.finished:
                    continue
                self._admit(inst, r, sched, true_len, now, local=True)
        return migrations

    def _tl_close(self, r: RolloutRequest, t1: float, next_phase: str,
                  phase: Optional[str] = None) -> None:
        """Close ``r``'s open phase span at ``t1`` (emitting it when it
        has nonzero width) and open the next one.  ``phase`` overrides
        the recorded pending phase (fault attribution)."""
        tl = self._tl
        rid = r.req_id
        t0 = tl["last"].get(rid)
        if t0 is None:
            return
        ph = phase if phase is not None else tl["pending"].get(rid, "queue")
        if t1 > t0:
            self.tracer.span(
                ph, "request", rid, tl["tick"][rid], self._tl_tick,
                t0=t0, t1=t1, tenant=tl["tenant"].get(rid, "-"),
                group=r.group_id)
        tl["last"][rid] = t1
        tl["tick"][rid] = self._tl_tick
        tl["pending"][rid] = next_phase

    def _admit(self, inst: SimInstance, r: RolloutRequest,
               sched: Scheduler, true_len: Dict[str, int], now: float,
               local: bool = False) -> int:
        ctx0 = len(r.prompt) + r.gen_len
        chunk = sched.chunk_tokens(r) if not local \
            else r.max_new_tokens
        migrated = 0
        if r.gen_len > 0 and r.instance_id and r.instance_id != inst.iid:
            migrated = 1
            r.migrations += 1
            # KV pool fetch (divided rollout): no re-prefill; the blob
            # import is batched with the instance's other arrivals and
            # overlapped with compute — stall charged at the next
            # segment via ForwardCostModel.migration_stall.  A blob
            # homed on another node additionally pays the inter-node
            # fabric leg (cross bytes at pool_cross_bw).
            nbytes = ctx0 * self.kv_bytes_per_token
            inst.mig_blobs += 1
            inst.mig_bytes += nbytes
            if self._node_of.get(r.instance_id, inst.node) != inst.node:
                inst.mig_cross_bytes += nbytes
        if r.gen_len == 0:
            if self.sim.mode == "divided":
                # batched prefill: admission queues the prompt; its cost
                # lands as mixed-step marginal time in _segment
                L = len(r.prompt)
                inst.prefill_backlog += L
                inst.prefill_backlog_ctxsum += L * (L / 2.0)
            else:
                inst.overhead += self.fwd.prefill_time(len(r.prompt))
        if self._tl is not None:
            # queue/migrate/recovery wait ends here; the slot residence
            # opens as "prefill" for a fresh prompt (the backlog is
            # consumed inside its first segment), "decode" on a resume
            self._tl_close(r, now,
                           "prefill" if r.gen_len == 0 else "decode")
            self.tracer.instant("admit", "request", r.req_id,
                                tick=self._tl_tick, t=now,
                                instance=inst.iid)
        if r.t_first_scheduled is None:
            r.t_first_scheduled = now
        r.state = ReqState.RUNNING
        r.instance_id = inst.iid
        inst.running[r.req_id] = SimSeq(
            req=r, true_len=min(true_len[r.req_id], r.max_new_tokens),
            ctx=float(ctx0), chunk_left=chunk)
        return migrated

    def _preempt(self, inst: SimInstance) -> None:
        """Evict youngest requests until ~12% KV head-room is restored."""
        victims = sorted(inst.running.values(), key=lambda s: s.ctx)
        for s in victims:
            if inst.kv_free() >= 0.12 * inst.kv_capacity:
                break
            del inst.running[s.req.req_id]
            s.chunk_left = max(s.total_left, 1)
            inst.preempted.append(s)
            inst.preemptions += 1
