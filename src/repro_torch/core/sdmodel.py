"""Speculative-decoding throughput model (paper §3.4.1).

    T_SD(B, γ) = (1 - α) · (D(B, γ) + T(B, γ)) / (1 - α^{γ+1})

is the expected time to generate one token per request, where D is the
draft cost, T the target-model forward over γ+1 tokens/request at batch B,
and α the mean acceptance rate.  SD wins when T_SD < T(B, 1).

``ForwardCostModel`` is the "offline-profiled" T(B, γ) of the paper: a
roofline-style analytic model with a compute term (FLOPs/peak, grows with
B·(γ+1)) and a memory term (weight+KV bytes/bw, nearly flat in γ) — the
max of the two plus a fixed launch overhead.  The same model (with H800 or
TPU v5e constants) drives both the MBA policy and the cluster simulator,
so scheduling decisions and simulated timings are consistent.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional, Sequence

from repro_torch.configs.base import ModelConfig


@dataclass(frozen=True)
class HardwareSpec:
    name: str
    peak_flops: float            # per chip, bf16
    hbm_bw: float                # bytes/s per chip
    link_bw: float               # bytes/s per ICI/NVLink link
    launch_overhead: float = 3e-4  # fixed per-forward overhead (s)
    # blocking device->host readback between steps (host-side accept /
    # commit).  The fused device-resident step avoids it: acceptance,
    # bonus select and rollback run inside the jitted step and the host
    # reads one tiny async block instead.
    host_sync_overhead: float = 2e-4


H800 = HardwareSpec("h800", peak_flops=989e12 / 2, hbm_bw=3.35e12,
                    link_bw=200e9)
TPU_V5E = HardwareSpec("tpu_v5e", peak_flops=197e12, hbm_bw=819e9,
                       link_bw=50e9)


@dataclass(frozen=True)
class ForwardCostModel:
    """Analytic T(B, T_tokens) for one decode/verify forward of a model
    sharded over ``chips`` chips (TP/EP within an instance).

    ``tp`` is the engine's per-instance tensor-parallel degree (the
    column-parallel head/ff sharding of launch.mesh.engine_mesh): it
    multiplies the effective chip count for the compute and HBM terms
    and adds a collective term on the ICI — an all-gather of the
    head-sharded attention output and ff-sharded MLP hidden before each
    row matmul, plus the expert all-to-all (dispatch + combine) on MoE
    layers.  ``chips`` stays the legacy coarse knob; callers set one or
    the other (the rollout passes tp)."""
    cfg: ModelConfig
    hw: HardwareSpec
    chips: int = 1
    tp: int = 1
    mfu: float = 0.5             # achievable fraction of peak compute
    mbu: float = 0.7             # achievable fraction of HBM bandwidth

    def __post_init__(self):
        if self.tp < 1 or self.chips < 1:
            raise ValueError(
                f"tp/chips must be >= 1, got tp={self.tp} "
                f"chips={self.chips}")

    @property
    def _n_chips(self) -> int:
        return self.chips * self.tp

    # -- component byte/flop counts ---------------------------------------------

    def param_bytes(self) -> int:
        return self.cfg.num_params() * 2      # bf16 weights

    def active_param_bytes(self) -> int:
        return self.cfg.active_params() * 2

    def kv_bytes_per_token(self) -> int:
        cfg = self.cfg
        if cfg.arch_type == "ssm":
            return 0
        n_attn = cfg.num_layers
        if cfg.arch_type == "hybrid":
            n_attn = cfg.num_layers // max(cfg.hybrid_attn_every, 1)
        return 2 * n_attn * cfg.num_kv_heads * cfg.head_dim * 2  # k+v, bf16

    def flops_per_token(self) -> float:
        return 2.0 * self.cfg.active_params()

    # -- tp collectives ----------------------------------------------------------

    def _n_attn_layers(self) -> int:
        cfg = self.cfg
        if cfg.arch_type == "ssm":
            return 0
        if cfg.arch_type == "hybrid":
            return cfg.num_layers // max(cfg.hybrid_attn_every, 1)
        return cfg.num_layers

    def _n_moe_layers(self) -> int:
        cfg = self.cfg
        if not cfg.num_experts:
            return 0
        return (cfg.num_layers - cfg.first_dense_layers
                + cfg.moe_every - 1) // max(cfg.moe_every, 1)

    def collective_bytes(self, n_tok: int) -> dict:
        """Interconnect bytes one forward of ``n_tok`` tokens moves at
        this tp degree, per chip (ring collectives move (tp-1)/tp of the
        logical tensor past each chip).

        ``all_gather``: the head-sharded attention output and the
        ff-sharded MLP hidden, gathered before their row matmuls (the
        engine's token-exact column-parallel scheme gathers instead of
        psum-reducing).  ``all_to_all``: MoE token dispatch + combine —
        top_k * d_model each way per token on every MoE layer."""
        tp = self.tp
        if tp <= 1 or n_tok <= 0:
            return {"all_gather": 0, "all_to_all": 0}
        cfg = self.cfg
        frac = (tp - 1) / tp
        elt = 2                                       # bf16
        n_attn = self._n_attn_layers()
        n_moe = self._n_moe_layers()
        n_mlp = 0
        if cfg.arch_type in ("dense", "vlm", "audio"):
            n_mlp = cfg.num_layers
        elif cfg.arch_type == "hybrid":
            n_mlp = n_attn                            # shared block's MLP
        elif cfg.arch_type == "moe":
            n_mlp = cfg.num_layers - n_moe            # first dense layers
        ag = n_attn * cfg.num_heads * cfg.head_dim    # o before wo
        ag += n_mlp * cfg.d_ff                        # h before wd
        if n_moe and cfg.num_shared_experts:
            ag += n_moe * cfg.d_ff                    # shared-expert hidden
        a2a = 2 * n_moe * cfg.moe_top_k * cfg.d_model  # dispatch + combine
        return {"all_gather": int(n_tok * ag * elt * frac),
                "all_to_all": int(n_tok * a2a * elt * frac)}

    def collective_time(self, n_tok: int) -> float:
        b = self.collective_bytes(n_tok)
        return (b["all_gather"] + b["all_to_all"]) / self.hw.link_bw

    # -- forward time --------------------------------------------------------------

    def _attn_dim(self) -> float:
        return self.cfg.num_heads * self.cfg.head_dim * 2 \
            if self.cfg.arch_type != "ssm" else self.cfg.d_inner

    def forward_time(self, batch: int, tokens_per_req: int,
                     mean_ctx: float) -> float:
        """One forward scoring ``batch * tokens_per_req`` tokens with mean
        KV context length ``mean_ctx``."""
        n_tok = batch * tokens_per_req
        # compute term: linear in scored tokens + attention term
        flops = n_tok * self.flops_per_token()
        flops += 2.0 * n_tok * mean_ctx * self._attn_dim()
        t_compute = flops / (self._n_chips * self.hw.peak_flops * self.mfu)
        # memory term: weights stream once per forward; KV streams per req
        mem = self.active_param_bytes()
        mem += batch * mean_ctx * self.kv_bytes_per_token()
        t_mem = mem / (self._n_chips * self.hw.hbm_bw * self.mbu)
        return max(t_compute, t_mem) + self.collective_time(n_tok) \
            + self.hw.launch_overhead

    def decode_time(self, batch: int, mean_ctx: float) -> float:
        return self.forward_time(batch, 1, mean_ctx)

    def verify_time(self, batch: int, gamma: int, mean_ctx: float) -> float:
        return self.forward_time(batch, gamma + 1, mean_ctx)

    def tree_verify_time(self, batch: int, n_nodes: int,
                         mean_ctx: float) -> float:
        """One tree-verify forward scoring ``n_nodes`` draft-tree nodes
        (+ the anchor) per request.  A token tree of N nodes costs the
        same forward as a linear chain of N drafts — the whole point of
        tree speculation: at an equal draft-token budget the forward is
        unchanged while the expected accepted length rises (see
        :meth:`SDThroughputModel.expected_tokens_tree`)."""
        return self.forward_time(batch, n_nodes + 1, mean_ctx)

    def step_time(self, batch: int, tokens_per_req: int, mean_ctx: float,
                  *, fused_accept: bool = True) -> float:
        """One engine decode/verify step including accept/commit cost.

        The device-resident fused step (engine hot path) does the draft
        acceptance, bonus-token select and slot rollback inside the jit
        and reads back one tiny async block — no extra term.  The
        host-accept reference path pays a blocking device->host sync per
        step (the engine's sync path additionally replays an SSM/hybrid
        forward on draft rejection; the simulator models attention-cache
        deployments, so that term is not modeled here)."""
        t = self.forward_time(batch, tokens_per_req, mean_ctx)
        if not fused_accept:
            t += self.hw.host_sync_overhead
        return t

    def prefill_time(self, n_tokens: int, mean_ctx: float = 0.0) -> float:
        return self.forward_time(1, n_tokens, mean_ctx or n_tokens / 2)

    def migration_stall(self, n_blobs: int, total_bytes: float, bw: float,
                        *, cross_bytes: float = 0.0,
                        cross_bw: Optional[float] = None,
                        batched: bool = True,
                        overlap_frac: float = 0.0) -> float:
        """Stall seconds charged for moving ``n_blobs`` KV blobs
        (``total_bytes`` total) through the global pool at ``bw``.

        ``cross_bytes`` of the total additionally crossed the inter-node
        fabric and pay a second wire leg at ``cross_bw`` (defaults to
        ``bw``) — mirroring :class:`~repro_torch.core.kvpool.PoolCosts`, where
        a cross-node fetch stacks the network hop on top of the host
        leg.  The batched engine path gathers/scatters every migrating
        slot in one dispatch (one fixed launch overhead per batch, not
        per blob) and enqueues the export behind the next step so
        ``overlap_frac`` of the wire time hides under device compute;
        the per-slot path pays a launch per blob and serializes the
        transfer on the step stream (no overlap)."""
        if n_blobs <= 0 or total_bytes <= 0:
            return 0.0
        launches = self.hw.launch_overhead * \
            (1.0 if batched else float(n_blobs))
        wire = total_bytes / max(bw, 1.0)
        if cross_bytes > 0:
            wire += cross_bytes / max(cross_bw if cross_bw is not None
                                      else bw, 1.0)
        return (1.0 - min(max(overlap_frac, 0.0), 1.0)) * wire + launches

    def mixed_step_time(self, batch: int, tokens_per_req: int,
                        prefill_tokens: float, mean_ctx: float,
                        prefill_ctx: Optional[float] = None) -> float:
        """One fused step: ``batch`` decode/verify rows of
        ``tokens_per_req`` tokens plus ``prefill_tokens`` chunk tokens
        packed into the same forward (the engine's mixed prefill/decode
        step).  Prefill tokens add compute (linear + attention over their
        own growing context, ~prefill_ctx) but share the per-forward
        weight stream and launch overhead — which is exactly why batching
        prefill into decode steps wins over serial chunk forwards."""
        if prefill_tokens <= 0:
            return self.forward_time(batch, tokens_per_req, mean_ctx) \
                if batch else 0.0
        pctx = prefill_ctx if prefill_ctx is not None else prefill_tokens / 2
        n_dec = batch * tokens_per_req
        flops = (n_dec + prefill_tokens) * self.flops_per_token()
        flops += 2.0 * n_dec * mean_ctx * self._attn_dim()
        flops += 2.0 * prefill_tokens * pctx * self._attn_dim()
        t_compute = flops / (self._n_chips * self.hw.peak_flops * self.mfu)
        mem = self.active_param_bytes()
        mem += batch * mean_ctx * self.kv_bytes_per_token()
        mem += prefill_tokens * self.kv_bytes_per_token()   # KV writes
        t_mem = mem / (self._n_chips * self.hw.hbm_bw * self.mbu)
        return max(t_compute, t_mem) \
            + self.collective_time(n_dec + int(prefill_tokens)) \
            + self.hw.launch_overhead


@dataclass(frozen=True)
class SDThroughputModel:
    """T_SD and the optimal draft length γ*(B) (paper §3.4.1)."""
    fwd: ForwardCostModel
    draft_cost_per_token: float = 2e-5   # CST lookup is host-side & cheap
    draft_cost_fixed: float = 1e-4

    def draft_time(self, batch: int, gamma: int) -> float:
        return self.draft_cost_fixed + \
            batch * gamma * self.draft_cost_per_token

    def expected_tokens(self, alpha: float, gamma: int) -> float:
        """E[accepted+bonus] per request per forward = (1-α^{γ+1})/(1-α)."""
        if gamma == 0:
            return 1.0
        a = min(max(alpha, 0.0), 0.999)
        return (1.0 - a ** (gamma + 1)) / (1.0 - a)

    def expected_tokens_tree(self, alpha: float,
                             path_budgets: Sequence[int],
                             branch_beta: Sequence[float]) -> float:
        """E[accepted+bonus] per forward for *tree* verification.

        The trunk (``path_budgets[0]``) contributes the linear
        expectation at its depth; each funded side branch ``r`` adds its
        rescue probability ``branch_beta[r]`` (the chance the sampled
        chain leaves the trunk but follows branch r) times the extra
        tokens that branch salvages beyond the bonus token the linear
        path would have kept anyway.  Upper-bounded by the whole budget
        plus the bonus — a tree can never beat committing every drafted
        node."""
        if not path_budgets:
            return 1.0
        e = self.expected_tokens(alpha, path_budgets[0])
        for r, d in enumerate(path_budgets[1:], start=1):
            w = branch_beta[r] if r < len(branch_beta) else 0.0
            e += w * (self.expected_tokens(alpha, d) - 1.0)
        return min(e, sum(path_budgets) + 1.0)

    def t_sd(self, batch: int, gamma: int, alpha: float,
             mean_ctx: float) -> float:
        """Expected seconds per generated token per request."""
        step = self.draft_time(batch, gamma) + \
            self.fwd.verify_time(batch, gamma, mean_ctx)
        return step / self.expected_tokens(alpha, gamma)

    def optimal_gamma(self, batch: int, alpha: float, mean_ctx: float,
                      gamma_max: int = 16) -> int:
        best_g, best_t = 0, self.t_sd(batch, 0, alpha, mean_ctx)
        for g in range(1, gamma_max + 1):
            t = self.t_sd(batch, g, alpha, mean_ctx)
            if t < best_t:
                best_g, best_t = g, t
        return best_g
