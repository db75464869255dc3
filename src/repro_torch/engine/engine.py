"""Inference engine: one Seer "inference instance", in PyTorch.

Counterpart of ``repro.engine.engine``: ``prefill_mode`` "batched" (the
device-resident hot path) or "sync" (the host-accept oracle),
``spec_mode`` "linear" or "tree",
``migration_mode`` "batched" or "perslot".  The engine behaviour is the
JAX package's, decision for decision — the same mixed
prefill/decode/verify batches, the same bucketing of gamma, T and export
extents, the same tree layout, the same admission, release, takeover and
crash rules — so step shapes, step counts and sampled tokens match the
reference.

What changes with PyTorch:

* **In-place cache.**  JAX donates the cache to each jitted step; here
  ``forward`` writes K/V rows and slot positions into the cache tensors
  in place and the fused step rolls back rejected drafts with an
  in-place ``masked_fill_``.  Exports gather into fresh tensors
  (``index_select``), never views of the cache the next step overwrites.
* **One host sync per step.**  ``dispatch_step`` uploads the host batch
  with a single non-blocking copy from pinned memory, enqueues the
  forward, sampling and acceptance, and enqueues one non-blocking copy of
  the packed (sampled, logprobs, n_accepted) block into pinned host
  memory.  ``commit_step`` waits for that copy — the step's one host
  sync, counted in ``StepFunctions.host_syncs``.  The sync oracle reads
  the full sampled and logprob blocks instead (two syncs per step).
* **Tree speculation.**  Draft trees are laid out after the anchor in
  distinct cache slots; every layer attends under one allowed-mask
  through the tree-verify kernel (K2); acceptance of the longest path
  and the compaction of the winning branch into canonical slots run on
  the device, where JAX's dropped scatters land in the scratch slot.
* **Recurrent state (SSM and hybrid archs).**  A Mamba2 block's state
  advanced through rejected drafts cannot be invalidated by ``slot_pos``:
  as in the JAX package, the step replays the accepted prefix from the
  pre-step state in a second, masked forward.  JAX decides on the device
  (``lax.cond(any(acc_mask != mask))``); here a Python ``if`` on that
  flag would be a second host sync, so the host decides from what it
  knows at dispatch — a replay can only be needed when some row carries
  drafts — and such steps replay unconditionally.  A replay whose mask
  equals the first pass's recomputes the same state bit for bit.  The
  first pass writes its recurrent state into fresh buffers
  (``forward(rec_out=)``), so the cache still holds the pre-step state
  for the replay, which writes into the cache: no copy of the state.
* **Device.**  Instances live on ``cuda`` unless built with
  ``device="cpu"``; there attention and the SSD run the kernels' plain
  versions.

* **Tensor parallelism** (``Instance(tp=k)``).  SPMD over
  ``torch.distributed``: every rank of the instance's group
  (``launch.mesh.engine_group``, one per degree) runs the same host code
  — scheduler, pool, drafting, this engine — on its own shard of the
  weights and of the K/V cache (``launch.steps``), under the exact
  column-parallel scheme (``forward(sctx=)``): activations are gathered
  before every row-parallel matmul and the vocab-split logits before
  sampling, so every rank samples the one-device tokens and makes the
  same host decisions.  Each upload of a host batch first compares its
  digest across the group (``sharding.check_lockstep``).  Exports gather
  the KV heads back into the unsharded layout (tp-invariant bytes,
  headers and CRCs); imports take the rank's heads.  There is still one
  host sync per step on each rank.  tp = 1 is a one-rank group, bitwise
  the ``tp=None`` path.  The production Megatron layout (row-parallel
  ``wo`` / ``wd``, sequence sharding, the MoE layer's capacity-bounded
  dispatch) is not ported yet.
"""
from __future__ import annotations

import time
import zlib
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import DeviceLike, dtype_name, resolve_device
from repro_torch.engine.sampling import (draft_acceptance, position_keys,
                                         prng_key, sample_tokens,
                                         token_logprobs_at, tree_acceptance)
from repro_torch.engine.token_tree import TokenTree, bucket_pow2, chain_tree
from repro_torch.launch.steps import (cache_shard, engine_param_shards,
                                      gather_heads)
from repro_torch.models import forward, init_cache
from repro_torch.models.model import modality_inputs
from repro_torch.models.transformer import (build_cross_cache, cross_len,
                                            with_scratch)
from repro_torch.sharding import ShardCtx, batch_digest, check_lockstep

_INT32_MAX = np.iinfo(np.int32).max


# ---------------------------------------------------------------------------
# step functions (shared per config)
# ---------------------------------------------------------------------------


def _sctx_key(sctx: Optional[ShardCtx]):
    """Step-cache key of a sharding context: its degree (engine groups
    are cached per degree, so instances of equal tp share step
    functions)."""
    return None if sctx is None else sctx.tp_size


class StepFunctions:
    """Per-config holder of the engine's device functions.

    Every returned step callable counts its calls in ``invocations`` and
    ``invocations_by_kind`` ("fused:T", "tree:T", and on the sync oracle
    "step:T", "tree_ref:T", "prefill:T"); ``host_syncs`` counts blocking
    device->host reads of step results; ``replays`` counts the
    recurrent-state replays inside fused steps (a second forward each);
    ``migration_calls`` counts the batched KV export/import calls (and
    per-leaf ops of the per-slot paths).  Each getter takes the
    instance's sharding context (None: one device) and keys its cache on
    the degree."""

    def __init__(self, cfg: ModelConfig):
        self.cfg = cfg
        self._step_cache: dict = {}
        self.invocations = 0
        self.invocations_by_kind: Dict[str, int] = {}
        self.host_syncs = 0
        self.replays = 0
        self.migration_calls = 0
        self.migration_calls_by_kind: Dict[str, int] = {}

    def count_migration(self, kind: str, n: int = 1) -> None:
        self.migration_calls += n
        self.migration_calls_by_kind[kind] = \
            self.migration_calls_by_kind.get(kind, 0) + n

    def _counted(self, fn, kind: str):
        def wrapper(*args):
            self.invocations += 1
            self.invocations_by_kind[kind] = \
                self.invocations_by_kind.get(kind, 0) + 1
            return fn(*args)
        return wrapper

    def fused_step(self, T: int, sctx: Optional[ShardCtx] = None):
        """Device-resident step with on-device accept/commit:

        (params, cache, tokens(B,T), positions, mask, keys, temps,
        sample_rows(B,), anchor(B,), n_drafts(B,), replay) ->
        (sampled(B,T), logprobs(B,T), n_accepted(B,), cache)

        Column ``anchor[i]`` holds the row's pending token, columns
        ``anchor+1 .. anchor+n_drafts`` its drafts.  The cache comes back
        updated in place with every slot past the accepted chain
        invalidated (``slot_pos`` rollback) and, with ``replay`` (a host
        bool: some row carries drafts, on a recurrent cache), the SSM and
        conv state replayed over the accepted prefix only; prefill rows
        keep their full mask, so the replay recomputes their state."""
        key = ("fused", T, _sctx_key(sctx))
        if key in self._step_cache:
            return self._step_cache[key]
        cfg = self.cfg

        @torch.no_grad()
        def fn(params, cache, tokens, positions, mask, keys, temps,
               sample_rows, anchor, n_drafts, replay=False):
            logits, cache, _ = forward(cfg, params, tokens, positions, cache,
                                       token_mask=mask,
                                       rec_out=_fresh_rec(cache, replay),
                                       sctx=sctx)
            logits = logits.float()
            sampled = sample_tokens(logits, keys, temps, sample_rows)
            lp = token_logprobs_at(logits, sampled)
            n_acc = draft_acceptance(sampled, tokens, anchor, n_drafts)
            if "slot_pos" in cache:
                anchor_pos = positions.gather(1, anchor.long()[:, None])[:, 0]
                committed_end = torch.where(
                    sample_rows, anchor_pos + n_acc + 1, _INT32_MAX)
                sp = cache["slot_pos"]
                sp.masked_fill_(sp >= committed_end[:, None], -1)
            if replay:
                cols = torch.arange(T, device=tokens.device)[None, :]
                acc_mask = mask & (~sample_rows[:, None]
                                   | (cols <= (anchor + n_acc)[:, None]))
                forward(cfg, params, tokens, positions, cache,
                        token_mask=acc_mask, logits=False, sctx=sctx)
                self.replays += 1
            return sampled, lp, n_acc, cache

        counted = self._counted(fn, f"fused:{T}")
        self._step_cache[key] = counted
        return counted

    def fused_tree_step(self, T: int, sctx: Optional[ShardCtx] = None):
        """Device-resident *tree*-verify step:

        (params, cache, tokens(B,T), positions, slot_index(B,T), mask,
        within(B,T,T), keys, temps, sample_rows(B,), anchor(B,),
        parent(B,T), depth(B,T)) ->
        (sampled(B,T), logprobs(B,T), n_accepted(B,), cache)

        Column ``anchor[i]`` holds the row's pending token; tree nodes
        follow in topological order, each written to cache slot
        ``slot_index`` and attending its ancestors only (``within``).  On
        the device: longest accepted path (:func:`tree_acceptance`),
        compaction of the winning branch into the canonical
        position-indexed slots, and a path-major relayout of the outputs,
        so the host commits columns ``0..n_accepted`` as on the linear
        path.  A trailing ``replay`` (host bool) replays the recurrent
        state over the anchor and the accepted path, as
        :meth:`fused_step` does; recurrent caches verify single-path
        trees only (``Instance._build_tree_batch`` refuses the others)."""
        key = ("tree", T, _sctx_key(sctx))
        if key in self._step_cache:
            return self._step_cache[key]
        cfg = self.cfg
        ring = cfg.sliding_window > 0

        @torch.no_grad()
        def fn(params, cache, tokens, positions, slot_index, mask, within,
               keys, temps, sample_rows, anchor, parent, depth,
               replay=False):
            logits, cache, _ = forward(cfg, params, tokens, positions, cache,
                                       token_mask=mask,
                                       slot_index=slot_index,
                                       within_mask=within,
                                       rec_out=_fresh_rec(cache, replay),
                                       sctx=sctx)
            logits = logits.float()
            sampled = sample_tokens(logits, keys, temps, sample_rows)
            lp = token_logprobs_at(logits, sampled)
            n_acc, path_col, acc = tree_acceptance(
                sampled, tokens, parent, depth, within, mask, anchor)
            n_acc = torch.where(sample_rows, n_acc, 0)
            pc = path_col.long()
            dcols = torch.arange(T, dtype=torch.int32,
                                 device=tokens.device)[None, :]
            if "slot_pos" in cache:
                S = cache["slot_pos"].shape[1]
                anchor_pos = positions.gather(1, anchor.long()[:, None])
                node_slots = torch.where((depth > 0) & mask, slot_index, S)
                dvalid = (dcols >= 1) & (dcols <= n_acc[:, None]) \
                    & sample_rows[:, None]
                src = torch.where(dvalid, slot_index.gather(1, pc), S)
                dst_pos = anchor_pos + dcols
                dst = torch.where(dvalid, dst_pos % S if ring else dst_pos,
                                  S)
                compact_tree(cache, node_slots, src, dst, dst_pos)
            if replay:
                keep = mask & (~sample_rows[:, None]
                               | (dcols <= anchor[:, None]) | acc)
                forward(cfg, params, tokens, positions, cache,
                        token_mask=keep, slot_index=slot_index,
                        within_mask=within, logits=False, sctx=sctx)
                self.replays += 1
            return sampled.gather(1, pc), lp.gather(1, pc), n_acc, cache

        counted = self._counted(fn, f"tree:{T}")
        self._step_cache[key] = counted
        return counted

    def step(self, T: int, sctx: Optional[ShardCtx] = None):
        """Reference step of the sync oracle (acceptance on the host):
        (params, cache, tokens(B,T), positions, mask, keys, temps,
        sample_rows(B,)) -> (sampled(B,T), logprobs(B,T), cache)."""
        return self._plain_step("step", T, sctx)

    def tree_step(self, T: int, sctx: Optional[ShardCtx] = None):
        """Reference *tree* step: :meth:`fused_tree_step`'s forward and
        sampling, with acceptance and the winning-branch compaction left
        to the host (``_run_step_sync_tree``): :meth:`step`'s arguments
        plus slot_index(B,T) and within(B,T,T)."""
        return self._plain_step("tree_ref", T, sctx)

    def _plain_step(self, kind: str, T: int, sctx: Optional[ShardCtx]):
        key = (kind, T, _sctx_key(sctx))
        if key in self._step_cache:
            return self._step_cache[key]
        cfg = self.cfg

        @torch.no_grad()
        def fn(params, cache, tokens, positions, mask, keys, temps,
               sample_rows, slot_index=None, within=None):
            logits, cache, _ = forward(cfg, params, tokens, positions, cache,
                                       token_mask=mask,
                                       slot_index=slot_index,
                                       within_mask=within, sctx=sctx)
            logits = logits.float()
            sampled = sample_tokens(logits, keys, temps, sample_rows)
            return sampled, token_logprobs_at(logits, sampled), cache

        counted = self._counted(fn, f"{kind}:{T}")
        self._step_cache[key] = counted
        return counted

    def prefill(self, T: int, sctx: Optional[ShardCtx] = None):
        """Admit-time prefill of the sync oracle: (params, cache,
        tokens(B,T), positions, mask) -> cache."""
        key = ("prefill", T, _sctx_key(sctx))
        if key in self._step_cache:
            return self._step_cache[key]
        cfg = self.cfg

        @torch.no_grad()
        def fn(params, cache, tokens, positions, mask):
            return forward(cfg, params, tokens, positions, cache,
                           token_mask=mask, sctx=sctx)[1]

        counted = self._counted(fn, f"prefill:{T}")
        self._step_cache[key] = counted
        return counted

    @staticmethod
    @torch.no_grad()
    def rollback(slot_pos: torch.Tensor, from_pos: torch.Tensor) -> None:
        """Invalidate, in place, every slot holding a position >=
        ``from_pos`` of its row."""
        slot_pos.masked_fill_(slot_pos >= from_pos[:, None], -1)

    def export_batch(self, lives: Tuple[int, ...],
                     sctx: Optional[ShardCtx] = None):
        """Multi-slot KV gather: ``(cache, slots(n,)) -> [blob leaf dict]
        * n``.  Each cache leaf is read by one gather (limited to the
        widest live extent) however many slots migrate; blob ``i``'s
        position-indexed leaves are then trimmed to ``lives[i]``.  The
        outputs are fresh tensors, never views of the cache.  Under
        ``sctx`` the KV heads of every rank are gathered, so the blobs
        hold the unsharded layout."""
        max_live = max(lives)
        cfg = self.cfg

        @torch.no_grad()
        def fn(cache, slots):
            gathered = {}
            for k, v in cache.items():
                pax = _pos_axis(k)
                if pax is not None:
                    v = v.narrow(pax + 1, 0, min(max_live, v.shape[pax + 1]))
                sax = _slot_slice(k)
                gathered[k] = gather_heads(
                    cfg, k, v.index_select(sax, slots).movedim(sax, 0), sctx)
            out = []
            for i, live in enumerate(lives):
                leaves = {}
                for k, g in gathered.items():
                    row = g[i]
                    ax = _pos_axis(k)
                    if ax is not None:
                        row = row.narrow(ax, 0, min(live, row.shape[ax]))
                    leaves[k] = row
                out.append(leaves)
            return out

        return fn

    @staticmethod
    @torch.no_grad()
    def import_batch(cache: dict, slots: torch.Tensor,
                     blobs: List[dict]) -> dict:
        """Multi-slot KV scatter, in place: blobs are stacked, padded back
        to the cache's position extent (``slot_pos`` with -1, K/V with
        zeros) and written with one indexed copy per leaf."""
        for k, dst in cache.items():
            src = torch.stack([b[k] for b in blobs])
            pax = _pos_axis(k)
            if pax is not None:
                pad = dst.shape[pax + 1] - src.shape[pax + 1]
                if pad > 0:
                    shape = list(src.shape)
                    shape[pax + 1] = pad
                    fill = torch.full(shape, -1 if k == "slot_pos" else 0,
                                      dtype=src.dtype, device=src.device)
                    src = torch.cat([src, fill], dim=pax + 1)
            sax = _slot_slice(k)
            idx = [slice(None)] * dst.dim()
            idx[sax] = slots
            dst[tuple(idx)] = src.movedim(0, sax).to(dst.dtype)
        return cache


def _fresh_rec(cache: dict, replay: bool) -> Optional[dict]:
    """Fresh buffers for the first pass's recurrent state when the step
    replays (the cache keeps the pre-step state for the replay)."""
    if not replay:
        return None
    return {k: torch.empty_like(cache[k]) for k in ("conv", "ssm")}


@torch.no_grad()
def compact_tree(cache: dict, node_slots: torch.Tensor, src: torch.Tensor,
                 dst: torch.Tensor, dst_pos: torch.Tensor) -> None:
    """Commit the winning branch of a tree step in place, in the JAX
    package's order: (a) every tree-node slot of the step (``node_slots``)
    gets ``slot_pos = -1``; (b) ``slot_pos = dst_pos`` at ``dst``; (c) the
    K/V rows at ``src`` are gathered into a fresh tensor, then written at
    ``dst`` (``dst <= src``: the two overlap).  All (B,T); an entry equal
    to S (the cache length) or past it is a dropped write and lands in
    the scratch slot."""
    S = cache["slot_pos"].shape[1]
    sp = with_scratch(cache["slot_pos"], 1)
    bidx = torch.arange(sp.shape[0], device=sp.device)[:, None]
    dst = torch.where(dst < S, dst, S).long()
    # a tensor, not the scalar -1: indexed assignment of a Python scalar
    # copies it to the device, a host sync
    sp[bidx, node_slots.long().clamp(max=S)] = torch.full(
        node_slots.shape, -1, dtype=sp.dtype, device=sp.device)
    sp[bidx, dst] = dst_pos.to(sp.dtype)
    src = src.long().clamp(0, S - 1)
    for name in ("k", "v"):
        kv = with_scratch(cache[name], 2)             # (L, B, S+1, H, D)
        rows = kv[:, bidx, src]                       # a copy, not a view
        kv[:, bidx, dst] = rows


# ---------------------------------------------------------------------------
# per-request engine state
# ---------------------------------------------------------------------------


@dataclass
class EngineSeq:
    req_id: str
    group_id: str
    prompt: List[int]
    seed: int
    temperature: float = 1.0
    max_new_tokens: int = 256
    stop_token: Optional[int] = None
    # mutable generation state
    generated: List[int] = field(default_factory=list)
    logprobs: List[float] = field(default_factory=list)
    last_token: int = -1          # pending token (fed on next step)
    next_pos: int = 0             # position of the pending token
    finished: bool = False
    # queued prefill work: tokens not yet written to the KV cache, and the
    # absolute position of the first of them
    prefill_queue: List[int] = field(default_factory=list)
    prefill_pos: int = 0
    # prefix-revalidation queue (truncate-mode weight refresh, replay
    # recovery): old tokens replayed as verify drafts
    reval_queue: List[int] = field(default_factory=list)

    @property
    def prefilling(self) -> bool:
        return bool(self.prefill_queue)

    @property
    def total_len(self) -> int:
        return len(self.prompt) + len(self.generated)

    def finish_reason(self) -> str:
        if self.stop_token is not None and self.generated and \
                self.generated[-1] == self.stop_token:
            return "stop"
        return "length"


def _dtype_str(dtype) -> str:
    return dtype_name(dtype) if isinstance(dtype, torch.dtype) else str(dtype)


@dataclass
class KVBlob:
    """Exported per-request cache state (what the global pool stores).

    Position-indexed leaves (k/v/slot_pos) are trimmed to the live
    prefix; ``nbytes`` counts the live prefix ``[0, next_pos)`` only.
    ``checksum`` is a CRC32 over the blob *header* (req_id, next_pos,
    nbytes and every leaf's name/shape/dtype, dtypes printed with numpy's
    names), so a blob's CRC is the same in the JAX package and the port;
    a content checksum would cost a device->host sync per blob."""
    req_id: str
    arrays: dict                  # cache leaves sliced at the slot
    next_pos: int
    nbytes: int
    checksum: Optional[int] = None

    def header_crc(self) -> int:
        parts = [self.req_id, str(self.next_pos), str(self.nbytes)]
        for name in sorted(self.arrays):
            leaf = self.arrays[name]
            parts.append(f"{name}:{tuple(leaf.shape)}:"
                         f"{_dtype_str(leaf.dtype)}")
        return zlib.crc32("|".join(parts).encode()) & 0xFFFFFFFF

    def stamp_checksum(self) -> "KVBlob":
        """Idempotent: (re)stamps ``checksum`` from the current header."""
        self.checksum = self.header_crc()
        return self

    def verify_checksum(self) -> None:
        """Raise :class:`BlobCorruptionError` on a stamp/header mismatch
        (unstamped blobs pass)."""
        if self.checksum is not None and self.checksum != self.header_crc():
            raise BlobCorruptionError(
                f"KV blob for {self.req_id!r} failed checksum validation "
                f"(stored 0x{self.checksum:08x} != computed "
                f"0x{self.header_crc():08x}); refusing to import at "
                f"possibly-garbage positions")


class BlobCorruptionError(RuntimeError):
    """A pooled KV blob's checksum no longer matches its header."""


def _slot_slice(key: str) -> int:
    """Cache leaves carry the slot (batch) dim at 0 or 1."""
    return 0 if key == "slot_pos" else 1


def _pos_axis(key: str) -> Optional[int]:
    """Axis of the cache-position dim in a per-slot blob leaf, or None
    for leaves without one (recurrent state, cross-attention memory):
    those ride a blob whole."""
    return {"k": 1, "v": 1, "slot_pos": 0}.get(key)


def _live_nbytes(leaves: dict, next_pos: int) -> int:
    """Bytes of a blob counting only the live prefix ``[0, next_pos)``."""
    total = 0
    for k, v in leaves.items():
        n = v.numel()
        ax = _pos_axis(k)
        if ax is not None and v.shape[ax]:
            n = n // v.shape[ax] * min(next_pos, v.shape[ax])
        total += n * v.element_size()
    return total


@dataclass
class StepTicket:
    """In-flight device step.  ``block`` is the packed (sampled,
    logprobs, n_accepted) result, in pinned host memory on the card
    (filled by a non-blocking copy that ``ready`` marks) or a CPU
    tensor; reading it is the step's one host sync."""
    block: torch.Tensor
    ready: Optional[torch.cuda.Event]
    B: int
    T: int
    sample_slots: List[int]           # decode rows + tail-fused rows
    anchors: Dict[int, int]           # slot -> column of its pending token


@dataclass
class _SyncTicket:
    """Already-committed result of the sync reference path."""
    out: Dict[int, Tuple[List[int], List[float], int]]


@dataclass
class _TreeBatch:
    """One built tree-verify step batch (host arrays), shared by the fused
    device path and the sync reference path, so the two verify the
    identical batch."""
    T: int
    fused: List[int]
    anchors: Dict[int, int]
    trees: Dict[int, TokenTree]
    n_tree_nodes: int
    tokens: np.ndarray
    positions: np.ndarray
    slot_index: np.ndarray
    mask: np.ndarray
    within: np.ndarray
    temps: np.ndarray
    seeds: np.ndarray
    sample_rows: np.ndarray
    anchor: np.ndarray
    parent: np.ndarray
    depth: np.ndarray


# ---------------------------------------------------------------------------
# instance
# ---------------------------------------------------------------------------


class Instance:
    """One inference instance (a model replica with its own KV buffer).

    A VLM or audio instance builds its cross-attention memory at
    construction (``build_cross_cache``, the audio encoder included) from
    ``modality_embeds`` (max_slots, Tm, d_model) — slot i's image
    embeddings or audio frames — or, when none are given, from the zero
    stub (``models.model.modality_inputs``), as the JAX package does.
    A slot keeps its memory across requests; a KV blob carries the
    slot's memory whole, and an import writes it into the new slot.

    ``tp=k`` shards the instance over the k ranks of
    ``launch.mesh.engine_group(k)`` (this process is one of them; fewer
    ranks raise).  ``params`` may be the whole tree or this rank's shard
    (``init_params`` / ``bridge.params_from_jax`` with the group's
    context); assigning ``params`` later shards the same way."""

    def __init__(self, cfg: ModelConfig, params, steps: StepFunctions, *,
                 tp: Optional[int] = None,
                 max_slots: int = 8, cache_len: int = 4096,
                 prefill_chunk: int = 64, gamma_max: int = 8,
                 prefill_mode: str = "batched",
                 prefill_budget: Optional[int] = None,
                 migration_mode: Optional[str] = None,
                 spec_mode: str = "linear",
                 cost_model=None, prefill_latency_factor: float = 2.0,
                 instance_id: str = "inst0", node: str = "n0",
                 admit_into_draining: Optional[bool] = None,
                 base_seed: int = 0,
                 modality_embeds: Optional[torch.Tensor] = None,
                 device: DeviceLike = None):
        if prefill_mode not in ("batched", "sync"):
            raise ValueError(f"prefill_mode={prefill_mode!r}")
        if spec_mode not in ("linear", "tree"):
            raise ValueError(f"spec_mode={spec_mode!r}")
        if migration_mode is None:
            # the sync reference path keeps the per-slot moves
            migration_mode = "perslot" if prefill_mode == "sync" \
                else "batched"
        if migration_mode not in ("batched", "perslot"):
            raise ValueError(f"migration_mode={migration_mode!r}")
        self.cfg = cfg
        self.device = resolve_device(device)
        if params["embed"].device != self.device:
            raise ValueError(f"params on {params['embed'].device}, instance "
                             f"on {self.device}")
        # tp=None: one device, no context end to end; tp>=1: this rank's
        # view of the degree's group (tp=1 a one-rank group)
        self.tp = tp
        self._sctx: Optional[ShardCtx] = None
        if tp is not None:
            from repro_torch.launch.mesh import engine_group
            self._sctx = engine_group(tp)
        self.params = params
        self.steps = steps
        self.max_slots = max_slots
        self.cache_len = cache_len
        self.prefill_chunk = prefill_chunk
        self.gamma_max = gamma_max
        self.prefill_mode = prefill_mode
        self.migration_mode = migration_mode
        self.spec_mode = spec_mode
        self.prefill_budget = prefill_budget
        self.cost_model = cost_model
        self.prefill_latency_factor = prefill_latency_factor
        self.instance_id = instance_id
        self.node = node
        # optional flight recorder (repro_torch.obs.Tracer), set by
        # run_stream; its hooks read only host ints the engine holds
        self.tracer = None
        # admit-into-draining: a draining slot counts as admittable one
        # tick early; the new seq's import/clear is deferred until the
        # next dispatch snapshots (exports) the draining rows first.  The
        # sync and per-slot paths write the slot at admit, before a
        # draining slot's rows could be snapshotted, so they never do it
        batched = migration_mode == "batched" and prefill_mode == "batched"
        if admit_into_draining is None:
            admit_into_draining = batched
        elif admit_into_draining and not batched:
            raise ValueError(
                "admit_into_draining requires prefill_mode='batched' "
                "and migration_mode='batched'")
        self.admit_into_draining = admit_into_draining
        self.base_key = prng_key(base_seed)
        self.cache = init_cache(cfg, max_slots, cache_len, device=self.device,
                                sctx=self._sctx)
        if "cross_k" in self.cache:
            if modality_embeds is None:
                (modality_embeds,) = modality_inputs(
                    cfg, max_slots, device=self.device).values()
            want = (max_slots, cross_len(cfg), cfg.d_model)
            if tuple(modality_embeds.shape) != want:
                raise ValueError(f"modality_embeds of shape "
                                 f"{tuple(modality_embeds.shape)}; want "
                                 f"{want}")
            self.cache["cross_k"], self.cache["cross_v"] = build_cross_cache(
                cfg, self.params, modality_embeds.to(self.device), self._sctx)
        self.slots: List[Optional[EngineSeq]] = [None] * max_slots
        self._inflight: Optional[StepTicket] = None
        self.alive = True
        self._draining: Dict[int, EngineSeq] = {}
        self._pending_imports: List[Tuple[int, KVBlob]] = []
        self._takeovers: Dict[int, EngineSeq] = {}
        self._pending_clears: List[int] = []
        self._export_buffer: Dict[str, KVBlob] = {}
        # stats
        self.crashes = 0
        self.tokens_generated = 0
        self.steps_run = 0
        self.prefill_tokens = 0
        self.admits = 0
        self.admit_seconds = 0.0
        self.slots_exported = 0
        self.slots_imported = 0
        self.takeover_admits = 0
        self.export_overlapped_slots = 0
        self.migration_bytes_out = 0
        self.migration_bytes_in = 0
        self.migration_host_seconds = 0.0
        self.row_slots_total = 0
        self.row_slots_active = 0
        self.prefill_rows_packed = 0
        self.tail_fused_rows = 0
        # tree speculation: steps that verified >= 1 tree node, nodes
        # verified, and nodes of branching (non-chain) trees
        self.tree_steps = 0
        self.tree_nodes = 0
        self.tree_branch_nodes = 0
        # tensor parallelism: host uploads whose digests the group
        # compared, and a running CRC of every one of them
        self.lockstep_checks = 0
        self.lockstep_digest = 0

    @property
    def params(self) -> dict:
        return self._params

    @params.setter
    def params(self, params: dict) -> None:
        """The weights (whole, or this rank's shard), kept as this rank's
        shard."""
        self._params = engine_param_shards(self.cfg, params, self._sctx)

    # -- host <-> device -----------------------------------------------------

    def _upload(self, arr: np.ndarray) -> torch.Tensor:
        """Host array -> device tensor without a host sync: staged in
        pinned memory and copied non-blocking on the current stream.
        Under tp > 1 the group first compares the array's digest (a host
        collective): every rank must upload the same host batch."""
        if self._sctx is not None and self._sctx.tp_size > 1:
            digest = batch_digest(arr)
            check_lockstep(self._sctx, digest)
            self.lockstep_checks += 1
            self.lockstep_digest = zlib.crc32(
                digest.to_bytes(4, "little"), self.lockstep_digest)
        t = torch.from_numpy(np.ascontiguousarray(arr))
        if self.device.type == "cpu":
            return t
        return t.pin_memory().to(self.device, non_blocking=True)

    def _index(self, slots: List[int]) -> torch.Tensor:
        return self._upload(np.asarray(slots, np.int64))

    def _upload_int32(self, *arrays: np.ndarray) -> List[torch.Tensor]:
        """Several int32-sized host arrays -> device tensors of their
        shapes, in one upload (float32 and bool arrays travel as int32
        bits and 0/1; the caller views / casts them back)."""
        flat = [np.ascontiguousarray(a).view(np.int32) if a.dtype ==
                np.float32 else np.asarray(a, np.int32) for a in arrays]
        packed = self._upload(np.concatenate([a.ravel() for a in flat]))
        parts = torch.tensor_split(
            packed, np.cumsum([a.size for a in flat])[:-1].tolist())
        return [p.view(a.shape) for p, a in zip(parts, flat)]

    def _result_block(self, sampled, lps, n_acc):
        """Enqueue the copy of a step's (sampled, logprobs, n_accepted)
        block to the host: (block, event to wait on, None on the CPU)."""
        block = torch.cat([sampled.reshape(-1),
                           lps.reshape(-1).view(torch.int32), n_acc])
        if self.device.type != "cuda":
            return block, None
        host = torch.empty(block.shape, dtype=block.dtype, pin_memory=True)
        host.copy_(block, non_blocking=True)
        ready = torch.cuda.Event()
        ready.record()
        return host, ready

    # -- capacity ------------------------------------------------------------

    def free_slots(self) -> int:
        if not self.alive:
            return 0
        free = sum(s is None for s in self.slots)
        if self.admit_into_draining:
            free += sum(1 for i in self._draining
                        if i not in self._takeovers)
        return free

    def pending_takeovers(self) -> List[int]:
        return sorted(self._takeovers)

    def active_slots(self) -> List[int]:
        return [i for i, s in enumerate(self.slots)
                if s is not None and i not in self._draining]

    def draining_slots(self) -> List[int]:
        return sorted(self._draining)

    def decode_slots(self) -> List[int]:
        return [i for i, s in enumerate(self.slots)
                if s is not None and not s.prefilling
                and i not in self._draining]

    def prefilling_slots(self) -> List[int]:
        return [i for i, s in enumerate(self.slots)
                if s is not None and s.prefilling
                and i not in self._draining]

    def queued_prefill_tokens(self) -> int:
        return sum(len(s.prefill_queue)
                   for s in self.slots if s is not None)

    def kv_used_tokens(self) -> int:
        return sum(min(s.next_pos, self.cache_len)
                   for s in self.slots if s is not None)

    def kv_capacity_tokens(self) -> int:
        return self.max_slots * self.cache_len

    def kv_headroom(self) -> float:
        return 1.0 - self.kv_used_tokens() / max(self.kv_capacity_tokens(), 1)

    # -- admission / release --------------------------------------------------

    def admit(self, seq: EngineSeq, blob: Optional[KVBlob] = None) -> int:
        """Place ``seq`` in a free (or draining) slot.  Only *queues* the
        prefill work or the blob import; legal with a step in flight
        (every cache write is deferred to the next dispatch)."""
        if self._inflight is not None and self.prefill_mode != "batched":
            # the sync path writes the cache inside admit
            raise RuntimeError("admit() while a step ticket is in flight")
        if not self.alive:
            raise RuntimeError("admit() on a crashed instance")
        if blob is not None and blob.next_pos == seq.next_pos:
            blob.verify_checksum()
        t0 = time.perf_counter()
        takeover = False
        free = [i for i, s in enumerate(self.slots) if s is None]
        if free:
            slot = free[0]
        else:
            cands = [i for i in self.draining_slots()
                     if i not in self._takeovers]
            if not (self.admit_into_draining and cands):
                raise ValueError("no admittable slot")
            slot, takeover = cands[0], True
            self._takeovers[slot] = seq
            self.takeover_admits += 1
        self.slots[slot] = seq
        if takeover:
            self._pending_clears.append(slot)
        else:
            self._clear_slot_cache(slot)
        seq.prefill_queue = []
        seq.prefill_pos = 0
        if blob is not None and blob.next_pos == seq.next_pos:
            self._check_blob_fits(blob)
            self.slots_imported += 1
            self.migration_bytes_in += blob.nbytes
            if self.migration_mode == "batched" \
                    and self.prefill_mode == "batched":
                self._pending_imports.append((slot, blob))
            else:
                tm = time.perf_counter()
                self._import_kv(slot, blob)
                self.migration_host_seconds += time.perf_counter() - tm
        elif seq.next_pos > 0:
            # no blob (pool miss): re-prefill everything up to next_pos
            tokens = (seq.prompt + seq.generated)[:seq.next_pos]
            self._queue_prefill(slot, seq, tokens, start_pos=0)
        else:
            tokens = seq.prompt[:-1]
            seq.last_token = seq.prompt[-1]
            seq.next_pos = len(seq.prompt) - 1
            self._queue_prefill(slot, seq, tokens, start_pos=0)
        if takeover and self._inflight is not None:
            # snapshot the draining rows now, behind the in-flight step
            self._export_buffer.update(self._gather_exports({slot}))
        if self.prefill_mode == "sync" and self.device.type == "cuda":
            # the timer should cover the chunk forwards, not their launch
            torch.cuda.synchronize(self.device)
        self.admits += 1
        self.admit_seconds += time.perf_counter() - t0
        return slot

    def release(self, slot: int, export: bool = True) -> Optional[KVBlob]:
        """Immediate release: export (per-slot gather) and free the slot."""
        if self._inflight is not None:
            raise RuntimeError("release() while a step ticket is in flight")
        if slot in self._draining:
            raise RuntimeError(f"slot {slot} is already draining")
        self._flush_imports(exclude=set(self._takeovers)
                            | set(self._pending_clears))
        seq = self.slots[slot]
        self._check_exportable(slot, seq, export)
        blob = None
        if export and seq:
            t0 = time.perf_counter()
            blob = self._export_kv(slot, seq)
            self.slots_exported += 1
            self.migration_bytes_out += blob.nbytes
            self.migration_host_seconds += time.perf_counter() - t0
        self.slots[slot] = None
        return blob

    def release_async(self, slot: int) -> None:
        """Mark a slot draining; its export waits for the next
        :meth:`flush_exports`."""
        if self._inflight is not None:
            raise RuntimeError(
                "release_async() while a step ticket is in flight")
        if self.migration_mode != "batched":
            raise RuntimeError("release_async() requires "
                               "migration_mode='batched'; use release()")
        seq = self.slots[slot]
        if seq is None or slot in self._draining:
            raise RuntimeError(f"slot {slot} holds no releasable seq")
        self._check_exportable(slot, seq, export=True)
        self._draining[slot] = seq

    def flush_exports(self) -> Dict[str, KVBlob]:
        """Materialise every draining slot's blob (one batched gather)
        and free the slots; also returns blobs a dispatch snapshotted
        early for a takeover."""
        out = dict(self._export_buffer)
        self._export_buffer.clear()
        out.update(self._gather_exports())
        return out

    def cancel_pending_imports(self) -> List[int]:
        """Drop every queued blob import (weight refresh)."""
        slots = [s for s, _ in self._pending_imports]
        self._pending_imports.clear()
        return slots

    def crash(self) -> List[EngineSeq]:
        """Lose the worker; returns the seqs that were live here."""
        victims: List[EngineSeq] = []
        seen = set()
        for s in list(self.slots) + list(self._draining.values()):
            if s is not None and id(s) not in seen:
                seen.add(id(s))
                victims.append(s)
        self.alive = False
        self.crashes += 1
        self._inflight = None
        self.slots = [None] * self.max_slots
        self._draining.clear()
        self._takeovers.clear()
        self._pending_imports.clear()
        self._pending_clears.clear()
        self._export_buffer.clear()
        return victims

    @property
    def step_in_flight(self) -> bool:
        return self._inflight is not None

    def _gather_exports(self, only: Optional[set] = None
                        ) -> Dict[str, KVBlob]:
        """Gather draining slots (all, or just ``only``) in one call."""
        slots = [i for i in self.draining_slots()
                 if only is None or i in only]
        if not slots:
            return {}
        t0 = time.perf_counter()
        if self._inflight is None:
            self._flush_imports(exclude=set(self._takeovers)
                                | set(self._pending_clears))
        seqs = [self._draining[i] for i in slots]
        overlapped = self._inflight is not None
        out: Dict[str, KVBlob] = {}
        extents = [v.shape[_pos_axis(k) + 1] for k, v in self.cache.items()
                   if _pos_axis(k) is not None]
        max_ext = max(extents) if extents else 0
        lives = []
        for s in seqs:
            live = min(s.next_pos, max_ext)
            b = max(self.prefill_chunk, 1)
            while b < live:
                b <<= 1
            lives.append(min(b, max_ext) if max_ext else 0)
        order = sorted(range(len(slots)), key=lambda j: (lives[j], slots[j]))
        slots = [slots[j] for j in order]
        seqs = [seqs[j] for j in order]
        fn = self.steps.export_batch(tuple(lives[j] for j in order),
                                     self._sctx)
        leaf_dicts = fn(self.cache, self._index(slots))
        self.steps.count_migration(f"export:{len(slots)}")
        for seq, leaves in zip(seqs, leaf_dicts):
            out[seq.req_id] = KVBlob(seq.req_id, leaves, seq.next_pos,
                                     _live_nbytes(leaves, seq.next_pos))
        for i in slots:
            if i not in self._takeovers:
                self.slots[i] = None
            self._draining.pop(i, None)
            self._takeovers.pop(i, None)
        n = len(slots)
        self.slots_exported += n
        self.export_overlapped_slots += n if overlapped else 0
        self.migration_bytes_out += sum(b.nbytes for b in out.values())
        self.migration_host_seconds += time.perf_counter() - t0
        return out

    def _check_exportable(self, slot: int, seq: Optional[EngineSeq],
                          export: bool) -> None:
        if export and seq is not None and seq.prefilling:
            raise RuntimeError(
                f"slot {slot} ({seq.req_id}) still has queued prefill; "
                "cannot export its KV blob")

    def _check_blob_fits(self, blob: KVBlob) -> None:
        """A blob whose position extent exceeds the target cache would
        lose live positions on import — refuse it."""
        for k, src in blob.arrays.items():
            pax = _pos_axis(k)
            if pax is None or k not in self.cache:
                continue
            tgt = self.cache[k].shape[pax + 1]
            if src.shape[pax] > tgt:
                raise ValueError(
                    f"KV blob {blob.req_id!r}: leaf {k!r} covers "
                    f"{src.shape[pax]} positions but the target cache "
                    f"holds {tgt}; importing would drop live positions "
                    "— re-prefill instead of importing this blob")

    # -- KV migration ---------------------------------------------------------

    def _export_kv(self, slot: int, seq: EngineSeq) -> KVBlob:
        """Copy the slot's cache state, trimmed to the live prefix."""
        arrays = {}
        nbytes = 0
        for k, v in self.cache.items():
            sl = v.select(_slot_slice(k), slot)
            self.steps.count_migration("export_perslot")
            ax = _pos_axis(k)
            if ax is not None:
                sl = sl.narrow(ax, 0, min(seq.next_pos, sl.shape[ax]))
                self.steps.count_migration("export_perslot")
            whole = gather_heads(self.cfg, k, sl, self._sctx)
            arrays[k] = whole.clone() if whole is sl else whole
            nbytes += whole.numel() * whole.element_size()
        return KVBlob(seq.req_id, arrays, seq.next_pos, nbytes)

    def _import_kv(self, slot: int, blob: KVBlob) -> None:
        """Per-slot import: each leaf padded back to the cache's position
        extent (``slot_pos`` with -1, K/V with zeros) and copied into the
        slot."""
        blob.verify_checksum()
        self._check_blob_fits(blob)
        for k, dst in self.cache.items():
            ax = _slot_slice(k)
            src = self._local(k, blob.arrays[k])
            row = dst.select(ax, slot)
            pax = _pos_axis(k)
            if pax is not None and src.shape[pax] != row.shape[pax]:
                shape = list(src.shape)
                shape[pax] = row.shape[pax] - src.shape[pax]
                fill = torch.full(shape, -1 if k == "slot_pos" else 0,
                                  dtype=src.dtype, device=src.device)
                src = torch.cat([src, fill], dim=pax)
                self.steps.count_migration("import_perslot")
            row.copy_(src)
            self.steps.count_migration("import_perslot")

    def _flush_imports(self, exclude: Optional[set] = None) -> None:
        """Scatter every pending admitted blob into the cache: one batched
        call per distinct source extent.  Imports for slots in
        ``exclude`` stay pending."""
        if not self._pending_imports:
            return
        t0 = time.perf_counter()
        pending, self._pending_imports = self._pending_imports, []
        if exclude:
            held = [(s, b) for s, b in pending if s in exclude]
            pending = [(s, b) for s, b in pending if s not in exclude]
            self._pending_imports.extend(held)
            if not pending:
                return
        by_extent: Dict[tuple, List[Tuple[int, KVBlob]]] = {}
        for slot, blob in pending:
            ext = tuple(sorted(
                (k, v.shape[_pos_axis(k)]) for k, v in blob.arrays.items()
                if _pos_axis(k) is not None))
            by_extent.setdefault(ext, []).append((slot, blob))
        for group in by_extent.values():
            blobs = [{k: self._local(k, v) for k, v in b.arrays.items()}
                     for _, b in group]
            self.steps.import_batch(self.cache,
                                    self._index([s for s, _ in group]),
                                    blobs)
            self.steps.count_migration(f"import:{len(group)}")
        self.migration_host_seconds += time.perf_counter() - t0

    def _local(self, name: str, leaf: torch.Tensor) -> torch.Tensor:
        """A blob leaf (the unsharded layout) as this rank's cache holds
        it, on the instance's device."""
        return cache_shard(self.cfg, name, leaf, self._sctx).to(self.device)

    def _clear_slot_cache(self, slot: int) -> None:
        """Empty a slot in place, on the device: ``slot_pos`` -1, the
        recurrent state and conv window 0 (each through a view, never an
        indexed assignment of a Python scalar, which syncs the host).
        The cross-attention memory stays, as in the JAX package."""
        if "slot_pos" in self.cache:
            self.cache["slot_pos"][slot].fill_(-1)
        for k in ("ssm", "conv"):
            if k in self.cache:
                self.cache[k][:, slot].zero_()

    # -- prefill --------------------------------------------------------------

    def _queue_prefill(self, slot: int, seq: EngineSeq, tokens: List[int],
                       start_pos: int) -> None:
        if not tokens:
            return
        if self.prefill_mode == "sync":
            self._prefill_slot(slot, tokens, start_pos)
        else:
            seq.prefill_queue = list(tokens)
            seq.prefill_pos = start_pos

    def _prefill_slot(self, slot: int, tokens: List[int], start_pos: int):
        """Sync oracle: one single-row forward per chunk, at admit."""
        B, c = self.max_slots, self.prefill_chunk
        fn = self.steps.prefill(c, self._sctx)
        for off in range(0, len(tokens), c):
            chunk = tokens[off:off + c]
            buf = np.zeros((B, c), np.int32)
            pos = np.zeros((B, c), np.int32)
            mask = np.zeros((B, c), np.int32)
            buf[slot, :len(chunk)] = chunk
            pos[slot, :len(chunk)] = start_pos + off + np.arange(len(chunk))
            mask[slot, :len(chunk)] = 1
            tok_d, pos_d, mask_d = self._upload_int32(buf, pos, mask)
            fn(self.params, self.cache, tok_d, pos_d, mask_d.bool())
            self.prefill_tokens += len(chunk)
            self.row_slots_total += B
            self.row_slots_active += 1
            self.prefill_rows_packed += 1

    # -- the mixed prefill / decode / verify step -----------------------------

    def _resolve_prefill_budget(self) -> int:
        """Per-step prefill token budget: explicit int, or adaptive from
        the cost model (largest chunk multiple whose modeled mixed-step
        latency stays within ``prefill_latency_factor`` x the decode-only
        step), or one chunk per slot."""
        if self.prefill_budget is not None:
            return self.prefill_budget
        cap_tokens = self.max_slots * self.prefill_chunk
        cm = self.cost_model
        decode = self.decode_slots() if cm is not None else []
        if cm is None or not decode:
            return cap_tokens
        B = len(decode)
        mean_ctx = sum(min(self.slots[i].next_pos, self.cache_len)
                       for i in decode) / B
        cap = self.prefill_latency_factor * cm.step_time(B, 1, mean_ctx)
        budget = self.prefill_chunk
        while budget + self.prefill_chunk <= cap_tokens:
            nxt = budget + self.prefill_chunk
            if cm.mixed_step_time(B, 1, nxt, mean_ctx) > cap:
                break
            budget = nxt
        return budget

    def _prefill_plan(self) -> Dict[int, int]:
        """slot -> queued prefill tokens to pack this step: decode-starved
        groups first, then shortest remaining prefill."""
        plan: Dict[int, int] = {}
        budget = max(self._resolve_prefill_budget(), 1)
        decode_groups = {self.slots[i].group_id
                         for i in self.decode_slots()}
        order = sorted(
            self.prefilling_slots(),
            key=lambda i: (self.slots[i].group_id in decode_groups,
                           len(self.slots[i].prefill_queue), i))
        for i in order:
            if budget <= 0:
                break
            n = min(len(self.slots[i].prefill_queue), self.prefill_chunk,
                    budget)
            if n > 0:
                plan[i] = n
                budget -= n
        return plan

    def run_step(self, drafts: Optional[Dict[int, List[int]]] = None
                 ) -> Dict[int, Tuple[List[int], List[float], int]]:
        """One engine iteration over all active slots: dispatch + commit."""
        return self.commit_step(self.dispatch_step(drafts))

    def dispatch_step(self, drafts: Optional[Dict[int, object]] = None):
        """Enqueue one engine step on the device without a host sync and
        return its ticket (None if there is nothing to do).

        Each row of the (max_slots, T) batch is a decode/verify row
        (pending token + drafts) or the next prefill chunk of a
        prefilling slot; a tail chunk that fits T with a column to spare
        also carries the pending token and samples its first decode
        token in the same forward.  Under ``spec_mode="tree"`` drafts may
        be :class:`TokenTree` values; under ``prefill_mode="sync"`` the
        step runs (and commits) at once on the oracle path."""
        if self._inflight is not None:
            raise RuntimeError("dispatch_step() with a ticket in flight")
        if not self.alive:
            raise RuntimeError("dispatch_step() on a crashed instance")
        drafts = drafts or {}
        if self.prefill_mode == "sync":
            return _SyncTicket(self._run_step_sync(drafts))
        if self._takeovers:
            self._export_buffer.update(
                self._gather_exports(set(self._takeovers)))
        for slot in self._pending_clears:
            self._clear_slot_cache(slot)
        self._pending_clears.clear()
        self._flush_imports()
        if not self.active_slots():
            return None
        decode = self.decode_slots()
        plan = self._prefill_plan()
        if not decode and not plan:
            return None
        if self.tracer is not None:
            self.tracer.instant(
                "step_dispatch", "instance", self.instance_id,
                decode_rows=len(decode), prefill_rows=len(plan),
                prefill_tokens=sum(plan.values()))
        if self.spec_mode == "tree":
            return self._dispatch_tree(decode, plan, drafts)
        gamma = max((len(drafts.get(i, [])) for i in decode), default=0)
        gamma = min(gamma, self.gamma_max)
        # bucket gamma to bound the number of step shapes
        for b in (0, 1, 2, 4, 8, 16, 32):
            if gamma <= b:
                gamma = b
                break
        T = gamma + 1
        if plan:
            need = max(plan.values())
            b = 1
            while b < need:
                b <<= 1
            T = max(T, min(b, self.prefill_chunk))
        B = self.max_slots
        fused = [i for i, n in plan.items()
                 if n == len(self.slots[i].prefill_queue) and n + 1 <= T]

        tokens = np.zeros((B, T), np.int32)
        positions = np.zeros((B, T), np.int32)
        mask = np.zeros((B, T), np.int32)
        temps = np.zeros((B,), np.float32)
        seeds = np.zeros((B,), np.int32)
        sample_rows = np.zeros((B,), np.int32)
        anchor = np.zeros((B,), np.int32)
        n_drafts = np.zeros((B,), np.int32)
        anchors: Dict[int, int] = {}
        for i in decode:
            seq = self.slots[i]
            d = list(drafts.get(i, []))[:gamma]
            n_drafts[i] = len(d)
            row = [seq.last_token] + d
            tokens[i, :len(row)] = row
            positions[i, :len(row)] = seq.next_pos + np.arange(len(row))
            mask[i, :len(row)] = 1
            temps[i] = seq.temperature
            seeds[i] = seq.seed
            sample_rows[i] = 1
            anchors[i] = 0
        for i, n in plan.items():
            seq = self.slots[i]
            tokens[i, :n] = seq.prefill_queue[:n]
            positions[i, :n] = seq.prefill_pos + np.arange(n)
            mask[i, :n] = 1
            if i in fused:
                tokens[i, n] = seq.last_token
                positions[i, n] = seq.next_pos
                mask[i, n] = 1
                temps[i] = seq.temperature
                seeds[i] = seq.seed
                sample_rows[i] = 1
                anchor[i] = n
                anchors[i] = n

        # one upload of the whole host batch
        tok_d, pos_d, mask_d, seeds_d, rows_d, anchor_d, nd_d, temps_d = \
            self._upload_int32(tokens, positions, mask, seeds, sample_rows,
                               anchor, n_drafts, temps)
        keys = position_keys(self.base_key, seeds_d, pos_d)
        fn = self.steps.fused_step(T, self._sctx)
        replay = "ssm" in self.cache and bool(n_drafts.any())
        sampled, lps, n_acc, self.cache = fn(
            self.params, self.cache, tok_d, pos_d, mask_d.bool(), keys,
            temps_d.view(torch.float32), rows_d.bool(), anchor_d, nd_d,
            replay)
        return self._book_step(B, T, sampled, lps, n_acc, decode, plan,
                               fused, anchors)

    def _book_step(self, B, T, sampled, lps, n_acc, decode, plan, fused,
                   anchors) -> StepTicket:
        """Book a dispatched step (host counters, consumed prefill) and
        return its ticket, whose result block is on its way to the host."""
        block, ready = self._result_block(sampled, lps, n_acc)
        self.row_slots_total += B
        self.row_slots_active += len(decode) + len(plan)
        self.prefill_rows_packed += len(plan)
        self.tail_fused_rows += len(fused)
        self._consume_plan(plan)
        self.steps_run += 1
        ticket = StepTicket(block=block, ready=ready, B=B, T=T,
                            sample_slots=decode + fused, anchors=anchors)
        self._inflight = ticket
        return ticket

    def _consume_plan(self, plan: Dict[int, int]) -> None:
        """Host bookkeeping of the prefill chunks a step wrote."""
        for i, n in plan.items():
            seq = self.slots[i]
            del seq.prefill_queue[:n]
            seq.prefill_pos += n
            self.prefill_tokens += n

    # -- tree speculation -----------------------------------------------------

    def _dispatch_tree(self, decode: List[int], plan: Dict[int, int],
                       drafts) -> StepTicket:
        """Build and launch one fused tree step.  Drafts may be
        :class:`TokenTree` values or token lists (single-path trees,
        bit-identical to the linear path)."""
        bt = self._build_tree_batch(decode, plan, drafts)
        B, T = self.max_slots, bt.T
        (tok_d, pos_d, slot_d, mask_d, within_d, seeds_d, rows_d, anchor_d,
         parent_d, depth_d, temps_d) = self._upload_int32(
            bt.tokens, bt.positions, bt.slot_index, bt.mask, bt.within,
            bt.seeds, bt.sample_rows, bt.anchor, bt.parent, bt.depth,
            bt.temps)
        keys = position_keys(self.base_key, seeds_d, pos_d)
        fn = self.steps.fused_tree_step(T, self._sctx)
        replay = "ssm" in self.cache and bt.n_tree_nodes > 0
        sampled, lps, n_acc, self.cache = fn(
            self.params, self.cache, tok_d, pos_d, slot_d, mask_d.bool(),
            within_d.bool(), keys, temps_d.view(torch.float32),
            rows_d.bool(), anchor_d, parent_d, depth_d, replay)
        self.tree_steps += 1 if bt.n_tree_nodes else 0
        return self._book_step(B, T, sampled, lps, n_acc, decode, plan,
                               bt.fused, bt.anchors)

    def _build_tree_batch(self, decode: List[int], plan: Dict[int, int],
                          drafts) -> _TreeBatch:
        """Tree-step batch layout, shared by the fused and the sync path.
        Column 0 of a decode row holds its pending token; node ``j`` of its
        tree (topological order) sits at column ``1+j``, cache slot
        ``next_pos+1+j`` and position ``next_pos+depth[j]``: siblings share
        a position (and a sampling key) but not a slot.  Trees are cut to
        ``min(gamma_max, cache_len-2-next_pos)`` nodes; T follows the
        linear ladder, ``bucket_pow2(widest, 32) + 1``."""
        trees: Dict[int, TokenTree] = {}
        widest = 0
        for i in decode:
            d = drafts.get(i)
            t = d if isinstance(d, TokenTree) else chain_tree(d or [])
            cap = min(self.gamma_max,
                      max(0, self.cache_len - 2 - self.slots[i].next_pos))
            if len(t) > cap:
                # topological order: a node-count prefix is a valid tree
                t = TokenTree(tokens=t.tokens[:cap],
                              parent=t.parent[:cap], depth=t.depth[:cap],
                              paths=[p[:cap] for p in t.paths if p[:cap]])
            trees[i] = t
            widest = max(widest, len(t))
        if "ssm" in self.cache and \
                any(not t.is_chain() for t in trees.values()):
            raise ValueError(
                "branching draft trees require an attention-only arch; "
                "SSM/hybrid instances verify single-path trees only")
        T = bucket_pow2(widest, 32) + 1
        if plan:
            T = max(T, bucket_pow2(max(plan.values()), self.prefill_chunk))
        B = self.max_slots
        fused = [i for i, n in plan.items()
                 if n == len(self.slots[i].prefill_queue) and n + 1 <= T]
        S = self.cache["slot_pos"].shape[1] if "slot_pos" in self.cache \
            else self.cache_len
        ring = self.cfg.sliding_window > 0

        def to_slot(p):
            return p % S if ring else p

        tokens = np.zeros((B, T), np.int32)
        positions = np.zeros((B, T), np.int32)
        slot_index = np.zeros((B, T), np.int32)
        mask = np.zeros((B, T), bool)
        within = np.zeros((B, T, T), bool)
        temps = np.zeros((B,), np.float32)
        seeds = np.zeros((B,), np.int32)
        sample_rows = np.zeros((B,), bool)
        anchor = np.zeros((B,), np.int32)
        parent = np.full((B, T), -1, np.int32)
        depth = np.zeros((B, T), np.int32)
        anchors: Dict[int, int] = {}
        n_tree_nodes = 0
        for i in decode:
            seq = self.slots[i]
            t = trees[i]
            tokens[i, 0] = seq.last_token
            positions[i, 0] = seq.next_pos
            slot_index[i, 0] = to_slot(seq.next_pos)
            mask[i, 0] = True
            within[i, 0, 0] = True
            anc = t.ancestors_or_self()
            for j, tok in enumerate(t.tokens):
                c = 1 + j
                tokens[i, c] = tok
                positions[i, c] = seq.next_pos + t.depth[j]
                slot_index[i, c] = to_slot(seq.next_pos + 1 + j)
                mask[i, c] = True
                parent[i, c] = 0 if t.parent[j] < 0 else 1 + t.parent[j]
                depth[i, c] = t.depth[j]
                within[i, c, 0] = True
                for a in anc[j]:
                    within[i, c, 1 + a] = True
            temps[i] = seq.temperature
            seeds[i] = seq.seed
            sample_rows[i] = True
            anchors[i] = 0
            n_tree_nodes += len(t)
            self.tree_nodes += len(t)
            if len(t) and not t.is_chain():
                self.tree_branch_nodes += len(t)
        for i, n in plan.items():
            seq = self.slots[i]
            tokens[i, :n] = seq.prefill_queue[:n]
            pos = seq.prefill_pos + np.arange(n)
            positions[i, :n] = pos
            slot_index[i, :n] = to_slot(pos)
            mask[i, :n] = True
            k = n
            if i in fused:
                tokens[i, n] = seq.last_token
                positions[i, n] = seq.next_pos
                slot_index[i, n] = to_slot(seq.next_pos)
                mask[i, n] = True
                temps[i] = seq.temperature
                seeds[i] = seq.seed
                sample_rows[i] = True
                anchor[i] = n
                anchors[i] = 0      # outputs are path-major: offset 0
                k = n + 1
            # prefill chunks are chains by position: plain causal order
            within[i, :k, :k] = np.tril(np.ones((k, k), bool))
        return _TreeBatch(
            T=T, fused=fused, anchors=anchors, trees=trees,
            n_tree_nodes=n_tree_nodes, tokens=tokens, positions=positions,
            slot_index=slot_index, mask=mask, within=within, temps=temps,
            seeds=seeds, sample_rows=sample_rows, anchor=anchor,
            parent=parent, depth=depth)

    def commit_step(self, ticket) -> Dict[int, Tuple[List[int],
                                                     List[float], int]]:
        """Fold a dispatched step's results into host state, after the
        step's one host sync (waiting for the result block's copy)."""
        if ticket is None:
            return {}
        if isinstance(ticket, _SyncTicket):
            return ticket.out
        if ticket is not self._inflight:
            raise RuntimeError("commit_step(): ticket is not the "
                               "instance's in-flight step")
        self._inflight = None
        if ticket.ready is not None:
            ticket.ready.synchronize()
        arr = ticket.block.numpy()
        self.steps.host_syncs += 1
        if self.tracer is not None:
            # stamped right after the step's one host sync; the tracer
            # reads only host ints
            self.tracer.instant(
                "step_commit", "instance", self.instance_id,
                rows=len(ticket.sample_slots))
        BT = ticket.B * ticket.T
        sampled = arr[:BT].reshape(ticket.B, ticket.T)
        lps = arr[BT:2 * BT].view(np.float32).reshape(ticket.B, ticket.T)
        n_acc = arr[2 * BT:]
        out = {}
        for i in ticket.sample_slots:
            seq = self.slots[i]
            a = int(n_acc[i])
            off = ticket.anchors[i]
            new_toks = [int(sampled[i, off + j]) for j in range(a + 1)]
            new_lps = [float(lps[i, off + j]) for j in range(a + 1)]
            out[i] = self._commit_row(seq, new_toks, new_lps, a)
        return out

    def _commit_row(self, seq: EngineSeq, new_toks: List[int],
                    new_lps: List[float], a: int):
        """Host bookkeeping for one sample row's step result."""
        room = seq.max_new_tokens - len(seq.generated)
        cut = new_toks[:room]
        if seq.stop_token is not None and seq.stop_token in cut:
            cut = cut[:cut.index(seq.stop_token) + 1]
        new_toks, new_lps = cut, new_lps[:len(cut)]
        seq.generated.extend(new_toks)
        seq.logprobs.extend(new_lps)
        self.tokens_generated += len(new_toks)
        committed_hi = seq.next_pos + a
        seq.last_token = new_toks[-1] if new_toks else seq.last_token
        seq.next_pos = committed_hi + 1
        if seq.stop_token is not None and new_toks and \
                new_toks[-1] == seq.stop_token:
            seq.finished = True
        if len(seq.generated) >= seq.max_new_tokens:
            seq.finished = True
        if seq.next_pos >= self.cache_len - 1 and not self.cfg.sliding_window \
                and self.cfg.arch_type not in ("ssm",):
            seq.finished = True   # cache exhausted (engine-tier guard)
        return (new_toks, new_lps, a)

    # -- sync reference path (losslessness oracle) ----------------------------

    def _run_step_sync(self, drafts) -> Dict[int, Tuple[List[int],
                                                        List[float], int]]:
        """Oracle step: acceptance on the host over the full sample block,
        rollback from the host.  Chain-only tree drafts are flattened to
        token lists (node ``j`` sits at column/position/slot ``1+j``
        either way); a step carrying a branching tree goes to
        :meth:`_run_step_sync_tree`."""
        if self.spec_mode == "tree" or \
                any(isinstance(d, TokenTree) for d in drafts.values()):
            flat: Dict[int, List[int]] = {}
            for i, d in drafts.items():
                if isinstance(d, TokenTree):
                    if not d.is_chain():
                        return self._run_step_sync_tree(drafts)
                    flat[i] = list(d.tokens)
                else:
                    flat[i] = list(d or [])
            drafts = flat
        if not self.active_slots():
            return {}
        decode = self.decode_slots()
        plan = self._prefill_plan()
        if not decode and not plan:
            return {}
        gamma = max((len(drafts.get(i, [])) for i in decode), default=0)
        gamma = min(gamma, self.gamma_max)
        for b in (0, 1, 2, 4, 8, 16, 32):
            if gamma <= b:
                gamma = b
                break
        T = gamma + 1
        if plan:
            need = max(plan.values())
            b = 1
            while b < need:
                b <<= 1
            T = max(T, min(b, self.prefill_chunk))
        B = self.max_slots

        tokens = np.zeros((B, T), np.int32)
        positions = np.zeros((B, T), np.int32)
        mask = np.zeros((B, T), np.int32)
        temps = np.zeros((B,), np.float32)
        seeds = np.zeros((B,), np.int32)
        sample_rows = np.zeros((B,), np.int32)
        ndraft = {}
        for i in decode:
            seq = self.slots[i]
            d = list(drafts.get(i, []))[:gamma]
            ndraft[i] = len(d)
            row = [seq.last_token] + d
            tokens[i, :len(row)] = row
            positions[i, :len(row)] = seq.next_pos + np.arange(len(row))
            mask[i, :len(row)] = 1
            temps[i] = seq.temperature
            seeds[i] = seq.seed
            sample_rows[i] = 1
        for i, n in plan.items():
            seq = self.slots[i]
            tokens[i, :n] = seq.prefill_queue[:n]
            positions[i, :n] = seq.prefill_pos + np.arange(n)
            mask[i, :n] = 1

        tok_d, pos_d, mask_d, seeds_d, rows_d, temps_d = self._upload_int32(
            tokens, positions, mask, seeds, sample_rows, temps)
        keys = position_keys(self.base_key, seeds_d, pos_d)
        fn = self.steps.step(T, self._sctx)
        # the forward updates the recurrent state in place: keep a copy of
        # the pre-step state for the host-side replay
        pre_rec = {k: self.cache[k].clone() for k in ("ssm", "conv")} \
            if ("ssm" in self.cache and gamma > 0) else None
        sampled_d, lps_d, self.cache = fn(
            self.params, self.cache, tok_d, pos_d, mask_d.bool(), keys,
            temps_d.view(torch.float32), rows_d.bool())
        sampled = sampled_d.cpu().numpy()
        lps = lps_d.cpu().numpy()
        self.steps.host_syncs += 2   # full sample + logprob blocks
        self.row_slots_total += B
        self.row_slots_active += len(decode) + len(plan)
        self.prefill_rows_packed += len(plan)
        self._consume_plan(plan)

        out = {}
        rollback_from = np.full((B,), _INT32_MAX, np.int32)
        for i in decode:
            seq = self.slots[i]
            d = list(drafts.get(i, []))[:ndraft[i]]
            # acceptance: longest prefix of drafts matching sampled chain
            a = 0
            while a < len(d) and d[a] == int(sampled[i, a]):
                a += 1
            new_toks = [int(sampled[i, j]) for j in range(a + 1)]
            new_lps = [float(lps[i, j]) for j in range(a + 1)]
            rollback_from[i] = seq.next_pos + a + 1
            out[i] = self._commit_row(seq, new_toks, new_lps, a)
        if "slot_pos" in self.cache and gamma > 0:
            self.steps.rollback(self.cache["slot_pos"],
                                self._upload(rollback_from))
        if pre_rec is not None:
            # states advanced through rejected drafts: restore the pre-step
            # state and replay only the accepted prefix (prefill rows keep
            # their full mask and recompute their state identically)
            accepted = mask.astype(bool)
            for i in decode:
                accepted[i, :] = False
                accepted[i, :rollback_from[i] - positions[i, 0]] = True
            if not np.array_equal(accepted, mask.astype(bool)):
                for k, t in pre_rec.items():
                    self.cache[k].copy_(t)
                acc_d, = self._upload_int32(accepted)
                _, _, self.cache = fn(
                    self.params, self.cache, tok_d, pos_d, acc_d.bool(),
                    keys, temps_d.view(torch.float32), rows_d.bool())
        self.steps_run += 1
        return out

    def _run_step_sync_tree(self, drafts
                            ) -> Dict[int, Tuple[List[int], List[float],
                                                 int]]:
        """Oracle *tree* step: :meth:`StepFunctions.tree_step`'s forward,
        then acceptance in numpy (the closed form of
        :func:`tree_acceptance`) and the winning-branch compaction from
        host-computed indices.  It verifies the batch the fused path would
        (:meth:`_build_tree_batch`), so the two can be held equal."""
        if not self.active_slots():
            return {}
        decode = self.decode_slots()
        plan = self._prefill_plan()
        if not decode and not plan:
            return {}
        bt = self._build_tree_batch(decode, plan, drafts)
        B, T = self.max_slots, bt.T
        (tok_d, pos_d, slot_d, mask_d, within_d, seeds_d, rows_d,
         temps_d) = self._upload_int32(
            bt.tokens, bt.positions, bt.slot_index, bt.mask, bt.within,
            bt.seeds, bt.sample_rows, bt.temps)
        keys = position_keys(self.base_key, seeds_d, pos_d)
        fn = self.steps.tree_step(T, self._sctx)
        sampled_d, lps_d, self.cache = fn(
            self.params, self.cache, tok_d, pos_d, mask_d.bool(), keys,
            temps_d.view(torch.float32), rows_d.bool(), slot_d,
            within_d.bool())
        sampled = sampled_d.cpu().numpy()
        lps = lps_d.cpu().numpy()
        self.steps.host_syncs += 2   # full sample + logprob blocks
        self.row_slots_total += B
        self.row_slots_active += len(decode) + len(plan)
        self.prefill_rows_packed += len(plan)
        self.tail_fused_rows += len(bt.fused)
        self.tree_steps += 1 if bt.n_tree_nodes else 0
        self._consume_plan(plan)

        # longest accepted path: a node is accepted iff every ancestor
        # edge token matches its parent's sample
        node = (bt.depth > 0) & bt.mask
        par = np.clip(bt.parent, 0, T - 1)
        edge_ok = np.where(
            bt.parent >= 0,
            bt.tokens == np.take_along_axis(sampled, par, axis=1), True)
        acc = node & np.all(edge_ok[:, None, :] | ~bt.within, axis=2)
        n_acc = np.max(np.where(acc, bt.depth, 0), axis=1).astype(np.int32)
        n_acc = np.where(bt.sample_rows, n_acc, 0)
        dd = np.arange(T, dtype=np.int32)[None, :]
        hit = acc[:, None, :] & (bt.depth[:, None, :] == dd[:, :, None]) \
            & (dd[:, :, None] > 0)
        path_col = np.where(np.any(hit, axis=2), np.argmax(hit, axis=2),
                            bt.anchor[:, None]).astype(np.int32)
        anchor_pos = np.take_along_axis(
            bt.positions, bt.anchor[:, None], axis=1)

        out = {}
        for i in decode + bt.fused:
            seq = self.slots[i]
            a = int(n_acc[i])
            new_toks = [int(sampled[i, path_col[i, j]])
                        for j in range(a + 1)]
            new_lps = [float(lps[i, path_col[i, j]])
                       for j in range(a + 1)]
            out[i] = self._commit_row(seq, new_toks, new_lps, a)

        if bt.n_tree_nodes:
            S = self.cache["slot_pos"].shape[1]
            ring = self.cfg.sliding_window > 0
            node_slots = np.where(node, bt.slot_index, S)
            dcols = np.arange(T, dtype=np.int32)[None, :]
            dvalid = (dcols >= 1) & (dcols <= n_acc[:, None]) \
                & bt.sample_rows[:, None]
            src = np.where(
                dvalid, np.take_along_axis(bt.slot_index, path_col, axis=1),
                S)
            dst_pos = anchor_pos + dcols
            dst = np.where(dvalid, dst_pos % S if ring else dst_pos, S)
            compact_tree(self.cache, *self._upload_int32(
                node_slots, src, dst, dst_pos))
        self.steps_run += 1
        return out
