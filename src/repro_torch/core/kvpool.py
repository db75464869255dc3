"""Global KV cache pool — the Mooncake-style substrate for divided rollout.

The paper stores the KV cache of *every* active request in a global,
hierarchical pool (DRAM + SSD, RDMA transfers) so a chunk can resume on any
instance without re-prefill (§3.2).  On a TPU pod the analogue is
host-DRAM offload + ICI/PCIe block transfer (DESIGN.md §2).

The pool is *topology-aware*: every blob lives on a **node** (the host
whose instance exported it) and the store is tiered per node —

* ``dram``   — the home node's host DRAM (capacity-tracked per node),
* ``ssd``    — the home node's NVMe (LRU spill target; optionally
               capacity-tracked),
* ``remote`` — cold storage across the fabric (unbounded; entries spill
               here when a node's SSD budget is exceeded).

Fetches are charged with the modeled bandwidth of the path actually
taken: a same-node fetch rides the fast intra-node device interconnect
(ICI/NVLink), a cross-node fetch pays the home node's host-DMA leg plus
the inter-node network hop (the ICI-vs-PCIe asymmetry RollPacker and
Laminar show dominates migration cost at scale).  ``cross_node_bytes``
in :meth:`GlobalKVPool.stats` is the currency the topology-aware
scheduler minimises.

Eviction is LRU to SSD per node; SSD is assumed large enough for the
iteration unless ``ssd_capacity`` is set (paper: 4 TB NVMe per node).
"""
from __future__ import annotations

import collections
from dataclasses import dataclass, field
from typing import Dict, Iterable, Optional

from repro_torch.engine.engine import KVBlob


@dataclass(frozen=True)
class PoolCosts:
    """Transfer bandwidths (bytes/s) for the modeled hierarchy."""
    dram_bw: float = 25e9        # device<->host DMA on one node (PCIe-ish)
    ssd_bw: float = 5e9          # host<->NVMe
    net_bw: float = 40e9         # inter-node fabric (RDMA / DCN)
    ici_bw: float = 100e9        # intra-node device interconnect (ICI/NVLink)

    def fetch_seconds(self, nbytes: int, tier: str, cross_node: bool) -> float:
        """Modeled seconds to land ``nbytes`` in the fetching node's HBM.

        Same-node fetches ride the intra-node interconnect; cross-node
        fetches pay the home node's host-DMA leg plus the network hop —
        the ICI-vs-PCIe asymmetry that makes placement matter.
        """
        if cross_node:
            t = nbytes / self.dram_bw + nbytes / self.net_bw
        else:
            t = nbytes / self.ici_bw
        if tier == "ssd":
            t += nbytes / self.ssd_bw
        elif tier == "remote":
            # cold storage: NVMe read plus a fabric hop to reach it
            t += nbytes / self.ssd_bw + nbytes / self.net_bw
        return t

    def put_seconds(self, nbytes: int) -> float:
        """Device->host export transfer at put time (the DMA leg; the
        writing node's DRAM is always the first tier)."""
        return nbytes / self.dram_bw


@dataclass
class PoolEntry:
    blob: KVBlob
    tier: str                    # "dram" | "ssd" | "remote"
    home_node: str               # node that holds it (last writer/fetcher)
    nbytes: int


class GlobalKVPool:
    """Capacity-tracked tiered blob store keyed by req_id.

    ``dram_capacity`` (and ``ssd_capacity`` when given) are **per-node**
    budgets: each node's DRAM tier is evicted independently, so a hot
    node spilling to NVMe never touches its peers' working sets.
    """

    def __init__(self, dram_capacity: int = 64 << 30,
                 costs: PoolCosts = PoolCosts(),
                 ssd_capacity: Optional[int] = None):
        self.dram_capacity = dram_capacity
        self.ssd_capacity = ssd_capacity
        self.costs = costs
        self._entries: "collections.OrderedDict[str, PoolEntry]" = \
            collections.OrderedDict()
        self._node_dram: Dict[str, int] = {}
        self._node_ssd: Dict[str, int] = {}
        # stats
        self.puts = 0
        self.hits = 0
        self.misses = 0
        self.evictions = 0           # dram -> ssd demotions
        self.remote_spills = 0       # ssd -> remote demotions
        self.bytes_moved = 0
        self.transfer_seconds = 0.0
        # directional split of bytes_moved (puts = device->host exports,
        # gets = host->device fetches)
        self.bytes_put = 0
        self.bytes_fetched = 0
        # bytes that crossed the inter-node fabric (fetches whose home
        # node differed from the fetching node) — the quantity the
        # topology-aware scheduler minimises
        self.cross_node_bytes = 0
        self.cross_node_fetches = 0
        # placement-aware export: blobs homed on a node other than the
        # exporter (the predicted resume node), paying the fabric leg
        # at export time instead of at fetch time
        self.export_placed_remote = 0
        self.export_placed_remote_bytes = 0
        # optional flight-recorder hook (repro_torch.obs.Tracer) — set by
        # run_stream; put/get/miss traffic emits instant events
        self.tracer = None

    # -- per-node accounting ---------------------------------------------------

    @property
    def dram_used(self) -> int:
        return sum(self._node_dram.values())

    def node_dram_used(self, node: str) -> int:
        return self._node_dram.get(node, 0)

    def node_ssd_used(self, node: str) -> int:
        return self._node_ssd.get(node, 0)

    def _deaccount(self, entry: PoolEntry) -> None:
        if entry.tier == "dram":
            self._node_dram[entry.home_node] -= entry.nbytes
        elif entry.tier == "ssd":
            self._node_ssd[entry.home_node] -= entry.nbytes

    # -- writes ----------------------------------------------------------------

    def put(self, blob: KVBlob, node: str = "n0",
            placed_node: Optional[str] = None) -> None:
        """Insert one exported blob.  ``node`` is the exporting node
        (whose device->host DMA leg is always charged);
        ``placed_node``, when given, homes the blob elsewhere —
        placement-aware export pays the fabric hop now, at export time,
        so the expected resume fetch rides the cheap same-node path."""
        self._insert(blob, node, placed_node)
        self._evict(placed_node or node)

    def put_batch(self, blobs: Iterable[KVBlob], node: str = "n0",
                  placements: Optional[Dict[str, str]] = None) -> None:
        """Insert several blobs (one instance's batched export), then
        run eviction once over the whole batch — a mid-batch eviction
        pass could demote an earlier blob of the same batch before its
        peers even landed, despite it being the newest data in the
        pool.  ``placements`` (req_id -> node) optionally homes each
        blob on the node its chunk is expected to resume on."""
        placements = placements or {}
        targets = {node}
        for blob in blobs:
            placed = placements.get(blob.req_id)
            self._insert(blob, node, placed)
            targets.add(placed or node)
        for n in targets:
            self._evict(n)

    def _insert(self, blob: KVBlob, node: str,
                placed_node: Optional[str] = None) -> None:
        old = self._entries.pop(blob.req_id, None)
        if old is not None:
            self._deaccount(old)
        # integrity stamp at the pool boundary: every pooled blob
        # carries a header CRC, verified on the import side before any
        # cache mutation (see KVBlob.stamp_checksum for what it covers)
        blob.stamp_checksum()
        home = placed_node if placed_node is not None else node
        entry = PoolEntry(blob, "dram", home, blob.nbytes)
        self._entries[blob.req_id] = entry
        self._node_dram[home] = self._node_dram.get(home, 0) + blob.nbytes
        self.puts += 1
        # the export itself moves bytes (device->host): charge it here,
        # not only at get time — puts were free while gets paid, so
        # migration cost was undercounted in engine stats and the
        # simulator
        t = self.costs.put_seconds(blob.nbytes)
        if home != node:
            # placement-aware export: the blob crosses the fabric to its
            # predicted resume node at export time (batched, inside the
            # overlap window) instead of at fetch time on the admission
            # path
            t += blob.nbytes / self.costs.net_bw
            self.export_placed_remote += 1
            self.export_placed_remote_bytes += blob.nbytes
        self.transfer_seconds += t
        self.bytes_moved += blob.nbytes
        self.bytes_put += blob.nbytes
        if self.tracer is not None:
            self.tracer.instant("pool_put", "pool", home,
                                req=blob.req_id, nbytes=blob.nbytes,
                                remote=home != node, seconds=t)

    def _evict(self, node: str) -> None:
        # one pass per tier over the recency order (oldest first): a
        # victim-at-a-time rescan would make a k-entry overflow cost
        # k full scans of the pool on the migration hot path
        over = self._node_dram.get(node, 0) - self.dram_capacity
        if over > 0:
            for e in self._entries.values():
                if over <= 0:
                    break
                if e.tier == "dram" and e.home_node == node:
                    e.tier = "ssd"
                    self._node_dram[node] -= e.nbytes
                    self._node_ssd[node] = \
                        self._node_ssd.get(node, 0) + e.nbytes
                    self.evictions += 1
                    over -= e.nbytes
        if self.ssd_capacity is None:
            return
        over = self._node_ssd.get(node, 0) - self.ssd_capacity
        if over > 0:
            for e in self._entries.values():
                if over <= 0:
                    break
                if e.tier == "ssd" and e.home_node == node:
                    e.tier = "remote"
                    self._node_ssd[node] -= e.nbytes
                    self.remote_spills += 1
                    over -= e.nbytes

    # -- reads -----------------------------------------------------------------

    def peek_fetch_cost(self, req_id: str, node: str) -> float:
        """Modeled seconds to bring ``req_id``'s blob to ``node``,
        without touching stats or recency — the scheduler's placement-
        ranking oracle.  Unknown blobs cost 0 (a fresh request has no
        placement preference)."""
        entry = self._entries.get(req_id)
        if entry is None:
            return 0.0
        return self.costs.fetch_seconds(
            entry.nbytes, entry.tier, entry.home_node != node)

    def peek_next_pos(self, req_id: str) -> Optional[int]:
        """Position extent of ``req_id``'s pooled blob, or None if the
        pool holds nothing for it.  No stats, no recency bump — the
        recovery path's is-the-blob-usable probe (a blob is only a
        valid resume point when its ``next_pos`` matches the request's
        last chunk boundary)."""
        entry = self._entries.get(req_id)
        return None if entry is None else entry.blob.next_pos

    def get(self, req_id: str, node: str = "n0") -> Optional[KVBlob]:
        entry = self._entries.get(req_id)
        if entry is None:
            self.misses += 1
            if self.tracer is not None:
                self.tracer.instant("pool_miss", "pool", node, req=req_id)
            return None
        self.hits += 1
        cross = entry.home_node != node
        fetch_s = self.costs.fetch_seconds(entry.nbytes, entry.tier, cross)
        if self.tracer is not None:
            self.tracer.instant("pool_get", "pool", node,
                                req=req_id, nbytes=entry.nbytes,
                                tier=entry.tier, cross=cross,
                                seconds=fetch_s)
        self.transfer_seconds += fetch_s
        self.bytes_moved += entry.nbytes
        self.bytes_fetched += entry.nbytes
        if cross:
            self.cross_node_bytes += entry.nbytes
            self.cross_node_fetches += 1
        # promote into the fetching node's DRAM.  Recency must be
        # bumped BEFORE eviction runs: the just-fetched entry was the LRU
        # head, so evicting first picked it as its own victim — counted as
        # an eviction and left tier-tagged "ssd" while the caller used it
        # as a DRAM hit.
        self._deaccount(entry)
        entry.home_node = node
        entry.tier = "dram"
        self._node_dram[node] = self._node_dram.get(node, 0) + entry.nbytes
        self._entries.move_to_end(req_id)
        self._evict(node)
        return entry.blob

    def drop(self, req_id: str) -> None:
        entry = self._entries.pop(req_id, None)
        if entry is not None:
            self._deaccount(entry)

    def stats(self) -> dict:
        return {
            "puts": self.puts, "hits": self.hits, "misses": self.misses,
            "evictions": self.evictions,
            "remote_spills": self.remote_spills,
            "dram_used_gb": self.dram_used / (1 << 30),
            "dram_used_by_node_gb": {n: u / (1 << 30)
                                     for n, u in self._node_dram.items()},
            "bytes_moved_gb": self.bytes_moved / (1 << 30),
            "bytes_put_gb": self.bytes_put / (1 << 30),
            "bytes_fetched_gb": self.bytes_fetched / (1 << 30),
            "cross_node_bytes": self.cross_node_bytes,
            "cross_node_fetches": self.cross_node_fetches,
            "export_placed_remote": self.export_placed_remote,
            "export_placed_remote_bytes": self.export_placed_remote_bytes,
            "transfer_seconds": self.transfer_seconds,
        }
