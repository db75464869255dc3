"""Distributed Grouped Draft Server (DGDS) — paper §3.4.2 + Appendix A.2.

Master-worker architecture with asynchronous CST updates:

* the **server** (master) owns the authoritative per-group CSTs and
  aggregates ``update_cst`` appends from every instance (isolated by
  ``request_id`` so cross-request token streams never interleave);
* each instance embeds a **draft client** that registers its active groups
  (``register_group`` with TTL), periodically ``fetch_cst``-es them, and
  serves ``batch_speculate`` from its *local* snapshot.

In the paper the fetch is an incremental RDMA sync; here the client keeps
a reference snapshot refreshed every ``fetch_interval`` appends, which
models the paper's async staleness (drafts may lag the newest tokens by a
bounded amount) — set ``fetch_interval=1`` for fully synchronous behaviour
in tests.
"""
from __future__ import annotations

import copy
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

from repro_torch.core.cst import DraftPath, GroupCST


@dataclass
class SpeculationArgs:
    max_spec_tokens: int = 8
    pattern_lookup_max: int = 8
    pattern_lookup_min: int = 1
    top_k: int = 1
    min_score: float = 0.0
    # tree speculation: per-rank depth budgets (trunk first) from the
    # tree-mode MBA controller.  When set they override
    # max_spec_tokens/top_k and the client drafts via speculate_paths —
    # the caller merges the returned paths into a TokenTree.
    path_budgets: Optional[Tuple[int, ...]] = None


class DraftServer:
    """The DGDS master: authoritative grouped CSTs."""

    def __init__(self, max_depth: int = 12):
        self.max_depth = max_depth
        self._groups: Dict[str, GroupCST] = {}
        self._versions: Dict[str, int] = {}
        self.updates = 0

    def _group(self, group_id: str) -> GroupCST:
        if group_id not in self._groups:
            self._groups[group_id] = GroupCST(group_id, self.max_depth)
            self._versions[group_id] = 0
        return self._groups[group_id]

    # paper API ---------------------------------------------------------------

    def update_cst(self, group_id: str, request_id: int,
                   prev_token_count: int,
                   new_tokens: Sequence[int]) -> None:
        g = self._group(group_id)
        g.update(request_id, prev_token_count, new_tokens)
        self._versions[group_id] += 1
        self.updates += 1

    def fetch_cst(self, group_ids: Sequence[str],
                  cache_versions: Optional[Dict[str, int]] = None
                  ) -> Dict[str, Tuple[int, GroupCST]]:
        """Returns {gid: (version, cst)} for groups newer than the cache."""
        cache_versions = cache_versions or {}
        out = {}
        for gid in group_ids:
            v = self._versions.get(gid, 0)
            if v > cache_versions.get(gid, -1) and gid in self._groups:
                out[gid] = (v, self._groups[gid])
        return out

    def drop_group(self, group_id: str) -> None:
        self._groups.pop(group_id, None)
        self._versions.pop(group_id, None)

    def stats(self) -> dict:
        return {
            "groups": len(self._groups),
            "updates": self.updates,
            "tokens": sum(g.tree.n_tokens for g in self._groups.values()),
        }


class DraftClient:
    """Embedded per-instance client with an async-refreshed local snapshot.

    ``shared_snapshot=True`` (default) keeps a *reference* to the server's
    CST — zero-copy, like the paper's shared-memory fetch; staleness is then
    modeled purely by fetch cadence bookkeeping.  ``shared_snapshot=False``
    deep-copies on fetch, giving true snapshot isolation (slower; used in
    staleness tests).
    """

    def __init__(self, server: DraftServer, *, fetch_interval: int = 1,
                 shared_snapshot: bool = True):
        self.server = server
        self.fetch_interval = max(1, fetch_interval)
        self.shared_snapshot = shared_snapshot
        self._registered: Dict[str, int] = {}    # gid -> ttl
        self._local: Dict[str, GroupCST] = {}
        self._local_versions: Dict[str, int] = {}
        self._ops_since_fetch = 0
        self.fetches = 0

    # paper API ---------------------------------------------------------------

    def register_group(self, group_id: str, ttl_seconds: int = 3600) -> None:
        self._registered[group_id] = ttl_seconds

    def unregister_group(self, group_id: str) -> None:
        self._registered.pop(group_id, None)
        self._local.pop(group_id, None)
        self._local_versions.pop(group_id, None)

    def maybe_fetch(self, force: bool = False) -> None:
        self._ops_since_fetch += 1
        if not force and self._ops_since_fetch < self.fetch_interval:
            return
        self._ops_since_fetch = 0
        fresh = self.server.fetch_cst(list(self._registered),
                                      self._local_versions)
        for gid, (v, cst) in fresh.items():
            self._local[gid] = cst if self.shared_snapshot \
                else copy.deepcopy(cst)
            self._local_versions[gid] = v
        self.fetches += 1

    def batch_speculate(self, group_ids: Sequence[str],
                        patterns: Sequence[Sequence[int]],
                        args: Sequence[SpeculationArgs]
                        ) -> List[List[DraftPath]]:
        """Drafts for a batch of requests from the local snapshots."""
        self.maybe_fetch()
        out: List[List[DraftPath]] = []
        for gid, pat, a in zip(group_ids, patterns, args):
            cst = self._local.get(gid)
            if cst is None or a.max_spec_tokens <= 0:
                out.append([DraftPath([], 0.0)])
                continue
            if a.path_budgets is not None:
                paths = cst.tree.speculate_paths(
                    pat, a.path_budgets,
                    lookup_max=a.pattern_lookup_max,
                    lookup_min=a.pattern_lookup_min, min_score=a.min_score)
            elif a.top_k > 1:
                paths = cst.tree.speculate_multipath(
                    pat, a.max_spec_tokens, a.top_k,
                    lookup_max=a.pattern_lookup_max,
                    lookup_min=a.pattern_lookup_min, min_score=a.min_score)
            else:
                paths = [cst.tree.speculate(
                    pat, a.max_spec_tokens,
                    lookup_max=a.pattern_lookup_max,
                    lookup_min=a.pattern_lookup_min, min_score=a.min_score)]
            out.append(paths)
        return out
