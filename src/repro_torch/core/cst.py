"""Grouped Compressed Suffix Tree (CST) for context-learning drafts.

The paper's DGDS keeps one CST per GRPO group, aggregating the token
sequences of *all* requests in the group (§3.4.2).  We implement it as a
bounded-depth generalized suffix trie: every suffix of every request's
token stream, truncated to ``max_depth``, is inserted with frequency
counts.  This preserves the two properties the paper relies on —
O(p + s) draft lookup (p = matched pattern, s = speculated tokens) and
cross-request pattern sharing — while keeping incremental append cheap
(O(max_depth) per token).

Drafting follows SuffixDecoding [27]: match the longest suffix of the
request's recent tokens that exists in the tree, then descend greedily by
frequency; each candidate path carries a confidence score (product of
empirical branch probabilities) used to filter low-probability candidates
and to rank multi-path (beam) speculation.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple


class _Node:
    __slots__ = ("children", "count")

    def __init__(self):
        self.children: Dict[int, "_Node"] = {}
        self.count = 0


@dataclass
class DraftPath:
    tokens: List[int]
    score: float


class SuffixTree:
    """Bounded-depth generalized suffix trie with frequency counts."""

    def __init__(self, max_depth: int = 12):
        self.max_depth = max_depth
        self.root = _Node()
        # per-request rolling window of the last (max_depth-1) tokens, so
        # incremental appends insert exactly the new suffixes
        self._tails: Dict[int, List[int]] = {}
        self.n_tokens = 0
        self.n_requests = 0

    # -- construction ---------------------------------------------------------

    def append(self, request_id: int, new_tokens: Sequence[int]) -> None:
        if request_id not in self._tails:
            self._tails[request_id] = []
            self.n_requests += 1
        tail = self._tails[request_id]
        for tok in new_tokens:
            tail.append(int(tok))
            if len(tail) > self.max_depth:
                del tail[0]
            # insert every suffix of the window ending at the new token
            self._insert_window(tail)
            self.n_tokens += 1

    def _insert_window(self, window: List[int]) -> None:
        """Insert every suffix of ``window`` (all end at the newest token)."""
        L = len(window)
        for start in range(L):
            node = self.root
            for t in window[start:]:
                nxt = node.children.get(t)
                if nxt is None:
                    nxt = _Node()
                    node.children[t] = nxt
                nxt.count += 1
                node = nxt

    # -- drafting ---------------------------------------------------------------

    def _match(self, pattern: Sequence[int], lookup_max: int,
               lookup_min: int) -> Tuple[Optional[_Node], int]:
        """Longest suffix of ``pattern`` present in the trie."""
        pattern = list(pattern)[-min(lookup_max, self.max_depth - 1):]
        for k in range(len(pattern), lookup_min - 1, -1):
            node = self.root
            ok = True
            for t in pattern[len(pattern) - k:]:
                node = node.children.get(int(t))
                if node is None:
                    ok = False
                    break
            if ok and node is not None and node.children:
                return node, k
        return None, 0

    def speculate(self, pattern: Sequence[int], max_tokens: int, *,
                  lookup_max: int = 8, lookup_min: int = 1,
                  min_score: float = 0.0) -> DraftPath:
        """Single-path (linear) draft."""
        node, _ = self._match(pattern, lookup_max, lookup_min)
        tokens: List[int] = []
        score = 1.0
        ctx = list(pattern)
        while node is not None and node.children and len(tokens) < max_tokens:
            tok, child = max(node.children.items(),
                             key=lambda kv: kv[1].count)
            total = sum(c.count for c in node.children.values())
            p = child.count / max(total, 1)
            if score * p < min_score:
                break
            score *= p
            tokens.append(tok)
            ctx.append(tok)
            if child.children:
                node = child
            else:  # re-match deeper context
                node, _ = self._match(ctx, lookup_max, lookup_min)
        return DraftPath(tokens, score)

    def speculate_multipath(self, pattern: Sequence[int], max_tokens: int,
                            top_k: int = 2, *, lookup_max: int = 8,
                            lookup_min: int = 1,
                            min_score: float = 0.0) -> List[DraftPath]:
        """Beam-search drafts: up to ``top_k`` candidate paths by score."""
        node, _ = self._match(pattern, lookup_max, lookup_min)
        if node is None:
            return [DraftPath([], 0.0)]
        beams: List[Tuple[float, List[int], Optional[_Node]]] = \
            [(1.0, [], node)]
        for _ in range(max_tokens):
            nxt: List[Tuple[float, List[int], Optional[_Node]]] = []
            for score, toks, nd in beams:
                if nd is not None and not nd.children:
                    # leaf: re-match on the extended context (same
                    # continuation rule as the linear path)
                    nd, _ = self._match(list(pattern) + toks,
                                        lookup_max, lookup_min)
                if nd is None or not nd.children:
                    nxt.append((score, toks, nd))
                    continue
                total = sum(c.count for c in nd.children.values())
                ranked = sorted(nd.children.items(),
                                key=lambda kv: -kv[1].count)[:top_k]
                for tok, child in ranked:
                    p = child.count / max(total, 1)
                    s = score * p
                    if s < min_score:
                        continue
                    nxt.append((s, toks + [tok], child))
                if not ranked:
                    nxt.append((score, toks, None))
            if not nxt:
                break
            nxt.sort(key=lambda b: -b[0])
            beams = nxt[:top_k]
        return [DraftPath(t, s) for s, t, _ in beams] or [DraftPath([], 0.0)]

    def speculate_paths(self, pattern: Sequence[int],
                        path_budgets: Sequence[int], *,
                        lookup_max: int = 8, lookup_min: int = 1,
                        min_score: float = 0.0) -> List[DraftPath]:
        """Budgeted multi-path drafts for tree speculation.

        ``path_budgets`` are per-rank depth budgets (trunk first) from
        the tree-mode MBA controller
        (:func:`repro_torch.core.mba.mba_tree_paths`): the beam search runs at
        width ``len(path_budgets)`` to the deepest budget, then rank r's
        path is trimmed to its own budget — the trunk keeps its full
        depth while side branches carry only the tokens their rescue
        rate earned.  A single budget degenerates to the linear draft.
        """
        if not path_budgets:
            return [DraftPath([], 0.0)]
        paths = self.speculate_multipath(
            pattern, max(path_budgets), top_k=len(path_budgets),
            lookup_max=lookup_max, lookup_min=lookup_min,
            min_score=min_score)
        out = [DraftPath(p.tokens[:b], p.score)
               for p, b in zip(paths, path_budgets)]
        return [p for p in out if p.tokens] or [DraftPath([], 0.0)]


class GroupCST:
    """Per-group CST aggregating all of the group's requests (+ the prompt)."""

    def __init__(self, group_id: str, max_depth: int = 12):
        self.group_id = group_id
        self.tree = SuffixTree(max_depth)
        self.token_counts: Dict[int, int] = {}   # request_id -> tokens seen

    def update(self, request_id: int, prev_token_count: int,
               new_tokens: Sequence[int]) -> None:
        """Paper API: update_cst(group_id, request_id, prev_count, tokens)."""
        seen = self.token_counts.get(request_id, 0)
        if prev_token_count != seen:
            # out-of-order delivery: drop the overlap, keep the new suffix
            skip = max(0, seen - prev_token_count)
            new_tokens = list(new_tokens)[skip:]
        if not len(new_tokens):
            return
        self.tree.append(request_id, new_tokens)
        self.token_counts[request_id] = self.token_counts.get(
            request_id, 0) + len(new_tokens)
