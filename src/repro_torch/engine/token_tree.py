"""Token trees for multi-path speculative verification.

``GroupCST.speculate_multipath`` produces top-k beam drafts; the engine
used to keep only the best path and verify a single linear chain per
slot.  A :class:`TokenTree` merges a slot's candidate paths into one
compact token tree — shared prefixes deduplicated, one node per distinct
(path-prefix, token) — so all paths are verified by a single forward:
tree nodes occupy the verify columns after the row's anchor token, each
node attends only to its ancestors (plus the committed cache prefix),
and the engine's fused step selects the longest *accepted path* on
device.  Acceptance per node follows the same rule as the linear
longest-prefix match: node ``j`` is accepted iff its token equals the
token the model sampled at ``j``'s parent and every ancestor of ``j``
was accepted.  Because children of one node carry distinct tokens (the
merge dedups them), at most one child can match its parent's sample, so
the accepted set is always a chain — the tree-generalisation of the
linear rule, and bit-identical to it when the tree is a single path.

Node order is topological (parents before children, BFS by depth), which
is what the engine's masked SSM replay and the device-side acceptance
scan rely on.  Tree sizes are bucketed to powers of two by the engine so
compiled step shapes stay log-bounded.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional, Sequence, Tuple


@dataclass
class TokenTree:
    """A compact draft token tree in topological (BFS) order.

    ``tokens[j]`` is node ``j``'s draft token; ``parent[j]`` is the node
    index of its parent (``-1`` = child of the anchor/root, i.e. depth
    1); ``depth[j] = depth[parent[j]] + 1`` (so logical position =
    ``anchor_pos + depth[j]``).  ``paths`` keeps the original (trimmed)
    candidate token lists, rank order preserved — the host uses them to
    attribute an accepted chain to the beam rank that drafted it
    (per-branch β statistics).
    """
    tokens: List[int] = field(default_factory=list)
    parent: List[int] = field(default_factory=list)
    depth: List[int] = field(default_factory=list)
    paths: List[List[int]] = field(default_factory=list)

    def __len__(self) -> int:
        return len(self.tokens)

    @property
    def max_depth(self) -> int:
        return max(self.depth, default=0)

    def is_chain(self) -> bool:
        """True iff the tree is a single linear path (each node's parent
        is the previous node) — the shape the linear verify path and the
        SSM/hybrid engines require."""
        return all(p == j - 1 for j, p in enumerate(self.parent))

    def ancestors_or_self(self) -> List[List[int]]:
        """Per node, the node indices on its root path (self included)."""
        out: List[List[int]] = []
        for j, p in enumerate(self.parent):
            out.append(([] if p < 0 else list(out[p])) + [j])
        return out

    def winner_rank(self, accepted: Sequence[int]) -> Optional[int]:
        """Rank of the candidate path the accepted chain followed.

        ``accepted`` are the accepted draft tokens (depth 1..a along the
        winning branch).  Returns the first (best-scored) rank whose
        path starts with them, or None when nothing was accepted.
        """
        acc = list(accepted)
        if not acc:
            return None
        for r, p in enumerate(self.paths):
            if p[:len(acc)] == acc:
                return r
        return None


def chain_tree(tokens: Sequence[int]) -> TokenTree:
    """Degenerate single-path tree — the linear draft as a TokenTree."""
    toks = [int(t) for t in tokens]
    return TokenTree(tokens=toks,
                     parent=list(range(-1, len(toks) - 1)),
                     depth=list(range(1, len(toks) + 1)),
                     paths=[toks] if toks else [])


def build_token_tree(paths: Sequence[Sequence[int]],
                     max_nodes: Optional[int] = None) -> TokenTree:
    """Merge candidate draft paths into one deduplicated token tree.

    Paths sharing a prefix share nodes (a trie merge), so k beams of
    depth d cost well under k*d verify columns when they diverge late —
    exactly the regime grouped CSTs produce (members of a GRPO group
    agree on a trunk and fork at a few positions).  Rank order encodes
    priority: when ``max_nodes`` bounds the tree, nodes are admitted
    path-by-path in rank order, each path breadth-kept only while budget
    remains, so the trunk survives truncation first.

    Returns nodes in BFS order (by depth, then insertion), parents
    before children.
    """
    # trie insert, path-by-path so rank priority bounds truncation
    trie_tok: List[int] = []
    trie_par: List[int] = []
    children: List[dict] = []
    kept_paths: List[List[int]] = []
    budget = max_nodes if max_nodes is not None else (1 << 30)
    root_children: dict = {}
    for path in paths:
        node = -1
        kept: List[int] = []
        for tok in path:
            tok = int(tok)
            ch = root_children if node < 0 else children[node]
            nxt = ch.get(tok)
            if nxt is None:
                if len(trie_tok) >= budget:
                    break
                nxt = len(trie_tok)
                trie_tok.append(tok)
                trie_par.append(node)
                children.append({})
                ch[tok] = nxt
            node = nxt
            kept.append(tok)
        if kept and kept not in kept_paths:
            kept_paths.append(kept)
    if not trie_tok:
        return TokenTree()
    # BFS order: depth, then original insertion order (stable)
    depth = [0] * len(trie_tok)
    for j, p in enumerate(trie_par):
        depth[j] = 1 if p < 0 else depth[p] + 1
    order = sorted(range(len(trie_tok)), key=lambda j: (depth[j], j))
    remap = {old: new for new, old in enumerate(order)}
    return TokenTree(
        tokens=[trie_tok[j] for j in order],
        parent=[(-1 if trie_par[j] < 0 else remap[trie_par[j]])
                for j in order],
        depth=[depth[j] for j in order],
        paths=kept_paths)


def bucket_pow2(n: int, cap: int) -> int:
    """Smallest power of two >= n, capped (0 stays 0) — the compile-key
    bucketing the tree dispatch applies to verify widths and prefill
    chunk columns (the same ladder the linear dispatch and the export
    extents use inline)."""
    if n <= 0:
        return 0
    b = 1
    while b < n:
        b <<= 1
    return min(b, cap)
