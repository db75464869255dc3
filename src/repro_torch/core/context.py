"""Context Manager — group-level online length estimation (§3.3).

The paper's estimator is deliberately simple and conservative:

* ``L̂_g = max(generation length over completed requests in g)``
* groups with no completion yet are assumed long-tail:
  ``L̂_g = max_gen_length`` (so they sort *first* under longest-first)

The manager also tracks per-group acceptance statistics for the MBA
speculation policy (per-position acceptance probabilities β[i], §3.4.2),
collected online with an EWMA so they adapt as the policy model drifts.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional

from repro_torch.core.request import Group, RolloutRequest


@dataclass
class GroupContext:
    group_id: str
    est_length: float              # L̂_g
    n_finished: int = 0
    n_total: int = 0
    has_estimate: bool = False     # any completion observed yet?


class ContextManager:
    """Maintains L̂_g per group + online acceptance statistics for SD."""

    def __init__(self, max_gen_length: int, *, beta_positions: int = 32,
                 beta_ewma: float = 0.05, beta_init: float = 0.6,
                 branch_ranks: int = 4, branch_init: float = 0.3):
        self.max_gen_length = max_gen_length
        self._groups: Dict[str, GroupContext] = {}
        self._beta_positions = beta_positions
        self._beta_init = beta_init
        self._beta_ewma = beta_ewma
        self._branch_ranks = branch_ranks
        self._branch_init = branch_init
        self.reset_acceptance()

    def reset_acceptance(self) -> None:
        """Re-initialise the acceptance profile (β, per-branch β) IN
        PLACE, preserving group length contexts and — critically — the
        object identity that live Schedulers hold.  Called at each
        mid-stream weight refresh: the policy has moved, so acceptance
        statistics gathered under the old version would mis-drive MBA
        (a collapsed β can pin γ at 0 and never recover), but the L̂_g
        estimates and group registrations must survive the now-soft
        iteration boundary."""
        # β[i]: probability that draft position i is accepted (1-indexed in
        # the paper's Alg. 1; we store index 0 = position 1).  Shared across
        # groups — the paper profiles these online per workload.
        self.beta = [self._beta_init * (0.85 ** i)
                     for i in range(self._beta_positions)]
        # per-position trial/accept counts for reporting
        self._trials = [0] * self._beta_positions
        self._accepts = [0] * self._beta_positions
        # per-branch β for tree speculation: branch_beta[r] (r >= 1) is
        # the EWMA probability that a verify step's accepted chain left
        # the rank-0 trunk and followed the rank-r candidate path
        # instead (a "rescue").  branch_beta[0] is the trunk's share.
        # These weights are what the tree-mode MBA controller trades a
        # deeper trunk against a second branch with: a rank with a
        # near-zero rescue rate never earns draft tokens, so low branch
        # diversity degrades tree mode gracefully back to linear.
        self.branch_beta = [1.0] + \
            [self._branch_init * (0.5 ** (r - 1))
             for r in range(1, self._branch_ranks)]
        self._branch_trials = [0] * self._branch_ranks
        self._branch_wins = [0] * self._branch_ranks

    # -- group length context --------------------------------------------------

    def register_group(self, group: Group) -> None:
        self._groups[group.group_id] = GroupContext(
            group_id=group.group_id,
            est_length=float(self.max_gen_length),
            n_total=group.size)

    def update_estimate(self, group_id: str, finished_len: int) -> None:
        """Paper: L̂_g <- max(L̂_g observed so far, new completion)."""
        g = self._groups[group_id]
        if not g.has_estimate:
            g.est_length = float(finished_len)
            g.has_estimate = True
        else:
            g.est_length = max(g.est_length, float(finished_len))
        g.n_finished += 1

    def estimate(self, group_id: str) -> float:
        g = self._groups.get(group_id)
        if g is None:
            return float(self.max_gen_length)
        return g.est_length

    def has_estimate(self, group_id: str) -> bool:
        g = self._groups.get(group_id)
        return bool(g and g.has_estimate)

    def group_progress(self, group_id: str) -> float:
        g = self._groups.get(group_id)
        if g is None or g.n_total == 0:
            return 0.0
        return g.n_finished / g.n_total

    # -- acceptance statistics (for MBA / Alg. 1) -------------------------------

    def record_verification(self, n_drafted: int, n_accepted: int) -> None:
        """After a verify step with ``n_drafted`` draft tokens of which the
        first ``n_accepted`` were accepted, update β[i] estimates."""
        w = self._beta_ewma
        for i in range(min(n_drafted, len(self.beta))):
            hit = 1.0 if i < n_accepted else 0.0
            self.beta[i] = (1 - w) * self.beta[i] + w * hit
            self._trials[i] += 1
            self._accepts[i] += int(hit)
        # enforce monotone non-increasing β (position i accepted requires
        # all earlier accepted) — keeps Alg. 1's marginal benefits sane
        for i in range(1, len(self.beta)):
            self.beta[i] = min(self.beta[i], self.beta[i - 1])

    def record_tree_verification(self, winner_rank: Optional[int],
                                 n_drafted: int, n_accepted: int,
                                 n_ranks: int = 0) -> None:
        """After a *tree* verify step, update per-branch β estimates.

        ``winner_rank`` is the candidate-path rank the accepted chain
        followed (:meth:`~repro_torch.engine.token_tree.TokenTree.winner_rank`),
        or None when nothing was accepted (counted as a trunk trial —
        a miss is a failure of the trunk, not of a side branch).
        ``n_ranks`` is how many candidate paths the tree actually
        offered: only offered ranks update — a branch the budget never
        funded keeps its optimistic prior, which is the controller's
        exploration budget (otherwise unfunded branches would decay to
        zero without ever being tried).  The per-position β update
        reuses :meth:`record_verification` so the depth profile stays
        shared between linear and tree mode.
        """
        if n_drafted > 0:
            self.record_verification(n_drafted, n_accepted)
        r_win = 0 if winner_rank is None else int(winner_rank)
        w = self._beta_ewma
        updated = False
        for r in range(1, min(max(n_ranks, r_win + 1),
                              len(self.branch_beta))):
            hit = 1.0 if r == r_win else 0.0
            self.branch_beta[r] = (1 - w) * self.branch_beta[r] + w * hit
            self._branch_trials[r] += 1
            self._branch_wins[r] += int(hit)
            updated = True
        if updated:
            # renormalize the trunk share only against ranks that have
            # actually been measured — a single-path verify must not
            # debit the trunk for untouched optimistic priors
            self.branch_beta[0] = max(
                0.0, 1.0 - sum(self.branch_beta[1:]))

    @property
    def alpha(self) -> float:
        """Mean per-position acceptance rate (the paper's α = E[β])."""
        return self.beta[0]

    def beta_padded(self, n: int) -> List[float]:
        """β[1..n] padded with geometric decay, plus a terminal 0.

        Returns ``n + 1`` entries: positions 1..n then an appended 0.0,
        so MBA's marginal-benefit loop reads exactly 0 — never a decayed
        tail — when it probes one position past γ_max.
        """
        out = list(self.beta[:n])
        while len(out) < n:
            out.append(out[-1] * 0.85 if out else 0.5)
        out.append(0.0)
        return out

    # -- reporting ---------------------------------------------------------------

    def stats(self) -> dict:
        known = [g for g in self._groups.values() if g.has_estimate]
        return {
            "groups": len(self._groups),
            "groups_with_estimate": len(known),
            "alpha": self.alpha,
            "beta": list(self.beta[:8]),
            "branch_beta": list(self.branch_beta),
        }
