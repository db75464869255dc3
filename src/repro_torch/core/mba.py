"""Marginal-Benefit-Aware Adaptive Speculation — paper Algorithm 1.

Splits the total draft-token budget Γ* = γ*(B)·B between high-priority
(speculative probes) and low-priority requests by repeatedly granting one
more draft position to whichever class has the larger marginal benefit,
biased toward high priority by λ.

Fidelity note (documented in DESIGN.md): the paper's line 9 writes the
benefit as ``B·(β[γ] − β[γ+1])`` — the *slope* of the acceptance curve.
Taken literally that rewards classes whose curve decays fastest, which
inverts the utility-maximization principle the text invokes.  We use the
standard marginal-utility form ``B·β[γ+1]`` (class size x probability the
next drafted position is accepted = expected extra tokens per step from
one more draft slot).  With a monotone β the greedy allocation is then
water-filling-optimal.  Structure (budget Γ*, B_h-first funding, λ bias,
γ_max caps, early-exit) follows Algorithm 1 exactly.

Second fidelity note: the paper states λ ∈ [1, ∞) *biases allocation
toward the high-priority class* ("probes ... should complete faster, thus
requiring higher draft budgets").  Line 11 as printed (benefit_h >
λ·benefit_l) does the opposite — it demands high-priority's benefit beat
λ× low-priority's before granting it a slot.  We apply λ on the
high-priority side (λ·benefit_h ≥ benefit_l), which matches the stated
intent: λ=1 is neutral utility maximization, λ>1 tilts budget toward the
probes.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Sequence, Tuple

from repro_torch.core.sdmodel import SDThroughputModel


def mba_tree_paths(gamma_tokens: int, beta: Sequence[float],
                   branch_beta: Sequence[float], max_paths: int,
                   gamma_max: int) -> Tuple[int, ...]:
    """Split one request's draft-token budget across tree paths.

    Tree-mode extension of Algorithm 1's marginal-benefit principle:
    the per-request budget ``gamma_tokens`` (the γ the linear policy
    would spend on one chain) is allocated token-by-token to whichever
    candidate path has the larger marginal expected-acceptance gain.
    Extending path ``r`` from depth ``d`` to ``d+1`` is worth
    ``w_r * beta[d]`` expected tokens, where ``w_r`` is the probability
    the accepted chain follows branch ``r`` — 1.0 for the trunk by
    construction of the per-branch β estimates
    (:meth:`~repro_torch.core.context.ContextManager.record_tree_verification`
    normalises rescue ranks against the trunk), and the online rescue
    rate ``branch_beta[r]`` for side branches.  A branch whose rescue
    rate decays to ~0 never outbids the trunk's next position, so low
    branch diversity collapses the allocation back to one chain —
    exactly the regime where linear speculation already wins.

    The trunk's marginal at depth d is the unconditional β[d] (all of
    positions 1..d+1 must accept).  A side branch's marginal is
    conditional: GIVEN the chain follows branch r (probability w_r),
    its depth-d continuation tracks the normalised profile β[d]/β[1] —
    so a branch's first token is worth w_r outright, and the controller
    naturally moves the *tail* of a long trunk onto a second branch
    once β has decayed below the rescue rate (deep trunk positions are
    compound bets; a fresh branch is not).

    Paths open in rank order (rank r can only receive tokens once rank
    r-1 holds at least one), depths are capped at ``gamma_max``, and
    the trunk always gets the first token.  Returns per-path depth
    budgets, trunk first, side branches only when funded.
    """
    if gamma_tokens <= 0 or max_paths <= 0:
        return ()
    beta = list(beta) + [0.0] * max(0, gamma_max + 1 - len(beta))
    b0 = max(beta[0], 1e-6)
    weights = [1.0] + [
        (branch_beta[r] if r < len(branch_beta) else 0.0)
        for r in range(1, max_paths)]
    depths = [0] * max_paths
    depths[0] = 1
    for _ in range(min(gamma_tokens, max_paths * gamma_max) - 1):
        best_r, best_gain = -1, 0.0
        for r in range(max_paths):
            if depths[r] >= gamma_max:
                continue
            if r > 0 and depths[r - 1] == 0:
                break                      # ranks open in order
            d = min(depths[r], gamma_max)
            gain = beta[d] if r == 0 else \
                weights[r] * beta[d] / b0
            if gain > best_gain:
                best_r, best_gain = r, gain
        if best_r < 0:
            break
        depths[best_r] += 1
    return tuple(d for d in depths if d > 0)


@dataclass(frozen=True)
class MBAConfig:
    gamma_max: int = 8
    lam: float = 2.0             # priority factor λ ∈ [1, ∞)


def mba_speculation(b_h: int, b_l: int, beta: Sequence[float],
                    sd: SDThroughputModel, alpha: float, mean_ctx: float,
                    cfg: MBAConfig = MBAConfig()) -> Tuple[int, int]:
    """Algorithm 1.  Returns (γ_h, γ_l).

    ``beta`` are per-position acceptance probabilities β[1], β[2], …
    (beta[0] is position 1).  Needs len(beta) >= gamma_max + 1.
    """
    B = b_h + b_l
    if B == 0:
        return 0, 0
    beta = list(beta) + [0.0] * max(0, cfg.gamma_max + 1 - len(beta))

    # line 2: optimal draft length for the whole batch
    gamma_star = sd.optimal_gamma(B, alpha, mean_ctx, cfg.gamma_max)
    total = gamma_star * B                       # line 3: Γ*
    if total < b_h or gamma_star == 0:           # lines 4-5
        return 0, 0

    # lines 7+: allocate by marginal benefit
    gamma_h, gamma_l = 1, 0
    remaining = total - b_h
    while remaining > 0:
        # marginal expected tokens from one more draft position
        # (beta is 0-indexed: beta[i] = acceptance prob of position i+1)
        benefit_h = b_h * beta[gamma_h] if b_h > 0 else -1.0
        benefit_l = b_l * beta[gamma_l] if b_l > 0 else -1.0
        if b_h > 0 and cfg.lam * benefit_h >= benefit_l \
                and gamma_h < cfg.gamma_max and remaining >= b_h:
            gamma_h += 1
            remaining -= b_h
        elif b_l > 0 and gamma_l < cfg.gamma_max and remaining >= b_l:
            gamma_l += 1
            remaining -= b_l
        else:
            break
    if b_h == 0:
        gamma_h = 0
    return gamma_h, gamma_l
