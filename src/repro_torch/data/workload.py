"""Synthetic RL rollout workload generator.

Reproduces the two statistical properties the paper measures on production
workloads:

* **heavy-tailed output lengths** (Fig. 2): a lognormal body with a
  power-law tail, truncated at ``max_gen_length``; generations range from a
  few hundred tokens to ~96k.
* **intra-group length correlation** (Fig. 4): lengths within a GRPO group
  share a latent group factor; the mixing weight ``rho`` controls how
  "columnar" Fig. 4 looks.

Also generates correlated *token streams* for CST experiments: each group
draws a template token sequence and each response copies template segments
(with per-token corruption), yielding the recurring local patterns the
paper exploits (Table 2).

Presets match Table 3's three production workloads.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import numpy as np


@dataclass(frozen=True)
class WorkloadSpec:
    name: str
    n_requests: int              # per iteration (Table 3 "Reqs per Iter")
    group_size: int
    max_gen_length: int
    mean_gen_length: int
    n_instances: int             # serving instances (GPUs / GPUs-per-inst)
    temperature: float = 1.0
    rho: float = 0.8             # intra-group length correlation
    sigma: float = 1.0           # lognormal shape (tail heaviness)
    prompt_len: int = 1024

    @property
    def n_groups(self) -> int:
        return self.n_requests // self.group_size


# Table 3 presets (n_instances = Total GPUs / GPUs per Instance)
MOONLIGHT = WorkloadSpec("moonlight", n_requests=3200, group_size=8,
                         max_gen_length=65_536, mean_gen_length=22_386,
                         n_instances=32, temperature=1.0, sigma=0.95)
QWEN2_VL_72B = WorkloadSpec("qwen2-vl-72b", n_requests=9600, group_size=16,
                            max_gen_length=40_960, mean_gen_length=7_615,
                            n_instances=16, temperature=0.8, sigma=1.1)
KIMI_K2 = WorkloadSpec("kimi-k2", n_requests=6400, group_size=8,
                       max_gen_length=98_304, mean_gen_length=38_959,
                       n_instances=8, temperature=1.0, sigma=0.85)
WORKLOADS = {w.name: w for w in (MOONLIGHT, QWEN2_VL_72B, KIMI_K2)}


def sample_lengths(spec: WorkloadSpec, rng: np.random.Generator
                   ) -> np.ndarray:
    """(n_groups, group_size) int lengths with group correlation + tail."""
    G, K = spec.n_groups, spec.group_size
    # latent group factor and idiosyncratic factor in log space
    mu = math.log(spec.mean_gen_length) - spec.sigma ** 2 / 2
    z_g = rng.normal(0.0, 1.0, size=(G, 1))
    z_i = rng.normal(0.0, 1.0, size=(G, K))
    z = math.sqrt(spec.rho) * z_g + math.sqrt(1 - spec.rho) * z_i
    lens = np.exp(mu + spec.sigma * z)
    lens = np.clip(lens, 32, spec.max_gen_length).astype(np.int64)
    return lens


def length_stats(lengths: np.ndarray) -> dict:
    flat = lengths.reshape(-1)
    group_mean = lengths.mean(axis=1)
    # intra-class correlation: var(group means) vs total var (log space)
    lg = np.log(lengths)
    icc = np.var(np.mean(lg, axis=1)) / max(np.var(lg), 1e-9)
    return {
        "mean": float(flat.mean()),
        "p50": float(np.percentile(flat, 50)),
        "p90": float(np.percentile(flat, 90)),
        "p99": float(np.percentile(flat, 99)),
        "max": float(flat.max()),
        "icc_log": float(icc),
        "top10pct_share": float(
            np.sort(flat)[-len(flat) // 10:].sum() / flat.sum()),
        "group_mean_cv": float(group_mean.std() / group_mean.mean()),
    }


# ---------------------------------------------------------------------------
# correlated token streams (for CST / Table 2 experiments)
# ---------------------------------------------------------------------------


def group_token_streams(rng: np.random.Generator, group_size: int,
                        lengths: Sequence[int], *, vocab: int = 1024,
                        similarity: float = 0.85, segment: int = 24,
                        n_phrases: int = 64, zipf_a: float = 1.3,
                        token_noise: float = 0.08) -> List[List[int]]:
    """Token sequences for one group sharing recurring local patterns.

    Models the two sources of repetitiveness the paper exploits:

    * **intra-response**: the group draws a *phrase bank* and a template —
      a Zipf-weighted walk over phrase ids — so frequent phrases recur
      within a single response (this is what gives SuffixDecoding's
      self-reference baseline its non-trivial acceptance, ~1.7);
    * **inter-response**: each response follows the shared template with
      prob ``similarity`` per slot (diverging into fresh random tokens
      otherwise), so siblings expose the template's phrases early — the
      grouped-reference gain of Table 2.

    ``token_noise`` corrupts copied tokens i.i.d., bounding acceptance
    run lengths the way sampling temperature does in real rollouts.
    """
    bank = rng.integers(0, vocab, size=(n_phrases, segment))
    w = 1.0 / np.arange(1, n_phrases + 1, dtype=float) ** zipf_a
    w /= w.sum()
    max_len = max(lengths)
    n_slots = max_len // segment + 2
    template_ids = rng.choice(n_phrases, size=n_slots, p=w)
    out = []
    for L in lengths:
        toks: List[int] = []
        slot = 0
        while len(toks) < L:
            if rng.random() < similarity:
                seg = bank[template_ids[slot]].copy()
                flip = rng.random(segment) < token_noise
                seg[flip] = rng.integers(0, vocab, size=int(flip.sum()))
            else:
                seg = rng.integers(0, vocab, size=segment)
            toks.extend(int(t) for t in seg)
            slot += 1
        out.append(toks[:int(L)])
    return out


def make_workload(spec: WorkloadSpec, seed: int = 0, *,
                  n_groups: Optional[int] = None,
                  with_tokens: bool = False, vocab: int = 1024
                  ) -> "Workload":
    rng = np.random.default_rng(seed)
    lengths = sample_lengths(spec, rng)
    if n_groups is not None:
        lengths = lengths[:n_groups]
    tokens = None
    if with_tokens:
        tokens = [group_token_streams(rng, spec.group_size, row,
                                      vocab=vocab)
                  for row in lengths]
    return Workload(spec=spec, lengths=lengths, tokens=tokens)


@dataclass
class Workload:
    spec: WorkloadSpec
    lengths: np.ndarray          # (n_groups, group_size)
    tokens: Optional[List[List[List[int]]]] = None

    @property
    def n_groups(self) -> int:
        return self.lengths.shape[0]

    def stats(self) -> dict:
        return length_stats(self.lengths)
