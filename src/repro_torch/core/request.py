"""Request / group / chunk abstractions for divided rollout.

The paper's schedulable unit is a *generation chunk*: a bounded number of
decode tokens of one request (§3.2).  A :class:`RolloutRequest` is the
persistent object that survives across chunks (and across instances, since
divided rollout may migrate it); it carries everything the engine needs to
resume — prompt, generated tokens, sampling seed — so resumption is
deterministic no matter where the next chunk runs.

Groups mirror GRPO: ``G`` requests share one prompt (one ``group_id``).
Exactly one request per group is flagged ``speculative`` — the paper's
online length probe (§3.3).
"""
from __future__ import annotations

import enum
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple


class ReqState(enum.Enum):
    PENDING = "pending"        # never scheduled
    READY = "ready"            # in the request buffer, waiting for a chunk
    RUNNING = "running"        # a chunk is executing on an instance
    FINISHED = "finished"


@dataclass
class RolloutRequest:
    req_id: str
    group_id: str
    prompt: List[int]
    seed: int
    max_new_tokens: int
    temperature: float = 1.0
    stop_token: Optional[int] = None
    speculative: bool = False       # the group's high-priority probe

    # mutable rollout state
    state: ReqState = ReqState.PENDING
    # the simulator tracks lengths only; when set, gen_count overrides
    # len(generated) so production-scale sims never materialise tokens
    gen_count: Optional[int] = None
    generated: List[int] = field(default_factory=list)
    logprobs: List[float] = field(default_factory=list)
    next_pos: int = 0               # engine resume position
    last_token: int = -1
    instance_id: Optional[str] = None   # where the current chunk runs
    chunks_run: int = 0
    migrations: int = 0
    preemptions: int = 0
    # staleness ledger: run-length encoding of the param version each
    # generated token was sampled under — [(version, n_tokens), ...] in
    # generation order.  A request that lives across an in-flight weight
    # refresh carries several runs; the trainer expands them to
    # per-token staleness masks.  Empty = everything at version 0.
    version_runs: List[Tuple[int, int]] = field(default_factory=list)
    # timestamps (wall or simulated)
    t_submitted: float = 0.0
    t_first_scheduled: Optional[float] = None
    t_finished: Optional[float] = None

    @property
    def gen_len(self) -> int:
        return self.gen_count if self.gen_count is not None \
            else len(self.generated)

    @property
    def remaining_tokens(self) -> int:
        return max(0, self.max_new_tokens - self.gen_len)

    @property
    def finished(self) -> bool:
        return self.state == ReqState.FINISHED

    def finish(self, now: float) -> None:
        self.state = ReqState.FINISHED
        self.t_finished = now

    def note_version_tokens(self, version: int, n: int) -> None:
        """Record ``n`` newly committed tokens sampled under param
        ``version`` (merged into the last run when contiguous)."""
        if n <= 0:
            return
        if self.version_runs and self.version_runs[-1][0] == version:
            v, k = self.version_runs[-1]
            self.version_runs[-1] = (v, k + n)
        else:
            self.version_runs.append((version, n))

    def version_tokens_recorded(self) -> int:
        """Total tokens the ledger has recorded so far.  The recovery
        path compares this against ``len(generated)`` to note only
        genuinely-new tokens: replayed/re-decoded tokens keep the
        versions they were originally sampled under."""
        return sum(k for _, k in self.version_runs)

    def trim_version_runs(self, n: int) -> None:
        """Drop ledger entries from the tail until at most ``n`` tokens
        are recorded.  Crash recovery from a chunk-boundary blob rewinds
        the request to ``n = len(generated)`` committed tokens; the
        in-chunk tokens beyond it re-decode (bit-identically) and
        re-record on commit."""
        while self.version_runs and self.version_tokens_recorded() > n:
            v, k = self.version_runs[-1]
            excess = self.version_tokens_recorded() - n
            if k <= excess:
                self.version_runs.pop()
            else:
                self.version_runs[-1] = (v, k - excess)

    def token_versions(self) -> List[int]:
        """Per-token param versions, expanded from the run-length ledger
        and padded with version 0 if the ledger is short (tokens from
        before ledger tracking began are version 0 by construction)."""
        out: List[int] = []
        for v, k in self.version_runs:
            out.extend([v] * k)
        n = self.gen_len
        if len(out) < n:
            out = [0] * (n - len(out)) + out
        return out[:n]


@dataclass
class Group:
    group_id: str
    requests: List[RolloutRequest]

    @property
    def size(self) -> int:
        return len(self.requests)

    @property
    def speculative_request(self) -> Optional[RolloutRequest]:
        for r in self.requests:
            if r.speculative:
                return r
        return None

    def finished_lengths(self) -> List[int]:
        return [r.gen_len for r in self.requests if r.finished]

    @property
    def all_finished(self) -> bool:
        return all(r.finished for r in self.requests)


def make_groups(prompts: List[List[int]], group_size: int, *,
                max_new_tokens: int, temperature: float = 1.0,
                stop_token: Optional[int] = None, seed: int = 0,
                prefix: str = "g") -> List[Group]:
    """Expand prompts into GRPO groups; request 0 of each is speculative."""
    groups = []
    for gi, prompt in enumerate(prompts):
        gid = f"{prefix}{gi}"
        reqs = [
            RolloutRequest(
                req_id=f"{gid}.r{ri}", group_id=gid, prompt=list(prompt),
                seed=seed * 1_000_003 + gi * 1009 + ri,
                max_new_tokens=max_new_tokens, temperature=temperature,
                stop_token=stop_token, speculative=(ri == 0))
            for ri in range(group_size)
        ]
        groups.append(Group(gid, reqs))
    return groups
