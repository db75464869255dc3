"""Toy RL tasks with programmatic rewards + a toy tokenizer.

A copy of ``repro.data.tasks`` (pure numpy; the port imports nothing of
the JAX package), so a seed gives both trainers the same prompts and
rewards.

The RL loop needs verifiable rewards that a ~100M (or tiny) model can
actually learn.  Tasks operate on small integer vocabularies:

* ``copy``    — respond with the prompt body repeated cyclically; reward =
                fraction of correct positions.  Learnable by induction
                heads; reward climbs quickly under GRPO.
* ``sort``    — respond with the prompt tokens in sorted order.
* ``succ``    — respond with each prompt token + 1 (mod vocab).

Rewards are in [0, 1] and depend only on (prompt, response), mirroring the
paper's rule-based math rewards (reward computation is async in Seer —
our loop computes rewards while the next groups roll out).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, List, Sequence

import numpy as np


@dataclass(frozen=True)
class Tokenizer:
    """Integer-token toy tokenizer with reserved specials.

    ``content_vocab`` bounds the token range tasks draw from — a small
    range keeps random-policy reward variance non-zero so GRPO's
    group-normalized advantages carry signal from step one.
    """
    vocab_size: int
    content_vocab: int = 0         # 0 -> full vocab
    pad_id: int = 0
    bos_id: int = 1
    eos_id: int = 2

    @property
    def first_content(self) -> int:
        return 3

    @property
    def last_content(self) -> int:
        if self.content_vocab:
            return min(self.first_content + self.content_vocab,
                       self.vocab_size)
        return self.vocab_size

    def random_body(self, rng: np.random.Generator, length: int
                    ) -> List[int]:
        return rng.integers(self.first_content, self.last_content,
                            size=length).tolist()


def _target_copy(body: Sequence[int], n: int) -> List[int]:
    return [body[i % len(body)] for i in range(n)]


def _target_sort(body: Sequence[int], n: int) -> List[int]:
    s = sorted(body)
    return [s[i % len(s)] for i in range(n)]


def _target_succ(body: Sequence[int], n: int, vocab: int, first: int
                 ) -> List[int]:
    span = vocab - first
    out = [first + ((t - first + 1) % span) for t in body]
    return [out[i % len(out)] for i in range(n)]


@dataclass(frozen=True)
class Task:
    name: str
    tok: Tokenizer
    prompt_len: int = 8
    response_len: int = 16

    def sample_prompt(self, rng: np.random.Generator) -> List[int]:
        body = self.tok.random_body(rng, self.prompt_len)
        return [self.tok.bos_id] + body

    def target(self, prompt: Sequence[int]) -> List[int]:
        body = list(prompt[1:])    # strip BOS
        n = self.response_len
        if self.name == "copy":
            return _target_copy(body, n)
        if self.name == "sort":
            return _target_sort(body, n)
        if self.name == "succ":
            return _target_succ(body, n, self.tok.vocab_size,
                                self.tok.first_content)
        raise ValueError(self.name)

    def reward(self, prompt: Sequence[int], response: Sequence[int]
               ) -> float:
        """0.75·positional match + 0.25·in-prompt shaping (dense signal)."""
        tgt = self.target(prompt)
        if not response:
            return 0.0
        hits = sum(1 for a, b in zip(response, tgt) if a == b)
        body = set(prompt[1:])
        soft = sum(1 for a in response if a in body)
        n = max(len(tgt), 1)
        return 0.75 * hits / n + 0.25 * soft / max(len(response), 1)


def make_task(name: str, vocab_size: int, *, prompt_len: int = 8,
              response_len: int = 16, content_vocab: int = 8) -> Task:
    return Task(name, Tokenizer(vocab_size, content_vocab),
                prompt_len, response_len)


class RewardWorker:
    """Asynchronous-reward stand-in: scores arrive via a queue the loop
    drains after rollout (the paper overlaps reward computation with
    rollout; in-process we preserve the interface)."""

    def __init__(self, task: Task):
        self.task = task
        self._pending: List[tuple] = []

    def submit(self, req_id: str, prompt: Sequence[int],
               response: Sequence[int]) -> None:
        self._pending.append((req_id, prompt, response))

    def collect(self) -> Dict[str, float]:
        out = {rid: self.task.reward(p, r) for rid, p, r in self._pending}
        self._pending.clear()
        return out
