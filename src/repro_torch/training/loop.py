"""The RL iteration loop (rollout -> reward -> experience -> train ->
weight update) with Seer driving the rollout phase.

Counterpart of ``repro.training.loop``: ``RLConfig``,
``StalenessLedger``, ``IterStats``, ``make_train_step`` and ``RLTrainer``
with its synchronous barrier loop (``_run_sync``) and its
bounded-staleness streaming loop (``_run_stream``).  The trainer holds
f32 master weights that require gradients and an AdamW state on the
device; each train step runs ``grpo_loss`` (the cache-free forward on the
flash-attention kernel, K3, and on SSM and hybrid models the SSD
kernel, K4, and its backward; each layer recomputed in the backward),
``torch.autograd.grad`` and an in-place AdamW update.  The rollout
instances decode under a detached ``cfg.dtype`` copy that
``WeightUpdater`` pushes after each train step, so the engine never sees
a tensor that requires gradients, and pushes and ``refresh_params`` only
happen at stream yield points, with no step ticket in flight.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.request import Group, make_groups
from repro_torch.core.rollout import SeerRollout
from repro_torch.data.tasks import RewardWorker, Task
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models.transformer import init_params
from repro_torch.training.checkpoint import (WeightUpdater, save,
                                             serving_params)
from repro_torch.training.grpo import GRPOConfig, grpo_loss, pack_experience
from repro_torch.training.optim import (OptConfig, OptState, adamw_update,
                                        init_opt_state, tree_items,
                                        tree_map, tree_rebuild)


@dataclass
class RLConfig:
    n_groups: int = 8
    group_size: int = 4
    max_new_tokens: int = 16
    temperature: float = 1.0
    iterations: int = 20
    train_steps_per_iter: int = 1
    seed: int = 0
    policy: str = "seer"
    spec_decode: bool = True
    n_instances: int = 2
    max_slots: int = 4
    cache_len: int = 256
    chunk_size: int = 64
    # bounded-staleness rollout<->train overlap: async_overlap drives the
    # rollout as a stream (SeerRollout.run_stream) — groups train as they
    # finish, next-iteration prompts pack into tail bubbles, and weights
    # refresh in flight.  Iteration j's prompts may enter the stream once
    # weights reached version j - staleness_bound.  Bound 0 forbids any
    # overlap and reproduces the sync loop bit-exactly.
    async_overlap: bool = False
    staleness_bound: int = 0
    # how live slots survive an in-flight refresh: "keep" re-prefills the
    # committed prefix under the new params, "truncate" rewinds to the
    # prompt and replays the old generation as verify drafts
    refresh_mode: str = "keep"
    # deterministic fault schedule for the rollout stream
    fault_injector: Optional[object] = None
    watchdog_ticks: int = 3
    # optional repro_torch.obs.Tracer: threaded into the rollout stream,
    # with the trainer stamping train/refresh instants on the "trainer"
    # track at the rollout's current tick (host metadata only)
    tracer: Optional[object] = None
    checkpoint_dir: Optional[str] = None
    checkpoint_every: int = 0
    log: Callable[[str], None] = print
    # where the trainer runs: "cuda" unless the caller asks for the CPU
    device: DeviceLike = None


class StalenessLedger:
    """Per-iteration accounting of how stale every trained token was
    (weight version at the train step minus the version the token was
    sampled under), with a hard gate on the configured bound."""

    def __init__(self, bound: int):
        self.bound = bound
        # iteration -> {staleness: token count}
        self.per_iteration: Dict[int, Dict[int, int]] = {}

    def record(self, iteration: int, train_version: int,
               token_versions: Dict[str, List[int]]) -> None:
        counts: Dict[int, int] = {}
        for vs in token_versions.values():
            for v in vs:
                s = max(0, train_version - v)
                counts[s] = counts.get(s, 0) + 1
        self.per_iteration[iteration] = counts
        worst = max(counts) if counts else 0
        if worst > self.bound:
            raise RuntimeError(
                f"staleness bound violated: iteration {iteration} "
                f"trained tokens {worst} versions stale "
                f"(bound {self.bound})")

    @property
    def max_staleness(self) -> int:
        return max((max(c) for c in self.per_iteration.values() if c),
                   default=0)

    def total_tokens(self, staleness: Optional[int] = None) -> int:
        return sum(n for c in self.per_iteration.values()
                   for s, n in c.items()
                   if staleness is None or s == staleness)


@dataclass
class IterStats:
    iteration: int
    mean_reward: float
    loss: float
    rollout_seconds: float
    train_seconds: float
    weight_update_seconds: float
    tokens: int
    mean_acceptance: float
    metrics: dict = field(default_factory=dict)


def make_train_step(cfg: ModelConfig, gcfg: GRPOConfig, ocfg: OptConfig):
    """step(params, opt_state, batch) -> (params, opt_state, loss,
    metrics): value and gradient of ``grpo_loss``, then AdamW, on any
    arch's batch (a VLM's with ``image_embeds``, an audio model's with
    ``audio_frames``).  Params and state are updated in place; loss and
    metrics stay on the device."""
    def step(params, opt_state: OptState, batch: dict):
        loss, metrics = grpo_loss(cfg, params, batch, gcfg=gcfg)
        leaves = [t for _, t in tree_items(params)]
        grads = tree_rebuild(params, torch.autograd.grad(loss, leaves))
        params, opt_state, om = adamw_update(ocfg, params, grads,
                                             opt_state)
        metrics.update(om)
        return params, opt_state, loss.detach(), metrics

    return step


def master_params(params, device) -> dict:
    """f32 copies of ``params`` on ``device`` that require gradients."""
    return tree_map(lambda p: p.detach().to(device, torch.float32,
                                            copy=True).requires_grad_(),
                    params)


class RLTrainer:
    def __init__(self, cfg: ModelConfig, task: Task, rl: RLConfig,
                 gcfg: GRPOConfig = GRPOConfig(),
                 ocfg: Optional[OptConfig] = None, params=None):
        if cfg.arch_type in ("vlm", "audio"):
            raise NotImplementedError(
                f"arch_type={cfg.arch_type!r}: RLTrainer does not train VLM "
                "or audio models, as the JAX package's does not: its "
                "experience batch (pack_experience) carries no image_embeds "
                "or audio_frames, so its first train step's cache-free "
                "forward fails its assertion that they are there.  Their "
                "train step runs through make_train_step on a batch that "
                "carries them")
        self.cfg = cfg
        self.task = task
        self.rl = rl
        self.gcfg = gcfg
        self.device = resolve_device(rl.device)
        self.ocfg = ocfg or OptConfig(
            total_steps=rl.iterations * rl.train_steps_per_iter)
        if params is None:
            gen = torch.Generator(device=self.device).manual_seed(rl.seed)
            params = init_params(cfg, gen, device=self.device,
                                 dtype="float32")
        self.params = master_params(params, self.device)
        self.opt_state = init_opt_state(self.params)
        self.train_step = make_train_step(cfg, gcfg, self.ocfg)
        self.rollout = SeerRollout(
            cfg, serving_params(self.params, cfg.dtype),
            n_instances=rl.n_instances, max_slots=rl.max_slots,
            cache_len=rl.cache_len, chunk_size=rl.chunk_size,
            policy=rl.policy, spec_decode=rl.spec_decode,
            base_seed=rl.seed, fault_injector=rl.fault_injector,
            watchdog_ticks=rl.watchdog_ticks, tracer=rl.tracer,
            device=self.device)
        self.updater = WeightUpdater(self.rollout.instances)
        self.rewards = RewardWorker(task)
        self.history: List[IterStats] = []
        self.ledger = StalenessLedger(rl.staleness_bound)
        # one RolloutResult per stream (streaming mode only)
        self.stream_results: List = []

    def _sample_groups(self, it: int) -> List[Group]:
        rng = np.random.default_rng(self.rl.seed * 7919 + it)
        prompts = [self.task.sample_prompt(rng)
                   for _ in range(self.rl.n_groups)]
        return make_groups(
            prompts, self.rl.group_size,
            max_new_tokens=self.rl.max_new_tokens,
            temperature=self.rl.temperature,
            stop_token=None, seed=self.rl.seed * 131 + it,
            prefix=f"it{it}-g")

    def _train(self, batch: dict):
        """The iteration's train steps -> (loss, metrics) as floats; the
        read of the loss waits for the device."""
        loss = torch.zeros((), device=self.device)
        metrics: dict = {}
        for _ in range(self.rl.train_steps_per_iter):
            self.params, self.opt_state, loss, metrics = \
                self.train_step(self.params, self.opt_state, batch)
        return float(loss), {k: float(v) for k, v in metrics.items()}

    def run(self) -> List[IterStats]:
        if self.rl.async_overlap:
            return self._run_stream()
        return self._run_sync()

    def _run_sync(self) -> List[IterStats]:
        """The strict barrier loop (rollout -> train -> refresh): the
        bit-exactness oracle of the streaming mode's bound-0 gate."""
        rl = self.rl
        for it in range(rl.iterations):
            # ---- rollout (Seer) ----------------------------------------
            t0 = time.monotonic()
            groups = self._sample_groups(it)
            # fresh context/DGDS per iteration (CSTs are iteration-scoped)
            self.rollout.ctx = type(self.rollout.ctx)(
                max_gen_length=rl.cache_len)
            res = self.rollout.run(groups)
            t_roll = time.monotonic() - t0

            # ---- rewards ------------------------------------------------
            prompts, responses, logprobs = {}, {}, {}
            for g in groups:
                for r in g.requests:
                    prompts[r.req_id] = r.prompt
                    responses[r.req_id] = r.generated
                    logprobs[r.req_id] = r.logprobs
                    self.rewards.submit(r.req_id, r.prompt, r.generated)
            rewards = self.rewards.collect()

            # ---- experience + training ----------------------------------
            t1 = time.monotonic()
            max_len = max(len(p) for p in prompts.values()) \
                + rl.max_new_tokens
            batch = pack_experience(
                self.cfg, responses, prompts, rewards, logprobs,
                rl.group_size, max_len, gcfg=self.gcfg, device=self.device)
            loss, metrics = self._train(batch)
            t_train = time.monotonic() - t1

            # ---- weight update -------------------------------------------
            t2 = time.monotonic()
            self.updater.push(self.params)
            t_upd = time.monotonic() - t2

            mean_r = float(np.mean(list(rewards.values())))
            st = IterStats(
                iteration=it, mean_reward=mean_r, loss=loss,
                rollout_seconds=t_roll, train_seconds=t_train,
                weight_update_seconds=t_upd, tokens=res.stats.tokens,
                mean_acceptance=res.stats.mean_acceptance, metrics=metrics)
            self.history.append(st)
            rl.log(f"[iter {it:3d}] reward={mean_r:.3f} loss={loss:+.4f} "
                   f"rollout={t_roll:.1f}s train={t_train:.1f}s "
                   f"acc={res.stats.mean_acceptance:.2f}")
            if rl.checkpoint_dir and rl.checkpoint_every and \
                    (it + 1) % rl.checkpoint_every == 0:
                save(f"{rl.checkpoint_dir}/it{it + 1}", self.params, it + 1)
        return self.history

    def _run_stream(self) -> List[IterStats]:
        """Bounded-staleness streaming pipeline.

        One ``run_stream`` may span several iterations: groups stream to
        the reward workers as they finish; when every group of the
        oldest untrained iteration is in, that iteration trains — mid-
        stream if newer work is still rolling — and the fresh weights
        refresh the live instances (``rl.refresh_mode``).  At every
        bubble the next iteration's prompts are injected if the
        version-skew cap allows: iteration j enters once weights reached
        version ``j - bound``.  With ``staleness_bound=0`` injection never
        fires, every iteration gets its own barrier-shaped stream, and
        the loop is bit-exact with :meth:`_run_sync`."""
        rl = self.rl
        bound = rl.staleness_bound
        total = rl.iterations
        state = {"next": 0, "trained": 0}
        iter_groups: Dict[int, List[Group]] = {}
        unfinished: Dict[int, set] = {}
        t_start: Dict[int, float] = {}
        t_done: Dict[int, float] = {}
        reward_buf: Dict[str, float] = {}

        def iter_of(group_id: str) -> int:
            # group ids are f"it{j}-g{k}" (see _sample_groups)
            return int(group_id[2:group_id.index("-g")])

        def sample_iteration(j: int) -> List[Group]:
            gs = self._sample_groups(j)
            iter_groups[j] = gs
            unfinished[j] = {g.group_id for g in gs}
            t_start[j] = time.monotonic()
            state["next"] = j + 1
            return gs

        def train_iteration(j: int, live: bool, result=None) -> None:
            t1 = time.monotonic()
            prompts, responses, logprobs, versions = {}, {}, {}, {}
            for g in iter_groups.pop(j):
                for r in g.requests:
                    prompts[r.req_id] = r.prompt
                    responses[r.req_id] = r.generated
                    logprobs[r.req_id] = r.logprobs
                    versions[r.req_id] = r.token_versions()
            reward_buf.update(self.rewards.collect())
            rewards = {rid: reward_buf.pop(rid) for rid in responses}
            max_len = max(len(p) for p in prompts.values()) \
                + rl.max_new_tokens
            train_version = self.updater.version
            self.ledger.record(j, train_version, versions)
            batch = pack_experience(
                self.cfg, responses, prompts, rewards, logprobs,
                rl.group_size, max_len, gcfg=self.gcfg,
                token_versions=versions if bound > 0 else None,
                train_version=train_version, device=self.device)
            loss, metrics = self._train(batch)
            t_train = time.monotonic() - t1
            t2 = time.monotonic()
            self.updater.push(self.params)
            if live:
                # requests still decoding (newer iterations) survive the
                # refresh: their KV re-anchors under the new params
                self.rollout.refresh_params(
                    self.updater.params, version=self.updater.version,
                    mode=rl.refresh_mode)
            else:
                self.rollout.param_version = self.updater.version
            t_upd = time.monotonic() - t2
            stream_stats = self.rollout._stream_stats
            acc = stream_stats.mean_acceptance if live and stream_stats \
                else (result.stats.mean_acceptance if result else 0.0)
            mean_r = float(np.mean(list(rewards.values())))
            t_roll = t_done.get(j, t1) - t_start[j]
            st = IterStats(
                iteration=j, mean_reward=mean_r, loss=loss,
                rollout_seconds=t_roll, train_seconds=t_train,
                weight_update_seconds=t_upd,
                tokens=sum(len(t) for t in responses.values()),
                mean_acceptance=acc, metrics=metrics)
            self.history.append(st)
            if rl.tracer is not None:
                rl.tracer.instant(
                    "train_iteration", "train", "trainer",
                    tick=self.rollout._cur_tick, iteration=j,
                    live=live, version=self.updater.version,
                    tokens=st.tokens)
            rl.log(f"[iter {j:3d}] reward={mean_r:.3f} "
                   f"loss={loss:+.4f} rollout={t_roll:.1f}s "
                   f"train={t_train:.1f}s acc={acc:.2f}"
                   + (" (streamed)" if live else ""))
            if rl.checkpoint_dir and rl.checkpoint_every and \
                    (j + 1) % rl.checkpoint_every == 0:
                save(f"{rl.checkpoint_dir}/it{j + 1}", self.params, j + 1)

        while state["trained"] < total:
            groups = sample_iteration(state["next"])
            # fresh context per stream (iteration-scoped group state,
            # matching the sync loop)
            self.rollout.ctx = type(self.rollout.ctx)(
                max_gen_length=rl.cache_len)
            result = None
            for kind, payload in self.rollout.run_stream(groups):
                if kind == "group":
                    j = iter_of(payload.group_id)
                    unfinished[j].discard(payload.group_id)
                    if not unfinished[j]:
                        t_done[j] = time.monotonic()
                    for r in payload.requests:
                        self.rewards.submit(r.req_id, r.prompt,
                                            r.generated)
                    # train every ready iteration in order — mid-stream
                    # only while newer work keeps the stream alive
                    while state["trained"] < state["next"] \
                            and not unfinished[state["trained"]] \
                            and any(unfinished[k] for k in unfinished):
                        train_iteration(state["trained"], live=True)
                        unfinished.pop(state["trained"])
                        state["trained"] += 1
                elif kind == "bubble":
                    if state["next"] < total and \
                            self.updater.version >= state["next"] - bound:
                        self.rollout.inject(
                            sample_iteration(state["next"]))
                else:   # "result"
                    result = payload
                    self.stream_results.append(payload)
            while state["trained"] < state["next"]:
                j = state["trained"]
                if unfinished.get(j):
                    raise RuntimeError(
                        f"stream ended with iteration {j} unfinished")
                train_iteration(j, live=False, result=result)
                unfinished.pop(j, None)
                state["trained"] += 1
        return self.history
