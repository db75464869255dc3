"""GRPO — Group Relative Policy Optimization: group advantages, the
clipped-surrogate loss and the packing of rollout outputs into a batch.

Counterpart of ``repro.training.grpo``.  For each prompt, G responses are
sampled from the rollout policy; rewards are normalized *within the
group* to get advantages:

    A_i = (r_i - mean(r_group)) / (std(r_group) + eps)

The policy loss is the clipped PPO surrogate per token, using the
rollout logprobs as the old policy.  The forward is the cache-free one
(K3, and K4 with its backward, on the card), each layer recomputed in
the backward.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models.common import token_logprobs
from repro_torch.models.transformer import forward


@dataclass(frozen=True)
class GRPOConfig:
    clip_eps: float = 0.2
    kl_coef: float = 0.0           # optional KL-to-old penalty
    aux_coef: float = 0.01         # MoE router load-balance coefficient
    adv_eps: float = 1e-4
    normalize_std: bool = True     # GRPO normalizes by group std
    # bounded-staleness corrections (streamed overlap mode); both engage
    # only when the batch carries "staleness", so sync batches are
    # untouched: tokens with staleness > max_token_staleness leave the
    # loss, and each token's weight is staleness_discount ** staleness
    max_token_staleness: Optional[int] = None
    staleness_discount: float = 1.0


def group_advantages(rewards, group_size: int,
                     cfg: GRPOConfig = GRPOConfig()) -> torch.Tensor:
    """rewards: (B,) with B = n_groups * group_size, group-major order ->
    (B,) float32 on the CPU.  Normalized on the host in float64, as the
    reference does: the (r - mean)/std cancellation is precision-critical
    when a group's rewards are nearly constant."""
    r = np.asarray(rewards, np.float64).reshape(-1, group_size)
    mean = r.mean(axis=1, keepdims=True)
    adv = r - mean
    if cfg.normalize_std:
        adv = adv / (r.std(axis=1, keepdims=True) + cfg.adv_eps)
    return torch.from_numpy(adv.reshape(-1).astype(np.float32))


def grpo_loss(cfg: ModelConfig, params, batch: dict, *,
              gcfg: GRPOConfig = GRPOConfig(), sctx=None):
    """batch: tokens (B,S) int32, loss_mask (B,S) f32 (1 on response
    tokens), advantages (B,) f32, old_logprobs (B,S) f32, optionally
    staleness (B,S) f32 and a VLM's ``image_embeds`` (B,Tm,d) or an
    audio model's ``audio_frames`` (B,Tf,d), which go to the forward as
    ``aux_inputs``.  -> (loss, metrics), metrics detached.

    tokens[:, t] predicts tokens[:, t+1]; loss_mask marks *predicted*
    positions (shifted alignment done here).  A MoE model's loss adds
    ``gcfg.aux_coef`` times the router's load-balance loss
    (``metrics["aux_loss"]``).  Each layer is recomputed in the
    backward, as the JAX package's ``train=True`` forward does.
    ``sctx``: the production layout's context, passed to the forward
    (``params`` are then this rank's ``launch.steps.param_shards``; the
    logits come back whole on the model group).  With the data axes over
    ranks, ``batch`` holds this rank's rows (``launch.steps.batch_shards``,
    their span under ``launch.steps.BATCH_SPAN``): the loss's sums — the
    mask's (``denom``), the surrogate's, the KL term's and the metrics'
    — are summed over the data-parallel group (one all-reduce, whose
    backward is the identity), so the loss and metrics are those of the
    whole batch on every rank; ``mean_adv`` too.  A batch without a span
    is whole on every rank, and nothing is summed."""
    from repro_torch.launch.steps import BATCH_SPAN, rows_ctx
    if sctx is not None:
        sctx = rows_ctx(sctx, batch)
    tokens = batch["tokens"]
    mask = batch["loss_mask"][:, 1:]
    adv = batch["advantages"][:, None]
    old_lp = batch["old_logprobs"][:, 1:]
    if "staleness" in batch:
        stale = batch["staleness"][:, 1:].float()
        if gcfg.max_token_staleness is not None:
            mask = mask * (stale <= gcfg.max_token_staleness)
        if gcfg.staleness_discount != 1.0:
            mask = mask * torch.pow(gcfg.staleness_discount, stale)

    aux_inputs = {k: v for k, v in batch.items()
                  if k in ("image_embeds", "audio_frames")}
    B, S = tokens.shape
    positions = torch.arange(S, dtype=torch.int32,
                             device=tokens.device).expand(B, S)
    logits, _, aux = forward(cfg, params, tokens, positions,
                             aux_inputs=aux_inputs or None, sctx=sctx,
                             train=True)
    lp = token_logprobs(logits[:, :-1], tokens[:, 1:])      # (B,S-1)

    ratio = torch.exp(lp - old_lp)
    clipped = torch.clamp(ratio, 1.0 - gcfg.clip_eps, 1.0 + gcfg.clip_eps)
    pg = -torch.minimum(ratio * adv, clipped * adv)
    zero = torch.zeros((), device=tokens.device)
    kl = zero
    if gcfg.kl_coef:
        kl = (((torch.exp(old_lp - lp) - 1.0) - (old_lp - lp)) * mask).sum()
    with torch.no_grad():
        seen = [(ratio * mask).sum(),
                ((torch.abs(ratio - 1.0) > gcfg.clip_eps) * mask).sum(),
                adv.sum()]
    sums = _global_sums([mask.sum(), (pg * mask).sum(), kl] + seen, sctx)
    denom = torch.clamp(sums[0], min=1.0)
    loss = sums[1] / denom
    if gcfg.kl_coef:
        loss = loss + gcfg.kl_coef * sums[2] / denom
    if cfg.num_experts:
        loss = loss + gcfg.aux_coef * aux
    span = batch.get(BATCH_SPAN)
    rows = int(span[2]) if span is not None and sctx is not None \
        and sctx.dp_group is not None else B
    with torch.no_grad():
        metrics = {
            "pg_loss": sums[1] / denom,
            "aux_loss": zero + aux,
            "mean_ratio": sums[3] / denom,
            "clip_frac": sums[4] / denom,
            "mean_adv": sums[5] / rows,
        }
    return loss, metrics


def _global_sums(terms: list, sctx) -> torch.Tensor:
    """The loss's per-rank sums, stacked and summed over the data-parallel
    group (``sharding.dp_sum``: one all-reduce; the gradient passes to
    each rank's terms as it is)."""
    from repro_torch import sharding
    return sharding.dp_sum(torch.stack(terms), sctx)


def pack_experience(cfg: ModelConfig, responses: dict, prompts: dict,
                    rewards: dict, logprobs: dict, group_size: int,
                    max_len: int, *, gcfg: GRPOConfig = GRPOConfig(),
                    pad_id: int = 0,
                    token_versions: Optional[dict] = None,
                    train_version: int = 0,
                    device: DeviceLike = None) -> dict:
    """Build a fixed-shape training batch from rollout outputs, on
    ``device``.

    responses/prompts/logprobs keyed by req_id; req order must be
    group-major (g0.r0, g0.r1, ..., g1.r0, ...).  ``token_versions``
    (req_id -> per-token weight versions, from the rollout's staleness
    ledger) adds a per-token ``staleness`` plane (``train_version -
    version``) that engages the GRPOConfig staleness knobs; omitted (the
    sync path), the batch has no such key."""
    dev = resolve_device(device)
    rids = sorted(responses, key=lambda k: (k.split(".r")[0],
                                            int(k.split(".r")[1])))
    B = len(rids)
    tokens = np.full((B, max_len), pad_id, np.int32)
    mask = np.zeros((B, max_len), np.float32)
    old_lp = np.zeros((B, max_len), np.float32)
    stale = np.zeros((B, max_len), np.float32)
    rew = np.zeros((B,), np.float32)
    for i, rid in enumerate(rids):
        seq = list(prompts[rid]) + list(responses[rid])
        seq = seq[:max_len]
        np_len = min(len(prompts[rid]), max_len)
        tokens[i, :len(seq)] = seq
        mask[i, np_len:len(seq)] = 1.0
        lp = list(logprobs[rid])[:max(0, max_len - np_len)]
        old_lp[i, np_len:np_len + len(lp)] = lp
        if token_versions is not None:
            vs = list(token_versions.get(rid, []))[:max(0, max_len - np_len)]
            stale[i, np_len:np_len + len(vs)] = \
                [max(0, train_version - v) for v in vs]
        rew[i] = rewards[rid]
    adv = group_advantages(rew, group_size, gcfg)
    batch = {"tokens": tokens, "loss_mask": mask, "old_logprobs": old_lp,
             "advantages": adv.numpy(), "rewards": rew}
    if token_versions is not None:
        batch["staleness"] = stale
    return {k: torch.from_numpy(v).to(dev) for k, v in batch.items()}
