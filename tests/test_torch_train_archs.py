"""Training of every arch the reference trains, in the port against the
JAX package at f32 on tiny configs with the reference's weights
(``init_params(cfg, PRNGKey(1))`` through the bridge): ``grpo_loss``,
its metrics (the MoE router's ``aux_loss`` among them) and every
gradient leaf against ``jax.grad`` of the reference's ``grpo_loss``,
here on the MoE archs (moonshot, mixtral, deepseek).  The helpers serve
tests/test_torch_train_modal.py too, which runs them on SSM (mamba2),
hybrid (zamba2, also with a tail of blocks past its last cell), VLM and
audio models, whose batches carry seeded ``image_embeds`` /
``audio_frames``, and ``make_train_step`` (one AdamW step) there."""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as jcfgs
from repro.models import init_params as jinit_params
from repro.training import grpo as jgrpo
from repro.training import optim as joptim
import repro_torch.configs as tcfgs
from repro_torch.bridge import params_from_jax, params_to_numpy
from repro_torch.training import grpo, optim
from repro_torch.training.loop import make_train_step

torch.set_num_threads(2)
# f32 on both sides, summed in other orders: 1e-5 of each value's scale
# (MoE outputs and their gradients reach ~100, tests/test_torch_moe.py)
TOL = 1e-5
# (arch, config overrides): a hybrid with one whole cell and a tail
ARCHS = [("moonshot-v1-16b-a3b", {}), ("mixtral-8x7b", {}),
         ("deepseek-moe-16b", {}), ("mamba2-370m", {}), ("zamba2-1.2b", {}),
         ("zamba2-1.2b", {"num_layers": 3, "hybrid_attn_every": 2}),
         ("llama-3.2-vision-11b", {}), ("whisper-tiny", {})]
IDS = ["moonshot", "mixtral", "deepseek", "mamba2", "zamba2", "zamba2-tail",
       "vlm", "whisper"]


@functools.lru_cache(maxsize=None)
def arch_model(arch, overrides=()):
    """(jcfg, tcfg, reference params, the same as numpy) at f32."""
    kw = dict(overrides, dtype="float32")
    jcfg = dataclasses.replace(jcfgs.get_tiny_config(arch), **kw)
    tcfg = dataclasses.replace(tcfgs.get_tiny_config(arch), **kw)
    jp, _ = jinit_params(jcfg, jax.random.PRNGKey(1))
    return jcfg, tcfg, jp, jax.tree.map(np.asarray, jp)


def modality_inputs(cfg, B, rng):
    """Seeded image embeddings or audio frames for a batch of B rows."""
    if cfg.arch_type == "vlm":
        return {"image_embeds": rng.normal(size=(
            B, cfg.num_image_tokens, cfg.d_model)).astype(np.float32)}
    if cfg.arch_type == "audio":
        return {"audio_frames": rng.normal(size=(
            B, cfg.num_audio_frames, cfg.d_model)).astype(np.float32)}
    return {}


def _batch(cfg, seed):
    """A GRPO batch of 4 sequences of 24 tokens (responses from position
    8, two shorter), old logprobs near the policy's, and the arch's
    modality inputs."""
    rng = np.random.default_rng(seed)
    B, S = 4, 24
    mask = np.zeros((B, S), np.float32)
    mask[:, 8:] = 1.0
    mask[1, 20:] = 0.0
    mask[3, 15:] = 0.0
    batch = {"tokens": rng.integers(0, cfg.vocab_size, size=(B, S)).astype(
                 np.int32),
             "loss_mask": mask,
             "old_logprobs": (-np.log(cfg.vocab_size)
                              + rng.normal(0, 0.3, size=(B, S))
                              ).astype(np.float32),
             "advantages": rng.normal(size=(B,)).astype(np.float32),
             "rewards": rng.random(B).astype(np.float32)}
    batch.update(modality_inputs(cfg, B, rng))
    return batch


def _close(a, b, what):
    b = np.asarray(b, np.float32)
    scale = max(float(np.abs(b).max()), 1.0)
    np.testing.assert_allclose(np.asarray(a, np.float32), b, rtol=TOL,
                               atol=TOL * scale, err_msg=what)


def assert_tree_close(port_tree_np, jax_tree, what=""):
    flat_p = jax.tree_util.tree_leaves_with_path(port_tree_np)
    flat_j = dict(jax.tree_util.tree_leaves_with_path(jax_tree))
    assert len(flat_p) == len(flat_j) and \
        jax.tree.structure(port_tree_np) == jax.tree.structure(
            jax.tree.map(np.asarray, jax_tree))
    for path, a in flat_p:
        _close(a, flat_j[path], f"{what} {jax.tree_util.keystr(path)}")


def _masters(tcfg, np_params):
    return optim.tree_map(lambda p: p.requires_grad_(),
                          params_from_jax(tcfg, np_params, device="cpu",
                                          dtype="float32"))


@functools.lru_cache(maxsize=None)
def jax_loss_and_grads(arch, overrides=()):
    """The reference's (loss, metrics) and gradient on ``_batch(cfg, 2)``,
    and the batch."""
    jcfg, _, jp, _ = arch_model(arch, overrides)
    batch = _batch(jcfg, seed=2)
    (jloss, jmet), jgrads = jax.value_and_grad(
        lambda p: jgrpo.grpo_loss(
            jcfg, p, {k: jnp.asarray(v) for k, v in batch.items()}),
        has_aux=True)(jp)
    return jloss, jmet, jgrads, batch


def check_grpo_gradients(arch, over):
    """``grpo_loss``, its metrics and every gradient leaf of the port
    against the reference's on one arch."""
    jcfg, tcfg, jp, np_params = arch_model(arch, tuple(over.items()))
    jloss, jmet, jgrads, batch = jax_loss_and_grads(arch,
                                                    tuple(over.items()))
    params = _masters(tcfg, np_params)
    loss, met = grpo.grpo_loss(tcfg, params, {
        k: torch.from_numpy(v) for k, v in batch.items()})
    leaves = [t for _, t in optim.tree_items(params)]
    grads = torch.autograd.grad(loss, leaves)
    _close(float(loss.detach()), float(jloss), "loss")
    assert sorted(met) == sorted(jmet)
    for name, v in jmet.items():
        _close(float(met[name]), float(v), name)
    if jcfg.num_experts:
        assert float(met["aux_loss"]) > 0.0
    else:
        assert float(met["aux_loss"]) == 0.0
    grad_tree = params_to_numpy(tcfg, optim.tree_rebuild(params, grads))
    assert_tree_close(grad_tree, jgrads, what="grad")
    assert all(float(g.abs().max()) > 0 for g in grads), \
        "a parameter leaf got no gradient"


@pytest.mark.parametrize("arch,over", ARCHS[:3], ids=IDS[:3])
def test_grpo_loss_and_gradients_match_jax(arch, over):
    check_grpo_gradients(arch, over)


def check_train_step(arch):
    """``make_train_step`` (loss, gradient, AdamW at the trainer's default
    schedule, whose first step's rate is 3e-6) on a batch that carries the
    modality inputs, against the reference's ``grpo_loss`` gradient and
    AdamW step; without them the forward refuses, as the reference
    asserts."""
    from repro_torch.models import forward
    jcfg, tcfg, jp, np_params = arch_model(arch)
    _, _, jgrads, batch = jax_loss_and_grads(arch)
    jnew, _, jm = joptim.adamw_update(joptim.OptConfig(), jp, jgrads,
                                      joptim.init_opt_state(jp))
    params = _masters(tcfg, np_params)
    step = make_train_step(tcfg, grpo.GRPOConfig(), optim.OptConfig())
    params, _, loss, m = step(params, optim.init_opt_state(params),
                              {k: torch.from_numpy(v)
                               for k, v in batch.items()})
    assert np.isfinite(float(loss))
    _close(float(m["grad_norm"]), float(jm["grad_norm"]), "grad_norm")
    assert_tree_close(params_to_numpy(tcfg, params), jnew, what="params")
    toks = torch.from_numpy(batch["tokens"])
    pos = torch.arange(toks.shape[1], dtype=torch.int32).expand_as(toks)
    with pytest.raises(ValueError, match="aux_inputs"):
        forward(tcfg, params, toks, pos)
