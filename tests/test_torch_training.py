"""The port's training path against the JAX package on granite-3-8b tiny
at f32, with the reference's own weights (``init_params(cfg,
PRNGKey(1))``) carried over by the bridge: the cache-free forward,
``grpo_loss`` and every gradient leaf, AdamW (the per-layer norms'
weight decay included), the schedule, experience packing, tasks,
checkpoints read across packages, and whole trainers — the sync loop and
the bounded-staleness stream — iteration by iteration."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as jcfgs
from repro.data.tasks import make_task as jmake_task
from repro.models import forward as jforward
from repro.models import init_params as jinit_params
from repro.training import checkpoint as jckpt
from repro.training import grpo as jgrpo
from repro.training import optim as joptim
from repro.training.loop import RLConfig as JRLConfig
from repro.training.loop import RLTrainer as JRLTrainer
import repro_torch.configs as tcfgs
from repro_torch.bridge import params_from_jax, params_to_numpy, to_numpy
from repro_torch.data.tasks import make_task
from repro_torch.models import forward
from repro_torch.training import checkpoint, grpo, optim
from repro_torch.training.loop import RLConfig, RLTrainer
from test_torch_train_archs import ARCHS as TRAIN_ARCHS
from test_torch_train_archs import IDS as TRAIN_IDS
from test_torch_train_archs import arch_model, modality_inputs

torch.set_num_threads(2)
ARCH = "granite-3-8b"
# f32 on both sides: the two frameworks sum in other orders, so values
# agree to a few f32 ulps of their scale (the tolerance of
# tests/test_torch_model.py)
TOL = 1e-5
# trainer setup of tests/test_training.py (tiny granite, vocab 32, copy
# task, 3 groups x 2, 8 new tokens, 3 iterations, seed 3), at f32
RL_KW = dict(n_groups=3, group_size=2, max_new_tokens=8, iterations=3,
             n_instances=2, max_slots=2, cache_len=128, chunk_size=8,
             seed=3, log=lambda s: None)


def _cfgs(dtype="float32", vocab=None):
    kw = {"dtype": dtype}
    if vocab:
        kw["vocab_size"] = vocab
    return (dataclasses.replace(jcfgs.get_tiny_config(ARCH), **kw),
            dataclasses.replace(tcfgs.get_tiny_config(ARCH), **kw))


@pytest.fixture(scope="module")
def model():
    jcfg, tcfg = _cfgs()
    jp, _ = jinit_params(jcfg, jax.random.PRNGKey(1))
    return jcfg, tcfg, jp, jax.tree.map(np.asarray, jp)


def _port_params(tcfg, np_params):
    return params_from_jax(tcfg, np_params, device="cpu", dtype="float32")


def _masters(tcfg, np_params):
    return optim.tree_map(lambda p: p.requires_grad_(),
                          _port_params(tcfg, np_params))


def _assert_tree_close(port_tree_np, jax_tree, atol, rtol=0.0, what=""):
    flat_p = jax.tree_util.tree_leaves_with_path(port_tree_np)
    flat_j = dict(jax.tree_util.tree_leaves_with_path(jax_tree))
    assert len(flat_p) == len(flat_j)
    for path, a in flat_p:
        np.testing.assert_allclose(
            a, np.asarray(flat_j[path], np.float32), atol=atol, rtol=rtol,
            err_msg=f"{what} {jax.tree_util.keystr(path)}")


# ---------------------------------------------------------------------------
# forward, loss and gradients
# ---------------------------------------------------------------------------


# the dense model at f32 and bf16, then every other arch the reference
# trains at f32 (a MoE model's bf16 logits do not hold 3e-2 even reference
# against reference, tests/test_torch_moe.py), a hybrid also with a tail
FORWARD_CASES = [
    pytest.param(ARCH, {}, "float32", 1e-5, id="float32-1e-05"),
    pytest.param(ARCH, {}, "bfloat16", 3e-2, id="bfloat16-0.03")] + [
    pytest.param(arch, over, "float32", 1e-5, id=f"{name}-float32")
    for (arch, over), name in zip(TRAIN_ARCHS, TRAIN_IDS)]


@pytest.mark.parametrize("arch,over,dtype,tol", FORWARD_CASES)
def test_cache_free_forward_matches_jax_train_forward(model, arch, over,
                                                      dtype, tol):
    if arch == ARCH:
        _, _, _, np_params = model
        jcfg, tcfg = _cfgs(dtype)
    else:
        jcfg, tcfg, _, np_params = arch_model(arch, tuple(over.items()))
    # two whole SSD chunks on the Mamba2 archs (the reference's ssd pads
    # no ragged chunk)
    T = 2 * jcfg.ssm_chunk if jcfg.arch_type in ("ssm", "hybrid") else 40
    rng = np.random.default_rng(0)
    toks = rng.integers(0, jcfg.vocab_size, size=(2, T)).astype(np.int32)
    pos = np.broadcast_to(np.arange(T, dtype=np.int32), (2, T)).copy()
    aux_in = modality_inputs(jcfg, 2, rng)
    want, _, jaux = jforward(jcfg, jax.tree.map(jnp.asarray, np_params),
                             jnp.asarray(toks), jnp.asarray(pos),
                             aux_inputs={k: jnp.asarray(v)
                                         for k, v in aux_in.items()} or None,
                             train=True)
    got, cache, aux = forward(tcfg, _port_params(tcfg, np_params),
                              torch.from_numpy(toks), torch.from_numpy(pos),
                              aux_inputs={k: torch.from_numpy(v) for k, v in
                                          aux_in.items()} or None,
                              train=True)
    assert cache is None
    if jcfg.num_experts:
        np.testing.assert_allclose(float(aux), float(jaux), rtol=tol)
    else:
        assert aux == 0.0
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(to_numpy(got), want, atol=tol * max(
        float(np.abs(want).max()), 1.0), rtol=tol)
    with pytest.raises(NotImplementedError, match="positions 0..T-1"):
        forward(tcfg, _port_params(tcfg, np_params), torch.from_numpy(toks),
                torch.from_numpy(pos + 1))


def _batch(cfg, seed, stale=False):
    """A GRPO batch: 4 sequences of 24 tokens, responses from position 8
    (two shorter), old logprobs near the policy's so ratios straddle the
    clip range."""
    rng = np.random.default_rng(seed)
    B, S = 4, 24
    tokens = rng.integers(0, cfg.vocab_size, size=(B, S)).astype(np.int32)
    mask = np.zeros((B, S), np.float32)
    mask[:, 8:] = 1.0
    mask[1, 20:] = 0.0
    mask[3, 15:] = 0.0
    batch = {"tokens": tokens, "loss_mask": mask,
             "old_logprobs": (-np.log(cfg.vocab_size)
                              + rng.normal(0, 0.3, size=(B, S))
                              ).astype(np.float32),
             "advantages": rng.normal(size=(B,)).astype(np.float32),
             "rewards": rng.random(B).astype(np.float32)}
    if stale:
        batch["staleness"] = rng.integers(0, 3, size=(B, S)).astype(
            np.float32)
    return batch


@pytest.mark.parametrize("stale", [False, True], ids=["sync", "staleness"])
def test_grpo_loss_and_gradients_match_jax(model, stale, monkeypatch):
    jcfg, tcfg, jp, np_params = model
    gcfg = dict(max_token_staleness=1, staleness_discount=0.5) if stale \
        else {}
    batch = _batch(jcfg, seed=2, stale=stale)
    (jloss, jmet), jgrads = jax.value_and_grad(
        lambda p: jgrpo.grpo_loss(
            jcfg, p, {k: jnp.asarray(v) for k, v in batch.items()},
            gcfg=jgrpo.GRPOConfig(**gcfg)), has_aux=True)(jp)
    params = _masters(tcfg, np_params)
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    results = []
    for remat in (True, False):
        # grpo_loss always recomputes; the second pass runs its forward
        # with train=False, which keeps every activation instead
        monkeypatch.setattr(grpo, "forward", lambda *a, **kw: forward(
            *a, **{**kw, "train": remat}))
        loss, met = grpo.grpo_loss(tcfg, params, tbatch,
                                   gcfg=grpo.GRPOConfig(**gcfg))
        leaves = [t for _, t in optim.tree_items(params)]
        grads = torch.autograd.grad(loss, leaves)
        results.append((loss, met, grads))
    loss, met, grads = results[0]
    # the loss is a mean over tokens of terms of order |advantage| ~ 1
    np.testing.assert_allclose(float(loss.detach()), float(jloss), atol=TOL,
                               rtol=TOL)
    for name, v in jmet.items():
        np.testing.assert_allclose(float(met[name]), float(v), atol=TOL,
                                   rtol=TOL, err_msg=name)
    grad_tree = params_to_numpy(tcfg, optim.tree_rebuild(params, grads))
    _assert_tree_close(grad_tree, jgrads, atol=TOL, rtol=TOL, what="grad")
    # per-layer recompute changes nothing: bitwise the same loss and grads
    loss2, _, grads2 = results[1]
    assert torch.equal(loss, loss2)
    assert all(torch.equal(a, b) for a, b in zip(grads, grads2))


# ---------------------------------------------------------------------------
# optimizer, schedule, experience, tasks, checkpoints
# ---------------------------------------------------------------------------


def test_adamw_matches_jax(model):
    """One step from zero moments, then two more (the last with zero
    gradients), against the JAX optimizer: params, mu, nu, grad_norm and
    lr after each."""
    jcfg, tcfg, jp, np_params = model
    ocfg = dict(lr=1e-2, warmup_steps=1, total_steps=10)
    jstate = joptim.init_opt_state(jp)
    params = _port_params(tcfg, np_params)
    state = optim.init_opt_state(params)
    rng = np.random.default_rng(4)
    jparams = jp
    for step in range(3):
        g_np = jax.tree.map(lambda x: rng.normal(size=x.shape).astype(
            np.float32) * (0.0 if step == 2 else 1e-2), np_params)
        jparams, jstate, jm = joptim.adamw_update(
            joptim.OptConfig(**ocfg), jparams,
            jax.tree.map(jnp.asarray, g_np), jstate)
        params, state, m = optim.adamw_update(
            optim.OptConfig(**ocfg), params,
            _port_params(tcfg, g_np), state)
        np.testing.assert_allclose(float(m["grad_norm"]),
                                   float(jm["grad_norm"]), rtol=TOL)
        np.testing.assert_allclose(float(m["lr"]), float(jm["lr"]),
                                   rtol=1e-6)
        _assert_tree_close(params_to_numpy(tcfg, params), jparams,
                           atol=TOL, what=f"params, step {step}")
        _assert_tree_close(params_to_numpy(tcfg, state.mu), jstate.mu,
                           atol=TOL, what=f"mu, step {step}")
        _assert_tree_close(params_to_numpy(tcfg, state.nu), jstate.nu,
                           atol=TOL, what=f"nu, step {step}")
        assert int(state.step) == int(jstate.step) == step + 1


def test_weight_decay_alone_moves_per_layer_norms_only_where_jax_does(
        model):
    """With zero gradients AdamW's step is the decay alone.  The JAX
    package decays leaves of ndim >= 2, which takes in every per-layer
    norm (stacked (L, d)) and leaves out ``final_ln`` (d,); the port's
    per-layer ``ln`` is 1-D, and is decayed all the same."""
    jcfg, tcfg, jp, np_params = model
    cfg = dict(lr=0.1, warmup_steps=0, total_steps=10, weight_decay=0.5)
    zeros = jax.tree.map(np.zeros_like, np_params)
    jnew, _, _ = joptim.adamw_update(joptim.OptConfig(**cfg), jp,
                                     jax.tree.map(jnp.asarray, zeros),
                                     joptim.init_opt_state(jp))
    params = _port_params(tcfg, np_params)
    assert optim.decays(("layers", 0, "attn", "ln"),
                        params["layers"][0]["attn"]["ln"])
    assert not optim.decays(("final_ln",), params["final_ln"])
    params, _, _ = optim.adamw_update(optim.OptConfig(**cfg), params,
                                      _port_params(tcfg, zeros),
                                      optim.init_opt_state(params))
    for i in range(tcfg.num_layers):
        for blk in ("attn", "mlp"):
            got = to_numpy(params["layers"][i][blk]["ln"])
            assert not np.array_equal(got, np_params["layers"][blk]["ln"][i])
            np.testing.assert_allclose(
                got, np.asarray(jnew["layers"][blk]["ln"][i]), atol=TOL)
    np.testing.assert_array_equal(to_numpy(params["final_ln"]),
                                  np_params["final_ln"])
    np.testing.assert_array_equal(np.asarray(jnew["final_ln"]),
                                  np_params["final_ln"])


def test_schedule_matches_jax_across_warmup():
    kw = dict(lr=1.0, warmup_steps=10, total_steps=30, min_lr_frac=0.1)
    for step in range(0, 35):
        want = float(joptim.schedule(joptim.OptConfig(**kw),
                                     jnp.asarray(step)))
        got = float(optim.schedule(optim.OptConfig(**kw),
                                   torch.tensor(step, dtype=torch.int32)))
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7,
                                   err_msg=f"step {step}")


@pytest.mark.parametrize("versions", [False, True])
def test_pack_experience_and_advantages_equal_the_reference(versions):
    rng = np.random.default_rng(9)
    prompts, responses, logprobs, rewards, tv = {}, {}, {}, {}, {}
    for g in range(3):
        for r in range(4):
            rid = f"it0-g{g}.r{r}"
            prompts[rid] = rng.integers(3, 20, size=5).tolist()
            n = int(rng.integers(1, 9))
            responses[rid] = rng.integers(3, 20, size=n).tolist()
            logprobs[rid] = rng.normal(size=n).astype(np.float32).tolist()
            rewards[rid] = float(rng.random())
            tv[rid] = rng.integers(0, 3, size=n).tolist()
    kw = dict(token_versions=tv, train_version=2) if versions else {}
    want = jgrpo.pack_experience(None, responses, prompts, rewards,
                                 logprobs, 4, 12, **kw)
    got = grpo.pack_experience(None, responses, prompts, rewards, logprobs,
                               4, 12, device="cpu", **kw)
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]),
                                      err_msg=k)
    r = np.asarray([0.2, 0.2, 0.2, 0.2 + 1e-7, 1.0, 0.0, 0.5, 0.25])
    np.testing.assert_array_equal(grpo.group_advantages(r, 4).numpy(),
                                  np.asarray(jgrpo.group_advantages(r, 4)))


def test_tasks_give_the_reference_prompts_and_rewards():
    for name in ("copy", "sort", "succ"):
        jt = jmake_task(name, 32, prompt_len=6, response_len=8)
        tt = make_task(name, 32, prompt_len=6, response_len=8)
        r1, r2 = np.random.default_rng(5), np.random.default_rng(5)
        for _ in range(5):
            p = tt.sample_prompt(r2)
            assert p == jt.sample_prompt(r1)
            resp = r1.integers(0, 32, size=8).tolist()
            r2.integers(0, 32, size=8)
            assert tt.reward(p, resp) == jt.reward(p, resp)
            assert tt.target(p) == jt.target(p)


def test_checkpoints_cross_load(model, tmp_path):
    """A checkpoint the JAX package saves restores in the port, and the
    port's restores in the JAX package, leaf for leaf (bf16 included), on
    the dense model and then on every other arch the reference trains;
    ``params_to_numpy`` is the exact inverse of ``params_from_jax``."""
    jcfg, tcfg, jp, np_params = model
    jckpt.save(str(tmp_path / "jax"), jp, step=7)
    got, step = checkpoint.restore(str(tmp_path / "jax"), device="cpu")
    assert step == 7
    want = _port_params(tcfg, np_params)
    assert list(optim.tree_items(got)) and all(
        torch.equal(a, b) for (_, a), (_, b) in
        zip(optim.tree_items(got), optim.tree_items(want)))
    params = _port_params(tcfg, np_params)
    params["layers"][1]["mlp"]["wd"] = params["layers"][1]["mlp"][
        "wd"].to(torch.bfloat16)
    stacked_bf16 = {"embed": params["embed"].to(torch.bfloat16),
                    "final_ln": params["final_ln"]}
    checkpoint.save(str(tmp_path / "port"), params, step=3)
    checkpoint.save(str(tmp_path / "bf16"), stacked_bf16, step=1)
    jgot, jstep = jckpt.restore(str(tmp_path / "port"))
    assert jstep == 3
    want_np = params_to_numpy(tcfg, params)
    _assert_tree_close(want_np, jgot, atol=0.0, what="port -> jax")
    jb, _ = jckpt.restore(str(tmp_path / "bf16"))
    assert jb["embed"].dtype == jnp.bfloat16
    np.testing.assert_array_equal(np.asarray(jb["embed"], np.float32),
                                  to_numpy(stacked_bf16["embed"]))
    back, _ = checkpoint.restore(str(tmp_path / "bf16"), device="cpu")
    assert torch.equal(back["embed"], stacked_bf16["embed"])
    # every other arch the reference trains, both ways: MoE experts in the
    # reference's (E, d, eff), VLM and hybrid cells stacked twice, a
    # hybrid's tail and shared block, the audio encoder and decoder
    for (arch, over), name in zip(TRAIN_ARCHS, TRAIN_IDS):
        _, acfg, ajp, anp = arch_model(arch, tuple(over.items()))
        want = _port_params(acfg, anp)
        jckpt.save(str(tmp_path / f"jax-{name}"), ajp, step=1)
        got, _ = checkpoint.restore(str(tmp_path / f"jax-{name}"),
                                    device="cpu")
        gi, wi = list(optim.tree_items(got)), list(optim.tree_items(want))
        assert [p for p, _ in gi] == [p for p, _ in wi], name
        assert all(torch.equal(a, b) for (_, a), (_, b) in zip(gi, wi)), \
            name
        checkpoint.save(str(tmp_path / f"port-{name}"), want, step=2)
        jgot, _ = jckpt.restore(str(tmp_path / f"port-{name}"))
        _assert_tree_close(params_to_numpy(acfg, want), jgot, atol=0.0,
                           what=f"{name} port -> jax")
        _assert_tree_close(params_to_numpy(acfg, want), anp, atol=0.0,
                           what=f"{name} params_to_numpy")


# ---------------------------------------------------------------------------
# whole trainers
# ---------------------------------------------------------------------------


def _record(tr):
    """Every (req_id -> generated) pair that reached the reward worker."""
    responses = {}
    orig = tr.rewards.submit

    def submit(rid, prompt, gen):
        responses[rid] = list(gen)
        return orig(rid, prompt, gen)

    tr.rewards.submit = submit
    return responses


def _task(make):
    return make("copy", 32, prompt_len=4, response_len=8, content_vocab=8)


@pytest.fixture(scope="module")
def trainer_model():
    jcfg, tcfg = _cfgs(vocab=32)
    jp, _ = jinit_params(jcfg, jax.random.PRNGKey(1))
    return jcfg, tcfg, jp, jax.tree.map(np.asarray, jp)


def _run_jax(trainer_model, **kw):
    jcfg, _, jp, _ = trainer_model
    tr = JRLTrainer(jcfg, _task(jmake_task), JRLConfig(**RL_KW, **kw),
                    params=jp)
    responses = _record(tr)
    return tr, tr.run(), responses


def _run_port(trainer_model, **kw):
    _, tcfg, _, np_params = trainer_model
    tr = RLTrainer(tcfg, _task(make_task), RLConfig(**RL_KW, **kw,
                                                    device="cpu"),
                   params=_port_params(tcfg, np_params))
    responses = _record(tr)
    return tr, tr.run(), responses


@pytest.fixture(scope="module")
def sync_runs(trainer_model):
    return _run_jax(trainer_model), _run_port(trainer_model)


def _loss_close(a, b):
    # the on-policy GRPO loss is a near-cancelling mean of terms of order
    # |advantage| ~ 1 (advantages are normalized within each group), so
    # 1e-5 relative is taken against that scale, floored at 1
    assert abs(a - b) <= 1e-5 * max(abs(a), abs(b), 1.0), (a, b)


def test_sync_trainer_matches_reference(sync_runs, trainer_model):
    (jtr, jhist, jresp), (ttr, thist, tresp) = sync_runs
    assert tresp == jresp
    assert len(thist) == len(jhist) == 3
    for j, t in zip(jhist, thist):
        assert (t.iteration, t.tokens, t.mean_reward) == \
            (j.iteration, j.tokens, j.mean_reward)
        _loss_close(t.loss, j.loss)
        for name in ("pg_loss", "mean_ratio", "clip_frac", "mean_adv"):
            assert abs(t.metrics[name] - j.metrics[name]) <= \
                1e-5 * max(abs(j.metrics[name]), 1.0), name
        np.testing.assert_allclose(t.metrics["grad_norm"],
                                   j.metrics["grad_norm"], rtol=TOL)
        np.testing.assert_allclose(t.metrics["lr"], j.metrics["lr"],
                                   rtol=1e-6)
    _, tcfg, _, _ = trainer_model
    _assert_tree_close(params_to_numpy(tcfg, ttr.params),
                       jax.tree.map(np.asarray, jtr.params), atol=TOL,
                       what="trained params")
    # the rollout decodes under the pushed serving copy, not the masters
    inst = ttr.rollout.instances[0]
    assert inst.params is ttr.updater.params
    assert not any(t.requires_grad
                   for _, t in optim.tree_items(inst.params))
    assert ttr.updater.version == 3


def test_stream_bound0_is_the_sync_loop_bitwise(sync_runs, trainer_model):
    _, (_, thist, tresp) = sync_runs
    tr, hist, resp = _run_port(trainer_model, async_overlap=True,
                               staleness_bound=0)
    assert resp == tresp
    assert [h.loss for h in hist] == [h.loss for h in thist]
    assert [h.mean_reward for h in hist] == [h.mean_reward for h in thist]
    assert [h.tokens for h in hist] == [h.tokens for h in thist]
    assert sum(r.stats.injected_groups for r in tr.stream_results) == 0


def test_stream_bound1_matches_reference(trainer_model):
    jtr, jhist, jresp = _run_jax(trainer_model, async_overlap=True,
                                 staleness_bound=1)
    ttr, thist, tresp = _run_port(trainer_model, async_overlap=True,
                                  staleness_bound=1)
    assert tresp == jresp
    assert ttr.ledger.per_iteration == jtr.ledger.per_iteration
    assert 0 < ttr.ledger.max_staleness <= 1
    assert ttr.ledger.total_tokens(1) > 0
    for j, t in zip(jhist, thist):
        assert (t.iteration, t.tokens, t.mean_reward) == \
            (j.iteration, j.tokens, j.mean_reward)
        _loss_close(t.loss, j.loss)
    stats = [r.stats for r in ttr.stream_results]
    assert sum(s.injected_groups for s in stats) > 0
    assert sum(s.refreshes for s in stats) > 0


def test_trainer_and_cli_refuse_the_cpu_unless_asked(trainer_model):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the trainer uses it")
    from repro_torch.launch import train
    _, tcfg, _, _ = trainer_model
    with pytest.raises(RuntimeError, match="device='cpu'"):
        RLTrainer(tcfg, _task(make_task), RLConfig(**RL_KW))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train.main(["--iterations", "1"])


def test_train_cli_runs_on_the_cpu(tmp_path, capsys):
    import json
    from repro_torch.launch import train
    out = tmp_path / "hist.json"
    train.main(["--iterations", "2", "--groups", "2", "--group-size", "2",
                "--max-new-tokens", "4", "--train-steps", "1", "--device",
                "cpu", "--out", str(out)])
    summary = json.loads(out.read_text())["summary"]
    assert summary["device"] == "cpu" and summary["arch"] == ARCH
    assert len(json.loads(out.read_text())["history"]) == 2
