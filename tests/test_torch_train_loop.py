"""The port's sync ``RLTrainer`` on the archs it newly trains, against the
reference's ``RLTrainer`` on the same weights at f32 (tiny configs at
vocab 32, so that rewards differ within a group; tests/
test_torch_training.py's setup at 2 iterations): MoE (moonshot: the
router's aux loss in every loss) and SSM (mamba2: K4's backward's plain
version in every train step).  Responses and rewards exact, losses and
grad norms within 1e-5 of scale, trained parameters at the trainer
tolerance.  VLM and audio models: the port's trainer refuses them, and
the reference's fails at its first train step (its experience batch
carries no modality inputs), which a cheap reference run shows."""
import dataclasses

import jax
import numpy as np
import pytest
import torch

import repro.configs as jcfgs
from repro.data.tasks import make_task as jmake_task
from repro.models import init_params as jinit_params
from repro.training.loop import RLConfig as JRLConfig
from repro.training.loop import RLTrainer as JRLTrainer
import repro_torch.configs as tcfgs
from repro_torch.bridge import params_from_jax, params_to_numpy
from repro_torch.data.tasks import make_task
from repro_torch.training.loop import RLConfig, RLTrainer
from test_torch_training import RL_KW, TOL, _loss_close, _record, _task

torch.set_num_threads(2)
ITERS = 2


def _models(arch):
    kw = dict(dtype="float32", vocab_size=32)
    jcfg = dataclasses.replace(jcfgs.get_tiny_config(arch), **kw)
    tcfg = dataclasses.replace(tcfgs.get_tiny_config(arch), **kw)
    jp, _ = jinit_params(jcfg, jax.random.PRNGKey(1))
    return jcfg, tcfg, jp


@pytest.mark.parametrize("arch", ["moonshot-v1-16b-a3b", "mamba2-370m"],
                         ids=["moonshot", "mamba2"])
def test_sync_trainer_matches_reference(arch):
    jcfg, tcfg, jp = _models(arch)
    kw = dict(RL_KW, iterations=ITERS)
    jtr = JRLTrainer(jcfg, _task(jmake_task), JRLConfig(**kw), params=jp)
    jresp = _record(jtr)
    jhist = jtr.run()
    ttr = RLTrainer(tcfg, _task(make_task), RLConfig(**kw, device="cpu"),
                    params=params_from_jax(tcfg, jax.tree.map(np.asarray, jp),
                                           device="cpu", dtype="float32"))
    tresp = _record(ttr)
    thist = ttr.run()
    assert tresp == jresp
    assert len(thist) == len(jhist) == ITERS
    for j, t in zip(jhist, thist):
        assert (t.iteration, t.tokens, t.mean_reward) == \
            (j.iteration, j.tokens, j.mean_reward)
        _loss_close(t.loss, j.loss)
        for name in ("pg_loss", "aux_loss", "mean_ratio", "clip_frac",
                     "mean_adv"):
            assert abs(t.metrics[name] - j.metrics[name]) <= \
                1e-5 * max(abs(j.metrics[name]), 1.0), name
        np.testing.assert_allclose(t.metrics["grad_norm"],
                                   j.metrics["grad_norm"], rtol=TOL)
        assert t.metrics["grad_norm"] > 0
        assert (t.metrics["aux_loss"] > 0) == bool(tcfg.num_experts)
    assert any(h.metrics["mean_adv"] != 0 or h.loss != 0 for h in thist)
    got = params_to_numpy(tcfg, ttr.params)
    want = jax.tree.map(np.asarray, jtr.params)
    assert jax.tree.structure(got) == jax.tree.structure(want)
    for (path, a), b in zip(jax.tree_util.tree_leaves_with_path(got),
                            jax.tree.leaves(want)):
        np.testing.assert_allclose(a, b, atol=TOL,
                                   err_msg=jax.tree_util.keystr(path))
    assert ttr.updater.version == ITERS


@pytest.mark.parametrize("arch", ["llama-3.2-vision-11b", "whisper-tiny"],
                         ids=["vlm", "whisper"])
def test_trainer_refuses_vlm_and_audio_as_the_reference_fails(arch):
    """The port's trainer refuses, saying why; the reference's (1 group x
    2, 4 tokens) raises its forward's AssertionError at the first train
    step.  If the reference starts to train them, this test says so."""
    jcfg, tcfg, jp = _models(arch)
    with pytest.raises(NotImplementedError, match="image_embeds or "
                       "audio_frames"):
        RLTrainer(tcfg, _task(make_task), RLConfig(**RL_KW, device="cpu"))
    kw = dict(RL_KW, n_groups=1, group_size=2, max_new_tokens=4,
              iterations=1)
    jtr = JRLTrainer(jcfg, _task(jmake_task), JRLConfig(**kw), params=jp)
    with pytest.raises(AssertionError):
        jtr.run()


def test_train_cli_takes_the_new_archs(tmp_path):
    """``launch/train.py`` trains an SSM, a hybrid and a MoE tiny config
    with no new flag; a VLM config is refused."""
    import json
    from repro_torch.launch import train
    for arch in ("mamba2-370m", "zamba2-1.2b", "deepseek-moe-16b"):
        out = tmp_path / f"{arch}.json"
        train.main(["--arch", arch, "--iterations", "1", "--groups", "1",
                    "--group-size", "2", "--max-new-tokens", "4",
                    "--train-steps", "1", "--device", "cpu", "--out",
                    str(out)])
        rep = json.loads(out.read_text())
        assert rep["summary"]["arch"] == arch
        assert np.isfinite(rep["history"][0]["loss"])
    with pytest.raises(NotImplementedError):
        train.main(["--arch", "llama-3.2-vision-11b", "--iterations", "1",
                    "--device", "cpu"])
