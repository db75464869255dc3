"""Training of the SSM, hybrid, VLM and audio archs in the port against
the JAX package at f32 on tiny configs with the reference's weights:
``grpo_loss``, its metrics and every gradient leaf against ``jax.grad``
of the reference's (mamba2; zamba2, also with a tail of blocks past its
last cell, the SSD gradients through K4's backward's plain version;
llama-3.2-vision and whisper on batches that carry seeded
``image_embeds`` / ``audio_frames``), and ``make_train_step`` on the
VLM and audio batches.  The helpers live in
tests/test_torch_train_archs.py (the MoE archs)."""
import pytest
import torch

from test_torch_train_archs import (ARCHS, IDS, check_grpo_gradients,
                                    check_train_step)

torch.set_num_threads(2)


@pytest.mark.parametrize("arch,over", ARCHS[3:], ids=IDS[3:])
def test_grpo_loss_and_gradients_match_jax(arch, over):
    check_grpo_gradients(arch, over)


@pytest.mark.parametrize("arch", ["llama-3.2-vision-11b", "whisper-tiny"],
                         ids=["vlm", "whisper"])
def test_train_step_on_modality_batches_matches_jax(arch):
    check_train_step(arch)
