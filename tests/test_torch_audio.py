"""The port's audio serving path against the JAX package on the CPU, on
whisper-tiny tiny with the reference's weights: the init tree (encoder
and decoder layers) and the bridge, the zero frontend stub, the
bidirectional encoder (``encode_audio``: non-causal self-attention at
positions 0..Tf-1, RoPE included), ``_cross_attn`` and
``build_cross_cache`` (through the encoder) at f32 (1e-5) and bf16
(3e-2), ``forward`` logits and caches at f32 (1e-5) and, in bf16,
sub-layer by sub-layer (3e-2); then, at f32 on seeded random audio
frames, token-exact ``Instance`` runs in the linear and sync modes, tree
mode with branching draft trees, the fused tree and linear steps against
the sync oracle from a snapshot (bitwise), KV blobs carrying the
encoder's memory both ways under batched and per-slot migration, and a
token-exact ``SeerRollout`` on the zero stub in both speculation
modes."""
import pytest
import torch

from _torch_rec import (MODEL_TOL, blobs_cross, both,
                        build_cross_cache_matches, close, cross_attn_matches,
                        cross_sublayers, forward_layers_match_bf16,
                        forward_matches,
                        fused_tree_vs_sync, fused_vs_sync, init_tree_matches,
                        load_models, modality_stub_matches, model_pair,
                        random_embeds, rollout_matches, run_side_by_side,
                        tree_side_by_side)
from repro.models import encode_audio as jencode_audio
from repro_torch.models.transformer import encode_audio

torch.set_num_threads(2)
ARCH = "whisper-tiny"
DTYPES = ["float32", "bfloat16"]


@pytest.fixture(scope="module")
def models():
    cache = {}

    def get(dtype):
        if dtype not in cache:
            cache[dtype] = model_pair(ARCH, dtype)
        return cache[dtype]
    return get


@pytest.fixture(scope="module")
def m():
    return load_models(ARCH)


def test_init_tree_matches_the_reference(models):
    """``encoder_layers`` dense layers and decoder layers of
    self-attention, a cross block and an MLP."""
    mp = models("bfloat16")
    params = init_tree_matches(mp)
    assert len(params["enc_layers"]) == mp.tcfg.encoder_layers
    assert [sorted(p) for p in params["dec_layers"]] == \
        [["attn", "cross", "mlp"]] * mp.tcfg.num_layers


def test_modality_stub_matches_the_reference(models):
    modality_stub_matches(models("bfloat16"), "audio_frames")


@pytest.mark.parametrize("dtype", DTYPES)
def test_encoder_matches(models, dtype):
    """The bidirectional encoder over seeded frames; each frame's output
    depends on later frames (non-causal)."""
    mp = models(dtype)
    jf, tf = both(random_embeds(mp.tcfg, 2, seed=3), dtype)
    got = encode_audio(mp.tcfg, mp.tp, tf)
    assert got.dtype == tf.dtype and got.shape == tf.shape
    close(got, jencode_audio(mp.jcfg, mp.jp, jf), MODEL_TOL[dtype])
    late = tf.clone()
    late[:, -1] += 1
    assert not torch.equal(encode_audio(mp.tcfg, mp.tp, late)[:, 0],
                           got[:, 0])


@pytest.mark.parametrize("dtype", DTYPES)
def test_cross_attn_matches(models, dtype):
    cross_attn_matches(models(dtype), dtype)


@pytest.mark.parametrize("dtype", DTYPES)
def test_build_cross_cache_matches(models, dtype):
    build_cross_cache_matches(models(dtype), dtype)


def test_forward_matches_f32(models):
    forward_matches(models("float32"), "float32")


def test_forward_layers_match_bf16(models):
    m = models("bfloat16")
    forward_layers_match_bf16(m, cross_sublayers(m))


@pytest.mark.parametrize("temp", [0.0, 1.0])
@pytest.mark.parametrize("mode", ["linear", "sync"])
def test_instances_token_exact(m, mode, temp):
    kw = {"linear": {}, "sync": {"prefill_mode": "sync"}}[mode]
    port = run_side_by_side(m, temp,
                            syncs_per_step=2 if mode == "sync" else 1, **kw)
    # the instance's memory was built from the frames, not the stub
    assert port.cache["cross_k"].abs().max() > 0


@pytest.mark.parametrize("temp", [0.0, 1.0])
def test_tree_instances_token_exact(m, temp):
    tree_side_by_side(m, temp)


def test_fused_tree_step_equals_sync_oracle(m):
    assert fused_tree_vs_sync(m) > 0


def test_fused_linear_step_equals_sync_oracle(m):
    steps, replays = fused_vs_sync(m, "linear")
    assert steps > 5 and replays == 0


@pytest.mark.parametrize("migration_mode", ["batched", "perslot"])
def test_blobs_cross_both_ways(m, migration_mode):
    blobs_cross(m, 1.0, migration_mode)


@pytest.mark.parametrize("spec_mode", ["linear", "tree"])
def test_rollout_token_exact(m, spec_mode):
    """``SeerRollout`` passes no frames: both packages serve on the zero
    stub, which the encoder maps to zero memory (no bias, and RMSNorm of
    zeros is zero)."""
    tro = rollout_matches(m, 1.0, spec_mode=spec_mode)
    assert tro.tree_branching == (spec_mode == "tree")
    for inst in tro.instances:
        assert not inst.cache["cross_k"].any()
