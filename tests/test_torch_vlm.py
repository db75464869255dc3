"""The port's VLM serving path against the JAX package on the CPU, on
llama-3.2-vision-11b tiny with the reference's weights: the init tree
and the bridge, the zero frontend stub, ``_cross_attn`` (from the cache
and from the memory) and ``build_cross_cache`` at f32 (1e-5) and bf16
(3e-2), ``forward`` logits and caches at f32 (1e-5) and, in bf16,
sub-layer by sub-layer (3e-2); then, at f32 on seeded random image
embeddings, token-exact ``Instance`` runs in the linear and sync modes,
tree mode with branching draft trees, the fused tree and linear steps
against the sync oracle from a snapshot (bitwise), KV blobs carrying the
cross-attention memory both ways under batched and per-slot migration,
and a token-exact ``SeerRollout`` on the zero stub in both speculation
modes."""
import pytest
import torch

from _torch_rec import (blobs_cross, build_cross_cache_matches,
                        cross_attn_matches, cross_sublayers,
                        forward_layers_match_bf16,
                        forward_matches, fused_tree_vs_sync, fused_vs_sync,
                        init_tree_matches, load_models, modality_stub_matches,
                        model_pair, rollout_matches, run_side_by_side,
                        tree_side_by_side)

torch.set_num_threads(2)
ARCH = "llama-3.2-vision-11b"
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
    """Cells of ``cross_attn_every`` dense layers and a cross block."""
    mp = models("bfloat16")
    params = init_tree_matches(mp)
    assert len(params["cells"]) == 1
    assert len(params["cells"][0]["self"]) == mp.tcfg.cross_attn_every


def test_modality_stub_matches_the_reference(models):
    modality_stub_matches(models("bfloat16"), "image_embeds")


@pytest.mark.parametrize("dtype", DTYPES)
def test_cross_attn_matches(models, dtype):
    cross_attn_matches(models(dtype), dtype)


@pytest.mark.parametrize("dtype", DTYPES)
def test_build_cross_cache_matches(models, dtype):
    build_cross_cache_matches(models(dtype), dtype)


@pytest.mark.parametrize("cells", [1, 2])
def test_forward_matches_f32(models, cells):
    """The tiny config has one cell; two cells also check which self
    layers and which memory each cell takes."""
    mp = models("float32") if cells == 1 else model_pair(
        ARCH, "float32", num_layers=2 * cells)
    forward_matches(mp, "float32")


def test_forward_layers_match_bf16(models):
    m = models("bfloat16")
    forward_layers_match_bf16(m, cross_sublayers(m))


@pytest.mark.parametrize("temp", [0.0, 1.0])
@pytest.mark.parametrize("mode", ["linear", "sync"])
def test_instances_token_exact(m, mode, temp):
    kw = {"linear": {}, "sync": {"prefill_mode": "sync"}}[mode]
    port = run_side_by_side(m, temp,
                            syncs_per_step=2 if mode == "sync" else 1, **kw)
    # the instance's memory was built from the embeddings, not the stub
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
    """``SeerRollout`` passes no embeddings: both packages serve on the
    zero stub, whose cross blocks add exactly 0."""
    tro = rollout_matches(m, 1.0, spec_mode=spec_mode)
    assert tro.tree_branching == (spec_mode == "tree")
    for inst in tro.instances:
        assert not inst.cache["cross_k"].any()
