"""The port's MoE serving path against the JAX package on the CPU, at
f32 on moonshot-v1-16b-a3b tiny (a first dense layer, a shared expert)
and mixtral-8x7b tiny (a 64-slot ring cache), with the reference's
weights: token-exact ``Instance`` runs in the linear and sync modes with
accepted and rejected drafts, tree mode with branching draft trees (the
MoE model is attention-only, so its trees branch as a dense model's
do), the fused tree and linear steps against the sync oracle from a
snapshot of the same instance (bitwise), KV blobs crossing both ways,
and a token-exact ``SeerRollout`` in both speculation modes."""
import pytest
import torch

from _torch_rec import (blobs_cross, fused_tree_vs_sync, fused_vs_sync,
                        load_models, rollout_matches, run_side_by_side,
                        tree_side_by_side)

torch.set_num_threads(2)
ARCHS = ["moonshot-v1-16b-a3b", "mixtral-8x7b"]


@pytest.fixture(scope="module")
def models():
    cache = {}

    def get(arch):
        if arch not in cache:
            cache[arch] = load_models(arch)
        return cache[arch]
    return get


@pytest.mark.parametrize("temp", [0.0, 1.0])
@pytest.mark.parametrize("mode", ["linear", "sync"])
@pytest.mark.parametrize("arch", ARCHS)
def test_instances_token_exact(models, arch, mode, temp):
    kw = {"linear": {}, "sync": {"prefill_mode": "sync"}}[mode]
    port = run_side_by_side(models(arch), temp,
                            syncs_per_step=2 if mode == "sync" else 1, **kw)
    assert port.steps.replays == 0


@pytest.mark.parametrize("temp", [0.0, 1.0])
@pytest.mark.parametrize("arch", ARCHS)
def test_tree_instances_token_exact(models, arch, temp):
    tree_side_by_side(models(arch), temp)


@pytest.mark.parametrize("arch", ARCHS)
def test_fused_tree_step_equals_sync_oracle(models, arch):
    assert fused_tree_vs_sync(models(arch)) > 0


def test_fused_linear_step_equals_sync_oracle(models):
    steps, replays = fused_vs_sync(models("moonshot-v1-16b-a3b"), "linear")
    assert steps > 5 and replays == 0


@pytest.mark.parametrize("migration_mode", ["batched", "perslot"])
@pytest.mark.parametrize("arch", ARCHS)
def test_blobs_cross_both_ways(models, arch, migration_mode):
    blobs_cross(models(arch), 1.0, migration_mode)


@pytest.mark.parametrize("spec_mode", ["linear", "tree"])
def test_rollout_token_exact(models, spec_mode):
    tro = rollout_matches(models("moonshot-v1-16b-a3b"), 1.0,
                          spec_mode=spec_mode)
    assert tro.tree_branching == (spec_mode == "tree")
