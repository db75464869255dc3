"""The port's hybrid (Zamba2) slice against the JAX package on the CPU,
on zamba2-1.2b tiny (one Mamba2 block per cell, a 64-slot ring cache for
the shared attention's window) and a tiny hybrid with a tail (3 blocks,
a shared-attention cell every 2): the bridge's tree (the shared block
held once, f32 conv weights), ``forward``'s logits and caches,
token-exact ``Instance`` runs in the linear, tree (chains), sync and
per-slot modes with rejected drafts replayed, the fused step against the
sync oracle from the same state (bitwise), KV blobs crossing both ways
and a token-exact ``SeerRollout``.  All at f32, with the reference's
weights."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_rec import (blobs_cross, fused_vs_sync, load_models,
                        rollout_matches, run_side_by_side)
from repro.models import forward as jforward
from repro.models import init_cache as jinit_cache
from repro_torch.bridge import cache_from_jax, to_numpy
from repro_torch.configs import get_config
from repro_torch.models import forward, init_cache, init_params

torch.set_num_threads(2)
ARCH = "zamba2-1.2b"
TAIL = dict(num_layers=3, hybrid_attn_every=2)


@pytest.fixture(scope="module")
def m():
    return load_models(ARCH)


@pytest.fixture(scope="module")
def m_tail():
    return load_models(ARCH, **TAIL)


def test_bridge_tree(m, m_tail):
    for mm, cells, every, tail in ((m, 2, 1, 0), (m_tail, 1, 2, 1)):
        tp = mm.tp
        assert len(tp["cells"]) == cells and len(tp.get("tail", [])) == tail
        assert all(len(c["ssm"]) == every for c in tp["cells"])
        blk = tp["cells"][0]["ssm"][0]
        assert blk["conv_w"].dtype == torch.float32
        np.testing.assert_array_equal(
            to_numpy(blk["conv_w"]),
            np.asarray(mm.jp["cells"]["ssm"]["conv_w"][0, 0]))
        # the shared block is held once, beside the cells, not per cell
        assert all(set(c) == {"ssm"} for c in tp["cells"])
        assert sorted(tp["shared_attn"]) == ["ln", "wk", "wo", "wq", "wv"]
        assert sorted(tp["shared_mlp"]) == ["ln", "wd", "wg", "wu"]
    # bf16 weights: matrices in bf16, conv_w and the vectors stay f32
    from dataclasses import replace
    from repro_torch.bridge import params_from_jax
    cfg = replace(m.tcfg, dtype="bfloat16")
    tp = params_from_jax(cfg, jax.tree.map(np.asarray, m.jp), device="cpu")
    blk = tp["cells"][1]["ssm"][0]
    assert blk["in_proj"].dtype == torch.bfloat16
    for name in ("conv_w", "conv_b", "A_log", "dt_bias", "D", "gn", "ln"):
        assert blk[name].dtype == torch.float32, name


def test_seeded_init_shares_the_attention_block():
    cfg = get_config(ARCH)
    from dataclasses import replace
    cfg = replace(cfg, num_layers=14, d_model=64, num_heads=2,
                  num_kv_heads=2, head_dim=32, d_ff=64, vocab_size=64,
                  ssm_state=16, ssm_head_dim=32)
    a = init_params(cfg, torch.Generator().manual_seed(1), device="cpu")
    b = init_params(cfg, torch.Generator().manual_seed(1), device="cpu")
    assert len(a["cells"]) == 2 and len(a["tail"]) == 2
    assert a["cells"][0]["ssm"][0]["conv_w"].dtype == torch.float32
    assert a["cells"][0]["ssm"][0]["in_proj"].dtype == torch.bfloat16
    assert torch.equal(a["cells"][1]["ssm"][5]["in_proj"],
                       b["cells"][1]["ssm"][5]["in_proj"])
    cache = init_cache(cfg, 2, 16, device="cpu")
    assert cache["k"].shape[0] == 2 and cache["ssm"].shape[0] == 14
    assert cache["conv"].dtype == torch.bfloat16


@pytest.mark.parametrize("which", ["tiny", "tail"])
def test_forward_logits_and_caches(m, m_tail, which):
    """Prefill chunks with padded rows, decode and verify steps through
    ``forward`` on a ring cache that wraps: logits and every cache leaf
    equal the reference's."""
    mm = m if which == "tiny" else m_tail
    B, S = 3, 24          # a ring of 24 slots (the window is 64)
    jc = jinit_cache(mm.jcfg, B, S)
    tc = cache_from_jax(mm.tcfg, jax.tree.map(np.asarray, jc), device="cpu")
    assert tc["slot_pos"].shape == (B, S)
    rng = np.random.default_rng(1)
    start = np.zeros(B, np.int64)
    for T, n in ((8, [8, 5, 0]), (8, [8, 8, 3]), (8, [8, 8, 8]),
                 (1, [1, 1, 1]), (5, [5, 2, 1])):
        toks = rng.integers(0, mm.tcfg.vocab_size, size=(B, T)).astype(
            np.int32)
        pos = (start[:, None] + np.arange(T)[None]).astype(np.int32)
        mask = np.arange(T)[None] < np.asarray(n)[:, None]
        jl, jc, _ = jforward(mm.jcfg, mm.jp, jnp.asarray(toks),
                             jnp.asarray(pos), jc,
                             token_mask=jnp.asarray(mask))
        tl, _, _ = forward(mm.tcfg, mm.tp, torch.from_numpy(toks),
                           torch.from_numpy(pos), tc,
                           token_mask=torch.from_numpy(mask))
        np.testing.assert_allclose(to_numpy(tl)[mask], np.asarray(jl)[mask],
                                   atol=1e-5, rtol=1e-5)
        for k in tc:
            np.testing.assert_allclose(to_numpy(tc[k]), np.asarray(jc[k]),
                                       atol=1e-5, rtol=1e-5, err_msg=k)
        start += np.asarray(n)
    assert start.max() > S       # the ring wrapped


@pytest.mark.parametrize("temp", [0.0, 1.0])
@pytest.mark.parametrize("mode", ["linear", "tree", "sync"])
def test_instances_token_exact(m, temp, mode):
    kw = {"linear": {}, "tree": {"spec_mode": "tree"},
          "sync": {"prefill_mode": "sync"}}[mode]
    port = run_side_by_side(m, temp, syncs_per_step=2 if mode == "sync"
                            else 1, **kw)
    if mode != "sync":
        assert port.steps.replays > 0


@pytest.mark.parametrize("spec_mode", ["linear", "tree"])
def test_fused_step_equals_sync_oracle(m, spec_mode):
    steps, replays = fused_vs_sync(m, spec_mode)
    assert steps > 5 and replays > 0


@pytest.mark.parametrize("migration_mode", ["batched", "perslot"])
def test_blobs_cross_both_ways(m, migration_mode):
    blobs_cross(m, 1.0, migration_mode)


@pytest.mark.parametrize("spec_mode", ["linear", "tree"])
def test_rollout_token_exact(m, spec_mode):
    tro = rollout_matches(m, 1.0, spec_mode=spec_mode)
    assert tro.steps.replays > 0
    assert not tro.tree_branching
