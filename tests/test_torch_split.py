"""The split route of K1 and K2 (f32 and D 32 / 256 on the CUDA cores)
in plain PyTorch against the JAX package: the attention of each row cut into
n_split shares of the cache's 32-slot tiles (``split_partials``) and
merged in share order (``merge_partials``, the plain version of the
merge launch), held against ``spec_verify_ref`` and ``tree_verify_ref``
on numpy-seeded inputs at the tolerances of ``tests/test_kernels.py``
(2e-5 at f32, 3e-2 at bf16): n_split 1-8, shares left empty, rows that
see no key (exactly 0, no NaN), windows and tree masks.  Also what the
wrappers refuse for the tensor-core route (TMA's alignment).  The CUDA
kernels themselves run only on the card, where ``chip_smoke.py`` holds
both routes to the plain versions."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.spec_verify.ref import spec_verify_ref as jax_ref
from repro.kernels.spec_verify.ref import tree_verify_ref as jax_tree_ref
from repro_torch.bridge import to_numpy
from repro_torch.kernels.spec_verify import ops
from repro_torch.kernels.spec_verify.ref import (NEG_INF, merge_partials,
                                                 pos_mask, split_partials,
                                                 split_verify_ref)

torch.set_num_threads(2)

DTYPES = {"float32": (jnp.float32, torch.float32, 2e-5),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, 3e-2)}
# B, T, S, Hq, Hk, D, window (tests/test_kernels.py VERIFY_CASES)
VERIFY_CASES = [
    (2, 5, 256, 4, 2, 64, 0),
    (1, 1, 128, 8, 8, 128, 0),
    (3, 9, 384, 4, 1, 64, 0),
    (2, 4, 256, 4, 2, 64, 64),
]


def _inputs(case, seed, empty_rows=True):
    """Slots permuted at random; with ``empty_rows`` the last row's cache
    is empty and the first query of the first row sees no key."""
    B, T, S, Hq, Hk, D, _ = case
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(B, T, Hq, D)).astype(np.float32)
    k = rng.normal(size=(B, S, Hk, D)).astype(np.float32)
    v = rng.normal(size=(B, S, Hk, D)).astype(np.float32)
    base = rng.integers(50, 150, size=(B, 1))
    q_pos = (base + np.arange(T)[None]).astype(np.int32)
    k_pos = np.full((B, S), -1, np.int32)
    for b in range(B):
        sl = rng.permutation(S)[:min(int(base[b, 0]) + T, S)]
        k_pos[b, sl] = np.arange(len(sl))
    if empty_rows and B > 1:
        k_pos[-1] = -1
    if empty_rows:
        q_pos[0, 0] = -1
    return q, k, v, q_pos, k_pos


def _tree_inputs(B, T, S, Hq, Hk, D, seed):
    """A random draft tree per row (siblings at one position, node c at
    slot anchor + c) with its ancestor mask; the last query of the last
    row sees nothing."""
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(B, T, Hq, D)).astype(np.float32)
    k = rng.normal(size=(B, S, Hk, D)).astype(np.float32)
    v = rng.normal(size=(B, S, Hk, D)).astype(np.float32)
    q_pos = np.zeros((B, T), np.int32)
    k_pos = np.full((B, S), -1, np.int32)
    tree = np.zeros((B, T, S), bool)
    for b, anchor in enumerate(rng.integers(40, 90, B)):
        k_pos[b, :anchor + 1] = np.arange(anchor + 1)
        parent = [-1] + [int(rng.integers(0, j)) for j in range(1, T)]
        depth = [0]
        for j in range(1, T):
            depth.append(depth[parent[j]] + 1)
        for j in range(T):
            q_pos[b, j] = anchor + depth[j]
            tree[b, j, :anchor + 1] = True
            node = j
            while node >= 0:
                tree[b, j, anchor + node] = True
                node = parent[node]
            k_pos[b, anchor + j] = q_pos[b, j]
    tree[-1, -1] = False
    return q, k, v, q_pos, k_pos, tree


def _torch(arrays, tdt):
    out = [torch.from_numpy(a) for a in arrays]
    out[:3] = [t.to(tdt) for t in out[:3]]
    return out


@pytest.mark.parametrize("n_split", range(1, 9))
@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("case", VERIFY_CASES)
def test_split_merge_matches_jax(case, dtype, n_split):
    jdt, tdt, tol = DTYPES[dtype]
    q, k, v, q_pos, k_pos = _inputs(case, 11)
    win = case[-1]
    want = np.asarray(jax_ref(jnp.asarray(q, jdt), jnp.asarray(k, jdt),
                              jnp.asarray(v, jdt), jnp.asarray(q_pos),
                              jnp.asarray(k_pos), window=win), np.float32)
    tq, tk, tv, tqp, tkp = _torch((q, k, v, q_pos, k_pos), tdt)
    got = split_verify_ref(tq, tk, tv, tqp, tkp, n_split, window=win)
    assert got.dtype == tdt and got.shape == tq.shape
    got = to_numpy(got)
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, atol=tol, rtol=tol)
    assert not got[0, 0].any()                  # a query that sees nothing
    if case[0] > 1:
        assert not got[-1].any()                # a row whose cache is empty


@pytest.mark.parametrize("n_split", [1, 2, 3, 5, 8])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("shape", [(2, 5, 256, 4, 2, 64, 0),
                                   (1, 8, 128, 8, 8, 128, 0),
                                   (2, 4, 256, 4, 1, 64, 96)])
def test_split_merge_tree_matches_jax(shape, dtype, n_split):
    jdt, tdt, tol = DTYPES[dtype]
    B, T, S, Hq, Hk, D, win = shape
    q, k, v, q_pos, k_pos, tree = _tree_inputs(B, T, S, Hq, Hk, D, 5)
    want = np.asarray(jax_tree_ref(
        jnp.asarray(q, jdt), jnp.asarray(k, jdt), jnp.asarray(v, jdt),
        jnp.asarray(q_pos), jnp.asarray(k_pos), jnp.asarray(tree),
        window=win), np.float32)
    tq, tk, tv, tqp, tkp = _torch((q, k, v, q_pos, k_pos), tdt)
    got = to_numpy(split_verify_ref(tq, tk, tv, tqp, tkp, n_split,
                                    window=win,
                                    tree_mask=torch.from_numpy(tree)))
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, atol=tol, rtol=tol)
    assert not got[-1, -1].any()


def test_shares_beyond_the_needed_tiles_are_empty():
    """Live slots in 2 of the cache's 8 tiles of 32, 8 shares: 6 shares
    hold no live slot, their m is NEG_INF and l and acc 0, and the merge
    is still exact."""
    case = (1, 3, 256, 4, 2, 64, 0)
    q, k, v, q_pos, k_pos = _inputs(case, 3, empty_rows=False)
    k_pos[:] = -1
    k_pos[0, :50] = np.arange(50)
    q_pos[0] = [47, 48, 49]
    tq, tk, tv, tqp, tkp = _torch((q, k, v, q_pos, k_pos), torch.float32)
    m, l, acc = split_partials(tq, tk, tv, pos_mask(tqp, tkp), 8)
    empty = (l == 0).all(dim=(1, 2, 3))
    assert int(empty.sum()) == 6
    assert (m[empty] == NEG_INF).all() and not acc[empty].any()
    want = np.asarray(jax_ref(*(jnp.asarray(a) for a in
                                (q, k, v, q_pos, k_pos))), np.float32)
    np.testing.assert_allclose(to_numpy(merge_partials(m, l, acc)), want,
                               atol=2e-5, rtol=2e-5)


def test_merge_of_shares_that_saw_nothing_is_zero():
    n, B, T, Hq, D = 4, 2, 3, 4, 32
    m = torch.full((n, B, T, Hq), NEG_INF)
    l = torch.zeros(n, B, T, Hq)
    acc = torch.zeros(n, B, T, Hq, D)
    out = merge_partials(m, l, acc)
    assert torch.isfinite(out).all() and not out.any()


def test_merge_is_independent_of_the_cut():
    """Every n_split gives the one-share result within f32 rounding."""
    case = (2, 5, 256, 4, 2, 64, 0)
    tq, tk, tv, tqp, tkp = _torch(_inputs(case, 4), torch.float32)
    one = split_verify_ref(tq, tk, tv, tqp, tkp, 1)
    for n in range(2, 9):
        got = split_verify_ref(tq, tk, tv, tqp, tkp, n)
        torch.testing.assert_close(got, one, atol=1e-6, rtol=1e-6)


def _engine_like(S=64, T=4, offset=0):
    """bf16 q (B, T, Hq, D) and a (B, T, S) mask of the engine's layout;
    ``offset`` bytes shift the mask's base."""
    q = torch.zeros(2, T, 8, 64, dtype=torch.bfloat16)
    k = torch.zeros(2, S, 2, 64, dtype=torch.bfloat16)
    buf = torch.zeros(2 * T * S + offset, dtype=torch.bool)
    mask = buf[offset:].view(2, T, S)
    return q, k, mask


def test_tensor_core_route_takes_the_engine_layout():
    q, k, mask = _engine_like()
    qp = torch.zeros(2, 4, dtype=torch.int32)
    kp = torch.zeros(2, 64, dtype=torch.int32)
    ops.check_inputs(q, k, k, qp, kp)
    ops.check_tree_mask(q, k, mask)
    ops.check_tensor_cores(q, mask)


@pytest.mark.parametrize("what", ["q_base", "mask_rows", "mask_base"])
def test_tensor_core_route_refuses_what_tma_cannot_read(what):
    """TMA reads q and K2's mask as tiles: a q base off 16 bytes, mask
    rows (S = 40 bytes) or a mask base off 16 bytes are refused with a
    clear error on the tensor-core route, and taken on the CUDA cores."""
    q, k, mask = _engine_like(S=40 if what == "mask_rows" else 64,
                              offset=1 if what == "mask_base" else 0)
    if what == "q_base":
        q = torch.zeros(q.numel() + 1, dtype=q.dtype)[1:].view(q.shape)
    ops.check_tree_mask(q, k, mask)
    with pytest.raises(ValueError, match="16"):
        ops.check_tensor_cores(q, mask)


@pytest.mark.parametrize("S", [40, 64])
def test_tree_forward_mask_rows_take_tma(S):
    """The allowed mask a tree forward builds has rows a multiple of 16
    bytes apart whatever the cache length (a view of a padded buffer), so
    K2's tensor-core route takes it; its values are the unpadded ones."""
    from repro_torch.configs import get_tiny_config
    from repro_torch.models.transformer import _allowed_mask
    cfg = get_tiny_config("granite-3-8b")
    B, T = 2, 4
    rng = np.random.default_rng(0)
    slot_pos = torch.full((B, S), -1, dtype=torch.int32)
    slot_pos[:, :20] = torch.arange(20, dtype=torch.int32)
    positions = torch.tensor([[20, 21, 21, 22], [20, 21, 22, 23]],
                             dtype=torch.int32)
    slots = torch.tensor([[20, 21, 22, 23], [20, 21, 22, S]])
    within = torch.from_numpy(rng.random((B, T, T)) < 0.5) | torch.eye(
        T, dtype=torch.bool)
    got = _allowed_mask(cfg, positions, slots, slot_pos, within)
    assert got.shape == (B, T, S) and got.stride(2) == 1
    assert got.stride(1) % 16 == 0 and got.stride(0) % 16 == 0
    assert got.data_ptr() % 16 == 0
    q = torch.zeros(B, T, cfg.num_heads, 64, dtype=torch.bfloat16)
    k = torch.zeros(B, S, cfg.num_kv_heads, 64, dtype=torch.bfloat16)
    ops.check_tree_mask(q, k, got)
    ops.check_tensor_cores(q, got)
    kp = slot_pos[:, None, :]
    qp = positions[:, :, None]
    col = torch.full((B, S + 1), -1, dtype=torch.int64)
    col[torch.arange(B)[:, None], slots] = torch.arange(T).expand(B, T)
    col = col[:, :S]
    ext = within.gather(2, col.clamp(0, T - 1)[:, None, :].expand(B, T, S))
    want = torch.where((col >= 0)[:, None, :], ext, (kp >= 0) & (kp <= qp))
    assert torch.equal(got, want)


SHARD_CASES = [(2, 5, 256, 4, 2, 64, 0), (1, 1, 128, 8, 8, 128, 0),
               (2, 1, 256, 32, 8, 128, 0), (2, 4, 256, 4, 2, 64, 64),
               (3, 9, 384, 4, 1, 64, 0)]


@pytest.mark.parametrize("tree", [False, True])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("case", SHARD_CASES)
def test_head_shard_with_the_unsharded_split_is_bitwise(case, dtype, tree):
    """What a tensor-parallel rank runs: its heads
    (``sharding.head_shard``) of K1 / K2 cut into the unsharded call's
    n_split shares (the wrappers' ``split_like``) give exactly those heads
    of the unsharded call, for every n_split, through the split route's
    plain version on the CPU.  A head's shares depend only on its own
    rows and the cache (the kernel's CTAs each take one KV head)."""
    from repro_torch.sharding import head_shard
    _, tdt, _ = DTYPES[dtype]
    B, T, S, Hq, Hk, D, win = case
    if tree:
        q, k, v, q_pos, k_pos, mask = _tree_inputs(B, T, S, Hq, Hk, D, 3)
        mask = torch.from_numpy(mask)
    else:
        q, k, v, q_pos, k_pos = _inputs(case, 7)
        mask = None
    tq, tk, tv, tqp, tkp = _torch((q, k, v, q_pos, k_pos), tdt)
    for n_split in (1, 2, 3, 8):
        whole = split_verify_ref(tq, tk, tv, tqp, tkp, n_split, window=win,
                                 tree_mask=mask)
        for tp in (2, 4, 8):
            if Hk % tp:
                continue
            for r in range(tp):
                hs = head_shard(Hq, Hk, tp, r)
                qs = tq[:, :, hs.q_lo:hs.q_hi].contiguous()
                ks = tk[:, :, hs.kv_lo:hs.kv_hi].contiguous()
                vs = tv[:, :, hs.kv_lo:hs.kv_hi].contiguous()
                got = split_verify_ref(qs, ks, vs, tqp, tkp, n_split,
                                       window=win, tree_mask=mask)
                assert torch.equal(got, whole[:, :, hs.q_lo:hs.q_hi]), \
                    (n_split, tp, r)
