#!/usr/bin/env python3
"""Drive the PyTorch port (``src/repro_torch``) on one NVIDIA card.

    python3 chip_smoke.py [--profile N] [--out DIR]

Phases, in this order:

1. the card's name and power limit, as nvidia-smi prints them;
2. build of the hand-written kernels from ``src/repro_torch/kernels``;
3. kernels: K1 (spec_verify) and K2 (tree_verify) against their plain
   PyTorch versions on the card at granite-3-8b's head shapes, and at
   every other head dim they are built for; K2 on random draft trees
   (siblings at one position, a query that sees no key) and, under an
   all-true mask, bitwise equal to K1;
4. linear slice: a full-width, full-depth granite-3-8b Seer rollout
   (random weights from a seed, bf16) on two instances through the
   port's entry points, with its checks: every group finishes, every
   cached attention launched K1, at most one host sync per engine step,
   dispatch free of host syncs under
   ``torch.cuda.set_sync_debug_mode("error")``, and a repeat run
   bit-identical; then a third pass on the second rollout, its group
   suffix trees warm from the pass before;
5. tree engine: one full-width tree-mode ``Instance`` driven with
   branching drafts (a bad trunk, a good side branch); at each step the
   fused tree step is held against the sync oracle run from the same
   state (same tokens and accept counts, same ``slot_pos``, bitwise
   equal K/V at every committed slot), with one host sync and 40 K2
   launches per fused step, and dispatch free of host syncs;
6. tree slice: the linear slice's rollout with ``spec_mode="tree"`` and
   three draft paths, a warm pass then a measured one drafting from the
   warm group suffix trees (every attention through K2, none through K1,
   at most one host sync per step, drafts accepted, branching trees
   verified), set beside the linear slice's warm pass;
7. timing: each kernel at the shape its slice gave it, beside its plain
   version, a library call and the card's bound.  Its ``launches`` are
   its slice's.

The line before the last is the ``kernels`` JSON record; the last line
is ``{"ok": true, "device": {...}}``.  Any failed check exits non-zero
before either.  Without a CUDA device, or without the repository beside
it, the script exits non-zero and prints no result.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

# published peaks of one H100 SXM (dense): memory bytes/s, and the
# operation rate of each input type (bf16 on the tensor cores, f32 on
# the CUDA cores)
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS = {"bfloat16": 989e12, "float32": 67e12}
# tolerances of tests/test_kernels.py (spec_verify against its oracle)
TOL = {"float32": 2e-5, "bfloat16": 3e-2}
SPEC_VERIFY_TPU = "src/repro/kernels/spec_verify/kernel.py:87"
TREE_VERIFY_TPU = "src/repro/kernels/spec_verify/kernel.py:94"
SPEC_VERIFY_SRC = "src/repro_torch/kernels/spec_verify/csrc/spec_verify.cu"
# the slice's rollout: 8 GRPO groups of 4 (32 requests on 2 x 8 slots,
# so requests queue and migrate), 128 new tokens in chunks of 32
GROUPS, GROUP_SIZE, NEW_TOKENS, CHUNK_SIZE = 8, 4, 128, 32


class CheckFailed(RuntimeError):
    pass


def check(cond: bool, what: str) -> None:
    if not cond:
        raise CheckFailed(what)


def log(*a) -> None:
    print(*a, flush=True)


# ---------------------------------------------------------------------------
# phase 1: the card
# ---------------------------------------------------------------------------


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    check(out.returncode == 0, f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


# ---------------------------------------------------------------------------
# phase 3: kernels
# ---------------------------------------------------------------------------


def _sv_inputs(torch, np, *, B, T, S, Hq, Hk, D, dtype, seed, live=None):
    """Inputs of K1.  With ``live`` (B,) the cache holds positions
    0..live-1 in slots 0..live-1 and the queries sit at the last T of
    them, as in the engine; without it (the kernel check), rows alternate
    between that layout and slots permuted at random, the last row's
    cache is empty and one query of the row before it sees no key."""
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(B, T, Hq, D)).astype(np.float32)
    k = rng.normal(size=(B, S, Hk, D)).astype(np.float32)
    v = rng.normal(size=(B, S, Hk, D)).astype(np.float32)
    k_pos = np.full((B, S), -1, np.int32)
    if live is not None:
        q_pos = np.asarray(live)[:, None] - T + np.arange(T)[None]
        for b in range(B):
            k_pos[b, :live[b]] = np.arange(live[b])
    else:
        base = rng.integers(50, min(S - T, 700), size=(B, 1))
        q_pos = base + np.arange(T)[None]
        for b in range(B):
            n = min(int(base[b, 0]) + T, S)
            slots = rng.permutation(S)[:n] if b % 2 else np.arange(n)
            k_pos[b, slots] = np.arange(n)
        k_pos[B - 1] = -1
        q_pos[B - 2, 0] = -1
    dt = getattr(torch, dtype)
    return (torch.from_numpy(q).to("cuda", dt),
            torch.from_numpy(k).to("cuda", dt),
            torch.from_numpy(v).to("cuda", dt),
            torch.from_numpy(q_pos.astype(np.int32)).to("cuda"),
            torch.from_numpy(k_pos).to("cuda"))


def _bound_ms(q, k, q_pos, k_pos, window, dtype, tree=None):
    """Least time for one K1 call (K2 with ``tree``) on these inputs, and
    what sets it: K/V rows of the slots some query of the row can see, q,
    out and both position arrays, each moved once, plus for K2 the mask
    bytes of every (query, slot) the positional mask leaves open (the
    others need not be read), against 4*Hq*D operations per visible
    (query, key)."""
    from repro_torch.kernels.spec_verify.ref import pos_mask
    B, T, Hq, D = q.shape
    Hk = k.shape[2]
    pos = pos_mask(q_pos, k_pos, window)                     # (B,T,S)
    vis = pos if tree is None else pos & tree
    n_vis = int(vis.sum())
    n_slots = int(vis.any(dim=1).sum())
    es = q.element_size()
    nbytes = (2 * q.numel() * es + 4 * (q_pos.numel() + k_pos.numel())
              + 2 * n_slots * Hk * D * es)
    if tree is not None:
        nbytes += T * int(pos.any(dim=1).sum())
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = 4 * Hq * D * n_vis / PEAK_OPS[dtype]
    return 1e3 * max(t_bytes, t_ops), \
        "bytes" if t_bytes >= t_ops else "operations"


def _time_ms(torch, fn, iters: int, flush=None) -> float:
    """Median device time of ``fn`` over ``iters`` calls (CUDA events
    around each call; ``flush`` runs before each, outside the timed
    window).  The median, not the mean: one slow stretch of the card
    during a run should not decide a kernel's figure."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    pairs = []
    for _ in range(iters):
        if flush is not None:
            flush()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        pairs.append((a, b))
    torch.cuda.synchronize()
    times = sorted(a.elapsed_time(b) for a, b in pairs)
    return times[len(times) // 2]


def kernels_check(torch, np, *, B, S, T_list) -> list:
    """K1 against its plain version at the main path's head shapes
    (Hq=32, Hk=8, D=128), then at each other head dim it is built for on
    a small cache, so that every instance of the kernel ran on the card."""
    from repro_torch.kernels.spec_verify import ops
    from repro_torch.kernels.spec_verify.ref import spec_verify_ref
    rows = []
    cases = [(B, S, T, 32, 8, 128, dt, 0) for T in T_list
             for dt in ("bfloat16", "float32")]
    cases += [(B, S, T_list[1], 32, 8, 128, "bfloat16", 256),
              (B, S, T_list[-1], 32, 8, 128, "float32", 256)]
    cases += [(4, 512, 9, 8, 2, D, dt, w) for D in ops.HEAD_DIMS if D != 128
              for dt, w in (("bfloat16", 0), ("float32", 64))]
    for B, S, T, Hq, Hk, D, dtype, window in cases:
        q, k, v, qp, kp = _sv_inputs(torch, np, B=B, T=T, S=S, Hq=Hq, Hk=Hk,
                                     D=D, dtype=dtype, seed=T + window + D)
        out = ops.spec_verify(q, k, v, qp, kp, window=window)
        out2 = ops.spec_verify(q, k, v, qp, kp, window=window)
        ref = spec_verify_ref(q, k, v, qp, kp, window=window)
        torch.cuda.synchronize()
        err = float((out.float() - ref.float()).abs().max())
        tol = TOL[dtype]
        ok = torch.allclose(out.float(), ref.float(), atol=tol, rtol=tol)
        empty = out[B - 1].float().abs().max().item() == 0.0 and \
            out[B - 2, 0].float().abs().max().item() == 0.0
        det = torch.equal(out, out2)
        rows.append({"B": B, "S": S, "T": T, "Hq": Hq, "Hk": Hk, "D": D,
                     "dtype": dtype, "window": window, "max_abs_err": err,
                     "tol": tol, "empty_rows_zero": empty,
                     "deterministic": det})
        what = f"B={B} T={T} S={S} Hq={Hq} Hk={Hk} D={D} {dtype} " \
            f"window={window}"
        log(f"  spec_verify {what}: max|err|={err:.3e} (tol {tol}) "
            f"empty rows 0: {empty}, repeat bit-equal: {det}")
        check(bool(ok), f"spec_verify disagrees with its plain version: "
              f"{what} max|err|={err}")
        check(empty, f"spec_verify: rows with no visible key not 0 ({what})")
        check(det, f"spec_verify: repeat launch not bit-equal ({what})")
    return rows


def kernels_time(torch, np, *, B, S, T, live, dtype="bfloat16",
                 iters=50) -> dict:
    """Time K1, its plain version and SDPA (the yardstick, never called
    by the port) on one main-path shape, with L2 flushed before each."""
    import torch.nn.functional as F
    from repro_torch.kernels.spec_verify import ops
    from repro_torch.kernels.spec_verify.ref import pos_mask, spec_verify_ref
    q, k, v, qp, kp = _sv_inputs(torch, np, B=B, T=T, S=S, Hq=32, Hk=8,
                                 D=128, dtype=dtype, seed=7, live=live)
    scratch = torch.empty(256 << 20, dtype=torch.uint8, device="cuda")

    def flush():
        scratch.zero_()

    n0 = dict(ops.launches)
    out = ops.spec_verify(q, k, v, qp, kp)
    ref = spec_verify_ref(q, k, v, qp, kp)
    err = float((out.float() - ref.float()).abs().max())
    check(err <= TOL[dtype] * (1 + float(ref.float().abs().max())),
          f"spec_verify (timing shape) max|err|={err}")
    ms = _time_ms(torch, lambda: ops.spec_verify(q, k, v, qp, kp), iters,
                  flush)
    plain_ms = _time_ms(torch, lambda: spec_verify_ref(q, k, v, qp, kp),
                        max(iters // 5, 5), flush)
    # SDPA on the same values in its (B, H, T, D) layout with the same
    # boolean mask; the transposes are made outside the timed window
    qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
    mask = pos_mask(qp, kp)[:, None]

    def lib():
        return F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask,
                                              enable_gqa=True)
    library_ms = _time_ms(torch, lib, iters, flush)
    bound_ms, bound_by = _bound_ms(q, k, qp, kp, 0, dtype)
    ops.launches.update(n0)      # timing launches are not a slice's
    return {"T": T, "dtype": dtype, "live_mean": float(np.mean(live)),
            "ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "max_abs_err": err}


def _tree_inputs(torch, np, *, B, T, S, Hq, Hk, D, dtype, seed, live=None):
    """Inputs of K2: each row a random draft tree of T nodes (the anchor
    and T-1 nodes, siblings at duplicate positions) over a cache of
    committed positions, laid out as the engine lays it out (node c at
    slot anchor+c), with the ancestor mask.  The anchor sits at
    ``live[b] - 1`` (or at random); without ``live`` the last query of
    the last row sees no key."""
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(B, T, Hq, D)).astype(np.float32)
    k = rng.normal(size=(B, S, Hk, D)).astype(np.float32)
    v = rng.normal(size=(B, S, Hk, D)).astype(np.float32)
    anchors = (np.asarray(live) - 1 if live is not None
               else rng.integers(50, min(S - T, 700), size=B))
    q_pos = np.zeros((B, T), np.int32)
    k_pos = np.full((B, S), -1, np.int32)
    tree = np.zeros((B, T, S), bool)
    for b in range(B):
        a = int(anchors[b])
        k_pos[b, :a + 1] = np.arange(a + 1)
        parent = [-1] + [int(rng.integers(0, j)) for j in range(1, T)]
        depth = [0] * T
        for j in range(1, T):
            depth[j] = depth[parent[j]] + 1
        for j in range(T):
            q_pos[b, j] = a + depth[j]
            tree[b, j, :a + 1] = True
            node = j
            while node >= 0:
                tree[b, j, a + node] = True
                node = parent[node]
            k_pos[b, a + j] = q_pos[b, j]
    if live is None:
        tree[B - 1, T - 1] = False
    dt = getattr(torch, dtype)
    return (torch.from_numpy(q).to("cuda", dt),
            torch.from_numpy(k).to("cuda", dt),
            torch.from_numpy(v).to("cuda", dt),
            torch.from_numpy(q_pos).to("cuda"),
            torch.from_numpy(k_pos).to("cuda"),
            torch.from_numpy(tree).to("cuda"))


def tree_kernels_check(torch, np, *, B, S, T_list) -> list:
    """K2 against its plain version at the main path's head shapes, on
    random trees, T in ``T_list`` (decode, tree verify and prefill
    widths), bf16 and f32, window 0 and 256; repeat launches bit-equal,
    the query that sees no key exactly 0, and with an all-true mask K2
    bitwise equal to K1.  Then each other head dim on a small cache."""
    from repro_torch.kernels.spec_verify import ops
    from repro_torch.kernels.spec_verify.ref import tree_verify_ref
    rows = []
    cases = [(B, S, T, 32, 8, 128, dt, w) for T in T_list
             for dt in ("bfloat16", "float32") for w in (0, 256)]
    cases += [(4, 512, 9, 8, 2, D, dt, w) for D in ops.HEAD_DIMS if D != 128
              for dt, w in (("bfloat16", 0), ("float32", 64))]
    for B, S, T, Hq, Hk, D, dtype, window in cases:
        q, k, v, qp, kp, tm = _tree_inputs(
            torch, np, B=B, T=T, S=S, Hq=Hq, Hk=Hk, D=D, dtype=dtype,
            seed=100 + T + window + D)
        out = ops.tree_verify(q, k, v, qp, kp, tm, window=window)
        out2 = ops.tree_verify(q, k, v, qp, kp, tm, window=window)
        ref = tree_verify_ref(q, k, v, qp, kp, tm, window=window)
        ones = torch.ones_like(tm)
        k2_all = ops.tree_verify(q, k, v, qp, kp, ones, window=window)
        k1 = ops.spec_verify(q, k, v, qp, kp, window=window)
        torch.cuda.synchronize()
        err = float((out.float() - ref.float()).abs().max())
        tol = TOL[dtype]
        ok = torch.allclose(out.float(), ref.float(), atol=tol, rtol=tol)
        empty = out[B - 1, T - 1].float().abs().max().item() == 0.0
        det = torch.equal(out, out2)
        same_k1 = torch.equal(k2_all, k1)
        rows.append({"B": B, "S": S, "T": T, "Hq": Hq, "Hk": Hk, "D": D,
                     "dtype": dtype, "window": window, "max_abs_err": err,
                     "tol": tol, "empty_query_zero": empty,
                     "deterministic": det, "all_true_equals_k1": same_k1})
        what = f"B={B} T={T} S={S} Hq={Hq} Hk={Hk} D={D} {dtype} " \
            f"window={window}"
        log(f"  tree_verify {what}: max|err|={err:.3e} (tol {tol}) "
            f"blind query 0: {empty}, repeat bit-equal: {det}, all-true "
            f"mask == K1: {same_k1}")
        check(bool(ok), f"tree_verify disagrees with its plain version: "
              f"{what} max|err|={err}")
        check(empty, f"tree_verify: a query with no visible key is not 0 "
              f"({what})")
        check(det, f"tree_verify: repeat launch not bit-equal ({what})")
        check(same_k1, f"tree_verify with an all-true mask is not "
              f"bitwise K1 ({what})")
    return rows


def tree_kernels_time(torch, np, *, B, S, T, live, dtype="bfloat16",
                      iters=50) -> dict:
    """Time K2, K1 on the same inputs (without the mask), K2's plain
    version and SDPA with the combined boolean mask (the yardstick, never
    called by the port), with L2 flushed before each call."""
    import torch.nn.functional as F
    from repro_torch.kernels.spec_verify import ops
    from repro_torch.kernels.spec_verify.ref import pos_mask, tree_verify_ref
    q, k, v, qp, kp, tm = _tree_inputs(torch, np, B=B, T=T, S=S, Hq=32,
                                       Hk=8, D=128, dtype=dtype, seed=17,
                                       live=live)
    scratch = torch.empty(256 << 20, dtype=torch.uint8, device="cuda")

    def flush():
        scratch.zero_()

    n0 = dict(ops.launches)
    out = ops.tree_verify(q, k, v, qp, kp, tm)
    ref = tree_verify_ref(q, k, v, qp, kp, tm)
    err = float((out.float() - ref.float()).abs().max())
    check(err <= TOL[dtype] * (1 + float(ref.float().abs().max())),
          f"tree_verify (timing shape) max|err|={err}")
    ms = _time_ms(torch, lambda: ops.tree_verify(q, k, v, qp, kp, tm),
                  iters, flush)
    k1_ms = _time_ms(torch, lambda: ops.spec_verify(q, k, v, qp, kp), iters,
                     flush)
    plain_ms = _time_ms(torch, lambda: tree_verify_ref(q, k, v, qp, kp, tm),
                        max(iters // 5, 5), flush)
    qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
    mask = (pos_mask(qp, kp) & tm)[:, None]

    def lib():
        return F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask,
                                              enable_gqa=True)
    library_ms = _time_ms(torch, lib, iters, flush)
    bound_ms, bound_by = _bound_ms(q, k, qp, kp, 0, dtype, tree=tm)
    ops.launches.update(n0)      # timing launches are not a slice's
    return {"T": T, "dtype": dtype, "live_mean": float(np.mean(live)),
            "ms": ms, "k1_ms": k1_ms, "plain_ms": plain_ms,
            "library_ms": library_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "max_abs_err": err}


# ---------------------------------------------------------------------------
# phase 4: the linear slice
# ---------------------------------------------------------------------------


def build_model(torch):
    from repro_torch.configs import get_config
    from repro_torch.models import init_params
    cfg = get_config("granite-3-8b")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    t0 = time.perf_counter()
    params = init_params(cfg, gen, device="cuda")
    torch.cuda.synchronize()
    n = sum(w.numel() for w in [params["embed"]] + [
        t for lyr in params["layers"] for blk in lyr.values()
        for t in blk.values()])
    log(f"  granite-3-8b: {cfg.num_layers} layers, d_model {cfg.d_model}, "
        f"{cfg.num_heads}/{cfg.num_kv_heads} heads, d_ff {cfg.d_ff}, vocab "
        f"{cfg.vocab_size}, {cfg.dtype}; {n / 1e9:.2f} B params made in "
        f"{time.perf_counter() - t0:.1f} s")
    return cfg, params


def make_prompts(np, cfg, n_groups: int, seed: int):
    rng = np.random.default_rng(seed)
    lens = rng.integers(192, 384, size=n_groups)
    return [rng.integers(0, cfg.vocab_size, size=int(n)).tolist()
            for n in lens]


def make_rollout(cfg, params, **kw):
    from repro_torch.core import SeerRollout
    return SeerRollout(cfg, params, n_instances=2, max_slots=8,
                       cache_len=2048, chunk_size=CHUNK_SIZE,
                       policy="seer", spec_decode=True, device="cuda", **kw)


def run_rollout(torch, ro, prompts):
    """One ``ro.run`` over the slice's groups, its launch counts set to 0
    just before and read just after."""
    from repro_torch.core import make_groups
    from repro_torch.kernels.spec_verify import ops
    groups = make_groups(prompts, group_size=GROUP_SIZE,
                         max_new_tokens=NEW_TOKENS, seed=3,
                         temperature=1.0)
    st = ro.steps
    inv0, hs0 = st.invocations, st.host_syncs
    by0 = dict(st.invocations_by_kind)
    nodes0 = [(i.tree_nodes, i.tree_branch_nodes) for i in ro.instances]
    torch.cuda.synchronize()
    ops.reset_launches()
    t0 = time.perf_counter()
    res = ro.run(groups)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return {"responses": res.responses(), "wall_s": wall,
            "launches": dict(ops.launches),
            "fused_steps": st.invocations - inv0,
            "by_kind": {k_: n - by0.get(k_, 0) for k_, n in
                        st.invocations_by_kind.items()
                        if n - by0.get(k_, 0)},
            "host_syncs": st.host_syncs - hs0, "stats": res.stats,
            "tree_nodes": sum(i.tree_nodes - n[0] for i, n in
                              zip(ro.instances, nodes0)),
            "tree_branch_nodes": sum(i.tree_branch_nodes - n[1] for i, n in
                                     zip(ro.instances, nodes0)),
            "finished": all(g.all_finished for g in res.groups)}


def sync_debug_steps(torch, np, cfg, params, n_steps: int = 8) -> dict:
    """Dispatch engine steps (prefill, decode and verify with drafts)
    under ``set_sync_debug_mode("error")``; commit outside it."""
    from repro_torch.engine import EngineSeq, Instance, StepFunctions
    steps = StepFunctions(cfg)
    inst = Instance(cfg, params, steps, max_slots=8, cache_len=2048,
                    device="cuda")
    rng = np.random.default_rng(11)
    for i in range(4):
        inst.admit(EngineSeq(f"s{i}", "g", rng.integers(
            0, cfg.vocab_size, size=40 + 30 * i).tolist(), seed=i,
            temperature=1.0, max_new_tokens=64))
    kinds, syncs = [], []
    for it in range(n_steps):
        drafts = {i: [inst.slots[i].last_token] * (8 if it % 2 else 2)
                  for i in inst.decode_slots()}
        s0 = steps.host_syncs
        torch.cuda.set_sync_debug_mode("error")
        try:
            ticket = inst.dispatch_step(drafts)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        inst.commit_step(ticket)
        syncs.append(steps.host_syncs - s0)
        kinds.append(ticket.T if ticket is not None else 0)
    check(all(s == 1 for s in syncs), f"host syncs per step {syncs}")
    return {"step_T": kinds, "host_syncs_per_step": syncs}


# ---------------------------------------------------------------------------
# phase 5: the tree engine against its sync oracle
# ---------------------------------------------------------------------------


def _snapshot(inst):
    """A copy of ``inst`` that shares nothing the next step writes: the
    cache (scratch slots included), the seqs, the step counters."""
    import copy
    from repro_torch.engine import StepFunctions
    from repro_torch.models.transformer import clone_cache
    shadow = copy.copy(inst)
    shadow.cache = clone_cache(inst.cache)
    shadow.slots = [copy.deepcopy(x) for x in inst.slots]
    shadow.steps = StepFunctions(inst.cfg)
    return shadow


def tree_engine_check(torch, np, cfg, params, n_tokens: int = 24) -> dict:
    """One tree-mode instance driven with ``build_token_tree([bad,
    good])`` drafts (``good`` from a no-draft run of the same requests,
    ``bad`` that trunk perturbed).  Before each fused step the instance
    is snapshotted and the sync oracle's tree step runs on the snapshot
    with the same drafts; both must commit the same tokens and accept
    counts, leave the same ``slot_pos`` and bitwise equal K/V at every
    committed slot.  Each fused step dispatches under
    ``set_sync_debug_mode("error")``, costs one host sync and launches K2
    once per layer (K1 never)."""
    from repro_torch.engine import (EngineSeq, Instance, StepFunctions,
                                    build_token_tree)
    from repro_torch.kernels.spec_verify import ops
    V, L = cfg.vocab_size, cfg.num_layers
    rng = np.random.default_rng(21)
    prompts = [rng.integers(0, V, size=int(n)).tolist()
               for n in rng.integers(100, 300, size=8)]

    def new_instance():
        inst = Instance(cfg, params, StepFunctions(cfg), max_slots=8,
                        cache_len=2048, spec_mode="tree", device="cuda")
        seqs = [EngineSeq(f"t{i}", f"g{i}", p, seed=i, temperature=1.0,
                          max_new_tokens=n_tokens)
                for i, p in enumerate(prompts)]
        check([inst.admit(s) for s in seqs] == list(range(8)),
              "slots not admitted in order")
        return inst, seqs

    base, seqs = new_instance()
    while not all(s.finished for s in seqs):
        base.run_step()
    streams = [s.generated for s in seqs]
    del base

    inst, seqs = new_instance()
    steps = rescues = accepted = 0
    while not all(s.finished for s in seqs):
        drafts = {}
        for i, s in enumerate(seqs):
            good = streams[i][len(s.generated):len(s.generated) + 2]
            if s.finished or s.prefilling or not good:
                continue
            drafts[i] = build_token_tree([[(x + 7) % V for x in good],
                                          good])
        shadow = _snapshot(inst)
        want = shadow._run_step_sync_tree(drafts)
        n0, h0 = dict(ops.launches), inst.steps.host_syncs
        torch.cuda.set_sync_debug_mode("error")
        try:
            ticket = inst.dispatch_step(drafts)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        k2 = ops.launches["tree_verify"] - n0["tree_verify"]
        k1 = ops.launches["spec_verify"] - n0["spec_verify"]
        got = inst.commit_step(ticket)
        steps += 1
        check(inst.steps.host_syncs - h0 == 1,
              f"tree step {steps}: {inst.steps.host_syncs - h0} host syncs")
        check(k2 == L and k1 == 0,
              f"tree step {steps}: K2 launches {k2}, K1 launches {k1}")
        check({i: (t, a) for i, (t, _, a) in got.items()} ==
              {i: (t, a) for i, (t, _, a) in want.items()},
              f"tree step {steps}: fused {got} != sync oracle {want}")
        sp = inst.cache["slot_pos"]
        check(torch.equal(sp, shadow.cache["slot_pos"]),
              f"tree step {steps}: slot_pos differs from the oracle's")
        live = sp >= 0
        for name in ("k", "v"):
            check(torch.equal(inst.cache[name][:, live],
                              shadow.cache[name][:, live]),
                  f"tree step {steps}: {name} differs from the oracle's "
                  "at a committed slot")
        for i, (toks, _, a) in got.items():
            accepted += a
            if a and i in drafts and drafts[i].winner_rank(toks[:a]) == 1:
                rescues += 1
        del shadow
        check(steps < 200, "tree engine phase does not finish")
    return {"steps": steps, "accepted": accepted,
            "side_branch_steps": rescues, "tree_nodes": inst.tree_nodes,
            "tree_branch_nodes": inst.tree_branch_nodes,
            "tokens": sum(len(s.generated) for s in seqs)}


def profile_steps(torch, cfg, params, n_steps: int) -> dict:
    """torch.profiler over decode steps of one full instance: device time
    by kernel name, and the device's busy share of the window."""
    import numpy as np
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.engine import EngineSeq, Instance, StepFunctions
    inst = Instance(cfg, params, StepFunctions(cfg), max_slots=8,
                    cache_len=2048, device="cuda")
    rng = np.random.default_rng(5)
    for i in range(8):
        inst.admit(EngineSeq(f"p{i}", f"g{i % 2}", rng.integers(
            0, cfg.vocab_size, size=300).tolist(), seed=i, temperature=1.0,
            max_new_tokens=10_000))
    while inst.prefilling_slots():
        inst.run_step()
    for _ in range(3):
        inst.run_step()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for it in range(n_steps):
            drafts = {i: [inst.slots[i].last_token] * 8
                      for i in inst.decode_slots()} if it % 2 else {}
            inst.run_step(drafts)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    rows = []
    dev_total = 0.0
    for e in prof.key_averages():
        t = getattr(e, "device_time_total", None)
        if t is None:
            t = getattr(e, "cuda_time_total", 0.0)
        if t and e.device_type.name == "CUDA":
            rows.append((e.key, t / 1e3, e.count))
            dev_total += t / 1e3
    rows.sort(key=lambda r: -r[1])
    return {"steps": n_steps, "wall_ms": wall * 1e3,
            "device_ms": dev_total,
            "busy_share": dev_total / max(wall * 1e3, 1e-9),
            "top": rows[:25]}


# ---------------------------------------------------------------------------


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--profile", type=int, default=0,
                    help="profile this many engine steps (0: off)")
    ap.add_argument("--out", default=None,
                    help="directory for the full JSON report and traces")
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    import numpy as np
    from repro_torch.kernels.spec_verify import ops

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    out_dir = args.out
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
    report = {"torch": torch.__version__, "cuda": torch.version.cuda}

    card = card_line()
    log(card)
    report["card"] = card
    name = torch.cuda.get_device_name(0)

    t0 = time.perf_counter()
    ops.build()
    info = ops.build_info()
    log(f"build: spec_verify.cu -> sm_90a in {info['seconds']:.1f} s")
    report["build_seconds"] = info["seconds"]
    if out_dir:
        with open(os.path.join(out_dir, "ptxas.txt"), "w") as f:
            f.write(info["log"])

    B, S = 8, 2048
    log("kernels: spec_verify (K1) against its plain version")
    report["kernel_checks"] = kernels_check(torch, np, B=B, S=S,
                                            T_list=[1, 9, 64])

    log("kernels: tree_verify (K2) against its plain version")
    report["tree_kernel_checks"] = tree_kernels_check(
        torch, np, B=B, S=S, T_list=[1, 9, 33, 64])

    log("linear slice: granite-3-8b Seer rollout on the card")
    cfg, params = build_model(torch)
    L = cfg.num_layers
    prompts = make_prompts(np, cfg, GROUPS, seed=1)
    report["sync_debug"] = sync_debug_steps(torch, np, cfg, params)
    log(f"  dispatch under sync debug 'error': T per step "
        f"{report['sync_debug']['step_T']}, host syncs "
        f"{report['sync_debug']['host_syncs_per_step']}")
    runs = []
    for _ in range(2):
        ro = make_rollout(cfg, params)
        runs.append(run_rollout(torch, ro, prompts))
    # a third pass on the second rollout, its group CSTs warm from the
    # second pass: the like-for-like yardstick of the tree slice's
    # measured pass (same method, linear drafts)
    ro.reset_acceptance_profile()
    lw = run_rollout(torch, ro, prompts)
    del ro
    r = runs[0]
    st = r["stats"]
    k1_launches = r["launches"]["spec_verify"]
    check(r["finished"], "not every group finished")
    check(k1_launches > 0, "the rollout launched K1 no time")
    check(k1_launches == r["fused_steps"] * L,
          f"K1 launches {k1_launches} != cached forwards "
          f"{r['fused_steps']} x {L}")
    check(r["launches"]["tree_verify"] == 0,
          "the linear rollout launched K2")
    check(r["host_syncs"] <= st.steps,
          f"host syncs {r['host_syncs']} > steps {st.steps}")
    check(runs[1]["responses"] == r["responses"],
          "repeat rollout not bit-identical")
    check(runs[1]["launches"] == r["launches"],
          "repeat rollout launched K1 a different number of times")
    lens = [len(x) for x in r["responses"].values()]
    check(all(n == NEW_TOKENS for n in lens),
          f"response lengths {sorted(set(lens))}")
    slice_rep = {
        "layers": L, "requests": len(lens),
        "tokens": st.tokens, "steps": st.steps, "chunks": st.chunks,
        "migrations": st.migrations, "drafted": st.drafted,
        "accepted": st.accepted, "mean_acceptance": st.mean_acceptance,
        "host_syncs": r["host_syncs"], "k1_launches": k1_launches,
        "fused_steps": r["fused_steps"],
        "tokens_per_step": st.tokens / r["fused_steps"],
        "fused_by_T": r["by_kind"],
        "wall_s": [x["wall_s"] for x in runs],
        "tokens_per_s": [st.tokens / x["wall_s"] for x in runs],
        "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9}
    lwst = lw["stats"]
    check(lw["finished"], "linear warm pass: not every group finished")
    check(lw["launches"]["spec_verify"] == lw["fused_steps"] * L,
          "linear warm pass: K1 launches != steps x layers")
    check(lw["host_syncs"] <= lwst.steps, "linear warm pass: host syncs > "
          "steps")
    slice_rep["warm"] = {
        "fused_steps": lw["fused_steps"],
        "tokens_per_step": lwst.tokens / lw["fused_steps"],
        "drafted": lwst.drafted, "accepted": lwst.accepted,
        "mean_acceptance": lwst.mean_acceptance, "wall_s": lw["wall_s"],
        "tokens_per_s": lwst.tokens / lw["wall_s"],
        "same_responses": sum(lw["responses"][k] == v
                              for k, v in r["responses"].items())}
    report["slice"] = slice_rep
    log(f"  tokens {st.tokens}, steps {st.steps}, chunks {st.chunks}, "
        f"migrations {st.migrations}, drafted {st.drafted}, accepted "
        f"{st.accepted} (mean acceptance {st.mean_acceptance:.4f}), "
        f"tokens per engine step {slice_rep['tokens_per_step']:.3f}")
    log(f"  K1 launches {k1_launches} = {r['fused_steps']} cached "
        f"forwards x {L}; host syncs {r['host_syncs']} "
        f"<= steps {st.steps}; fused steps by T {r['by_kind']}")
    log(f"  wall s {[round(x, 3) for x in slice_rep['wall_s']]}, "
        f"tokens/s {[round(x, 1) for x in slice_rep['tokens_per_s']]}, "
        f"repeat bit-identical: True, peak memory "
        f"{slice_rep['peak_mem_gb']:.1f} GB")
    w_ = slice_rep["warm"]
    log(f"  warm pass (group CSTs from the pass before): engine steps "
        f"{w_['fused_steps']}, tokens per step {w_['tokens_per_step']:.3f}"
        f", drafted {w_['drafted']}, accepted {w_['accepted']}, wall "
        f"{w_['wall_s']:.3f} s, {w_['tokens_per_s']:.1f} tokens/s, "
        f"responses equal to the cold pass: {w_['same_responses']}/"
        f"{len(lens)}")
    if args.profile:
        report["profile"] = profile_steps(torch, cfg, params, args.profile)
        p = report["profile"]
        log(f"  profile of {p['steps']} steps: wall {p['wall_ms']:.1f} "
            f"ms, device {p['device_ms']:.1f} ms (busy share "
            f"{p['busy_share']:.3f})")
        for k_, t_, n_ in p["top"][:12]:
            log(f"    {t_:10.3f} ms  x{n_:<6d} {k_[:90]}")

    log("tree engine: fused tree steps against the sync oracle")
    te = tree_engine_check(torch, np, cfg, params)
    report["tree_engine"] = te
    log(f"  {te['steps']} steps, each equal to the sync oracle from the "
        f"same state (tokens, accept counts, slot_pos, K/V at committed "
        f"slots), 1 host sync and {L} K2 launches each, dispatch clean "
        f"under sync debug 'error'; {te['accepted']} drafts accepted, "
        f"{te['side_branch_steps']} row-steps accepted along the side "
        f"branch; tree nodes {te['tree_nodes']} (branching "
        f"{te['tree_branch_nodes']})")

    log("tree slice: the same rollout with spec_mode='tree', 3 paths")
    ro = make_rollout(cfg, params, spec_mode="tree", multipath_top_k=3)
    warm = run_rollout(torch, ro, prompts)
    ro.reset_acceptance_profile()
    tr = run_rollout(torch, ro, prompts)
    del ro
    tst = tr["stats"]
    k2_launches = tr["launches"]["tree_verify"]
    for which, x in (("warm", warm), ("measured", tr)):
        check(x["finished"], f"tree rollout ({which}): not every group "
              "finished")
        check(x["launches"]["tree_verify"] == x["fused_steps"] * L,
              f"tree rollout ({which}): K2 launches "
              f"{x['launches']['tree_verify']} != {x['fused_steps']} "
              f"steps x {L}")
        check(x["launches"]["spec_verify"] == 0,
              f"tree rollout ({which}): K1 launched "
              f"{x['launches']['spec_verify']} times")
        check(x["host_syncs"] <= x["stats"].steps,
              f"tree rollout ({which}): host syncs {x['host_syncs']} > "
              f"steps {x['stats'].steps}")
    check(tst.accepted > 0, "tree rollout accepted no draft")
    check(tr["tree_branch_nodes"] > 0, "tree rollout verified no branching "
          "tree")
    tree_rep = {
        "tokens": tst.tokens, "steps": tst.steps,
        "fused_steps": tr["fused_steps"],
        "tokens_per_step": tst.tokens / tr["fused_steps"],
        "drafted": tst.drafted, "accepted": tst.accepted,
        "mean_acceptance": tst.mean_acceptance,
        "tree_nodes": tr["tree_nodes"],
        "tree_branch_nodes": tr["tree_branch_nodes"],
        "migrations": tst.migrations, "host_syncs": tr["host_syncs"],
        "k2_launches": k2_launches, "fused_by_T": tr["by_kind"],
        "wall_s": tr["wall_s"], "tokens_per_s": tst.tokens / tr["wall_s"],
        "same_responses_as_linear": sum(
            tr["responses"][k] == v for k, v in lw["responses"].items()),
        "warm": {"fused_steps": warm["fused_steps"],
                 "drafted": warm["stats"].drafted,
                 "accepted": warm["stats"].accepted,
                 "tree_nodes": warm["tree_nodes"],
                 "tree_branch_nodes": warm["tree_branch_nodes"],
                 "wall_s": warm["wall_s"],
                 "tokens_per_s": warm["stats"].tokens / warm["wall_s"]}}
    report["tree_slice"] = tree_rep
    log(f"  measured pass: tokens {tst.tokens}, engine steps "
        f"{tr['fused_steps']}, tokens per step "
        f"{tree_rep['tokens_per_step']:.3f}, drafted {tst.drafted}, "
        f"accepted {tst.accepted} (mean acceptance "
        f"{tst.mean_acceptance:.4f}), tree nodes {tr['tree_nodes']} "
        f"(branching {tr['tree_branch_nodes']}), migrations "
        f"{tst.migrations}, wall {tr['wall_s']:.3f} s, "
        f"{tree_rep['tokens_per_s']:.1f} tokens/s")
    log(f"  K2 launches {k2_launches} = {tr['fused_steps']} x {L}, K1 0; "
        f"host syncs {tr['host_syncs']} <= steps {tst.steps}; steps by "
        f"T {tr['by_kind']}; warm pass {warm['fused_steps']} steps, "
        f"drafted {warm['stats'].drafted}, accepted "
        f"{warm['stats'].accepted}, branching nodes "
        f"{warm['tree_branch_nodes']}, "
        f"{tree_rep['warm']['tokens_per_s']:.1f} tokens/s")
    log(f"  against the linear warm pass: tokens per step "
        f"{tree_rep['tokens_per_step']:.3f} vs {w_['tokens_per_step']:.3f}"
        f", tokens/s {tree_rep['tokens_per_s']:.1f} vs "
        f"{w_['tokens_per_s']:.1f}, responses equal "
        f"{tree_rep['same_responses_as_linear']}/{len(lens)}")
    del params
    torch.cuda.empty_cache()

    def commonest_T(by_kind):
        return int(max(by_kind, key=by_kind.get).split(":")[1])

    # each kernel's timing shape follows its slice: its most frequent step
    # width, and each slot's context halfway through; then a fixed set of
    # widths at 384 live slots, comparable across runs
    live = np.asarray([min(len(p) + NEW_TOKENS // 2, S)
                       for p in prompts for _ in range(GROUP_SIZE)][:B])
    fixed = [(T, np.full(B, 384)) for T in (1, 9, 64)]
    report["kernel_time"] = [
        kernels_time(torch, np, B=B, S=S, T=T, live=lv)
        for T, lv in [(commonest_T(r["by_kind"]), live)] + fixed]
    for tm in report["kernel_time"]:
        log(f"  spec_verify timing B={B} T={tm['T']} S={S} live~"
            f"{tm['live_mean']:.0f} bf16: {tm['ms']:.4f} ms, plain "
            f"{tm['plain_ms']:.4f} ms, SDPA {tm['library_ms']:.4f} ms, "
            f"bound {tm['bound_ms']:.4f} ms ({tm['bound_by']})")
    report["tree_kernel_time"] = [
        tree_kernels_time(torch, np, B=B, S=S, T=T, live=lv)
        for T, lv in [(commonest_T(tr["by_kind"]), live)] + fixed]
    for tm in report["tree_kernel_time"]:
        log(f"  tree_verify timing B={B} T={tm['T']} S={S} live~"
            f"{tm['live_mean']:.0f} bf16: {tm['ms']:.4f} ms (K1 on the "
            f"same inputs {tm['k1_ms']:.4f} ms), plain "
            f"{tm['plain_ms']:.4f} ms, SDPA {tm['library_ms']:.4f} ms, "
            f"bound {tm['bound_ms']:.4f} ms ({tm['bound_by']})")

    def kernel_row(name, tpu, launches, checks, tm):
        return {"name": name, "route": "cuda", "source": SPEC_VERIFY_SRC,
                "replaces": tpu, "launches": launches,
                "max_abs_err": max(c["max_abs_err"] for c in checks),
                "ms": tm["ms"], "plain_ms": tm["plain_ms"],
                "bound_ms": tm["bound_ms"], "bound_by": tm["bound_by"],
                "library_ms": tm["library_ms"]}
    rows = [kernel_row("spec_verify", SPEC_VERIFY_TPU, k1_launches,
                       report["kernel_checks"], report["kernel_time"][0]),
            kernel_row("tree_verify", TREE_VERIFY_TPU, k2_launches,
                       report["tree_kernel_checks"],
                       report["tree_kernel_time"][0])]

    report["wall_total_s"] = time.perf_counter() - t0
    if out_dir:
        with open(os.path.join(out_dir, "report.json"), "w") as f:
            json.dump(report, f, indent=1, default=str)
    log(card)
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except CheckFailed as e:
        print(f"chip_smoke: check failed: {e}", file=sys.stderr)
        sys.exit(1)
