#!/usr/bin/env python3
"""Drive the PyTorch port (``src/repro_torch``) on one NVIDIA card.

    python3 chip_smoke.py [--profile N] [--out DIR]

Phases, in this order:

1. the card's name and power limit, as nvidia-smi prints them;
2. build of the hand-written kernels from ``src/repro_torch/kernels``;
3. kernels: each kernel against its plain PyTorch version on the card
   at granite-3-8b's head shapes, and at every other head dim the
   kernel is built for;
4. slice: a full-width, full-depth granite-3-8b Seer rollout (random
   weights from a seed, bf16) on two instances through the port's entry
   points, with its checks: every group finishes, every cached attention
   launched K1, at most one host sync per engine step, dispatch free of
   host syncs under ``torch.cuda.set_sync_debug_mode("error")``, and a
   repeat run bit-identical;
5. timing: each kernel at the shape the slice gave it, beside its plain
   version, a library call and the card's bound.  Its ``launches`` are
   the slice's.

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


def _sv_bound_ms(q, k, q_pos, k_pos, window, dtype):
    """Least time for one K1 call on these inputs, and what sets it: K/V
    rows of the slots some query of the row can see, q, out and both
    position arrays, each moved once, against 4*Hq*D operations per
    visible (query, key)."""
    from repro_torch.kernels.spec_verify.ref import pos_mask
    B, T, Hq, D = q.shape
    Hk = k.shape[2]
    vis = pos_mask(q_pos, k_pos, window)                     # (B,T,S)
    n_vis = int(vis.sum())
    n_slots = int(vis.any(dim=1).sum())
    es = q.element_size()
    nbytes = (2 * q.numel() * es + 4 * (q_pos.numel() + k_pos.numel())
              + 2 * n_slots * Hk * D * es)
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = 4 * Hq * D * n_vis / PEAK_OPS[dtype]
    return 1e3 * max(t_bytes, t_ops), \
        "bytes" if t_bytes >= t_ops else "operations"


def _time_ms(torch, fn, iters: int, flush=None) -> float:
    """Mean device time of ``fn`` over ``iters`` calls (CUDA events around
    each call; ``flush`` runs before each, outside the timed window)."""
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
    return sum(a.elapsed_time(b) for a, b in pairs) / iters


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

    n0 = ops.launches
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
    bound_ms, bound_by = _sv_bound_ms(q, k, qp, kp, 0, dtype)
    ops.launches = n0            # timing launches are not the main path's
    return {"T": T, "dtype": dtype, "live_mean": float(np.mean(live)),
            "ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "max_abs_err": err}


# ---------------------------------------------------------------------------
# phase 4: the slice
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


def run_rollout(torch, cfg, params, prompts):
    from repro_torch.core import SeerRollout, make_groups
    from repro_torch.kernels.spec_verify import ops
    ro = SeerRollout(cfg, params, n_instances=2, max_slots=8,
                     cache_len=2048, chunk_size=CHUNK_SIZE,
                     policy="seer", spec_decode=True, device="cuda")
    groups = make_groups(prompts, group_size=GROUP_SIZE,
                         max_new_tokens=NEW_TOKENS, seed=3,
                         temperature=1.0)
    torch.cuda.synchronize()
    ops.reset_launches()
    t0 = time.perf_counter()
    res = ro.run(groups)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    st = ro.steps
    out = {"responses": res.responses(), "wall_s": wall,
           "launches": ops.launches, "fused_steps": st.invocations,
           "by_kind": dict(st.invocations_by_kind),
           "host_syncs": st.host_syncs, "stats": res.stats,
           "finished": all(g.all_finished for g in res.groups)}
    del ro
    return out


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

    log("slice: granite-3-8b Seer rollout on the card")
    cfg, params = build_model(torch)
    prompts = make_prompts(np, cfg, GROUPS, seed=1)
    report["sync_debug"] = sync_debug_steps(torch, np, cfg, params)
    log(f"  dispatch under sync debug 'error': T per step "
        f"{report['sync_debug']['step_T']}, host syncs "
        f"{report['sync_debug']['host_syncs_per_step']}")
    runs = [run_rollout(torch, cfg, params, prompts) for _ in range(2)]
    r = runs[0]
    st = r["stats"]
    check(r["finished"], "not every group finished")
    check(r["launches"] > 0, "the rollout launched K1 no time")
    check(r["launches"] == r["fused_steps"] * cfg.num_layers,
          f"K1 launches {r['launches']} != cached forwards "
          f"{r['fused_steps']} x {cfg.num_layers}")
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
        "layers": cfg.num_layers, "requests": len(lens),
        "tokens": st.tokens, "steps": st.steps, "chunks": st.chunks,
        "migrations": st.migrations, "drafted": st.drafted,
        "accepted": st.accepted, "mean_acceptance": st.mean_acceptance,
        "host_syncs": r["host_syncs"], "k1_launches": r["launches"],
        "fused_by_T": r["by_kind"],
        "wall_s": [x["wall_s"] for x in runs],
        "tokens_per_s": [st.tokens / x["wall_s"] for x in runs],
        "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9}
    report["slice"] = slice_rep
    log(f"  tokens {st.tokens}, steps {st.steps}, chunks {st.chunks}, "
        f"migrations {st.migrations}, drafted {st.drafted}, accepted "
        f"{st.accepted} (mean acceptance {st.mean_acceptance:.4f})")
    log(f"  K1 launches {r['launches']} = {r['fused_steps']} cached "
        f"forwards x {cfg.num_layers}; host syncs {r['host_syncs']} "
        f"<= steps {st.steps}; fused steps by T {r['by_kind']}")
    log(f"  wall s {[round(x, 3) for x in slice_rep['wall_s']]}, "
        f"tokens/s {[round(x, 1) for x in slice_rep['tokens_per_s']]}, "
        f"repeat bit-identical: True, peak memory "
        f"{slice_rep['peak_mem_gb']:.1f} GB")
    if args.profile:
        report["profile"] = profile_steps(torch, cfg, params, args.profile)
        p = report["profile"]
        log(f"  profile of {p['steps']} steps: wall {p['wall_ms']:.1f} "
            f"ms, device {p['device_ms']:.1f} ms (busy share "
            f"{p['busy_share']:.3f})")
        for k_, t_, n_ in p["top"][:12]:
            log(f"    {t_:10.3f} ms  x{n_:<6d} {k_[:90]}")
    del params
    torch.cuda.empty_cache()

    # K1's timing shape follows the slice: its most frequent step width,
    # and each slot's context halfway through; then a fixed set of widths
    # at 384 live slots, comparable across runs
    main_T = int(max(r["by_kind"], key=r["by_kind"].get).split(":")[1])
    live = np.asarray([min(len(p) + NEW_TOKENS // 2, S)
                       for p in prompts for _ in range(GROUP_SIZE)][:B])
    shapes = [(main_T, live)] + [(T, np.full(B, 384)) for T in (1, 9, 64)]
    report["kernel_time"] = [kernels_time(torch, np, B=B, S=S, T=T, live=lv)
                             for T, lv in shapes]
    for tm in report["kernel_time"]:
        log(f"  spec_verify timing B={B} T={tm['T']} S={S} live~"
            f"{tm['live_mean']:.0f} bf16: {tm['ms']:.4f} ms, plain "
            f"{tm['plain_ms']:.4f} ms, SDPA {tm['library_ms']:.4f} ms, "
            f"bound {tm['bound_ms']:.4f} ms ({tm['bound_by']})")
    tm = report["kernel_time"][0]
    kernel_row = {"name": "spec_verify", "route": "cuda",
                  "source": SPEC_VERIFY_SRC, "replaces": SPEC_VERIFY_TPU,
                  "launches": r["launches"],
                  "max_abs_err": max(c["max_abs_err"]
                                     for c in report["kernel_checks"]),
                  "ms": tm["ms"], "plain_ms": tm["plain_ms"],
                  "bound_ms": tm["bound_ms"], "bound_by": tm["bound_by"],
                  "library_ms": tm["library_ms"]}

    report["wall_total_s"] = time.perf_counter() - t0
    if out_dir:
        with open(os.path.join(out_dir, "report.json"), "w") as f:
            json.dump(report, f, indent=1, default=str)
    log(card)
    print(json.dumps({"kernels": [kernel_row]}))
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
