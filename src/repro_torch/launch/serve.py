"""CLI: serve a small model with batched requests through the Seer rollout
subsystem (divided rollout + context-aware scheduling + grouped SD), on
the port.

Counterpart of ``repro.launch.serve``, with the same flags and the same
report, plus ``--device`` (``cuda``, the default, or ``cpu``):

  PYTHONPATH=src python -m repro_torch.launch.serve --arch yi-6b \\
      --groups 6 --group-size 8 --max-new-tokens 48 --device cpu

It serves the tiny variant of the architecture, with random weights made
from ``--seed``, and reports throughput, acceptance statistics and
scheduling counters: the serving-side view of the system (no training).
"""
from __future__ import annotations

import argparse
import json
import time


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="yi-6b")
    ap.add_argument("--groups", type=int, default=6)
    ap.add_argument("--group-size", type=int, default=8)
    ap.add_argument("--max-new-tokens", type=int, default=48)
    ap.add_argument("--instances", type=int, default=2)
    ap.add_argument("--slots", type=int, default=8)
    ap.add_argument("--cache-len", type=int, default=512)
    ap.add_argument("--chunk", type=int, default=32)
    ap.add_argument("--policy", default="seer",
                    choices=["seer", "fifo", "nocontext", "sfs", "lfs"])
    ap.add_argument("--no-spec-decode", action="store_true")
    ap.add_argument("--multipath", type=int, default=1)
    ap.add_argument("--temperature", type=float, default=0.7)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=None)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    import numpy as np
    import torch

    from repro_torch.configs import get_tiny_config
    from repro_torch.core import SeerRollout, make_groups
    from repro_torch.device import resolve_device
    from repro_torch.models import init_params

    dev = resolve_device(args.device)
    cfg = get_tiny_config(args.arch)
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(
        args.seed), device=dev)
    rng = np.random.default_rng(args.seed)
    prompts = [rng.integers(3, 16, size=6).tolist()
               for _ in range(args.groups)]
    groups = make_groups(prompts, args.group_size,
                         max_new_tokens=args.max_new_tokens,
                         temperature=args.temperature, seed=args.seed)
    ro = SeerRollout(cfg, params, n_instances=args.instances,
                     max_slots=args.slots, cache_len=args.cache_len,
                     chunk_size=args.chunk, policy=args.policy,
                     spec_decode=not args.no_spec_decode,
                     multipath_top_k=args.multipath, device=dev)
    t0 = time.time()
    res = ro.run(groups, progress_every=50)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    dt = time.time() - t0
    s = res.stats
    report = {
        "arch": args.arch, "policy": args.policy,
        "requests": sum(g.size for g in groups),
        "tokens": s.tokens, "wall_seconds": round(dt, 1),
        "tokens_per_sec": round(s.tokens / dt, 1),
        "engine_steps": s.steps, "chunks": s.chunks,
        "migrations": s.migrations,
        "drafted": s.drafted, "accepted": s.accepted,
        "mean_acceptance": round(s.mean_acceptance, 3),
        "pool": res.pool_stats, "dgds": res.dgds_stats,
        "ctx": res.ctx_stats,
    }
    print(json.dumps(report, indent=1))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(report, f, indent=1)
    return report


if __name__ == "__main__":
    main()
