"""CLI: end-to-end synchronous RL training with Seer rollout, on the
port.

Counterpart of ``repro.launch.train``.  Runs the real-engine tier on the
card (``--device cuda``, the default) or, asked, on the CPU, using the
tiny variant of one of the port's configs:

  PYTHONPATH=src python -m repro_torch.launch.train --arch granite-3-8b \\
      --iterations 20 --groups 8 --group-size 8 --task copy --device cpu

``--full`` selects the full published config (guarded by a size check).
"""
from __future__ import annotations

import argparse
import dataclasses
import json


def main(argv=None):
    from repro_torch.configs import get_config, get_tiny_config, list_archs

    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="granite-3-8b", choices=list_archs())
    ap.add_argument("--task", default="copy",
                    choices=["copy", "sort", "succ"])
    ap.add_argument("--iterations", type=int, default=20)
    ap.add_argument("--groups", type=int, default=8)
    ap.add_argument("--group-size", type=int, default=8)
    ap.add_argument("--max-new-tokens", type=int, default=12)
    ap.add_argument("--train-steps", type=int, default=2)
    ap.add_argument("--instances", type=int, default=2)
    ap.add_argument("--policy", default="seer")
    ap.add_argument("--no-spec-decode", action="store_true")
    ap.add_argument("--vocab", type=int, default=32)
    ap.add_argument("--lr", type=float, default=2e-4)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--full", action="store_true")
    ap.add_argument("--checkpoint-dir", default=None)
    ap.add_argument("--out", default=None)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    from repro_torch.data.tasks import make_task
    from repro_torch.training import OptConfig, RLConfig, RLTrainer

    cfg = get_config(args.arch) if args.full else get_tiny_config(args.arch)
    if args.full and cfg.num_params() > 2e9:
        raise SystemExit("--full on a model >2B params needs a real cluster")
    if args.vocab:
        cfg = dataclasses.replace(cfg, vocab_size=args.vocab)
    task = make_task(args.task, cfg.vocab_size, prompt_len=4,
                     response_len=args.max_new_tokens,
                     content_vocab=min(8, cfg.vocab_size - 3))
    rl = RLConfig(
        n_groups=args.groups, group_size=args.group_size,
        max_new_tokens=args.max_new_tokens, iterations=args.iterations,
        train_steps_per_iter=args.train_steps,
        n_instances=args.instances, max_slots=args.group_size * 2,
        cache_len=128, chunk_size=args.max_new_tokens // 2 or 8,
        policy=args.policy, spec_decode=not args.no_spec_decode,
        seed=args.seed, checkpoint_dir=args.checkpoint_dir,
        checkpoint_every=5 if args.checkpoint_dir else 0,
        device=args.device)
    tr = RLTrainer(cfg, task, rl, ocfg=OptConfig(
        lr=args.lr, total_steps=args.iterations * args.train_steps,
        warmup_steps=4))
    hist = tr.run()
    summary = {
        "arch": args.arch, "task": args.task, "device": str(tr.device),
        "first_reward": hist[0].mean_reward,
        "last_reward": hist[-1].mean_reward,
        "rollout_frac": sum(h.rollout_seconds for h in hist) / max(
            sum(h.rollout_seconds + h.train_seconds
                + h.weight_update_seconds for h in hist), 1e-9),
        "mean_acceptance": hist[-1].mean_acceptance,
    }
    print(json.dumps(summary, indent=1))
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"summary": summary,
                       "history": [dataclasses.asdict(h) for h in hist]},
                      f, indent=1, default=float)


if __name__ == "__main__":
    main()
