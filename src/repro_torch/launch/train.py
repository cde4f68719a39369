"""Training launcher:
``python -m repro_torch.launch.train --arch stablelm-3b --full``.

Trains a model of any family (dense, e.g. stablelm-3b; moe,
olmoe-1b-7b and deepseek-v2-lite-16b; ssm, mamba2-1.3b; hybrid,
zamba2-2.7b; encdec, whisper-large-v3, over the data pipeline's stub
audio frames) on ``--device`` (the card by default; it refuses to start
when there is none) with the reference's flags: ``--device cpu`` trains
the reduced config on the CPU, ``--full`` takes the published widths
and depths (card only, in practice; the moe models' AdamW state at full
depth exceeds one card).  It prints the reference's
``[train] step=... loss=... gnorm=... ms`` lines.  The reference's
``--pipe``, ``--model`` and ``--pods`` meshes wait for the port's
distribution slice (ROADMAP A14): above their defaults they raise.
"""

from __future__ import annotations

import argparse

from repro_torch.configs import ARCHS, get_config
from repro_torch.train import TrainConfig, Trainer


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="stablelm-3b", choices=list(ARCHS))
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--microbatches", type=int, default=1,
                    help="gradient-accumulation chunks")
    ap.add_argument("--pipe", type=int, default=0,
                    help="pipeline stages (not ported: ROADMAP A14)")
    ap.add_argument("--pipe-microbatches", type=int, default=0,
                    help="pipeline microbatches "
                         "(0 = cfg.pipeline_microbatches)")
    ap.add_argument("--pipe-schedule", default=None,
                    help="pipeline micro-op schedule: gpipe | 1f1b "
                         "(default cfg.pipeline_schedule)")
    ap.add_argument("--model", type=int, default=1,
                    help="tensor-parallel axis size (not ported: A14)")
    ap.add_argument("--pods", type=int, default=1,
                    help="pod axis size (not ported: A14)")
    ap.add_argument("--no-compress-pod-grads", action="store_true",
                    help="plain fp32 psum over `pod` instead of bf16+EF")
    ap.add_argument("--full", action="store_true",
                    help="the published widths (default: the reduced config)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; raises without one)")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch, reduced=not args.full)
    pipe = args.pipe or cfg.pipeline_stages
    if pipe > 1 or args.model > 1 or args.pods > 1:
        raise NotImplementedError(
            f"--pipe {pipe} / --model {args.model} / --pods {args.pods}: "
            f"meshes are not ported yet; see ROADMAP A14 (distribution)")
    overrides = {}
    if args.pipe_microbatches:
        overrides["pipeline_microbatches"] = args.pipe_microbatches
    if args.pipe_schedule:
        overrides["pipeline_schedule"] = args.pipe_schedule
    if args.no_compress_pod_grads:
        overrides["compress_pod_grads"] = False
    if overrides:
        cfg = cfg.replace(**overrides)

    tcfg = TrainConfig(steps=args.steps, seq_len=args.seq_len,
                       global_batch=args.global_batch, lr=args.lr,
                       ckpt_dir=args.ckpt_dir,
                       num_microbatches=args.microbatches)
    trainer = Trainer(cfg, tcfg, device=args.device)

    def on_straggler(step, dt):
        print(f"[train] straggler watermark: step {step} took {dt:.2f}s")

    trainer.straggler_hook = on_straggler
    log = trainer.run()
    for row in log[:: max(1, len(log) // 10)]:
        print(f"[train] step={row['step']:5d} loss={row['loss']:.4f} "
              f"gnorm={row['grad_norm']:.3f} {row['seconds']*1e3:.0f}ms")
    print(f"[train] final loss: {log[-1]['loss']:.4f} "
          f"(start {log[0]['loss']:.4f})")


if __name__ == "__main__":
    main()
