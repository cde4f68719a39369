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
``[train] step=... loss=... gnorm=... ms`` lines.

``--pipe S`` (or ``pipeline_stages`` on the config) builds a mesh with a
``pipe`` axis and switches the Trainer onto the pipeline step
(``--pipe-schedule gpipe|1f1b`` picks the micro-op timetable);
``--model M`` adds a tensor-parallel ``model`` axis (composed into the
pipeline stages, or alone the GSPMD step's tensor and expert
parallelism); ``--pods P`` adds a ``pod`` axis whose gradient reduction
runs compressed (bf16 + error feedback) in the pipeline step unless
``--no-compress-pod-grads``, and in f32 in the GSPMD step.  ``--model``
or ``--pods`` without ``--pipe`` >= 2 trains with the GSPMD step
(``make_train_step(mesh=...)``; the data axis takes the ranks left).  A
mesh runs one process per rank::

    torchrun --nproc-per-node 4 -m repro_torch.launch.train \\
        --pipe 2 --model 2 --device cpu
    torchrun --standalone --nproc-per-node 4 -m repro_torch.launch.train \\
        --device cpu --model 2 --steps 2 --seq-len 16 --global-batch 4

(the world of N ranks plays the reference's device count; without
``--device`` each rank takes ``cuda:(local_rank % device_count)``).
Only rank 0 prints.
"""

from __future__ import annotations

import argparse
import atexit
import warnings

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
                    help="gradient-accumulation chunks (mesh-less step)")
    ap.add_argument("--pipe", type=int, default=0,
                    help="pipeline stages (0 = cfg.pipeline_stages; > 1 "
                         "builds a `pipe` mesh axis + the pipeline step)")
    ap.add_argument("--pipe-microbatches", type=int, default=0,
                    help="pipeline microbatches "
                         "(0 = cfg.pipeline_microbatches)")
    ap.add_argument("--pipe-schedule", default=None,
                    help="pipeline micro-op schedule: gpipe | 1f1b "
                         "(default cfg.pipeline_schedule)")
    ap.add_argument("--model", type=int, default=1,
                    help="tensor-parallel `model` axis size (> 1: TP in "
                         "the pipeline stages, or the GSPMD step)")
    ap.add_argument("--pods", type=int, default=1,
                    help="pod axis size (> 1 = multi-pod gradient reduction)")
    ap.add_argument("--no-compress-pod-grads", action="store_true",
                    help="plain fp32 psum over `pod` instead of bf16+EF")
    ap.add_argument("--full", action="store_true",
                    help="the published widths (default: the reduced config)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; raises without one)")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch, reduced=not args.full)
    pipe = args.pipe or cfg.pipeline_stages
    overrides = {}
    if pipe:
        overrides["pipeline_stages"] = pipe
    if args.pipe_microbatches:
        overrides["pipeline_microbatches"] = args.pipe_microbatches
    if args.pipe_schedule:
        overrides["pipeline_schedule"] = args.pipe_schedule
    if args.no_compress_pod_grads:
        overrides["compress_pod_grads"] = False
    if overrides:
        cfg = cfg.replace(**overrides)

    # validate the schedule name eagerly — a typo should die here with the
    # valid choices, not deep inside step construction
    from repro_torch.dist.pipeline import SCHEDULES
    if cfg.pipeline_schedule not in SCHEDULES:
        ap.error(f"--pipe-schedule {cfg.pipeline_schedule!r} is not a valid "
                 f"pipeline schedule; choose from {sorted(SCHEDULES)}")

    mesh = None
    say = print
    if pipe > 1 or args.pods > 1 or args.model > 1:
        import torch.distributed as dist
        from repro_torch.launch.mesh import init_distributed, make_host_mesh
        if not dist.is_initialized():
            init_distributed(args.device)
            atexit.register(dist.destroy_process_group)
        mesh = make_host_mesh(model=args.model, pipe=max(pipe, 1),
                              pods=args.pods, device=args.device)
        if mesh.rank != 0:
            def say(*_a, **_k):
                return None
        note = ""
        if args.pods > 1:
            # the compressed reduction lives in the pipeline step, which
            # the Trainer only selects for pipe >= 2 — say so instead of
            # claiming compression the GSPMD step won't do
            if args.no_compress_pod_grads:
                pod_grads = "fp32 psum"
            elif pipe > 1:
                pod_grads = "bf16+EF compressed"
            else:
                pod_grads = ("fp32 psum — compressed reduction needs the "
                             "shard_map step, pass --pipe >= 2")
            note = f" (pod grads: {pod_grads})"
        say(f"[train] mesh: {dict(mesh.shape)}{note}")
        say(f"[train] {mesh!r}")
        if pipe > 1:
            # surface the gcd clamp the Trainer will apply instead of
            # letting a non-dividing --pipe-microbatches remap silently
            from repro_torch.train.loop import pipeline_microbatch_clamp
            n_micro, local_b = pipeline_microbatch_clamp(
                cfg.pipeline_microbatches, args.global_batch, mesh)
            if n_micro != cfg.pipeline_microbatches and mesh.rank == 0:
                warnings.warn(
                    f"--pipe-microbatches {cfg.pipeline_microbatches} "
                    f"does not divide the per-shard batch {local_b}; the "
                    f"Trainer will clamp it to {n_micro}", stacklevel=1)

    tcfg = TrainConfig(steps=args.steps, seq_len=args.seq_len,
                       global_batch=args.global_batch, lr=args.lr,
                       ckpt_dir=args.ckpt_dir,
                       num_microbatches=args.microbatches)
    trainer = Trainer(cfg, tcfg, mesh=mesh, device=args.device)

    def on_straggler(step, dt):
        say(f"[train] straggler watermark: step {step} took {dt:.2f}s")

    trainer.straggler_hook = on_straggler
    log = trainer.run()
    for row in log[:: max(1, len(log) // 10)]:
        say(f"[train] step={row['step']:5d} loss={row['loss']:.4f} "
            f"gnorm={row['grad_norm']:.3f} {row['seconds']*1e3:.0f}ms")
    say(f"[train] final loss: {log[-1]['loss']:.4f} "
        f"(start {log[0]['loss']:.4f})")


if __name__ == "__main__":
    main()
