"""Training entry point: base training, then an optional DistillCycle phase.

Port of ``repro.launch.train`` with the same flags and the same ``[train]``
/ ``[distill]`` lines, plus ``--device``: it runs on the card (``cuda``,
the default) unless ``--device cpu`` is given. With ``--ckpt-dir`` the
steps run through ``runtime.fault_tolerance.TrainRunner``: a checkpoint
every ``--ckpt-every`` steps (written on a thread with ``--async-ckpt``),
straggler monitoring, an injected failure before step
``--inject-failure-at``, and restarts from the latest checkpoint that end
on the uninterrupted run's state. Unlike the reference, ``--ckpt-dir`` has
no default: without it nothing is written and the steps run in a plain
loop (a default directory would let a stale checkpoint silently resume an
unrelated run), and the other three flags are an error.

Examples:
  PYTHONPATH=src python -m repro_torch.launch.train --arch tinyllama-1.1b \
      --smoke --steps 200 --distill --device cpu
  PYTHONPATH=src python -m repro_torch.launch.train --arch mamba2-370m \
      --steps 50 --seq 256
"""
from __future__ import annotations

import argparse
import json
import os
import time

from repro_torch.configs import get_config, smoke_config
from repro_torch.core.distillcycle import DistillCycle, DistillCycleConfig
from repro_torch.data import DataConfig, make_batch
from repro_torch.device import resolve_device
from repro_torch.launch.steps import init_train_state, make_train_step
from repro_torch.optim import OptimizerConfig, warmup_cosine
from repro_torch.runtime.fault_tolerance import (FailurePlan,
                                                 StragglerMonitor,
                                                 TrainRunner)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true",
                    help="reduced same-family config (CPU-runnable)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--remat", default="none", choices=["none", "dots", "full"])
    ap.add_argument("--ckpt-dir", default=None,
                    help="checkpoint directory; resumes from its latest "
                         "checkpoint (default: none, no checkpoints)")
    ap.add_argument("--ckpt-every", type=int, default=None,
                    help="steps between checkpoints (default 25; needs "
                         "--ckpt-dir)")
    ap.add_argument("--async-ckpt", action="store_true",
                    help="write checkpoints on a thread (needs --ckpt-dir)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--distill", action="store_true",
                    help="run a DistillCycle phase after base training")
    ap.add_argument("--inject-failure-at", type=int, default=None,
                    help="inject one failure before this step; the runner "
                         "restarts from the latest checkpoint (needs "
                         "--ckpt-dir)")
    ap.add_argument("--metrics-out", default="")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu; no fallback between them")
    args = ap.parse_args(argv)
    if args.ckpt_dir is None:
        for flag, val in (("--ckpt-every", args.ckpt_every),
                          ("--async-ckpt", args.async_ckpt or None),
                          ("--inject-failure-at", args.inject_failure_at)):
            if val is not None:
                ap.error(f"{flag} needs --ckpt-dir")
    device = resolve_device(args.device)

    cfg = smoke_config(args.arch) if args.smoke else get_config(args.arch)
    ocfg = OptimizerConfig(lr=args.lr)
    dc = DataConfig(seed=args.seed, global_batch=args.batch, seq_len=args.seq)
    sched = warmup_cosine(1.0, max(args.steps // 20, 1), args.steps)
    step = make_train_step(cfg, ocfg, microbatches=args.microbatches,
                           remat=args.remat, lr_schedule=sched)

    def init_state():
        return init_train_state(cfg, ocfg, seed=args.seed, device=device)

    t0 = time.time()
    runner = None
    if args.ckpt_dir is None:
        state = init_state()
        metrics_log = []
        for i in range(args.steps):
            state, m = step(state, make_batch(cfg, dc, i))
            metrics_log.append({"step": i,
                                **{k: float(v) for k, v in m.items()}})
    else:
        at = args.inject_failure_at
        runner = TrainRunner(
            cfg, step, init_state, dc, args.ckpt_dir,
            ckpt_every=args.ckpt_every or 25, async_ckpt=args.async_ckpt,
            failure_plan=FailurePlan(at_steps=(at,) if at is not None
                                     and at >= 0 else ()),
            straggler=StragglerMonitor())
        state = runner.run_with_restarts(args.steps)
        metrics_log = runner.metrics_log
    wall = time.time() - t0
    losses = [m["loss"] for m in metrics_log] or [float("nan")]
    note = ""
    if runner is not None:
        note = (f" ckpt={args.ckpt_dir} steps run={len(metrics_log)} "
                f"restarts={len(runner.failure_plan._fired)} "
                f"stragglers={len(runner.straggler.flagged)}")
    print(f"[train] {cfg.name}: {args.steps} steps in {wall:.1f}s "
          f"loss {losses[0]:.3f} -> {losses[-1]:.3f} on {device}{note}")

    if args.distill:
        dcfg = DistillCycleConfig(epochs_per_stage=1,
                                  steps_per_epoch=max(args.steps // 10, 4),
                                  epoch_lr_decay=1.0)
        cyc = DistillCycle(cfg, ocfg, dc, dcfg=dcfg)
        params, _ = cyc.run(state["params"], state["opt"])
        state["params"] = params
        ev = cyc.eval_modes(params)
        print("[distill] per-mode eval CE:",
              {k: round(v, 3) for k, v in ev.items()})

    if args.metrics_out:
        os.makedirs(os.path.dirname(args.metrics_out) or ".", exist_ok=True)
        with open(args.metrics_out, "w") as f:
            json.dump({"metrics": metrics_log,
                       "stragglers": (runner.straggler.flagged
                                      if runner is not None else [])}, f)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
