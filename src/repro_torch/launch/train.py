"""Training entry point: base training, then an optional DistillCycle phase.

Port of ``repro.launch.train`` with the same flags and the same ``[train]``
/ ``[distill]`` lines, plus ``--device``: it runs on the card (``cuda``,
the default) unless ``--device cpu`` is given. The reference's
``TrainRunner`` (checkpoint / restart, straggler monitoring, failure
injection) belongs to the robustness item of the port (ROADMAP A6); until
then this entry point runs a plain step loop, and ``--ckpt-dir``,
``--ckpt-every``, ``--async-ckpt`` and ``--inject-failure-at`` raise when
set to anything but their defaults.

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

# the reference's defaults; checkpointing is not ported, so no directory
_CKPT_DEFAULTS = {"ckpt_dir": None, "ckpt_every": 25, "async_ckpt": False,
                  "inject_failure_at": -1}


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
    ap.add_argument("--ckpt-dir", default=_CKPT_DEFAULTS["ckpt_dir"])
    ap.add_argument("--ckpt-every", type=int,
                    default=_CKPT_DEFAULTS["ckpt_every"])
    ap.add_argument("--async-ckpt", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--distill", action="store_true",
                    help="run a DistillCycle phase after base training")
    ap.add_argument("--inject-failure-at", type=int,
                    default=_CKPT_DEFAULTS["inject_failure_at"])
    ap.add_argument("--metrics-out", default="")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu; no fallback between them")
    args = ap.parse_args(argv)
    for name, default in _CKPT_DEFAULTS.items():
        if getattr(args, name) != default:
            flag = "--" + name.replace("_", "-")
            raise NotImplementedError(
                f"{flag}: checkpointing, restarts and failure injection "
                f"arrive with the robustness item of the port (ROADMAP A6)")
    device = resolve_device(args.device)

    cfg = smoke_config(args.arch) if args.smoke else get_config(args.arch)
    ocfg = OptimizerConfig(lr=args.lr)
    dc = DataConfig(seed=args.seed, global_batch=args.batch, seq_len=args.seq)
    sched = warmup_cosine(1.0, max(args.steps // 20, 1), args.steps)
    step = make_train_step(cfg, ocfg, microbatches=args.microbatches,
                           remat=args.remat, lr_schedule=sched)
    state = init_train_state(cfg, ocfg, seed=args.seed, device=device)

    metrics_log = []
    t0 = time.time()
    for i in range(args.steps):
        state, m = step(state, make_batch(cfg, dc, i))
        metrics_log.append({"step": i, **{k: float(v) for k, v in m.items()}})
    wall = time.time() - t0
    losses = [m["loss"] for m in metrics_log]
    print(f"[train] {cfg.name}: {len(metrics_log)} steps in {wall:.1f}s "
          f"loss {losses[0]:.3f} -> {losses[-1]:.3f} on {device}")

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
            json.dump({"metrics": metrics_log}, f)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
