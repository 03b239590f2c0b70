#!/usr/bin/env python3
"""Find what makes a seeded Mamba2 training step differ from run to run on
one card.

    python3 scripts/determinism_probe.py [--layers N] [--steps N]

Full-width Mamba2-370M (``--layers`` cuts the depth; default the full 48),
B = 8 x S = 256 from ``DataConfig(seed=0)``, AdamW:

1. ``loss_fn`` gradients on batch 0 from ``init_params(seed=0)``, twice in
   one process: every gradient leaf compared bit for bit, the leaves that
   differ printed with their largest difference;
2. ``--steps`` ``make_train_step`` steps from ``init_train_state(seed=0)``,
   twice: parameters and moments compared bit for bit;
3. the same gradients in a child process under
   ``torch.use_deterministic_algorithms(True)`` (with
   ``CUBLAS_WORKSPACE_CONFIG=:4096:8``), as a probe only: an op with no
   deterministic implementation raises and is printed; otherwise the two
   runs' gradients are compared there too.

Prints one JSON line: the differing leaves per part and the probe's
outcome. Needs one CUDA card; weights are random from a seed.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def _setup(layers):
    import dataclasses

    import torch

    from repro_torch.configs import get_config
    from repro_torch.data import DataConfig, make_batch, to_device

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = get_config("mamba2-370m")
    if layers:
        cfg = dataclasses.replace(cfg, n_layers=layers)
    dc = DataConfig(seed=0, global_batch=8, seq_len=256)
    return torch, cfg, dc, lambda i: to_device(make_batch(cfg, dc, i), "cuda")


def _diff(torch, a, b):
    """{leaf: max |a - b|} over the leaves whose bits differ."""
    return {k: float((a[k].double() - b[k].double()).abs().max())
            for k in a if not torch.equal(a[k], b[k])}


def grads_twice(layers):
    torch, cfg, _, batch = _setup(layers)
    from repro_torch.models.model import init_params, loss_fn
    from repro_torch.optim import grads_of, trainable
    from repro_torch.optim.optimizer import leaves_with_path

    runs = []
    for _ in range(2):
        p = trainable(init_params(cfg, seed=0, device="cuda"))
        loss, _ = loss_fn(p, batch(0), cfg)
        runs.append({k: t.detach().clone()
                     for k, t in leaves_with_path(grads_of(loss, p))})
        runs[-1]["loss"] = loss.detach().clone()
        del p
    torch.cuda.synchronize()
    return _diff(torch, *runs)


def steps_twice(layers, n_steps):
    torch, cfg, _, batch = _setup(layers)
    from repro_torch.launch.steps import init_train_state, make_train_step
    from repro_torch.optim import OptimizerConfig
    from repro_torch.optim.optimizer import leaves_with_path

    ocfg = OptimizerConfig(lr=2e-3)
    runs, losses = [], []
    for _ in range(2):
        state = init_train_state(cfg, ocfg, seed=0, device="cuda")
        step = make_train_step(cfg, ocfg, remat="none")
        hist = []
        for i in range(n_steps):
            state, m = step(state, batch(i % 4))
            hist.append(m["loss"].item())
        losses.append(hist)
        runs.append({f"{part}/{k}": t.detach().clone()
                     for part, tree in (("params", state["params"]),
                                        ("mu", state["opt"].mu),
                                        ("nu", state["opt"].nu))
                     for k, t in leaves_with_path(tree)})
        del state
    torch.cuda.synchronize()
    return _diff(torch, *runs), losses


def probe_child(layers):
    """Run in a fresh process: deterministic algorithms on."""
    torch, *_ = _setup(layers)
    torch.use_deterministic_algorithms(True)
    try:
        return {"raised": None, "grads_differ": grads_twice(layers)}
    except RuntimeError as e:
        return {"raised": str(e).splitlines()[0][:400]}


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--layers", type=int, default=0)
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--child", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args()
    sys.path.insert(0, str(ROOT / "src"))
    if args.child:
        print(json.dumps(probe_child(args.layers)), flush=True)
        return 0
    out = {"grads_differ": grads_twice(args.layers)}
    out["steps_differ"], out["step_losses"] = steps_twice(args.layers,
                                                          args.steps)
    env = dict(os.environ, CUBLAS_WORKSPACE_CONFIG=":4096:8")
    r = subprocess.run([sys.executable, __file__, "--child", "--layers",
                        str(args.layers)], env=env, capture_output=True,
                       text=True, timeout=600)
    lines = r.stdout.strip().splitlines()
    out["deterministic_mode"] = (json.loads(lines[-1]) if r.returncode == 0
                                 and lines else {"rc": r.returncode,
                                                 "stderr": r.stderr[-800:]})
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
