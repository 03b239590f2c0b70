#!/usr/bin/env python3
"""Run only ``chip_smoke.py``'s ``cost_phase`` on one card, without the
rest of that script's phases.

    python3 scripts/cost_phase.py

Builds the kernels, then calls ``chip_smoke.cost_phase``: the op-trace
walker (``repro_torch.launch.op_analysis``) held to real steps at the
published width and full depth (TinyLlama-1.1B's unfused and fused
decode steps, Mamba2-370M's decode step, 256-token prompt pass and train
step; B = 8, cache 512), with the same assertions as in ``chip_smoke.py``:
traced launches equal the wrappers' counters, traced bytes at least
``step_bytes``, the train step's memory rise within ``COST_MEM_RATIO`` of
the trace's argument + temp bytes. Prints the card's name and power limit
and one JSON line of the results; exit code 1 if the phase failed. Needs
one CUDA card; weights are random from a seed.
"""
from __future__ import annotations

import json
import sys
import time
import traceback
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))


def main() -> int:
    import torch

    import chip_smoke as CS
    from repro_torch.configs import get_config
    from repro_torch.kernels import _build

    if not torch.cuda.is_available():
        print("cost_phase: needs a CUDA card", file=sys.stderr)
        return 3
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = CS.card_line()
    print(card, flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda}", flush=True)
    t0 = time.perf_counter()
    _build.build_all()
    print(f"built in {time.perf_counter() - t0:.1f} s", flush=True)
    t0 = time.perf_counter()
    try:
        res = CS.cost_phase(torch, get_config("tinyllama-1.1b"),
                            get_config("mamba2-370m"), card)
        ok = True
    except (SystemExit, Exception):
        traceback.print_exc()
        res, ok = {}, False
    print(f"  [cost_phase: {time.perf_counter() - t0:.1f} s]", flush=True)
    print(json.dumps({"ok": ok, "results": res}, default=str))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
