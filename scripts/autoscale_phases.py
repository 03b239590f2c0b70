#!/usr/bin/env python3
"""Run only the online autoscaler's phase of ``chip_smoke.py`` on one card,
without the rest of that script's phases.

    python3 scripts/autoscale_phases.py

Builds the kernels, then calls ``chip_smoke.autoscale_phase``: every drive
of ``AUTOSCALE_DRIVES`` (full-width TinyLlama-1.1B dense with the standby
drive on its snapshot, paged, and 4 layers in f32), with the same
assertions as in ``chip_smoke.py``. Prints the card's name and power
limit first and one JSON line of the results last; the exit code is 1 if
the phase failed. Needs one CUDA card; weights are random from a seed.
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
    from repro_torch.kernels import _build

    if not torch.cuda.is_available():
        print("autoscale_phases: needs a CUDA card", file=sys.stderr)
        return 3
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(CS.card_line(), flush=True)
    t0 = time.perf_counter()
    _build.build_all()
    print(f"built in {time.perf_counter() - t0:.1f} s", flush=True)
    t0 = time.perf_counter()
    try:
        launches, results = CS.autoscale_phase(torch)
    except (SystemExit, Exception):
        traceback.print_exc()
        print(json.dumps({"failed": True}))
        return 1
    print(f"  [autoscale phase: {time.perf_counter() - t0:.1f} s]",
          flush=True)
    print(json.dumps({"failed": False, "launches": launches,
                      "results": results}, default=str))
    return 0


if __name__ == "__main__":
    sys.exit(main())
