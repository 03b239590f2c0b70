#!/usr/bin/env python3
"""Run only the failover and restart phases of ``chip_smoke.py`` on one
card, without the rest of that script's phases.

    python3 scripts/failover_phases.py

Builds the kernels, then calls ``chip_smoke``'s own functions:
``check_replay_chunk`` (the fused verify kernel at the replay chunk's
shape against its plain version), every drive of ``FAILOVER_DRIVES``
(unsupervised, under a counting supervisor and as a chaos run, with the
same assertions as in ``chip_smoke.py``) and ``restart_drive`` (a
full-depth Mamba2-370M ``TrainRunner`` restart, bit for bit). Each runs
here in a fresh process state, so its peak memory is its own. A failing
phase is reported and the next one still runs; the exit code is 1 if any
failed. Prints one JSON line of the results. Needs one CUDA card;
weights are random from a seed.
"""
from __future__ import annotations

import gc
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
        print("failover_phases: needs a CUDA card", file=sys.stderr)
        return 3
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(CS.card_line(), flush=True)
    t0 = time.perf_counter()
    _build.build_all()
    print(f"built in {time.perf_counter() - t0:.1f} s", flush=True)
    cfg, mcfg = get_config("tinyllama-1.1b"), get_config("mamba2-370m")
    timer = CS.Timer(torch)
    results, failed = {}, []

    def run(name, fn, *args):
        t = time.perf_counter()
        try:
            results[name] = fn(*args)
        except (SystemExit, Exception):
            traceback.print_exc()
            failed.append(name)
        print(f"  [{name}: {time.perf_counter() - t:.1f} s]", flush=True)
        gc.collect()
        torch.cuda.empty_cache()

    run("replay_chunk", CS.check_replay_chunk, torch, cfg, timer)
    for spec in CS.FAILOVER_DRIVES:
        run(spec[0], CS.failover_drive, torch, *spec)
    run("mamba2_restart", CS.restart_drive, torch, mcfg)
    print(json.dumps({"failed": failed, "results": results}, default=str))
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
