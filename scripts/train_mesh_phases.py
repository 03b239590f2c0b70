#!/usr/bin/env python3
"""Run only the mesh-training parts of ``chip_smoke.py`` on one card,
without the rest of that script's phases.

    python3 scripts/train_mesh_phases.py

Builds the kernels, then calls ``chip_smoke``'s own functions:
``check_ssd_train_shards`` (``ssd_scan`` and its backward at the Mamba2
mesh step's rank shapes, each against its plain version, timed beside its
bound) and ``train_mesh_phase`` (the S = 4096 chunked TinyLlama train step
with no ``flash_attention`` launch, the one-card references, the mesh step
at world size 1 over NCCL bit for bit, then ``TRAIN_MESH_DRIVES`` as two
ranks sharing the card over gloo), with the same assertions as in
``chip_smoke.py`` (the fused chunked serving drive's 220 launches are not
checked: it does not run here). A failing part is reported and the next
one still runs; the exit code is 1 if any failed. Prints one JSON line of
the results. Needs one CUDA card; weights are random from a seed.
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
        print("train_mesh_phases: needs a CUDA card", file=sys.stderr)
        return 3
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(CS.card_line(), flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda}", flush=True)
    t0 = time.perf_counter()
    _build.build_all()
    print(f"built in {time.perf_counter() - t0:.1f} s", flush=True)
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
        torch.cuda.empty_cache()

    run("train_shard_shapes", CS.check_ssd_train_shards, torch,
        get_config("mamba2-370m"), timer)
    run("train_mesh", CS.train_mesh_phase, torch, None)
    print(json.dumps({"failed": failed, "results": results}, default=str))
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
