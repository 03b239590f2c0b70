#!/usr/bin/env python3
"""Run only the mesh parts of ``chip_smoke.py`` on one card, without the
rest of that script's phases.

    python3 scripts/mesh_phases.py

Builds the kernels, then calls ``chip_smoke``'s own functions:
``check_shard_shapes`` (``morph_matmul``, the fused decode and the fused
verify at TinyLlama's tp = 2 shard shapes, each against its plain version,
timed beside its bound and the library call), ``check_family_shard_shapes``
(the same kernels, ``flash_decode`` and ``flash_attention`` at the granite,
whisper and internvl tp = 2 shard shapes) and ``mesh_phase``
(``MeshExecutor`` at world size 1 over NCCL against ``LocalExecutor``,
then every drive of ``MESH_DRIVES``, the model drives, the autoscaled
drive and ``serve_2d`` as two ranks sharing the card over gloo), with the
same assertions as in ``chip_smoke.py``. A failing part is
reported and the next one still runs; the exit code is 1 if any failed.
Prints one JSON line of the results. Needs one CUDA card; weights are
random from a seed.
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
        print("mesh_phases: needs a CUDA card", file=sys.stderr)
        return 3
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(CS.card_line(), flush=True)
    t0 = time.perf_counter()
    _build.build_all()
    print(f"built in {time.perf_counter() - t0:.1f} s", flush=True)
    cfg = get_config("tinyllama-1.1b")
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

    run("shard_shapes", lambda: {k: CS.shard_row(v) for k, v in
                                 CS.check_shard_shapes(torch, cfg,
                                                       timer).items()})
    run("family_shard_shapes", CS.check_family_shard_shapes, torch, timer)
    run("mesh", CS.mesh_phase, torch)
    print(json.dumps({"failed": failed, "results": results}, default=str))
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
