#!/usr/bin/env python3
"""Mesh training over four cards, one rank a card over NCCL.

    python3 scripts/train_mesh_nccl.py

Builds the kernels, then runs ``chip_smoke``'s ``train_mesh_ranks`` as 4
ranks, one card each (``launch.mesh.spawn_ranks`` picks NCCL), on a
(2, 2) mesh: full-width Mamba2-370M cut to 8 layers (f32, B = 8, S = 256,
AdamW, 3 steps) and TinyLlama-1.1B cut to 2 layers (bf16 activations, 2
steps, sequence parallelism), each held to the one-card step that
``train_mesh_local`` computes first on card 0, with the checks of
``chip_smoke.py``'s ``train_mesh_phase`` (``TRAIN_MESH_TOL``, each
rank's exact kernel launches, its state bytes beside the dry-run's) and
its step wall and device ms. Prints the cards, then one JSON line of the
results. Needs four CUDA cards; weights are random from a seed.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

DRIVES = (
    ("mamba2_2x2", "mamba2-370m", (2, 2), 3, "float32", False, False),
    ("tinyllama_2x2_sp", "tinyllama-1.1b", (2, 2), 2, "float32", True,
     False),
)


def main() -> int:
    import torch

    import chip_smoke as CS
    from repro_torch.kernels import _build
    from repro_torch.launch.mesh import spawn_ranks

    if torch.cuda.device_count() < 4:
        print("train_mesh_nccl: needs four CUDA cards", file=sys.stderr)
        return 3
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True).stdout,
        flush=True)
    t0 = time.perf_counter()
    _build.build_all()
    print(f"built in {time.perf_counter() - t0:.1f} s", flush=True)
    out_dir = tempfile.mkdtemp(prefix="train_mesh_nccl_")
    for _, arch, _, steps, gdt, _, bf16mm in DRIVES:
        ref = CS.train_mesh_local(torch, arch, steps, gdt, bf16mm)
        torch.save(ref, os.path.join(
            out_dir, f"{CS._ref_key(arch, steps, gdt, bf16mm)}.pt"))
        del ref
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    spawn_ranks(CS.train_mesh_ranks, 4, (out_dir, DRIVES, ((2, 2),)),
                device="cuda")
    print(f"ranks: {time.perf_counter() - t0:.1f} s", flush=True)
    with open(os.path.join(out_dir, "train_mesh.json")) as f:
        print(json.dumps(json.load(f)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
