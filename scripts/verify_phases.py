#!/usr/bin/env python3
"""Where the verify attention launch spends its time, phase by phase, on one
card.

    python3 scripts/verify_phases.py

Builds a copy of ``src/repro_torch/csrc`` under ``build/verify_phases/``
(git-ignored) whose decode-attention core (``decode_attn.cuh``) has thread 0
of every block record ``clock64()`` at the boundaries of its phases, loads
that build of ``fused_verify.cu`` in place of the plain one, and runs one
fused verify layer at ``chip_smoke.py``'s phase-2 shape (TinyLlama-1.1B,
B = 8 slots, S = 5, a 512-row bf16 cache, full width) with the L2 flushed
before the timed call, at mixed committed counts and at none (every split
empty: the launch's fixed cost). Prints, per case, the mean and the largest
time over the launch's blocks from the block's start to each boundary, in
thousands of SM cycles, and in microseconds at the card's maximum SM clock
(``nvidia-smi``'s ``clocks.max.sm``, the clock a busy card runs at unless
its power limit holds it lower; an idle card reads lower). Boundaries: ``begun``
(the unit's length read), ``q loaded``, ``prepared`` (RoPE, candidates,
extension scores), ``q converted`` (the bf16 hi / lo rows), per chunk 0
and 1 of the block ``data`` (landed), ``QK`` and ``softmax`` (done),
``loop end``, ``block merged``, ``cluster sync``, ``pass 1`` and ``pass 2``
of the merge, ``end``. The stamps are inserted by matching lines of the
core's source; a line that moved makes the script fail, not guess.
"""
from __future__ import annotations

import ctypes
import json
import math
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

# (line of decode_attn.cuh, stamp, insert after the line (else before))
ANCHORS = (
    ("  P pb = prm;\n", 0, True),
    ("  const int n = pb.begin(unit, h0, nh);\n", 1, True),
    ("  pb.template load_q<HDP, MR>(qs, LQ, ext, t);\n  __syncthreads();\n",
     2, True),
    ("  pb.template prepare<HDP, MR>(qs, LQ, ext, t);\n  __syncthreads();\n",
     3, True),
    ("  float acc[MT][ND][4];\n", 4, False),
    ("    if (w0 >= rend) continue;                      // warp-uniform\n",
     "C0", False),
    ("    // scale (and the k scale), mask, online softmax over the warp's "
     "rows\n", "C1", False),
    ("    if constexpr (kTC) {\n      // O += P V, P = p_hi + p_lo straight "
     "from the S fragments\n", "C2", False),
    ("  ptx::cp_async_wait<0>();\n  __syncthreads();  // the ring is free",
     19, False),
    ("  __syncthreads();  // the ring is free: the warps' partials take its "
     "place\n", 5, True),
    ("  ptx::cluster_sync();  // every block's partial is written; every row "
     "read\n", 6, False),
    ("  pb.after_merge(ext, split, hg, t);\n", 7, False),
    ("    __syncthreads();\n    for (int i = t; i < mine * (HDP / 4); "
     "i += kThreads) {", 8, "after_first_line"),
    ("    ptx::cluster_sync_relaxed();\n    return;\n", 9, False),
)
NAMES = {0: "start", 1: "begun", 2: "q loaded", 3: "prepared",
         4: "q converted", 10: "chunk 0 data", 11: "chunk 0 QK",
         12: "chunk 0 softmax", 14: "chunk 1 data", 15: "chunk 1 QK",
         16: "chunk 1 softmax", 19: "loop end", 5: "ring free",
         6: "block merged", 7: "cluster sync", 8: "pass 1", 9: "pass 2",
         18: "end"}


def stamped_sources(dst: Path) -> None:
    src = ROOT / "src" / "repro_torch" / "csrc"
    shutil.rmtree(dst, ignore_errors=True)
    shutil.copytree(src, dst)
    h = (dst / "decode_attn.cuh").read_text()
    h = h.replace("namespace da {", """namespace da {
__device__ long long g_stamps[8192][20];
#define STAMP(k) if (threadIdx.x == 0) \\
  g_stamps[(blockIdx.x * gridDim.y + blockIdx.y) % 8192][k] = clock64();
#define STAMPC(k) if (threadIdx.x == 0 && c < 2) \\
  g_stamps[(blockIdx.x * gridDim.y + blockIdx.y) % 8192][10 + 4 * c + (k)] \\
      = clock64();
""", 1)
    for line, k, after in ANCHORS:
        i = h.find(line)
        if i < 0:
            raise SystemExit(f"verify_phases: line not found in the core: "
                             f"{line!r}")
        stamp = (f"STAMPC({k[1]})" if isinstance(k, str) else f"STAMP({k})")
        if after == "after_first_line":
            j = i + len(line.split("\n")[0]) + 1
            h = h[:j] + f"    {stamp}\n" + h[j:]
        elif after:
            h = h[:i + len(line)] + f"  {stamp}\n" + h[i + len(line):]
        else:
            h = h[:i] + f"  {stamp}\n" + h[i:]
    end = "    ptx::cluster_sync_relaxed();\n    return;\n"
    j = h.index(end) + len("    ptx::cluster_sync_relaxed();\n")
    h = h[:j] + "    STAMP(18)\n" + h[j:]
    (dst / "decode_attn.cuh").write_text(h)
    with open(dst / "fused_verify.cu", "a") as f:
        f.write("""
extern "C" int verify_phases_read(long long* out) {
  return (int)cudaMemcpyFromSymbol(out, da::g_stamps, sizeof(da::g_stamps));
}
extern "C" int verify_phases_clear() {
  static long long z[8192][20];
  return (int)cudaMemcpyToSymbol(da::g_stamps, z, sizeof(z));
}
""")


def main() -> int:
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(1, str(ROOT))
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("verify_phases: needs a CUDA card", file=sys.stderr)
        return 3
    import chip_smoke as cs
    from repro_torch.configs import get_config
    from repro_torch.core import elastic
    from repro_torch.kernels import _build
    from repro_torch.kernels import fused_decode as FD

    dst = ROOT / "build" / "verify_phases"
    stamped_sources(dst)
    lib_path = dst / "libfused_verify_phases.so"
    r = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(dst),
                        "-o", str(lib_path), str(dst / "fused_verify.cu")],
                       capture_output=True, text=True)
    if r.returncode:
        print(r.stdout[-4000:], r.stderr[-4000:], file=sys.stderr)
        return 1
    lib = ctypes.CDLL(str(lib_path))
    _build._LIBS["fused_verify"] = lib  # the stamped build for this run
    mhz = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"],
        capture_output=True, text=True, check=True).stdout.split()[0])
    cfg = get_config("tinyllama-1.1b")
    B, Sc, S = 8, 512, 5
    dm, H, KV, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    gen = torch.Generator(device="cuda").manual_seed(6)
    params = {n: torch.randn(*sh, generator=gen, device="cuda") / math.sqrt(sh[0])
              for n, sh in (("wq", (dm, H * hd)), ("wk", (dm, KV * hd)),
                            ("wv", (dm, KV * hd)), ("wo", (H * hd, dm)))}
    act = elastic.active_widths_batch(cfg, [1.0] * B, device="cuda")
    cache = {n: torch.randn(B, Sc, KV, hd, generator=gen, device="cuda")
             .to(torch.bfloat16) for n in ("k", "v")}
    x = torch.randn(B, S, dm, generator=gen, device="cuda").to(torch.bfloat16)
    flush = torch.empty(256 * 2**20, dtype=torch.uint8, device="cuda")
    print(f"card: {cs.card_line()}; max SM clock {mhz:.0f} MHz", flush=True)
    for tag, pl in (("mixed", [0, 1, 63, 64, 200, 333, 450, 505]),
                    ("no cache rows", [0] * B)):
        pos = torch.tensor(pl, dtype=torch.int32, device="cuda")
        runs = []
        for it in range(6):
            FD.fused_verify(params, x, cache, pos, cfg, active=act)
            flush.zero_()
            torch.cuda.synchronize()
            lib.verify_phases_clear()
            FD.fused_verify(params, x, cache, pos, cfg, active=act)
            torch.cuda.synchronize()
            st = np.zeros((8192, 20), np.int64)
            lib.verify_phases_read(st.ctypes.data_as(ctypes.c_void_p))
            if it:  # the first is a warm-up
                runs.append(st[(st[:, 0] != 0) & (st[:, 18] != 0)])
        st = np.concatenate(runs).astype(np.float64)
        rel = np.where(st != 0, st - st[:, :1], np.nan)  # cycles
        seen = [k for k in NAMES if np.isfinite(rel[:, k]).any()]
        with np.errstate(all="ignore"):
            mean = {NAMES[k]: float(np.nanmean(rel[:, k])) for k in seen}
            top = {NAMES[k]: float(np.nanmax(rel[:, k])) for k in seen}
        print(json.dumps(dict(
            case=tag, positions=pl, blocks=len(st) // len(runs),
            mean_kcycles={k: round(v / 1e3, 2) for k, v in mean.items()},
            max_kcycles={k: round(v / 1e3, 2) for k, v in top.items()},
            mean_us_at_max_clock={k: round(v / mhz, 2) for k, v in mean.items()},
            max_us_at_max_clock={k: round(v / mhz, 2) for k, v in top.items()})),
            flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
