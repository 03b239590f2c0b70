#!/usr/bin/env python3
"""Do the fused attention layers' K / V projections and ``morph_matmul``
depend on how many rows one launch carries?

    python3 scripts/rowcount_probe.py

At full TinyLlama-1.1B shapes (B = 8 slots, d_model 2048, 4 KV heads of
64, a 512-row bf16 cache, seeded random weights), compares bit for bit:
the ``fused_verify`` K / V candidates of each row at S = 8 against the
same rows scored at S = 3 and S = 1 (at their own positions), the cache
row ``fused_decode_step`` writes for that token against both, and
``morph_matmul`` (f32 x on its FMA route, bf16 x on its tensor-core
route) over 8 rows per slot at once against one row at a time and 3 at a
time. A failover replay chunk scores 8 rows per slot where the source
engine scored 1 (decode) or K + 1 (verify), so any difference here shows
up in a restored cache. Prints, per comparison, how many elements differ
and by how much. Needs one CUDA card.
"""
from __future__ import annotations

import math
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))


def main() -> int:
    import torch

    import chip_smoke as CS
    from repro_torch.configs import get_config
    from repro_torch.kernels import _build
    from repro_torch.kernels import fused_decode as FD
    from repro_torch.kernels import morph_matmul as MM

    if not torch.cuda.is_available():
        print("rowcount_probe: needs a CUDA card", file=sys.stderr)
        return 3
    print(CS.card_line(), flush=True)
    _build.build_all()
    cfg = get_config("tinyllama-1.1b")
    B, Sc, S = 8, 512, 8
    dm, H, KV, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    g = torch.Generator(device="cuda").manual_seed(1)

    def w(n_in, n_out):
        return torch.randn(n_in, n_out, generator=g,
                           device="cuda") / math.sqrt(n_in)

    p = {"wq": w(dm, H * hd), "wk": w(dm, KV * hd), "wv": w(dm, KV * hd),
         "wo": w(H * hd, dm)}
    cache = {n: torch.randn(B, Sc, KV, hd, generator=g,
                            device="cuda").to(torch.bfloat16) for n in "kv"}
    pos = torch.tensor([0, 1, 63, 64, 200, 333, 450, Sc - S],
                       dtype=torch.int32, device="cuda")
    x = torch.randn(B, S, dm, generator=g, device="cuda").to(torch.bfloat16)

    def diff(what, a, b):
        d = (a.float() - b.float()).abs()
        print(f"  {what}: {int((d > 0).sum())} of {d.numel()} elements "
              f"differ, max {float(d.max()):.3e}", flush=True)

    _, kv8 = FD.fused_verify(p, x, cache, pos, cfg)
    _, kv3 = FD.fused_verify(p, x[:, :3].contiguous(), cache, pos, cfg)
    for n in "kv":
        diff(f"fused_verify {n}, rows 0-2: S = 3 vs S = 8", kv3[n],
             kv8[n][:, :3])
    for j in range(S):
        xj = x[:, j:j + 1].contiguous()
        _, kv1 = FD.fused_verify(p, xj, cache, pos + j, cfg)
        c = {n: t.clone() for n, t in cache.items()}
        FD.fused_decode_step(p, xj, c, pos + j, cfg)
        rows = (pos + j).long()
        for n in "kv":
            dec = c[n][torch.arange(B, device="cuda"), rows]
            diff(f"row {j} {n}: verify S = 1 vs S = 8", kv1[n][:, 0],
                 kv8[n][:, j])
            diff(f"row {j} {n}: decode's cache row vs verify S = 1", dec,
                 kv1[n][:, 0].to(dec.dtype))
    for dt in (torch.float32, torch.bfloat16):
        xx = x.to(dt)
        y8 = MM.morph_matmul(xx, p["wk"])
        y1 = torch.cat([MM.morph_matmul(xx[:, j:j + 1].contiguous(),
                                        p["wk"]) for j in range(S)], dim=1)
        y3 = MM.morph_matmul(xx[:, :3].contiguous(), p["wk"])
        diff(f"morph_matmul {dt}: one row at a time vs 8 at once", y1, y8)
        diff(f"morph_matmul {dt}: 3 rows vs 8 at once", y3, y8[:, :3])
    torch.cuda.synchronize()
    return 0


if __name__ == "__main__":
    sys.exit(main())
