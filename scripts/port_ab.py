#!/usr/bin/env python3
"""Time the PyTorch/H100 port's verify and scan paths on one card, for a
before/after comparison of two source trees inside one run.

    python3 scripts/port_ab.py --src SRC_DIR [--tag NAME] [--spec]

``SRC_DIR`` is the ``src`` directory of a checkout: this one, or a parent
commit unpacked with ``git archive`` into a git-ignored directory. The
script imports ``repro_torch`` from it (its kernels build into that
checkout's ``build/kernels``) and the timer and input helpers of this
checkout's ``chip_smoke.py``, so both trees are timed the same way.
Compare two trees in turns (parent, change, change, parent) in one run on
one card. It prints one JSON line with:

* ``decode``: one fused decode layer at ``chip_smoke.py``'s phase-2 shape
  (TinyLlama-1.1B, B = 8 slots, a 1024-row bf16 cache at mixed positions,
  mixed widths) and over a 512-row cache, device ms by launch, each timed
  twice in turns;
* ``verify``: one fused verify layer at ``chip_smoke.py``'s phase-2 shape
  (TinyLlama-1.1B, B = 8 slots, S = 5, a 512-row bf16 cache at mixed
  committed counts, mixed widths), device ms by launch (QKV, attention:
  every kernel that is not a projection, ``wo``), timed as
  ``chip_smoke.py`` times it: once (``check``), then after an int8-cache
  (2, 2) tree verify has run, again (``profiler``);
* ``ssd_scan``: the scan at the full-width Mamba2-370M prompt pass (S =
  256), a ragged S = 200, and the reference's ``kernel_bench`` shape;
* ``mamba2_prompt``: a full-depth 256-token Mamba2-370M prompt pass, host
  ms, device ms and the scans' device ms;
* with ``--spec``, ``spec_tick``: host and device ms of one fused
  TinyLlama-1.1B speculative tick (4 drafts at depth 16, verify at 22).

``--attention-only`` prints ``decode`` and ``verify`` alone. Needs one
CUDA card; weights are random from a seed.
"""
from __future__ import annotations

import argparse
import json
import math
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def parts(times):
    """Device ms of a verify layer by launch."""
    out = {"qkv": 0.0, "attention": 0.0, "wo": 0.0}
    for name, t in times.items():
        if "gated_gemm<float, float" in name:
            out["wo"] += t
        elif "gated_gemm" in name:
            out["qkv"] += t
        else:
            out["attention"] += t
    return out


def verify_layer(torch, cs, timer, cfg):
    import dataclasses

    from repro_torch.core import elastic
    from repro_torch.kernels import fused_decode as FD
    from repro_torch.models import layers as L

    B, Sc, S = 8, 512, 5
    dm, H, KV, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    gen = torch.Generator(device="cuda").manual_seed(6)
    params = {
        "wq": torch.randn(dm, H * hd, generator=gen, device="cuda") / math.sqrt(dm),
        "wk": torch.randn(dm, KV * hd, generator=gen, device="cuda") / math.sqrt(dm),
        "wv": torch.randn(dm, KV * hd, generator=gen, device="cuda") / math.sqrt(dm),
        "wo": torch.randn(H * hd, dm, generator=gen, device="cuda") / math.sqrt(H * hd),
    }
    act = elastic.active_widths_batch(
        cfg, [0.25, 0.5, 1.0, 0.25, 0.5, 1.0, 0.5, 0.25], device="cuda")
    pos = torch.tensor([0, 1, 63, 64, 200, 333, 450, 505], dtype=torch.int32,
                       device="cuda")
    cache = {n: torch.randn(B, Sc, KV, hd, generator=gen, device="cuda")
             .to(torch.bfloat16) for n in ("k", "v")}
    x = torch.randn(B, S, dm, generator=gen, device="cuda").to(torch.bfloat16)

    def run():
        return FD.fused_verify(params, x, cache, pos, cfg, active=act)

    res = {}
    layer = timer.ms(run)
    res["check"] = dict(layer_ms=layer, **parts(timer.last))
    depths, bias = cs.tree_np((2, 2))
    qcfg = dataclasses.replace(cfg, kv_quant=True)
    k8, ks = L.quantize_kv(torch.randn(B, Sc, KV, hd, generator=gen,
                                       device="cuda"))
    v8, vs = L.quantize_kv(torch.randn(B, Sc, KV, hd, generator=gen,
                                       device="cuda"))
    c8 = {"k": k8, "v": v8, "k_scale": ks, "v_scale": vs}
    x7 = torch.randn(B, len(depths), dm, generator=gen,
                     device="cuda").to(torch.bfloat16)
    timer.ms(lambda: FD.fused_verify(params, x7, c8, pos, qcfg, active=act,
                                     node_depth=depths, tree_bias=bias))
    layer = timer.ms(run)
    res["profiler"] = dict(layer_ms=layer, **parts(timer.last))
    return res


def decode_layer(torch, cs, timer, cfg):
    from repro_torch.core import elastic
    from repro_torch.kernels import fused_decode as FD

    B = 8
    dm, H, KV, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    gen = torch.Generator(device="cuda").manual_seed(2)
    params = {
        "wq": torch.randn(dm, H * hd, generator=gen, device="cuda") / math.sqrt(dm),
        "wk": torch.randn(dm, KV * hd, generator=gen, device="cuda") / math.sqrt(dm),
        "wv": torch.randn(dm, KV * hd, generator=gen, device="cuda") / math.sqrt(dm),
        "wo": torch.randn(H * hd, dm, generator=gen, device="cuda") / math.sqrt(H * hd),
    }
    act = elastic.active_widths_batch(
        cfg, [0.25, 0.5, 1.0, 0.25, 0.5, 1.0, 0.5, 0.25], device="cuda")
    x = torch.randn(B, 1, dm, generator=gen, device="cuda").to(torch.bfloat16)
    res = {}
    for S, pos in ((1024, [0, 1, 63, 64, 200, 511, 777, 1023]),
                   (512, [0, 1, 63, 64, 200, 333, 450, 505])):
        cache = {n: torch.randn(B, S, KV, hd, generator=gen, device="cuda")
                 .to(torch.bfloat16) for n in ("k", "v")}
        pos_t = torch.tensor(pos, dtype=torch.int32, device="cuda")

        def run():
            return FD.fused_decode_step(params, x, cache, pos_t, cfg,
                                        active=act)

        for rep in ("first", "second"):
            layer = timer.ms(run)
            res[f"S={S} {rep}"] = dict(layer_ms=layer, **parts(timer.last))
    return res


def scans(torch, cs, timer, mcfg):
    from repro_torch.kernels import ops

    h, p, g, n, q = (mcfg.ssm_nheads, mcfg.ssm_head_dim, mcfg.ssm_ngroups,
                     mcfg.ssm_state, mcfg.ssm_chunk)
    gen = torch.Generator(device="cuda").manual_seed(9)
    out = {}
    for tag, (b, s, hh, pp, gg, nn, qq) in (
            ("S=256", (1, 256, h, p, g, n, q)),
            ("S=200", (1, 200, h, p, g, n, q)),
            ("kernel_bench", (2, 256, 4, 32, 1, 16, 64))):
        x, dt, A, B, C = cs.scan_inputs(torch, gen, b, s, hh, pp, gg, nn)
        out[tag] = timer.ms(lambda: ops.ssd_scan_bshn(x, dt, A, B, C,
                                                      chunk=qq))
    return out


def mamba2_prompt(torch, cs, mcfg, seq=256, iters=5):
    from repro_torch.models.model import prefill

    params = cs.init_on_card(torch, mcfg)
    toks = (torch.arange(seq, device="cuda")[None] * 31 + 7) % mcfg.vocab_size

    def run():
        return prefill(params, {"tokens": toks}, mcfg, cache_extra=0)

    run()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        run()
    torch.cuda.synchronize()
    host = (time.perf_counter() - t0) / iters * 1e3
    per = cs.kernel_us(torch, run, iters)
    dev = sum(per.values()) / iters / 1e3
    scan = sum(v for k, v in per.items() if "ssd_" in k) / iters / 1e3
    del params
    torch.cuda.empty_cache()
    return dict(host_ms=host, device_ms=dev, scan_ms=scan)


def spec_tick(torch, cs, cfg):
    from repro_torch.runtime.serving import ServingEngine
    from repro_torch.runtime.speculative import SpecConfig

    params = cs.init_on_card(torch, cfg)
    engine = ServingEngine(params, cfg, batch_size=8, cache_capacity=512,
                           prefill_threshold=8, fused=True,
                           speculative=SpecConfig(ks=(cs.SPEC_K,),
                                                  min_accept_rate=0.0),
                           device="cuda")
    engine.warmup()
    host, dev = cs.spec_tick_ms(torch, engine)
    del engine, params
    torch.cuda.empty_cache()
    return dict(host_ms=host, device_ms=dev)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", required=True, help="a checkout's src directory")
    ap.add_argument("--tag", default="", help="a name for the printed line")
    ap.add_argument("--spec", action="store_true",
                    help="also time a fused TinyLlama speculative tick")
    ap.add_argument("--attention-only", action="store_true",
                    help="time the fused decode and verify layers only")
    args = ap.parse_args(argv)
    src = Path(args.src).resolve()
    if not (src / "repro_torch").is_dir():
        print(f"port_ab: no repro_torch under {src}", file=sys.stderr)
        return 2
    sys.path.insert(0, str(src))
    sys.path.insert(1, str(ROOT))
    import torch

    if not torch.cuda.is_available():
        print("port_ab: needs a CUDA card", file=sys.stderr)
        return 3
    torch.backends.cuda.matmul.allow_tf32 = False
    import chip_smoke as cs
    from repro_torch.configs import get_config
    from repro_torch.kernels import _build

    _build.build_all()
    cfg, mcfg = get_config("tinyllama-1.1b"), get_config("mamba2-370m")
    timer = cs.Timer(torch)
    res = dict(tag=args.tag, src=str(src), card=cs.card_line(),
               decode=decode_layer(torch, cs, timer, cfg),
               verify=verify_layer(torch, cs, timer, cfg))
    if not args.attention_only:
        res.update(ssd_scan=scans(torch, cs, timer, mcfg),
                   mamba2_prompt=mamba2_prompt(torch, cs, mcfg))
    if args.spec:
        res["spec_tick"] = spec_tick(torch, cs, cfg)
    print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
