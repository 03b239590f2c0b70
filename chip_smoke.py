#!/usr/bin/env python3
"""Drive the PyTorch/H100 port (``src/repro_torch``) once on one card.

Phases (any failure exits non-zero; nothing is caught into a pass):

1. Device and build: print the card's name and power limit, build every
   CUDA kernel of the serving path from ``src/repro_torch/csrc`` for sm_90a
   (one nvcc per source, started together) and print the build seconds and
   ptxas register/spill lines.
2. Kernels vs their plain versions, on the card, at full TinyLlama-1.1B
   shapes in bf16 with B = 8 slots at mixed widths {0.25, 0.5, 1.0}:
   ``morph_matmul`` over the seven projections of one decoder layer plus a
   width that is not tile-aligned; ``fused_decode_step`` on a 1024-row
   cache at mixed positions, plain and int8-KV. Each is timed on the card
   (device time of its kernels from ``torch.profiler``, L2 flushed before
   every call; the CUDA-event time of the whole call, host launch gaps
   included, is printed beside it) together with its plain version, a
   library yardstick where one PyTorch call computes the same function,
   and its bound from the H100 data sheet.
3. End to end: full-width ``tinyllama-1.1b`` with seeded random weights
   through the port's ``ServingEngine`` (8 slots, a 24-request Poisson
   trace, cache 512, prefill threshold 8, width and depth switches), once
   unfused and once with ``fused=True``. Launch counters are zeroed just
   before each drive and read just after it, and each path must show its
   exact counts (unfused: 7 ``morph_matmul`` per decoder-layer step and no
   ``fused_decode``; fused: 3 ``morph_matmul`` and 1 ``fused_decode``).
   Also: the decode step at all-0.25 vs all-1.0 width, fused vs unfused token
   agreement, and the smoke model on the card against the plain versions
   on the CPU (a small-input reference).
4. A ``{"kernels": [...]}`` JSON line, then the last line
   ``{"ok": true, "device": {...}}``.

Run from the repository root: ``python3 chip_smoke.py``. Needs one CUDA
card; exits non-zero without one, and outside a checkout of the repository.
``--skip-e2e`` stops after phase 2 (for a quick kernel check).
"""
from __future__ import annotations

import argparse
import json
import math
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

# NVIDIA H100 SXM data sheet (dense, no sparsity)
HBM_BYTES_PER_S = 3.35e12
PEAK_BF16 = 989e12
PEAK_F32 = 67e12

# kernel vs plain on the card, bf16 outputs: one bf16 rounding step apart
# (the two sum in different orders, then round) plus a small absolute floor
RTOL_BF16 = 2.0 ** -7
ATOL_BF16 = 1e-3
# smoke model (f32) on the card vs the plain versions on the CPU
ATOL_SMOKE = 1e-3


def log(msg: str) -> None:
    print(msg, flush=True)


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke FAILED: {msg}")


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def kernel_us(torch, fn, iters: int):
    """Per-kernel device microseconds over ``iters`` calls of ``fn``, from
    ``torch.profiler`` (CUPTI sees the ctypes-launched kernels too)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    return {r.key: r.self_device_time_total for r in prof.key_averages()
            if r.device_type == DeviceType.CUDA}


class Timer:
    """Device time of one call, with a cold L2 before each call.

    ``ms`` sums the durations of the GPU kernels the call launched, from
    ``torch.profiler``, leaving out the L2 flush's own kernel (found by name
    in a flush-only profile); a call the profiler sees no device time for
    fails the run. ``wall_ms`` is the CUDA-event time of the whole call,
    host launch gaps included."""

    def __init__(self, torch):
        self.torch = torch
        self.flush_buf = torch.empty(256 * 2**20, dtype=torch.uint8,
                                     device="cuda")
        self.flush_names = set(kernel_us(torch, self._flush, 2))
        self.last = {}

    def _flush(self):
        self.flush_buf.zero_()

    def wall_ms(self, fn, iters: int = 20) -> float:
        torch = self.torch
        pairs = []
        for _ in range(iters):
            self._flush()
            s = torch.cuda.Event(enable_timing=True)
            e = torch.cuda.Event(enable_timing=True)
            s.record()
            fn()
            e.record()
            pairs.append((s, e))
        torch.cuda.synchronize()
        return sum(s.elapsed_time(e) for s, e in pairs) / iters

    def ms(self, fn, iters: int = 20, warmup: int = 3) -> float:
        for _ in range(warmup):
            fn()
        self.torch.cuda.synchronize()

        def call():
            self._flush()
            fn()

        per = {k: v / iters / 1e3 for k, v in kernel_us(self.torch, call,
                                                       iters).items()
               if k not in self.flush_names}
        self.last = per
        if sum(per.values()) <= 0.0:
            fail("torch.profiler recorded no device time for a timed call")
        return sum(per.values())


def close(torch, got, want, rtol=RTOL_BF16, atol=ATOL_BF16):
    g, w = got.float(), want.float()
    err = (g - w).abs()
    ok = bool((err <= atol + rtol * w.abs()).all())
    return ok, float(err.max()) if err.numel() else 0.0


# ---------------------------------------------------------------------------
# phase 2: kernels vs plain versions
# ---------------------------------------------------------------------------


def check_morph_matmul(torch, cfg, timer):
    from repro_torch.core import elastic
    from repro_torch.kernels import morph_matmul as MM

    B, dm, ff = 8, cfg.d_model, cfg.d_ff
    widths = [0.25, 0.5, 1.0, 0.25, 0.5, 1.0, 0.5, 0.25]
    act = elastic.active_widths_batch(cfg, widths, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(1)

    def w_(k, n):
        return torch.randn(k, n, generator=gen, device="cuda") / math.sqrt(k)

    qd, kvd = cfg.q_dim, cfg.kv_dim
    odd_n = torch.tensor([1000, 2048, 37, 512, 1999, 64, 2048, 1],
                         dtype=torch.int32, device="cuda")
    odd_k = torch.tensor([1500, 2048, 2047, 33, 700, 2048, 1, 96],
                         dtype=torch.int32, device="cuda")
    # name, K, N, active_n, active_k, calls per decoder layer
    cases = [
        ("wq", dm, qd, act["q_dim"], None, 1),
        ("wk/wv", dm, kvd, act["kv_dim"], None, 2),
        ("attn wo", qd, dm, None, act["q_dim"], 1),
        ("wi/wg", dm, ff, act["d_ff"], None, 2),
        ("mlp wo", ff, dm, None, act["d_ff"], 1),
        ("unaligned", dm, dm, odd_n, odd_k, 0),
    ]
    tot = dict(ms=0.0, plain_ms=0.0, bound_ms=0.0, library_ms=0.0)
    max_err = 0.0
    for name, K, N, an, ak, per_layer in cases:
        x = torch.randn(B, 1, K, generator=gen, device="cuda").to(torch.bfloat16)
        w = w_(K, N)
        got = MM.morph_matmul(x, w, an, ak)
        want = MM.morph_matmul_plain(x, w, an, ak)
        torch.cuda.synchronize()
        ok, err = close(torch, got, want)
        if an is not None:
            cols = torch.arange(N, device="cuda")[None, None, :]
            dead = cols >= an[:, None, None]
            if bool((got[dead] != 0).any()):
                fail(f"morph_matmul {name}: columns past active_n not zero")
        if not ok:
            fail(f"morph_matmul {name} {K}x{N}: max |err| {err:.3e} beyond "
                 f"rtol {RTOL_BF16:.2e} + atol {ATOL_BF16:.0e}")
        max_err = max(max_err, err)
        t_k = timer.ms(lambda: MM.morph_matmul(x, w, an, ak))
        t_kw = timer.wall_ms(lambda: MM.morph_matmul(x, w, an, ak))
        t_p = timer.ms(lambda: MM.morph_matmul_plain(x, w, an, ak))
        wb = w.to(torch.bfloat16)
        x2 = x[:, 0]
        t_l = timer.ms(lambda: torch.matmul(x2, wb))
        # bound: the live weight block (widest slot) read once as f32, x
        # read once, out written once; ops = 2 * live rows * live cols
        an_h = [N] * B if an is None else an.tolist()
        ak_h = [K] * B if ak is None else ak.tolist()
        live_w = max(min(a, K) for a in ak_h) * max(min(a, N) for a in an_h)
        nbytes = live_w * 4 + B * K * 2 + B * N * 2
        ops = sum(2 * min(a, K) * min(n, N) for a, n in zip(ak_h, an_h))
        bound = max(nbytes / HBM_BYTES_PER_S, ops / PEAK_BF16) * 1e3
        log(f"  morph_matmul {name:9s} K={K:5d} N={N:5d} max|err| {err:.3e}"
            f"  kernel {t_k:.4f} ms (call, event-timed {t_kw:.4f} ms)  plain "
            f"{t_p:.4f} ms  torch.matmul(bf16, full width) {t_l:.4f} ms  "
            f"bound {bound:.4f} ms (bytes)")
        for k_, v_ in (("ms", t_k), ("plain_ms", t_p), ("bound_ms", bound),
                       ("library_ms", t_l)):
            tot[k_] += v_ * per_layer
    log(f"  morph_matmul, one decoder layer (7 projections, B=8, mixed "
        f"widths): kernel {tot['ms']:.4f} ms, plain {tot['plain_ms']:.4f} ms, "
        f"library {tot['library_ms']:.4f} ms, bound {tot['bound_ms']:.4f} ms; "
        f"tolerance rtol {RTOL_BF16:.2e} + atol {ATOL_BF16:.0e}")
    return dict(max_abs_err=max_err, **tot)


def check_fused_decode(torch, cfg, timer):
    import dataclasses

    from repro_torch.core import elastic
    from repro_torch.kernels import fused_decode as FD
    from repro_torch.models import layers as L

    B, S = 8, 1024
    dm, H, KV, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    gen = torch.Generator(device="cuda").manual_seed(2)
    params = {
        "wq": torch.randn(dm, H * hd, generator=gen, device="cuda") / math.sqrt(dm),
        "wk": torch.randn(dm, KV * hd, generator=gen, device="cuda") / math.sqrt(dm),
        "wv": torch.randn(dm, KV * hd, generator=gen, device="cuda") / math.sqrt(dm),
        "wo": torch.randn(H * hd, dm, generator=gen, device="cuda") / math.sqrt(H * hd),
    }
    widths = [0.25, 0.5, 1.0, 0.25, 0.5, 1.0, 0.5, 0.25]
    act = elastic.active_widths_batch(cfg, widths, device="cuda")
    pos = torch.tensor([0, 1, 63, 64, 200, 511, 777, 1023], dtype=torch.int32,
                       device="cuda")
    x = torch.randn(B, 1, dm, generator=gen, device="cuda").to(torch.bfloat16)
    out = {}
    for variant, qcfg in (("bf16", cfg),
                          ("int8", dataclasses.replace(cfg, kv_quant=True))):
        k = torch.randn(B, S, KV, hd, generator=gen, device="cuda")
        v = torch.randn(B, S, KV, hd, generator=gen, device="cuda")
        if qcfg.kv_quant:
            kq, ks = L.quantize_kv(k)
            vq, vs = L.quantize_kv(v)
            cache = {"k": kq, "v": vq, "k_scale": ks, "v_scale": vs}
        else:
            cache = {"k": k.to(torch.bfloat16), "v": v.to(torch.bfloat16)}
        c_k = {n: t.clone() for n, t in cache.items()}
        c_p = {n: t.clone() for n, t in cache.items()}
        o_k, _ = FD.fused_decode_step(params, x, c_k, pos, qcfg, active=act)
        o_p, _ = FD.fused_decode_plain(params, x, c_p, pos, qcfg,
                                       act["q_dim"], act["kv_dim"])
        torch.cuda.synchronize()
        ok, err = close(torch, o_k, o_p)
        if not ok:
            fail(f"fused_decode {variant}: out max |err| {err:.3e}")
        for n in cache:
            if c_k[n].dtype == torch.int8:
                d = (c_k[n].int() - c_p[n].int()).abs()
                e = float(d.max())
                n_off = int((d != 0).sum())
                if e > 1:  # f32 sum order may move a value across a .5 edge
                    fail(f"fused_decode {variant} cache {n}: int8 off by {e}")
                log(f"  fused_decode {variant} cache {n}: max int8 diff {e:.0f}"
                    f" ({n_off} of {d.numel()} differ)")
            else:
                okc, ec = close(torch, c_k[n], c_p[n])
                if not okc:
                    fail(f"fused_decode {variant} cache {n}: max |err| {ec:.3e}")
                err = max(err, ec)
        log(f"  fused_decode {variant}: out/cache max|err| {err:.3e} "
            f"(rtol {RTOL_BF16:.2e} + atol {ATOL_BF16:.0e})")
        out[variant] = dict(err=err, cache=c_k, qcfg=qcfg)
    # time the main-path variant (bf16 cache, as tinyllama serves)
    c = out["bf16"]["cache"]
    t_k = timer.ms(lambda: FD.fused_decode_step(params, x, c, pos, cfg,
                                                active=act))
    for name, t in sorted(timer.last.items(), key=lambda kv: -kv[1]):
        log(f"    {t:.4f} ms  {name[:100]}")
    t_kw = timer.wall_ms(lambda: FD.fused_decode_step(params, x, c, pos, cfg,
                                                      active=act))
    t_p = timer.ms(lambda: FD.fused_decode_plain(params, x, c, pos, cfg,
                                                 act["q_dim"], act["kv_dim"]))
    aq, akv = act["q_dim"].tolist(), act["kv_dim"].tolist()
    lens = [min(p + 1, S) for p in pos.tolist()]
    nbytes = (dm * (max(aq) + 2 * max(akv)) * 4 + max(aq) * dm * 4
              + sum(lens) * KV * hd * 2 * 2 + B * dm * 2 * 2
              + B * KV * hd * 2 * 2)
    ops = sum(2 * dm * (q + 2 * kv) + 2 * q * dm + 4 * n * H * hd
              for q, kv, n in zip(aq, akv, lens))
    bound = max(nbytes / HBM_BYTES_PER_S, ops / PEAK_F32) * 1e3
    by = "bytes" if nbytes / HBM_BYTES_PER_S >= ops / PEAK_F32 else "operations"
    log(f"  fused_decode bf16 (B=8, S=1024, one layer): kernels {t_k:.4f} ms"
        f" (call, event-timed {t_kw:.4f} ms)  plain {t_p:.4f} ms  bound "
        f"{bound:.4f} ms ({by}; f32 math at {PEAK_F32 / 1e12:.0f} TFLOP/s)")
    return dict(max_abs_err=max(o["err"] for o in out.values()), ms=t_k,
                plain_ms=t_p, bound_ms=bound, bound_by=by, library_ms=None)


# ---------------------------------------------------------------------------
# phase 3: end to end
# ---------------------------------------------------------------------------


def mode_schedule(modes):
    """Every mode once, in an order that changes width and depth between
    neighbours: full model first, then a stride coprime to the mode count."""
    n = len(modes)
    stride = next(s for s in range(2, n + 2) if math.gcd(s, n) == 1)
    return [modes[(n - 1 + i * stride) % n] for i in range(n)]


def drive(engine, trace, switch_every: int):
    """Submit the whole trace, then tick, moving the admission mode along
    ``mode_schedule`` every ``switch_every`` ticks."""
    import copy

    reqs = copy.deepcopy(trace)
    for r in reqs:
        engine.submit(r)
    sched = mode_schedule(engine.ctrl.modes)
    t0 = time.perf_counter()
    i = 0
    while engine.queue or engine.n_active:
        if engine.step_count % switch_every == 0:
            engine.set_admission_mode(sched[i % len(sched)])
            i += 1
        engine.step()
    return time.perf_counter() - t0, {r.rid: list(r.generated) for r in reqs}


def step_width_ms(torch, engine, width: float, iters: int = 10):
    """Decode step at full depth with every slot at ``width``: (host ms per
    step, device kernel ms per step or None on the CPU)."""
    ctrl = engine.ctrl
    step = ctrl.step_for(ctrl.modes[-1])
    active = engine._active_for([width] * engine.batch_size)
    cache = engine.executor.init_cache()
    tok = torch.ones((engine.batch_size, 1), dtype=torch.int64,
                     device=engine.device)
    step(engine.params, cache, tok, active)
    sync(torch, engine.device)
    t0 = time.perf_counter()
    for _ in range(iters):
        step(engine.params, cache, tok, active)
    sync(torch, engine.device)
    host = (time.perf_counter() - t0) / iters * 1e3
    if torch.device(engine.device).type != "cuda":
        return host, None
    per = kernel_us(torch, lambda: step(engine.params, cache, tok, active),
                    iters)
    return host, sum(per.values()) / iters / 1e3


def sync(torch, device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def expected_launches(torch, layer_steps: int, fused: bool, device):
    """Launch counts one drive must show: every decoder layer of every
    decode step runs the 7 gated projections through ``morph_matmul``
    unfused; fused, its attention is one ``fused_decode_step`` (whose output
    projection is not a ``morph_matmul`` count) and its MLP 3 projections.
    On the CPU the wrappers run their plain versions and count nothing."""
    if torch.device(device).type != "cuda":
        return {"morph_matmul": 0, "fused_decode": 0}
    if fused:
        return {"morph_matmul": 3 * layer_steps, "fused_decode": layer_steps}
    return {"morph_matmul": 7 * layer_steps, "fused_decode": 0}


def end_to_end(torch, cfg, device="cuda", n_requests=24,
               prompt_len=(16, 256), new_tokens=(32, 64), capacity=512):
    from repro_torch.kernels import fused_decode as FD
    from repro_torch.kernels import morph_matmul as MM
    from repro_torch.models.model import init_params
    from repro_torch.runtime.serving import ServingEngine, poisson_trace

    t0 = time.perf_counter()
    params = init_params(cfg, seed=0, device=device)
    sync(torch, device)
    n_params = sum(t.numel() for t in _leaves(params))
    log(f"  init_params: {n_params / 1e9:.3f} B f32 parameters on the card in "
        f"{time.perf_counter() - t0:.1f} s")
    trace = poisson_trace(n_requests, 50.0, seed=0, prompt_len=prompt_len,
                          new_tokens=new_tokens, vocab=cfg.vocab_size)
    results = {}
    launches = {}  # path -> kernel -> launches in that path's drive
    for fused in (False, True):
        engine = ServingEngine(params, cfg, batch_size=8,
                               cache_capacity=capacity, prefill_threshold=8,
                               fused=fused, device=device)
        engine.warmup()
        tag = "fused" if fused else "unfused"
        steps0 = {n: t.steps for n, t in engine.ctrl.telemetry.items()}
        # each path's counts cover exactly its own drive: zeroed just
        # before it, read just after
        MM.reset_launch_count()
        FD.reset_launch_count()
        wall, streams = drive(engine, trace, switch_every=12)
        run_launches = {"morph_matmul": MM.launch_count(),
                        "fused_decode": FD.launch_count()}
        launches[tag] = run_launches
        # decoder layers run by the drive's decode steps (telemetry records
        # one entry per step, at the mode it was attributed to)
        layer_steps = sum(
            (engine.ctrl.telemetry[m.name].steps - steps0[m.name])
            * m.depth * cfg.period for m in engine.ctrl.modes)
        want = expected_launches(torch, layer_steps, fused, device)
        if run_launches != want:
            fail(f"{tag} path: launches {run_launches}, expected {want} for "
                 f"{layer_steps} decoder-layer steps")
        gen = sum(len(s) for s in streams.values())
        if len(engine.completed) != len(trace):
            fail(f"fused={fused}: {len(engine.completed)} of {len(trace)} done")
        for r in trace:
            s = streams[r.rid]
            if len(s) != r.max_new_tokens or not all(0 <= t < cfg.vocab_size
                                                     for t in s):
                fail(f"fused={fused}: request {r.rid} stream is malformed")
        if engine.ctrl.stats["compiles"] != engine.compiles_after_warmup:
            fail("a width/depth switch rebuilt a step")
        log(f"  e2e {tag}: {gen} tokens, {len(engine.completed)} requests in "
            f"{wall:.2f} s wall -> {gen / wall:.1f} tokens/s; "
            f"{engine.decode_launches} decode steps, {engine.prefills} "
            f"prefills, admission switches {len(engine.admission_switch_log)}")
        for name, t in sorted(engine.ctrl.telemetry_summary().items()):
            log(f"    mode {name:8s} steps {t['steps']:4d}  p50 "
                f"{t['p50_ms']:8.3f} ms  p95 {t['p95_ms']:8.3f} ms")
        log(f"    launches in this drive: morph_matmul "
            f"{run_launches['morph_matmul']}, fused_decode "
            f"{run_launches['fused_decode']} ({layer_steps} decoder-layer "
            f"steps; as expected)")
        narrow = min(cfg.elastic.width_fractions)
        (h_n, d_n), (h_f, d_f) = (step_width_ms(torch, engine, narrow),
                                  step_width_ms(torch, engine, 1.0))
        dev_note = ("" if d_n is None else
                    f"; device kernel time {d_n:.3f} ms vs {d_f:.3f} ms "
                    f"(ratio {d_n / d_f:.3f}, idle share at w1.0 "
                    f"{1 - d_f / h_f:.3f})")
        log(f"    decode step at full depth, all slots w{narrow}: host "
            f"{h_n:.3f} ms, all w1.0: {h_f:.3f} ms{dev_note}")
        results[tag] = dict(streams=streams, tokens_per_s=gen / wall)
        del engine
    a, b = results["unfused"]["streams"], results["fused"]["streams"]
    same = sum(x == y for r in a for x, y in zip(a[r], b[r]))
    total = sum(len(a[r]) for r in a)
    whole = sum(a[r] == b[r] for r in a)
    log(f"  fused vs unfused: {same}/{total} tokens agree position-wise, "
        f"{whole}/{len(a)} streams identical (f32 fused projections vs bf16 "
        f"unfused weights; reported, not asserted)")
    return launches, results


def _leaves(tree):
    for v in tree.values():
        if isinstance(v, dict):
            yield from _leaves(v)
        else:
            yield v


def smoke_reference(torch):
    """The smoke model on the card (kernels) vs the CPU (plain versions)."""
    from repro_torch.configs import smoke_config
    from repro_torch.core import elastic
    from repro_torch.models.model import (decode_step, init_decode_cache,
                                          init_params, prefill)

    cfg = smoke_config("tinyllama-1.1b")
    p_cpu = init_params(cfg, seed=3, device="cpu")
    p_gpu = {k: v for k, v in _move(p_cpu, "cuda").items()}
    worst = 0.0
    for fused in (False, True):
        outs = []
        for dev, p in (("cpu", p_cpu), ("cuda", p_gpu)):
            act = elastic.active_widths_batch(cfg, [0.5, 1.0], device=dev)
            cache = init_decode_cache(cfg, 2, 32, per_slot=True, device=dev)
            toks = torch.tensor([[5, 9, 3, 7], [2, 4, 6, 8]], device=dev)
            lg = []
            for t in range(toks.shape[1]):
                logits, cache = decode_step(p, cache, toks[:, t:t + 1], cfg,
                                            active=act, fused=fused)
                lg.append(logits.float().cpu())
            pl, _ = prefill(p, {"tokens": toks[:1]}, cfg, cache_extra=4,
                            per_slot=True, slot=1, n_slots=2)
            lg.append(pl.float().cpu())
            outs.append(torch.cat([x.reshape(-1) for x in lg]))
        err = float((outs[0] - outs[1]).abs().max())
        if not math.isfinite(err) or err > ATOL_SMOKE:
            fail(f"smoke model fused={fused}: card vs CPU max |err| {err:.3e}")
        worst = max(worst, err)
    log(f"  smoke model (f32) on the card vs plain versions on the CPU: "
        f"max |logit err| {worst:.3e} (atol {ATOL_SMOKE:.0e})")


def _move(tree, dev):
    return {k: _move(v, dev) if isinstance(v, dict) else v.to(dev)
            for k, v in tree.items()}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--skip-e2e", action="store_true",
                    help="stop after the kernel checks")
    args = ap.parse_args(argv)
    if not (SRC / "repro_torch").is_dir():
        print("chip_smoke: src/repro_torch not found beside this script; run "
              "it from a checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "needs a CUDA card", file=sys.stderr)
        return 3
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from repro_torch.configs import get_config
    from repro_torch.kernels import _build

    log("[phase 1] device and build")
    card = card_line()
    log(f"  card: {card}")
    log(f"  torch {torch.__version__} cuda {torch.version.cuda}; "
        f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")
    t0 = time.perf_counter()
    secs = _build.build_all()
    log(f"  built {sorted(secs)} in {time.perf_counter() - t0:.1f} s "
        f"(parallel nvcc, sm_90a)")
    for name in _build.KERNELS:
        for ln in _build.ptxas_report(name):
            log(f"    {name}: {ln}")

    cfg = get_config("tinyllama-1.1b")
    timer = Timer(torch)
    log("[phase 2] kernels vs plain versions (full TinyLlama shapes, bf16)")
    mm = check_morph_matmul(torch, cfg, timer)
    fd = check_fused_decode(torch, cfg, timer)
    del timer
    torch.cuda.empty_cache()

    launches = {"unfused": {"morph_matmul": None, "fused_decode": None},
                "fused": {"morph_matmul": None, "fused_decode": None}}
    if not args.skip_e2e:
        log("[phase 3] end to end: tinyllama-1.1b, full width, one card")
        smoke_reference(torch)
        launches, _ = end_to_end(torch, cfg)

    # every check above raises on failure, so reaching here means each
    # kernel built, launched and matched its plain version. ``launches`` is
    # the count from the path the kernel carries (morph_matmul: the default
    # unfused engine; fused_decode: ``fused=True``); ``launches_by_path``
    # gives every path's own count.
    status = "ok" if not args.skip_e2e else "ok (kernel checks only)"
    kernels = [
        dict(name="morph_matmul", route="cuda", status=status,
             source="src/repro_torch/csrc/morph_matmul.cu",
             replaces="src/repro/kernels/morph_matmul.py:68",
             launches=launches["unfused"]["morph_matmul"],
             launches_by_path={p: c["morph_matmul"]
                               for p, c in launches.items()},
             max_abs_err=mm["max_abs_err"], ms=mm["ms"],
             plain_ms=mm["plain_ms"], bound_ms=mm["bound_ms"],
             bound_by="bytes", library_ms=mm["library_ms"]),
        dict(name="fused_decode", route="cuda", status=status,
             source="src/repro_torch/csrc/fused_decode.cu",
             replaces="src/repro/kernels/fused_decode.py:377",
             launches=launches["fused"]["fused_decode"],
             launches_by_path={p: c["fused_decode"]
                               for p, c in launches.items()},
             max_abs_err=fd["max_abs_err"], ms=fd["ms"],
             plain_ms=fd["plain_ms"], bound_ms=fd["bound_ms"],
             bound_by=fd["bound_by"], library_ms=None),
    ]
    log("[phase 4] summary")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
