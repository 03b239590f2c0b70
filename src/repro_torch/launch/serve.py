"""Serving entry point: continuous-batching engine with NeuroMorph reconfiguration.

Port of ``repro.launch.serve`` for the flags this slice supports. Drives
``repro_torch.runtime.serving.ServingEngine`` — request queue, per-step slot
admission, per-DEPTH slot groups with per-slot runtime widths — while
switching morph modes on the fly. Width switches change a tensor operand of
the same step; only distinct depths build separate steps, and nothing is
rebuilt after warmup (asserted and reported).

Two traffic shapes:
  * default: a fixed round of ``--batch`` x enough requests to generate
    ``--tokens`` tokens, cycling the admission mode every ``--switch-every``
    engine steps.
  * ``--budget-ms``: SLO-driven — the admission mode is chosen each tick as
    the widest mode whose predicted step latency fits the budget.

``--trace-out trace.json`` writes Chrome trace-event JSON of every launch
and request; ``--metrics-dump`` prints the metrics registry. Runs on the
card (``--device cuda``, the default) unless ``--device cpu`` is given.

Example:
  PYTHONPATH=src python -m repro_torch.launch.serve --arch tinyllama-1.1b \
      --batch 8 --tokens 256 --switch-every 16
"""
from __future__ import annotations

import argparse
import json

from repro_torch.configs import get_config, smoke_config
from repro_torch.core import elastic
from repro_torch.device import resolve_device
from repro_torch.models.model import init_params
from repro_torch.runtime.observability import Observability
from repro_torch.runtime.serving import Request, ServingEngine, SLOPolicy


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--batch", type=int, default=4, help="batch slots per depth")
    ap.add_argument("--tokens", type=int, default=64,
                    help="total tokens to generate across all requests")
    ap.add_argument("--switch-every", type=int, default=16,
                    help="cycle admission mode every N engine steps")
    ap.add_argument("--budget-ms", type=float, default=0.0,
                    help="if > 0, use the SLO policy with this latency budget")
    ap.add_argument("--prefill-threshold", type=int, default=8,
                    help="prompts at least this long are consumed by one "
                         "prefill instead of token-by-token")
    ap.add_argument("--fused", action="store_true",
                    help="route attention layers through the fused decode "
                         "kernels")
    ap.add_argument("--trace-out", default="",
                    help="write Chrome trace-event JSON to this path")
    ap.add_argument("--metrics-dump", action="store_true",
                    help="print the end-of-run metrics registry as "
                         "Prometheus exposition text plus a JSON snapshot")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; cpu runs the plain "
                         "PyTorch versions of the kernels)")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    if args.batch < 1:
        ap.error(f"--batch must be >= 1, got {args.batch}")
    device = resolve_device(args.device)
    cfg = smoke_config(args.arch) if args.smoke else get_config(args.arch)
    params = init_params(cfg, seed=args.seed, device=device)
    modes = cfg.elastic.modes(cfg.n_groups)
    per_req = max(4, args.tokens // (2 * args.batch))
    n_requests = max(args.batch, (args.tokens + per_req - 1) // per_req)
    capacity = per_req + 8
    obs = Observability(trace=bool(args.trace_out))
    engine = ServingEngine(params, cfg, batch_size=args.batch,
                           cache_capacity=capacity, modes=modes,
                           prefill_threshold=args.prefill_threshold,
                           fused=args.fused, observability=obs, device=device)
    print(f"[serve] {cfg.name} on {device}: modes = {[m.name for m in modes]} "
          f"requests={n_requests} x {per_req} tokens, batch={args.batch}"
          f"{' fused' if args.fused else ''}")
    engine.warmup()
    for i in range(n_requests):
        engine.submit(Request(rid=i, prompt=(1 + i % (cfg.vocab_size - 1),),
                              max_new_tokens=per_req,
                              slo_class="interactive" if i % 3 == 0 else "batch"))
    policy = None
    if args.budget_ms > 0:
        policy = SLOPolicy(cfg, engine.ctrl, batch_size=args.batch,
                           cache_capacity=capacity)
    mode_idx = len(modes) - 1
    busy = 0.0
    while engine.queue or engine.n_active:
        if policy is not None:
            engine.set_admission_mode(policy.choose(args.budget_ms * 1e-3))
        elif engine.step_count and engine.step_count % args.switch_every == 0:
            mode_idx = (mode_idx - 1) % len(modes)  # degrade then wrap
            engine.set_admission_mode(modes[mode_idx])
        busy += engine.step(now_s=busy)
    ctrl = engine.ctrl
    assert ctrl.stats["compiles"] == engine.compiles_after_warmup, \
        "runtime switch must not rebuild a step"
    generated = sum(len(r.generated) for r in engine.completed)
    print(f"[serve] completed={len(engine.completed)} "
          f"generated={generated} switches={ctrl.stats['switches']} "
          f"admission_switches={len(engine.admission_switch_log)} "
          f"recompiles_after_warmup=0 dispatches={ctrl.stats['dispatches']} "
          f"executables={ctrl.stats['compiles']} (per depth) "
          f"decode_launches={engine.decode_launches} "
          f"(per-mode baseline {engine.per_mode_launch_equiv}) "
          f"prefills={engine.prefills} "
          f"tokens/s={generated / busy if busy else 0.0:.1f}")
    for name, t in ctrl.telemetry_summary().items():
        mode = ctrl.mode_by_name[name]
        frac = elastic.flops_fraction(cfg, mode)
        print(f"  mode {name:8s} p50 {t['p50_ms']:8.2f} ms  p95 {t['p95_ms']:8.2f} ms  "
              f"{t['tokens_per_s']:8.1f} tok/s  active-FLOPs {frac * 100:5.1f}%")
    if args.trace_out:
        obs.recorder.write(args.trace_out)
        print(f"[serve] wrote {len(obs.recorder.events)} trace events to "
              f"{args.trace_out}")
    if args.metrics_dump:
        print("[serve] metrics (prometheus):")
        print(engine.metrics.prometheus_text(), end="")
        print("[serve] metrics (json):")
        print(json.dumps(engine.export_metrics(), indent=2, sort_keys=True))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
