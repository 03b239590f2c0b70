"""Re-run the op-trace accounting over saved dry-run traces (no retrace).

Port of ``repro.launch.reanalyze``. The dry-run saves each cell's op
stream (``--save-trace``); when the cost model in ``launch.op_analysis``
evolves, this tool refreshes the ``cost``, ``collectives`` and roofline
terms of the JSON records in place (``memory`` was measured while tracing
and stays):

    PYTHONPATH=src python -m repro_torch.launch.reanalyze \\
        --results build/dryrun.json --trace build/traces
"""
from __future__ import annotations

import argparse
import json
import os

from repro_torch.launch import op_analysis as OA
from repro_torch.launch.dryrun import RESULTS_DEFAULT, apply_cost


def reanalyze_record(rec, trace_dir: str) -> bool:
    if rec.get("status") != "ok" or "trace_file" not in rec:
        return False
    path = os.path.join(trace_dir, rec["trace_file"])
    if not os.path.exists(path):
        return False
    saved = OA.load_events(path)
    chips = 1
    for d in rec["mesh"].split("x"):
        chips *= int(d)
    apply_cost(rec, OA.account(saved["events"]), chips)
    return True


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--results", default=RESULTS_DEFAULT)
    ap.add_argument("--trace", default="build/traces")
    args = ap.parse_args(argv)
    with open(args.results) as f:
        results = json.load(f)
    n = 0
    for key, rec in results.items():
        if reanalyze_record(rec, args.trace):
            n += 1
            r = rec["roofline"]
            print(f"{key}: dom={r['dominant']} frac="
                  f"{r['roofline_fraction']:.4f} compute="
                  f"{r['compute_s'] * 1e3:.1f}ms memory="
                  f"{r['memory_s'] * 1e3:.1f}ms coll="
                  f"{r['collective_s'] * 1e3:.1f}ms")
    tmp = args.results + ".tmp"
    with open(tmp, "w") as f:
        json.dump(results, f, indent=1, sort_keys=True)
    os.replace(tmp, args.results)
    print(f"reanalyzed {n} records")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
