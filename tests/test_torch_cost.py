"""The op-trace cost walker (``repro_torch.launch.op_analysis``), the kernels'
cost functions and the dry-run's cost, collectives and roofline records,
on the CPU.

* The ring model against ``repro.launch.hlo_analysis._wire_bytes`` for
  every op and group size, exactly.
* The dense smoke prefill's matrix-product FLOPs against the reference's
  dot FLOPs, from its own ``_parse_module`` / ``_dot_flops`` over the HLO
  of ``repro.launch.dryrun._lower_prefill`` compiled on the CPU (one
  device, in a subprocess: the reference's dry-run sets its device count
  before JAX starts), within 1%; total FLOPs within 5% (the reference
  counts an elementwise op fused on the CPU as no FLOPs, the port counts
  every op).
* Loop accounting: one traced microbatch times its trips equals the
  unrolled trace at microbatches 2 and 4, exactly.
* Each kernel's ``cost`` at the headline shape of its ``PERF.md`` section
  6 row gives that row's bound (the larger of bytes at 3.35 TB/s and FLOPs
  at the operand type's peak) within 2%.
* A kernel wrapper given a meta tensor outside a trace raises.
* ``reanalyze`` of a saved trace reproduces the record that saved it.
* The ``--debug-mesh`` CLI writes ``ok`` records with every field.
"""
import copy
import json
import os
import subprocess
import sys

import pytest
import torch

from repro.launch.hlo_analysis import COLLECTIVE_OPS as JAX_OPS
from repro.launch.hlo_analysis import _wire_bytes
from repro_torch.configs import get_config, smoke_config
from repro_torch.core import elastic
from repro_torch.kernels import flash_attention as FA
from repro_torch.kernels import flash_decode as FDK
from repro_torch.kernels import fused_decode as FD
from repro_torch.kernels import morph_matmul as MM
from repro_torch.kernels import ops
from repro_torch.kernels import ssd_scan as SSD
from repro_torch.launch import dryrun as DRY
from repro_torch.launch import op_analysis as OA
from repro_torch.launch import reanalyze as RA
from repro_torch.launch.steps import make_prefill_step, make_train_step
from repro_torch.models.model import init_params
from repro_torch.optim import OptimizerConfig
from repro_torch.parallel.collectives import TraceMesh

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "tests"))
from torch_threads import one_thread  # noqa: E402,F401  (autouse)

META = torch.device("meta")
HBM = 3.35e12
BF16, F32 = OA.PEAK_FLOPS[torch.bfloat16], OA.PEAK_FLOPS[torch.float32]
MIXED = [0.25, 0.5, 1.0, 0.25, 0.5, 1.0, 0.5, 0.25]  # chip_smoke's widths


def _bound_ms(flops_bytes, peak):
    flops, nbytes = flops_bytes
    return max(nbytes / HBM, flops / peak) * 1e3


# ---------------------------------------------------------------------------
# (a) the ring model
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("g", [1, 2, 4, 8, 16])
def test_ring_model_is_the_reference_s(g):
    for op in JAX_OPS + ("send", "recv", "broadcast"):
        for rb in (0.0, 4.0, 12345.0, 3.0e9):
            assert OA.wire_bytes(op, rb, g) == _wire_bytes(op, rb, g), op
    assert OA.COLLECTIVE_OPS == JAX_OPS


# ---------------------------------------------------------------------------
# (b) the dense prefill's dot FLOPs against the reference's HLO
# ---------------------------------------------------------------------------

REF_PREFILL = r"""
import json, os, re, sys
os.environ["REPRO_DRYRUN_DEVICES"] = "1"
os.environ.setdefault("JAX_PLATFORMS", "cpu")
from repro.launch import dryrun as D
from repro import compat
from repro.configs import smoke_config
from repro.configs.base import ShapeCell
from repro.launch.hlo_analysis import (_CONST_INT, _dot_flops, _parse_module,
                                       analyze_hlo)
B, S = int(sys.argv[1]), int(sys.argv[2])
mesh = compat.make_mesh((1, 1), ("data", "model"))
with compat.set_mesh(mesh):
    hlo = D._lower_prefill(smoke_config("tinyllama-1.1b"),
                           ShapeCell("t", S, B, "prefill"), mesh,
                           D.Knobs(sp=False)).compile().as_text()
comps = _parse_module(hlo)

def trips(cond):
    c = comps.get(cond)
    consts = [int(x) for op in (c.ops.values() if c else [])
              for x in _CONST_INT.findall(op.line)]
    return max(consts) if consts else 1

dot = 0.0

def walk(comp, mult, stack):
    global dot
    if comp.name in stack:
        return
    for body, cond in comp.whiles:
        if body in comps:
            walk(comps[body], mult * trips(cond), stack + [comp.name])
    for op in comp.ops.values():
        if op.opcode == "dot":
            dot += mult * _dot_flops(op, comp.ops)
        elif op.opcode != "while":
            for m in re.finditer(r"(?:calls|to_apply)=%?([\w.\-]+)", op.line):
                if m.group(1) in comps:
                    walk(comps[m.group(1)], mult, stack + [comp.name])

walk(comps["__entry__"], 1.0, [])
print(json.dumps({"dot": dot, "total": analyze_hlo(hlo, 1).flops}))
"""


def test_dense_prefill_dot_flops_match_the_reference_hlo():
    B, S = 2, 64
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    run = subprocess.run([sys.executable, "-c", REF_PREFILL, str(B), str(S)],
                         capture_output=True, text=True, env=env, timeout=240)
    assert run.returncode == 0, run.stderr[-2000:]
    ref = json.loads(run.stdout.strip().splitlines()[-1])
    cfg = smoke_config("tinyllama-1.1b")
    batch = {"tokens": torch.empty((B, S), dtype=torch.int32, device=META)}
    cost = OA.trace(make_prefill_step(cfg), init_params(cfg, device=META),
                    batch)
    dots = sum(e["mult"] * OA._op_cost(e)[0] for e in cost.events
               if e.get("cat") == "matmul")
    assert ref["dot"] > 0
    assert abs(dots - ref["dot"]) <= 0.01 * ref["dot"], (dots, ref)
    assert abs(cost.flops - ref["total"]) <= 0.05 * ref["total"], (
        cost.flops, ref)


# ---------------------------------------------------------------------------
# (c) loop accounting
# ---------------------------------------------------------------------------


def _train_trace(mb, unroll):
    cfg = smoke_config("tinyllama-1.1b")
    mesh = TraceMesh({"data": 2, "model": 2})
    ocfg = OptimizerConfig()
    state, gsh = DRY._train_pieces(cfg, mesh, ocfg)
    step = make_train_step(cfg, ocfg, microbatches=mb, remat="full",
                           grad_shardings=gsh)
    batch = DRY.batch_struct(cfg, 16, 32)
    return OA.trace(step, state, batch, world=4, unroll=unroll)


@pytest.mark.parametrize("mb", [2, 4])
def test_one_traced_microbatch_times_its_trips_is_the_unrolled_trace(mb):
    once, full = _train_trace(mb, False), _train_trace(mb, True)
    assert once.loop_trips == [mb] and full.loop_trips == []
    assert full.n_ops > once.n_ops
    for f in ("flops", "bytes", "coll_wire_bytes", "coll_result_bytes"):
        assert getattr(once, f) == getattr(full, f), f
    assert dict(once.per_op_count) == dict(full.per_op_count)
    assert dict(once.per_op_bytes) == dict(full.per_op_bytes)
    assert {k: dict(v) for k, v in once.per_kernel.items()} == {
        k: dict(v) for k, v in full.per_kernel.items()}
    assert once.per_op_count["all-gather"] > 0
    assert once.per_op_count["reduce-scatter"] > 0  # the NCCL route


# ---------------------------------------------------------------------------
# (d) each kernel's cost at its PERF.md row's headline shape
# ---------------------------------------------------------------------------


def _b1():
    cfg = get_config("tinyllama-1.1b")
    act = elastic.active_widths_batch(cfg, MIXED, device="cpu")
    dm, ff, qd, kvd = cfg.d_model, cfg.d_ff, cfg.q_dim, cfg.kv_dim
    cases = [(dm, qd, act["q_dim"], None, 1),
             (dm, kvd, act["kv_dim"], None, 2),
             (qd, dm, None, act["q_dim"], 1),
             (dm, ff, act["d_ff"], None, 2),
             (ff, dm, None, act["d_ff"], 1)]
    return sum(n * _bound_ms(MM.cost((8, 1, K), (K, N), torch.bfloat16,
                                     torch.float32, an, ak), BF16)
               for K, N, an, ak, n in cases)


def _fused_args():
    cfg = get_config("tinyllama-1.1b")
    act = elastic.active_widths_batch(cfg, MIXED, device="cpu")
    return cfg, dict(active_q=act["q_dim"], active_kv=act["kv_dim"])


def _b2():
    cfg, kw = _fused_args()
    pos = [0, 1, 63, 64, 200, 511, 777, 1023]
    return _bound_ms(FD.cost(8, cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                             cfg.head_dim, [p + 1 for p in pos], S=1024,
                             **kw), F32)


def _b3():
    cfg, kw = _fused_args()
    pos = [0, 1, 63, 64, 200, 333, 450, 505]
    return _bound_ms(FD.verify_cost(8, 5, cfg.d_model, cfg.n_heads,
                                    cfg.n_kv_heads, cfg.head_dim, pos,
                                    Sc=512, **kw), F32)


KERNEL_ROWS = {
    "B1": (_b1, 0.0528),
    "B2": (_b2, 0.0121),
    "B3": (_b3, 0.0119),
    "B4": (lambda: _bound_ms(SSD.cost(1, 256, 32, 64, 1, 128), F32), 0.0043),
    "B5": (lambda: _bound_ms(FDK.cost((256, 64), (32, 512, 64),
                                      torch.bfloat16, torch.bfloat16, 512,
                                      group=8), BF16), 0.00127),
    "B6": (lambda: _bound_ms(FA.cost((1, 256, 32, 64), (1, 256, 4, 64),
                                     torch.bfloat16, causal=True), BF16),
           0.00070),
    "row7": (lambda: _bound_ms(SSD.bwd_cost(8, 256, 32, 64, 1, 128), F32),
             0.0703),
}


@pytest.mark.parametrize("row", list(KERNEL_ROWS))
def test_kernel_cost_gives_its_perf_row_bound(row):
    fn, want = KERNEL_ROWS[row]
    got = fn()
    assert abs(got - want) <= 0.02 * want, (row, got, want)


# ---------------------------------------------------------------------------
# (e) a meta tensor outside a trace
# ---------------------------------------------------------------------------


def _meta(*shape, dtype=torch.bfloat16):
    return torch.empty(shape, dtype=dtype, device=META)


def _fused_call(verify):
    cfg = smoke_config("tinyllama-1.1b")
    dm, H, KV, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    params = {"wq": _meta(dm, H * hd, dtype=torch.float32),
              "wk": _meta(dm, KV * hd, dtype=torch.float32),
              "wv": _meta(dm, KV * hd, dtype=torch.float32),
              "wo": _meta(H * hd, dm, dtype=torch.float32)}
    cache = {"k": _meta(2, 16, KV, hd), "v": _meta(2, 16, KV, hd)}
    pos = torch.zeros(2, dtype=torch.int32, device=META)
    if verify:
        return lambda: FD.fused_verify(params, _meta(2, 3, dm), cache, pos,
                                       cfg)
    return lambda: FD.fused_decode_step(params, _meta(2, 1, dm), cache, pos,
                                        cfg)


META_CALLS = {
    "morph_matmul": lambda: MM.morph_matmul(_meta(2, 1, 8),
                                            _meta(8, 4, dtype=torch.float32),
                                            2),
    "fused_decode": lambda: _fused_call(False)(),
    "fused_verify": lambda: _fused_call(True)(),
    "ssd_scan": lambda: ops.ssd_scan_bshn(
        _meta(1, 8, 2, 4, dtype=torch.float32),
        _meta(1, 8, 2, dtype=torch.float32), _meta(2, dtype=torch.float32),
        _meta(1, 8, 1, 4, dtype=torch.float32),
        _meta(1, 8, 1, 4, dtype=torch.float32)),
    "flash_decode": lambda: FDK.flash_decode(_meta(4, 8), _meta(2, 16, 8),
                                             _meta(2, 16, 8), 16, group=2),
    "flash_attention": lambda: ops.flash_attention_bshd(
        _meta(1, 8, 4, 16), _meta(1, 8, 2, 16), _meta(1, 8, 2, 16)),
}


@pytest.mark.parametrize("kernel", list(META_CALLS))
def test_kernel_wrapper_on_meta_outside_a_trace_raises(kernel):
    with pytest.raises(ValueError, match="outside an op trace"):
        META_CALLS[kernel]()
    # inside one it records one launch and counts none of its own
    before = {"morph_matmul": MM.launch_count, "fused_decode":
              FD.launch_count, "fused_verify": FD.verify_launch_count,
              "ssd_scan": SSD.launch_count, "flash_decode":
              FDK.launch_count, "flash_attention": FA.launch_count}[kernel]
    n0 = before()
    cost = OA.trace(lambda: META_CALLS[kernel]())
    assert cost.launches() == {kernel: 1}
    assert before() == n0


# ---------------------------------------------------------------------------
# (f) reanalyze, (g) the CLI
# ---------------------------------------------------------------------------


def test_reanalyze_reproduces_the_record_that_saved_it(tmp_path):
    rec = DRY.run_cell("mamba2-370m", "decode_32k", False, DRY.Knobs(),
                       debug_mesh=True, trace_dir=str(tmp_path))
    assert rec["status"] == "ok", rec.get("error")
    saved = json.loads(json.dumps(rec))
    again = copy.deepcopy(saved)
    for k in ("cost", "collectives"):
        del again[k]
    again["roofline"] = {"model_flops": saved["roofline"]["model_flops"]}
    assert RA.reanalyze_record(again, str(tmp_path))
    assert json.loads(json.dumps(again)) == saved


ROOF = ("compute_s", "memory_s", "collective_s", "dominant",
        "traced_flops_global", "useful_ratio", "step_s",
        "roofline_fraction", "model_flops", "ideal_s", "hw")


def test_dryrun_cli_writes_cost_collectives_memory_and_roofline(tmp_path):
    out = tmp_path / "dry.json"
    assert DRY.main(["--arch", "tinyllama-1.1b,mamba2-370m", "--shape",
                     "train_4k,decode_32k", "--mesh", "single",
                     "--debug-mesh", "--out", str(out)]) == 0
    res = json.loads(out.read_text())
    assert len(res) == 4
    for key, rec in res.items():
        assert rec["status"] == "ok", (key, rec.get("error"))
        c, col, m, r = (rec["cost"], rec["collectives"], rec["memory"],
                        rec["roofline"])
        assert c["flops_per_device"] > 0 and c["bytes_per_device"] > 0
        assert set(c) == {"flops_per_device", "bytes_per_device",
                          "loop_trips", "per_kernel"}
        assert set(col) == {"wire_bytes_per_chip", "result_bytes",
                            "per_op_bytes", "per_op_count"}
        assert col["wire_bytes_per_chip"] == pytest.approx(
            sum(col["per_op_bytes"].values()))
        for f in ("temp_bytes", "output_bytes", "live_bytes_per_device"):
            assert f in m
        assert m["live_bytes_per_device"] == (
            m["argument_bytes"] + m["temp_bytes"] + m["output_bytes"])
        assert m["fits_80gb"] == (m["live_bytes_per_device"] <= 80e9)
        assert set(ROOF) <= set(r)
        assert r["dominant"] in ("compute", "memory", "collective")
        assert r["step_s"] == max(r["compute_s"], r["memory_s"],
                                  r["collective_s"])
        kernels = c["per_kernel"]
        if "train_4k" in key:
            assert c["loop_trips"] == [rec["resolved_knobs"]["microbatches"]]
            assert "morph_matmul" not in kernels  # no backward: routed round
        else:
            assert kernels["morph_matmul"]["launches"] > 0
        if "mamba2" in key and "train_4k" in key:
            assert kernels["ssd_scan_bwd"]["launches"] > 0
