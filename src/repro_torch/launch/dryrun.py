"""Host-only dry-run: every (arch x shape x mesh) cell reckoned on meta
tensors.

Port of ``repro.launch.dryrun``, where it means something in PyTorch. The
reference lowers and compiles each cell with XLA and reads the compiled
program's memory and cost analyses. The port has no such compiler: it
builds each cell's arguments as meta tensors (nothing allocated, no rank
started, no card touched), with the mesh as an ``{axis: size}`` mapping,
and reports for the rank at coordinate 0:

* ``memory``: the argument bytes one rank holds under the port's layouts
  (``parallel.sharding``): params, optimizer state and batch for a train
  cell (the training layout), params and batch for prefill, params, cache
  and tokens for decode (the serving shard: ``plan_serve_shard`` under
  ``serve_tp``, ``param_specs(..., "serve_2d")``'s cut under
  ``serve_2d``), and ``fits_80gb`` of those bytes against
  ``core.neuroforge.hw.DEFAULT_HW.hbm_bytes`` (one H100's HBM);
* ``roofline``: ``model_flops`` (6 N T for training, 2 N T otherwise, N
  the active parameters) and ``ideal_s``, that work over the mesh's cards
  at ``DEFAULT_HW.peak_flops`` (the H100's dense bf16 data-sheet peak);
* ``status`` ``skip`` with ``cell_applicable``'s reason.

Left out: the reference's ``cost``, ``collectives`` and its compute /
memory / collective roofline terms and the temporary and output bytes of
``memory_analysis``, which all come from XLA's compiled HLO.

Usage (results cached in a JSON file keyed by ``cell_key``):
  PYTHONPATH=src python -m repro_torch.launch.dryrun \\
      --arch tinyllama-1.1b,mamba2-370m --shape train_4k,decode_32k \\
      --debug-mesh
"""
from __future__ import annotations

import argparse
import dataclasses
import hashlib
import json
import math
import os
import time
from typing import Any, Dict, Mapping, Optional

import torch

from repro_torch.configs import (SHAPE_BY_NAME, SHAPES, cell_applicable,
                                 get_config, list_archs)
from repro_torch.configs.base import ModelConfig, MorphMode, ShapeCell
from repro_torch.core import elastic
from repro_torch.core.neuroforge.hw import DEFAULT_HW
from repro_torch.device import dtype_of
from repro_torch.models.model import init_decode_cache, init_params
from repro_torch.optim import OptimizerConfig, init_opt_state
from repro_torch.parallel import sharding as SH

RESULTS_DEFAULT = "build/dryrun.json"
META = torch.device("meta")


# ---------------------------------------------------------------------------
# knobs (the reference's, so that a cell's key is the same)
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class Knobs:
    remat: str = "full"
    microbatches: int = 0  # 0 = auto (per-shard batch -> microbatch of 1 seq)
    moment_dtype: str = ""  # "" = auto (bf16 for >50B params)
    param_dtype: str = "bfloat16"
    kv_quant: bool = False
    width: float = 1.0
    depth_frac: float = 1.0  # morph depth fraction (1.0 = full)
    policy: str = ""  # "" = auto
    attn_chunk: int = 1024
    capacity_factor: float = 1.25
    sp: bool = True  # sequence-parallel residual constraint
    grad_dtype: str = "float32"  # gradient reduction dtype
    bf16_grad_matmul: bool = False  # bf16 dW (layers.set_bf16_grad_matmul)

    def key(self) -> str:
        return hashlib.md5(json.dumps(dataclasses.asdict(self),
                                      sort_keys=True).encode()).hexdigest()[:10]


def resolve_cfg(arch: str, knobs: Knobs) -> ModelConfig:
    cfg = get_config(arch)
    return cfg.scaled(param_dtype=knobs.param_dtype, dtype="bfloat16",
                      attn_impl="chunked", attn_chunk=knobs.attn_chunk,
                      kv_quant=knobs.kv_quant,
                      capacity_factor=knobs.capacity_factor)


def auto_knobs(cfg: ModelConfig, cell: ShapeCell, mesh: Mapping[str, int],
               knobs: Knobs) -> Knobs:
    k = dataclasses.replace(knobs)
    sizes = SH.axis_sizes(mesh)
    data_sz = math.prod(sizes[a] for a in SH.data_axes(sizes))
    if not k.moment_dtype:
        k.moment_dtype = "bfloat16" if cfg.n_params() > 50e9 else "float32"
    if k.microbatches == 0:
        per_shard = max(1, cell.global_batch // data_sz)
        k.microbatches = max(1, per_shard // 2)  # 2-seq microbatches default
    if not k.policy:
        k.policy = "train" if cell.kind != "decode" else SH.serve_policy(
            cfg, tp=sizes.get("model", 1))
    return k


# ---------------------------------------------------------------------------
# arguments as meta tensors
# ---------------------------------------------------------------------------


def batch_struct(cfg: ModelConfig, B: int, S: int) -> Dict[str, torch.Tensor]:
    text = S - (cfg.frontend_seq if cfg.frontend == "vision_stub" else 0)
    out = {"tokens": torch.empty((B, text), dtype=torch.int32, device=META),
           "targets": torch.empty((B, text), dtype=torch.int32, device=META)}
    if cfg.frontend == "vision_stub":
        out["patches"] = torch.empty((B, cfg.frontend_seq, cfg.frontend_dim),
                                     dtype=torch.bfloat16, device=META)
    if cfg.is_encdec:
        out["frames"] = torch.empty((B, cfg.enc_seq, cfg.frontend_dim),
                                    dtype=torch.bfloat16, device=META)
    return out


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif dataclasses.is_dataclass(tree):
        for f in dataclasses.fields(tree):
            yield from _leaves(getattr(tree, f.name))
    else:
        yield tree


def _bytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in _leaves(tree))


def _cut_bytes(tree, shardings, coord) -> int:
    """Bytes of the pieces the rank at ``coord`` holds of ``tree``."""
    total = 0
    flat = dict(SH.sharding_leaves(shardings))

    def walk(t, path):
        nonlocal total
        if isinstance(t, dict):
            for k, v in t.items():
                walk(v, path + (str(k),))
        elif dataclasses.is_dataclass(t):
            for f in dataclasses.fields(t):
                walk(getattr(t, f.name), path + (f.name,))
        else:
            sl = flat[path].slices(t.shape, coord)
            n = t.numel()
            for dim, (_, size) in sl.items():
                n = n // t.shape[dim] * size
            total += n * t.element_size()

    walk(tree, ())
    return total


def _mesh_of(multi_pod: bool, debug_mesh: bool) -> Dict[str, int]:
    if debug_mesh:
        return ({"pod": 2, "data": 2, "model": 2} if multi_pod
                else {"data": 2, "model": 4})
    return ({"pod": 2, "data": 16, "model": 16} if multi_pod
            else {"data": 16, "model": 16})


def train_state_bytes(cfg: ModelConfig, ocfg: OptimizerConfig, mesh,
                      coord: Optional[Dict[str, int]] = None
                      ) -> Dict[str, int]:
    """{"params_bytes", "opt_bytes"}: what the rank at ``coord`` (0 on
    every axis by default) holds of a train state in the training layout
    (``launch.steps.init_train_state(mesh=...)``'s), from meta tensors."""
    sizes = SH.axis_sizes(mesh)
    coord = coord or {a: 0 for a in sizes}
    params = init_params(cfg, device=META)
    pspecs = SH.param_specs(params, cfg, sizes, "train")
    opt = init_opt_state(params, ocfg)
    return {"params_bytes": _cut_bytes(
                params, SH.shardings_for(pspecs, sizes, cfg), coord),
            "opt_bytes": _cut_bytes(
                opt, SH.shardings_for(SH.opt_specs(opt, pspecs), sizes, cfg),
                coord)}


def _train_memory(cfg: ModelConfig, cell: ShapeCell, mesh, k: Knobs,
                  coord, with_opt: bool) -> Dict[str, int]:
    out = train_state_bytes(cfg, OptimizerConfig(
        moment_dtype=k.moment_dtype or "float32"), mesh, coord)
    if not with_opt:
        del out["opt_bytes"]
    batch = batch_struct(cfg, cell.global_batch, cell.seq_len)
    out["batch_bytes"] = _cut_bytes(batch, SH.shardings_for(
        SH.batch_specs(batch, mesh, "train"), mesh), coord)
    return out


def _decode_memory(cfg_full: ModelConfig, cfg_exec: ModelConfig,
                   cell: ShapeCell, mesh, k: Knobs, mode, coord
                   ) -> Dict[str, int]:
    B = cell.global_batch
    params_cfg = cfg_full if mode is not None else cfg_exec
    params = init_params(params_cfg, device=META)
    shard = SH.plan_serve_shard(cfg_exec, mesh, n_slots=B, coord=coord)
    if k.policy == "serve_2d":
        specs = SH.param_specs(params, params_cfg, mesh, "serve_2d")
        pbytes = _cut_bytes(params, SH.shardings_for(specs, mesh), coord)
    else:
        pshard = SH.plan_serve_shard(params_cfg, mesh, n_slots=B, coord=coord)
        pbytes = _bytes(SH.shard_serve_params(params, pshard, params_cfg))
    cache = init_decode_cache(shard.cfg, shard.slots[1], cell.seq_len,
                              device=META)
    sizes = SH.axis_sizes(mesh)
    dp = math.prod(sizes[a] for a in SH.data_axes(sizes))
    tok_rows = B // dp if (k.policy != "serve_2d" and B % dp == 0) else B
    return {"params_bytes": pbytes, "cache_bytes": _bytes(cache),
            "tokens_bytes": tok_rows * 4}


# ---------------------------------------------------------------------------
# cell runner
# ---------------------------------------------------------------------------


def run_cell(arch: str, shape: str, multi_pod: bool, knobs: Knobs,
             mesh: Optional[Mapping[str, int]] = None,
             debug_mesh: bool = False) -> Dict[str, Any]:
    cell = SHAPE_BY_NAME[shape]
    cfg = resolve_cfg(arch, knobs)
    ok, why = cell_applicable(cfg, cell)
    mesh_name = ("2x2x2" if multi_pod else "2x4") if debug_mesh else \
        ("2x16x16" if multi_pod else "16x16")
    rec: Dict[str, Any] = {"arch": arch, "shape": shape, "mesh": mesh_name,
                           "knobs": dataclasses.asdict(knobs)}
    if not ok:
        rec.update(status="skip", reason=why)
        return rec
    sizes = SH.axis_sizes(mesh or _mesh_of(multi_pod, debug_mesh))
    chips = math.prod(sizes.values())
    k = auto_knobs(cfg, cell, sizes, knobs)
    rec["resolved_knobs"] = dataclasses.asdict(k)
    rec["policy"] = k.policy
    mode: Optional[MorphMode] = None
    cfg_exec = cfg
    if k.width < 1.0 or k.depth_frac < 1.0:
        depth = max(1, int(round(cfg.n_groups * k.depth_frac)))
        mode = MorphMode(depth=depth, width=k.width)
        cfg_exec = elastic.morph_config(cfg, mode)
    coord = {a: 0 for a in sizes}
    t0 = time.time()
    try:
        if cell.kind == "decode":
            mem = _decode_memory(cfg, cfg_exec, cell, sizes, k, mode, coord)
        else:
            mem = _train_memory(cfg_exec, cell, sizes, k, coord,
                                with_opt=cell.kind == "train")
    except Exception as e:  # noqa: BLE001 — record and continue the sweep
        rec.update(status="error", error=f"{type(e).__name__}: {e}")
        return rec
    rec["time_reckon_s"] = round(time.time() - t0, 3)
    mem["argument_bytes"] = sum(mem.values())
    mem["fits_80gb"] = bool(mem["argument_bytes"] <= DEFAULT_HW.hbm_bytes)
    rec["memory"] = mem
    tokens = cell.global_batch * (cell.seq_len if cell.kind != "decode"
                                  else 1)
    n_active = cfg_exec.n_active_params()
    if mode is not None:
        n_active = int(n_active * mode.depth / cfg_exec.n_groups)
    model_flops = (6.0 if cell.kind == "train" else 2.0) * n_active * tokens
    rec["roofline"] = {"model_flops": model_flops,
                       "ideal_s": model_flops / (chips * DEFAULT_HW.peak_flops),
                       "hw": DEFAULT_HW.name}
    rec["status"] = "ok"
    return rec


# ---------------------------------------------------------------------------
# the sweep, its results cached in a JSON file
# ---------------------------------------------------------------------------


def cell_key(arch: str, shape: str, mesh_name: str, knobs: Knobs) -> str:
    return f"{arch}|{shape}|{mesh_name}|{knobs.key()}"


def load_results(path: str) -> Dict[str, Any]:
    if os.path.exists(path):
        with open(path) as f:
            return json.load(f)
    return {}


def save_results(path: str, results: Dict[str, Any]):
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(results, f, indent=1, sort_keys=True)
    os.replace(tmp, path)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", default="all")
    ap.add_argument("--shape", default="all")
    ap.add_argument("--mesh", default="both", choices=["single", "multi",
                                                       "both"])
    ap.add_argument("--out", default=RESULTS_DEFAULT)
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--tag", default="", help="suffix for the result key")
    ap.add_argument("--list", action="store_true")
    ap.add_argument("--remat", default="full", choices=["none", "dots", "full"])
    ap.add_argument("--microbatches", type=int, default=0)
    ap.add_argument("--moment-dtype", default="")
    ap.add_argument("--param-dtype", default="bfloat16")
    ap.add_argument("--kv-quant", action="store_true")
    ap.add_argument("--width", type=float, default=1.0)
    ap.add_argument("--depth-frac", type=float, default=1.0)
    ap.add_argument("--policy", default="")
    ap.add_argument("--attn-chunk", type=int, default=1024)
    ap.add_argument("--capacity-factor", type=float, default=1.25)
    ap.add_argument("--grad-dtype", default="float32")
    ap.add_argument("--bf16-grad-matmul", action="store_true")
    ap.add_argument("--no-sp", action="store_true")
    ap.add_argument("--debug-mesh", action="store_true",
                    help="the 8-rank debug mesh: (2, 4) or (2, 2, 2)")
    args = ap.parse_args(argv)

    if args.list:
        for a in list_archs():
            print(a)
        return 0
    dtype_of(args.param_dtype)  # an unknown dtype is a usage error
    knobs = Knobs(remat=args.remat, microbatches=args.microbatches,
                  moment_dtype=args.moment_dtype, param_dtype=args.param_dtype,
                  kv_quant=args.kv_quant, width=args.width,
                  depth_frac=args.depth_frac, policy=args.policy,
                  attn_chunk=args.attn_chunk,
                  capacity_factor=args.capacity_factor, sp=not args.no_sp,
                  grad_dtype=args.grad_dtype,
                  bf16_grad_matmul=args.bf16_grad_matmul)
    archs = list_archs() if args.arch == "all" else args.arch.split(",")
    shapes = ([s.name for s in SHAPES] if args.shape == "all"
              else args.shape.split(","))
    meshes = {"single": [False], "multi": [True],
              "both": [False, True]}[args.mesh]

    results = load_results(args.out)
    n_ok = n_skip = n_err = 0
    for multi in meshes:
        mesh_name = ("2x2x2" if multi else "2x4") if args.debug_mesh else \
            ("2x16x16" if multi else "16x16")
        for arch in archs:
            for shape in shapes:
                key = cell_key(arch, shape, mesh_name, knobs) + (
                    f"|{args.tag}" if args.tag else "")
                if key in results and not args.force \
                        and results[key].get("status") in ("ok", "skip"):
                    print(f"[cache] {key} -> {results[key]['status']}")
                    continue
                print(f"[run] {arch} x {shape} x {mesh_name} ...", flush=True)
                rec = run_cell(arch, shape, multi, knobs,
                               debug_mesh=args.debug_mesh)
                rec["tag"] = args.tag
                results[key] = rec
                save_results(args.out, results)
                st = rec["status"]
                n_ok += st == "ok"
                n_skip += st == "skip"
                n_err += st == "error"
                if st == "ok":
                    m, r = rec["memory"], rec["roofline"]
                    print(f"  ok: args={m['argument_bytes'] / 1e9:.3f}GB "
                          f"per rank fits_80gb={m['fits_80gb']} "
                          f"model_flops={r['model_flops']:.3e} "
                          f"ideal={r['ideal_s'] * 1e3:.2f}ms", flush=True)
                elif st == "skip":
                    print(f"  skip: {rec['reason']}")
                else:
                    print(f"  ERROR: {rec['error']}")
    print(f"done: ok={n_ok} skip={n_skip} err={n_err}")
    return 1 if n_err else 0


if __name__ == "__main__":
    raise SystemExit(main())
