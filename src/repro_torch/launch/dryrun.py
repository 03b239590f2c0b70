"""Host-only dry-run: every (arch x shape x mesh) cell reckoned and traced
on meta tensors.

Port of ``repro.launch.dryrun``, where it means something in PyTorch. The
reference lowers and compiles each cell with XLA and reads the compiled
program's memory and cost analyses. The port has no such compiler: it
builds each cell's arguments as meta tensors (nothing allocated, no rank
started, no card touched), with the mesh as an ``{axis: size}`` mapping
(a ``collectives.TraceMesh`` for the step), and reports for the rank at
coordinate 0:

* ``memory``: the argument bytes one rank holds under the port's layouts
  (``parallel.sharding``): params, optimizer state and batch for a train
  cell (the training layout), params and batch for prefill, params, cache
  and tokens for decode (the serving shard: ``plan_serve_shard`` under
  ``serve_tp``, ``param_specs(..., "serve_2d")``'s cut under
  ``serve_2d``); from the trace, ``temp_bytes`` (the peak of the live
  storages the step makes), ``output_bytes`` (the new storages it
  returns) and ``live_bytes_per_device`` (argument + temp + output), and
  ``fits_80gb`` of the live bytes against
  ``core.neuroforge.hw.DEFAULT_HW.hbm_bytes`` (one H100's HBM);
* ``cost`` and ``collectives``: the rank's step as a rank runs it (a
  train cell: ``make_train_step(grad_shardings=...)`` on ``train_view``'s
  gathers, with SP where ``k.sp``, the remat and microbatches of the
  knobs; prefill: ``make_prefill_step`` on the same gathers; decode:
  ``make_decode_fn`` at full width under ``MeshStep`` with the serve
  shard, or ``Serve2D``'s view under ``serve_2d``), traced once by
  ``launch.op_analysis``: FLOPs and HBM bytes per rank (the eager port's
  traffic: every op reads its operands and writes its result), the loop
  trips, each hand kernel's launches, FLOPs and bytes, and the collectives'
  ring-model wire bytes in the dtypes the port sends, on the routes of
  NCCL (``BACKEND``: one rank a card);
* ``roofline``: ``compute_s``, ``memory_s`` and ``collective_s`` of that
  work at ``DEFAULT_HW``'s peak, HBM rate and NVLink rate, the
  ``dominant`` term, ``step_s`` (the largest), ``model_flops`` (6 N T for
  training, 2 N T otherwise, N the active parameters), ``ideal_s`` (that
  work over the mesh's cards at the peak), ``traced_flops_global``,
  ``useful_ratio`` and ``roofline_fraction`` (ideal over step);
* ``status`` ``skip`` with ``cell_applicable``'s reason, or ``error`` with
  the exception of a cell that cannot be reckoned or traced (one whose
  step the port cannot run: heads that do not split over tp, ``serve_2d``
  with fewer KV heads than tp; it keeps its argument bytes).

Not reckoned: the reference's ``xla_cost_analysis_*`` fields (XLA's own
per-module counts, which have no counterpart without a compiler), and
``alias_bytes`` (the port updates a train state in place, so its outputs
are new storages only). A prefill cell runs without sequence
parallelism (the port's SP is a training collective). The port's mesh
steps run on a (data, model) mesh: on the pod mesh the trace folds the
pod axis into ``data`` (``trace_mesh``), as those ranks would run it,
while the argument bytes keep the reference's pod layout.

``--save-trace DIR`` (the counterpart of ``--save-hlo``) writes each
cell's op stream as gzipped JSON and names it in ``trace_file``;
``launch.reanalyze`` re-runs the accounting over it.

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
import traceback
from typing import Any, Dict, Mapping, Optional

import torch

from repro_torch.configs import (SHAPE_BY_NAME, SHAPES, cell_applicable,
                                 get_config, list_archs)
from repro_torch.configs.base import ModelConfig, MorphMode, ShapeCell
from repro_torch.core import elastic
from repro_torch.core.neuroforge.hw import DEFAULT_HW
from repro_torch.device import dtype_of
from repro_torch.launch import op_analysis as OA
from repro_torch.models.model import init_decode_cache, init_params
from repro_torch.optim import OptimizerConfig, init_opt_state
from repro_torch.parallel import sharding as SH

RESULTS_DEFAULT = "build/dryrun.json"
# the collectives' routes a trace records: one rank a card, over NCCL
BACKEND = "nccl"
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


def _train_pieces(cfg: ModelConfig, mesh, ocfg=None):
    """The rank's training-layout pieces as meta tensors (params requiring
    grad; with ``ocfg`` a train state ``{"params", "opt"}``), and the
    params' ``grad_shardings``."""
    from repro_torch.optim import trainable

    params = init_params(cfg, device=META)
    pspecs = SH.param_specs(params, cfg, mesh, "train")
    pieces = trainable(SH.shard_tree(params, SH.shardings_for(pspecs, mesh,
                                                              cfg)))
    gsh = SH.shardings_for(pspecs, mesh)
    if ocfg is None:
        return pieces, gsh
    return {"params": pieces, "opt": init_opt_state(pieces, ocfg)}, gsh


def _sp_scope(mesh, on: bool):
    import contextlib

    return (SH.activation_sharding(mesh, SH.residual_specs(mesh, "train"))
            if on else contextlib.nullcontext())


def _trace_train(cfg: ModelConfig, cell: ShapeCell, mesh, k: Knobs, world
                 ) -> OA.OpCost:
    """One rank's train step (``make_train_step(grad_shardings=...)``)
    traced on the global batch, which the step cuts to the rank's rows."""
    from repro_torch.launch.steps import make_train_step

    ocfg = OptimizerConfig(moment_dtype=k.moment_dtype or "float32")
    state, gsh = _train_pieces(cfg, mesh, ocfg)
    step = make_train_step(cfg, ocfg, microbatches=k.microbatches,
                           remat=k.remat, grad_shardings=gsh,
                           grad_dtype=k.grad_dtype)
    batch = batch_struct(cfg, cell.global_batch, cell.seq_len)
    with _sp_scope(mesh, k.sp):
        return OA.trace(step, state, batch, world=world, backend=BACKEND)


def _trace_prefill(cfg: ModelConfig, cell: ShapeCell, mesh, k: Knobs, world
                   ) -> OA.OpCost:
    """One rank's prompt pass (``make_prefill_step``) on its rows of the
    batch, over ``train_view``'s FSDP gathers of the training layout and
    the tensor-parallel collectives."""
    from repro_torch.launch.steps import make_prefill_step
    from repro_torch.parallel import tensor_parallel as TP

    pieces, gsh = _train_pieces(cfg, mesh)
    shard = SH.plan_serve_shard(cfg, mesh, n_slots=1)
    sizes, coord = SH.axis_sizes(mesh), SH.mesh_coord(mesh)
    dims = SH._map_specs(gsh, lambda p, sh: SH.train_reduction(
        p, sh.spec, cfg, mesh).data_dim)
    groups = mesh.mesh_dim_names
    step = make_prefill_step(shard.cfg)
    batch = batch_struct(cfg, cell.global_batch, cell.seq_len)
    bspecs = SH.batch_specs(batch, mesh, "train")
    batch = {n: SH.take(v, SH.spec_slices(v.shape, bspecs[n], sizes, coord))
             for n, v in batch.items() if n != "targets"}

    def run(params, batch):
        comm = TP.ShardComm(
            shard, mesh.get_group("model") if "model" in groups else None,
            mesh.get_group("data") if "data" in groups else None)
        with torch.no_grad(), TP.shard_context(comm):
            return step(TP.train_view(params, comm, dims), batch)

    return OA.trace(run, pieces, batch, world=world, backend=BACKEND)


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


def _decode_args(cfg_full: ModelConfig, cfg_exec: ModelConfig,
                 cell: ShapeCell, mesh, k: Knobs, mode):
    """The rank's held params, its cache, its shard and the ``serve_2d``
    plan's recipes (None under ``serve_tp``), as meta tensors."""
    B = cell.global_batch
    params_cfg = cfg_full if mode is not None else cfg_exec
    params = init_params(params_cfg, device=META)
    shard = SH.plan_serve_shard(cfg_exec, mesh, n_slots=B)
    recipes = None
    if k.policy == "serve_2d":
        specs, recipes = SH.serve_2d_plan(params, shard, params_cfg, mesh)
        held = SH.shard_params(params, specs, mesh)
    else:
        held = SH.shard_serve_params(params, SH.plan_serve_shard(
            params_cfg, mesh, n_slots=B), params_cfg)
    cache = init_decode_cache(shard.cfg, shard.slots[1], cell.seq_len,
                              device=META)
    return held, cache, shard, recipes


def _trace_decode(cfg_full: ModelConfig, cfg_exec: ModelConfig,
                  cell: ShapeCell, mesh, k: Knobs, mode, world
                  ) -> OA.OpCost:
    """One rank's decode step (``make_decode_fn``; at the full mode with
    every slot's width operand at 1.0, as the engines serve) under
    ``MeshStep``: the tokens cut to the rank's slots, the step on the shard,
    its logits gathered over ``data``; under ``serve_2d`` on ``Serve2D``'s
    view of the held params."""
    from repro_torch.launch.steps import make_decode_fn
    from repro_torch.parallel import tensor_parallel as TP

    held, cache, shard, recipes = _decode_args(cfg_full, cfg_exec, cell,
                                               mesh, k, mode)
    groups = mesh.mesh_dim_names
    B = cell.global_batch
    tokens = torch.empty((B, 1), dtype=torch.int32, device=META)
    if mode is None:
        fn = make_decode_fn(shard.cfg)
        active = elastic.active_widths_batch(cfg_exec, [1.0] * B,
                                             device=META)
        args = (held, cache, tokens, active)
    else:
        fn = make_decode_fn(shard.cfg, mode)
        args = (held, cache, tokens)

    def run(*args):
        comm = TP.ShardComm(
            shard, mesh.get_group("model") if "model" in groups else None,
            mesh.get_group("data") if "data" in groups else None)
        if recipes is not None:
            comm.serve2d = TP.Serve2D(recipes, comm.data_group, shard.dp,
                                      False)
        return TP.MeshStep(fn, comm)(*args)

    with torch.no_grad():
        return OA.trace(run, *args, world=world, backend=BACKEND)


# ---------------------------------------------------------------------------
# cell runner
# ---------------------------------------------------------------------------


def apply_cost(rec: Dict[str, Any], cost: OA.OpCost, chips: int,
               hw=DEFAULT_HW) -> None:
    """Write an ``OpCost``'s ``cost``, ``collectives`` and roofline terms
    into a cell's record (``rec["roofline"]["model_flops"]`` set), as the
    reference's dry-run and reanalyze do."""
    rec["cost"] = {"flops_per_device": cost.flops,
                   "bytes_per_device": cost.bytes,
                   "loop_trips": list(cost.loop_trips),
                   "per_kernel": {n: dict(v)
                                  for n, v in cost.per_kernel.items()}}
    rec["collectives"] = {"wire_bytes_per_chip": cost.coll_wire_bytes,
                          "result_bytes": cost.coll_result_bytes,
                          "per_op_bytes": dict(cost.per_op_bytes),
                          "per_op_count": dict(cost.per_op_count)}
    compute_s = cost.flops / hw.peak_flops
    memory_s = cost.bytes / hw.hbm_bw
    coll_s = cost.coll_wire_bytes / hw.ici_bw
    r = rec["roofline"]
    model_flops = r["model_flops"]
    traced_global = cost.flops * chips
    step = max(compute_s, memory_s, coll_s)
    ideal = model_flops / (chips * hw.peak_flops)
    r.update(compute_s=compute_s, memory_s=memory_s, collective_s=coll_s,
             dominant=max(("compute", compute_s), ("memory", memory_s),
                          ("collective", coll_s), key=lambda kv: kv[1])[0],
             traced_flops_global=traced_global,
             useful_ratio=model_flops / traced_global if traced_global
             else 0.0,
             ideal_s=ideal, step_s=step,
             roofline_fraction=ideal / step if step > 0 else 0.0,
             hw=hw.name)


def run_cell(arch: str, shape: str, multi_pod: bool, knobs: Knobs,
             mesh: Optional[Mapping[str, int]] = None,
             debug_mesh: bool = False,
             trace_dir: Optional[str] = None) -> Dict[str, Any]:
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
    rec["memory"] = mem  # kept by a cell whose step cannot be traced
    from repro_torch.models.layers import set_bf16_grad_matmul
    from repro_torch.parallel.collectives import TraceMesh

    # the port's mesh steps run on (data, model): a pod axis folds into
    # data (its ranks and the data axis's form one data-parallel group)
    folded = {"data": math.prod(sizes[a] for a in SH.data_axes(sizes))}
    if "model" in sizes:
        folded["model"] = sizes["model"]
    tmesh = TraceMesh(folded)
    rec["trace_mesh"] = folded
    t0 = time.time()
    set_bf16_grad_matmul(k.bf16_grad_matmul)
    try:
        if cell.kind == "train":
            cost = _trace_train(cfg_exec, cell, tmesh, k, chips)
        elif cell.kind == "prefill":
            cost = _trace_prefill(cfg_exec, cell, tmesh, k, chips)
        else:
            cost = _trace_decode(cfg, cfg_exec, cell, tmesh, k, mode, chips)
    except Exception as e:  # noqa: BLE001 — record and continue the sweep
        rec.update(status="error", error=f"{type(e).__name__}: {e}",
                   trace=traceback.format_exc()[-2000:])
        return rec
    finally:
        set_bf16_grad_matmul(False)
    rec["time_trace_s"] = round(time.time() - t0, 3)
    rec["backend"] = BACKEND
    mem.update(temp_bytes=cost.peak_temp_bytes, output_bytes=cost.output_bytes)
    mem["live_bytes_per_device"] = (mem["argument_bytes"] + mem["temp_bytes"]
                                    + mem["output_bytes"])
    mem["fits_80gb"] = bool(mem["live_bytes_per_device"]
                            <= DEFAULT_HW.hbm_bytes)
    if trace_dir:
        os.makedirs(trace_dir, exist_ok=True)
        fn = f"{arch}__{shape}__{mesh_name}__{knobs.key()}.trace.json.gz"
        OA.save_events(os.path.join(trace_dir, fn), cost,
                       {"arch": arch, "shape": shape, "mesh": mesh_name,
                        "world": chips, "backend": BACKEND})
        rec["trace_file"] = fn
    tokens = cell.global_batch * (cell.seq_len if cell.kind != "decode"
                                  else 1)
    n_active = cfg_exec.n_active_params()
    if mode is not None:
        n_active = int(n_active * mode.depth / cfg_exec.n_groups)
    model_flops = (6.0 if cell.kind == "train" else 2.0) * n_active * tokens
    rec["roofline"] = {"model_flops": model_flops}
    apply_cost(rec, cost, chips)
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
    ap.add_argument("--save-trace", default="",
                    help="write each cell's op stream (gzipped JSON) here")
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
                               debug_mesh=args.debug_mesh,
                               trace_dir=args.save_trace or None)
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
                          f"live={m['live_bytes_per_device'] / 1e9:.3f}GB "
                          f"per rank fits_80gb={m['fits_80gb']} "
                          f"dom={r['dominant']} compute="
                          f"{r['compute_s'] * 1e3:.2f}ms memory="
                          f"{r['memory_s'] * 1e3:.2f}ms coll="
                          f"{r['collective_s'] * 1e3:.2f}ms "
                          f"ideal={r['ideal_s'] * 1e3:.2f}ms frac="
                          f"{r['roofline_fraction']:.4f} (trace "
                          f"{rec['time_trace_s']:.1f} s)", flush=True)
                elif st == "skip":
                    print(f"  skip: {rec['reason']}")
                else:
                    print(f"  ERROR: {rec['error']}")
    print(f"done: ok={n_ok} skip={n_skip} err={n_err}")
    return 1 if n_err else 0


if __name__ == "__main__":
    raise SystemExit(main())
