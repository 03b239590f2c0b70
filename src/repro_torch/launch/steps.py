"""Step functions (train / prefill / decode) with microbatching and remat.

Port of ``repro.launch.steps``. A train step is a (state, batch) ->
(state, metrics) callable; it updates the params and optimizer state in
place (``optim.apply_updates``) and returns the same state dict. Batches
may be numpy (``data.make_batch``) or tensors; numpy batches move to the
params' device.

With ``grad_shardings`` (``sharding.shardings_for`` of the ``train``
param specs) the step runs SPMD on this rank of a (data, model) mesh
that spans the world's ranks (the clipping norm sums over the world), on
the state ``init_train_state(mesh=...)`` / ``shard_train_state`` cut
(the training layout of ``parallel.sharding``): each rank takes its rows
of the global batch (``batch_specs``), runs the forward on its shard with
the layer groups' data-split pieces gathered over ``data`` (FSDP) and the
tensor-parallel collectives of ``parallel.tensor_parallel``, under
sequence parallelism where ``residual_specs(mesh, "train")`` is in force
(``sharding.activation_sharding``). The loss is the global batch's: each
rank's ``sum(nll * mask)`` over the all-reduced token count. Gradients
are cast to ``grad_dtype`` and completed in it (``sharding.
train_reduction``): reduce-scattered over ``data`` by the gathers'
backward, all-reduced over ``data`` for the leaves not split on it, and
summed over ``model`` for the partial ones. The optimizer updates the
rank's pieces, its clipping norm spanning the mesh.
"""
from __future__ import annotations

from typing import Callable, Dict, Optional

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig, MorphMode
from repro_torch.core import elastic
from repro_torch.data.pipeline import to_device
from repro_torch.device import dtype_of
from repro_torch.models.model import decode_step as _decode_step
from repro_torch.models.model import init_params, loss_fn, prefill
from repro_torch.optim import (OptimizerConfig, apply_updates, grads_of,
                               init_opt_state, trainable)
from repro_torch.optim.optimizer import tree_map


def to_microbatches(x, mb: int):
    """(B, ...) -> (mb, B/mb, ...): microbatch i takes rows i, i + mb, ...
    (the strided split that keeps per-device row counts equal)."""
    B = x.shape[0]
    assert B % mb == 0, (B, mb)
    x = x.reshape((B // mb, mb) + tuple(x.shape[1:]))
    return x.swapaxes(0, 1) if isinstance(x, np.ndarray) else x.transpose(0, 1)


def _on_device(batch, device):
    if any(isinstance(v, np.ndarray) for v in batch.values()):
        return to_device(batch, device)
    return batch


def make_train_step(cfg: ModelConfig, ocfg: OptimizerConfig, *,
                    microbatches: int = 1, remat: str = "full",
                    lr_schedule: Optional[Callable] = None,
                    grad_shardings=None, grad_dtype: str = "float32") -> Callable:
    """Build a (state, batch) -> (state, metrics) step.

    Gradients are taken in ``grad_dtype``; with microbatches they are
    summed in f32 and averaged, then cast to each param's dtype. The LR
    scale is ``lr_schedule(opt.step)`` read before the step increments.
    ``grad_shardings`` (the ``sharding.Sharding`` tree of the params'
    ``train`` specs on a mesh) makes it this rank's SPMD step (see the
    module docstring)."""
    sched = lr_schedule or (lambda step: 1.0)
    gdt = dtype_of(grad_dtype)
    if grad_shardings is not None:
        return _mesh_train_step(cfg, ocfg, microbatches, remat, sched,
                                grad_shardings, gdt)

    def mb_grads(params, mb_batch):
        loss, _ = loss_fn(params, mb_batch, cfg, remat=remat)
        grads = grads_of(loss, params)
        return loss.detach(), tree_map(lambda g: g.to(gdt), grads)

    def train_step(state, batch):
        params, opt = state["params"], state["opt"]
        batch = _on_device(batch, params["embed"].device)
        if microbatches == 1:
            loss, grads = mb_grads(params, batch)
        else:
            mbs = {k: to_microbatches(v, microbatches) for k, v in batch.items()}
            g_sum = tree_map(lambda a: torch.zeros_like(a, dtype=torch.float32),
                             params)
            l_sum = torch.zeros((), dtype=torch.float32,
                                device=params["embed"].device)
            for i in range(microbatches):
                loss, grads = mb_grads(params, {k: v[i] for k, v in mbs.items()})
                tree_map(lambda a, g: a.add_(g.float()), g_sum, grads)
                l_sum += loss
            grads = tree_map(lambda g, p: (g / microbatches).to(p.dtype),
                             g_sum, params)
            loss = l_sum / microbatches
        params, opt, metrics = apply_updates(params, grads, opt, ocfg,
                                             sched(opt.step))
        return {"params": params, "opt": opt}, {"loss": loss, **metrics}

    return train_step


def _mesh_train_step(cfg: ModelConfig, ocfg: OptimizerConfig, microbatches,
                     remat, sched, grad_shardings, gdt) -> Callable:
    import torch.distributed as dist

    from repro_torch.parallel import sharding as SH
    from repro_torch.parallel import tensor_parallel as TP

    leaves = list(SH.sharding_leaves(grad_shardings))
    if not leaves:
        raise ValueError("grad_shardings: expected the params' (mesh, spec) "
                         "shardings (sharding.shardings_for), got no "
                         "Sharding leaves")
    mesh = leaves[0][1].mesh
    sizes = SH.axis_sizes(mesh)
    if SH.data_axes(mesh) not in ((), ("data",)):
        raise ValueError(f"mesh training runs on a (data, model) mesh, got "
                         f"axes {tuple(sizes)}")
    coord = SH.mesh_coord(mesh)
    shard = SH.plan_serve_shard(cfg, mesh, n_slots=1)
    tp, dp = shard.tp, shard.dp
    mgroup = mesh.get_group("model") if tp > 1 else None
    dgroup = mesh.get_group("data") if dp > 1 else None

    def step_plan(sp: bool):
        rules = {p: SH.train_reduction(p, s.spec, cfg, mesh, sp=sp)
                 for p, s in leaves}
        return (rules,
                SH._map_specs(grad_shardings, lambda p, s: rules[p].data_dim),
                SH._map_specs(grad_shardings, lambda p, s: rules[p].replicas))

    plans = {}

    def complete(grads, rules, stage):
        """Cast to ``gdt`` and finish the reductions the backward left."""
        def leaf(path, g):
            r = rules[path]
            g = g.to(gdt)
            if r.model_sum == "model":
                g = TP._all_reduce(g.clone(), mgroup, stage)
            elif r.model_sum == "kv":  # sum over the ranks of one KV head
                k0, nk = shard.kv_heads
                hd = cfg.head_dim
                full = g.new_zeros(g.shape[:-1] + (cfg.n_kv_heads * hd,))
                full[..., k0 * hd:(k0 + nk) * hd] = g
                g = TP._all_reduce(full, mgroup, stage)[
                    ..., k0 * hd:(k0 + nk) * hd].contiguous()
            if r.data_dim is None and dp > 1:
                g = TP._all_reduce(g.clone(), dgroup, stage)
            return g

        return SH._map_with_path(grads, leaf)

    def setup(params, batch):
        dev = params["embed"].device
        stage = dist.get_backend() == "gloo" and dev.type == "cuda"
        sp = tp > 1 and SH.sequence_parallel()
        if sp not in plans:
            plans[sp] = step_plan(sp)
        comm = TP.ShardComm(shard, mgroup, dgroup, stage=stage, train=True,
                            sp=sp, grad_dtype=gdt)
        batch = _on_device(batch, dev)
        bspecs = SH.batch_specs(batch, mesh, "train")
        batch = {k: SH.take(v, SH.spec_slices(v.shape, bspecs[k], sizes,
                                              coord))
                 for k, v in batch.items()}
        return dev, stage, plans[sp], comm, batch

    def grads(params, batch):
        """(global loss, this rank's completed gradients in ``gdt``) of
        one pass over ``batch`` (no microbatches, no update)."""
        dev, stage, (rules, dims, _), comm, batch = setup(params, batch)
        return _mb_grads(params, batch, dev, stage, rules, dims, comm)

    def _mb_grads(params, mb_batch, dev, stage, rules, dims, comm):
        count = None
        if dp > 1:  # the global batch's token count
            m = mb_batch.get("loss_mask")
            n = (m.float().sum() if m is not None else torch.tensor(
                float(mb_batch["targets"].numel()), device=dev))
            count = TP._all_reduce(n.reshape(1).clone(), dgroup, stage)[0]
        with TP.shard_context(comm):
            view = TP.train_view(params, comm, dims)
            loss, _ = loss_fn(view, mb_batch, shard.cfg, remat=remat,
                              count=count)
            g = grads_of(loss, params)
        loss = loss.detach()
        if dp > 1:
            loss = TP._all_reduce(loss.reshape(1).clone(), dgroup, stage)[0]
        return loss, complete(g, rules, stage)

    def train_step(state, batch):
        params, opt = state["params"], state["opt"]
        dev, stage, (rules, dims, replicas), comm, batch = setup(params, batch)

        def mb_grads(mb_batch):
            return _mb_grads(params, mb_batch, dev, stage, rules, dims, comm)

        if microbatches == 1:
            loss, grads = mb_grads(batch)
        else:
            mbs = {k: to_microbatches(v, microbatches) for k, v in batch.items()}
            g_sum = tree_map(lambda a: torch.zeros_like(a, dtype=torch.float32),
                             params)
            l_sum = torch.zeros((), dtype=torch.float32, device=dev)
            for i in range(microbatches):
                loss, grads = mb_grads({k: v[i] for k, v in mbs.items()})
                tree_map(lambda a, g: a.add_(g.float()), g_sum, grads)
                l_sum += loss
            grads = tree_map(lambda g, p: (g / microbatches).to(p.dtype),
                             g_sum, params)
            loss = l_sum / microbatches
        params, opt, metrics = apply_updates(
            params, grads, opt, ocfg, sched(opt.step),
            replicas=replicas if dist.get_world_size() > 1 else None)
        return {"params": params, "opt": opt}, {"loss": loss, **metrics}

    train_step.grads = grads
    return train_step


def make_prefill_step(cfg: ModelConfig, *, remat: str = "none") -> Callable:
    """The prompt pass as a step. The port's ``prefill`` keeps caches, so it
    takes no activation checkpointing: ``remat`` must be "none"."""
    if remat != "none":
        raise ValueError("the prompt pass keeps its caches; remat applies to "
                         "the training forward only")

    def prefill_step(params, batch):
        return prefill(params, batch, cfg)

    return prefill_step


def make_decode_fn(cfg: ModelConfig, mode: Optional[MorphMode] = None) -> Callable:
    """serve_step: one token for every sequence in the batch."""
    if mode is None or (mode.width == 1.0 and mode.depth == cfg.n_groups):
        def serve_step(params, cache, tokens):
            return _decode_step(params, cache, tokens, cfg)
    else:
        def serve_step(params, cache, tokens):
            return elastic.morph_decode_step(params, cache, tokens, cfg, mode)

    return serve_step


def init_train_state(cfg: ModelConfig, ocfg: OptimizerConfig, *, seed: int = 0,
                     device=None, mesh=None) -> Dict:
    """Seeded params (requiring grad) and a fresh optimizer state on
    ``device`` (the card unless the caller says otherwise). With ``mesh``,
    this rank's pieces of them in the training layout: the full seeded
    params are built, cut and freed (the peak is one full replica)."""
    params = init_params(cfg, seed=seed, device=device)
    if mesh is not None:
        from repro_torch.parallel import sharding as SH

        shardings = SH.shardings_for(
            SH.param_specs(params, cfg, mesh, "train"), mesh, cfg)
        params = SH.shard_tree(params, shardings)
    params = trainable(params)
    return {"params": params, "opt": init_opt_state(params, ocfg)}


def shard_train_state(state: Dict, cfg: ModelConfig, mesh) -> Dict:
    """This rank's pieces of a full train state (``{"params", "opt"}``) in
    the training layout: params (requiring grad) and the moments cut
    alike, the step kept."""
    from repro_torch.parallel import sharding as SH

    params, opt = state["params"], state["opt"]
    pspecs = SH.param_specs(params, cfg, mesh, "train")
    with torch.no_grad():
        pieces = SH.shard_tree(params, SH.shardings_for(pspecs, mesh, cfg))
        ospec = SH.shardings_for(SH.opt_specs(opt, pspecs), mesh, cfg)
        opt = SH.shard_tree(opt, ospec)
    return {"params": trainable(pieces), "opt": opt}
