"""Step functions (train / prefill / decode) with microbatching and remat.

Port of ``repro.launch.steps``. A train step is a (state, batch) ->
(state, metrics) callable; it updates the params and optimizer state in
place (``optim.apply_updates``) and returns the same state dict. Batches
may be numpy (``data.make_batch``) or tensors; numpy batches move to the
params' device.
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
    ``grad_shardings`` constrains a sharded gradient accumulator in the
    reference. The port's mesh serves but does not train yet: data-parallel
    training, with the training half of ``parallel.sharding``, is the
    port's remaining slice (ROADMAP.md, A), so it must be None."""
    if grad_shardings is not None:
        raise NotImplementedError("grad_shardings: data-parallel training "
                                  "arrives with the port's training-side "
                                  "mesh slice (ROADMAP.md, A)")
    sched = lr_schedule or (lambda step: 1.0)
    gdt = dtype_of(grad_dtype)

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
                     device=None) -> Dict:
    """Seeded params (requiring grad) and a fresh optimizer state on
    ``device`` (the card unless the caller says otherwise)."""
    params = trainable(init_params(cfg, seed=seed, device=device))
    return {"params": params, "opt": init_opt_state(params, ocfg)}
