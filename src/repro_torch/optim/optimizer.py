"""Optimizers written out in PyTorch (no ``torch.optim``).

Port of ``repro.optim.optimizer``: AdamW with decoupled weight decay and
sgd with momentum, global-norm clipping, and a configurable moment dtype
(f32 moments are the baseline; bf16 moments halve the optimizer's memory).

Where JAX returns new params and a new state, ``apply_updates`` updates both
in place under ``torch.no_grad()``: a 1.1 B-parameter model is not copied
every step. Params and moments are nested dicts of tensors with the JAX
tree keys; the decay mask reads the same ``/``-joined key path as the
reference's ``tree_map_with_path``.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Iterator, Tuple

import torch

from repro_torch.device import dtype_of

_NO_DECAY = ("norm", "scale", "bias", "A_log", "dt_bias", "D")


@dataclass(frozen=True)
class OptimizerConfig:
    name: str = "adamw"  # adamw | sgdm
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    moment_dtype: str = "float32"  # float32 | bfloat16
    momentum: float = 0.9  # sgdm only


@dataclass
class OptState:
    """``step`` is a 0-d int32 tensor on the params' device; ``mu`` / ``nu``
    mirror the param tree (``nu`` holds empty tensors for sgdm)."""
    step: torch.Tensor
    mu: Dict
    nu: Dict


def leaves_with_path(tree, prefix: str = "") -> Iterator[Tuple[str, torch.Tensor]]:
    """(``/``-joined key path, tensor) for every leaf, in insertion order."""
    for k, v in tree.items():
        path = f"{prefix}/{k}" if prefix else str(k)
        if isinstance(v, dict):
            yield from leaves_with_path(v, path)
        else:
            yield path, v


def tree_map(fn, tree, *rest):
    """``fn`` over the leaves of ``tree`` and the matching leaves of
    ``rest`` (trees with the same keys)."""
    return {k: tree_map(fn, v, *(r[k] for r in rest)) if isinstance(v, dict)
            else fn(v, *(r[k] for r in rest)) for k, v in tree.items()}


def _leaves(tree):
    return [v for _, v in leaves_with_path(tree)]


def global_norm(tree, replicas=None, group=None) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf. On a mesh, ``tree`` holds
    this rank's pieces and ``replicas`` (a tree like it of ints) how many
    ranks hold each piece's elements: each leaf's sum of squares is
    divided by it and the sums are all-reduced over ``group`` (the world
    by default), so every distinct element counts once."""
    if replicas is None:
        return torch.sqrt(sum(torch.sum(torch.square(a.float()))
                              for a in _leaves(tree)))
    import torch.distributed as dist

    reps = dict(leaves_with_path(replicas))
    total = sum(torch.sum(torch.square(a.float())) / reps[p] if reps[p] > 1
                else torch.sum(torch.square(a.float()))
                for p, a in leaves_with_path(tree))
    if dist.get_backend(group) == "gloo" and total.is_cuda:
        host = total.cpu()
        dist.all_reduce(host, group=group)
        total = host.to(total.device)
    else:
        dist.all_reduce(total, group=group)
    return torch.sqrt(total)


def clip_by_global_norm(grads, max_norm: float, replicas=None, group=None):
    """(clipped grads, global norm); the grads keep their dtypes.
    ``replicas`` / ``group``: ``global_norm``'s, for a mesh's pieces."""
    gn = global_norm(grads, replicas, group)
    scale = torch.clamp(max_norm / torch.clamp(gn, min=1e-12), max=1.0)
    return tree_map(lambda g: (g.float() * scale).to(g.dtype), grads), gn


def _decay_mask(path: str) -> bool:
    """Decay matmul kernels; skip norms / scales / biases / 1-d params."""
    return not any(s in path for s in _NO_DECAY)


def init_opt_state(params, cfg: OptimizerConfig) -> OptState:
    md = dtype_of(cfg.moment_dtype)
    mu = tree_map(lambda a: torch.zeros(a.shape, dtype=md, device=a.device),
                   params)
    if cfg.name == "adamw":
        nu = tree_map(lambda a: torch.zeros(a.shape, dtype=md,
                                             device=a.device), params)
    else:
        nu = tree_map(lambda a: torch.zeros((0,), dtype=md, device=a.device),
                       params)
    dev = _leaves(params)[0].device
    return OptState(step=torch.zeros((), dtype=torch.int32, device=dev),
                    mu=mu, nu=nu)


@torch.no_grad()
def apply_updates(params, grads, state: OptState, cfg: OptimizerConfig,
                  lr_scale=1.0, *, replicas=None, group=None
                  ) -> Tuple[Dict, OptState, Dict]:
    """One optimizer step, in place on ``params`` and ``state``. Returns
    (params, state, metrics) with metrics ``grad_norm`` and ``lr``.

    On a mesh ``params``, ``grads`` and the moments are this rank's pieces
    (``sharding.opt_specs`` lays the moments out as the parameters): the
    update is elementwise, so each rank updates its pieces alone, and only
    the clipping norm spans the mesh (``global_norm`` with ``replicas``
    and ``group``)."""
    grads, gn = clip_by_global_norm(grads, cfg.grad_clip, replicas, group)
    state.step += 1
    step = state.step.float()
    lr = cfg.lr * torch.as_tensor(lr_scale, dtype=torch.float32,
                                  device=step.device)
    md = dtype_of(cfg.moment_dtype)
    g_of = dict(leaves_with_path(grads))
    mu_of = dict(leaves_with_path(state.mu))
    nu_of = dict(leaves_with_path(state.nu))
    if cfg.name == "adamw":
        b1, b2 = cfg.b1, cfg.b2
        bc1 = 1.0 - b1 ** step
        bc2 = 1.0 - b2 ** step
        for path, p in leaves_with_path(params):
            g32, m, v = g_of[path].float(), mu_of[path], nu_of[path]
            m32 = b1 * m.float() + (1 - b1) * g32
            v32 = b2 * v.float() + (1 - b2) * torch.square(g32)
            delta = (m32 / bc1) / (torch.sqrt(v32 / bc2) + cfg.eps)
            if cfg.weight_decay and _decay_mask(path):
                delta = delta + cfg.weight_decay * p.float()
            p.copy_((p.float() - lr * delta).to(p.dtype))
            m.copy_(m32.to(md))
            v.copy_(v32.to(md))
    elif cfg.name == "sgdm":
        for path, p in leaves_with_path(params):
            g32, m = g_of[path].float(), mu_of[path]
            if cfg.weight_decay and _decay_mask(path):
                g32 = g32 + cfg.weight_decay * p.float()
            m32 = cfg.momentum * m.float() + g32
            p.copy_((p.float() - lr * m32).to(p.dtype))
            m.copy_(m32.to(md))
    else:
        raise ValueError(cfg.name)
    return params, state, {"grad_norm": gn, "lr": lr}


def trainable(params):
    """Mark every leaf of ``params`` as requiring grad (in place); returns
    ``params``."""
    for _, p in leaves_with_path(params):
        p.requires_grad_(True)
    return params


def grads_of(loss: torch.Tensor, params) -> Dict:
    """d loss / d params as a tree like ``params``. A leaf the loss does not
    reach (groups past a depth, an unused exit norm) gets zeros, as
    ``jax.grad`` gives it, so the optimizer treats every leaf alike."""
    gs = iter(torch.autograd.grad(loss, _leaves(params), allow_unused=True))

    def take(p):
        g = next(gs)
        return torch.zeros_like(p) if g is None else g

    return tree_map(take, params)


def opt_state_bytes(params, cfg: OptimizerConfig) -> int:
    md = dtype_of(cfg.moment_dtype)
    n = sum(a.numel() for a in _leaves(params))
    per = torch.finfo(md).bits // 8 * (2 if cfg.name == "adamw" else 1)
    return n * per
