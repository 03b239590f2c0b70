"""Bring the JAX package's parameters and caches over to the port.

``jax.device_get`` turns a JAX pytree into nested dicts of numpy arrays; the
functions here turn those into the port's tensors with the same keys, so
both packages can compute on the same weights and the same cache. This
module never imports JAX: it takes numpy (or anything ``np.asarray``
accepts, bfloat16 arrays from ``ml_dtypes`` included).
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from repro_torch.device import resolve_device


def _to_tensor(a: Any, device: torch.device) -> torch.Tensor:
    # always a private copy: arrays from jax.device_get may share (read-only)
    # memory with JAX's own buffers, and the port writes caches in place
    a = np.array(a, copy=True)
    if a.dtype.name == "bfloat16":  # ml_dtypes: go through f32, exact
        return torch.from_numpy(a.astype(np.float32)).to(
            device=device, dtype=torch.bfloat16)
    return torch.from_numpy(a).to(device)


def _convert(tree: Any, device: torch.device) -> Any:
    if isinstance(tree, dict):
        return {k: _convert(v, device) for k, v in tree.items()}
    return _to_tensor(tree, device)


def params_from_jax(tree: Dict, device=None) -> Dict:
    """Nested dict of numpy arrays (JAX params) -> same tree of tensors."""
    return _convert(tree, resolve_device(device))


def cache_from_jax(tree: Dict, device=None) -> Dict:
    """Nested dict of numpy arrays (a JAX decode cache) -> same tree of
    tensors: ``{"pos": (B,), "stack": {"pos0": {"k": (G,B,S,KV,hd), ...}}}``.
    Position counters become int32 tensors, as the port's caches hold them."""
    out = _convert(tree, resolve_device(device))
    if "pos" in out:
        out["pos"] = out["pos"].to(torch.int32)
    return out


def to_numpy(tree: Any) -> Any:
    """Tensors -> numpy (f32 for bfloat16), for comparing with JAX output."""
    if isinstance(tree, dict):
        return {k: to_numpy(v) for k, v in tree.items()}
    t = tree.detach().cpu()
    if t.dtype == torch.bfloat16:
        t = t.float()
    return t.numpy()
