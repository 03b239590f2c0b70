"""Bring the JAX package's parameters and caches over to the port.

``jax.device_get`` turns a JAX pytree into nested dicts of numpy arrays; the
functions here turn those into the port's tensors with the same keys, so
both packages can compute on the same weights, the same cache and the same
optimizer state. This module never imports JAX: it takes numpy (or
anything ``np.asarray`` accepts, bfloat16 arrays from ``ml_dtypes``
included).
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


_CROSS_KEYS = ("cross_k", "cross_v")


def cache_from_jax(tree: Dict, device=None) -> Dict:
    """Nested dict of numpy arrays (a JAX decode cache) -> same tree of
    tensors: ``{"pos": (B,), "stack": {"pos0": {"k": (G,B,S,KV,hd), ...}}}``
    (SSM layers: ``conv_x``, ``conv_bc``, ``state``).
    Position counters become int32 tensors, as the port's caches hold them.

    One layout differs: an encoder-decoder cache's ``cross_k`` /
    ``cross_v`` are (G, B, enc_seq, KV, hd) in JAX and (G, B, KV, enc_seq,
    hd) in the port (the ``flash_decode`` kernel's layout as a view), so
    these two leaves have axes -3 and -2 swapped here, into contiguous
    tensors; a test that holds a port cache to JAX's swaps them back."""
    out = _convert(tree, resolve_device(device))
    if "pos" in out:
        out["pos"] = out["pos"].to(torch.int32)
    for layer in out.get("stack", {}).values():
        for k in _CROSS_KEYS:
            if k in layer:
                layer[k] = layer[k].transpose(-3, -2).contiguous()
    return out


def opt_state_from_jax(state: Any, device=None):
    """A JAX ``OptState`` (or its ``(step, mu, nu)`` tuple) fetched with
    ``jax.device_get`` -> the port's ``optim.OptState``: moments as tensors
    with the param tree's keys, the step as a 0-d int32 tensor."""
    from repro_torch.optim.optimizer import OptState

    dev = resolve_device(device)
    step, mu, nu = state
    return OptState(step=torch.tensor(int(np.asarray(step)), dtype=torch.int32,
                                      device=dev),
                    mu=_convert(mu, dev), nu=_convert(nu, dev))


def to_numpy(tree: Any) -> Any:
    """Tensors -> numpy (f32 for bfloat16), for comparing with JAX output."""
    if isinstance(tree, dict):
        return {k: to_numpy(v) for k, v in tree.items()}
    t = tree.detach().cpu()
    if t.dtype == torch.bfloat16:
        t = t.float()
    return t.numpy()
