"""Checkpointing: atomic, async-capable, restored onto a template.

Port of ``repro.checkpoint.checkpointing`` with the same layout:
``<dir>/step_<N>/proc_0.npz`` plus ``<dir>/step_<N>/META.json``. Writes go
to ``step_<N>.tmp`` and are renamed only after every array is written, so
a crash mid-save never corrupts the latest checkpoint (restore ignores
``.tmp`` directories); ``keep`` bounds how many finished steps stay on disk.

A state is a tree of dicts, lists, tuples and dataclasses (the optimizer's
``OptState``) over tensors, numpy arrays or Python scalars; a leaf's key is
its ``/``-joined path. numpy has no bfloat16, so a bf16 tensor is stored
as its 16-bit patterns (``view(torch.int16)``) and every leaf's dtype is
recorded in ``META.json``: restore is bit-exact for f32, bf16 and integer
leaves. ``restore`` takes a template of the same structure and places each
leaf on the template leaf's device, with its dtype and ``requires_grad``.

The port writes from one process (``proc_0``); it does not read a JAX
checkpoint.
"""
from __future__ import annotations

import dataclasses
import json
import os
import shutil
import threading
from typing import Any, Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch

_BITS_AS = {torch.bfloat16: torch.int16}


def _children(node) -> Optional[List[Tuple[str, Any]]]:
    """(key, child) pairs of an inner node, or None for a leaf."""
    if isinstance(node, dict):
        return [(str(k), v) for k, v in node.items()]
    if isinstance(node, (list, tuple)):
        return [(str(i), v) for i, v in enumerate(node)]
    if dataclasses.is_dataclass(node) and not isinstance(node, type):
        return [(f.name, getattr(node, f.name))
                for f in dataclasses.fields(node)]
    return None


def leaves_with_path(tree, prefix: str = "") -> Iterator[Tuple[str, Any]]:
    """(``/``-joined key path, leaf) for every leaf, in tree order."""
    kids = _children(tree)
    if kids is None:
        yield prefix, tree
        return
    for k, v in kids:
        yield from leaves_with_path(v, f"{prefix}/{k}" if prefix else k)


def _rebuild(template, leaf_fn, prefix: str = ""):
    """``template``'s structure with every leaf replaced by
    ``leaf_fn(path, leaf)``."""
    kids = _children(template)
    if kids is None:
        return leaf_fn(prefix, template)
    new = {k: _rebuild(v, leaf_fn, f"{prefix}/{k}" if prefix else k)
           for k, v in kids}
    if isinstance(template, dict):
        return {k: new[str(k)] for k in template}
    if isinstance(template, (list, tuple)):
        return type(template)(new[str(i)] for i in range(len(template)))
    return dataclasses.replace(template, **new)


def _to_host(leaf, copy: bool) -> Tuple[np.ndarray, str]:
    """(numpy array, dtype name) of a leaf; ``copy`` makes the array own
    its memory, so later in-place updates of the leaf cannot reach it."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach()
        t = t.to("cpu", copy=True) if copy else t.cpu()
        name = str(t.dtype).replace("torch.", "")
        bits = _BITS_AS.get(t.dtype)
        return (t.view(bits) if bits is not None else t).numpy(), name
    arr = np.array(leaf, copy=True) if copy else np.asarray(leaf)
    return arr, arr.dtype.name


def _from_host(arr: np.ndarray, dtype: str, template):
    """A stored array as a leaf like ``template`` (device, dtype,
    ``requires_grad`` for tensors)."""
    if isinstance(template, torch.Tensor):
        # np.load gives a fresh array; copy only a non-contiguous one
        t = torch.from_numpy(arr if arr.flags.c_contiguous
                             else np.array(arr, order="C"))
        stored = getattr(torch, dtype)
        if stored in _BITS_AS:
            t = t.view(stored)
        t = t.to(device=template.device, dtype=template.dtype, copy=True)
        return t.requires_grad_(template.requires_grad)
    if isinstance(template, np.generic):
        return np.asarray(arr, dtype=template.dtype)[()]
    if isinstance(template, np.ndarray):
        return np.asarray(arr, dtype=template.dtype).copy()
    return type(template)(arr[()])


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3, async_save: bool = False):
        self.directory = directory
        self.keep = keep
        self.async_save = async_save
        self._pending: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None
        os.makedirs(directory, exist_ok=True)

    # -- save ---------------------------------------------------------------

    def save(self, step: int, tree,
             extra_meta: Optional[Dict[str, Any]] = None) -> str:
        """Write ``tree`` as step ``step``. With ``async_save`` every leaf
        is copied to host memory before the writer thread starts (the
        optimizer updates its tensors in place; on the CPU a tensor's
        ``numpy()`` is a view), then the call returns."""
        self.wait()
        flat = {k: _to_host(v, copy=self.async_save)
                for k, v in leaves_with_path(tree)}
        if self.async_save:
            self._pending = threading.Thread(
                target=self._save_guarded, args=(step, flat, extra_meta),
                daemon=True)
            self._pending.start()
            return os.path.join(self.directory, f"step_{step:08d}")
        return self._save_sync(step, flat, extra_meta)

    def _save_guarded(self, step, flat, extra_meta) -> None:
        try:
            self._save_sync(step, flat, extra_meta)
        except BaseException as e:  # surfaced by wait()
            self._error = e

    def _save_sync(self, step: int, flat, extra_meta=None) -> str:
        final = os.path.join(self.directory, f"step_{step:08d}")
        tmp = final + ".tmp"
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp, exist_ok=True)
        np.savez(os.path.join(tmp, "proc_0.npz"),
                 **{k: arr for k, (arr, _) in flat.items()})
        meta = {"step": step, "n_arrays": len(flat),
                "dtypes": {k: dt for k, (_, dt) in flat.items()},
                **(extra_meta or {})}
        with open(os.path.join(tmp, "META.json"), "w") as f:
            json.dump(meta, f)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)
        self._gc()
        return final

    def wait(self) -> None:
        """Join a pending async save; re-raise what it raised."""
        if self._pending is not None:
            self._pending.join()
            self._pending = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def _gc(self) -> None:
        steps = self.all_steps()
        for s in steps[: max(0, len(steps) - self.keep)]:
            shutil.rmtree(os.path.join(self.directory, f"step_{s:08d}"),
                          ignore_errors=True)

    # -- restore ------------------------------------------------------------

    def all_steps(self) -> List[int]:
        out = []
        for name in os.listdir(self.directory):
            if name.startswith("step_") and not name.endswith(".tmp"):
                if os.path.exists(os.path.join(self.directory, name,
                                               "META.json")):
                    out.append(int(name.split("_")[1]))
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, template, step: Optional[int] = None
                ) -> Tuple[Any, Dict[str, Any]]:
        """(tree shaped like ``template``, META) of ``step`` (default: the
        latest). ``KeyError`` when the checkpoint lacks a template key,
        ``ValueError`` when a shape differs."""
        self.wait()
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self.directory}")
        d = os.path.join(self.directory, f"step_{step:08d}")
        with open(os.path.join(d, "META.json")) as f:
            meta = json.load(f)
        flat: Dict[str, np.ndarray] = {}
        for name in sorted(os.listdir(d)):
            if name.endswith(".npz"):
                with np.load(os.path.join(d, name)) as z:
                    flat.update({k: z[k] for k in z.files})
        dtypes = meta.get("dtypes", {})

        def leaf(key, tmpl):
            if key not in flat:
                raise KeyError(f"checkpoint missing {key}")
            arr = flat[key]
            shape = tuple(getattr(tmpl, "shape", np.shape(tmpl)))
            if tuple(arr.shape) != shape:
                raise ValueError(f"{key}: ckpt shape {arr.shape} != "
                                 f"template {shape}")
            return _from_host(arr, dtypes.get(key, arr.dtype.name), tmpl)

        return _rebuild(template, leaf), meta
