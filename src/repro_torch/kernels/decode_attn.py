"""The launch plan of the decode-attention core (``csrc/decode_attn.cuh``).

``flash_decode`` and the attention launches of ``fused_decode_step`` and
``fused_verify`` run on one CUDA core: per unit (a KV row, or a (slot, KV
head) pair) the cache rows split into ranges of whole 64-row chunks, and the
splits of a unit run as one thread block cluster that merges its partials
in shared memory. This module sizes the split: the most splits (at most 16,
the largest cluster the H100 takes) for which every unit's cluster fits on
the card at once, as the kernel's own occupancy query reports, so that a
launch is one wave.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels import morph_matmul as _mm

CHUNK = 64        # kChunk: cache rows per ring slot
MAX_SPLITS = 16   # kMaxSplits: blocks of one cluster
MAX_HEADS = 16    # kMaxHeads: query rows of one m16 tile (and of a block
                  # of flash_decode and fused_decode)
MAX_HD = 128      # kMaxHD
ROUTES = ("fma", "tc")  # Route: the route code a launch reports
_I = ctypes.c_int
_P = ctypes.c_void_p


def split_plan(clusters: int, S: int,
               caps: Tuple[int, ...]) -> Tuple[int, int]:
    """(splits, rows per split) of an S-row cache for ``clusters`` units,
    given ``caps[s - 1]``, the clusters of s blocks that fit on the card at
    once: the most splits whose clusters all fit (one split when none
    does), whole 64-row chunks, no split empty of cache rows."""
    chunks = max(1, -(-S // CHUNK))
    s = 1
    for cand in range(min(MAX_SPLITS, len(caps), chunks), 1, -1):
        if caps[cand - 1] >= clusters:
            s = cand
            break
    per = -(-chunks // s)
    return -(-chunks // per), per * CHUNK


def plan(lib: str, fn_name: str, code: Tuple[int, ...], units: int,
         group: int, S: int, device,
         rows_per_block: int = MAX_HEADS) -> Tuple[int, int]:
    """(splits, rows per split) of a launch over ``units`` units of
    ``group`` query rows each (one cluster per unit and group of
    ``rows_per_block`` rows) of an S-row cache, for the kernel that
    ``lib``'s ``fn_name`` occupancy query reports on for ``code``."""
    caps = cluster_caps(lib, fn_name, code, _mm._device_index(device))
    return split_plan(units * -(-group // rows_per_block), S, caps)


@functools.lru_cache(maxsize=None)
def cluster_caps(lib: str, fn_name: str, code: Tuple[int, ...],
                 device_index: int) -> Tuple[int, ...]:
    """Clusters of s = 1 .. 16 blocks of the kernel that ``code`` (dtype
    codes and hd, as the library's ``*_max_clusters`` takes them) selects,
    that fit on the card at once. Cached per kernel and device."""
    fn = getattr(_build.load(lib), fn_name)
    if fn.argtypes is None:
        fn.argtypes = [_I] * (len(code) + 1) + [_P]
        fn.restype = _I
    caps = []
    with torch.cuda.device(device_index):
        for s in range(1, MAX_SPLITS + 1):
            n = ctypes.c_int(0)
            err = fn(*code, s, ctypes.byref(n))
            if err != 0:
                raise RuntimeError(f"{lib} occupancy query failed: CUDA "
                                   f"error {err}")
            caps.append(n.value)
    return tuple(caps)
