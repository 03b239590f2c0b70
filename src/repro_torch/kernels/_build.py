"""Build the port's CUDA kernels at first use, from the sources in ``csrc/``.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for ``sm_90a`` into a shared
library with a plain C interface (no PyTorch headers, so a build takes
seconds) and loaded with ``ctypes``. Libraries land in ``build/kernels/`` at
the repository root (``REPRO_TORCH_BUILD_DIR`` overrides it), named by a
hash of their sources and flags so an edited source is rebuilt. ``nvcc``'s
``-Xptxas -v`` report (registers, shared memory, spills) is kept beside each
library as ``<name>-<hash>.log``.

Nothing here runs at import time: the CPU tests import every module, and a
host without ``nvcc`` only fails when a kernel is actually launched.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Iterable, List

CSRC = Path(__file__).resolve().parent.parent / "csrc"
KERNELS = ("morph_matmul", "fused_decode", "fused_verify", "ssd_scan",
           "ssd_scan_bwd", "flash_attention", "flash_decode")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LIBS: Dict[str, ctypes.CDLL] = {}
_LOCK = threading.Lock()
build_seconds: Dict[str, float] = {}


def build_dir() -> Path:
    env = os.environ.get("REPRO_TORCH_BUILD_DIR")
    if env:
        return Path(env)
    return CSRC.parents[2] / "build" / "kernels"


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found (looked on PATH and in $CUDA_HOME/bin); "
                       "the CUDA kernels are built on the machine with the card")


def _target(name: str) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(CSRC.glob("*.cu*")):  # the .cu and every shared header
        if src.suffix == ".cuh" or src.stem == name:
            h.update(src.name.encode())
            h.update(src.read_bytes())
    return build_dir() / f"lib{name}-{h.hexdigest()[:12]}.so"


def _start(name: str):
    """Start one nvcc for ``name``; returns (process, tmp path, target) or
    None when the library is already built."""
    out = _target(name)
    if out.exists():
        return None
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp),
           str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, tmp, out


def _finish(name: str, job, t0: float) -> None:
    proc, tmp, out = job
    log, _ = proc.communicate()
    out.with_suffix(".log").write_text(log)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for csrc/{name}.cu "
                           f"(exit {proc.returncode}):\n{log}")
    os.replace(tmp, out)
    build_seconds[name] = time.perf_counter() - t0


def build_all(names: Iterable[str] = KERNELS) -> Dict[str, float]:
    """Compile every kernel library that is not built yet, one ``nvcc`` per
    source, all started together. Returns seconds per library built."""
    with _LOCK:
        t0 = time.perf_counter()
        jobs = [(n, _start(n)) for n in names]
        for n, job in jobs:
            if job is not None:
                _finish(n, job, t0)
    return dict(build_seconds)


def ptxas_report(name: str) -> List[str]:
    """One line per kernel of a built library's ``ptxas`` log: its (mangled)
    name, registers and spills."""
    log = _target(name).with_suffix(".log")
    if not log.exists():
        return []
    out, fn, spill = [], "?", ""
    for ln in log.read_text().splitlines():
        if "Function properties for" in ln:
            fn = ln.split("Function properties for", 1)[1].strip()
        elif "spill" in ln:
            spill = ln.strip()
        elif "registers" in ln:
            regs = ln.split(":", 1)[-1].strip()
            out.append(f"{fn}: {regs}; {spill}")
    return out


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, building it if needed."""
    lib = _LIBS.get(name)
    if lib is None:
        build_all([name])
        with _LOCK:
            lib = _LIBS.get(name)
            if lib is None:
                lib = ctypes.CDLL(str(_target(name)))
                _LIBS[name] = lib
    return lib
