"""Meshes over ``torch.distributed``: the serving mesh, the production and
debug shapes, and a launcher that starts one process per rank.

Port of ``repro.launch.mesh``. A mesh is a ``DeviceMesh`` whose dims are
named ``("data", "model")`` (``("pod", "data", "model")`` for the
multi-pod shapes), as in the JAX package.

The backend follows from the layout, and is printed: NCCL when every rank
of a host has a card of its own; gloo when ranks share one card (NCCL
refuses two ranks on one device; gloo reduces CUDA tensors, which the
collectives of ``parallel.tensor_parallel`` stage through host memory) and
on the CPU. A failure to set up the chosen backend is raised, never
retried on another.
"""
from __future__ import annotations

import datetime
import os
import socket
from typing import Callable, Sequence

import torch
import torch.distributed as dist

from repro_torch.device import resolve_device

MESH_AXES = ("data", "model")
TIMEOUT = datetime.timedelta(seconds=600)


def choose_backend(world: int, device=None) -> str:
    """``nccl`` when each of this host's ranks (``LOCAL_WORLD_SIZE``, else
    ``world``) has a card of its own, else ``gloo``."""
    dev = resolve_device(device)
    if dev.type != "cuda":
        return "gloo"
    local = int(os.environ.get("LOCAL_WORLD_SIZE", world))
    return "nccl" if local <= torch.cuda.device_count() else "gloo"


def _rank_card(backend: str) -> None:
    """NCCL: this rank's own card (its local rank); gloo: card 0."""
    if torch.cuda.is_available():
        local = int(os.environ.get("LOCAL_RANK", dist.get_rank()))
        torch.cuda.set_device(local % torch.cuda.device_count()
                              if backend == "nccl" else 0)


def init_ranks(world: int, rank: int, device=None, init_method=None) -> str:
    """Create the default process group for ``rank`` of ``world`` (unless
    one exists) with the backend ``choose_backend`` picks; returns it.
    ``init_method`` defaults to ``env://`` (``MASTER_ADDR`` /
    ``MASTER_PORT``, as ``torchrun`` sets them); a world of one without
    them rendezvouses in memory."""
    if dist.is_initialized():
        return dist.get_backend()
    backend = choose_backend(world, device)
    kw = {}
    if init_method is None and world == 1 \
            and "MASTER_ADDR" not in os.environ:
        kw["store"] = dist.HashStore()
    else:
        kw["init_method"] = init_method or "env://"
    dist.init_process_group(backend, world_size=world, rank=rank,
                            timeout=TIMEOUT, **kw)
    _rank_card(backend)
    if rank == 0:
        per = ("a card per rank" if backend == "nccl" else
               "ranks share a card" if resolve_device(device).type == "cuda"
               else "CPU")
        print(f"[mesh] backend {backend} ({per}, world {world})", flush=True)
    return backend


def _mesh(shape: Sequence[int], axes: Sequence[str], device=None):
    from torch.distributed.device_mesh import DeviceMesh

    n = 1
    for s in shape:
        n *= s
    if not dist.is_initialized():
        init_ranks(int(os.environ.get("WORLD_SIZE", 1)),
                   int(os.environ.get("RANK", 0)), device)
    world = dist.get_world_size()
    if world < n:
        raise ValueError(f"a {'x'.join(map(str, shape))} mesh over {axes} "
                         f"needs {n} ranks, the world has {world}")
    mesh_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    ranks = torch.arange(n).reshape(tuple(shape))
    return DeviceMesh(mesh_type, ranks, mesh_dim_names=tuple(axes))


def make_serve_mesh(dp: int = 1, tp: int = 1, device=None):
    """Serving mesh: (dp, tp) over ``("data", "model")`` on the first
    ``dp * tp`` ranks. Creates the process group (``init_ranks``, from
    ``RANK`` / ``WORLD_SIZE``; a lone process is a world of one) when none
    exists, and raises when the world is smaller than the mesh. A 1x1 mesh
    is valid, so one engine construction path serves every scale."""
    if dp < 1 or tp < 1:
        raise ValueError(f"mesh degrees must be >= 1, got dp={dp} tp={tp}")
    return _mesh((dp, tp), MESH_AXES, device)


def make_production_mesh(*, multi_pod: bool = False, device=None):
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod",) + MESH_AXES if multi_pod else MESH_AXES
    return _mesh(shape, axes, device)


def make_debug_mesh(*, multi_pod: bool = False, device=None):
    """Small mesh for CI-scale runs (8 ranks)."""
    shape = (2, 2, 2) if multi_pod else (2, 4)
    axes = ("pod",) + MESH_AXES if multi_pod else MESH_AXES
    return _mesh(shape, axes, device)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _rank_main(rank: int, fn, world: int, device, init_method, args):
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world),
                      LOCAL_RANK=str(rank), LOCAL_WORLD_SIZE=str(world))
    init_ranks(world, rank, device, init_method)
    try:
        fn(rank, world, *args)
    finally:
        dist.destroy_process_group()


def spawn_ranks(fn: Callable, world: int, args=(), *, device=None,
                init_method=None) -> None:
    """Run ``fn(rank, world, *args)`` in ``world`` fresh processes
    (``torch.multiprocessing``, spawn), each with the default process group
    created (``init_ranks``; ``init_method`` defaults to a free localhost
    port), and wait for all. A rank that raises ends the others and raises
    here. ``fn`` must be importable by name (a module-level function)."""
    if init_method is None:
        init_method = f"tcp://localhost:{_free_port()}"
    torch.multiprocessing.start_processes(
        _rank_main, args=(fn, world, str(resolve_device(device)),
                          init_method, tuple(args)),
        nprocs=world, join=True, start_method="spawn")
