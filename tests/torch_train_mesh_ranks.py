"""Rank program for ``tests/test_torch_train_mesh.py``: the port's training
on a (data, model) mesh, run as 4 gloo ranks on the CPU.

    PYTHONPATH=src python tests/torch_train_mesh_ranks.py DIR

reads ``DIR/inputs.pt`` (every case's converted parameters and its batch),
starts 4 ranks rendezvousing through a fresh ``DIR/train_mesh.store`` and
has rank 0 write ``DIR/train_mesh.pt``: for each case of ``CASES`` the
loss, the gradients before the optimizer and the parameters after one
step, all gathered to full tensors; for the cases of ``COUNTED`` every
``torch.distributed`` collective rank 0 made in that step, as (op, result
bytes, group size); and a state saved at (2, 2) and restored at (4, 1).
Nothing here imports JAX.
"""
from __future__ import annotations

import contextlib
import os
import sys

import torch

LR = 1e-3
# (name, arch, (dp, tp), microbatches, grad dtype, sequence parallelism)
CASES = (
    ("tinyllama", "tinyllama-1.1b", (2, 2), 1, "float32", False),
    ("tinyllama_kv_replicated_mb2_bf16_sp", "tinyllama-1.1b", (1, 4), 2,
     "bfloat16", True),
    ("mamba2_mb2_sp", "mamba2-370m", (2, 2), 2, "float32", True),
    ("granite_mb2_bf16_sp", "granite-moe-1b-a400m", (2, 2), 2, "bfloat16",
     True),
    ("whisper_sp", "whisper-base", (2, 2), 1, "float32", True),
    ("internvl", "internvl2-2b", (2, 2), 1, "float32", False),
)
# the cases whose collectives rank 0 records (held to the op-trace walker)
COUNTED = ("tinyllama", "mamba2_mb2_sp")
_DIST_CALLS = {"all_reduce": "all-reduce", "all_gather": "all-gather",
               "reduce_scatter_tensor": "reduce-scatter",
               "broadcast": "broadcast", "send": "send", "recv": "recv"}


@contextlib.contextmanager
def _counting(calls):
    """Record each ``torch.distributed`` collective made inside as (op,
    result bytes, group size): an all-gather's result is every part."""
    import torch.distributed as dist

    orig = {n: getattr(dist, n) for n in _DIST_CALLS}

    def wrap(name):
        def call(*args, **kwargs):
            group = kwargs.get("group")
            ts = args[0] if name == "all_gather" else [args[0]]
            calls.append((_DIST_CALLS[name],
                          sum(t.numel() * t.element_size() for t in ts),
                          dist.get_world_size(group)))
            return orig[name](*args, **kwargs)
        return call

    for n in orig:
        setattr(dist, n, wrap(n))
    try:
        yield calls
    finally:
        for n, f in orig.items():
            setattr(dist, n, f)


def _mesh(dp, tp):
    from repro_torch.launch.mesh import _mesh as make

    return make((dp, tp), ("data", "model"))


def _sp(mesh, on):
    from repro_torch.parallel import sharding as SH

    return (SH.activation_sharding(mesh, SH.residual_specs(mesh, "train"))
            if on else contextlib.nullcontext())


def _full_state(params, ocfg):
    from repro_torch.optim import init_opt_state

    return {"params": params, "opt": init_opt_state(params, ocfg)}


def _case(inp, name, arch, shape, mb, gdt, sp):
    from repro_torch.configs import smoke_config
    from repro_torch.launch import steps as ST
    from repro_torch.optim import OptimizerConfig
    from repro_torch.optim.schedule import warmup_cosine
    from repro_torch.parallel import sharding as SH
    from repro_torch.parallel import tensor_parallel as TP

    cfg, ocfg = smoke_config(arch), OptimizerConfig(lr=LR)
    mesh = _mesh(*shape)
    state = ST.shard_train_state(_full_state(inp[arch], ocfg), cfg, mesh)
    gsh = SH.shardings_for(SH.param_specs(inp[arch], cfg, mesh, "train"),
                           mesh)
    step = ST.make_train_step(cfg, ocfg, microbatches=mb, remat="none",
                              grad_shardings=gsh, grad_dtype=gdt,
                              lr_schedule=warmup_cosine(1.0, 2, 10))
    shards = SH.train_state_shardings(cfg, ocfg, mesh)
    batch = inp["batch"][arch]
    calls = []
    with _sp(mesh, sp):
        gloss, grads = step.grads(state["params"], batch)
        with (_counting(calls) if name in COUNTED
              else contextlib.nullcontext()):
            state, m = step(state, batch)
    return {"dist_calls": calls, "loss": float(m["loss"]),
            "grad_norm": float(m["grad_norm"]),
            "lr": float(m["lr"]), "grads_loss": float(gloss),
            "grads": TP.gather_tree(grads, shards["params"], mesh),
            "params": TP.gather_tree(
                {k: v for k, v in state["params"].items()},
                shards["params"], mesh),
            "step": int(state["opt"].step)}


def _restart(inp, d):
    """Two steps at (2, 2), saved gathered; restored at (4, 1) and held
    to the gathered state; one more step at (4, 1) from both."""
    from repro_torch.checkpoint.checkpointing import CheckpointManager
    from repro_torch.configs import smoke_config
    from repro_torch.launch import steps as ST
    from repro_torch.optim import OptimizerConfig
    from repro_torch.parallel import sharding as SH
    from repro_torch.parallel import tensor_parallel as TP

    arch = "mamba2-370m"
    cfg, ocfg = smoke_config(arch), OptimizerConfig(lr=LR)
    a, b = _mesh(2, 2), _mesh(4, 1)
    sa = SH.train_state_shardings(cfg, ocfg, a)
    sb = SH.train_state_shardings(cfg, ocfg, b)
    state = ST.shard_train_state(_full_state(inp[arch], ocfg), cfg, a)
    step = ST.make_train_step(cfg, ocfg, remat="none", grad_shardings=SH.
                              shardings_for(SH.param_specs(
                                  inp[arch], cfg, a, "train"), a))
    for _ in range(2):
        state, _ = step(state, inp["batch"][arch])
    ckpt = CheckpointManager(os.path.join(d, "ckpt"))
    ckpt.save_gathered(2, state, sa, a)
    torch.distributed.barrier()
    full = TP.gather_tree(state, sa, a)
    template = ST.init_train_state(cfg, ocfg, seed=7, device="cpu", mesh=b)
    got, meta = ckpt.restore(template, shardings=sb)
    want = ST.shard_train_state(full, cfg, b)
    got_t, want_t = _tensors(got), _tensors(want)
    same = got_t.keys() == want_t.keys() and all(
        torch.equal(got_t[k], want_t[k]) for k in got_t)
    step_b = ST.make_train_step(cfg, ocfg, remat="none", grad_shardings=SH.
                                shardings_for(SH.param_specs(
                                    inp[arch], cfg, b, "train"), b))
    _, m = step_b(got, inp["batch"][arch])
    _, m_full = step(state, inp["batch"][arch])
    return {"restored_equals_cut": same, "meta_step": meta["step"],
            "piece_shapes": {"/".join(p): tuple(t.shape) for p, t in
                             _with_path(got["params"])},
            "full_shapes": {"/".join(p): tuple(t.shape) for p, t in
                            _with_path(full["params"])},
            "loss_at_4x1": float(m["loss"]),
            "loss_at_2x2": float(m_full["loss"]),
            "opt_step": int(got["opt"].step)}


def _with_path(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _with_path(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def _tensors(state):
    """{path: tensor} of a train state (the key order of a converted JAX
    tree differs from the port's init)."""
    opt = state["opt"]
    out = {("step",): opt.step}
    for name, tree in (("params", state["params"]), ("mu", opt.mu),
                       ("nu", opt.nu)):
        out.update({(name,) + p: t for p, t in _with_path(tree)})
    return out


def train_mesh(rank, world, d):
    torch.set_num_threads(1)
    inp = torch.load(os.path.join(d, "inputs.pt"), weights_only=False)
    out = {name: _case(inp, name, *rest) for name, *rest in CASES}
    out["restart"] = _restart(inp, d)
    if rank == 0:
        torch.save(out, os.path.join(d, "train_mesh.pt"))


if __name__ == "__main__":
    from repro_torch.launch.mesh import spawn_ranks

    d = sys.argv[1]
    store = os.path.join(d, "train_mesh.store")
    if os.path.exists(store):
        os.remove(store)
    spawn_ranks(train_mesh, 4, (d,), device="cpu",
                init_method=f"file://{store}")
