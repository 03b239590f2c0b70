"""The port's training on a (data, model) mesh against the JAX package, on
the CPU.

* The training half of ``parallel.sharding`` (``batch_specs``,
  ``cache_specs`` dense and paged, ``opt_specs`` for AdamW and sgdm,
  ``residual_specs``, ``shardings_for``) leaf for leaf against
  ``repro.parallel.sharding`` on ``AbstractMesh((2, 4))`` and the 3-axis
  pod mesh, for every family's smoke config.
* ``set_bf16_grad_matmul``'s dx / dW against the reference's custom VJP:
  bit-identical dtypes, values within one bf16 step (2^-8 relative).
* One spawned run of 4 gloo ranks (``tests/torch_train_mesh_ranks.py``,
  ~25 s, once per test run behind a file lock, as
  ``tests/test_torch_mesh_serving.py``'s) drives ``make_train_step(
  grad_shardings=shardings_for(...))`` at (2, 2) (and at (1, 4), where
  tinyllama's 2 KV heads are replicated) on tinyllama, mamba2, granite,
  whisper (frames through the encoder, cross-attention) and internvl
  (patches) smoke configs, six cases that cover microbatches 1 and 2,
  ``grad_dtype`` f32 and bf16 and sequence parallelism on and off (the
  MoE router under it too), each held to JAX's single-device
  ``make_train_step`` on the same converted params and batch
  (``convert.py``). Tolerances: losses rtol 1e-5; f32 gradients before
  the optimizer |port - JAX| <= 1e-4 max |g| of each leaf; bf16 gradients
  within 4 bf16 steps of the f32 gradient's scale (2^-6 max |g|: the port
  casts each rank's partial sum to bf16 and sums those in bf16, JAX casts
  the whole sum once); parameters after the step within 1e-5, plus 2 lr
  where the JAX gradient lies inside that leaf's gradient tolerance
  (AdamW's first step moves a parameter by about lr sign(g), and a
  gradient inside the noise may take either sign).
* A state saved at (2, 2) (gathered, rank 0 writes) restored at (4, 1).
* The dry-run's per-rank argument bytes against the reference's specs
  applied to ``jax.eval_shape`` trees (tinyllama and mamba2 x train_4k /
  decode_32k on the (2, 4) debug mesh), the one documented departure
  (``ROADMAP.md`` C: the SSM per-head vectors ``w_dt``, ``A_log``, ``D``,
  ``dt_bias`` held as the rank's slice over ``model``, which the
  reference replicates) counted leaf by leaf; ``model_flops``; the skip
  reasons; the CLI writing its JSON.
"""
import functools
import json
import math
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh

from repro.configs import SHAPE_BY_NAME as JSHAPES
from repro.configs import get_config as jax_get_config
from repro.configs import smoke_config as jax_smoke_config
from repro.launch import steps as JST
from repro.models import layers as JL
from repro.models import model as JM
from repro.optim import optimizer as JO
from repro.optim import schedule as JSCH
from repro.parallel import sharding as JSH
from repro_torch.configs import list_archs, smoke_config
from repro_torch.convert import params_from_jax, to_numpy
from repro_torch.data import pipeline as TD
from repro_torch.launch import dryrun as DRY
from repro_torch.models import layers as TL
from repro_torch.models.model import init_params
from repro_torch.optim import optimizer as TO
from repro_torch.parallel import sharding as SH

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "tests"))
import torch_train_mesh_ranks as R  # noqa: E402
from torch_threads import one_thread  # noqa: E402,F401  (autouse)

MESHES = {"2x4": ({"data": 2, "model": 4},
                  AbstractMesh((2, 4), ("data", "model"))),
          "2x2x2": ({"pod": 2, "data": 2, "model": 2},
                    AbstractMesh((2, 2, 2), ("pod", "data", "model")))}
ARCHS = ("tinyllama-1.1b", "mamba2-370m", "granite-moe-1b-a400m",
         "whisper-base", "internvl2-2b")
GRAD_RTOL = 1e-4
BF16_STEPS = 4 * 2.0 ** -8


def _tup(tree):
    return jax.tree_util.tree_map(
        tuple, tree, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = v
    return out


# ---------------------------------------------------------------------------
# the training half of sharding.py
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", list_archs())
def test_training_specs_match_jax(arch):
    cfg, jcfg = smoke_config(arch), jax_smoke_config(arch)
    params = init_params(cfg, device="meta")
    jshapes = jax.eval_shape(lambda: JM.init_params(jax.random.PRNGKey(0),
                                                    jcfg))
    B, S = 4, 32
    batch = {"tokens": torch.empty(B, S, dtype=torch.int32, device="meta"),
             "targets": torch.empty(B, S, dtype=torch.int32, device="meta")}
    jbatch = {k: jax.ShapeDtypeStruct((B, S), jnp.int32) for k in batch}
    # the rules read leaf shapes: hold them on the reference's cache shapes
    jcache = jax.eval_shape(lambda: JM.init_decode_cache(jcfg, B, 16))
    cache = jax.tree_util.tree_map(
        lambda a: torch.empty(a.shape, device="meta"), jcache)
    for name, (mesh, jmesh) in MESHES.items():
        pspecs = SH.param_specs(params, cfg, mesh, "train")
        jpspecs = JSH.param_specs(jshapes, jcfg, jmesh, "train")
        for policy in ("train", "serve_tp", "serve_2d"):
            assert SH.batch_specs(batch, mesh, policy) == _tup(
                JSH.batch_specs(jbatch, jmesh, policy)), (name, policy)
            assert SH.residual_specs(mesh, policy) == _tup(
                JSH.residual_specs(jmesh, policy)), (name, policy)
            for paged in (False, True):
                if paged and not cfg.n_heads:
                    continue
                want = _flat(_tup(JSH.cache_specs(jcache["stack"], jcfg,
                                                  jmesh, policy, paged=paged)))
                got = _flat(SH.cache_specs(cache["stack"], cfg, mesh, policy,
                                           paged=paged))
                assert got == want, (name, policy, paged)
        for opt_name in ("adamw", "sgdm"):
            jo = JO.OptimizerConfig(name=opt_name)
            jopt = jax.eval_shape(lambda: JO.init_opt_state(jshapes, jo))
            opt = TO.init_opt_state(params, TO.OptimizerConfig(name=opt_name))
            got = SH.opt_specs(opt, pspecs)
            want = JSH.opt_specs(jopt, jpspecs)
            assert got.step == tuple(want.step)
            assert _flat(got.mu) == _flat(_tup(want.mu))
            assert _flat(got.nu) == _flat(_tup(want.nu)), opt_name
        shard = SH.shardings_for(pspecs, mesh)
        want = _flat(jax.tree_util.tree_map(
            lambda s: tuple(s.spec), JSH.shardings_for(jpspecs, jmesh)))
        got = {"/".join(p): s.spec for p, s in SH.sharding_leaves(shard)}
        assert got == want and all(s.mesh is mesh for _, s in
                                   SH.sharding_leaves(shard))


def test_bf16_grad_matmul_matches_the_reference_vjp():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 5, 48)).astype(np.float32)
    w = rng.standard_normal((48, 24)).astype(np.float32) / 7
    dy = rng.standard_normal((2, 5, 24)).astype(np.float32)

    JL.set_bf16_grad_matmul(True)
    try:
        def jf(x, w):
            return JL.matmul(x, w, jnp.bfloat16)
        jy, vjp = jax.vjp(jf, jnp.asarray(x, jnp.bfloat16),
                          jnp.asarray(w, jnp.bfloat16))
        jdx, jdw = vjp(jnp.asarray(dy, jnp.bfloat16))
    finally:
        JL.set_bf16_grad_matmul(False)
    TL.set_bf16_grad_matmul(True)
    try:
        tx = torch.tensor(x).bfloat16().requires_grad_(True)
        tw = torch.tensor(w).bfloat16().requires_grad_(True)
        ty = TL.matmul(tx, tw, torch.bfloat16)
        tdx, tdw = torch.autograd.grad(ty, (tx, tw),
                                       torch.tensor(dy).bfloat16())
    finally:
        TL.set_bf16_grad_matmul(False)
    assert ty.dtype == tdx.dtype == tdw.dtype == torch.bfloat16
    for got, want in ((ty, jy), (tdx, jdx), (tdw, jdw)):
        want = np.asarray(want, np.float32)
        np.testing.assert_allclose(got.detach().float().numpy(), want,
                                   atol=2.0 ** -8 * np.abs(want).max(),
                                   rtol=2.0 ** -8)
    # off: autograd's own matmul backward (dW in the activations' dtype)
    tx32 = torch.tensor(x).requires_grad_(True)
    tw32 = torch.tensor(w).requires_grad_(True)
    g = torch.autograd.grad(TL.matmul(tx32, tw32, torch.float32).sum(),
                            tw32)[0]
    assert g.dtype == torch.float32


# ---------------------------------------------------------------------------
# the mesh step against JAX's single-device step (one spawned run)
# ---------------------------------------------------------------------------


def _batch(arch):
    return TD.make_batch(smoke_config(arch), TD.DataConfig(
        seed=3, global_batch=8, seq_len=32), 0)


def _jax_params(arch):
    return jax.device_get(jax.jit(JM.init_params, static_argnums=1)(
        jax.random.PRNGKey(1), jax_smoke_config(arch)))


@pytest.fixture(scope="module")
def ranks_dir(tmp_path_factory):
    from filelock import FileLock

    if os.environ.get("PYTEST_XDIST_WORKER"):
        d = tmp_path_factory.getbasetemp().parent / "train_mesh"
        d.mkdir(exist_ok=True)
    else:
        d = tmp_path_factory.mktemp("train_mesh")
    with FileLock(str(d / "run.lock")):
        if not (d / "train_mesh.pt").exists():
            inp = {a: params_from_jax(_jax_params(a), device="cpu")
                   for a in ARCHS}
            inp["batch"] = {a: _batch(a) for a in ARCHS}
            torch.save(inp, d / "inputs.pt")
            env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"),
                       OMP_NUM_THREADS="1")
            out = subprocess.run(
                [sys.executable, os.path.join(REPO, "tests",
                                              "torch_train_mesh_ranks.py"),
                 str(d)], capture_output=True, text=True, env=env,
                timeout=300)
            assert out.returncode == 0, (out.stdout[-3000:],
                                         out.stderr[-3000:])
    return d


@pytest.fixture(scope="module")
def mesh_run(ranks_dir):
    return torch.load(ranks_dir / "train_mesh.pt", weights_only=False)


@functools.lru_cache(maxsize=None)
def _jax_grads(arch):
    cfg = jax_smoke_config(arch)
    b = {k: jnp.asarray(v) for k, v in _batch(arch).items()}
    loss, g = jax.jit(jax.value_and_grad(
        lambda q: JM.loss_fn(q, b, cfg)[0]))(_jax_params(arch))
    return float(loss), _flat(jax.device_get(g))


def _jax_step(arch, mb, gdt):
    cfg = jax_smoke_config(arch)
    jo = JO.OptimizerConfig(lr=R.LR)
    p = _jax_params(arch)
    b = {k: jnp.asarray(v) for k, v in _batch(arch).items()}
    loss, g = _jax_grads(arch)
    step = jax.jit(JST.make_train_step(cfg, jo, microbatches=mb,
                                       remat="none", grad_dtype=gdt,
                                       lr_schedule=JSCH.warmup_cosine(
                                           1.0, 2, 10)))
    state, m = step({"params": p, "opt": JO.init_opt_state(p, jo)}, b)
    return loss, g, _flat(jax.device_get(state["params"])), m


@pytest.mark.parametrize("case", R.CASES, ids=[c[0] for c in R.CASES])
def test_mesh_step_matches_jax_single_device_step(mesh_run, case):
    name, arch, shape, mb, gdt, sp = case
    got = mesh_run[name]
    jloss, jgrads, jparams, jm = _jax_step(arch, mb, gdt)
    np.testing.assert_allclose(got["grads_loss"], jloss, rtol=1e-5)
    np.testing.assert_allclose(got["loss"], float(jm["loss"]), rtol=1e-5)
    np.testing.assert_allclose(got["lr"], float(jm["lr"]), rtol=1e-6)
    np.testing.assert_allclose(got["grad_norm"], float(jm["grad_norm"]),
                               rtol=1e-4 if gdt == "float32" else 1e-2)
    assert got["step"] == 1
    grads = _flat(to_numpy(got["grads"]))
    assert set(grads) == set(jgrads)
    for path, g in grads.items():
        w = np.asarray(jgrads[path], np.float32)
        scale = max(float(np.abs(w).max()), 1e-30)
        tol = (GRAD_RTOL if gdt == "float32" else BF16_STEPS) * scale
        np.testing.assert_allclose(g, w, atol=tol, rtol=0,
                                   err_msg=f"{name} grad {path}")
    lr_step = R.LR * float(JSCH.warmup_cosine(1.0, 2, 10)(0))
    params = _flat(to_numpy(got["params"]))
    for path, p in params.items():
        gj = np.abs(np.asarray(jgrads[path], np.float32))
        rtol = GRAD_RTOL if gdt == "float32" else BF16_STEPS
        noise = gj <= rtol * gj.max()
        tol = 1e-5 + np.where(noise, 2 * lr_step, 0.0)
        err = np.abs(p - np.asarray(jparams[path], np.float32))
        assert (err <= tol).all(), (name, path, float(err.max()))


def test_state_saved_at_2x2_restores_at_4x1(mesh_run):
    r = mesh_run["restart"]
    assert r["restored_equals_cut"] and r["meta_step"] == 2
    assert r["opt_step"] == 3  # the restored state took one more step
    # at (4, 1) every data-split dim holds a quarter of the full leaf
    cfg = smoke_config("mamba2-370m")
    specs = SH.param_specs(init_params(cfg, device="meta"), cfg,
                           {"data": 4, "model": 1}, "train")
    for path, shape in r["full_shapes"].items():
        spec = _flat(specs)[path]
        want = tuple(n // 4 if ax == "data" else n
                     for n, ax in zip(shape, spec))
        assert r["piece_shapes"][path] == want, path
    np.testing.assert_allclose(r["loss_at_4x1"], r["loss_at_2x2"], rtol=1e-5)


# ---------------------------------------------------------------------------
# the dry-run
# ---------------------------------------------------------------------------

_PER_HEAD = ("w_dt", "A_log", "D", "dt_bias")


def _spec_bytes(shapes, specs, sizes, per_head_tp=1):
    """Per-rank bytes of JAX ShapeDtypeStruct leaves under their specs;
    the SSM per-head vectors divided by ``per_head_tp`` (the port's
    documented departure)."""
    flat_s = _flat(jax.tree_util.tree_map(
        lambda s: s, shapes))
    flat_p = _flat(_tup(specs))
    total = 0
    for path, leaf in flat_s.items():
        n = math.prod(leaf.shape)
        for dim, ax in enumerate(flat_p[path]):
            axes = () if ax is None else (ax,) if isinstance(ax, str) else ax
            k = math.prod(sizes[a] for a in axes)
            if k > 1 and leaf.shape[dim] % k == 0:
                n //= k
        if path.split("/")[-1] in _PER_HEAD and "ssm" in path:
            n //= per_head_tp
        total += n * np.dtype(leaf.dtype).itemsize
    return total


@pytest.mark.parametrize("arch", ["tinyllama-1.1b", "mamba2-370m"])
@pytest.mark.parametrize("shape", ["train_4k", "decode_32k"])
def test_dryrun_argument_bytes_match_the_reference_specs(arch, shape):
    sizes, jmesh = MESHES["2x4"]
    knobs = DRY.Knobs()
    rec = DRY.run_cell(arch, shape, False, knobs, debug_mesh=True)
    assert rec["status"] == "ok", rec.get("error")
    cell = JSHAPES[shape]
    jcfg = jax_get_config(arch).scaled(
        param_dtype=knobs.param_dtype, dtype="bfloat16", attn_impl="chunked",
        attn_chunk=knobs.attn_chunk, kv_quant=knobs.kv_quant,
        capacity_factor=knobs.capacity_factor)
    params = jax.eval_shape(lambda: JM.init_params(jax.random.PRNGKey(0),
                                                   jcfg))
    tp = sizes["model"] if jcfg.ssm_state else 1  # the per-head departure
    mem = rec["memory"]
    if cell.kind == "train":
        pspecs = JSH.param_specs(params, jcfg, jmesh, "train")
        jo = JO.OptimizerConfig(moment_dtype=rec["resolved_knobs"][
            "moment_dtype"])
        opt = jax.eval_shape(lambda: JO.init_opt_state(params, jo))
        ospecs = JSH.opt_specs(opt, pspecs)
        batch = {k: jax.ShapeDtypeStruct((cell.global_batch, cell.seq_len),
                                         jnp.int32)
                 for k in ("tokens", "targets")}
        assert mem["params_bytes"] == _spec_bytes(params, pspecs, sizes, tp)
        want_opt = (_spec_bytes(opt.mu, ospecs.mu, sizes, tp)
                    + _spec_bytes(opt.nu, ospecs.nu, sizes, tp) + 4)
        assert mem["opt_bytes"] == want_opt
        assert mem["batch_bytes"] == _spec_bytes(
            batch, JSH.batch_specs(batch, jmesh, "train"), sizes)
    else:
        policy = rec["policy"]
        assert policy == JSH.serve_policy(jcfg, tp=sizes["model"])
        pspecs = JSH.param_specs(params, jcfg, jmesh, policy)
        cache = jax.eval_shape(lambda: JM.init_decode_cache(
            jcfg, cell.global_batch, cell.seq_len))
        cspecs = {"pos": jax.sharding.PartitionSpec(),
                  "stack": JSH.cache_specs(cache["stack"], jcfg, jmesh,
                                           policy)}
        assert mem["params_bytes"] == _spec_bytes(params, pspecs, sizes, tp)
        assert mem["cache_bytes"] == _spec_bytes(cache, cspecs, sizes)
        assert mem["tokens_bytes"] == cell.global_batch // sizes["data"] * 4
    assert mem["argument_bytes"] == sum(
        v for k, v in mem.items() if k.endswith("_bytes")
        and k != "argument_bytes")
    assert mem["fits_80gb"] == (mem["argument_bytes"] <= 80e9)


def test_dryrun_model_flops_and_skips():
    knobs = DRY.Knobs()
    rec = DRY.run_cell("tinyllama-1.1b", "train_4k", False, knobs,
                       debug_mesh=True)
    cfg = DRY.resolve_cfg("tinyllama-1.1b", knobs)
    cell = JSHAPES["train_4k"]
    flops = 6.0 * cfg.n_active_params() * cell.global_batch * cell.seq_len
    assert rec["roofline"]["model_flops"] == flops
    assert rec["roofline"]["model_flops"] == 6.0 * jax_get_config(
        "tinyllama-1.1b").n_active_params() * cell.global_batch * cell.seq_len
    np.testing.assert_allclose(rec["roofline"]["ideal_s"],
                               flops / (8 * 989e12), rtol=1e-12)
    assert "cost" not in rec and "collectives" not in rec
    from repro.configs import cell_applicable as jax_applicable
    skip = DRY.run_cell("tinyllama-1.1b", "long_500k", False, knobs,
                        debug_mesh=True)
    ok, why = jax_applicable(jax_get_config("tinyllama-1.1b"),
                             JSHAPES["long_500k"])
    assert not ok and skip["status"] == "skip" and skip["reason"] == why


def test_dryrun_cli_on_the_debug_mesh_writes_its_json(tmp_path):
    out = tmp_path / "dry.json"
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    run = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
         "tinyllama-1.1b,mamba2-370m", "--shape", "train_4k,decode_32k",
         "--mesh", "single", "--debug-mesh", "--out", str(out)],
        capture_output=True, text=True, env=env, timeout=300)
    assert run.returncode == 0, run.stderr[-2000:]
    assert "done: ok=4 skip=0 err=0" in run.stdout
    res = json.loads(out.read_text())
    assert len(res) == 4
    for key, rec in res.items():
        arch, shape, mesh, kkey = key.split("|")
        assert key == DRY.cell_key(arch, shape, "2x4", DRY.Knobs())
        assert rec["status"] == "ok" and rec["roofline"]["ideal_s"] > 0
