"""The rest of the port's mesh serving on the CPU: the MoE, encoder-decoder
and frontend families under ``serve_tp``, the autoscaler over a mesh and
``serve_2d``, as gloo ranks (``tests/torch_mesh_ranks.py``) held to the
port's single-device engine and to the JAX package.

One spawned run of 4 ranks (``mesh_serving``), a process of its own
rendezvousing through a file in the session's temporary directory, run
once per session (pytest-xdist's workers share the directory and the
first to arrive runs it):

* its ``families``: granite and jamba (MoE), whisper (encoder-decoder) and
  internvl (frontend) smoke configs at (2, 2) (4 slots split over data,
  fused) and (1, 4) (3 slots, unfused: 2 KV heads under tp = 4), granite
  with 6 experts at (1, 4) (each expert's columns split, not the experts),
  every tick's logits kept; whisper's and internvl's prompt passes with
  frames and patches at tp = 2, two decode steps after each.
* its ``autoscale``: ``tests/test_autoscale.py``'s mesh lifecycle at (2, 2)
  beside the fixed-mode mesh run; then ``serve_2d`` at (2, 2) on
  tinyllama, mamba2 and granite beside ``serve_tp``.

``param_specs``' ``serve_2d`` leaves are held to JAX's in
``tests/test_torch_sharding.py``. The JAX side runs here, in the test's
process; the ranks import no JAX. The CLI test starts 2 ranks.
"""
import json
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from repro.configs import smoke_config as jax_smoke_config
from repro.models import model as JM
from repro.runtime import serving as JS
from repro_torch.configs import smoke_config
from repro_torch.convert import params_from_jax
from repro_torch.launch import serve as SERVE
from repro_torch.models.model import init_params
from repro_torch.runtime.serving import LocalExecutor, ServingEngine

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "tests"))
import torch_mesh_ranks as R  # noqa: E402
from test_torch_mesh import _jax_drive  # noqa: E402
from torch_threads import one_thread  # noqa: E402,F401  (autouse)

TOL = 1e-5  # f32 logits, mesh vs the port's local engine
CONVERTED = ("tinyllama-1.1b", "granite-moe-1b-a400m") + R.FAMILIES[1:]
SERVE_2D = ("tinyllama-1.1b", "mamba2-370m", "granite-moe-1b-a400m")


def _spawn(run, d):
    """Run ``run``'s ranks once per test session: under pytest-xdist the
    workers share ``d`` and the first to arrive runs them."""
    from filelock import FileLock

    with FileLock(str(d / f"{run}.lock")):
        if not (d / f"{run}.json").exists():
            env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"),
                       OMP_NUM_THREADS="1")
            out = subprocess.run(
                [sys.executable, os.path.join(REPO, "tests",
                                              "torch_mesh_ranks.py"),
                 run, str(d)], capture_output=True, text=True, env=env,
                timeout=300)
            assert out.returncode == 0, (out.stdout[-3000:],
                                         out.stderr[-3000:])
    with open(d / f"{run}.json") as f:
        return json.load(f)


def _jax_params(arch):
    return jax.device_get(JM.init_params(jax.random.PRNGKey(0),
                                         jax_smoke_config(arch)))


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    """Every family's weights from the JAX init (their streams are held to
    JAX's engine too), mamba2's from the port's; the frames and patches of
    the prompt passes, from a seed. Written once per session (xdist's
    workers share the session's directory)."""
    from filelock import FileLock

    if os.environ.get("PYTEST_XDIST_WORKER"):
        d = tmp_path_factory.getbasetemp().parent / "mesh_serving"
        d.mkdir(exist_ok=True)
    else:
        d = tmp_path_factory.mktemp("mesh_serving")
    with FileLock(str(d / "inputs.lock")):
        if not (d / "frontend.pt").exists():
            _write_inputs(d)
    return d


def _write_inputs(d):
    for arch in CONVERTED:
        torch.save(params_from_jax(_jax_params(arch), device="cpu"),
                   d / f"{arch}.pt")
    torch.save(init_params(smoke_config("mamba2-370m"), seed=0,
                           device="cpu"), d / "mamba2-370m.pt")
    rng = np.random.default_rng(0)
    fe = {}
    for arch, key in (("whisper-base", "frames"), ("internvl2-2b",
                                                   "patches")):
        cfg = smoke_config(arch)
        n = cfg.enc_seq if key == "frames" else cfg.frontend_seq
        fe[arch] = {
            "tokens": torch.from_numpy(rng.integers(
                1, cfg.vocab_size, (2, 5)).astype(np.int64)),
            key: torch.from_numpy(rng.standard_normal(
                (2, n, cfg.frontend_dim)).astype(np.float32)),
            "next": torch.from_numpy(rng.integers(
                1, cfg.vocab_size, (2, 2)).astype(np.int64))}
    torch.save(fe, d / "frontend.pt")


@pytest.fixture(scope="module")
def spawned(inputs):
    return _spawn("mesh_serving", inputs)


@pytest.fixture(scope="module")
def families(inputs, spawned):
    return spawned["families"], torch.load(inputs / "families_logits.pt")


def _local(name, d, batch, fused):
    cfg = R.family_config(name)
    eng = ServingEngine(R.family_params(name, d), cfg, batch_size=batch,
                        cache_capacity=32, prefill_threshold=4, fused=fused,
                        device="cpu")
    eng.warmup()
    return R.logged_drive(eng, cfg)


def _hold_to_local(res, logits, name, d, mesh, batch, fused):
    want, want_lg = _local(name, d, batch, fused)
    got = res[f"{name} {mesh}"]
    assert got["same_on_every_rank"]
    assert got["streams"] == want
    lg = logits[f"{name} {mesh}"]
    assert len(lg) == len(want_lg)
    for a, b in zip(lg, want_lg):
        assert a.shape == b.shape
        assert float((a - b).abs().max()) <= TOL


@pytest.mark.parametrize("arch", R.FAMILIES)
def test_family_engines_match_local_port_engine(inputs, families, arch):
    """(2, 2) fused and (1, 4) unfused: streams equal and every tick's
    logits within 1e-5 of the port's local engine, the same on every
    rank."""
    d = inputs
    res, logits = families
    _hold_to_local(res, logits, arch, d, "2x2", 4, True)
    _hold_to_local(res, logits, arch, d, "1x4", 3, False)


@pytest.mark.parametrize("arch", R.FAMILIES)
def test_family_engines_match_jax_local_engine(inputs, families, arch):
    """The mesh streams against the JAX package's local engine on the same
    converted weights, token for token."""
    jcfg = jax_smoke_config(arch)
    eng = JS.ServingEngine(_jax_params(arch), jcfg, batch_size=3,
                           cache_capacity=32, prefill_threshold=4)
    eng.warmup()
    want = {str(k): list(v) for k, v in _jax_drive(eng, jcfg).items()}
    for mesh in ("2x2", "1x4"):
        assert families[0][f"{arch} {mesh}"]["streams"] == want, mesh


def test_moe_expert_split(inputs, families):
    """granite's 4 experts at (2, 2): 2 whole experts a rank (expert
    parallelism, ``param_specs``' ``spec(m, d0, None)``); its 6 experts at
    (1, 4): every expert's 128 columns in quarters (``spec(None, d0, m)``),
    served as the local engine serves; the router replicated."""
    d = inputs
    res, logits = families
    ep = res["granite-moe-1b-a400m 2x2"]
    assert ep["experts"] == [0, 2] and ep["moe_ff"] == [0, 128]
    assert ep["params"]["stack/pos0/moe/wi"] == [3, 2, 64, 128]
    assert ep["params"]["stack/pos0/moe/wo"] == [3, 2, 128, 64]
    assert ep["params"]["stack/pos0/moe/router"] == [3, 64, 4]
    cols = res["granite6 1x4"]
    assert cols["experts"] == [0, 6] and cols["moe_ff"] == [0, 32]
    assert cols["params"]["stack/pos0/moe/wi"] == [3, 6, 64, 32]
    assert cols["params"]["stack/pos0/moe/wo"] == [3, 6, 32, 64]
    _hold_to_local(res, logits, "granite6", d, "1x4", 3, False)


def test_cross_attention_and_frontend_shards(families):
    """whisper's encoder and cross-attention cut as the self-attention
    (tp = 2: 2 of 4 heads, 1 of 2 KV heads), its encoder K/V cache by KV
    head; internvl's frontend projection replicated."""
    w = families[0]["whisper-base 2x2"]
    p = w["params"]
    assert p["stack/pos0/cross/wq"] == [3, 64, 32]
    assert p["stack/pos0/cross/wk"] == [3, 64, 16]
    assert p["stack/pos0/cross/wo"] == [3, 32, 64]
    assert p["encoder/stack/pos0/attn/wq"] == [2, 64, 32]
    assert p["encoder/stack/pos0/mlp/wi"] == [2, 64, 64]
    assert p["frontend_proj"] == [48, 64]
    assert w["cache"]["stack/pos0/cross_k"] == [3, 2, 1, 24, 16]
    assert families[0]["internvl2-2b 2x2"]["params"]["frontend_proj"] == \
        [48, 64]


@pytest.mark.parametrize("arch", ["whisper-base", "internvl2-2b"])
def test_prompt_pass_with_frames_and_patches(inputs, families, arch):
    """The model-level prompt pass with whisper's frames (the encoder and
    the cross K/V on the shard) or internvl's patches at tp = 2, and two
    decode steps reading its cache, within 1e-5 of the local pass."""
    d = inputs
    res, logits = families
    assert res[f"{arch} prompt"]["same_on_every_rank"]
    cfg = R.family_config(arch)
    fe = torch.load(os.path.join(d, "frontend.pt"))[arch]
    with torch.no_grad():
        want = R.prompt_pass(R.family_params(arch, d), cfg, fe)
    got = logits[f"{arch} prompt"]
    assert got.shape == want.shape == (2, 3, cfg.vocab_size)
    assert float((got - want).abs().max()) <= TOL


@pytest.fixture(scope="module")
def autoscale(spawned):
    return spawned["autoscale"]


def test_mesh_autoscaler_adopts_and_retires_on_every_rank(autoscale):
    """``tests/test_autoscale.py``'s mesh lifecycle: K = 4 built off the
    serving thread, published and retired on the same tick of every rank,
    the table within its budget, every build after warmup published, no
    stalled tick."""
    a = autoscale["autoscaled"]
    st = a["stats"]
    assert a["built"], "the mesh background build never finished"
    assert st["published"] >= 1 and st["retired"] >= 1, st
    assert st["tick_stalls"] == 0 and st["dropped"] == 0
    assert a["table"] <= a["budget"]
    assert a["compiles"] == a["compiles0"] + st["published_keys"]
    assert a["off_thread"]
    kinds = {e[1] for e in a["events"]}
    assert {"publish", "retire"} <= kinds, a["events"]
    for r in autoscale["every_rank"]:
        assert r["events"] == a["events"]  # same units, same ticks
        assert r["stats"] == st and r["compiles"] == a["compiles"]
        assert r["off_thread"] and r["streams"] == a["streams"]


def test_mesh_autoscaled_streams_match_fixed_mode_and_local(inputs,
                                                            autoscale):
    d = inputs
    cfg = smoke_config("tinyllama-1.1b")
    loc = R.autoscale_engine(torch.load(os.path.join(d, "tinyllama-1.1b.pt")),
                             cfg, LocalExecutor("cpu"))
    loc.set_admission_mode(loc.ctrl.modes[-1])
    for t in R.autoscale_traces():
        loc.run(t)
    assert autoscale["fixed"] == R.streams(loc)
    assert autoscale["autoscaled"]["streams"] == autoscale["fixed"]


@pytest.mark.parametrize("arch", SERVE_2D)
def test_serve_2d_holds_the_param_specs_cut(autoscale, arch):
    """Every leaf a rank holds is ``take(full, spec_slices(shape,
    param_specs(..., "serve_2d")))``: about a quarter of the weights on a
    (2, 2) mesh; each step gathered its groups over data."""
    r = autoscale[f"{arch} serve_2d"]
    assert r["held_is_spec_cut"] and r["n_leaves"] > 0
    assert r["held_elems"] < 0.3 * r["full_elems"]
    assert r["gathers"] > 0


@pytest.mark.parametrize("arch", SERVE_2D)
def test_serve_2d_tokens_match_serve_tp_and_local(inputs, autoscale, arch):
    d = inputs
    r = autoscale[f"{arch} serve_2d"]
    assert r["same_on_every_rank"]
    assert r["streams"] == r["serve_tp"]
    cfg = smoke_config(arch)
    eng = ServingEngine(torch.load(os.path.join(d, f"{arch}.pt")), cfg,
                        batch_size=4, cache_capacity=32, prefill_threshold=4,
                        fused=True, device="cpu")
    eng.warmup()
    assert r["streams"] == R.drive(eng, cfg)


def _cli(argv):
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"),
               OMP_NUM_THREADS="1")
    out = subprocess.run([sys.executable, "-m", "repro_torch.launch.serve",
                          *argv], capture_output=True, text=True, env=env,
                         timeout=300, cwd=REPO)
    assert out.returncode == 0, (out.stdout[-3000:], out.stderr[-3000:])
    return out.stdout


def _crc(text):
    return next(w for ln in text.splitlines() if "streams_crc32=" in ln
                for w in ln.split() if w.startswith("streams_crc32="))


def test_serve_cli_mesh_moe_autoscale(capsys):
    """``--arch granite-moe-1b-a400m --mesh 1x2 --autoscale``: the MoE
    family over a mesh with an autoscaler on each rank, no stalled tick
    and no dropped build, serving the streams of the same run without a
    mesh."""
    argv = ["--arch", "granite-moe-1b-a400m", "--smoke", "--batch", "2",
            "--tokens", "24", "--device", "cpu", "--spec-k", "2",
            "--budget-ms", "500", "--autoscale", "--autoscale-interval", "1",
            "--autoscale-ks", "4"]
    out = _cli(argv + ["--mesh", "1x2"])
    assert "[mesh] backend gloo (CPU, world 2)" in out and "mesh=1x2" in out
    assert "tick_stalls=0 dropped=0" in out
    assert SERVE.main(argv) == 0
    assert _crc(out) == _crc(capsys.readouterr().out)
