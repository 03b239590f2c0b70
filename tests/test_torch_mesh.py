"""The port's mesh serving on the CPU: gloo ranks (``tests/torch_mesh_ranks.py``)
held to the port's single-device engine and to the JAX package.

Two spawned runs of 4 ranks, each a process of its own that starts the
ranks and rendezvouses through a file in the test's temporary directory:

* ``serve`` (world 4, mesh (2, 2)): ``tests/test_serving_mesh.py``'s trace
  (mixed widths, a depth switch, prompt lengths 1-5 at threshold 4) on the
  tinyllama and mamba2 smoke configs, 3 slots (replicated over ``data``);
  tinyllama again with 4 slots (split over ``data``), plain and fused with
  token trees, and fused at (1, 4) (2 KV heads under tp = 4: each rank
  holds the head its query heads read);
  and ``compressed_psum`` with one worker per rank.
* ``chaos`` (world 4, (2, 2)): ``tests/test_chaos.py``'s mesh drill, paged
  with page 4 and K = 2, three injected failures, then ``elastic_reshard``
  (2, 2) -> (1, 4) -> (2, 2), then ``pipeline_apply`` over 4 stages (a
  (4, 1) ``("pod", "model")`` mesh) against sequential application.

The JAX side runs here, in the test's process; the ranks import no JAX.
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
from repro.runtime.compression import compressed_psum as jax_compressed_psum
from repro_torch.configs import smoke_config
from repro_torch.convert import params_from_jax
from repro_torch.models.model import init_params
from repro_torch.runtime.serving import ServingEngine

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "tests"))
import torch_mesh_ranks as R  # noqa: E402
from torch_threads import one_thread  # noqa: E402,F401  (autouse)

ARCHS = ("tinyllama-1.1b", "mamba2-370m")


def _spawn(run, d):
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"),
               OMP_NUM_THREADS="1")
    out = subprocess.run(
        [sys.executable, os.path.join(REPO, "tests", "torch_mesh_ranks.py"),
         run, str(d)], capture_output=True, text=True, env=env, timeout=300)
    assert out.returncode == 0, (out.stdout[-3000:], out.stderr[-3000:])
    with open(os.path.join(d, f"{run}.json")) as f:
        return json.load(f)


def _jax_params(arch):
    return jax.device_get(JM.init_params(jax.random.PRNGKey(0),
                                         jax_smoke_config(arch)))


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    """tinyllama's weights from the JAX init (its streams are held to JAX's
    engine too), mamba2's from the port's."""
    d = tmp_path_factory.mktemp("mesh")
    jax_params = _jax_params("tinyllama-1.1b")
    torch.save(params_from_jax(jax_params, device="cpu"),
               os.path.join(d, "tinyllama-1.1b.pt"))
    torch.save(init_params(smoke_config("mamba2-370m"), seed=0,
                           device="cpu"), os.path.join(d, "mamba2-370m.pt"))
    return d, jax_params


def _local_streams(arch, d, batch):
    cfg = smoke_config(arch)
    eng = ServingEngine(torch.load(os.path.join(d, f"{arch}.pt")), cfg,
                        batch_size=batch, cache_capacity=32,
                        prefill_threshold=4, device="cpu")
    eng.warmup()
    return R.drive(eng, cfg), eng.prefills


@pytest.fixture(scope="module")
def serve(inputs):
    d, _ = inputs
    rng = np.random.default_rng(0)
    g = {"w": rng.standard_normal((4, 6, 5)).astype(np.float32),
         "b": rng.standard_normal((4, 7)).astype(np.float32)}
    e = {k: (0.01 * rng.standard_normal(v.shape)).astype(np.float32)
         for k, v in g.items()}
    torch.save({"g": {k: torch.from_numpy(v) for k, v in g.items()},
                "e": {k: torch.from_numpy(v) for k, v in e.items()}},
               os.path.join(d, "psum.pt"))
    res = _spawn("serve", d)
    return res, (g, e), torch.load(os.path.join(d, "psum_out.pt"))


@pytest.mark.parametrize("arch", ARCHS)
def test_mesh_engine_matches_local_port_engine(inputs, serve, arch):
    d, _ = inputs
    res = serve[0][arch]
    want, prefills = _local_streams(arch, d, 3)
    assert res["streams"] == want
    assert res["prefills"] == prefills > 0
    assert res["same_on_every_rank"]


def test_mesh_engine_matches_jax_local_engine(inputs, serve):
    _, jax_params = inputs
    jcfg = jax_smoke_config("tinyllama-1.1b")
    eng = JS.ServingEngine(jax_params, jcfg, batch_size=3,
                           cache_capacity=32, prefill_threshold=4)
    eng.warmup()
    want = {str(k): list(v) for k, v in _jax_drive(eng, jcfg).items()}
    assert serve[0]["tinyllama-1.1b"]["streams"] == want


def _jax_drive(eng, cfg):
    modes = eng.ctrl.modes
    full = modes[-1]
    widths = [m for m in modes if m.depth == full.depth]
    shallow = [m for m in modes if m.depth != full.depth]
    for rid, m in enumerate([widths[-1], widths[0], shallow[-1], widths[-1]]):
        eng.set_admission_mode(m)
        eng.submit(JS.Request(
            rid=rid, prompt=tuple(1 + (rid * 7 + j) % (cfg.vocab_size - 1)
                                  for j in range(1 + rid % 5)),
            max_new_tokens=5,
            slo_class="interactive" if rid % 2 else "batch"))
        eng.step()
    while eng.queue or eng.n_active:
        eng.step()
    return {r.rid: tuple(r.generated) for r in eng.completed}


@pytest.mark.parametrize("arch", ARCHS)
def test_mesh_engine_builds_nothing_after_warmup(serve, arch):
    res = serve[0][arch]
    assert res["retraces"] == 0
    assert res["compiles_after_warmup"] == res["depths"] == res["compiles"]


def test_each_rank_holds_only_its_shard_at_tp2(serve):
    """tinyllama smoke (4 / 2 heads of 16, d_ff 128, vocab 2048 padded) and
    mamba2 smoke (8 heads of 16) at tp = 2: halves of every split dim."""
    t = serve[0]["tinyllama-1.1b"]
    p, c = t["params"], t["cache"]
    assert p["stack/pos0/attn/wq"] == [3, 64, 32]
    assert p["stack/pos0/attn/wk"] == [3, 64, 16]
    assert p["stack/pos0/attn/wo"] == [3, 32, 64]
    assert p["stack/pos0/mlp/wi"] == [3, 64, 64]
    assert p["stack/pos0/mlp/wo"] == [3, 64, 64]
    assert p["embed"] == [1024, 64] and p["unembed"] == [64, 1024]
    assert c["stack/pos0/k"] == [3, 3, 32, 1, 16]  # 3 slots, 1 of 2 KV
    m = serve[0]["mamba2-370m"]
    p, c = m["params"], m["cache"]
    assert p["stack/pos0/ssm/w_x"] == [3, 64, 64]
    assert p["stack/pos0/ssm/out_proj"] == [3, 64, 64]
    assert p["stack/pos0/ssm/A_log"] == [3, 4]
    assert p["stack/pos0/ssm/w_bc"] == [3, 64, 32]  # B / C replicated
    assert c["stack/pos0/state"] == [3, 3, 4, 16, 16]
    assert c["stack/pos0/conv_x"] == [3, 3, 3, 64]


def test_slots_split_over_data(inputs, serve):
    d, _ = inputs
    res = serve[0]["tinyllama-1.1b slots4"]
    assert res["split_slots"]
    assert res["cache"]["stack/pos0/k"] == [3, 2, 32, 1, 16]
    assert res["cache"]["pos"] == [2]
    assert res["streams"] == _local_streams("tinyllama-1.1b", d, 4)[0]
    assert res["same_on_every_rank"]


def test_tree_speculation_with_slots_split_over_data(inputs, serve):
    """Fused, a (2, 2) tree and K = 2 built: the tree draft, the tree
    verify and the commit per data rank, results gathered over data."""
    from repro_torch.runtime.speculative import SpecConfig

    d, _ = inputs
    res = serve[0]["tinyllama-1.1b slots4 fused tree"]
    cfg = smoke_config("tinyllama-1.1b")
    eng = ServingEngine(torch.load(os.path.join(d, "tinyllama-1.1b.pt")), cfg,
                        batch_size=4, cache_capacity=32, prefill_threshold=4,
                        fused=True, device="cpu",
                        speculative=SpecConfig(ks=(2,), trees=((2, 2),)))
    eng.warmup()
    assert res["streams"] == R.drive(eng, cfg)
    assert res["tree_launches"] == eng.spec_tree_launches > 0
    assert res["same_on_every_rank"]


def test_replicated_kv_heads_fused_at_tp4(inputs, serve):
    d, _ = inputs
    res = serve[0]["tinyllama-1.1b 1x4 fused"]
    assert res["kv_heads"] == [0, 1]  # rank 0: query head 0 reads KV head 0
    assert res["params"]["stack/pos0/attn/wk"] == [3, 64, 16]
    assert res["params"]["stack/pos0/attn/wq"] == [3, 64, 16]
    assert res["streams"] == _local_streams("tinyllama-1.1b", d, 3)[0]
    assert res["same_on_every_rank"]


def test_compressed_psum_matches_jax_under_vmap(serve):
    """4 workers from one seed: the mean and each worker's error buffer
    against ``repro.runtime.compression.compressed_psum`` under
    ``jax.vmap(axis_name=...)`` (its pmax / psum over the mapped dim)."""
    _, (g, e), got = serve
    with jax.disable_jit():
        red, err = jax.vmap(lambda a, b: jax_compressed_psum(a, b, "w"),
                            axis_name="w")(g, e)
    for r, (red_r, err_r) in enumerate(got):
        for k in g:
            np.testing.assert_allclose(red_r[k].numpy(),
                                       np.asarray(red[k][r]), rtol=0,
                                       atol=1e-6)
            np.testing.assert_allclose(err_r[k].numpy(),
                                       np.asarray(err[k][r]), rtol=0,
                                       atol=1e-6)


@pytest.fixture(scope="module")
def chaos(inputs):
    d, _ = inputs
    g = torch.Generator().manual_seed(0)
    torch.save({"ws": torch.randn(4, 16, 16, generator=g) / 4,
                "x": torch.randn(8, 16, generator=g)},
               os.path.join(d, "pipeline.pt"))
    return _spawn("chaos", d)


def test_mesh_chaos_drill_recovers_bit_identically(chaos):
    assert all(chaos["totals"].get(s, 0) >= 1 for s in R.FAIL_SITES)
    assert chaos["failovers"] == 3
    assert chaos["fired"] == sorted([s, 1] for s in R.FAIL_SITES)
    assert chaos["out"] == chaos["ref"]
    assert chaos["same_on_every_rank"]


def test_paged_speculative_mesh_matches_local_engine(inputs, chaos):
    """The drill's fault-free mesh run (paged, page 4, K = 2) against the
    port's local engine on the same trace."""
    from repro_torch.runtime.fault_tolerance import ExecutorSupervisor
    from repro_torch.runtime.serving import LocalExecutor

    d, _ = inputs
    cfg = smoke_config("tinyllama-1.1b")
    params = torch.load(os.path.join(d, "tinyllama-1.1b.pt"))
    sup = ExecutorSupervisor(lambda: R.chaos_engine(params, cfg,
                                                    LocalExecutor("cpu")))
    sup.run_trace(R.chaos_trace(cfg))
    assert R.streams(sup.engine) == chaos["ref"]


def test_elastic_reshard_round_trip(chaos):
    assert chaos["reshard_ok"]


def test_pipeline_apply_matches_sequential(chaos):
    """JAX's tolerance (``tests/test_pipeline_parallel.py``)."""
    assert chaos["pipeline"]["max_abs_err"] <= 1e-5
    assert abs(chaos["pipeline"]["bubble"] - 3 / 7) < 1e-12
