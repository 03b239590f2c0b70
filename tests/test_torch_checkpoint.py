"""Checkpoint / restart and gradient compression in the port, on the CPU.

* ``CheckpointManager``: bit-exact round trips of f32, bf16 and integer
  leaves through a tree of dicts and the optimizer's ``OptState``; ``keep``;
  ``.tmp`` directories ignored; a missing key and a wrong shape refused;
  an async save that in-place updates after ``save`` cannot reach.
* ``TrainRunner.run_with_restarts`` after injected failures ends bit for
  bit on the uninterrupted run's parameters and moments (sync and async,
  TinyLlama and Mamba2 smoke), and on JAX's runner's state for a step
  function both packages run.
* Compression: ``quantize``'s q and scale equal JAX's exactly, and error
  feedback converges as the JAX package's ``tests/test_substrate.py``
  holds it.
* ``launch.train --ckpt-dir ... --inject-failure-at`` ends on the
  uninterrupted run's loss.
"""
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import smoke_config as jax_smoke_config
from repro.data import pipeline as JD
from repro.runtime import compression as JC
from repro.runtime import fault_tolerance as JFT
from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import smoke_config
from repro_torch.data import pipeline as TD
from repro_torch.launch import steps as TST
from repro_torch.launch import train as TTRAIN
from repro_torch.optim import optimizer as TO
from repro_torch.optim import schedule as TSCH
from repro_torch.runtime import compression as TC
from repro_torch.runtime import fault_tolerance as TFT
from torch_threads import one_thread  # noqa: E402,F401  (autouse)


def _tree(dtype, seed=0):
    g = torch.Generator().manual_seed(seed)

    def leaf(*shape):
        if dtype.is_floating_point:
            return (torch.randn(*shape, generator=g) * 3).to(dtype)
        return torch.randint(-100, 100, shape, generator=g).to(dtype)

    return {"params": {"embed": leaf(5, 4), "stack": {"w": leaf(2, 3, 4)}},
            "opt": TO.OptState(step=torch.tensor(7, dtype=torch.int32),
                               mu={"a": leaf(6)}, nu={"a": leaf(6)}),
            "rows": [leaf(3), leaf(1)]}


def _leaves(tree):
    from repro_torch.checkpoint.checkpointing import leaves_with_path
    return dict(leaves_with_path(tree))


def _bit_equal(a, b):
    la, lb = _leaves(a), _leaves(b)
    assert la.keys() == lb.keys()
    for k in la:
        x, y = la[k], lb[k]
        assert x.dtype == y.dtype and x.shape == y.shape, k
        if x.dtype == torch.bfloat16:
            x, y = x.view(torch.int16), y.view(torch.int16)
        assert torch.equal(x, y), k


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.int32, torch.int8],
                         ids=["f32", "bf16", "int32", "int8"])
def test_round_trip_is_bit_exact(tmp_path, dtype):
    tree = _tree(dtype)
    tree["params"]["embed"].requires_grad_(dtype.is_floating_point)
    mgr = CheckpointManager(str(tmp_path), keep=2)
    mgr.save(10, tree, {"note": "x"})
    template = _tree(dtype, seed=1)
    template["params"]["embed"].requires_grad_(dtype.is_floating_point)
    back, meta = mgr.restore(template)
    assert meta["step"] == 10 and meta["note"] == "x"
    assert meta["dtypes"]["params/embed"] == str(dtype).split(".")[1]
    _bit_equal(back, tree)
    assert isinstance(back["opt"], TO.OptState)
    assert back["params"]["embed"].requires_grad == dtype.is_floating_point
    assert os.path.exists(tmp_path / "step_00000010" / "proc_0.npz")


def test_keep_and_tmp_directories(tmp_path):
    tree = _tree(torch.float32)
    mgr = CheckpointManager(str(tmp_path), keep=2)
    for s in (1, 2, 3, 4):
        mgr.save(s, tree)
    assert mgr.all_steps() == [3, 4]
    # a crash mid-save leaves a .tmp directory: ignored
    os.makedirs(tmp_path / "step_00000009.tmp")
    _, meta = mgr.restore(tree)
    assert meta["step"] == 4
    with open(tmp_path / "step_00000004" / "META.json") as f:
        assert json.load(f)["n_arrays"] == len(_leaves(tree))


def test_missing_key_and_wrong_shape_are_refused(tmp_path):
    tree = _tree(torch.float32)
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(1, tree)
    extra = _tree(torch.float32)
    extra["params"]["new"] = torch.zeros(2)
    with pytest.raises(KeyError, match="params/new"):
        mgr.restore(extra)
    wrong = _tree(torch.float32)
    wrong["params"]["embed"] = torch.zeros(4, 5)
    with pytest.raises(ValueError, match="params/embed"):
        mgr.restore(wrong)


def test_async_save_is_immune_to_in_place_updates(tmp_path):
    """The optimizer writes parameters and moments in place; an async save
    copies every leaf before its thread starts, so updates made after
    ``save`` and before ``wait`` do not reach the checkpoint."""
    for dtype in (torch.float32, torch.bfloat16):
        tree = _tree(dtype)
        want = {k: v.clone() for k, v in _leaves(tree).items()}
        mgr = CheckpointManager(str(tmp_path / str(dtype)), async_save=True)
        mgr.save(1, tree)
        with torch.no_grad():
            for v in _leaves(tree).values():
                v.add_(1)
        mgr.wait()
        back, _ = mgr.restore(_tree(dtype, seed=2))
        for k, v in _leaves(back).items():
            x, y = v, want[k]
            if dtype == torch.bfloat16 and x.dtype == dtype:
                x, y = x.view(torch.int16), y.view(torch.int16)
            assert torch.equal(x, y), k


def _run(arch, tmp, async_ckpt, plan):
    cfg = smoke_config(arch)
    ocfg = TO.OptimizerConfig(lr=5e-3)
    step = TST.make_train_step(cfg, ocfg, remat="none",
                               lr_schedule=TSCH.warmup_cosine(1.0, 2, 7))
    runner = TFT.TrainRunner(
        cfg, step, lambda: TST.init_train_state(cfg, ocfg, seed=0,
                                                device="cpu"),
        TD.DataConfig(seed=11, global_batch=2, seq_len=8), str(tmp),
        ckpt_every=2, async_ckpt=async_ckpt, failure_plan=plan)
    return runner.run_with_restarts(7), runner


@pytest.mark.parametrize("async_ckpt", [False, True], ids=["sync", "async"])
@pytest.mark.parametrize("arch", ["tinyllama-1.1b", "mamba2-370m"])
def test_train_runner_resumes_bit_identical(tmp_path, arch, async_ckpt):
    ref, r1 = _run(arch, tmp_path / "ref", async_ckpt, None)
    got, r2 = _run(arch, tmp_path / "chaos", async_ckpt,
                   TFT.FailurePlan(at_steps=(3, 6)))
    assert r2.failure_plan._fired == {3, 6}
    # failures before steps 3 and 6 resume from the checkpoints at 2 and 6
    assert [m["step"] for m in r2.metrics_log] == [0, 1, 2, 2, 3, 4, 5, 6]
    assert int(got["opt"].step) == 7
    _bit_equal(got, ref)
    assert r2.metrics_log[-1]["loss"] == r1.metrics_log[-1]["loss"]
    assert all(p.requires_grad for p in _leaves(got["params"]).values())


def test_train_runner_matches_jax_runner(tmp_path):
    """One order-sensitive step function (a modular digest of each step's
    batch), run by JAX's runner and the port's through failures at steps
    3 and 7: the same final state, and both equal to a run without
    failures."""
    def step_fn(state, batch):
        s = int(np.asarray(batch["tokens"], np.int64).sum())
        acc = (int(state["acc"]) * 31 + s) % 2147483647
        return ({"acc": np.int32(acc), "n": np.int32(int(state["n"]) + 1)},
                {"sum": float(s)})

    def init():
        return {"acc": np.int32(0), "n": np.int32(0)}

    out = []
    for mod, cfg, dc in (
            (TFT, smoke_config("tinyllama-1.1b"),
             TD.DataConfig(seed=7, global_batch=2, seq_len=8)),
            (JFT, jax_smoke_config("tinyllama-1.1b"),
             JD.DataConfig(seed=7, global_batch=2, seq_len=8))):
        for name, plan in (("ref", None), ("chaos", (3, 7))):
            r = mod.TrainRunner(cfg, step_fn, init, dc,
                                str(tmp_path / f"{mod.__name__}{name}"),
                                ckpt_every=2,
                                failure_plan=mod.FailurePlan(
                                    at_steps=plan or ()))
            s = r.run_with_restarts(9)
            out.append((int(s["acc"]), int(s["n"])))
    assert len(set(out)) == 1 and out[0][1] == 9


def test_quantize_matches_jax_exactly():
    rng = np.random.default_rng(0)
    cases = [rng.standard_normal(257).astype(np.float32),
             (rng.standard_normal((4, 33)) * 1e-3).astype(np.float32),
             np.zeros(8, np.float32),
             np.array([0.5, -0.5, 1.5, 2.5, -127.0, 127.0], np.float32)]
    for x in cases:
        q, s = TC.quantize(torch.from_numpy(x))
        jq, js = JC.quantize(jnp.asarray(x))
        np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
        assert q.dtype == torch.int8 and float(s) == float(js)
        np.testing.assert_array_equal(TC.dequantize(q, s).numpy(),
                                      np.asarray(JC.dequantize(jq, js)))
    g = {"a": torch.from_numpy(cases[0]), "b": {"c": torch.from_numpy(
        cases[1])}}
    jg = {"a": jnp.asarray(cases[0]), "b": {"c": jnp.asarray(cases[1])}}
    e, je = TC.init_error_buffer(g), JC.init_error_buffer(jg)
    for _ in range(3):
        (qs, e), (jqs, je) = (TC.compress_with_feedback(g, e),
                              JC.compress_with_feedback(jg, je))
    np.testing.assert_array_equal(qs["b"]["c"][0].numpy(),
                                  np.asarray(jqs["b"]["c"][0]))
    assert float(qs["a"][1]) == float(jqs["a"][1])
    np.testing.assert_allclose(e["a"].numpy(), np.asarray(je["a"]),
                               rtol=0, atol=1e-7)


def test_error_feedback_converges():
    """Accumulated compressed gradients track the true ones (small
    gradients, the worst case for int8)."""
    g = {"w": torch.full((32,), 0.01)}
    err = TC.init_error_buffer(g)
    acc = torch.zeros(32)
    for _ in range(50):
        qs, err = TC.compress_with_feedback(g, err)
        q, s = qs["w"]
        acc = acc + q.float() * s
    np.testing.assert_allclose(acc.numpy(), 0.5 * np.ones(32), rtol=0.05)


def test_train_entry_point_restarts_onto_the_uninterrupted_loss(capsys,
                                                                 tmp_path):
    base = ["--arch", "tinyllama-1.1b", "--smoke", "--steps", "6",
            "--batch", "2", "--seq", "8", "--device", "cpu"]

    def last_loss(*flags):
        assert TTRAIN.main(base + list(flags)) == 0
        line = next(ln for ln in capsys.readouterr().out.splitlines()
                    if ln.startswith("[train]"))
        return line, line.split("loss ")[1].split(" on ")[0].split(" -> ")[1]

    _, want = last_loss()
    line, got = last_loss("--ckpt-dir", str(tmp_path), "--ckpt-every", "2",
                          "--inject-failure-at", "3")
    assert got == want and "restarts=1" in line
    assert "steps run=7" in line  # step 2 runs twice
