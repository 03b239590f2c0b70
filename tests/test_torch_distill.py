"""The port's DistillCycle and width slicing against the JAX package, on the
CPU.

Same weights in both packages (JAX init, converted through numpy), batches
from the port's ``make_batch`` (bit-identical to the reference's), the f32
smoke configs of ``tinyllama-1.1b`` and ``mamba2-370m``. Tolerances:

* ``slice_params`` views: exact (they are the same numbers);
  ``morph_forward`` logits at width 0.5 and an exit depth: atol 1e-4;
* ``kd_loss``, ``teacher_loss``, ``student_loss``: rtol 1e-5 (f32 sums in
  another order), their grads: 1e-4 of each leaf's max |g|;
* a 2-stage ``DistillCycle.run`` (one teacher and one student step per
  stage, AdamW at lr 1e-3): every history loss within 1e-4, relative.
  Adam's first steps move each parameter by about lr sign(g), and a
  gradient inside the f32 noise may take the other sign, so the losses
  after a step agree to ~lr, not to rounding;
* ``eval_modes(with_agreement=True)``: CE within 1e-4 relative, agreement
  within one token in 100 (argmax ties between near-equal logits).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import MorphMode as JMode
from repro.configs import smoke_config as jax_smoke_config
from repro.core import distillcycle as JDC
from repro.core import elastic as JEL
from repro.data import pipeline as JD
from repro.models import model as JM
from repro.optim import optimizer as JO
from repro_torch.configs import MorphMode, smoke_config
from repro_torch.convert import cache_from_jax, params_from_jax, to_numpy
from repro_torch.core import distillcycle as TDC
from repro_torch.core import elastic as TEL
from repro_torch.data import pipeline as TD
from repro_torch.launch import steps as TST
from repro_torch.models import model as TM
from repro_torch.optim import optimizer as TO
from torch_threads import one_thread  # noqa: E402,F401  (autouse)

ARCHS = ("tinyllama-1.1b", "mamba2-370m")
LR = 1e-3


@pytest.fixture(scope="module")
def jax_params():
    out = {}
    for arch in ARCHS:
        init = jax.jit(JM.init_params, static_argnums=1)
        out[arch] = jax.device_get(init(jax.random.PRNGKey(2),
                                        jax_smoke_config(arch)))
    return out


def _dc():
    return dict(seed=4, global_batch=4, seq_len=16)


def _batch(arch, step=0):
    return TD.make_batch(smoke_config(arch), TD.DataConfig(**_dc()), step)


def _leaves(tree, prefix=""):
    for k, v in tree.items():
        p = f"{prefix}/{k}" if prefix else k
        if isinstance(v, dict):
            yield from _leaves(v, p)
        else:
            yield p, v


def _assert_grads(got, want):
    want = dict(_leaves(jax.device_get(want)))
    for path, g in _leaves(to_numpy(got)):
        w = np.asarray(want[path], np.float32)
        np.testing.assert_allclose(g, w, atol=1e-4 * max(float(np.abs(w).max()),
                                                        1e-30),
                                   rtol=0, err_msg=path)


@pytest.mark.parametrize("arch", ARCHS)
def test_slice_params_and_morph_forward_match(jax_params, arch):
    """Width 0.5 at the exit depth and at full depth: the sliced views equal
    the reference's slices and share storage with the full params."""
    jcfg, tcfg = jax_smoke_config(arch), smoke_config(arch)
    tp = params_from_jax(jax_params[arch], "cpu")
    b = _batch(arch, 2)
    for depth in (tcfg.elastic.exit_layers[0], tcfg.n_groups):
        jmode, tmode = JMode(depth=depth, width=0.5), MorphMode(depth=depth,
                                                                 width=0.5)
        want_p = dict(_leaves(jax.device_get(
            JEL.slice_params(jax_params[arch], jcfg, jmode))))
        got_p = TEL.slice_params(tp, tcfg, tmode)
        full = dict(_leaves(tp))
        for path, t in _leaves(got_p):
            np.testing.assert_array_equal(to_numpy(t), want_p[path])
            assert t.untyped_storage().data_ptr() == \
                full[path].untyped_storage().data_ptr(), path
        want, _ = JEL.morph_forward(jax_params[arch],
                                    {k: jnp.asarray(v) for k, v in b.items()},
                                    jcfg, jmode)
        with torch.no_grad():
            got, _ = TEL.morph_forward(tp, TD.to_device(b, "cpu"), tcfg, tmode)
        np.testing.assert_allclose(to_numpy(got["final"]),
                                   np.asarray(want["final"]), atol=1e-4,
                                   rtol=1e-4)


def test_morph_decode_steps_match(jax_params):
    arch = "tinyllama-1.1b"
    jcfg, tcfg = jax_smoke_config(arch), smoke_config(arch)
    tp = params_from_jax(jax_params[arch], "cpu")
    toks = np.array([[3], [7]], np.int32)
    jmode, tmode = JMode(depth=1, width=0.5), MorphMode(depth=1, width=0.5)
    jcache = JM.init_decode_cache(JEL.morph_config(jcfg, jmode), 2, 8)
    want, _ = JEL.morph_decode_step(jax_params[arch], jcache, jnp.asarray(toks),
                                    jcfg, jmode)
    tcache = cache_from_jax(jax.device_get(jcache), "cpu")
    got, _ = TEL.morph_decode_step(tp, tcache, torch.from_numpy(toks).long(),
                                   tcfg, tmode)
    np.testing.assert_allclose(to_numpy(got), np.asarray(want), atol=1e-4)
    jcache = JM.init_decode_cache(jcfg, 2, 8, per_slot=True)
    want, _ = JEL.morph_decode_step_dynamic(jax_params[arch], jcache,
                                            jnp.asarray(toks), jcfg, 0.5,
                                            depth=1)
    tcache = cache_from_jax(jax.device_get(jcache), "cpu")
    got, _ = TEL.morph_decode_step_dynamic(tp, tcache,
                                           torch.from_numpy(toks).long(),
                                           tcfg, 0.5, depth=1)
    np.testing.assert_allclose(to_numpy(got), np.asarray(want), atol=1e-4)
    # the step factories: a morphed mode reaches morph_decode_step, the full
    # mode decode_step; the prefill step is the prompt pass
    caches = [TM.init_decode_cache(TEL.morph_config(tcfg, tmode), 2, 8,
                                   device="cpu") for _ in range(2)]
    t = torch.from_numpy(toks).long()
    got, _ = TST.make_decode_fn(tcfg, tmode)(tp, caches[0], t)
    want, _ = TEL.morph_decode_step(tp, caches[1], t, tcfg, tmode)
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    got, _ = TST.make_decode_fn(tcfg)(tp, TM.init_decode_cache(
        tcfg, 2, 8, device="cpu"), t)
    want, _ = TM.decode_step(tp, TM.init_decode_cache(tcfg, 2, 8,
                                                      device="cpu"), t, tcfg)
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    got, _ = TST.make_prefill_step(tcfg)(tp, {"tokens": t})
    torch.testing.assert_close(got, TM.prefill(tp, {"tokens": t}, tcfg)[0],
                               rtol=0, atol=0)


@pytest.mark.parametrize("arch", ARCHS)
def test_distill_losses_and_grads_match(jax_params, arch):
    """``kd_loss`` on logits with padded columns, ``teacher_loss`` at the
    exit depth, ``student_loss`` at width 0.5 against the full teacher."""
    jcfg, tcfg = jax_smoke_config(arch), smoke_config(arch)
    b = _batch(arch, 3)
    jb = {k: jnp.asarray(v) for k, v in b.items()}
    tb = TD.to_device(b, "cpu")
    rng = np.random.default_rng(5)
    s_lg, t_lg = (rng.standard_normal((2, 3, tcfg.padded_vocab()))
                  .astype(np.float32) for _ in range(2))
    np.testing.assert_allclose(
        float(TDC.kd_loss(torch.from_numpy(s_lg), torch.from_numpy(t_lg), tcfg,
                          2.0)),
        float(JDC.kd_loss(jnp.asarray(s_lg), jnp.asarray(t_lg), jcfg, 2.0)),
        rtol=1e-5)

    depth = tcfg.elastic.exit_layers[0]
    jl, jg = jax.jit(jax.value_and_grad(
        lambda p: JDC.teacher_loss(p, jb, jcfg, depth)))(jax_params[arch])
    tp = TO.trainable(params_from_jax(jax_params[arch], "cpu"))
    tl = TDC.teacher_loss(tp, tb, tcfg, depth)
    np.testing.assert_allclose(tl.item(), float(jl), rtol=1e-5)
    _assert_grads(TO.grads_of(tl, tp), jg)

    teacher = np.array(jax.jit(lambda p: JM.forward(p, jb, jcfg)[0][
        "final"])(jax_params[arch]))
    jmode, tmode = JMode(depth=tcfg.n_groups, width=0.5), MorphMode(
        depth=tcfg.n_groups, width=0.5)
    (jl, jparts), jg = jax.jit(jax.value_and_grad(
        lambda p: JDC.student_loss(p, jb, jcfg, jmode, jnp.asarray(teacher),
                                   0.5, 2.0), has_aux=True))(jax_params[arch])
    tl, tparts = TDC.student_loss(tp, tb, tcfg, tmode,
                                  torch.from_numpy(teacher), 0.5, 2.0)
    np.testing.assert_allclose(tl.item(), float(jl), rtol=1e-5)
    for k in ("ce", "kd"):
        np.testing.assert_allclose(tparts[k].item(), float(jparts[k]),
                                   rtol=1e-5, atol=1e-7)
    _assert_grads(TO.grads_of(tl, tp), jg)


def test_default_schedule_is_depth_then_width():
    for arch in ARCHS:
        got = TDC.default_schedule(smoke_config(arch))
        want = JDC.default_schedule(jax_smoke_config(arch))
        assert [(m.depth, m.width) for m in got] == \
            [(m.depth, m.width) for m in want]


@pytest.fixture(scope="module")
def cycles(jax_params):
    """A 2-stage run in both packages (the exit at width 0.5, then full
    depth at full width: the net grows between them), one teacher and one
    student step per stage; returns per arch (JAX cycle, JAX params, port
    cycle, port params)."""
    out = {}
    for arch in ARCHS:
        jcfg, tcfg = jax_smoke_config(arch), smoke_config(arch)
        e = tcfg.elastic.exit_layers[0]
        dkw = dict(epochs_per_stage=1, steps_per_epoch=1, epoch_lr_decay=1.0)
        jcyc = JDC.DistillCycle(
            jcfg, JO.OptimizerConfig(lr=LR), JD.DataConfig(**_dc()),
            schedule=(JMode(e, 0.5), JMode(jcfg.n_groups, 1.0)),
            dcfg=JDC.DistillCycleConfig(**dkw))
        jp, _ = jcyc.run(jax_params[arch])
        tcyc = TDC.DistillCycle(
            tcfg, TO.OptimizerConfig(lr=LR), TD.DataConfig(**_dc()),
            schedule=(MorphMode(e, 0.5), MorphMode(tcfg.n_groups, 1.0)),
            dcfg=TDC.DistillCycleConfig(**dkw))
        calls = []
        tp, topt = tcyc.run(params_from_jax(jax_params[arch], "cpu"),
                            on_step=lambda *a: calls.append(a))
        assert calls == [("teacher", tcyc.schedule[0], e),
                         ("student", tcyc.schedule[0], e),
                         ("teacher", tcyc.schedule[1], tcfg.n_groups),
                         ("student", tcyc.schedule[1], tcfg.n_groups)]
        out[arch] = (jcyc, jax.device_get(jp), tcyc, tp, topt)
    return out


@pytest.mark.parametrize("arch", ARCHS)
def test_distillcycle_run_matches(cycles, arch):
    jcyc, _, tcyc, _, topt = cycles[arch]
    assert len(tcyc.history) == len(jcyc.history) == 2
    for got, want in zip(tcyc.history, jcyc.history):
        for k in ("stage", "mode", "epoch"):
            assert got[k] == want[k]
        for k in ("teacher_loss", "student_loss", "student_ce", "student_kd"):
            np.testing.assert_allclose(got[k], want[k], rtol=1e-4, atol=1e-6,
                                       err_msg=k)
    assert int(topt.step) == 4
    # one teacher step per grown depth, one student step per mode
    assert tcyc.builds == 4
    assert [m.name for m in tcyc.trained_paths] == \
        [m.name for m in jcyc.trained_paths]


@pytest.mark.parametrize("arch", ARCHS)
def test_eval_modes_with_agreement_matches(cycles, arch):
    jcyc, jp, tcyc, tp, _ = cycles[arch]
    want = jcyc.eval_modes(jp, n_batches=2, with_agreement=True)
    got = tcyc.eval_modes(tp, n_batches=2, with_agreement=True)
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_allclose(got[k]["ce"], want[k]["ce"], rtol=1e-4)
        assert abs(got[k]["agreement"] - want[k]["agreement"]) <= 0.01, k
    assert got[f"d{smoke_config(arch).n_groups}w100"]["agreement"] == 1.0
    plain = tcyc.eval_modes(tp, n_batches=2)
    assert plain == {k: v["ce"] for k, v in got.items()}
