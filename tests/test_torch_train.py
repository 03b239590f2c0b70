"""The port's training stack against the JAX package, on the CPU.

Same weights and optimizer state in both packages (JAX init, converted
through numpy with ``params_from_jax`` / ``opt_state_from_jax``), batches
from the port's ``make_batch`` (bit-identical to the reference's), the f32
smoke configs of ``tinyllama-1.1b`` and ``mamba2-370m``. Tolerances, all in
f32:

* ``make_batch``: bit-identical;
* schedules, ``clip_by_global_norm``, ``apply_updates`` on the same grads:
  atol 1e-6 + rtol 1e-5 (elementwise f32 arithmetic in another order);
  bf16 moments to one bf16 step (rtol 2^-7);
* ``forward`` logits: atol 1e-4; losses: rtol 1e-5;
* gradients: |port - JAX| <= 1e-4 max |g| of each leaf (summation order
  across the whole model);
* one ``make_train_step``: params within 1e-5 plus, where the JAX gradient
  is below that leaf's gradient tolerance, 2 lr: Adam's first step is
  lr sign(g), and a gradient inside the noise may take either sign;
* the SSD scan's backward: ``ssd_scan_bwd_plain`` against autograd through
  ``ssd_chunked`` and against ``jax.grad`` of the reference, rtol / atol
  1e-4 of each gradient's scale; at chunk 256 with a tile decay past 88,
  against float64 autograd through the step-by-step recurrence, 1e-4 of
  the scale (f32 against f64).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import smoke_config as jax_smoke_config
from repro.data import pipeline as JD
from repro.launch import steps as JST
from repro.models import model as JM
from repro.models import ssm as JSSM
from repro.optim import optimizer as JO
from repro.optim import schedule as JSCH
from repro_torch.configs import smoke_config
from repro_torch.convert import opt_state_from_jax, params_from_jax, to_numpy
from repro_torch.data import pipeline as TD
from repro_torch.kernels import ssd_scan as TSSD
from repro_torch.launch import steps as TST
from repro_torch.launch import train as TTRAIN
from repro_torch.models import model as TM
from repro_torch.optim import optimizer as TO
from repro_torch.optim import schedule as TSCH
from torch_threads import one_thread  # noqa: E402,F401  (autouse)

ARCHS = ("tinyllama-1.1b", "mamba2-370m")
GRAD_RTOL = 1e-4


def _dc(**kw):
    return TD.DataConfig(**{"seed": 3, "global_batch": 4, "seq_len": 16, **kw})


@pytest.fixture(scope="module")
def jax_params():
    out = {}
    for arch in ARCHS:
        init = jax.jit(JM.init_params, static_argnums=1)
        out[arch] = jax.device_get(init(jax.random.PRNGKey(1),
                                        jax_smoke_config(arch)))
    return out


def _port(params_np):
    return TO.trainable(params_from_jax(params_np, device="cpu"))


def _batch(arch, step=0, **kw):
    return TD.make_batch(smoke_config(arch), _dc(**kw), step)


def _jbatch(b):
    return {k: jnp.asarray(v) for k, v in b.items()}


def _leaves(tree, prefix=""):
    for k, v in tree.items():
        p = f"{prefix}/{k}" if prefix else k
        if isinstance(v, dict):
            yield from _leaves(v, p)
        else:
            yield p, v


def _assert_grads(got, want, what=""):
    want = dict(_leaves(want))
    for path, g in _leaves(to_numpy(got)):
        w = np.asarray(want[path], np.float32)
        tol = GRAD_RTOL * max(float(np.abs(w).max()), 1e-30)
        np.testing.assert_allclose(g, w, atol=tol, rtol=0,
                                   err_msg=f"{what} {path}")


@pytest.fixture(scope="module")
def jax_grads(jax_params):
    """JAX loss and grads of each arch on one batch (also the noise floor
    of the train-step test)."""
    out = {}
    for arch in ARCHS:
        cfg = jax_smoke_config(arch)
        fn = jax.jit(jax.value_and_grad(
            lambda p, b, cfg=cfg: JM.loss_fn(p, b, cfg)[0]))
        loss, g = fn(jax_params[arch], _jbatch(_batch(arch)))
        out[arch] = (float(loss), jax.device_get(g))
    return out


# ---------------------------------------------------------------------------
# data, schedules, optimizer
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ARCHS)
def test_make_batch_is_bit_identical(arch):
    jd = JD.DataConfig(seed=5, global_batch=4, seq_len=24, n_shards=2, shard=1)
    td = TD.DataConfig(seed=5, global_batch=4, seq_len=24, n_shards=2, shard=1)
    for step in (0, 7):
        got = TD.make_batch(smoke_config(arch), td, step)
        want = JD.make_batch(jax_smoke_config(arch), jd, step)
        assert got.keys() == want.keys()
        for k in want:
            assert got[k].dtype == want[k].dtype
            np.testing.assert_array_equal(got[k], want[k])
    it = TD.PrefetchIterator(smoke_config(arch), td, start_step=7)
    step, b = next(it)
    it.close()
    assert step == 7
    np.testing.assert_array_equal(b["tokens"], want["tokens"])


def test_schedules_match():
    jw, tw = JSCH.warmup_cosine(1.0, 5, 40), TSCH.warmup_cosine(1.0, 5, 40)
    for step in (0, 1, 4, 5, 6, 20, 39, 40, 55):
        np.testing.assert_allclose(float(tw(step)), float(jw(step)),
                                   rtol=1e-6, atol=1e-7)
        np.testing.assert_allclose(float(tw(torch.tensor(step))),
                                   float(jw(step)), rtol=1e-6, atol=1e-7)
    assert float(TSCH.constant(0.3)(9)) == pytest.approx(0.3)
    assert TSCH.distillcycle_decay(0.8, 3) == JSCH.distillcycle_decay(0.8, 3)


def test_clip_by_global_norm_matches():
    rng = np.random.default_rng(0)
    tree = {"a": rng.standard_normal((3, 4)).astype(np.float32),
            "b": {"c": rng.standard_normal(5).astype(np.float32)}}
    for max_norm in (0.5, 100.0):
        jg, jn = JO.clip_by_global_norm(tree, max_norm)
        tg, tn = TO.clip_by_global_norm(params_from_jax(tree, "cpu"), max_norm)
        np.testing.assert_allclose(float(tn), float(jn), rtol=1e-6)
        for path, g in _leaves(to_numpy(tg)):
            np.testing.assert_allclose(g, dict(_leaves(jax.device_get(jg)))[path],
                                       rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("name,moments", [("adamw", "float32"),
                                          ("adamw", "bfloat16"),
                                          ("sgdm", "float32"),
                                          ("sgdm", "bfloat16")])
def test_apply_updates_matches_from_a_mid_run_state(jax_params, name,
                                                    moments):
    """Two reference steps make a mid-run state; the third step runs in
    both packages on the same grads (mamba2: its A_log, D and dt_bias
    leaves take no weight decay)."""
    arch = "mamba2-370m"
    ocfg = dict(name=name, lr=1e-2, moment_dtype=moments, weight_decay=0.1,
                grad_clip=0.05)
    jcfg, tcfg = JO.OptimizerConfig(**ocfg), TO.OptimizerConfig(**ocfg)
    p = jax_params[arch]
    rng = np.random.default_rng(1)
    grads = [jax.tree_util.tree_map(
        lambda a: rng.standard_normal(a.shape).astype(np.float32), p)
        for _ in range(3)]
    upd = jax.jit(JO.apply_updates, static_argnums=3)
    st = JO.init_opt_state(p, jcfg)
    for g in grads[:2]:
        p, st, _ = upd(p, g, st, jcfg, 0.7)
    p, st = jax.device_get(p), jax.device_get(st)
    tp = params_from_jax(p, "cpu")
    tst = opt_state_from_jax(st, "cpu")
    assert int(tst.step) == 2
    jp, jst, jm = upd(p, grads[2], st, jcfg, 0.7)
    tp, tst, tm = TO.apply_updates(tp, params_from_jax(grads[2], "cpu"), tst,
                                   tcfg, torch.tensor(0.7))
    assert int(tst.step) == int(jst.step) == 3
    np.testing.assert_allclose(float(tm["grad_norm"]), float(jm["grad_norm"]),
                               rtol=1e-5)
    np.testing.assert_allclose(float(tm["lr"]), float(jm["lr"]), rtol=1e-6)
    # bf16 moments: one bf16 step (the f32 values before rounding differ
    # in their last bits, and a rounding boundary between them moves the
    # stored value by a step)
    m_rtol = 2.0 ** -7 if moments == "bfloat16" else 1e-5
    for tree_t, tree_j, rtol in ((tp, jp, 1e-5), (tst.mu, jst.mu, m_rtol),
                                 (tst.nu, jst.nu, m_rtol)):
        want = dict(_leaves(jax.device_get(tree_j)))
        for path, got in _leaves(to_numpy(tree_t)):
            np.testing.assert_allclose(got, np.asarray(want[path], np.float32),
                                       atol=1e-6, rtol=rtol, err_msg=path)
    assert TO.opt_state_bytes(tp, tcfg) == JO.opt_state_bytes(jp, jcfg)


def test_decay_mask_reads_the_key_path():
    assert TO._decay_mask("stack/pos0/ssm/w_x")
    for path in ("stack/pos0/ssm/A_log", "stack/pos0/ssm/D",
                 "stack/pos0/ssm/dt_bias", "final_norm/scale",
                 "stack/pos0/norm1/scale", "exit_norms/g1/scale"):
        assert not TO._decay_mask(path), path


# ---------------------------------------------------------------------------
# forward and loss
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_with_depth_and_exits_matches(jax_params, arch):
    jcfg, tcfg = jax_smoke_config(arch), smoke_config(arch)
    b = _batch(arch, step=1)
    tp = params_from_jax(jax_params[arch], "cpu")
    for depth, exits in ((None, (1,)), (2, (1,)), (1, ())):
        want, _ = JM.forward(jax_params[arch], _jbatch(b), jcfg, depth=depth,
                             collect_exits=exits)
        with torch.no_grad():
            got, aux = TM.forward(tp, TD.to_device(b, "cpu"), tcfg,
                                  depth=depth, collect_exits=exits)
        assert sorted(got) == sorted(want)
        assert float(aux) == 0.0
        for k in want:
            np.testing.assert_allclose(to_numpy(got[k]), np.asarray(want[k]),
                                       atol=1e-4, rtol=1e-4, err_msg=k)


def test_cross_entropy_masks_the_padded_vocab():
    jcfg, tcfg = (jax_smoke_config("tinyllama-1.1b"),
                  smoke_config("tinyllama-1.1b"))
    rng = np.random.default_rng(2)
    v = tcfg.vocab_size
    logits = rng.standard_normal((2, 5, tcfg.padded_vocab())).astype(np.float32)
    logits[..., v:] = 50.0  # padded columns would dominate if unmasked
    targets = rng.integers(0, v, (2, 5)).astype(np.int32)
    mask = (rng.random((2, 5)) < 0.6).astype(np.float32)
    for m in (None, mask):
        want = JM.cross_entropy(jnp.asarray(logits), jnp.asarray(targets), jcfg,
                                None if m is None else jnp.asarray(m))
        got = TM.cross_entropy(torch.from_numpy(logits),
                               torch.from_numpy(targets), tcfg,
                               None if m is None else torch.from_numpy(m))
        np.testing.assert_allclose(float(got), float(want), rtol=1e-6)


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_fn_value_and_grads_match(jax_params, jax_grads, arch):
    tp = _port(jax_params[arch])
    loss, parts = TM.loss_fn(tp, TD.to_device(_batch(arch), "cpu"),
                             smoke_config(arch))
    want_loss, want_g = jax_grads[arch]
    np.testing.assert_allclose(loss.item(), want_loss, rtol=1e-5)
    assert parts["ce"].item() == pytest.approx(loss.item())
    _assert_grads(TO.grads_of(loss, tp), want_g, arch)


@pytest.mark.parametrize("remat", ["full", "dots"])
def test_remat_keeps_loss_and_grads(jax_params, remat):
    arch = "mamba2-370m"
    b = TD.to_device(_batch(arch), "cpu")
    grads = []
    for r in ("none", remat):
        tp = _port(jax_params[arch])
        loss, _ = TM.loss_fn(tp, b, smoke_config(arch), remat=r)
        grads.append((loss.item(), to_numpy(TO.grads_of(loss, tp))))
    assert grads[0][0] == pytest.approx(grads[1][0], rel=1e-6)
    _assert_grads(params_from_jax(grads[1][1], "cpu"), grads[0][1], remat)


# ---------------------------------------------------------------------------
# train steps
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("mb,remat", [(1, "none"), (2, "full")])
def test_make_train_step_matches(jax_params, jax_grads, arch, mb, remat):
    lr = 1e-3
    jo, to = JO.OptimizerConfig(lr=lr), TO.OptimizerConfig(lr=lr)
    jcfg, tcfg = jax_smoke_config(arch), smoke_config(arch)
    sched_j = JSCH.warmup_cosine(1.0, 2, 10)
    sched_t = TSCH.warmup_cosine(1.0, 2, 10)
    b = _batch(arch)
    jstep = jax.jit(JST.make_train_step(jcfg, jo, microbatches=mb, remat=remat,
                                        lr_schedule=sched_j))
    jstate = {"params": jax_params[arch],
              "opt": JO.init_opt_state(jax_params[arch], jo)}
    jstate, jm = jstep(jstate, _jbatch(b))
    tstep = TST.make_train_step(tcfg, to, microbatches=mb, remat=remat,
                                lr_schedule=sched_t)
    tp = _port(jax_params[arch])
    tstate = {"params": tp, "opt": TO.init_opt_state(tp, to)}
    tstate, tm = tstep(tstate, b)  # a numpy batch moves to the params' device
    np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]), rtol=1e-5)
    np.testing.assert_allclose(float(tm["lr"]), float(jm["lr"]), rtol=1e-6)
    np.testing.assert_allclose(float(tm["grad_norm"]), float(jm["grad_norm"]),
                               rtol=1e-4)
    assert int(tstate["opt"].step) == 1
    g = dict(_leaves(jax_grads[arch][1]))
    want = dict(_leaves(jax.device_get(jstate["params"])))
    lr_step = lr * float(sched_j(0))
    for path, got in _leaves(to_numpy(tstate["params"])):
        gj = np.abs(np.asarray(g[path]))
        noise = gj <= GRAD_RTOL * gj.max()
        tol = 1e-5 + np.where(noise, 2 * lr_step, 0.0)
        err = np.abs(got - np.asarray(want[path]))
        assert (err <= tol).all(), (path, float(err.max()))


def test_to_microbatches_takes_strided_rows():
    x = np.arange(12).reshape(6, 2)
    got = TST.to_microbatches(torch.from_numpy(x), 3)
    np.testing.assert_array_equal(got.numpy(), np.asarray(
        JST.to_microbatches(jnp.asarray(x), 3)))
    np.testing.assert_array_equal(got[1].numpy(), x[1::3])


def test_grad_shardings_waits_for_the_mesh():
    # grad_shardings must be the params' (mesh, spec) shardings
    # (tests/test_torch_train_mesh.py drives the mesh step itself)
    with pytest.raises(ValueError, match="mesh"):
        TST.make_train_step(smoke_config("mamba2-370m"), TO.OptimizerConfig(),
                            grad_shardings={})


def test_train_entry_point_lowers_the_loss(capsys, tmp_path):
    assert TTRAIN.main(["--arch", "mamba2-370m", "--smoke", "--steps", "24",
                        "--batch", "4", "--seq", "16", "--distill",
                        "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    line = next(ln for ln in out.splitlines() if ln.startswith("[train]"))
    first, last = (float(v) for v in
                   line.split("loss ")[1].split(" on ")[0].split(" -> "))
    assert last < first, line
    assert "[distill] per-mode eval CE:" in out
    # the checkpoint flags run with a directory (the restart itself is held
    # to the uninterrupted run in tests/test_torch_checkpoint.py) and are a
    # usage error without one
    assert TTRAIN.main(["--arch", "mamba2-370m", "--smoke", "--steps", "4",
                        "--batch", "2", "--seq", "8", "--device", "cpu",
                        "--ckpt-dir", str(tmp_path / "ckpt"),
                        "--ckpt-every", "2", "--async-ckpt",
                        "--inject-failure-at", "3"]) == 0
    assert "restarts=1" in capsys.readouterr().out
    for flag in (["--async-ckpt"], ["--inject-failure-at", "3"],
                 ["--ckpt-every", "5"]):
        with pytest.raises(SystemExit):
            TTRAIN.main(["--arch", "mamba2-370m", "--smoke", "--device", "cpu",
                         *flag])


# ---------------------------------------------------------------------------
# the SSD scan's backward
# ---------------------------------------------------------------------------


def _scan_args(b, s, h, p, g, n, seed=0, dt_const=None, A=None):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, s, h, p))
    # softplus-range steps, scaled so that no 64-step tile's decay reaches
    # the reference's overflow (test_ssd_grads_stay_finite_... goes past it)
    dt = (np.full((b, s, h), dt_const) if dt_const is not None
          else 0.2 * np.log1p(np.exp(rng.standard_normal((b, s, h)))))
    A = (np.asarray(A, np.float64) if A is not None
         else -(0.5 + rng.random(h)))
    B_ = rng.standard_normal((b, s, g, n))
    C_ = rng.standard_normal((b, s, g, n))
    dy = rng.standard_normal((b, s, h, p))
    ds = rng.standard_normal((b, h, p, n))
    return [a.astype(np.float32) for a in (x, dt, A, B_, C_, dy, ds)]


def _autograd(fn, x, dt, A, B_, C_, dy, ds, dtype=torch.float32):
    ins = [torch.tensor(a, dtype=dtype, requires_grad=True)
           for a in (x, dt, A, B_, C_)]
    y, st = fn(*ins)
    ((y * torch.tensor(dy, dtype=dtype)).sum()
     + (st * torch.tensor(ds, dtype=dtype)).sum()).backward()
    return [t.grad for t in ins]


def _plain(x, dt, A, B_, C_, dy, ds):
    b, h = x.shape[0], x.shape[2]
    t = [torch.from_numpy(a) for a in (x, dt, A, B_, C_, dy, ds)]
    dx, ddt, dA_bh, dB, dC = TSSD.ssd_scan_bwd_plain(
        t[0], t[1], t[2].expand(b, h), t[3], t[4], t[5], t[6])
    return [dx, ddt, dA_bh.sum(0), dB, dC]


def _assert_scaled(got, want, rtol=1e-4, what=""):
    for name, g, w in zip(("dx", "ddt", "dA", "dB", "dC"), got, want):
        g, w = np.asarray(g, np.float64), np.asarray(w, np.float64)
        assert np.isfinite(g).all(), (what, name)
        scale = max(float(np.abs(w).max()), 1.0)
        np.testing.assert_allclose(g, w, atol=rtol * scale, rtol=rtol,
                                   err_msg=f"{what} {name}")


@pytest.mark.parametrize("shape", [(2, 40, 4, 8, 2, 6, 16),
                                   (1, 130, 2, 16, 1, 16, 64)],
                         ids=["ragged-g2", "3-tiles"])
def test_ssd_scan_bwd_plain_matches_autograd_and_jax(shape):
    """At smoke shapes: a ragged 40 steps in one 64-step tile with two
    groups, and three tiles (the last ragged) with one group."""
    b, s, h, p, g, n, chunk = shape
    args = _scan_args(b, s, h, p, g, n)
    got = _plain(*args)
    want = _autograd(lambda x, dt, A, B_, C_: TSSD.ssd_chunked(
        x, dt, A, B_, C_, chunk), *args)
    _assert_scaled(got, [t.numpy() for t in want], what="vs autograd")

    def jloss(x, dt, A, B_, C_):
        y, st = JSSM.ssd_chunked(x, dt, A, B_, C_, chunk)
        return jnp.sum(y * args[5]) + jnp.sum(st * args[6])

    jg = jax.jit(jax.grad(jloss, argnums=(0, 1, 2, 3, 4)))(
        *(jnp.asarray(a) for a in args[:5]))
    _assert_scaled(got, [np.asarray(t) for t in jg], what="vs jax.grad")


def _sequential(x, dt, A, B_, C_):
    """The step-by-step recurrence, in the inputs' dtype."""
    b, s, h, p = x.shape
    rep = h // B_.shape[2]
    Bh, Ch = (t.repeat_interleave(rep, dim=2) for t in (B_, C_))
    st = torch.zeros((b, h, p, B_.shape[3]), dtype=x.dtype)
    ys = []
    for t in range(s):
        st = (st * torch.exp(dt[:, t] * A)[..., None, None]
              + torch.einsum("bhp,bhn->bhpn", x[:, t] * dt[:, t, :, None],
                             Bh[:, t]))
        ys.append(torch.einsum("bhpn,bhn->bhp", st, Ch[:, t]))
    return torch.stack(ys, dim=1), st


def test_ssd_grads_stay_finite_past_a_tile_decay_of_88():
    """Chunk 256, dt = 0.5, A = (-1, -4): a chunk's decay reaches 128 and
    512. The masked ``ssd_chunked`` and the plain backward give finite
    gradients that match float64 autograd through the sequential
    recurrence (the reference's ``jax.grad`` gives NaN for dt and A here:
    ROADMAP section C)."""
    args = _scan_args(1, 256, 2, 4, 1, 3, seed=4, dt_const=0.5, A=[-1.0, -4.0])
    assert 0.5 * 256 * 1.0 > 88
    want = _autograd(_sequential, *args, dtype=torch.float64)
    want = [t.numpy() for t in want]
    got = _autograd(lambda x, dt, A, B_, C_: TSSD.ssd_chunked(
        x, dt, A, B_, C_, 256), *args)
    _assert_scaled([t.numpy() for t in got], want, what="ssd_chunked")
    _assert_scaled(_plain(*args), want, what="ssd_scan_bwd_plain")


# ---------------------------------------------------------------------------
# no silent gradient drop through a kernel
# ---------------------------------------------------------------------------


def _needs_grad(*shape):
    return torch.zeros(shape, requires_grad=True)


def test_kernel_launches_refuse_autograd():
    """A launch with no backward raises under autograd before it looks at
    the device, so the CPU can check it; under ``no_grad`` it goes on to
    its device check."""
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import flash_decode as FDK
    from repro_torch.kernels import fused_decode as FD
    from repro_torch.kernels import morph_matmul as MM

    q = _needs_grad(1, 4, 2, 8)
    cases = {
        "morph_matmul": lambda: MM.launch(_needs_grad(1, 2, 4),
                                          torch.zeros(4, 3),
                                          torch.zeros(1, 2, 3), None, None,
                                          round_w=False),
        "flash_attention": lambda: FA.launch(q, q, q, torch.zeros(1, 4, 2, 8),
                                             causal=True, window=0),
        "flash_decode": lambda: FDK.launch(_needs_grad(2, 8),
                                           torch.zeros(1, 4, 8),
                                           torch.zeros(1, 4, 8),
                                           torch.tensor([3])),
        "fused_decode": lambda: FD._fused_decode_cuda(
            {k: _needs_grad(2, 2) for k in ("wq", "wk", "wv", "wo")},
            torch.zeros(1, 1, 2), {}, None, None, None, None, None, 0, 0),
        "fused_verify": lambda: FD._fused_verify_cuda(
            {k: _needs_grad(2, 2) for k in ("wq", "wk", "wv", "wo")},
            torch.zeros(1, 2, 2), {}, None, None, None, None, None, None,
            None, 0, 0),
        "ssd_scan.launch_bshn": lambda: TSSD.launch_bshn(
            _needs_grad(1, 4, 2, 2), torch.zeros(1, 4, 2), torch.zeros(1, 2),
            torch.zeros(1, 4, 1, 3), torch.zeros(1, 4, 1, 3)),
    }
    for name, call in cases.items():
        with pytest.raises(RuntimeError, match="no backward"):
            call()
    with torch.no_grad(), pytest.raises(ValueError, match="CUDA"):
        cases["morph_matmul"]()
