"""The port's SSM family (mamba2) against the JAX package, on the CPU.

Same weights in both packages (JAX init, converted through numpy with
``params_from_jax``), inputs from numpy seeds, the f32 smoke config of
``mamba2-370m`` (3 layers, d_model 64, 8 SSD heads of 16, state 16, one
group, chunk 16, exit at group 1). Tolerances, all in f32:

* the SSD scan (port ``ssd_scan_plain`` / ``ops.ssd_scan_bshn``) against
  JAX's Pallas ``ssd_scan`` in interpret mode, ``ssd_chunked`` and the
  sequential oracle ``ssd_scan_ref``: atol / rtol 1e-4 (summation order
  only; the oracle sums step by step, so 1e-3 against it, as
  ``tests/test_kernels.py`` holds JAX to it);
* layers and model (``ssm_forward``, ``ssm_decode_step``, ``ssm_verify_step``,
  ``prefill``, ``decode_step``, ``verify_step`` + ``commit_verify``):
  atol 1e-4 on logits, outputs and every cache leaf;
* engines: greedy streams token-identical to JAX's ``ServingEngine`` (plain
  and speculative) on one trace with width and depth switches, where every
  top-1 margin that picked a token exceeds the logit tolerance tenfold.
"""
import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import smoke_config as jax_smoke_config
from repro.core import elastic as jax_elastic
from repro.kernels import ops as JOPS
from repro.kernels import ref as JREF
from repro.kernels.ssd_scan import ssd_scan as jax_ssd_scan
from repro.models import model as JM
from repro.models import ssm as JSSM
from repro.runtime import serving as JS
from repro.runtime import speculative as JSP
from repro_torch.configs import smoke_config
from repro_torch.convert import cache_from_jax, params_from_jax, to_numpy
from repro_torch.core import elastic
from repro_torch.kernels import ops as TOPS
from repro_torch.kernels import ref as TREF
from repro_torch.kernels import ssd_scan as TSSD
from repro_torch.models import model as TM
from repro_torch.models import ssm as TSSM
from repro_torch.runtime import serving as TS
from repro_torch.runtime import speculative as TSP
from torch_threads import one_thread  # noqa: E402,F401  (autouse)

ARCH = "mamba2-370m"
ATOL = 1e-4
JCFG = jax_smoke_config(ARCH)
TCFG = smoke_config(ARCH)


def _close(got, want, atol=ATOL, rtol=ATOL, msg=""):
    np.testing.assert_allclose(to_numpy(got), np.asarray(want, np.float32),
                               atol=atol, rtol=rtol, err_msg=msg)


@pytest.fixture(scope="module")
def jax_params():
    init = jax.jit(JM.init_params, static_argnums=1)
    return jax.device_get(init(jax.random.PRNGKey(0), JCFG))


# ---------------------------------------------------------------------------
# the SSD scan
# ---------------------------------------------------------------------------


def _scan_inputs(b, s, h, p, g, n, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, s, h, p)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((b, s, h)))).astype(np.float32)
    A = -np.exp(rng.standard_normal(h)).astype(np.float32)
    B_ = rng.standard_normal((b, s, g, n)).astype(np.float32)
    C_ = rng.standard_normal((b, s, g, n)).astype(np.float32)
    return x, dt, A, B_, C_


def _flat(x, dt, A, B_, C_):
    """Model layout -> the kernel's per-(batch, head) layout, B and C
    repeated per head (as the JAX ``ssd_scan_bshn`` does)."""
    b, s, h, p = x.shape
    rep = h // B_.shape[2]
    Bh, Ch = np.repeat(B_, rep, axis=2), np.repeat(C_, rep, axis=2)
    n = B_.shape[3]
    return (x.transpose(0, 2, 1, 3).reshape(b * h, s, p),
            dt.transpose(0, 2, 1).reshape(b * h, s),
            np.broadcast_to(A, (b, h)).reshape(b * h).copy(),
            Bh.transpose(0, 2, 1, 3).reshape(b * h, s, n),
            Ch.transpose(0, 2, 1, 3).reshape(b * h, s, n))


def _t(*arrays):
    return tuple(torch.from_numpy(np.ascontiguousarray(a)) for a in arrays)


_jchunked = jax.jit(JSSM.ssd_chunked, static_argnums=5)
_jref = jax.jit(JREF.ssd_scan_ref)

# (b, s, h, p, g, n, chunk): s a multiple of the chunk and not; g 1 and 2
SCAN_CASES = [(2, 32, 4, 8, 1, 8, 16), (2, 27, 4, 8, 2, 8, 16),
              (1, 9, 8, 16, 1, 16, 16)]


@pytest.mark.parametrize("case", SCAN_CASES,
                         ids=lambda c: "b{}s{}h{}p{}g{}n{}q{}".format(*c))
def test_ssd_scan_matches_jax(case):
    b, s, h, p, g, n, chunk = case
    ins = _scan_inputs(b, s, h, p, g, n)
    y, fs = TOPS.ssd_scan_bshn(*_t(*ins), chunk=chunk)
    # JAX's chunked oracle pads a ragged length itself
    jy, jfs = _jchunked(*map(jnp.asarray, ins), chunk)
    _close(y, jy, msg="y vs ssd_chunked")
    _close(fs, jfs, msg="state vs ssd_chunked")
    # the Pallas kernel (interpret mode) takes whole chunks: zero-pad
    pad = -s % chunk
    padded = [np.pad(a, [(0, 0), (0, pad)] + [(0, 0)] * (a.ndim - 2))
              if a.ndim > 1 else a for a in ins]
    py, pfs = JOPS.ssd_scan_bshn(*map(jnp.asarray, padded), chunk=chunk,
                                 interpret=True)
    _close(y, np.asarray(py)[:, :s], msg="y vs Pallas")
    _close(fs, pfs, msg="state vs Pallas")
    # the kernel's own layout: plain version vs Pallas and both oracles
    flat = _flat(*ins)
    ty, tfs = TSSD.ssd_scan(*_t(*flat), chunk=chunk)
    if s % min(chunk, s) == 0:
        ky, kfs = jax_ssd_scan(*map(jnp.asarray, flat), chunk=chunk,
                               interpret=True)
        _close(ty, ky, msg="flat y vs Pallas")
        _close(tfs, kfs, msg="flat state vs Pallas")
    ry, rfs = TREF.ssd_scan_ref(*_t(*flat))
    jry, jrfs = _jref(*map(jnp.asarray, flat))
    _close(ry, jry, msg="port oracle vs JAX oracle")
    _close(rfs, jrfs, msg="port oracle state vs JAX oracle")
    _close(ty, jry, atol=1e-3, rtol=1e-3, msg="flat y vs oracle")
    _close(tfs, jrfs, atol=1e-3, rtol=1e-3, msg="flat state vs oracle")
    ry2, rfs2 = TSSM.ssd_reference(*_t(*ins))
    _close(ry2, jy, atol=1e-3, rtol=1e-3, msg="ssd_reference")
    _close(rfs2, jfs, atol=1e-3, rtol=1e-3, msg="ssd_reference state")


def test_ssd_scan_padding_changes_nothing():
    """A padded step (dt = 0, x = 0) decays by 1 and adds nothing: y at the
    real positions and the final state equal the unpadded scan's."""
    b, s, h, p, g, n, chunk = 2, 21, 4, 8, 2, 8, 16
    ins = _t(*_scan_inputs(b, s, h, p, g, n, seed=3))
    y, fs = TOPS.ssd_scan_bshn(*ins, chunk=chunk)
    x, dt, A, B_, C_ = ins
    rng = np.random.default_rng(4)
    pad = 11  # junk B and C on the padded steps must not matter either
    xp = torch.cat([x, torch.zeros(b, pad, h, p)], 1)
    dtp = torch.cat([dt, torch.zeros(b, pad, h)], 1)
    Bp = torch.cat([B_, torch.from_numpy(
        rng.standard_normal((b, pad, g, n)).astype(np.float32))], 1)
    Cp = torch.cat([C_, torch.from_numpy(
        rng.standard_normal((b, pad, g, n)).astype(np.float32))], 1)
    yp, fsp = TOPS.ssd_scan_bshn(xp, dtp, A, Bp, Cp, chunk=chunk)
    torch.testing.assert_close(yp[:, :s], y, atol=ATOL, rtol=ATOL)
    torch.testing.assert_close(fsp, fs, atol=ATOL, rtol=ATOL)
    assert float(yp[:, s:].abs().max()) > 0  # padded rows still read C


# ---------------------------------------------------------------------------
# the SSM block
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def block_params():
    init = jax.jit(JSSM.init_ssm, static_argnums=1)
    jp = jax.device_get(init(jax.random.PRNGKey(1), JCFG))
    return jp, params_from_jax(jp, device="cpu")


def _block_cache(batch, seed):
    rng = np.random.default_rng(seed)
    c = jax.device_get(JSSM.init_ssm_cache(JCFG, batch))
    return {k: rng.standard_normal(np.shape(v)).astype(np.float32)
            for k, v in c.items()}


def test_ssm_forward_matches_jax(block_params):
    jp, tp = block_params
    x = np.random.default_rng(2).standard_normal(
        (2, 37, JCFG.d_model)).astype(np.float32)
    fwd = jax.jit(JSSM.ssm_forward, static_argnames=("cfg", "return_state"))
    jy, ((jxt, jbt), jst) = fwd(jp, jnp.asarray(x), cfg=JCFG,
                                return_state=True)
    ty, ((txt, tbt), tst) = TSSM.ssm_forward(tp, torch.from_numpy(x), TCFG,
                                             return_state=True)
    for got, want, name in ((ty, jy, "y"), (txt, jxt, "conv_x"),
                            (tbt, jbt, "conv_bc"), (tst, jst, "state")):
        _close(got, want, msg=name)


def test_ssm_decode_step_matches_jax_mixed_widths(block_params):
    jp, tp = block_params
    widths = [0.5, 1.0, 0.5]
    ja = jax_elastic.active_widths_batch(JCFG, widths)
    ta = elastic.active_widths_batch(TCFG, widths, device="cpu")
    cache = _block_cache(3, 5)
    tcache = {k: torch.from_numpy(v.copy()) for k, v in cache.items()}
    jcache = {k: jnp.asarray(v) for k, v in cache.items()}
    rng = np.random.default_rng(6)
    step = jax.jit(JSSM.ssm_decode_step, static_argnames=("cfg",))
    for t in range(3):
        x = rng.standard_normal((3, 1, JCFG.d_model)).astype(np.float32)
        jy, jcache = step(jp, jnp.asarray(x), jcache, cfg=JCFG, active=ja)
        ty, out = TSSM.ssm_decode_step(tp, torch.from_numpy(x), tcache, TCFG,
                                       active=ta)
        assert out is tcache  # written in place
        _close(ty, jy, msg=f"y step {t}")
        for k in cache:
            _close(tcache[k], jcache[k], msg=f"{k} step {t}")


def test_ssm_verify_step_matches_jax_and_reads_only(block_params):
    jp, tp = block_params
    widths = [1.0, 0.5]
    ja = jax_elastic.active_widths_batch(JCFG, widths)
    ta = elastic.active_widths_batch(TCFG, widths, device="cpu")
    cache = _block_cache(2, 7)
    tcache = {k: torch.from_numpy(v.copy()) for k, v in cache.items()}
    x = np.random.default_rng(8).standard_normal(
        (2, 4, JCFG.d_model)).astype(np.float32)
    verify = jax.jit(JSSM.ssm_verify_step, static_argnames=("cfg",))
    jy, jc = verify(jp, jnp.asarray(x),
                    {k: jnp.asarray(v) for k, v in cache.items()}, cfg=JCFG,
                    active=ja)
    ty, tc = TSSM.ssm_verify_step(tp, torch.from_numpy(x), tcache, TCFG,
                                  active=ta)
    _close(ty, jy, msg="y")
    for k in jc:
        _close(tc[k], jc[k], msg=k)
    for k, v in cache.items():
        np.testing.assert_array_equal(tcache[k].numpy(), v)
    # a chain tree (one child a level) is the linear window: the tree pass
    # gives the verify step's outputs and per-step candidates
    from repro_torch.runtime.speculative import tree_topology

    yt, ct = TSSM.ssm_verify_tree(tp, torch.from_numpy(x), tcache, TCFG,
                                  tree_topology((1, 1, 1)), active=ta)
    _close(yt, ty, msg="chain tree y")
    for k in tc:
        _close(ct[k], tc[k], msg=f"chain tree {k}")


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------


_jprefill = jax.jit(JM.prefill, static_argnames=(
    "cfg", "cache_extra", "per_slot", "slot", "n_slots", "depth"))
_jdecode = jax.jit(JM.decode_step, static_argnames=("cfg", "depth"))
_jverify = jax.jit(JM.verify_step, static_argnames=("cfg", "depth"))
_jcommit = jax.jit(JM.commit_verify, static_argnames=("cfg",))


def _assert_cache_close(tc, jc, msg):
    got, want = to_numpy(tc), jax.device_get(jc)
    np.testing.assert_array_equal(got["pos"], np.asarray(want["pos"]))
    for pn, layer in want["stack"].items():
        assert set(got["stack"][pn]) == set(layer)
        for k, a in layer.items():
            np.testing.assert_allclose(
                got["stack"][pn][k], np.asarray(a, np.float32), atol=ATOL,
                rtol=ATOL, err_msg=f"{msg} cache {pn}/{k}")


def test_prefill_and_decode_match_jax(jax_params):
    """prefill logits and the packed cache (conv tails, state) at full depth
    and at exit 1, slot-scattered; then decode steps at mixed widths."""
    tp = params_from_jax(jax_params, device="cpu")
    ja = jax_elastic.active_widths_batch(JCFG, [0.5, 1.0])
    ta = elastic.active_widths_batch(TCFG, [0.5, 1.0], device="cpu")
    prompt = np.random.default_rng(9).integers(
        1, JCFG.vocab_size, (1, 21)).astype(np.int32)
    rng = np.random.default_rng(10)
    for depth in (1, JCFG.n_groups):
        jl, jc = _jprefill(jax_params, {"tokens": jnp.asarray(prompt)},
                           cfg=JCFG, cache_extra=4, per_slot=True, slot=1,
                           n_slots=2, depth=depth)
        tl, tc = TM.prefill(tp, {"tokens": torch.from_numpy(prompt).long()},
                            TCFG, cache_extra=4, per_slot=True, slot=1,
                            n_slots=2, depth=depth)
        _close(tl, jl, msg=f"prefill logits depth {depth}")
        _assert_cache_close(tc, jc, f"prefill depth {depth}")
        for t in range(3):
            tok = rng.integers(1, JCFG.vocab_size, (2, 1)).astype(np.int32)
            jl, jc = _jdecode(jax_params, jc, jnp.asarray(tok), cfg=JCFG,
                              depth=depth, active=ja)
            tl, tc = TM.decode_step(tp, tc, torch.from_numpy(tok).long(),
                                    TCFG, depth=depth, active=ta)
            _close(tl, jl, msg=f"decode depth {depth} step {t}")
        _assert_cache_close(tc, jc, f"decode depth {depth}")


def test_init_params_matches_jax_layout(jax_params):
    """Same tree, shapes and dtypes as JAX's init; the fan-in scaled
    weights match JAX's spread, the SSM rates JAX's ranges."""
    tp = TM.init_params(TCFG, seed=0, device="cpu")

    def walk(a, b, path=""):
        assert set(a) == set(b), path
        for k in a:
            if isinstance(a[k], dict):
                walk(a[k], b[k], f"{path}/{k}")
                continue
            assert tuple(b[k].shape) == np.shape(a[k]), f"{path}/{k}"
            assert str(b[k].dtype).endswith(str(np.asarray(a[k]).dtype))
            if np.size(a[k]) >= 1024:
                sa, sb = float(np.std(a[k])), float(b[k].float().std())
                assert abs(sa - sb) <= 0.1 * max(sa, 1e-6) + 1e-6, \
                    f"{path}/{k}"

    walk(jax_params, tp)
    ssm = tp["stack"]["pos0"]["ssm"]
    a = torch.exp(ssm["A_log"])
    assert bool(((a >= 1.0) & (a < 16.0)).all())
    dt = torch.nn.functional.softplus(ssm["dt_bias"])
    assert bool(((dt >= 1e-3 - 1e-6) & (dt <= 0.1 + 1e-6)).all())
    assert bool((ssm["D"] == 1).all()) and bool((ssm["conv_x_b"] == 0).all())


def test_reset_zeroes_recurrent_state_and_readmission_is_fresh(jax_params):
    tp = params_from_jax(jax_params, device="cpu")
    cache = TM.init_decode_cache(TCFG, 2, 8, per_slot=True, device="cpu")
    for t in (9, 13, 5):  # two occupants
        _, cache = TM.decode_step(tp, cache, torch.tensor([[t], [t + 1]]),
                                  TCFG)
    out = TM.reset_cache_slots(cache, np.array([False, True]))
    assert out is cache and cache["pos"].tolist() == [3, 0]
    for layer in cache["stack"].values():
        for k, a in layer.items():
            assert bool((a[:, 1] == 0).all()), k  # slot 1 zeroed
            assert bool((a[:, 0] != 0).any()), k  # slot 0 kept
    fresh = TM.init_decode_cache(TCFG, 1, 8, per_slot=True, device="cpu")
    for t in (4, 2):  # the re-admitted slot decodes as a fresh batch-1 cache
        lg, cache = TM.decode_step(tp, cache, torch.tensor([[7], [t]]), TCFG)
        lf, fresh = TM.decode_step(tp, fresh, torch.tensor([[t]]), TCFG)
        torch.testing.assert_close(lg[1], lf[0], atol=1e-5, rtol=1e-5)
    TM.reset_cache_slot(cache, 0)
    assert cache["pos"].tolist() == [0, 2]


def test_verify_and_commit_match_jax(jax_params):
    tp = params_from_jax(jax_params, device="cpu")
    ja = jax_elastic.active_widths_batch(JCFG, [0.5, 1.0])
    ta = elastic.active_widths_batch(TCFG, [0.5, 1.0], device="cpu")
    jcache = JM.init_decode_cache(JCFG, 2, 16, per_slot=True)
    for t in range(3):
        _, jcache = _jdecode(jax_params, jcache,
                             jnp.asarray([[3 + t], [5 + t]], jnp.int32),
                             cfg=JCFG, depth=JCFG.n_groups, active=ja)
    jcache0 = jax.device_get(jcache)
    window = np.array([[2, 9, 4, 6], [7, 3, 2, 1]], np.int32)
    for depth in (1, JCFG.n_groups):
        jl, jpend = _jverify(jax_params, jcache, jnp.asarray(window),
                             cfg=JCFG, depth=depth, active=ja)
        tc = cache_from_jax(jcache0, device="cpu")
        tl, tpend = TM.verify_step(tp, tc, torch.from_numpy(window).long(),
                                   TCFG, depth=depth, active=ta)
        _close(tl, jl, msg=f"verify logits depth {depth}")
        for pn, layer in jax.device_get(jpend["stack"]).items():
            for k, a in layer.items():
                _close(tpend["stack"][pn][k], a, msg=f"pending {pn}/{k}")
        n_acc = np.array([1, 3], np.int32)
        jc = _jcommit(jcache, jpend, jnp.asarray(n_acc), cfg=JCFG)
        out = TM.commit_verify(tc, tpend, torch.from_numpy(n_acc), TCFG)
        assert out is tc
        _assert_cache_close(tc, jc, f"commit depth {depth}")


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------

SCHEDULE = ("d3w100", "d3w50", "d1w100", "d3w100", "d1w50", "d3w50")
SPEC = dict(ks=(3,), min_accept_rate=0.0)
ENGINE = dict(batch_size=3, cache_capacity=24, prefill_threshold=3)


def _drive(engine, reqs):
    """One request submitted per tick and the admission mode moved every
    tick along SCHEDULE, so slots of one depth run at different widths."""
    pending = list(reqs)
    while pending or engine.queue or engine.n_active:
        if pending:
            engine.submit(pending.pop(0))
        sched = SCHEDULE[engine.step_count % len(SCHEDULE)]
        engine.set_admission_mode(engine.ctrl.mode_by_name[sched])
        engine.step()
    return {r.rid: list(r.generated) for r in reqs}


def _trace():
    return JS.poisson_trace(7, 100.0, seed=5, prompt_len=(1, 6),
                            new_tokens=(4, 10), vocab=JCFG.vocab_size)


@pytest.fixture(scope="module")
def jax_streams(jax_params):
    out = {}
    for name, spec in (("plain", None), ("spec", JSP.SpecConfig(**SPEC))):
        eng = JS.ServingEngine(jax_params, JCFG, speculative=spec, **ENGINE)
        eng.warmup()
        out[name] = _drive(eng, copy.deepcopy(_trace()))
        assert eng.prefills > 0
    return out


def _margin_spy(eng):
    """Record the top-1 margin of every logit row that picked a token."""
    margins = []

    def top1(rows):
        top = torch.topk(rows[..., : TCFG.vocab_size].float(), 2, dim=-1)
        margins.append(float((top.values[..., 0] - top.values[..., 1]).min()))

    timed, pre = eng.ctrl.timed_step, eng._prefill_launch
    accept = TSP.accept_speculative

    def timed_step(*a, **k):
        out = timed(*a, **k)
        g = eng.groups[k["mode"].depth]
        top1(out[0][[i for i, r in enumerate(g.slots) if r is not None]])
        return out

    def prefill_launch(*a, **k):
        logits = pre(*a, **k)
        top1(logits)
        return logits

    def accept_spy(logits, *a, **k):
        out, n_acc = accept(logits, *a, **k)
        for i in range(logits.shape[0]):
            top1(logits[i, : int(n_acc[i]) + 1])
        return out, n_acc

    eng.ctrl.timed_step, eng._prefill_launch = timed_step, prefill_launch
    return margins, accept_spy


def test_engine_streams_match_jax(jax_params, jax_streams, monkeypatch):
    """Greedy plain and linear-speculative serving are token-identical to
    JAX's engines, the speculative one to plain decode too, and nothing is
    built after warmup."""
    tp = params_from_jax(jax_params, device="cpu")
    plain = TS.ServingEngine(tp, TCFG, device="cpu", **ENGINE)
    plain.warmup()
    m_plain, _ = _margin_spy(plain)
    got_plain = _drive(plain, copy.deepcopy(_trace()))
    assert got_plain == jax_streams["plain"]
    assert plain.prefills > 0 and len(plain.admission_switch_log) >= 3
    assert plain.ctrl.stats["compiles"] == plain.compiles_after_warmup

    eng = TS.ServingEngine(tp, TCFG, device="cpu",
                           speculative=TSP.SpecConfig(**SPEC), **ENGINE)
    eng.warmup()
    built = eng.ctrl.trace_counter["n"]
    m_spec, spy = _margin_spy(eng)
    monkeypatch.setattr(TSP, "accept_speculative", spy)
    got = _drive(eng, copy.deepcopy(_trace()))
    assert got == jax_streams["spec"] == got_plain
    assert min(m_plain + m_spec) > 10 * ATOL, min(m_plain + m_spec)
    assert eng.spec_verify_launches > 0
    assert eng.ctrl.stats["compiles"] == eng.compiles_after_warmup
    assert eng.ctrl.trace_counter["n"] == built


def test_serve_cli_mamba2_on_cpu(capsys):
    from repro_torch.launch.serve import main

    for extra in ([], ["--spec-k", "2"]):
        assert main(["--arch", ARCH, "--smoke", "--batch", "2", "--tokens",
                     "12", "--switch-every", "3", "--device", "cpu"]
                    + extra) == 0
        out = capsys.readouterr().out
        assert "recompiles_after_warmup=0" in out and "completed=" in out
        if extra:
            assert "spec d3<-d1k2" in out


def test_check_width_rejects_widths_not_dividing_ssm_heads():
    from repro.core.elastic import check_width as jax_check_width

    for w in (0.5, 0.25, 1.0):
        elastic.check_width(TCFG, w)
        jax_check_width(JCFG, w)
    for w in (0.3, 0.2):
        with pytest.raises(ValueError, match="ssm heads"):
            elastic.check_width(TCFG, w)
        with pytest.raises(ValueError, match="ssm heads"):
            jax_check_width(JCFG, w)
    assert elastic.active_widths(TCFG, 0.5) == {"d_inner": 64,
                                                "ssm_heads": 4}


def test_tf32_split_error_is_far_below_f32_tolerance():
    """The scan kernels' 3xTF32 operand split (``csrc/ssd_scan.cu``: hi =
    tf32(a) by cvt.rna, lo = tf32(a - hi)): |a - hi - lo| <= 2^-22 |a|, and
    hi alone keeps 10 mantissa bits (nearest, ties away from zero)."""
    def tf32(a):
        i = a.contiguous().view(torch.int32)
        return ((i + 0x1000) & ~0x1FFF).view(torch.float32)

    rng = np.random.default_rng(3)
    a = torch.from_numpy((rng.standard_normal(100_000)
                          * np.exp(rng.uniform(-20, 20, 100_000))).astype(
        np.float32))
    hi = tf32(a)
    lo = tf32(a - hi)
    assert ((a - hi - lo).abs() / a.abs()).max().item() <= 2.0 ** -22
    assert ((a - hi).abs() / a.abs()).max().item() <= 2.0 ** -11
    assert tf32(torch.tensor([1.0 + 2.0 ** -11])).item() == 1.0 + 2.0 ** -10
    assert tf32(torch.tensor([-(1.0 + 2.0 ** -11)])).item() == -(1.0 + 2.0 ** -10)
