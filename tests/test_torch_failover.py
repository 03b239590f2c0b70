"""Failover in the port: snapshot/restore with chunked replay, the
ExecutorSupervisor chaos drives, and the SLO catch-up, held to the JAX
package where a counterpart exists.

* ``FailurePlan``, ``StragglerMonitor``, ``ModeTelemetry`` and the SLO
  catch-up penalty give the JAX objects' answers on the same inputs.
* ``ServingEngine.snapshot`` / ``restore`` mid-flight (dense and paged,
  prefilled, token-fed and narrow slots, linear speculation), repeated
  restores, the geometry and encoder-decoder refusals, and the chunked
  replay (fewer launches than a one-token lockstep, the same streams and
  counters as the uninterrupted run).
* Chaos drives through ``ExecutorSupervisor``, each with three planned
  failures at distinct launch sites, all firing: streams equal to the
  fault-free run's, no request dropped or completed twice, exact
  counters; dense linear, paged tree (page refcounts audited), fused, and
  Mamba2 linear. One drive runs JAX's supervisor and the port's on the
  same weights, trace and plan.
* ``launch.serve --fail-at`` and ``--deadline-s`` on the CPU.

Smoke configs (f32), 3 slots, capacity 32, prefill threshold 4, as the
JAX package's ``tests/test_chaos.py``.
"""
import re

import jax
import numpy as np
import pytest

from repro.configs import smoke_config as jax_smoke_config
from repro.core import morph as JMO
from repro.models import model as JM
from repro.runtime import fault_tolerance as JFT
from repro.runtime import serving as JS
from repro.runtime import speculative as JSP
from repro_torch.configs import smoke_config
from repro_torch.convert import params_from_jax
from repro_torch.core import morph as TMO
from repro_torch.launch import serve as TSERVE
from repro_torch.models.model import init_params
from repro_torch.models.paged import PagedLayout
from repro_torch.runtime import fault_tolerance as TFT
from repro_torch.runtime import serving as TS
from repro_torch.runtime.observability import Observability
from repro_torch.runtime.speculative import SpecConfig
from torch_threads import one_thread  # noqa: E402,F401  (autouse)

CFG = smoke_config("tinyllama-1.1b")
PARAMS = init_params(CFG, seed=0, device="cpu")
KW = dict(batch_size=3, cache_capacity=32, prefill_threshold=4, device="cpu")


@pytest.fixture(scope="module")
def jax_model():
    jcfg = jax_smoke_config("tinyllama-1.1b")
    return jcfg, JM.init_params(jax.random.PRNGKey(0), jcfg)


def _factory(cfg=CFG, params=PARAMS, **kw):
    def make():
        eng = TS.ServingEngine(params, cfg, **KW, **kw)
        eng.warmup()
        return eng
    return make


def _trace(cfg=CFG, n=10, seed=5, mod=TS):
    # rate 1e6: every arrival lands at t ~ 0, so the admission and tick
    # sequence does not depend on measured step times and a chaos run walks
    # the fault-free run's schedule
    return mod.poisson_trace(n, rate_per_s=1e6, seed=seed,
                             vocab=cfg.vocab_size, prompt_len=(1, 9),
                             interactive_frac=0.3)


def _streams(eng):
    return {r.rid: tuple(r.generated) for r in eng.completed}


def _counters(eng):
    return (eng.step_count, eng.decode_launches, eng.prefills,
            eng.spec_verify_launches, eng.spec_generated_tokens)


def _drain(eng):
    while eng.queue or eng.n_active:
        eng.step()
        eng.check_paged_invariants()
    return _streams(eng)


# ---------------------------------------------------------------------------
# primitives, held to the JAX objects
# ---------------------------------------------------------------------------


def _plan_log(mod):
    """Raise / pass outcomes of one scripted sequence of plan calls."""
    plan = mod.FailurePlan(at_steps=(3, 5),
                           at_sites=(("verify", 2), ("decode", 1)))
    log = []
    calls = ([("step", s) for s in range(8)] + [("step", 3), ("step", 5)]
             + [("site", s) for s in ("decode", "decode", "verify", "verify",
                                      "verify", "prefill")])
    for kind, arg in calls:
        try:
            (plan.maybe_fail if kind == "step" else plan.maybe_fail_site)(arg)
            log.append((kind, arg, None))
        except mod.SimulatedFailure as e:
            log.append((kind, arg, str(e)))
    return log, dict(plan.site_counts), plan.fired_sites


def test_failure_plan_matches_jax():
    got, want = _plan_log(TFT), _plan_log(JFT)
    assert got == want
    log, counts, fired = got
    assert sum(e is not None for _, _, e in log) == 4
    assert counts == {"decode": 2, "verify": 3, "prefill": 1}
    assert fired == {("decode", 1), ("verify", 2)}


def test_straggler_monitor_matches_jax():
    rng = np.random.default_rng(0)
    times = [100.0] + list(0.1 + 0.01 * rng.random(30)) + [0.5, 0.1, 0.9]
    t, j = TFT.StragglerMonitor(threshold=2.0), JFT.StragglerMonitor(
        threshold=2.0)
    assert [t.observe(i, s) for i, s in enumerate(times)] == \
        [j.observe(i, s) for i, s in enumerate(times)]
    assert t.flagged == j.flagged and t.flagged
    assert t.mitigations == j.mitigations


def test_mode_telemetry_state_round_trips_like_jax():
    rng = np.random.default_rng(1)
    samples = [(float(x), int(n)) for x, n in
               zip(rng.random(40), rng.integers(1, 4, 40))]
    t, j = TMO.ModeTelemetry(window=16), JMO.ModeTelemetry(window=16)
    for dt, n in samples:
        t.record(dt, n)
        j.record(dt, n)
    st = t.state_dict()
    assert st == j.state_dict()
    back = TMO.ModeTelemetry()
    back.load_state(st)
    assert back.state_dict() == st
    assert (back.p50_s, back.p95_s, back.tokens_per_s) == \
        (t.p50_s, t.p95_s, t.tokens_per_s)


def _catchup_decisions(mod, ctrl, cfg, recovery_ms, budgets, metrics=None):
    pol = mod.SLOPolicy(cfg, ctrl, batch_size=3, cache_capacity=32,
                        catchup_ticks=4, catchup_gamma=1.5, metrics=metrics)
    pol.note_failover(recovery_ms=recovery_ms)
    out = []
    for b in budgets:
        pol.choose(b, queue_depths={"interactive": 1, "batch": 2})
        d = pol.last_decision
        out.append((d["catchup_penalty"], d["effective_budget_s"]))
    return out


def test_catchup_penalty_matches_jax(jax_model):
    """The same recovery and budgets squeeze the effective budget as JAX's
    policy does for ``catchup_ticks`` decisions, then stop; the events land
    on the attached registry."""
    jcfg, jp = jax_model
    jctrl = JMO.make_serve_controller(jp, jcfg)
    tctrl = TMO.make_serve_controller(PARAMS, CFG)
    budgets = [0.01, 0.02, 0.005, 0.01, 0.01, 0.03]
    obs = Observability()
    got = _catchup_decisions(TS, tctrl, CFG, 37.5, budgets, obs.registry)
    want = _catchup_decisions(JS, jctrl, jcfg, 37.5, budgets)
    assert got == want
    assert [p > 0 for p, _ in got] == [True] * 4 + [False] * 2
    assert len(obs.registry.events("slo_catchup", ())) == 4


# ---------------------------------------------------------------------------
# snapshot / restore
# ---------------------------------------------------------------------------


def _mixed_trace(n=7):
    """Short and long prompts (token feed AND prefill), mixed classes."""
    return [TS.Request(rid=rid,
                       prompt=tuple(1 + (rid * 7 + j) % (CFG.vocab_size - 1)
                                    for j in range(1 + rid % 7)),
                       max_new_tokens=4 + rid % 3,
                       slo_class="interactive" if rid % 2 else "batch")
            for rid in range(n)]


@pytest.mark.parametrize("paged", [None, PagedLayout(page_size=4)],
                         ids=["dense", "paged"])
def test_snapshot_restore_mid_flight_is_exact(paged):
    """A snapshot with slots mid-generation (prefilled and token-fed, one
    NARROW) restores onto a fresh engine that finishes with the
    uninterrupted run's streams and counters."""
    make = _factory(paged=paged)
    ref = make()
    narrow, wide = ref.ctrl.modes[0], ref.ctrl.modes[-1]

    def drive_head(eng):
        trace = _mixed_trace()
        eng.set_admission_mode(eng.ctrl.mode_by_name[narrow.name])
        eng.submit(trace[0])
        eng.step()  # a narrow slot in flight: replay must keep its width
        eng.set_admission_mode(eng.ctrl.mode_by_name[wide.name])
        for r in trace[1:]:
            eng.submit(r)
        for _ in range(3):
            eng.step()

    drive_head(ref)
    ref_out = _drain(ref)
    a = make()
    drive_head(a)
    snap = a.snapshot()
    b = make()
    b.restore(snap)
    b.check_paged_invariants()
    assert (b.step_count, b.decode_launches, b.prefills) == \
        (a.step_count, a.decode_launches, a.prefills)
    assert b.admission_mode.name == a.admission_mode.name
    assert b.ctrl.telemetry_state() == a.ctrl.telemetry_state()
    for d, g in b.groups.items():
        ga = a.groups[d]
        assert [r.rid if r else None for r in g.slots] == \
            [r.rid if r else None for r in ga.slots]
        assert g.widths == ga.widths
        if g.paging is not None:
            for i, r in enumerate(g.slots):
                if r is not None:
                    assert g.paging.host_pos[i] == ga.paging.host_pos[i] \
                        == r.fed
            assert g.paging.budget == ga.paging.budget
    assert _drain(b) == ref_out
    assert _counters(b)[:3] == _counters(ref)[:3]


def test_snapshot_restore_with_speculation():
    """A speculative paged engine restores its draft shape and acceptance
    window and finishes with the uninterrupted streams and counters."""
    make = _factory(paged=PagedLayout(page_size=4),
                    speculative=SpecConfig(ks=(2,)))
    ref = make()
    for r in _mixed_trace():
        ref.submit(r)
    ref_out = _drain(ref)
    assert ref.spec_verify_launches > 0
    a = make()
    for r in _mixed_trace():
        a.submit(r)
    for _ in range(4):
        a.step()
    b = make()
    b.restore(a.snapshot())
    b.check_paged_invariants()
    ga, gb = a.groups[max(a.groups)], b.groups[max(b.groups)]
    assert (gb.spec_k, list(gb.accept_window)) == \
        (ga.spec_k, list(ga.accept_window))
    assert _drain(b) == ref_out
    assert _counters(b) == _counters(ref)


def test_restore_can_repeat_and_rewind():
    """One snapshot restores the SAME engine again and again, rewinding it
    to the capture point each time."""
    eng = _factory()()
    for r in _mixed_trace(4):
        eng.submit(r)
    for _ in range(2):
        eng.step()
    snap = eng.snapshot()
    first = _drain(eng)
    for _ in range(2):
        eng.restore(snap)
        assert _drain(eng) == first


def test_restore_validates_geometry_and_refuses_encdec():
    eng = _factory()()
    snap = eng.snapshot()
    with pytest.raises(ValueError, match="batch size"):
        TS.ServingEngine(PARAMS, CFG, batch_size=2, cache_capacity=32,
                         device="cpu").restore(snap)
    shallow = tuple(m for m in eng.ctrl.modes if m.depth == 1)
    with pytest.raises(ValueError, match="not in this engine's mode table"):
        TS.ServingEngine(PARAMS, CFG, **KW, modes=shallow).restore(snap)
    snap.admission_mode = shallow[0].name
    with pytest.raises(ValueError, match="depth groups"):
        TS.ServingEngine(PARAMS, CFG, **KW, modes=shallow).restore(snap)
    # a snapshot's autoscaler state: a bare standby holds it until an
    # autoscaler binds, which loads it
    from repro_torch.runtime.autoscale import AutoscaleConfig, Autoscaler

    asc = Autoscaler(AutoscaleConfig(pop_size=4, generations=1)).bind(eng)
    asc.generation = 3
    snap = eng.snapshot()
    asc.close()
    assert snap.autoscale["generation"] == 3
    standby = _factory()()
    standby.restore(snap)
    assert standby._pending_autoscale == snap.autoscale
    assert standby._pending_autoscale is not snap.autoscale
    asc2 = Autoscaler(AutoscaleConfig(pop_size=4, generations=1)).bind(standby)
    asc2.close()
    assert standby._pending_autoscale is None and asc2.generation == 3
    wcfg = smoke_config("whisper-base")
    whisper = TS.ServingEngine(init_params(wcfg, seed=0, device="cpu"), wcfg,
                               **KW)
    with pytest.raises(ValueError, match="token-only decoder"):
        whisper.snapshot()


@pytest.mark.parametrize("paged,spec", [
    (None, SpecConfig(ks=(2,))),
    (PagedLayout(page_size=4), SpecConfig(ks=(), trees=((2, 1),))),
], ids=["dense_linear", "paged_tree"])
def test_restore_replay_batching_exact(paged, spec):
    """Restore re-feeds committed history through the verify path in
    CHUNKS: fewer launches than the one-token lockstep, and the restored
    engine's continued streams and counters land on the uninterrupted
    run's."""
    make = _factory(paged=paged, speculative=spec)
    trace = _trace(n=8, seed=11)
    a = make()
    for r in trace:
        a.submit(r)
    for _ in range(8):
        a.step()
    snap = a.snapshot()
    b = make()
    d0 = b.ctrl.stats["dispatches"]
    b.restore(snap)
    lockstep = sum(max((r.fed - (len(r.prompt) if r.prefilled else 0)
                        for r in gs.slots if r is not None), default=0)
                   for gs in snap.groups.values())
    assert lockstep >= 2
    assert b.replay_chunk_launches > 0
    assert b.ctrl.stats["dispatches"] - d0 < lockstep
    b.check_paged_invariants()
    assert _drain(b) == _drain(a)
    assert _counters(a) == _counters(b)


# ---------------------------------------------------------------------------
# supervisor mechanics
# ---------------------------------------------------------------------------


def test_supervisor_timeout_with_an_injected_clock():
    """A tick whose wall time (on the injected clock) passes the timeout
    fails over although it completed; its results are discarded and the
    redo gives the uninterrupted streams."""
    short = [TS.Request(rid=rid, prompt=(1 + rid, 2 + rid), max_new_tokens=4)
             for rid in range(4)]
    ref = _factory()()
    for r in short:
        ref.submit(TS.Request(rid=r.rid, prompt=r.prompt, max_new_tokens=4))
    ref_out = _drain(ref)
    now = [0.0]
    obs = Observability(clock=lambda: now[0])
    slowed = []

    def slow_once(site):
        if not slowed:
            slowed.append(site)
            now[0] += 2.0

    sup = TFT.ExecutorSupervisor(_factory(observability=obs),
                                 tick_timeout_s=1.0, launch_hook=slow_once)
    for r in short:
        sup.engine.submit(r)
    while sup.engine.queue or sup.engine.n_active:
        sup.tick()
    assert sup.failovers == 1
    assert "exceeded timeout" in sup.failover_log[0]["cause"]
    assert sup.failover_log[0]["detect_s"] == 2.0
    assert _streams(sup.engine) == ref_out


def test_supervisor_enforces_max_failovers():
    plan = TFT.FailurePlan(at_sites=(("decode", 1), ("decode", 2)))
    sup = TFT.ExecutorSupervisor(_factory(), failure_plan=plan,
                                 max_failovers=1)
    sup.engine.submit(TS.Request(rid=0, prompt=(3,), max_new_tokens=6))
    with pytest.raises(RuntimeError, match="exceeded 1 failovers"):
        while sup.engine.queue or sup.engine.n_active:
            sup.tick()


def test_supervisor_records_recovery_and_starts_catchup(jax_model):
    """The failover log carries rebuild, replay and first-token times; the
    recovery lands in the histogram, and the attached policy is rebound to
    the new controller with the penalty JAX's policy computes for that
    recovery."""
    plan = TFT.FailurePlan(at_sites=(("decode", 2),))
    sup = TFT.ExecutorSupervisor(_factory(), failure_plan=plan)
    pol = TS.SLOPolicy(CFG, sup.engine.ctrl, batch_size=3, cache_capacity=32)
    sup.attach_policy(pol)
    for r in _mixed_trace(4):
        sup.engine.submit(r)
    while sup.engine.queue or sup.engine.n_active:
        sup.tick()
    assert sup.failovers == 1
    e = sup.failover_log[0]
    assert e["rebuild_s"] > 0 and e["replay_s"] > 0
    assert e["first_token_s"] is not None and e["first_token_s"] > 0
    rec_ms = (e["rebuild_s"] + e["replay_s"]) * 1e3
    assert sup.recovery_ms.count == 1
    assert pol.controller is sup.engine.ctrl
    jcfg, jp = jax_model
    jpol = JS.SLOPolicy(jcfg, JMO.make_serve_controller(jp, jcfg),
                        batch_size=3, cache_capacity=32)
    jpol.note_failover(recovery_ms=rec_ms)
    for _ in range(pol.catchup_ticks + 1):
        pol.choose(0.05)
        jpol.choose(0.05)
        assert pol.last_decision["catchup_penalty"] == \
            jpol.last_decision["catchup_penalty"]
    assert pol.last_decision["catchup_penalty"] == 0.0


# ---------------------------------------------------------------------------
# chaos drives
# ---------------------------------------------------------------------------


def _fault_free(make, trace, mod=TFT):
    """(streams, counters, launches per site, the engine) of a run under a
    counting supervisor."""
    counter = mod.FailurePlan()
    sup = mod.ExecutorSupervisor(make, failure_plan=counter)
    sup.run_trace(trace)
    assert sup.failovers == 0
    return (_streams(sup.engine), _counters(sup.engine),
            dict(counter.site_counts), sup.engine)


def _plan(totals, sites, mod=TFT):
    """One failure at each site, at an occurrence the fault-free run
    reached (redone ticks only add launches, so each one fires)."""
    at = []
    for site in sites:
        assert totals.get(site, 0) >= 1, (site, totals)
        at.append((site, min(2, totals[site])))
    return mod.FailurePlan(at_sites=tuple(at))


def _chaos(make, trace, plan, mod=TFT, standby=None):
    """Ping-pong two pre-warmed standbys (restore resets an engine, so two
    absorb any number of failovers; ``standby``, an engine that already
    ran, may be one of them)."""
    engines = [standby or make(), make()]
    idx = [0]

    def pingpong():
        idx[0] ^= 1
        return engines[idx[0]]

    sup = mod.ExecutorSupervisor(pingpong, failure_plan=plan,
                                 max_failovers=len(plan.at_sites))
    return sup, sup.run_trace(trace), engines


def _assert_exact(sup, summary, plan, ref_out, ref_counters, trace):
    eng = sup.engine
    assert summary["failovers"] == len(plan.at_sites) >= 3
    assert plan.fired_sites == set(plan.at_sites)
    assert _streams(eng) == ref_out
    rids = [r.rid for r in eng.completed]
    assert sorted(rids) == sorted({r.rid for r in trace})
    assert not eng.expired
    assert _counters(eng) == ref_counters
    assert all(s > 0 for s in summary["recovery_s"])
    eng.check_paged_invariants()


CHAOS = {
    "dense_linear": (CFG, dict(speculative=SpecConfig(ks=(2,))),
                     ("decode", "verify", "prefill")),
    "paged_tree": (CFG, dict(paged=PagedLayout(page_size=4),
                             speculative=SpecConfig(ks=(), trees=((2, 1),))),
                   ("paged_decode", "tree_verify", "prefill")),
    "fused": (CFG, dict(fused=True, speculative=SpecConfig(ks=(2,))),
              ("decode", "verify", "prefill")),
    "mamba2_linear": (smoke_config("mamba2-370m"),
                      dict(speculative=SpecConfig(ks=(2,))),
                      ("decode", "verify", "prefill")),
}


@pytest.mark.parametrize("name", list(CHAOS))
def test_chaos_drive_is_exact(name):
    cfg, kw, sites = CHAOS[name]
    params = PARAMS if cfg is CFG else init_params(cfg, seed=0, device="cpu")
    make = _factory(cfg, params, **kw)
    ref_out, ref_counters, totals, _ = _fault_free(make, _trace(cfg))
    plan = _plan(totals, sites)
    trace = _trace(cfg)
    sup, summary, engines = _chaos(make, trace, plan)
    _assert_exact(sup, summary, plan, ref_out, ref_counters, trace)
    assert sum(e.replay_chunk_launches for e in engines) > 0
    # each standby keeps its own registry: restoring one loads the other's
    # state, and the supervisor's failover stream and histogram keep every
    # failover all the same
    assert len(sup.failover_log) == sup.recovery_ms.count == 3
    assert all(e["first_token_s"] is not None for e in sup.failover_log)
    if "paged" in kw:
        # every slot released: only scratch and radix-held pages remain
        for g in sup.engine.groups.values():
            pg = g.paging
            held = pg.radix.held_pages() if pg.radix else []
            assert pg.alloc.n_in_use == len(pg.scratch) + len(held)


def test_chaos_drive_matches_jax_supervisor(jax_model):
    """JAX's supervisor and the port's, on the same weights, trace and
    plan: the same streams, counters, failovers and chunk launches (the
    fault-free engine serves again as one of the two standbys)."""
    jcfg, jp = jax_model
    tp = params_from_jax(jax.device_get(jp), device="cpu")
    spec = dict(ks=(2,))
    jkw = {k: v for k, v in KW.items() if k != "device"}

    def jmake():
        eng = JS.ServingEngine(jp, jcfg, **jkw,
                               speculative=JSP.SpecConfig(**spec))
        eng.warmup()
        return eng

    tmake = _factory(CFG, tp, speculative=SpecConfig(**spec))
    sites = ("decode", "verify", "prefill")
    runs = []
    for mod, make, smod in ((JFT, jmake, JS), (TFT, tmake, TS)):
        ref_out, ref_counters, totals, used = _fault_free(
            make, _trace(mod=smod), mod)
        plan = _plan(totals, sites, mod)
        trace = _trace(mod=smod)
        sup, summary, engines = _chaos(make, trace, plan, mod, standby=used)
        _assert_exact(sup, summary, plan, ref_out, ref_counters, trace)
        runs.append((_streams(sup.engine), _counters(sup.engine),
                     summary["failovers"], plan.at_sites,
                     [e.replay_chunk_launches for e in engines]))
    assert runs[0] == runs[1]


# ---------------------------------------------------------------------------
# the serving CLI
# ---------------------------------------------------------------------------


def _serve(capsys, *flags):
    assert TSERVE.main(["--arch", "tinyllama-1.1b", "--smoke", "--batch", "2",
                        "--tokens", "12", "--prefill-threshold", "1",
                        "--device", "cpu", *flags]) == 0
    return capsys.readouterr().out


def _summary(out):
    line = next(ln for ln in out.splitlines()
                if ln.startswith("[serve] completed="))
    return dict(re.findall(r"(completed|expired|failovers|generated|"
                           r"streams_crc32)=(\w+)", line))


def test_serve_fail_at_gives_the_fault_free_tokens(capsys):
    ref = _summary(_serve(capsys))
    out = _serve(capsys, "--fail-at", "decode:2,prefill:1")
    got = _summary(out)
    assert got["failovers"] == "2" and ref["failovers"] == "0"
    assert {k: v for k, v in got.items() if k != "failovers"} == \
        {k: v for k, v in ref.items() if k != "failovers"}
    assert len(re.findall(r"\[serve\] failover @step \d+: SimulatedFailure",
                          out)) == 2
    assert "never reached" not in out


def test_serve_deadline_expires_a_queued_request(capsys):
    """Two slots, three requests: the third waits a tick, past its 1 ns
    deadline on the virtual clock, and finishes as expired."""
    got = _summary(_serve(capsys, "--deadline-s", "1e-9"))
    assert (got["completed"], got["expired"]) == ("2", "1")
    with pytest.raises(SystemExit):
        _serve(capsys, "--fail-at", "decode")
