"""The online NeuroForge autoscaler in the port, ported from the JAX
package's ``tests/test_autoscale.py`` on the same smoke config.

* The lifecycle, dense and paged: under a traffic shift the online MOGA
  adopts K = 4 (not warmed) off-thread, publishes it between ticks,
  retires a cold unit to fit the table budget, never stalls a tick, and
  the committed streams equal a fixed-mode run's token for token.
* A bare standby absorbs a snapshot, holds its autoscaler state and
  re-publishes the adopted units when an autoscaler binds, with the
  reference's accounting; an in-place restore with one bound loads it.
* Constant traffic: identical streams, no stall, gauges exported; the
  admission-switch events stamp the front's generation.
* ``ServeSpace`` and ``measured_accept_rate`` equal the JAX package's on
  the same engine state (the port engine's, copied into a JAX engine of
  the same geometry), and so does one generation's front.
* ``MorphController.publish_aux`` / ``unregister_aux`` / ``coldness``,
  launches counted apart per thread (``kernels.counted_apart``), and
  ``launch.serve --autoscale`` on the CPU.

Smoke configs (f32), 2 slots, capacity 32, prefill threshold 4, linear
K = 2 warmed, as the reference's tests.
"""
import dataclasses
import threading
import time
from dataclasses import replace

import jax
import pytest

from repro.configs import smoke_config as jax_smoke_config
from repro.models import model as JM
from repro.runtime import autoscale as JA
from repro.runtime import serving as JS
from repro.runtime import speculative as JSP
from repro.runtime.observability import autoscale_events as j_events
from repro_torch.configs import smoke_config
from repro_torch.convert import params_from_jax
from repro_torch.core.morph import MorphController
from repro_torch.core.neuroforge import V5E
from repro_torch.launch import serve as TSERVE
from repro_torch.models.model import init_params
from repro_torch.models.paged import PagedLayout
from repro_torch.runtime import autoscale as TA
from repro_torch.runtime import serving as TS
from repro_torch.runtime.observability import autoscale_events
from repro_torch.runtime.speculative import SpecConfig
from torch_threads import one_thread  # noqa: E402,F401  (autouse)

ARCH = "tinyllama-1.1b"
CFG = smoke_config(ARCH)
PARAMS = init_params(CFG, seed=0, device="cpu")
EVENT_FIELDS = ("step", "event", "unit", "generation", "detail")


def _spec_engine(params=PARAMS, *, paged=False):
    eng = TS.ServingEngine(params, CFG, batch_size=2, cache_capacity=32,
                           prefill_threshold=4,
                           speculative=SpecConfig(ks=(2,)),
                           paged=PagedLayout(page_size=4) if paged else None,
                           device="cpu")
    eng.warmup()
    return eng


def _two_phase_traces():
    """Dense fast arrivals, then sparse slow ones; the second phase's rids
    are offset so the by-rid comparison with the baseline is sound."""
    t1 = TS.poisson_trace(10, 200.0, seed=1, new_tokens=(4, 8))
    t2 = [replace(r, rid=r.rid + 100)
          for r in TS.poisson_trace(8, 30.0, seed=2, new_tokens=(4, 8))]
    return t1, t2


def _await_builds(asc, timeout_s=60.0):
    """Wait for the background worker, publishing finished units as a
    serving tick would (drained on the caller's thread)."""
    t0 = time.monotonic()
    while asc._pending and time.monotonic() - t0 < timeout_s:
        asc._drain_publish()
        time.sleep(0.02)
    asc._drain_publish()
    assert not asc._pending, "background builds never finished"


def _autoscaler(eng, **kw):
    cfg = dict(interval_ticks=1, pop_size=8, generations=2, seed=0)
    cfg.update(kw)
    asc = TA.Autoscaler(TA.AutoscaleConfig(**cfg)).bind(eng)
    policy = TA.AutoscalePolicy(CFG, eng.ctrl, autoscaler=asc,
                                batch_size=eng.batch_size, cache_capacity=32,
                                metrics=eng.metrics)
    return asc, policy


def _streams(eng):
    return {r.rid: tuple(r.generated) for r in eng.completed}


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
def test_adopt_and_retire_lifecycle(paged):
    base = _spec_engine(paged=paged)
    pinned = base.ctrl.modes[-1]
    base.set_admission_mode(pinned)
    t1, t2 = _two_phase_traces()  # Requests are stateful: fresh per engine
    base.run(t1)
    base.run(t2)
    want = _streams(base)

    eng = _spec_engine(paged=paged)
    assert 4 not in eng.ctrl.spec_plan[pinned.depth].ks
    budget = eng.compiles_after_warmup + 1  # adopting K = 4 adds 2 keys
    asc, policy = _autoscaler(eng, table_budget=budget, spec_ks=(4,))
    try:
        compiles0 = eng.ctrl.stats["compiles"]
        t1, t2 = _two_phase_traces()
        eng.run(t1, policy=policy, budget_fn=lambda t: 0.5)
        _await_builds(asc)
        eng.run(t2, policy=policy, budget_fn=lambda t: 0.5)
        assert asc.stats["published"] >= 1, asc.stats
        assert ("spec_k", pinned.depth, 4) in (asc._published_units
                                               + asc._retired_units)
        assert asc.stats["retired"] >= 1, asc.stats
        assert eng.ctrl.compile_table_size <= budget
        assert eng.ctrl.stats["compiles"] == \
            compiles0 + asc.stats["published_keys"]
        assert asc.stats["tick_stalls"] == 0
        assert asc.stats["dropped"] == 0
        assert asc.worker_idents and \
            threading.get_ident() not in asc.worker_idents
        assert _streams(eng) == want
        evs = [(e["event"], e["unit"])
               for e in eng.metrics.events("autoscale_events", EVENT_FIELDS)]
        assert f"spec_k:d{pinned.depth}:4" in \
            [u for k, u in evs if k == "publish"]
        assert any(k == "retire" for k, _ in evs)
        if paged:
            # a retired bucket rounds launches up to a live one
            eng.check_paged_invariants()
            cap = eng.groups[pinned.depth].paging.cap_pages
            assert cap in eng._avail_buckets
            assert set(eng._avail_buckets) <= set(eng._buckets)
            assert eng._bucket_for(1) == min(eng._avail_buckets)
    finally:
        asc.close()


def test_snapshot_onto_bare_standby_republishes():
    eng = _spec_engine()
    pinned = eng.ctrl.modes[-1]
    asc, policy = _autoscaler(eng, spec_ks=(4,))
    try:
        t1, _ = _two_phase_traces()
        eng.run(list(t1), policy=policy, budget_fn=lambda t: 0.5)
        _await_builds(asc)
        policy.choose(0.5)  # one more decision tick publishes the unit
        assert 4 in eng.ctrl.spec_plan[pinned.depth].ks
        snap = eng.snapshot()
        assert snap.autoscale is not None

        standby = _spec_engine()
        warm = standby.ctrl.stats["compiles"]
        standby.restore(snap)
        assert standby._pending_autoscale == snap.autoscale
        assert 4 not in standby.ctrl.spec_plan[pinned.depth].ks
        asc2 = TA.Autoscaler(TA.AutoscaleConfig(
            interval_ticks=1, spec_ks=(4,), pop_size=8, generations=2,
            seed=0)).bind(standby)
        try:
            assert standby._pending_autoscale is None
            assert 4 in standby.ctrl.spec_plan[pinned.depth].ks
            assert standby.ctrl.stats["compiles"] == \
                warm + asc2.stats["published_keys"] > warm
            assert asc2.generation == asc.generation
            assert asc2.front == asc.front
            a, b = asc.state_dict(), asc2.state_dict()
            for key in ("generation", "front", "published", "retired",
                        "active_spec", "avail_buckets"):
                assert a[key] == b[key], key
            # the recovery build ran on this thread, counted apart (on the
            # CPU the wrappers count nothing)
            assert asc2.build_launches == {}
            # an in-place restore with an autoscaler bound loads the state:
            # what the snapshot lacked is retired again
            bare = standby.snapshot()
            bare.autoscale = dict(bare.autoscale, active_spec={
                d: {"ks": [2], "trees": []}
                for d in bare.autoscale["active_spec"]}, published=[])
            standby.restore(bare)
            assert 4 not in standby.ctrl.spec_plan[pinned.depth].ks
            assert standby._pending_autoscale is None
        finally:
            asc2.close()
    finally:
        asc.close()


def test_bit_identity_and_no_stall_under_constant_traffic():
    base = _spec_engine()
    base.set_admission_mode(base.ctrl.modes[-1])
    base.run(TS.poisson_trace(6, 100.0, seed=3))
    want = _streams(base)

    eng = _spec_engine()
    asc, policy = _autoscaler(eng)
    try:
        eng.run(TS.poisson_trace(6, 100.0, seed=3), policy=policy,
                budget_fn=lambda t: 0.5)
        assert asc.stats["generations"] >= 1
        assert asc.stats["tick_stalls"] == 0
        assert eng.ctrl.stats["compiles"] == eng.compiles_after_warmup
        assert _streams(eng) == want
        g = eng.metrics.to_json()["gauges"]
        assert g["autoscale_generation"] >= 1.0
        assert g["autoscale_compile_table"] == float(
            eng.ctrl.compile_table_size)
    finally:
        asc.close()


def test_admission_switch_records_frontier_generation():
    eng = TS.ServingEngine(PARAMS, CFG, batch_size=2, cache_capacity=32,
                           device="cpu")
    eng.warmup()
    fields = ("step", "from_mode", "to_mode", "queued_interactive",
              "queued_batch", "frontier_gen")
    eng.set_admission_mode(eng.ctrl.modes[0])
    evs = list(eng.metrics.events("engine_admission_switch", fields))
    assert evs and evs[-1]["frontier_gen"] == -1
    assert len(eng.admission_switch_log[-1]) == 5
    asc, policy = _autoscaler(eng)
    try:
        policy.choose(0.5)  # runs generation 1
        eng.set_admission_mode(eng.ctrl.modes[-1])
        evs = list(eng.metrics.events("engine_admission_switch", fields))
        assert evs[-1]["frontier_gen"] == asc.generation >= 1
    finally:
        asc.close()


@pytest.fixture(scope="module")
def twin_engines():
    """A port engine run on a trace, and a JAX engine of the same geometry
    holding the same serving state: the port's per-mode telemetry,
    acceptance telemetry and rolling acceptance windows, copied over (the
    JAX engine is not warmed or run: what the autoscaler reads is that
    state, and token identity of the two engines is held elsewhere)."""
    jcfg = jax_smoke_config(ARCH)
    jparams = JM.init_params(jax.random.PRNGKey(0), jcfg)
    je = JS.ServingEngine(jparams, jcfg, batch_size=2, cache_capacity=32,
                          prefill_threshold=4,
                          speculative=JSP.SpecConfig(ks=(2,)))
    te = _spec_engine(params_from_jax(jparams, device="cpu"))
    te.run(TS.poisson_trace(8, 1e6, seed=4, new_tokens=(6, 10)))
    je.ctrl.load_telemetry_state(te.ctrl.telemetry_state())
    je.spec_telemetry = {key: JSP.SpecTelemetry(**dataclasses.asdict(t))
                         for key, t in te.spec_telemetry.items()}
    for d, g in te.groups.items():
        if g.accept_window is not None:
            je.groups[d].accept_window.extend(g.accept_window)
    return jcfg, je, te


def test_serve_space_and_accept_rate_match_reference(twin_engines):
    _, je, te = twin_engines
    js, ts = JA.ServeSpace(je, spec_ks=(4,)), TA.ServeSpace(te, spec_ks=(4,))
    assert ts.bounds() == js.bounds() == (4, 3, 1)
    assert ts.modes == js.modes and ts.spec_choices == js.spec_choices
    nm, ns, nb = ts.bounds()
    for genes in ((a, b, c) for a in range(nm) for b in range(ns)
                  for c in range(nb + 1)):
        pt = ts.decode(genes)
        assert pt.__dict__ == js.decode(genes).__dict__
        if te.ctrl.spec_plan.get(pt.depth) is None:
            assert pt.spec_k == 0 and pt.spec_tree is None
    depth = te.ctrl.modes[-1].depth
    assert te.spec_telemetry and not te.groups[depth].accept_window
    for d in te.groups:
        # lifetime telemetry (the collapse fallback emptied the window),
        # or the default at a depth with no draft
        assert TA.measured_accept_rate(te, d) == \
            JA.measured_accept_rate(je, d)
    assert TA.measured_accept_rate(te, depth) != 0.75
    try:  # the rolling window comes first
        for eng in (te, je):
            eng.groups[depth].accept_window.extend((0.5, 0.25, 1.0))
        assert TA.measured_accept_rate(te, depth) == \
            JA.measured_accept_rate(je, depth) == 0.5833333333333334
    finally:
        for eng in (te, je):
            eng.groups[depth].accept_window.clear()
    paged = TA.ServeSpace(_spec_engine(paged=True), spec_ks=(4,))
    assert paged.buckets == [1, 2, 4, 8]


def test_generation_front_matches_reference(twin_engines):
    """One MOGA generation over each engine's pool, from the same
    telemetry and acceptance, on the reference's hardware spec: the same
    front and objectives (and the exhaustive refinement leaves no
    dominated point); K = 2 never sits beside K = 4."""
    jcfg, je, te = twin_engines
    fronts = []
    for eng, mod, cfg, events, kw in (
            (je, JA, jcfg, j_events, {}), (te, TA, CFG, autoscale_events,
                                           dict(hw=V5E))):
        asc = mod.Autoscaler(mod.AutoscaleConfig(spec_ks=(4,), pop_size=4,
                                                 generations=1))
        # attached by hand: no worker thread, so the scheduled build waits
        asc.engine, asc._events = eng, events(eng.metrics)
        pol = mod.SLOPolicy(cfg, eng.ctrl, batch_size=2, cache_capacity=32,
                            **kw)
        asc._run_generation(pol, 0.5, {"interactive": 1, "batch": 2})
        fronts.append((asc.front, asc.front_objectives,
                       sorted(asc._pending)))
    (jf, jo, jp), (tf, to, tp) = fronts
    assert [p.__dict__ for p in tf] == [p.__dict__ for p in jf]
    assert to == jo and tp == jp
    assert len(set(tf)) == len(tf)
    assert {p.spec_k for p in tf if p.spec_k} in (set(), {4})


def test_morph_controller_publish_unregister_coldness():
    ctrl = MorphController(CFG, lambda m: (lambda: m.depth),
                           compile_key=lambda m: m.depth)
    ctrl.warmup()
    n0, size0 = ctrl.stats["compiles"], ctrl.compile_table_size
    ctrl.publish_aux(("aux", 1), lambda: "one")
    with pytest.raises(KeyError, match="already registered"):
        ctrl.publish_aux(("aux", 1), lambda: "again")
    assert ctrl.stats["compiles"] == n0 + 1
    assert ctrl.compile_table_size == size0 + 1
    assert ("aux", 1) in ctrl.aux_keys() and ("aux", 1) in ctrl.compiled_keys()
    assert ctrl.coldness(("aux", 1)) == 0
    for _ in range(3):
        ctrl()
    assert ctrl.coldness(("aux", 1)) == 3
    assert ctrl.aux_step(("aux", 1))() == "one"
    assert ctrl.coldness(("aux", 1)) == 0
    assert ctrl.coldness(ctrl.modes[-1].depth) == 0
    ctrl.unregister_aux(("aux", 1))
    assert ("aux", 1) not in ctrl.compiled_keys()
    assert ctrl.compile_table_size == size0
    assert ctrl.stats["compiles"] == n0 + 1
    with pytest.raises(KeyError, match="not registered"):
        ctrl.unregister_aux(("aux", 1))
    eng = _spec_engine(paged=True)
    assert set(eng.ctrl.aux_builders) == {"paged_decode", "draft", "verify",
                                          "tree_draft", "tree_verify"}


def test_counted_apart_keeps_each_threads_launches():
    """Eight threads count launches into tallies of their own while the
    main thread counts into the wrapper's counters, under a switch
    interval of a microsecond: no count is lost or lands elsewhere."""
    import sys

    from repro_torch import kernels

    own = {"n": 0}
    tallies = [{} for _ in range(8)]

    def worker(tally):
        with kernels.counted_apart(tally):
            for _ in range(2000):
                kernels.launch_counter(own, "k")["n"] += 1

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=worker, args=(t,))
                   for t in tallies]
        for th in threads:
            th.start()
        for _ in range(2000):
            kernels.launch_counter(own, "k")["n"] += 1
        for th in threads:
            th.join(timeout=30)
    finally:
        sys.setswitchinterval(old)
    assert not any(th.is_alive() for th in threads)
    assert own == {"n": 2000}
    assert tallies == [{"k": {"n": 2000}}] * 8


def test_serve_cli_autoscale(capsys):
    argv = ["--arch", ARCH, "--smoke", "--batch", "2", "--tokens", "16",
            "--device", "cpu", "--spec-k", "2"]
    assert TSERVE.main(argv + ["--budget-ms", "500", "--autoscale",
                               "--autoscale-interval", "1",
                               "--autoscale-ks", "4", "--autoscale-pop", "8",
                               "--autoscale-gens", "2",
                               "--autoscale-table-budget", "7"]) == 0
    out = capsys.readouterr().out
    assert "[serve] autoscale generations=" in out
    assert "tick_stalls=0 dropped=0" in out
    assert "  front d" in out
    with pytest.raises(SystemExit):
        TSERVE.main(argv + ["--autoscale"])
    assert "--autoscale requires --budget-ms" in capsys.readouterr().err
