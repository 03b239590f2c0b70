"""The port's ServingEngine against the JAX ServingEngine on one trace.

Both engines get the same weights (JAX init, converted), the same
``poisson_trace`` (one numpy stream in both packages), prefill admission
(threshold 3), mixed per-slot widths and depth switches, driven tick for
tick by the same arrivals and admission-mode schedule. The committed token streams must be
identical, unfused and ``fused=True`` alike (in the f32 smoke config the
fused kernels' f32 projections equal the unfused path's). Identity is
asserted where it is meaningful: the test records every top-1 margin the
port's engine saw and requires the smallest to exceed the model-level logit
tolerance (1e-4) tenfold, so no greedy pick can flip on rounding.
"""
import copy

import jax
import numpy as np
import pytest
import torch

from repro.configs import smoke_config as jax_smoke_config
from repro.models import model as JM
from repro.runtime import serving as JS
from repro_torch.configs import smoke_config
from repro_torch.convert import params_from_jax
from repro_torch.runtime import serving as TS
from torch_threads import one_thread  # noqa: E402,F401  (autouse)

SCHEDULE = ("d3w100", "d3w50", "d1w100", "d3w100", "d1w50", "d3w50")
LOGIT_TOL = 1e-4


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


@pytest.fixture(scope="module")
def setup():
    jcfg = jax_smoke_config("tinyllama-1.1b")
    jp = JM.init_params(jax.random.PRNGKey(0), jcfg)
    trace = JS.poisson_trace(7, 100.0, seed=3, prompt_len=(1, 6),
                             new_tokens=(3, 9), vocab=jcfg.vocab_size)
    jeng = JS.ServingEngine(jp, jcfg, batch_size=3, cache_capacity=16,
                            prefill_threshold=3)
    jeng.warmup()
    want = _drive(jeng, copy.deepcopy(trace))
    assert jeng.prefills > 0 and len(jeng.admission_switch_log) >= 3
    return jax.device_get(jp), want


def _port_engine(jax_params, fused):
    cfg = smoke_config("tinyllama-1.1b")
    eng = TS.ServingEngine(params_from_jax(jax_params, device="cpu"), cfg,
                           batch_size=3, cache_capacity=16,
                           prefill_threshold=3, fused=fused, device="cpu")
    margins, widths_per_tick = [], []

    def top1_margin(logits):
        top = torch.topk(logits[..., : cfg.vocab_size].float(), 2, dim=-1)
        margins.append(float((top.values[..., 0] - top.values[..., 1]).min()))

    timed, pre = eng.ctrl.timed_step, eng._prefill_launch

    def timed_step(*a, **k):
        out = timed(*a, **k)
        g = eng.groups[k["mode"].depth]
        active = [i for i, r in enumerate(g.slots) if r is not None]
        top1_margin(out[0][active])
        widths_per_tick.append({g.widths[i] for i in active})
        return out

    def prefill_launch(*a, **k):
        logits = pre(*a, **k)
        top1_margin(logits)
        return logits

    eng.ctrl.timed_step, eng._prefill_launch = timed_step, prefill_launch
    return eng, margins, widths_per_tick


@pytest.mark.parametrize("fused", [False, True], ids=["unfused", "fused"])
def test_engine_streams_match_jax(setup, fused):
    jax_params, want = setup
    trace = TS.poisson_trace(7, 100.0, seed=3, prompt_len=(1, 6),
                             new_tokens=(3, 9), vocab=512)
    eng, margins, widths_per_tick = _port_engine(jax_params, fused)
    eng.warmup()
    compiles = eng.ctrl.stats["compiles"]
    built = eng.ctrl.trace_counter["n"]
    got = _drive(eng, trace)
    assert got == want
    assert min(margins) > 10 * LOGIT_TOL, min(margins)
    assert eng.prefills > 0 and len(eng.admission_switch_log) >= 3
    assert max(len(w) for w in widths_per_tick) > 1  # mixed widths, one step
    # width and depth churn after warmup builds no new step
    assert eng.ctrl.stats["compiles"] == compiles == eng.compiles_after_warmup
    assert eng.ctrl.trace_counter["n"] == built == len(eng.groups)


def test_slo_policy_run_and_metrics():
    cfg = smoke_config("tinyllama-1.1b")
    from repro_torch.models.model import init_params
    eng = TS.ServingEngine(init_params(cfg, seed=0, device="cpu"), cfg,
                           batch_size=2, cache_capacity=16, device="cpu")
    eng.warmup()
    policy = TS.SLOPolicy(cfg, eng.ctrl, batch_size=2, cache_capacity=16)
    assert policy._hw.name == "h100-sxm"
    trace = TS.poisson_trace(4, 1000.0, seed=0, prompt_len=(1, 3),
                             new_tokens=(2, 4), vocab=cfg.vocab_size)
    out = eng.run(trace, budget_fn=lambda t: 10.0, policy=policy)
    assert out["completed"] == 4 and out["compiles"] == eng.compiles_after_warmup
    m = eng.export_metrics()
    assert m["counters"]["engine_decode_launches"] == eng.decode_launches


def test_unported_options_raise():
    """A mesh executor raises for a serving policy it has no layout for
    (only ``serve_tp`` and ``serve_2d``), before any rank is asked for
    anything; every family serves over a mesh since the mesh slices
    (``test_torch_mesh.py``, ``test_torch_mesh_serving.py``). (Sampling
    and linear speculation arrived with the speculative slice,
    ``test_torch_speculative.py``; paged caches with the paged slice,
    ``test_torch_paged.py``: a page size that does not divide the capacity
    is refused before anything is built; token trees with the tree slice,
    ``test_torch_tree*.py``: a tree deeper than a sliding window allows is
    refused before anything is built.)"""
    from repro_torch.models.paged import PagedLayout
    from repro_torch.runtime.speculative import SpecConfig

    cfg = smoke_config("tinyllama-1.1b")
    with pytest.raises(ValueError, match="capacity"):
        TS.ServingEngine({}, cfg, device="cpu", cache_capacity=16,
                         paged=PagedLayout(page_size=5))
    for arch in ("granite-moe-1b-a400m", "whisper-base", "internvl2-2b"):
        mesh_exec = TS.MeshExecutor({"data": 1, "model": 2}, policy="train",
                                    device="cpu")
        with pytest.raises(ValueError, match="serving policy"):
            TS.ServingEngine({}, smoke_config(arch), device="cpu",
                             executor=mesh_exec)
    with pytest.raises(ValueError, match="sliding_window"):
        TS.ServingEngine({}, cfg.scaled(sliding_window=2), device="cpu",
                         speculative=SpecConfig(ks=(), trees=((1, 1),)))
