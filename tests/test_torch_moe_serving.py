"""The port's serving engines on MoE models against the JAX package's.

Same weights in both packages (JAX init, converted through numpy), f32
smoke configs (granite, mixtral with a sliding window of 6, and jamba cut
to 2 periods), 3 slots, capacity 32, prefill threshold 4, the drive of
``tests/test_torch_tree_serving.py`` (admissions at mixed widths, so
slots route at top-1 and top-2, and at a shallow depth; short prompts fed
by decode steps, 5- and 9-token ones by one prefill), greedy:

* every port engine emits exactly the tokens of the JAX package's plain
  engine on the same config: granite plain unfused and fused, over a dense
  and a block-paged cache (page 4), linear-speculative (K = 2) and
  token-tree (2, 1) unfused and fused; jamba plain and linear-speculative;
  mixtral plain under its window. A prefill routes its prompt with
  capacity dispatch, whose drops depend on how many tokens route together:
  both engines prefill one request's unpadded prompt at a time, so they
  route the same groups. Nothing is built after warmup;
* ``launch.serve --arch granite-moe-1b-a400m --smoke`` on the CPU.
"""
import dataclasses

import jax
import pytest

from repro.configs import smoke_config as jax_smoke_config
from repro.models import model as JM
from repro.runtime import serving as JS
from repro_torch.configs import smoke_config
from repro_torch.convert import params_from_jax
from repro_torch.models.paged import PagedLayout
from repro_torch.runtime import serving as TS
from repro_torch.runtime import speculative as TSP
from torch_threads import one_thread  # noqa: E402,F401  (autouse)

KW = dict(batch_size=3, cache_capacity=32, prefill_threshold=4)
ARCHS = {"granite": ("granite-moe-1b-a400m", {}),
         "mixtral": ("mixtral-8x22b", {"sliding_window": 6}),
         "jamba": ("jamba-v0.1-52b", {"n_layers": 16})}


def _cfgs(arch):
    name, kw = ARCHS[arch]
    return (dataclasses.replace(jax_smoke_config(name), **kw),
            dataclasses.replace(smoke_config(name), **kw))


def _drive(eng, vocab, n_new=6):
    """Four admissions at (full, narrow, shallow, full) modes with prompts
    of 1-5 tokens, then two requests with one 9-token prompt; paged
    engines check their page accounting after every tick."""
    modes = eng.ctrl.modes
    full = modes[-1]
    widths = [m for m in modes if m.depth == full.depth]
    shallow = [m for m in modes if m.depth != full.depth]
    Req = JS.Request if isinstance(eng, JS.ServingEngine) else TS.Request
    rid = 0

    def tick():
        eng.step()
        if getattr(eng, "paged", None) is not None:
            eng.check_paged_invariants()

    for m in (widths[-1], widths[0], shallow[-1], widths[-1]):
        eng.set_admission_mode(m)
        eng.submit(Req(rid=rid, max_new_tokens=n_new,
                       prompt=tuple(1 + (rid * 7 + j) % (vocab - 1)
                                    for j in range(1 + 4 * (rid % 2)))))
        rid += 1
        tick()
    prefix = tuple(1 + (j * 3) % (vocab - 1) for j in range(9))
    for _ in range(2):
        eng.submit(Req(rid=rid, prompt=prefix, max_new_tokens=n_new))
        rid += 1
    while eng.queue or eng.n_active:
        tick()
    return {r.rid: tuple(r.generated) for r in eng.completed}


_REF = {}


def _reference(arch):
    """(JAX params, the JAX plain engine's streams), once per arch."""
    if arch not in _REF:
        jcfg, _ = _cfgs(arch)
        jp = jax.device_get(JM.init_params(jax.random.PRNGKey(0), jcfg))
        eng = JS.ServingEngine(jp, jcfg, **KW)
        eng.warmup()
        want = _drive(eng, jcfg.vocab_size)
        assert eng.prefills > 0 and eng.decode_launches > 0
        _REF[arch] = (jp, want)
    return _REF[arch]


# id -> (arch, fused, paged, speculation: None, K or a tree)
ENGINES = {"granite-unfused": ("granite", False, False, None),
           "granite-fused": ("granite", True, False, None),
           "granite-paged-unfused": ("granite", False, True, None),
           "granite-paged-fused": ("granite", True, True, None),
           "granite-linear-fused": ("granite", True, False, 2),
           "granite-tree-unfused": ("granite", False, False, (2, 1)),
           "granite-tree-fused": ("granite", True, False, (2, 1)),
           "jamba-plain": ("jamba", False, False, None),
           "jamba-linear-fused": ("jamba", True, False, 2),
           "mixtral-window-plain": ("mixtral", False, False, None)}


@pytest.mark.parametrize("engine", list(ENGINES))
def test_greedy_engine_matches_jax(engine):
    arch, fused, paged, spec = ENGINES[engine]
    jp, want = _reference(arch)
    _, cfg = _cfgs(arch)
    sc = None
    if isinstance(spec, tuple):
        sc = TSP.SpecConfig(ks=(), trees=(spec,))
    elif spec:
        sc = TSP.SpecConfig(ks=(spec,))
    eng = TS.ServingEngine(params_from_jax(jp, device="cpu"), cfg,
                           fused=fused, speculative=sc,
                           paged=PagedLayout(page_size=4) if paged else None,
                           device="cpu", **KW)
    eng.warmup()
    built = eng.ctrl.trace_counter["n"]
    got = _drive(eng, cfg.vocab_size)
    assert got == want
    assert eng.prefills > 0
    assert eng.ctrl.trace_counter["n"] == built
    assert eng.ctrl.stats["compiles"] == eng.compiles_after_warmup
    if spec:
        assert eng.spec_verify_launches > 0
        assert eng.spec_tree_launches == (eng.spec_verify_launches
                                          if isinstance(spec, tuple) else 0)


def test_serve_cli_granite_smoke_on_cpu(capsys):
    from repro_torch.launch.serve import main

    assert main(["--arch", "granite-moe-1b-a400m", "--smoke", "--batch", "2",
                 "--tokens", "12", "--device", "cpu", "--fused",
                 "--spec-k", "2", "--kv-page-size", "4"]) == 0
    out = capsys.readouterr().out
    assert "granite-moe-1b-a400m-smoke on cpu" in out
    assert "recompiles_after_warmup=0" in out and "spec d3<-d1k2" in out
    assert "pages depth=3" in out
