"""The port's serving engine on encoder-decoder and frontend models.

Same weights in both packages (JAX init, converted through numpy), the f32
smoke configs of ``whisper-base`` and ``internvl2-2b``, 3 slots, capacity
32, prefill threshold 4, the drive of ``tests/test_torch_moe_serving.py``
(admissions at mixed widths and at a shallow depth, prompts of 1-9
tokens), greedy:

* the port's engine emits exactly the tokens of the JAX package's engine,
  unfused and ``fused=True``. As in the reference, these families take no
  prefill admission: the engine carries token prompts only, so every
  prompt is fed by decode steps and a slot's cross K/V stay the zeros of
  ``init_decode_cache``;
* speculative and paged engines refuse both families with the reference's
  errors, and so do ``verify_step``, ``verify_tree`` and
  ``draft_tree_level``;
* ``launch.serve --arch whisper-base --smoke`` on the CPU, and its
  ``--spec-k`` / ``--kv-page-size`` refusals.
"""
import jax
import pytest
import torch

from repro.configs import smoke_config as jax_smoke_config
from repro.models import model as JM
from repro.runtime import serving as JS
from repro_torch.configs import smoke_config
from repro_torch.convert import params_from_jax
from repro_torch.models import model as TM
from repro_torch.models.paged import PagedLayout
from repro_torch.runtime import serving as TS
from repro_torch.runtime import speculative as TSP
from torch_threads import one_thread  # noqa: E402,F401  (autouse)

KW = dict(batch_size=3, cache_capacity=32, prefill_threshold=4)
ARCHS = ("whisper-base", "internvl2-2b")


def _drive(eng, vocab, n_new=6):
    """Four admissions at (full, narrow, shallow, full) modes with prompts
    of 1-5 tokens, then two requests with one 9-token prompt."""
    modes = eng.ctrl.modes
    full = modes[-1]
    widths = [m for m in modes if m.depth == full.depth]
    shallow = [m for m in modes if m.depth != full.depth]
    Req = JS.Request if isinstance(eng, JS.ServingEngine) else TS.Request
    rid = 0
    for m in (widths[-1], widths[0], shallow[-1], widths[-1]):
        eng.set_admission_mode(m)
        eng.submit(Req(rid=rid, max_new_tokens=n_new,
                       prompt=tuple(1 + (rid * 7 + j) % (vocab - 1)
                                    for j in range(1 + 4 * (rid % 2)))))
        rid += 1
        eng.step()
    prefix = tuple(1 + (j * 3) % (vocab - 1) for j in range(9))
    for _ in range(2):
        eng.submit(Req(rid=rid, prompt=prefix, max_new_tokens=n_new))
        rid += 1
    while eng.queue or eng.n_active:
        eng.step()
    return {r.rid: tuple(r.generated) for r in eng.completed}


_REF = {}


def _reference(arch):
    """(JAX params, the JAX engine's streams), once per arch."""
    if arch not in _REF:
        jcfg = jax_smoke_config(arch)
        jp = jax.device_get(jax.jit(JM.init_params, static_argnums=1)(
            jax.random.PRNGKey(0), jcfg))
        eng = JS.ServingEngine(jp, jcfg, **KW)
        eng.warmup()
        want = _drive(eng, jcfg.vocab_size)
        assert eng.prefills == 0 and eng.decode_launches > 0
        _REF[arch] = (jp, want)
    return _REF[arch]


@pytest.mark.parametrize("fused", [False, True], ids=["unfused", "fused"])
@pytest.mark.parametrize("arch", ARCHS)
def test_greedy_engine_matches_jax(arch, fused):
    jp, want = _reference(arch)
    cfg = smoke_config(arch)
    eng = TS.ServingEngine(params_from_jax(jp, device="cpu"), cfg,
                           fused=fused, device="cpu", **KW)
    eng.warmup()
    built = eng.ctrl.trace_counter["n"]
    got = _drive(eng, cfg.vocab_size)
    assert got == want
    assert len(got) == 6 and all(len(t) == 6 for t in got.values())
    assert eng.prefills == 0  # token feed only, as in the reference
    assert eng.ctrl.trace_counter["n"] == built
    assert eng.ctrl.stats["compiles"] == eng.compiles_after_warmup


@pytest.mark.parametrize("arch", ARCHS)
def test_no_prefill_admission(arch):
    """A prompt at or past the threshold still goes to the token feed (the
    engine has no frames or patches to prefill with); a token-only decoder
    of the same engine settings takes the prefill."""
    req = TS.Request(rid=0, prompt=tuple(range(1, 10)), max_new_tokens=2)
    for name, expect in ((arch, False), ("tinyllama-1.1b", True)):
        eng = TS.ServingEngine({}, smoke_config(name), device="cpu", **KW)
        assert eng._use_prefill(req) is expect


@pytest.mark.parametrize("arch", ARCHS)
def test_speculative_and_paged_engines_refuse(arch):
    cfg = smoke_config(arch)
    with pytest.raises(ValueError, match="speculative serving needs a "
                                         "token-only decoder"):
        TS.ServingEngine({}, cfg, device="cpu",
                         speculative=TSP.SpecConfig(ks=(2,)), **KW)
    with pytest.raises(ValueError, match="speculative serving needs a "
                                         "token-only decoder"):
        TS.ServingEngine({}, cfg, device="cpu",
                         speculative=TSP.SpecConfig(ks=(), trees=((2, 1),)),
                         **KW)
    with pytest.raises(ValueError, match="paged KV serving needs a "
                                         "token-only decoder"):
        TS.ServingEngine({}, cfg, device="cpu",
                         paged=PagedLayout(page_size=4), **KW)


@pytest.mark.parametrize("arch", ARCHS)
def test_verify_paths_refuse(arch):
    cfg = smoke_config(arch)
    params = TM.init_params(cfg, seed=0, device="cpu")
    cache = TM.init_decode_cache(cfg, 2, 16, per_slot=True, device="cpu")
    tree = TSP.TreeTopology((2, 1))
    toks = torch.ones((2, 3), dtype=torch.long)
    with pytest.raises(NotImplementedError, match="verify_step supports "
                                                  "token-only decoders"):
        TM.verify_step(params, cache, toks, cfg)
    with pytest.raises(NotImplementedError, match="verify_tree supports "
                                                  "token-only decoders"):
        TM.verify_tree(params, cache, toks[:, :1].expand(2, tree.n_nodes),
                       cfg, tree=tree)
    with pytest.raises(NotImplementedError, match="draft_tree_level supports "
                                                  "token-only decoders"):
        TM.draft_tree_level(params, cache, {}, toks[:, :1], cfg, tree=tree,
                            level=0)


def test_serve_cli_whisper_smoke_on_cpu(capsys):
    from repro_torch.launch.serve import main

    assert main(["--arch", "whisper-base", "--smoke", "--batch", "2",
                 "--tokens", "12", "--device", "cpu", "--fused"]) == 0
    out = capsys.readouterr().out
    assert "whisper-base-smoke on cpu" in out
    assert "recompiles_after_warmup=0" in out and "prefills=0" in out
    for flags, match in ((["--spec-k", "2"], "speculative serving"),
                         (["--spec-tree", "2x1"], "speculative serving"),
                         (["--kv-page-size", "4"], "paged KV serving")):
        with pytest.raises(ValueError, match=match):
            main(["--arch", "whisper-base", "--smoke", "--device", "cpu"]
                 + flags)
