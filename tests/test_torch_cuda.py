"""The port's CUDA kernels against their plain versions, on the card.

Marked ``gpu``: on a host without a CUDA card every test here skips (the
decision is made inside the fixture, never at import). This file imports no
JAX, so it also runs on the machine with the card, where JAX is not
installed and ``tests/conftest.py`` cannot load:

    PYTHONPATH=src python -m pytest -q --noconftest -m gpu tests/test_torch_cuda.py

Tolerances: f32 inputs agree to 1e-4 (summation order only); bf16 outputs
to one bf16 rounding step (rtol 2^-7) plus atol 1e-3; int8 cache values
exactly.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs import smoke_config
from repro_torch.kernels import fused_decode as FD
from repro_torch.kernels import morph_matmul as MM

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


def _close(got, want, dtype):
    if dtype == torch.float32:
        torch.testing.assert_close(got, want, atol=1e-4, rtol=1e-4)
    else:
        torch.testing.assert_close(got.float(), want.float(), atol=1e-3,
                                   rtol=2.0 ** -7)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("shape", [(3, 1, 64, 96), (3, 5, 70, 45),
                                   (16, 1, 600, 2051), (2, 3, 4097, 40)])
def test_morph_matmul_kernel_matches_plain(cuda, dtype, shape):
    B, M, K, N = shape
    g = torch.Generator(device=cuda).manual_seed(0)
    x = torch.randn(B, M, K, generator=g, device=cuda).to(dtype)
    w = torch.randn(K, N, generator=g, device=cuda)
    an = torch.randint(0, N + 1, (B,), generator=g, device=cuda,
                       dtype=torch.int32)
    ak = torch.randint(0, K + 1, (B,), generator=g, device=cuda,
                       dtype=torch.int32)
    for a_n, a_k in ((an, ak), (None, ak), (an, None), (None, None)):
        got = MM.morph_matmul(x, w, a_n, a_k)
        want = MM.morph_matmul_plain(x, w, a_n, a_k)
        torch.cuda.synchronize()
        _close(got, want, dtype)
        if a_n is not None:
            dead = torch.arange(N, device=cuda)[None, None, :] >= a_n[:, None, None]
            assert bool((got[dead.expand(B, M, N)] == 0).all())


@pytest.mark.parametrize("variant", ["full", "swa", "kv_quant", "bf16"])
def test_fused_decode_kernels_match_plain(cuda, variant):
    kw = {"full": {}, "swa": {"sliding_window": 6},
          "kv_quant": {"kv_quant": True}, "bf16": {"dtype": "bfloat16"}}[variant]
    cfg = dataclasses.replace(smoke_config("tinyllama-1.1b"), **kw)
    dt = torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32
    g = torch.Generator(device=cuda).manual_seed(1)
    dm, H, KV, hd, B = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, 3
    params = {n: torch.randn(*s, generator=g, device=cuda) / np.sqrt(s[0])
              for n, s in (("wq", (dm, H * hd)), ("wk", (dm, KV * hd)),
                           ("wv", (dm, KV * hd)), ("wo", (H * hd, dm)))}
    S = 6 if cfg.sliding_window else 130
    shape = (B, S, KV, hd)
    if cfg.kv_quant:
        cache = {"k": torch.randint(-127, 128, shape, generator=g, device=cuda,
                                    dtype=torch.int8),
                 "v": torch.randint(-127, 128, shape, generator=g, device=cuda,
                                    dtype=torch.int8),
                 "k_scale": torch.rand(shape[:-1] + (1,), generator=g,
                                       device=cuda).to(torch.bfloat16) / 50,
                 "v_scale": torch.rand(shape[:-1] + (1,), generator=g,
                                       device=cuda).to(torch.bfloat16) / 50}
    else:
        cache = {"k": torch.randn(shape, generator=g, device=cuda).to(dt),
                 "v": torch.randn(shape, generator=g, device=cuda).to(dt)}
    x = torch.randn(B, 1, dm, generator=g, device=cuda).to(dt)
    pos = torch.tensor([0, 4, S + 70], dtype=torch.int32, device=cuda)
    act = {"q_dim": torch.tensor([32, 64, 24], dtype=torch.int32, device=cuda),
           "kv_dim": torch.tensor([16, 32, 24], dtype=torch.int32, device=cuda)}
    c_k = {n: t.clone() for n, t in cache.items()}
    c_p = {n: t.clone() for n, t in cache.items()}
    o_k, _ = FD.fused_decode_step(params, x, c_k, pos, cfg, active=act)
    o_p, _ = FD.fused_decode_plain(params, x, c_p, pos, cfg, act["q_dim"],
                                   act["kv_dim"])
    torch.cuda.synchronize()
    _close(o_k, o_p, dt)
    for n in cache:
        if cache[n].dtype == torch.int8:
            assert torch.equal(c_k[n], c_p[n]), n
        else:
            _close(c_k[n], c_p[n], cache[n].dtype)


def test_engine_on_card_fused_equals_unfused(cuda):
    from repro_torch.models.model import init_params
    from repro_torch.runtime.serving import ServingEngine, poisson_trace

    cfg = smoke_config("tinyllama-1.1b")
    params = init_params(cfg, seed=0, device=cuda)
    streams = []
    for fused in (False, True):
        eng = ServingEngine(params, cfg, batch_size=3, cache_capacity=24,
                            prefill_threshold=3, fused=fused, device=cuda)
        eng.warmup()
        trace = poisson_trace(6, 100.0, seed=2, prompt_len=(1, 6),
                              new_tokens=(3, 9), vocab=cfg.vocab_size)
        out = eng.run(trace, budget_fn=None, policy=None)
        assert out["completed"] == 6
        streams.append({r.rid: r.generated for r in eng.completed})
    assert streams[0] == streams[1]
