"""NeuroForge's design space, MOGA and estimator validation in the port,
held to the JAX package's on the same inputs.

* ``DesignSpace`` fields, bounds and decoded points equal the reference's
  for train and decode cells, with its fixes: the dp-divides-batch filter,
  the ``ValueError`` on an empty factorization, the microbatch clamp.
* ``run_moga`` draws from ``random.Random(seed)`` as the reference does, so
  for one seed, evaluator and ``hw`` its front, final population,
  evaluation count and history equal the reference's exactly: with the
  analytical evaluator (``hw=V5E``, the reference's default) and with an
  injected evaluator and space.
* ``non_dominated`` and ``pareto_is_consistent`` agree on one pool;
  ``validate_against_record`` and ``point_from_record`` on one record.
"""
from itertools import product
from types import SimpleNamespace

import pytest

from repro.configs import SHAPE_BY_NAME as J_SHAPES
from repro.configs import get_config as j_get_config
from repro.core import neuroforge as JNF
from repro.core.neuroforge import validate as JVAL
from repro_torch.configs import SHAPE_BY_NAME, get_config
from repro_torch.core import neuroforge as TNF
from repro_torch.core.neuroforge import validate as TVAL
from torch_threads import one_thread  # noqa: E402,F401  (autouse)

ARCHS = ("tinyllama-1.1b", "mamba2-370m", "granite-moe-1b-a400m")


def _both(arch, shape):
    return ((j_get_config(arch), J_SHAPES[shape]),
            (get_config(arch), SHAPE_BY_NAME[shape]))


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("shape,chips", [("train_4k", 256),
                                         ("train_4k", 16),
                                         ("decode_32k", 64)])
def test_design_space_matches_reference(arch, shape, chips):
    (jc, jcell), (tc, tcell) = _both(arch, shape)
    js = JNF.DesignSpace(jc, jcell, n_chips=chips)
    ts = TNF.DesignSpace(tc, tcell, n_chips=chips)
    assert ts.fields() == js.fields()
    assert ts.bounds() == js.bounds()
    assert ts.size() == js.size()
    for idx in product(*(range(b) for b in ts.bounds()[:2])):
        genes = list(idx) + [1] * (len(ts.bounds()) - 2)
        assert ts.decode(genes).__dict__ == js.decode(genes).__dict__
    assert ([p.name() for p in ts.enumerate_all(limit=40)]
            == [p.name() for p in js.enumerate_all(limit=40)])
    assert all(TNF.valid_tp(tc, t) == JNF.valid_tp(jc, t)
               for t in (1, 2, 3, 4, 7, 8, 16))


def test_design_space_fixes():
    """The reference's DSE fixes (``tests/test_properties.py``): an empty
    factorization raises, dp divides a train cell's batch, and a large-dp
    genome's microbatches are clamped to its own per-shard batch."""
    cfg, cell = get_config("tinyllama-1.1b"), SHAPE_BY_NAME["train_4k"]
    with pytest.raises(ValueError, match="no valid"):
        TNF.DesignSpace(cfg, cell, n_chips=7).fields()
    for dp, _tp in TNF.DesignSpace(cfg, cell, n_chips=16).fields()["dp_tp"]:
        assert cell.global_batch % dp == 0
    space = TNF.DesignSpace(cfg, cell, n_chips=256)
    f = space.fields()
    assert max(f["microbatches"]) > 1
    for i, j in product(range(len(f["dp_tp"])),
                        range(len(f["microbatches"]))):
        p = space.decode([i, j] + [0] * (len(f) - 2))
        assert p.microbatches <= max(1, cell.global_batch // max(1, p.dp))


def _summary(res):
    return ([(p.genes, p.objectives, p.violation, p.rank) for p in res.pareto],
            [(p.genes, p.objectives) for p in res.population],
            res.evaluations, res.history)


@pytest.mark.parametrize("seed", [0, 3, 11])
def test_run_moga_equals_reference(seed):
    """Analytical evaluator on TPU v5e (the reference's default): the same
    front, population, evaluation count and history; then the port's own
    default (H100, its 80 GB) runs and keeps a consistent front."""
    (jc, jcell), (tc, tcell) = _both("tinyllama-1.1b", "train_4k")
    kw = dict(pop_size=16, generations=4, seed=seed)
    want = JNF.run_moga(jc, jcell, **kw)
    got = TNF.run_moga(tc, tcell, hw=TNF.V5E,
                       constraints=TNF.Constraints(hbm_bytes=TNF.V5E.hbm_bytes),
                       **kw)
    assert _summary(got) == _summary(want)
    assert [p.point.__dict__ for p in got.pareto] == \
        [p.point.__dict__ for p in want.pareto]
    h100 = TNF.run_moga(tc, tcell, **kw)
    assert TNF.pareto_is_consistent(h100.pareto)
    assert TNF.Constraints().hbm_bytes == TNF.H100.hbm_bytes == 80e9
    assert h100.pareto[0].report.hw == TNF.H100


class _ToySpace:
    def bounds(self):
        return (5, 4, 3)

    def decode(self, genes):
        return tuple(g % b for g, b in zip(genes, self.bounds()))


def _toy_eval(p):
    # a trade-off: latency falls and capacity rises along axis 0
    return SimpleNamespace(latency_s=5.0 - p[0] + 0.1 * p[1],
                           hbm_capacity_per_chip=1.0 + p[0] + 0.2 * p[2],
                           collective_s=0.0)


def _toy_objectives(p, rep):
    return (rep.latency_s, rep.hbm_capacity_per_chip, float(p[1] + p[2]))


@pytest.mark.parametrize("seed", [1, 7])
def test_run_moga_injected_evaluator_equals_reference(seed):
    """An injected evaluator, space and objectives (the autoscaler's
    seam) and a latency constraint: identical to the reference's run."""
    (jc, jcell), (tc, tcell) = _both("tinyllama-1.1b", "train_4k")
    kw = dict(pop_size=12, generations=5, seed=seed, evaluate=_toy_eval,
              space=_ToySpace(), objectives=_toy_objectives)
    want = JNF.run_moga(jc, jcell, hw=JNF.V5E,
                        constraints=JNF.Constraints(hbm_bytes=4.0,
                                                    latency_s=3.5), **kw)
    got = TNF.run_moga(tc, tcell, hw=TNF.V5E,
                       constraints=TNF.Constraints(hbm_bytes=4.0,
                                                   latency_s=3.5), **kw)
    assert _summary(got) == _summary(want)
    assert TNF.pareto_is_consistent(got.pareto)


def test_non_dominated_matches_reference():
    def pool(mod):
        def ind(genes, obj, viol=0.0):
            return mod.Individual(genes=genes, point=genes, report=None,
                                  objectives=obj, violation=viol)
        return [ind((0, 0), (1.0, 2.0)), ind((0, 1), (2.0, 1.0)),
                ind((1, 1), (2.0, 2.0)), ind((0, 0), (1.0, 2.0)),
                ind((2, 2), (0.5, 3.0), viol=1.0), ind((3, 0), (0.9, 9.0))]
    got, want = TNF.non_dominated(pool(TNF)), JNF.non_dominated(pool(JNF))
    assert [p.genes for p in got] == [p.genes for p in want] == \
        [(3, 0), (0, 0), (0, 1)]
    assert TNF.pareto_is_consistent(got)
    assert not TNF.pareto_is_consistent(pool(TNF)[:3])


def test_validate_against_record_matches_reference():
    record = {
        "cost": {"flops_per_device": 3.1e14, "bytes_per_device": 2.2e11},
        "collectives": {"wire_bytes_per_chip": 4.5e9},
        "resolved_knobs": {"microbatches": 2, "remat": "full",
                           "param_dtype": "bfloat16", "moment_dtype": None,
                           "kv_quant": False, "attn_chunk": 1024,
                           "capacity_factor": 1.25, "width": 1.0},
    }
    (jc, jcell), (tc, tcell) = _both("tinyllama-1.1b", "train_4k")
    jpt = JVAL.point_from_record(record, mesh_dp=16, mesh_tp=16)
    tpt = TVAL.point_from_record(record, mesh_dp=16, mesh_tp=16)
    assert tpt.__dict__ == jpt.__dict__
    got = TVAL.validate_against_record(tc, tcell, tpt, record)
    want = JVAL.validate_against_record(jc, jcell, jpt, record)
    assert got.as_dict() == want.as_dict()
    assert (got.flops_err, got.bytes_ratio, got.coll_ratio) == \
        (want.flops_err, want.bytes_ratio, want.coll_ratio)
