"""Multi-objective genetic algorithm for NeuroForge DSE (paper Algorithm 1).

Port of ``repro.core.neuroforge.moga``: the same NSGA-II loop drawing from
Python's ``random.Random(seed)``, so for one seed, evaluator and ``hw`` its
fronts equal the reference's exactly. The defaults target the port's
card: ``hw`` is ``DEFAULT_HW`` (H100) and ``Constraints.hbm_bytes`` its
80 GB, where the reference's are TPU v5e's.

NSGA-II with Deb's constraint domination: feasible individuals dominate
infeasible ones; among infeasible, smaller total violation wins. Mutation
follows the paper's power-distribution scheme:

    x(i) <- x(i) - s * (x(i) - lb(i))   if t < r
            x(i) + s * (ub(i) - x(i))   otherwise

with s drawn from a power distribution — implemented on the integer genome.

Objectives (minimize), mapping the paper's Y = {Y_t, Y_DSP, Y_LUT, Y_BRAM}:
    Y_t    -> latency_s        (analytical roofline max-term)
    Y_DSP  -> hbm_capacity     (the binding per-chip resource)
    Y_LUT  -> collective_s     (interconnect pressure)
Constraints: hbm_capacity <= budget, optional latency target.
"""
from __future__ import annotations

import dataclasses
import random
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from repro_torch.configs.base import ModelConfig, ShapeCell
from repro_torch.core.neuroforge.analytical import CostReport, estimate
from repro_torch.core.neuroforge.hw import DEFAULT_HW, HardwareSpec
from repro_torch.core.neuroforge.space import DesignPoint, DesignSpace


@dataclass
class Constraints:
    hbm_bytes: float = DEFAULT_HW.hbm_bytes
    latency_s: Optional[float] = None


@dataclass
class Individual:
    genes: Tuple[int, ...]
    point: DesignPoint
    report: CostReport
    objectives: Tuple[float, ...]
    violation: float
    rank: int = 0
    crowding: float = 0.0

    @property
    def feasible(self) -> bool:
        return self.violation <= 0.0


def _dominates(a: Individual, b: Individual) -> bool:
    """Deb's constrained domination."""
    if a.feasible and not b.feasible:
        return True
    if not a.feasible and b.feasible:
        return False
    if not a.feasible and not b.feasible:
        return a.violation < b.violation
    le = all(x <= y for x, y in zip(a.objectives, b.objectives))
    lt = any(x < y for x, y in zip(a.objectives, b.objectives))
    return le and lt


def _non_dominated_sort(pop: List[Individual]) -> List[List[Individual]]:
    fronts: List[List[Individual]] = [[]]
    S: Dict[int, List[int]] = {}
    n: Dict[int, int] = {}
    for i, p in enumerate(pop):
        S[i], n[i] = [], 0
        for j, q in enumerate(pop):
            if i == j:
                continue
            if _dominates(p, q):
                S[i].append(j)
            elif _dominates(q, p):
                n[i] += 1
        if n[i] == 0:
            p.rank = 0
            fronts[0].append(p)
    idx_of = {id(p): i for i, p in enumerate(pop)}
    k = 0
    while fronts[k]:
        nxt: List[Individual] = []
        for p in fronts[k]:
            for j in S[idx_of[id(p)]]:
                n[j] -= 1
                if n[j] == 0:
                    pop[j].rank = k + 1
                    nxt.append(pop[j])
        k += 1
        fronts.append(nxt)
    return [f for f in fronts if f]


def _crowding(front: List[Individual]) -> None:
    if not front:
        return
    m = len(front[0].objectives)
    for p in front:
        p.crowding = 0.0
    for k in range(m):
        front.sort(key=lambda p: p.objectives[k])
        front[0].crowding = front[-1].crowding = float("inf")
        lo, hi = front[0].objectives[k], front[-1].objectives[k]
        span = max(hi - lo, 1e-30)
        for i in range(1, len(front) - 1):
            front[i].crowding += (front[i + 1].objectives[k] -
                                  front[i - 1].objectives[k]) / span


@dataclass
class MogaResult:
    pareto: List[Individual]
    population: List[Individual]
    evaluations: int
    history: List[Dict] = field(default_factory=list)


def run_moga(cfg: ModelConfig, cell: ShapeCell, *, n_chips: int = 256,
             n_pods: int = 1, constraints: Optional[Constraints] = None,
             pop_size: int = 48, generations: int = 30, seed: int = 0,
             hw: HardwareSpec = DEFAULT_HW,
             evaluate: Optional[Callable[[DesignPoint], CostReport]] = None,
             space=None,
             objectives: Optional[Callable[[DesignPoint, CostReport],
                                           Tuple[float, ...]]] = None) -> MogaResult:
    """NSGA-II over the design space. ``evaluate`` defaults to the analytical
    model; tests may inject a different evaluator (e.g. compiled ground truth).
    ``space`` may replace the default ``DesignSpace`` with any object exposing
    ``bounds()``/``decode()`` (the serving autoscaler searches a runtime pool of
    executables rather than launch-time shardings), and ``objectives`` maps a
    decoded point + its report to the minimized objective vector.
    """
    rng = random.Random(seed)
    space = space if space is not None else DesignSpace(cfg, cell, n_chips=n_chips)
    bounds = space.bounds()
    cons = constraints or Constraints()
    ev = evaluate or (lambda p: estimate(cfg, cell, p, hw=hw, n_pods=n_pods))
    obj_fn = objectives or (lambda p, rep: (rep.latency_s, rep.hbm_capacity_per_chip,
                                            rep.collective_s))
    n_evals = 0
    cache: Dict[Tuple[int, ...], Individual] = {}

    def make(genes: Tuple[int, ...]) -> Individual:
        nonlocal n_evals
        genes = tuple(g % b for g, b in zip(genes, bounds))
        if genes in cache:
            return dataclasses.replace(cache[genes])
        point = space.decode(genes)
        rep = ev(point)
        n_evals += 1
        obj = tuple(obj_fn(point, rep))
        viol = max(0.0, (rep.hbm_capacity_per_chip - cons.hbm_bytes) / cons.hbm_bytes)
        if cons.latency_s is not None:
            viol += max(0.0, (rep.latency_s - cons.latency_s) / cons.latency_s)
        ind = Individual(genes=genes, point=point, report=rep, objectives=obj,
                         violation=viol)
        cache[genes] = ind
        return dataclasses.replace(ind)

    def mutate(genes: Tuple[int, ...]) -> Tuple[int, ...]:
        out = list(genes)
        for i, b in enumerate(bounds):
            if rng.random() < 1.0 / max(len(bounds), 1):
                s = rng.random() ** 2.0  # power-distribution step (paper Alg. 1)
                if rng.random() < 0.5:
                    out[i] = int(out[i] - s * out[i])
                else:
                    out[i] = int(out[i] + s * (b - 1 - out[i]) + 0.999)
                out[i] = max(0, min(b - 1, out[i]))
        return tuple(out)

    def crossover(a: Tuple[int, ...], b: Tuple[int, ...]) -> Tuple[int, ...]:
        return tuple(x if rng.random() < 0.5 else y for x, y in zip(a, b))

    def tourney(pop: List[Individual]) -> Individual:
        a, b = rng.choice(pop), rng.choice(pop)
        if (a.rank, -a.crowding) <= (b.rank, -b.crowding):
            return a
        return b

    pop = [make(tuple(rng.randrange(b) for b in bounds)) for _ in range(pop_size)]
    history: List[Dict] = []
    for gen in range(generations):
        fronts = _non_dominated_sort(pop)
        for f in fronts:
            _crowding(f)
        # a few random immigrants per generation keep exploration pressure
        # once tournament selection has converged the mating pool — without
        # them an unlucky seed can stall on a local front and lose to
        # random search at equal evaluation budget
        children = [make(tuple(rng.randrange(b) for b in bounds))
                    for _ in range(max(1, pop_size // 12))]
        while len(children) < pop_size:
            p1, p2 = tourney(pop), tourney(pop)
            child = mutate(crossover(p1.genes, p2.genes))
            children.append(make(child))
        union = pop + children
        fronts = _non_dominated_sort(union)
        new_pop: List[Individual] = []
        for f in fronts:
            _crowding(f)
            if len(new_pop) + len(f) <= pop_size:
                new_pop.extend(f)
            else:
                f.sort(key=lambda p: -p.crowding)
                new_pop.extend(f[: pop_size - len(new_pop)])
                break
        pop = new_pop
        best = min(p.objectives[0] for p in pop if p.feasible) \
            if any(p.feasible for p in pop) else float("inf")
        history.append({"gen": gen, "best_latency": best,
                        "feasible": sum(p.feasible for p in pop)})
    fronts = _non_dominated_sort(pop)
    pareto = [p for p in fronts[0] if p.feasible] or fronts[0]
    seen = set()
    unique = []
    for p in pareto:
        if p.genes not in seen:
            seen.add(p.genes)
            unique.append(p)
    unique.sort(key=lambda p: p.objectives[0])
    return MogaResult(pareto=unique, population=pop, evaluations=n_evals,
                      history=history)


def non_dominated(pop: Sequence[Individual]) -> List[Individual]:
    """Exact Pareto filter over an arbitrary individual pool (Deb's
    constrained domination), deduped by genes and sorted by the first
    objective. The serving autoscaler merges the MOGA's final population
    with an exhaustive sweep of its (small) runtime space and refines the
    front through this — a dominated point must never protect an
    executable from eviction just because its dominator missed the
    sampled population."""
    out: List[Individual] = []
    seen = set()
    for i, a in enumerate(pop):
        if a.genes in seen:
            continue
        if any(_dominates(b, a) for j, b in enumerate(pop) if j != i):
            continue
        seen.add(a.genes)
        out.append(a)
    out.sort(key=lambda p: p.objectives[0])
    return out


def pareto_is_consistent(pareto: Sequence[Individual]) -> bool:
    """No member of the front may dominate another (test invariant)."""
    for i, a in enumerate(pareto):
        for j, b in enumerate(pareto):
            if i != j and _dominates(a, b):
                return False
    return True
