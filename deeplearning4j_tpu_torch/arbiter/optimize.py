"""Hyperparameter search: parameter spaces, generators, runner — the port of
``deeplearning4j_tpu/arbiter/optimize.py``, a copy of its host numpy.

Reference: arbiter ``org/deeplearning4j/arbiter/optimize/api/
ParameterSpace.java`` (Continuous/Discrete/Integer spaces),
``generator/{GridSearchCandidateGenerator,RandomSearchGenerator}.java``,
``OptimizationConfiguration`` + ``LocalOptimizationRunner`` with
termination conditions and a score function.

Candidates evaluate one after another in the calling process; the score
function builds each candidate's model where it chooses (the card, by the
models' default).  Every result keeps its model, as the reference's do:
on the card, every candidate's net stays allocated until the runner goes.
The UI is ``arbiter/ui.py``; results carry (params, score, model) triples.
"""
from __future__ import annotations

import itertools
import math
import time
from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np


# ------------------------------------------------------------- spaces ----

class ParameterSpace:
    def randomValue(self, rng) -> Any:
        raise NotImplementedError

    def gridValues(self, discretization: int) -> List:
        raise NotImplementedError


class ContinuousParameterSpace(ParameterSpace):
    """Uniform (optionally log-uniform) float range."""

    def __init__(self, minValue: float, maxValue: float, log: bool = False):
        self.lo, self.hi, self.log = float(minValue), float(maxValue), log

    def randomValue(self, rng):
        if self.log:
            return float(np.exp(rng.uniform(np.log(self.lo),
                                            np.log(self.hi))))
        return float(rng.uniform(self.lo, self.hi))

    def gridValues(self, discretization: int):
        if self.log:
            return [float(v) for v in np.exp(np.linspace(
                np.log(self.lo), np.log(self.hi), discretization))]
        return [float(v) for v in np.linspace(self.lo, self.hi,
                                              discretization)]


class IntegerParameterSpace(ParameterSpace):
    def __init__(self, minValue: int, maxValue: int):
        self.lo, self.hi = int(minValue), int(maxValue)

    def randomValue(self, rng):
        return int(rng.randint(self.lo, self.hi + 1))

    def gridValues(self, discretization: int):
        vals = np.unique(np.linspace(self.lo, self.hi,
                                     discretization).round().astype(int))
        return [int(v) for v in vals]


class DiscreteParameterSpace(ParameterSpace):
    def __init__(self, *values):
        self.values = list(values[0]) if len(values) == 1 and \
            isinstance(values[0], (list, tuple)) else list(values)

    def randomValue(self, rng):
        return self.values[rng.randint(len(self.values))]

    def gridValues(self, discretization: int):
        return list(self.values)


# ---------------------------------------------------------- generators ----

class CandidateGenerator:
    def __init__(self, spaces: Dict[str, ParameterSpace]):
        self.spaces = spaces

    def candidates(self):
        raise NotImplementedError

    def report(self, params: Dict, score: float) -> None:
        """Feedback hook the runner calls after scoring a candidate
        (reference: BaseCandidateGenerator.reportResults).  Sequential
        model-based generators (TPE) use it; random/grid ignore it."""


class RandomSearchGenerator(CandidateGenerator):
    """Reference: RandomSearchGenerator — endless random draws."""

    def __init__(self, spaces: Dict[str, ParameterSpace], seed: int = 123):
        super().__init__(spaces)
        self.rng = np.random.RandomState(seed)

    def candidates(self):
        while True:
            yield {k: s.randomValue(self.rng)
                   for k, s in self.spaces.items()}


class BayesianSearchGenerator(CandidateGenerator):
    """Sequential model-based search — TPE-lite.

    Reference role: arbiter's Bayesian optimization option (SURVEY.md
    §2.7).  Algorithm (Bergstra et al.'s Tree-structured Parzen Estimator,
    simplified): after ``numInitialRandom`` random draws, observed
    candidates are split at the ``gamma`` score quantile into good l(x)
    and bad g(x) sets; each new candidate is the best of ``nCandidates``
    samples drawn from a Parzen (KDE) model of the GOOD set, ranked by the
    density ratio l(x)/g(x).  Continuous/integer dimensions use Gaussian
    kernels (log-space when the space is log-scaled); discrete dimensions
    use smoothed categorical counts.
    """

    def __init__(self, spaces: Dict[str, ParameterSpace], seed: int = 123,
                 minimize: bool = True, numInitialRandom: int = 8,
                 gamma: float = 0.25, nCandidates: int = 24,
                 priorWeight: float = 0.2):
        super().__init__(spaces)
        self.rng = np.random.RandomState(seed)
        self.minimize = minimize
        self.n0 = int(numInitialRandom)
        self.gamma = float(gamma)
        self.nCand = int(nCandidates)
        self.priorWeight = float(priorWeight)
        self._hist: List[tuple] = []    # (params, score)

    def report(self, params: Dict, score: float) -> None:
        self._hist.append((params, float(score)))

    # -- per-dimension Parzen helpers -----------------------------------
    def _raw(self, space, v):
        if isinstance(space, ContinuousParameterSpace) and space.log:
            return math.log(v)
        return float(v) if not isinstance(space, DiscreteParameterSpace) \
            else v

    def _fit_dim(self, space, vals):
        """Fit one dimension's Parzen model ONCE per round (reused for
        all nCandidates samples + density evaluations)."""
        if isinstance(space, DiscreteParameterSpace):
            counts = {v: 1.0 for v in space.values}        # +1 smoothing
            for v in vals:
                counts[v] = counts.get(v, 1.0) + 1.0
            return ("cat", counts, sum(counts.values()))
        xs = np.asarray([self._raw(space, v) for v in vals])
        lo, hi = space.lo, space.hi
        if isinstance(space, ContinuousParameterSpace) and space.log:
            lo, hi = math.log(lo), math.log(hi)
        # shrink the kernel as evidence accumulates so proposals refine
        bw = max(xs.std() * len(xs) ** -0.25, (hi - lo) / 60.0, 1e-12)
        return ("kde", xs, lo, hi, bw)

    def _sample_dim(self, space, model):
        # TPE's Parzen estimator mixes the uniform PRIOR into l(x) — that
        # mixture is what keeps exploration alive after the model locks on
        if self.rng.rand() < self.priorWeight:
            return space.randomValue(self.rng)
        if model[0] == "cat":
            _, counts, _total = model
            vals = list(counts)
            p = np.asarray([counts[v] for v in vals])
            return vals[self.rng.choice(len(vals), p=p / p.sum())]
        _, xs, lo, hi, bw = model
        x = xs[self.rng.randint(len(xs))] + bw * self.rng.randn()
        x = float(np.clip(x, lo, hi))
        if isinstance(space, ContinuousParameterSpace):
            return float(math.exp(x)) if space.log else x
        return int(round(x))

    def _log_density(self, space, model, v):
        """log of the PRIOR-MIXED Parzen density (1-w)*KDE + w*uniform.
        The prior component is load-bearing: it keeps unexplored regions
        at ratio≈0 while an over-exploited cluster accumulates bad-set
        density and goes ratio<0 — that is TPE's escape mechanism."""
        w = self.priorWeight
        if model[0] == "cat":
            _, counts, total = model
            return math.log((1 - w) * counts.get(v, 1.0) / total
                            + w / len(space.values))
        _, xs, lo, hi, bw = model
        x = self._raw(space, v)
        z = (x - xs) / bw
        kde = np.exp(-0.5 * z * z).sum() / (len(xs) * bw * 2.5066282746)
        return math.log(max((1 - w) * kde + w / max(hi - lo, 1e-12),
                            1e-300))

    def candidates(self):
        while True:
            if len(self._hist) < self.n0:
                yield {k: s.randomValue(self.rng)
                       for k, s in self.spaces.items()}
                continue
            # hyperopt-style selectivity: the good set is only the TOP
            # ~gamma*sqrt(n) observations — a large good set drags l(x)
            # toward the history centroid and the search crawls
            n = len(self._hist)
            n_good = max(3, int(math.ceil(
                4.0 * self.gamma * math.sqrt(n))))
            order = sorted(self._hist, key=lambda t: t[1],
                           reverse=not self.minimize)
            good = [p for p, _ in order[:n_good]]
            bad = [p for p, _ in order[n_good:]] or [p for p, _ in order]
            gm = {k: self._fit_dim(sp, [g[k] for g in good])
                  for k, sp in self.spaces.items()}
            bm = {k: self._fit_dim(sp, [b[k] for b in bad])
                  for k, sp in self.spaces.items()}
            best, best_ratio = None, -math.inf
            for _ in range(self.nCand):
                cand = {k: self._sample_dim(sp, gm[k])
                        for k, sp in self.spaces.items()}
                ratio = sum(
                    self._log_density(sp, gm[k], cand[k])
                    - self._log_density(sp, bm[k], cand[k])
                    for k, sp in self.spaces.items())
                if ratio > best_ratio:
                    best, best_ratio = cand, ratio
            yield best


class GridSearchCandidateGenerator(CandidateGenerator):
    """Reference: GridSearchCandidateGenerator — cartesian product with a
    per-continuous-space discretization count."""

    def __init__(self, spaces: Dict[str, ParameterSpace],
                 discretizationCount: int = 5):
        super().__init__(spaces)
        self.disc = discretizationCount

    def candidates(self):
        keys = list(self.spaces)
        grids = [self.spaces[k].gridValues(self.disc) for k in keys]
        for combo in itertools.product(*grids):
            yield dict(zip(keys, combo))


# ---------------------------------------------------------- termination ----

class MaxCandidatesCondition:
    def __init__(self, n: int):
        self.n = n

    def start(self):
        self._count = 0

    def terminate(self, result) -> bool:
        self._count += 1
        return self._count >= self.n


class MaxTimeCondition:
    def __init__(self, duration: float, unit: str = "seconds"):
        mult = {"seconds": 1.0, "minutes": 60.0, "hours": 3600.0}[unit]
        self.maxSeconds = duration * mult

    def start(self):
        self._t0 = time.time()

    def terminate(self, result) -> bool:
        return (time.time() - self._t0) >= self.maxSeconds


# ------------------------------------------------------------- runner ----

class OptimizationResult:
    def __init__(self, parameters: Dict, score: float, model=None,
                 index: int = 0):
        self.parameters = parameters
        self.score = score
        self.model = model
        self.index = index

    def getScore(self) -> float:
        return self.score

    def __repr__(self):
        return f"OptimizationResult(#{self.index} score={self.score:.5f} " \
               f"params={self.parameters})"


class OptimizationConfiguration:
    """Builder parity with the reference: candidateGenerator + scoreFunction
    (+ terminationConditions).  ``scoreFunction(candidate_params) ->
    (score, model)`` or plain score; minimization by default."""

    def __init__(self, candidateGenerator: CandidateGenerator,
                 scoreFunction: Callable,
                 terminationConditions: Optional[Sequence] = None,
                 minimize: bool = True):
        self.generator = candidateGenerator
        self.scoreFunction = scoreFunction
        self.terminationConditions = list(terminationConditions or
                                          [MaxCandidatesCondition(10)])
        self.minimize = minimize

    class Builder:
        def __init__(self):
            self._kw = {}

        def candidateGenerator(self, g):
            self._kw["candidateGenerator"] = g
            return self

        def scoreFunction(self, f):
            self._kw["scoreFunction"] = f
            return self

        def terminationConditions(self, *conds):
            self._kw["terminationConditions"] = list(conds)
            return self

        def minimize(self, b: bool):
            self._kw["minimize"] = b
            return self

        def build(self) -> "OptimizationConfiguration":
            return OptimizationConfiguration(**self._kw)

    @staticmethod
    def builder() -> "OptimizationConfiguration.Builder":
        return OptimizationConfiguration.Builder()


class LocalOptimizationRunner:
    """Reference: LocalOptimizationRunner — evaluate candidates until a
    termination condition fires; keeps every result + the best."""

    def __init__(self, config: OptimizationConfiguration):
        self.config = config
        self.results: List[OptimizationResult] = []
        self._listeners: List = []

    def addListener(self, listener) -> None:
        """Listener with ``candidateScored(result)`` (reference: arbiter
        StatusListener feeding the UI)."""
        self._listeners.append(listener)

    def execute(self) -> OptimizationResult:
        cfg = self.config
        # the config owns the optimization direction — sync it into
        # model-based generators so the two can't silently disagree
        if hasattr(cfg.generator, "minimize"):
            cfg.generator.minimize = cfg.minimize
        for c in cfg.terminationConditions:
            c.start()
        best: Optional[OptimizationResult] = None
        for i, cand in enumerate(cfg.generator.candidates()):
            out = cfg.scoreFunction(cand)
            score, model = out if isinstance(out, tuple) else (out, None)
            res = OptimizationResult(cand, float(score), model, i)
            self.results.append(res)
            cfg.generator.report(cand, float(score))
            for li in self._listeners:
                try:
                    li.candidateScored(res)
                except Exception:   # noqa: BLE001
                    # a MONITORING failure must never kill the search it
                    # watches (same contract as ui/stats remote router)
                    import logging
                    logging.getLogger(__name__).warning(
                        "arbiter listener failed", exc_info=True)
            better = best is None or (
                res.score < best.score if cfg.minimize
                else res.score > best.score)
            if better:
                best = res
            if any(c.terminate(res) for c in cfg.terminationConditions):
                break
        return best

    def bestScore(self) -> float:
        best = min(self.results, key=lambda r: r.score) if \
            self.config.minimize else max(self.results,
                                          key=lambda r: r.score)
        return best.score

    def numCandidatesCompleted(self) -> int:
        return len(self.results)
