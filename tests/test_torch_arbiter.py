"""The port's hyperparameter search (ROADMAP A12g) against the reference.

- the reference's own ``tests/test_arbiter.py`` bodies run against the
  port (``_torch_parity._reference_tests``), on the CPU: every one;
- given the same scores, the grid, random and Bayesian (TPE) generators
  propose the reference's candidates, exactly, minimizing and maximizing;
- the runner keeps every candidate's model, on the device its score
  function built it on;
- ``ArbiterUIServer`` over a ``StatsStorageCandidateListener`` serves the
  reference's JSON and page for the same search, NaN scores included.
"""
import json
import math
import urllib.request

import numpy as np
import pytest
import torch

import deeplearning4j_tpu.arbiter as RA
import deeplearning4j_tpu_torch.arbiter as TA
from deeplearning4j_tpu.ui.stats import InMemoryStatsStorage as RStorage
from deeplearning4j_tpu_torch.ui.stats import InMemoryStatsStorage as TStorage
from tests._torch_parity import (_cpu_default, _reference_tests,
                                 _run_reference_test)

pytestmark = pytest.mark.torch_port


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """These tests' small CPU ops run on one intra-op thread: beside the
    suite's other workers, a thread pool per op mostly waits."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


_, _CASES = _reference_tests("test_arbiter.py")


@pytest.mark.parametrize("name,case", _CASES, ids=[i for i, _ in _CASES])
def test_reference_arbiter_suite(name, case, tmp_path, monkeypatch):
    _cpu_default(monkeypatch)
    _run_reference_test(case, tmp_path, monkeypatch)


def test_no_reference_case_is_left_out():
    assert len(_CASES) == 6


def _spaces(pkg):
    return {"lr": pkg.ContinuousParameterSpace(1e-4, 1e-1, log=True),
            "mom": pkg.ContinuousParameterSpace(0.0, 1.0),
            "width": pkg.IntegerParameterSpace(16, 256),
            "act": pkg.DiscreteParameterSpace("relu", "tanh", "elu")}


def _score(p):
    """A surrogate with a NaN corner: a diverged candidate's score."""
    if p["lr"] > 0.02 and p["act"] != "relu":
        return float("nan")
    return float((math.log10(p["lr"]) + 2.5) ** 2 + (p["mom"] - 0.9) ** 2
                 + abs(p["width"] - 120) / 100.0
                 + {"relu": 0.0, "tanh": 0.3, "elu": 0.6}[p["act"]])


_GENERATORS = {
    "grid": lambda pkg: pkg.GridSearchCandidateGenerator(
        _spaces(pkg), discretizationCount=3),
    "random": lambda pkg: pkg.RandomSearchGenerator(_spaces(pkg), seed=11),
    "bayesian": lambda pkg: pkg.BayesianSearchGenerator(
        _spaces(pkg), seed=5, numInitialRandom=6),
}


def _search(pkg, storage, kind, minimize, n=30):
    runner = pkg.LocalOptimizationRunner(
        pkg.OptimizationConfiguration.builder()
        .candidateGenerator(_GENERATORS[kind](pkg)).scoreFunction(_score)
        .terminationConditions(pkg.MaxCandidatesCondition(n))
        .minimize(minimize).build())
    runner.addListener(pkg.StatsStorageCandidateListener(storage))
    best = runner.execute()
    return runner, best


@pytest.mark.parametrize("minimize", [True, False], ids=["min", "max"])
@pytest.mark.parametrize("kind", sorted(_GENERATORS))
def test_generator_sequences_are_the_references(kind, minimize):
    (rr, rb), (tr, tb) = (_search(RA, RStorage(), kind, minimize),
                          _search(TA, TStorage(), kind, minimize))
    assert [r.parameters for r in tr.results] == \
        [r.parameters for r in rr.results]
    np.testing.assert_array_equal([r.score for r in tr.results],
                                  [r.score for r in rr.results])
    assert tb.index == rb.index and tr.numCandidatesCompleted() == 30


def test_runner_keeps_every_candidates_model_where_it_was_built():
    from deeplearning4j_tpu_torch.learning import Adam
    from deeplearning4j_tpu_torch.models import MultiLayerNetwork
    from deeplearning4j_tpu_torch.nn.conf import NeuralNetConfiguration
    from deeplearning4j_tpu_torch.nn.conf.layers import (DenseLayer,
                                                         OutputLayer)
    rng = np.random.RandomState(0)
    x = rng.randn(32, 4).astype(np.float32)
    y = np.eye(2, dtype=np.float32)[rng.randint(0, 2, 32)]

    def score(p):
        net = MultiLayerNetwork(
            NeuralNetConfiguration.builder().seed(1).updater(Adam(p["lr"]))
            .list().layer(DenseLayer.builder().nIn(4).nOut(p["width"])
                          .activation("relu").build())
            .layer(OutputLayer.builder("mcxent").nIn(p["width"]).nOut(2)
                   .activation("softmax").build()).build(),
            device="cpu").init()
        net.fit(x, y)
        return net.score(), net
    runner = TA.LocalOptimizationRunner(
        TA.OptimizationConfiguration.builder()
        .candidateGenerator(TA.RandomSearchGenerator(
            {"lr": TA.ContinuousParameterSpace(1e-3, 1e-1),
             "width": TA.IntegerParameterSpace(2, 8)}, seed=1))
        .scoreFunction(score)
        .terminationConditions(TA.MaxCandidatesCondition(4)).build())
    runner.execute()
    models = [r.model for r in runner.results]
    assert len({id(m) for m in models}) == 4
    for m, r in zip(models, runner.results):
        assert m.device == torch.device("cpu")
        assert m.params_["0"]["W"].shape[1] == r.parameters["width"]


def _get(port, path):
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}") as r:
        return r.read().decode()


@pytest.mark.parametrize("minimize", [True, False], ids=["min", "max"])
def test_board_serves_the_references_json_and_page(minimize):
    pages = []
    for pkg, storage in ((RA, RStorage()), (TA, TStorage())):
        runner, _ = _search(pkg, storage, "bayesian", minimize, n=14)
        srv = pkg.ArbiterUIServer(storage, minimize=minimize).start()
        try:
            pages.append((json.loads(_get(srv.port, "/data")),
                          _get(srv.port, "/")))
        finally:
            srv.stop()
    (rdata, rpage), (tdata, tpage) = pages
    assert tdata == rdata and len(tdata) == 14
    assert any(r["score"] is None for r in tdata)       # NaN -> null
    assert tpage == rpage and "polyline" in tpage
