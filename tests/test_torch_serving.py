"""Port parity of the serving tier (``remote/serving.py``,
``remote/server.py``): bucket and admission decisions, ``ForwardServing``
(rank 2, and rank 3 with padding masks) and ``GenerativeServing`` through
a ``BucketedExecutor``, offender-only 400s, and one HTTP round trip per
server whose status codes, JSON keys and headers must be the reference's.

Models: a small MLP and ``tests/_torch_parity.py``'s attention net, built
with each package's config DSL, the port's from the reference's
parameters; outputs within 1e-5 (float32 both).  The tiny LM and the
near-tie rule for tokens are ``tests/_torch_serving.py``'s.  Every server
and executor stops in a ``finally``.
"""
import json
import threading

import jax
import numpy as np
import pytest

import deeplearning4j_tpu.remote as jrem
import deeplearning4j_tpu.telemetry as jtel
import deeplearning4j_tpu_torch.remote as trem
import deeplearning4j_tpu_torch.telemetry as ttel
from _torch_parity import JAX, PORT, _conf
from _torch_serving import (assert_tokens, get, lm_pair, post, post_stream,
                            prompts)
from deeplearning4j_tpu_torch.autodiff import SameDiff

pytestmark = pytest.mark.torch_port

OUT_ATOL = 1e-5
REM = {"reference": jrem, "port": trem}


def _mlp(pkg, nIn=4, nOut=3):
    return (pkg.conf.NeuralNetConfiguration.builder().seed(1)
            .updater(pkg.learn.Adam(1e-2)).list()
            .layer(pkg.layers.DenseLayer.builder().nIn(nIn).nOut(8)
                   .activation("relu").build())
            .layer(pkg.layers.OutputLayer.builder("mcxent").nIn(8)
                   .nOut(nOut).activation("softmax").build())
            .build())


def _net_pair(conf_fn):
    """(reference net, port net on the CPU from its parameters)."""
    jnet = JAX.models.MultiLayerNetwork(conf_fn(JAX)).init()
    net = PORT.models.MultiLayerNetwork(conf_fn(PORT), device="cpu").init(
        params=jax.tree.map(np.array, jnet.params_))
    return jnet, net


@pytest.fixture(scope="module")
def mlps():
    return _net_pair(_mlp)


@pytest.fixture(scope="module")
def lms():
    return lm_pair()


def _submit_all(ex, payloads, timeout=60):
    """Submit concurrently; returns results (or the exceptions) in
    order.  Every thread is joined with a timeout."""
    out = [None] * len(payloads)

    def run(i):
        try:
            out[i] = ex.submit(payloads[i], timeout)
        except Exception as e:       # noqa: BLE001 — returned to compare
            out[i] = e

    threads = [threading.Thread(target=run, args=(i,))
               for i in range(len(payloads))]
    try:
        for th in threads:
            th.start()
    finally:
        for th in threads:
            th.join(timeout + 30)
    assert not any(th.is_alive() for th in threads)
    return out


# ---------------------------------------------------------------------------
# decisions
# ---------------------------------------------------------------------------

def test_bucket_ladder_decisions_identical():
    kw = dict(batchSizes=(4, 1, 2), seqLens=(32, 8, 16))
    lad = {k: m.BucketLadder(**kw) for k, m in REM.items()}
    for n in range(1, 7):
        assert lad["port"].batchBucket(n) == lad["reference"].batchBucket(n)
    for t in range(1, 33):
        assert lad["port"].seqBucket(t) == lad["reference"].seqBucket(t)
    for lad_ in lad.values():
        with pytest.raises(ValueError, match="exceeds the top bucket 32"):
            lad_.seqBucket(33)
    assert (lad["port"].maxBatch, lad["port"].maxSeq) == (4, 32)
    with pytest.raises(ValueError, match="at least one batch bucket"):
        trem.BucketLadder(batchSizes=())


def test_admission_decisions_identical():
    """Queue-depth and p99 rules (the latter only under a backlog) and the
    KV-headroom shed with its retire-rate Retry-After, over a grid: the
    same verdicts, details and waits."""
    got = {}
    for k, m in REM.items():
        tel = jtel if k == "reference" else ttel
        prev = tel.set_registry(tel.MetricsRegistry())
        try:
            ac = m.AdmissionControl(maxQueueRows=3, p99Threshold=0.5,
                                    retryAfter=1.5, minFreePages=2,
                                    maxKvRetryAfter=20.0)
            ac.bind("lm")
            sm = tel.serving_metrics()
            rows = []
            for depth, p99, queued in [(0, 0.1, 0), (3, 0.1, 3),
                                       (1, 0.9, 0), (1, 0.9, 2)]:
                sm.queue_depth().set(depth, model="lm")
                sm.p99_seconds().set(p99, model="lm")
                rows.append(ac.check(queued))
            for free, need, rate, holds in [(10, 4, 0.0, True),
                                            (5, 4, 0.0, True),
                                            (5, 4, 2.0, True),
                                            (1, 30, 0.5, True),
                                            (3, 9, 100.0, True),
                                            (0, 9, 0.0, False)]:
                rows.append(ac.checkKv(free, need, rate, holdsPages=holds))
            got[k] = rows
        finally:
            tel.set_registry(prev)
    assert got["port"] == got["reference"]
    assert got["port"][1][0] == "serving_queue_full"
    assert got["port"][3][0] == "serving_p99_high" and got["port"][2] is None
    assert got["port"][6][2] == 1.5 and got["port"][7][2] == 20.0


# ---------------------------------------------------------------------------
# adapters through a BucketedExecutor
# ---------------------------------------------------------------------------

def test_forward_serving_rank2_matches_reference(mlps):
    """Ragged row counts coalesce, pad to a batch bucket and chunk at the
    top one (4); each request's rows equal the reference's and the
    unpadded forward."""
    jnet, net = mlps
    rng = np.random.RandomState(0)
    xs = [rng.randn(n, 4).astype(np.float32) for n in (1, 3, 6, 2, 5)]
    outs = {}
    for k, m in REM.items():
        model = jnet if k == "reference" else net
        ex = m.BucketedExecutor(
            m.ForwardServing(model, m.BucketLadder(batchSizes=(1, 2, 4),
                                                   seqLens=()),
                             inputShape=(4,)), name=f"fwd2-{k}").start()
        try:
            outs[k] = _submit_all(ex, xs)
        finally:
            ex.shutdown()
    for x, o, r in zip(xs, outs["port"], outs["reference"]):
        assert isinstance(o, np.ndarray) and o.shape == (len(x), 3)
        np.testing.assert_allclose(o, np.asarray(r), atol=OUT_ATOL, rtol=0)
        np.testing.assert_allclose(o, net.output(x).numpy(), atol=OUT_ATOL,
                                   rtol=0)


def test_forward_serving_rank3_masks_match_reference():
    """Sequences of 5, 11 and 16 steps pad to buckets 8 and 16 with a
    features mask: outputs at the real steps equal the reference's and the
    unpadded forward (the attention honours the mask)."""
    jnet, net = _net_pair(lambda pkg: _conf(pkg, t=-1))
    rng = np.random.RandomState(1)
    xs = [rng.randn(2, 16, t).astype(np.float32) for t in (5, 11, 16, 5)]
    outs = {}
    for k, m in REM.items():
        model = jnet if k == "reference" else net
        ex = m.BucketedExecutor(
            m.ForwardServing(model, m.BucketLadder(batchSizes=(2, 4),
                                                   seqLens=(8, 16)),
                             inputShape=(16, None)),
            name=f"fwd3-{k}").start()
        try:
            outs[k] = _submit_all(ex, xs)
            with pytest.raises(ValueError, match="top bucket"):
                ex.submit(rng.randn(1, 16, 17).astype(np.float32))
        finally:
            ex.shutdown()
    for x, o, r in zip(xs, outs["port"], outs["reference"]):
        assert o.shape == (2, 4, x.shape[2])
        np.testing.assert_allclose(o, np.asarray(r), atol=OUT_ATOL, rtol=0)
        np.testing.assert_allclose(o, net.output(x).numpy(), atol=OUT_ATOL,
                                   rtol=0)


def test_generative_serving_matches_reference(lms):
    """Ragged prompts grouped by prompt bucket, left-padded, one
    ``generate`` per group: the port's tokens are the reference's (near-
    tie rule) and its own ``generate``'s of each prompt alone."""
    jlm, tlm = lms
    ps = prompts(6, 3, 30, seed=2)
    quotas = [4, 9, 6, 12, 3, 8]
    payloads = [{"tokens": p.tolist(), "maxNewTokens": q}
                for p, q in zip(ps, quotas)]
    outs = {}
    for k, m in REM.items():
        lm = jlm if k == "reference" else tlm
        ex = m.BucketedExecutor(
            m.GenerativeServing(lm, m.BucketLadder(batchSizes=(1, 2, 4),
                                                   seqLens=(16, 32))),
            name=f"gen-{k}").start()
        try:
            outs[k] = _submit_all(ex, payloads)
        finally:
            ex.shutdown()
    for o, q in zip(outs["port"], quotas):
        assert o.shape == (1, q) and o.dtype == np.int32
    assert_tokens(jlm, ps, outs["port"], outs["reference"])
    alone = [tlm.generate(p[None], q) for p, q in zip(ps, quotas)]
    assert_tokens(jlm, ps, outs["port"], alone)


def test_offender_only_400s(mlps, lms):
    """A malformed request fails alone, at validation, in both packages:
    its neighbours in the same executor still answer."""
    jnet, net = mlps
    jlm, tlm = lms
    bad_fwd = [np.zeros((1, 5), np.float32), np.zeros((0, 4), np.float32),
               np.zeros((4,), np.float32)]
    bad_gen = [{"tokens": []}, {"tokens": [1, 64]}, {"tokens": [1, 2],
               "maxNewTokens": 0}, {"tokens": [1] * 33}, {"toks": [1]},
               {"tokens": [1] * 30, "maxNewTokens": 40}]
    errs = {}
    for k, m in REM.items():
        fs = m.ForwardServing(jnet if k == "reference" else net,
                              m.BucketLadder(batchSizes=(2,), seqLens=()),
                              inputShape=(4,))
        gs = m.GenerativeServing(jlm if k == "reference" else tlm,
                                 m.BucketLadder(batchSizes=(2,),
                                                seqLens=(16, 32)))
        fex = m.BucketedExecutor(fs, name=f"bad-f-{k}").start()
        gex = m.BucketedExecutor(gs, name=f"bad-g-{k}").start()
        try:
            res = _submit_all(fex, bad_fwd + [np.ones((1, 4), np.float32)])
            res += _submit_all(gex, bad_gen + [{"tokens": [1, 2, 3],
                                                "maxNewTokens": 2}])
        finally:
            fex.shutdown()
            gex.shutdown()
        errs[k] = [type(r).__name__ for r in res]
        assert isinstance(res[len(bad_fwd)], np.ndarray)
        assert isinstance(res[-1], np.ndarray)
    assert errs["port"] == errs["reference"]
    assert errs["port"].count("ValueError") == len(bad_fwd) + len(bad_gen)


def test_waits_raise_naming_their_roadmap_items(mlps, monkeypatch):
    _, net = mlps
    with pytest.raises(NotImplementedError, match="A10"):
        trem.JsonModelServer(net, parallelInference=True)
    assert trem.ForwardServing(net).compileCacheSize() is None
    # the OTLP half no longer waits: start() brings the exporter up from
    # DL4J_TPU_OTLP_ENDPOINT as the reference's does (its interval from
    # DL4J_TPU_OTLP_INTERVAL)
    monkeypatch.setenv("DL4J_TPU_OTLP_ENDPOINT", "http://127.0.0.1:1/")
    monkeypatch.setenv("DL4J_TPU_OTLP_INTERVAL", "30")
    prev = {m: m.set_otlp_exporter(None) for m in (jtel, ttel)}
    srv = trem.InferenceServer(trem.ModelRegistry()).start()
    try:
        exp, ref = ttel.otlp_exporter(), jtel.ensure_otlp_exporter(
            start=False)
        assert exp is not None and exp._thread.is_alive()
        assert (exp.endpoint, exp.interval) == (ref.endpoint, ref.interval) \
            == ("http://127.0.0.1:1", 30.0)
    finally:
        srv.stop()
        for m, p in prev.items():
            e = m.set_otlp_exporter(p)
            if e is not None:
                e.stop()


# ---------------------------------------------------------------------------
# HTTP: the same script against both packages' servers
# ---------------------------------------------------------------------------

def _inference_script(port, x, toks):
    """A fixed request sequence; returns (status, body keys, a few
    headers) per request, and the bodies."""
    rows, bodies = [], []

    def note(status, body, headers, keep=("Retry-After",)):
        rows.append((status, sorted(body) if isinstance(body, dict)
                     else body, {h: headers.get(h) for h in keep},
                     "X-Trace-Id" in headers))
        bodies.append(body)

    tp = "00-0af7651916cd43dd8448eb211c80319c-b7ad6b7169203331-01"
    note(*post(port, "/v1/serving/mlp", {"features": x},
               headers={"traceparent": tp}))
    note(*post(port, "/v1/serving", {"features": x}))       # default route
    note(*post(port, "/v1/serving/lm", {"tokens": toks, "maxNewTokens": 5}))
    note(*post(port, "/v1/serving/lm_group", {"tokens": toks,
                                              "maxNewTokens": 5}))
    status, lines, headers = post_stream(port, "/v1/serving/lm",
                                         {"tokens": toks, "maxNewTokens": 5})
    note(status, [sorted(ln) for ln in lines], headers,
         keep=("Content-Type", "Transfer-Encoding"))
    bodies[-1] = lines
    note(*post(port, "/v1/serving/shed", {"features": x}))
    note(*post(port, "/v1/serving/lm_group", {"tokens": toks,
                                              "stream": True}))
    note(*post(port, "/v1/serving/nope", {"features": x}))
    note(*post(port, "/v1/serving/mlp", {"features": [[1.0, 2.0]]}))
    note(*post(port, "/v1/serving/mlp", {"other": 1}))
    note(*post(port, "/v1/serving/lm", {"tokens": [99]}))
    note(*post(port, "/elsewhere", {}))
    status, body, headers = get(port, "/v1/serving")
    note(status, json.loads(body), headers)
    status, body, headers = get(port, f"/v1/requests/{tp.split('-')[1]}")
    note(status, json.loads(body), headers)
    bodies[-1] = sorted({e["event"] for e in bodies[-1]["events"]})
    status, body, headers = get(port, "/metrics")
    note(status, "text", headers, keep=("Content-Type",))
    bodies[-1] = body.decode()
    status, body, headers = get(port, "/healthz")
    note(status, sorted(json.loads(body)), headers)
    status, body, headers = get(port, "/missing")
    note(status, sorted(json.loads(body)), headers)
    return rows, bodies


def _registry(m, net, lm):
    reg = m.ModelRegistry()
    reg.register("mlp", m.ForwardServing(
        net, m.BucketLadder(batchSizes=(1, 2), seqLens=()), inputShape=(4,)))
    reg.register("lm", m.ContinuousBatcher(
        lm, pageSize=8, maxSlots=2,
        ladder=m.BucketLadder(batchSizes=(2,), seqLens=(16,))))
    reg.register("lm_group", m.GenerativeServing(
        lm, m.BucketLadder(batchSizes=(1,), seqLens=(16,))))
    reg.register("shed", m.ForwardServing(
        net, m.BucketLadder(batchSizes=(1,), seqLens=()), inputShape=(4,)),
        admission=m.AdmissionControl(maxQueueRows=0, retryAfter=2.5))
    return reg


def test_inference_server_http_round_trip_matches_reference(mlps, lms):
    """Each package's server on a fresh process-global registry (what
    ``/metrics`` and ``/healthz`` read), so earlier tests in the process
    cannot add series to one side only."""
    jnet, net = mlps
    jlm, tlm = lms
    x = np.random.RandomState(3).randn(2, 4).astype(np.float32).tolist()
    toks = prompts(1, 9, 9, seed=4)[0]
    got = {}
    for k, m in REM.items():
        is_ref = k == "reference"
        tel = jtel if is_ref else ttel
        prev = tel.set_registry(tel.MetricsRegistry())
        srv = m.InferenceServer(_registry(m, jnet if is_ref else net,
                                          jlm if is_ref else tlm))
        try:
            srv.start()
            got[k] = _inference_script(srv.port, x, toks.tolist())
        finally:
            srv.stop()
            tel.set_registry(prev)
    (rows, bodies), (jrows, jbodies) = got["port"], got["reference"]
    assert rows == jrows
    assert [r[0] for r in rows] == [200, 200, 200, 200, 200, 429, 400, 404,
                                    400, 400, 400, 404, 200, 200, 200, 200,
                                    404]
    assert rows[5][2] == {"Retry-After": "3"}           # ceil(2.5)
    for i in (0, 1):
        np.testing.assert_allclose(bodies[i]["output"], jbodies[i]["output"],
                                   atol=OUT_ATOL, rtol=0)
        np.testing.assert_allclose(bodies[i]["output"],
                                   net.output(np.asarray(x)).numpy(),
                                   atol=OUT_ATOL, rtol=0)
    stream = [ln["token"] for ln in bodies[4] if "token" in ln]
    assert bodies[4][-1] == {"done": True}
    assert_tokens(jlm, [toks] * 4,
                  [bodies[2]["tokens"][0], bodies[3]["tokens"][0], stream,
                   tlm.generate(toks[None], 5)[0]],
                  [jbodies[2]["tokens"][0], jbodies[3]["tokens"][0],
                   [ln["token"] for ln in jbodies[4] if "token" in ln],
                   jlm.generate(toks[None], 5)[0]])
    assert bodies[12] == jbodies[12] == {
        "models": ["lm", "lm_group", "mlp", "shed"]}
    assert bodies[13] == jbodies[13]        # the traceparent's timeline
    assert {"serving.enqueue", "serving.retire"} <= set(bodies[13])
    for name in ("dl4j_tpu_serving_requests_total",
                 "dl4j_tpu_serving_sequences_admitted_total",
                 "dl4j_tpu_serving_decode_tokens_total",
                 "dl4j_tpu_serving_shed_total",
                 "dl4j_tpu_serving_kv_pages_free"):
        assert name in bodies[14] and name in jbodies[14], name


def test_json_model_server_round_trip_matches_reference(mlps):
    """``JsonModelServer`` + ``JsonRemoteInference`` in both packages: the
    same predictions, the same 400 for a bad payload, and both answer the
    observability GETs."""
    jnet, net = mlps
    x = np.random.RandomState(5).randn(3, 4).astype(np.float32)
    got = {}
    for k, m in REM.items():
        srv = m.JsonModelServer(jnet if k == "reference" else net).start()
        try:
            client = m.JsonRemoteInference(port=srv.port, retries=0)
            pred = client.predict(x)
            with pytest.raises(RuntimeError, match="HTTP 400"):
                client.predict([[1.0, 2.0, 3.0, 4.0, 5.0]])
            rows = [post(srv.port, "/v1/serving", {"nope": 1})[:2],
                    get(srv.port, "/healthz")[0], get(srv.port, "/x")[0]]
            text = get(srv.port, "/metrics")[1].decode()
        finally:
            srv.stop()
        got[k] = (pred, rows, 'dl4j_tpu_remote_requests_total{code="400"}'
                  in text)
    np.testing.assert_allclose(got["port"][0], got["reference"][0],
                               atol=OUT_ATOL, rtol=0)
    np.testing.assert_allclose(got["port"][0], net.output(x).numpy(),
                               atol=OUT_ATOL, rtol=0)
    assert [r[0] if isinstance(r, tuple) else r for r in got["port"][1]] \
        == [400, 200, 404]
    assert [(r[0], sorted(r[1])) if isinstance(r, tuple) else r
            for r in got["port"][1]] == \
        [(r[0], sorted(r[1])) if isinstance(r, tuple) else r
         for r in got["reference"][1]]
    assert got["port"][2] and got["reference"][2]


def _samediff():
    sd = SameDiff.create(device="cpu")
    x = sd.placeholder("x", shape=(-1, 3))
    w = sd.var("w", np.arange(6, dtype=np.float32).reshape(3, 2) / 10)
    b = sd.var("b", np.asarray([0.5, -0.5], np.float32))
    sd.nn().relu(x.mmul(w) + b, name="out")
    return sd


def test_samediff_json_model_server_round_trip():
    """The port's ``SameDiffJsonModelServer`` feeds the graph's
    placeholder (ROADMAP C13: the reference's is an alias of
    ``JsonModelServer``, whose ``sd.output(features)`` fails, so it answers
    400 to every request on a SameDiff graph)."""
    sd = _samediff()
    x = np.random.RandomState(6).randn(4, 3).astype(np.float32)
    srv = trem.SameDiffJsonModelServer(sd, outputNames=["out"]).start()
    try:
        pred = trem.JsonRemoteInference(port=srv.port).predict(x)
        status, body, _ = post(srv.port, "/v1/serving", {"features": [1.0]})
    finally:
        srv.stop()
    np.testing.assert_allclose(
        pred, sd.output({"x": x}, "out")["out"].numpy(), atol=1e-6, rtol=0)
    assert status == 400 and "error" in body    # a 1-d input: the caller's
    with pytest.raises(ValueError, match="placeholders"):
        sd2 = _samediff()
        sd2.placeholder("y", shape=(-1, 3))
        trem.SameDiffJsonModelServer(sd2)
    jsd = _reference_samediff()
    jsrv = jrem.SameDiffJsonModelServer(jsd).start()
    try:
        status, body, _ = post(jsrv.port, "/v1/serving",
                               {"features": x.tolist()})
    finally:
        jsrv.stop()
    assert status == 400 and "ValueError" in body["error"]


def _reference_samediff():
    from deeplearning4j_tpu.autodiff import SameDiff as JaxSameDiff
    sd = JaxSameDiff.create()
    x = sd.placeholder("x", shape=(-1, 3))
    w = sd.var("w", np.arange(6, dtype=np.float32).reshape(3, 2) / 10)
    sd.nn().relu(x.mmul(w), name="out")
    return sd
