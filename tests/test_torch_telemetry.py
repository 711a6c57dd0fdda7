"""Port parity of the telemetry the serving tier reports through: the
registry's Prometheus exposition, the trace context and timeline store,
``ThresholdRule`` / ``HealthMonitor`` with its edge actions and default
rules,
``health_summary``, the retention ring's queries, the exemplars and the
observability GET routing — each driven through both packages with the
same sequence of calls, and held equal exactly (these are pure Python in
both)."""
import json

import pytest

import deeplearning4j_tpu.telemetry as jtel
import deeplearning4j_tpu_torch.telemetry as ttel
from deeplearning4j_tpu.telemetry.http import \
    observability_route as jax_route
from deeplearning4j_tpu_torch.telemetry.http import observability_route

pytestmark = pytest.mark.torch_port

PKGS = {"reference": jtel, "port": ttel}


@pytest.fixture
def registries():
    """A fresh process-global registry in each package, restored after."""
    regs = {k: m.MetricsRegistry() for k, m in PKGS.items()}
    prev = {k: PKGS[k].set_registry(r) for k, r in regs.items()}
    try:
        yield regs
    finally:
        for k, r in prev.items():
            PKGS[k].set_registry(r)


def _drive(m):
    """One fixed sequence of inc / set / observe through a package's
    registry and its ServingMetrics."""
    reg = m.get_registry()
    c = reg.counter("dl4j_tpu_test_events_total", "Events", ("kind",))
    c.inc(kind="a")
    c.inc(2.5, kind='b"q\\uo\nte')
    g = reg.gauge("dl4j_tpu_test_level", "Level")
    g.set(3.25)
    g.dec(0.25)
    h = reg.histogram("dl4j_tpu_test_seconds", "Latency", ("model",),
                      buckets=(0.1, 1.0, 10.0))
    for v in (0.05, 0.1, 0.5, 3.0, 100.0, float("nan")):
        h.observe(v, model="m")
    sm = m.serving_metrics()
    sm.requests().inc(model="lm", outcome="ok")
    sm.queue_depth().set(7, model="lm")
    sm.kv_pages_in_use().set(12, model="lm", pool="target")
    sm.request_seconds().observe(0.0123, model="lm")
    sm.warmup_seconds().observe(4.2, model="lm")
    sm.drain_seconds().observe(0.3, model="lm")
    sm.replica_health().set(1, model="lm", replica="lm/0")
    m.observe_exemplar("dl4j_tpu_serving_ttft_seconds", 0.01,
                       trace_id="t1", model="lm")      # unregistered: no-op
    sm.ttft_seconds()
    m.observe_exemplar("dl4j_tpu_serving_ttft_seconds", 0.02,
                       trace_id="t2", model="lm")
    m.observe_exemplar("dl4j_tpu_serving_ttft_seconds", 0.005,
                       trace_id="t3", model="lm")
    return reg


def test_exposition_text_identical(registries):
    texts = {k: _drive(m).exposition() for k, m in PKGS.items()}
    assert texts["port"] == texts["reference"]
    assert 'dl4j_tpu_serving_requests_total{model="lm",outcome="ok"} 1.0' \
        in texts["port"]
    # json text: the NaN observation makes a sum that equals nothing
    assert json.dumps(ttel.get_registry().snapshot()) == \
        json.dumps(jtel.get_registry().snapshot())


def test_exemplars_identical(registries):
    for m in PKGS.values():
        m.clear_exemplars()
        _drive(m)
    for name in ("dl4j_tpu_serving_ttft_seconds",):
        assert ttel.exemplar_for(name, model="lm") == \
            jtel.exemplar_for(name, model="lm")
    assert ttel.exemplar_for("dl4j_tpu_serving_ttft_seconds",
                             model="lm")["trace_id"] == "t2"
    assert ttel.latency_exemplars() == jtel.latency_exemplars()


def test_metric_validation_errors_identical(registries):
    for m in PKGS.values():
        reg = m.get_registry()
        reg.counter("dl4j_tpu_x_total", labelnames=("a",))
        with pytest.raises(ValueError, match="labels"):
            reg.counter("dl4j_tpu_x_total", labelnames=("a",)).inc(b="1")
        with pytest.raises(ValueError, match="already registered"):
            reg.gauge("dl4j_tpu_x_total")
        with pytest.raises(ValueError, match="only go up"):
            reg.counter("dl4j_tpu_x_total", labelnames=("a",)).inc(-1, a=1)
        with pytest.raises(ValueError, match="invalid metric name"):
            reg.counter("bad name")


@pytest.mark.parametrize("header", [
    "00-0af7651916cd43dd8448eb211c80319c-b7ad6b7169203331-01",
    "00-0AF7651916CD43DD8448EB211C80319C-B7AD6B7169203331-00",
    "00-00000000000000000000000000000000-b7ad6b7169203331-01",
    "00-0af7651916cd43dd8448eb211c80319c-0000000000000000-01",
    "garbage", "", None])
def test_traceparent_parsing_identical(header):
    got = [m.parse_traceparent(header) for m in (ttel, jtel)]
    assert [g is None for g in got] == [got[1] is None] * 2
    if got[0] is not None:
        assert got[0].to_traceparent() == got[1].to_traceparent()
        child = got[0].child()
        assert child.traceId == got[0].traceId != "" and \
            child.spanId != got[0].spanId


def test_timeline_store_bounds_identical():
    stores = [m.TimelineStore(maxTraces=3, maxEvents=4)
              for m in (ttel, jtel)]
    for st in stores:
        for i in range(5):
            for e in range(6):
                st.note(f"t{i}", "serving.step", row=e)
        st.note(None, "ignored")
        st.note("t2", "serving.retire")      # t2 becomes most recent
    a, b = stores
    assert a.trace_ids() == b.trace_ids() == ["t3", "t4", "t2"]
    for tid in a.trace_ids():
        ga, gb = a.get(tid), b.get(tid)
        for g in (ga, gb):
            for ev in g["events"]:
                ev.pop("ts")
        assert ga == gb
    assert a.get("t4")["dropped"] == 2
    with ttel.request_context(ttel.RequestContext.new()) as ctx:
        assert ttel.current_context() is ctx
    assert ttel.current_context() is None


def test_threshold_rules_and_monitor_actions(registries, tmp_path):
    """Both packages' monitors fire and resolve on the same edges, log the
    same transitions and dispatch the same registered actions."""
    calls, logs = {}, {}
    for k, m in PKGS.items():
        reg = m.get_registry()
        g = reg.gauge("dl4j_tpu_serving_queue_depth", "", ("model",))
        rule = m.ThresholdRule("queue_high", "dl4j_tpu_serving_queue_depth",
                               ">=", 4, model="lm")
        path = tmp_path / f"{k}.jsonl"
        mon = m.HealthMonitor(rules=[rule], eventLogPath=str(path))
        seen = calls.setdefault(k, [])
        mon.registerAction("queue_high",
                           lambda r, d, s=seen: s.append(("up", r)) or "up")
        mon.registerAction("queue_high",
                           lambda r, d, s=seen: s.append(("down", r)),
                           on="resolved")
        states = []
        for t, depth in enumerate((0, 5, 6, 2, 9, 1)):
            g.set(depth, model="lm")
            states.append(sorted(mon.evaluate_once(now=float(t))))
        mon.note("drain", replica="lm/0")
        mon.stop()
        logs[k] = [(r["rule"], r["state"])
                   for r in map(json.loads, path.read_text().splitlines())]
        calls[k].append(states)
        calls[k].append(m.health_summary()["firing_alerts"])
    assert calls["port"] == calls["reference"]
    assert calls["port"][-2] == [[], ["queue_high"], ["queue_high"], [],
                                 ["queue_high"], []]
    assert logs["port"] == logs["reference"]
    text = {k: m.get_registry().exposition() for k, m in PKGS.items()}
    assert text["port"] == text["reference"]
    with pytest.raises(ValueError, match="on must be"):
        ttel.HealthMonitor(rules=[]).registerAction("x", print, on="never")


def _rule_config(rule):
    return (type(rule).__name__, rule.name,
            {k: v for k, v in vars(rule).items() if not k.startswith("_")})


def test_monitor_waits_for_a12():
    """What waited for A12 is ported: both packages' default monitor
    watches the same four rules with the same thresholds, and
    ``federated=True`` / ``webhookUrl`` construct in both."""
    rules = {k: [_rule_config(r) for r in m.HealthMonitor().rules]
             for k, m in PKGS.items()}
    assert rules["port"] == rules["reference"]
    assert [r[1] for r in rules["port"]] == [
        "training_stall", "replica_straggler", "etl_starvation",
        "divergence_precursor"]
    for m in PKGS.values():
        mon = m.HealthMonitor(federated=True,
                              webhookUrl="http://127.0.0.1:1/x")
        assert mon.federated and mon.webhookUrl == "http://127.0.0.1:1/x"


def test_health_summary_keys_identical(registries):
    for m in PKGS.values():
        m.serving_metrics().replica_health().set(0, model="lm",
                                                 replica="lm/1")
    a, b = ttel.health_summary(), jtel.health_summary()
    assert set(a) == set(b)
    for key in ("status", "steps_total", "last_step_age_seconds",
                "firing_alerts", "replica_health"):
        assert a[key] == b[key], key


def test_retention_queries_identical(registries):
    rings = {k: m.MetricsRetention(interval=1.0, window=10.0)
             for k, m in PKGS.items()}
    docs = {}
    for k, m in PKGS.items():
        c = m.serving_metrics().decode_tokens()
        for t, n in enumerate((0, 5, 5, 12, 3, 9)):   # a reset at t=4
            c.inc(n, model="lm")
            rings[k].sample_now(ts=100.0 + t)
        m.get_registry().counter("dl4j_tpu_other_total").inc()
        docs[k] = [rings[k].http_query(q) for q in (
            {"metric": "dl4j_tpu_serving_decode_tokens_total"},
            {"metric": "dl4j_tpu_serving_decode_tokens_total",
             "fn": "increase", "window": "3"},
            {"metric": "dl4j_tpu_serving_decode_tokens_total",
             "fn": "latest", "model": "lm"},
            {"metric": "dl4j_tpu_serving_decode_tokens_total",
             "fn": "median"},
            {"fn": "rate"}, {"metric": "x", "window": "soon"})]
        docs[k].append(rings[k].rate(
            "dl4j_tpu_serving_decode_tokens_total", model="lm"))
    assert docs["port"] == docs["reference"]
    assert docs["port"][0][1]["series"][0]["value"] == pytest.approx(
        34 / 5)


def test_observability_routes(registries):
    for m in PKGS.values():
        m.serving_metrics().requests().inc(model="lm", outcome="ok")
    for path in ("/metrics", "/nope"):
        assert observability_route(path) == jax_route(path)
    # federation unconfigured in both: the same 404 and hint
    prev = {k: m.set_federation_dir(None) for k, m in PKGS.items()}
    try:
        for path in ("/metrics/federated", "/v1/runs/r1/timeline"):
            status, body, ctype = observability_route(path)
            assert (status, body, ctype) == jax_route(path)
            assert status == 404 and ctype == "application/json"
            assert "federation unconfigured" in json.loads(body)["error"]
    finally:
        for k, m in PKGS.items():
            m.set_federation_dir(prev[k])
    assert observability_route("/v1/runs/r1") is None
    ttel.timeline_store().note("abc", "serving.enqueue", row=0)
    status, body, _ = observability_route("/v1/requests/abc")
    assert status == 200 and json.loads(body)["events"][0]["event"] == \
        "serving.enqueue"
    status, body, _ = observability_route("/v1/requests/zzz")
    assert status == 404 and json.loads(body)["trace_id"] == "zzz"
    prev = ttel.set_retention(None)
    try:
        assert observability_route("/metrics/query?metric=x")[0] == 503
        ring = ttel.ensure_retention(start=False)
        ring.sample_now(ts=1.0)
        status, body, _ = observability_route(
            "/metrics/query?metric=dl4j_tpu_serving_requests_total&fn=latest")
        assert status == 200 and \
            json.loads(body)["series"][0]["value"] == 1.0
    finally:
        ttel.set_retention(prev)
    status, body, _ = observability_route("/healthz")
    assert status == 200 and json.loads(body)["status"] == "ok"


def test_tracer_and_flight_recorder(tmp_path):
    tr = ttel.Tracer(maxEvents=8)
    with tr.span("outer", a=1):
        with tr.span("inner") as attrs:
            attrs["b"] = 2
            assert [s["name"] for s in tr.open_spans()] == ["outer",
                                                            "inner"]
    tr.record_complete("serving.decode.step", 0.0, 0.5,
                       args={"replica": "lm"})
    names = [e["name"] for e in tr.events()]
    assert names == ["inner", "outer", "serving.decode.step"]
    assert tr.events()[0]["args"] == {"b": 2, "depth": 2}
    path = tmp_path / "trace.json"
    tr.write_chrome_trace(str(path), tail=2)
    assert [e["name"] for e in json.loads(path.read_text())[
        "traceEvents"]] == ["outer", "serving.decode.step"]
    fr = ttel.FlightRecorder(capacity=2, dumpDir=str(tmp_path))
    for i in range(3):
        fr.record(kind="serving_request_failure", i=i)
    assert [r["i"] for r in fr.snapshot()] == [1, 2]
    dumped = json.loads(open(fr.dump(reason="test")).read())
    assert dumped["reason"] == "test" and len(dumped["records"]) == 2
