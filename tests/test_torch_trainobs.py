"""Port parity of the training run's telemetry: the four training alert
rules and ``HealthMonitor``'s federated evaluation and webhook delivery,
the run log (``merge_timelines``, a supervised run's fleet timeline,
``/v1/runs/<id>/timeline``), federation (``TelemetryAggregator``,
``/metrics/federated``), ``write_final_snapshot`` and the OTLP exporter.
These modules are pure Python in both packages: the same calls give the
same answers, held equal exactly (times, pids and random ids aside)."""
import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np
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


@pytest.fixture
def fed_dir(tmp_path):
    """One federation run directory configured in both packages."""
    prev = {k: m.set_federation_dir(str(tmp_path)) for k, m in PKGS.items()}
    try:
        yield tmp_path
    finally:
        for k, m in PKGS.items():
            m.set_federation_dir(prev[k])


@pytest.fixture
def collector():
    """An HTTP collector on 127.0.0.1 keeping every POST body by path."""
    got = {}

    class Handler(BaseHTTPRequestHandler):
        def do_POST(self):
            body = self.rfile.read(int(self.headers["Content-Length"]))
            got.setdefault(self.path, []).append(json.loads(body))
            self.send_response(200)
            self.send_header("Content-Length", "0")
            self.end_headers()

        def log_message(self, *args):
            pass

    httpd = ThreadingHTTPServer(("127.0.0.1", 0), Handler)
    th = threading.Thread(target=httpd.serve_forever, daemon=True)
    th.start()
    try:
        yield f"http://127.0.0.1:{httpd.server_address[1]}", got
    finally:
        httpd.shutdown()
        httpd.server_close()
        th.join(timeout=5)


def _rule_states(m):
    """Drive ``default_rules`` of one package through a fixed sequence of
    registry states and clock readings; every rule's answer at each."""
    reg = m.MetricsRegistry()
    rules = m.default_rules(stallTimeout=10.0, stragglerRatio=2.0,
                            starvationSeconds=5.0,
                            divergenceQuietSeconds=30.0)
    steps = reg.counter("dl4j_tpu_train_steps_total", "steps")
    rollbacks = reg.counter("dl4j_tpu_fault_nan_rollbacks_total", "rb")
    replica = reg.gauge("dl4j_tpu_parallel_replica_step_seconds", "rs",
                        labelnames=("replica",))
    waiting = reg.gauge("dl4j_tpu_etl_consumers_waiting", "w")
    active = reg.gauge("dl4j_tpu_etl_producer_active", "a")
    script = [
        (0.0, lambda: None),                       # nothing yet
        (1.0, lambda: steps.inc()),                # arms the stall rule
        (5.0, lambda: replica.set(1.0, replica="0")),
        (12.0, lambda: replica.set(1.1, replica="1")),   # stalled 11 s
        (13.0, lambda: (steps.inc(), replica.set(3.0, replica="2"))),
        (14.0, lambda: (waiting.set(1), active.set(1))),
        (20.0, lambda: rollbacks.inc()),           # starved 6 s; a rise
        (21.0, lambda: active.set(0)),             # a clean drain
        (40.0, lambda: waiting.set(0)),
        (60.0, lambda: (rollbacks.inc(0), steps.inc())),  # quiet again
    ]
    out = []
    for now, act in script:
        act()
        out.append([(r.name, r.evaluate(reg, now)) for r in rules])
    return out


def test_the_four_training_rules_fire_on_the_same_registry_states():
    port, ref = _rule_states(ttel), _rule_states(jtel)
    assert port == ref
    fired = {name for row in port for name, d in row if d is not None}
    assert fired == {"training_stall", "replica_straggler",
                     "etl_starvation", "divergence_precursor"}


def test_federated_monitor_sees_the_cross_host_straggler(fed_dir,
                                                         registries):
    """Two hosts' snapshots (one slow) in the run dir: a federated
    monitor fires the straggler rule in both packages, a local one
    cannot."""
    for host, secs in (("h0", 1.0), ("h1", 5.0)):
        reg = jtel.MetricsRegistry()
        reg.gauge("dl4j_tpu_parallel_replica_step_seconds", "rs",
                  labelnames=("replica",)).set(secs, replica="0")
        jtel.SnapshotWriter(str(fed_dir), hostId=host,
                            registry=reg).write_now()
    out = {}
    for k, m in PKGS.items():
        fed = m.HealthMonitor([m.ReplicaStragglerRule(ratio=2.0)],
                              federated=True,
                              eventLogPath=str(fed_dir / f"{k}.jsonl"))
        local = m.HealthMonitor([m.ReplicaStragglerRule(ratio=2.0)],
                                eventLogPath=str(fed_dir / f"{k}_l.jsonl"))
        out[k] = (fed.evaluate_once(now=1.0), local.evaluate_once(now=1.0))
    assert out["port"] == out["reference"]
    assert "replica_straggler" in out["port"][0] and not out["port"][1]


def test_webhook_delivers_the_same_transitions(collector, tmp_path,
                                               registries):
    url, got = collector
    for k, m in PKGS.items():
        mon = m.HealthMonitor(
            [m.ThresholdRule("hot", "dl4j_tpu_test_level", ">", 1.0)],
            eventLogPath=str(tmp_path / f"{k}.jsonl"),
            webhookUrl=f"{url}/{k}", webhookBackoff=0.01)
        g = m.get_registry().gauge("dl4j_tpu_test_level", "level")
        g.set(2.0)
        mon.evaluate_once(now=1.0)
        g.set(0.0)
        mon.evaluate_once(now=2.0)
        mon.stop()                       # drains the sender
    strip = lambda rows: [{k: v for k, v in r.items()
                           if k not in ("ts", "host")} for r in rows]
    assert strip(got["/port"]) == strip(got["/reference"])
    assert [r["state"] for r in got["/port"]] == ["firing", "resolved"]
    assert sorted(got["/port"][0]) == sorted(got["/reference"][0])
    delivered = {k: m.get_registry().get(
        "dl4j_tpu_health_webhook_deliveries_total").value(status="ok")
        for k, m in PKGS.items()}
    assert delivered["port"] == delivered["reference"] == 2


def _write_timelines(m, d):
    """Two hosts' timelines, the second adopting the first's plan stamp
    (the causal edge), through one package's writer."""
    rc = m.RunContext(m.RequestContext("ab" * 16, "cd" * 8))
    a = m.FleetTimeline(str(d), hostId="host-a")
    b = m.FleetTimeline(str(d), hostId="host-b")
    with m.run_scope(rc):
        a.record("run.start", step=0)
        a.record("ckpt.save", step=2, seconds=0.5)
        stamp = a.stamp()
        b.observe(stamp)
        b.record("ckpt.restore", step=2, generation=1)
        a.record("ckpt.rollback", step=3, reason="non-finite loss nan")
        b.record("train.step", step=3, epoch=0, seconds=0.01)
    with open(a.path, "a") as f:
        f.write('{"torn": ')             # a host dying mid-append
    return rc.runId


def test_merge_timelines_over_the_same_event_files(tmp_path):
    files = {}
    for k, m in PKGS.items():
        d = tmp_path / k
        run_id = _write_timelines(m, d)
        files[k] = sorted(p.name for p in d.iterdir())
    assert files["port"] == files["reference"]
    # each package merges the files either package wrote
    for d in (tmp_path / "port", tmp_path / "reference"):
        merged = {k: m.merge_timelines(str(d), run_id=run_id)
                  for k, m in PKGS.items()}
        assert merged["port"] == merged["reference"]
        kinds = [e["kind"] for e in merged["port"]]
        assert sorted(kinds) == sorted([
            "run.start", "ckpt.save", "ckpt.restore", "ckpt.rollback",
            "train.step"])
        # the causal edge: host-b's restore after the save it observed
        assert kinds.index("ckpt.save") < kinds.index("ckpt.restore")
        assert all(e["run"] == run_id for e in merged["port"])
        filt = {k: m.merge_timelines(str(d), kinds=["ckpt.restore"],
                                     generation=1, step_min=2, step_max=2)
                for k, m in PKGS.items()}
        assert filt["port"] == filt["reference"] and len(filt["port"]) == 1
    # the two writers' events, time stamps aside (how two hosts'
    # concurrent events interleave depends on the wall clock's reading)
    strip = lambda evs: sorted(
        json.dumps({k: v for k, v in e.items() if k not in ("ts", "hlc")},
                   sort_keys=True) for e in evs)
    assert strip(ttel.merge_timelines(str(tmp_path / "port"))) == \
        strip(jtel.merge_timelines(str(tmp_path / "reference")))


def _snapshots(d):
    """Three hosts' snapshots written by the reference's writer."""
    for i, host in enumerate(("w0", "w1", "w2")):
        reg = jtel.MetricsRegistry()
        reg.counter("dl4j_tpu_train_steps_total", "steps").inc(10 * (i + 1))
        reg.counter("dl4j_tpu_test_events_total", "ev",
                    ("kind",)).inc(i + 0.5, kind="a")
        reg.gauge("dl4j_tpu_test_level", "level").set(float(i))
        h = reg.histogram("dl4j_tpu_test_seconds", "lat",
                          buckets=(0.1, 1.0))
        for v in (0.05, 0.5 * (i + 1), 3.0):
            h.observe(v)
        if i == 2:       # a conflicting shape: skipped, not fatal
            reg.counter("dl4j_tpu_test_level_total", "x").inc()
        jtel.SnapshotWriter(str(d), hostId=host, registry=reg).write_now()
    with open(d / "metrics_torn.json", "w") as f:
        f.write("{not json")


def test_aggregator_exposition_over_the_same_snapshots(tmp_path,
                                                       registries):
    _snapshots(tmp_path)
    aggs = {k: m.TelemetryAggregator(str(tmp_path),
                                     localRegistry=m.MetricsRegistry(),
                                     localHost="nobody")
            for k, m in PKGS.items()}
    text = {k: a.exposition() for k, a in aggs.items()}
    assert text["port"] == text["reference"]
    assert "dl4j_tpu_train_steps_total 60" in text["port"]
    assert aggs["port"].hosts == aggs["reference"].hosts
    assert aggs["port"].skippedFiles == aggs["reference"].skippedFiles
    # counter smoothing: a worker restarting at 0 does not pull the
    # federated total backwards, in either package
    reg = jtel.MetricsRegistry()
    reg.counter("dl4j_tpu_train_steps_total", "steps").inc(1)
    jtel.SnapshotWriter(str(tmp_path), hostId="w2", registry=reg).write_now()
    again = {k: a.exposition() for k, a in aggs.items()}
    assert again["port"] == again["reference"]
    assert "dl4j_tpu_train_steps_total 61" in again["port"]


def test_observability_routes_serve_the_run_and_the_federation(
        fed_dir, registries):
    run_id = _write_timelines(jtel, fed_dir)
    _snapshots(fed_dir)
    for path in (f"/v1/runs/{run_id}/timeline",
                 f"/v1/runs/{run_id}/timeline?kind=ckpt.save&kind=ckpt."
                 "restore", "/v1/runs/nope/timeline", "/metrics/federated"):
        port, ref = observability_route(path), jax_route(path)
        assert port == ref, path
    status, body, _ = observability_route(f"/v1/runs/{run_id}/timeline")
    doc = json.loads(body)
    assert status == 200 and doc["hosts"] == ["host-a", "host-b"]
    assert observability_route("/v1/runs/nope/timeline")[0] == 404


def test_write_final_snapshot_keys(fed_dir, tmp_path, registries):
    docs = {}
    for k, m in PKGS.items():
        m.get_registry().counter("dl4j_tpu_train_steps_total",
                                 "steps").inc(3)
        with m.tracer().span("compile"):         # an open span rides along
            path = m.write_final_snapshot(reason="test",
                                          directory=str(tmp_path / k))
        with open(path) as f:
            docs[k] = json.load(f)
        spans = [p for p in (tmp_path / k).iterdir()
                 if p.name.startswith("dl4j_tpu_spans_")]
        with open(spans[0]) as f:
            docs[k + "_spans"] = json.load(f)
    assert sorted(docs["port"]) == sorted(docs["reference"])
    assert docs["port"]["reason"] == docs["reference"]["reason"] == \
        "final_test"
    assert docs["port"]["metrics"] == docs["reference"]["metrics"]
    assert sorted(docs["port_spans"]) == sorted(docs["reference_spans"])
    for m in PKGS.values():
        assert m.install_export_handlers() in (True, False)
        m.uninstall_export_handlers()


def _otlp_payloads(m, url, got):
    """One package's exporter flushing a fixed registry and span set."""
    reg = m.MetricsRegistry()
    reg.counter("dl4j_tpu_test_events_total", "ev", ("kind",)).inc(
        2, kind="a")
    reg.gauge("dl4j_tpu_test_level", "level").set(1.5)
    reg.histogram("dl4j_tpu_test_seconds", "lat",
                  buckets=(0.1, 1.0)).observe(0.5)
    tr = m.Tracer()
    rc = m.RunContext(m.RequestContext("ef" * 16, "01" * 8))
    with m.run_scope(rc):
        with tr.span("checkpoint", step=4, **m.run_span_attrs()):
            pass
    with tr.span("step", iteration=1, flag=True, ratio=0.5):
        pass
    tr.instant("crash", reason="x")               # not a complete span
    exp = m.OtlpExporter(url, registry=reg, trace=tr,
                         serviceName="dl4j_tpu")
    outcome = exp.export_now()
    again = exp.export_now()                      # nothing new to send
    return outcome, again, exp


def _strip_otlp(doc):
    """An OTLP JSON payload with its times, pid and span ids blanked."""
    if isinstance(doc, dict):
        return {k: ("*" if k in ("timeUnixNano", "startTimeUnixNano",
                                 "endTimeUnixNano", "spanId") else
                    ("*" if doc.get("key") == "process.pid" and k == "value"
                     else _strip_otlp(v))) for k, v in doc.items()}
    if isinstance(doc, list):
        return [_strip_otlp(v) for v in doc]
    return doc


def test_otlp_payload_to_a_local_collector(collector, registries):
    url, got = collector
    res = {}
    for k, m in PKGS.items():
        got.clear()
        outcome, again, exp = _otlp_payloads(m, url, got)
        res[k] = (outcome, again, {p: _strip_otlp(v) for p, v in
                                   got.items()})
        spans = got["/v1/traces"][0]["resourceSpans"][0]["scopeSpans"][0][
            "spans"]
        by_name = {s["name"]: s for s in spans}
        assert by_name["checkpoint"]["traceId"] == "ef" * 16
        assert len(by_name["step"]["traceId"]) == 32
        res[k + "_step_attrs"] = by_name["step"]["attributes"]
    assert res["port"][:2] == res["reference"][:2]
    assert res["port"][0] == {"metrics": "ok", "spans": "ok"}
    assert res["port"][1]["spans"] == "empty"
    port_traces = res["port"][2]["/v1/traces"]
    ref_traces = res["reference"][2]["/v1/traces"]
    # the step span's trace id is random without a run: blank it too
    for doc in (port_traces, ref_traces):
        for s in doc[0]["resourceSpans"][0]["scopeSpans"][0]["spans"]:
            if s["name"] == "step":
                s["traceId"] = "*"
    assert port_traces == ref_traces
    assert res["port"][2]["/v1/metrics"] == res["reference"][2]["/v1/metrics"]


def test_training_instruments_report_the_same_series(registries):
    """The supervisor's instruments: logical steps, the micro-batch and
    supervised scopes, an ETL fetch and the step-phase histograms."""

    class Model:
        iterationCount, epochCount = 3, 1

    class It:
        def next(self):
            return "batch"

    out = {}
    for k, m in PKGS.items():
        m.clear_exemplars()     # process-global: other tests' runs left some
        model = Model()
        rc = m.RunContext(m.RequestContext("12" * 16, "34" * 8))
        with m.run_scope(rc):
            with m.train_step_span(model, 8):
                pass
            with m.microbatch_scope():
                assert m.in_microbatch()
                with m.train_step_span(model, 4):   # not a logical step
                    pass
            assert not m.in_microbatch()
            m.record_logical_step(model, 0.25, 8)
            m.note_etl_wait(0.5, it := It())
            assert m.etl_fetch(it) == "batch"
            m.observe_step_phase("checkpoint", 0.125, step=3)
            with pytest.raises(ValueError, match="unknown step phase"):
                m.observe_step_phase("nope", 1.0)
        reg = m.get_registry()
        out[k] = {
            "names": sorted(reg.names()),
            "steps": reg.get("dl4j_tpu_train_steps_total").value(),
            "phases": {p: reg.get(f"dl4j_tpu_step_{p}_seconds").count()
                       for p in ("compute", "data_wait", "checkpoint")},
            "exemplar": m.exemplar_for("dl4j_tpu_step_checkpoint_seconds"),
            "phase_names": m.STEP_PHASES}
    assert out["port"] == out["reference"]
    assert out["port"]["steps"] == 2


def test_supervised_run_records_the_references_timeline(fed_dir,
                                                        registries):
    """The same supervised NaN-rollback run in both packages writes the
    same sequence of timeline events (kinds and steps)."""
    from _torch_parity import JAX, PORT

    import deeplearning4j_tpu.fault as jfault
    import deeplearning4j_tpu_torch.fault as tfault

    def conf(P):
        L = P.layers
        return (P.conf.NeuralNetConfiguration.builder().seed(42)
                .updater(P.learn.Adam(0.01)).list()
                .layer(L.DenseLayer.builder().nIn(4).nOut(8)
                       .activation("relu").build())
                .layer(L.OutputLayer.builder("mse").nOut(3)
                       .activation("identity").build())
                .setInputType(P.conf.InputType.feedForward(4)).build())

    rng = np.random.RandomState(0)
    x = rng.randn(64, 4).astype(np.float32)
    y = rng.randn(64, 3).astype(np.float32)
    seqs = {}
    for k, P, F, m in (("reference", JAX, jfault, jtel),
                       ("port", PORT, tfault, ttel)):
        jnet = JAX.models.MultiLayerNetwork(conf(JAX)).init()
        net = jnet if k == "reference" else PORT.models.MultiLayerNetwork(
            conf(PORT), device="cpu").init(params=jax_params(jnet))
        rc = m.RunContext(m.RequestContext(("a" if k == "port" else "b")
                                           * 32, "0" * 16))
        with m.run_scope(rc), F.inject(F.NaNAtStep(1)):
            F.FaultTolerantTrainer(
                net, str(fed_dir / f"ck_{k}"), checkpointEveryN=1,
                durableExport=False).fit(
                P.ds.ListDataSetIterator([P.ds.DataSet(x, y)], batch=32),
                epochs=1)
        seqs[k] = [(e["kind"], e.get("step"))
                   for e in m.merge_timelines(str(fed_dir), run_id=rc.runId)
                   if e.get("run") == rc.runId]
    assert seqs["port"] == seqs["reference"]
    kinds = [kd for kd, _ in seqs["port"]]
    assert kinds[0] == "run.start" and kinds[-1] == "run.end"
    assert "ckpt.rollback" in kinds and "ckpt.restore" in kinds


def jax_params(jnet):
    import jax
    return jax.tree.map(np.array, jnet.params_)
