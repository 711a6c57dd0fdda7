"""DataVec's records, schemas, transforms, joins and reductions in the port
(``deeplearning4j_tpu_torch/datavec``), held against the JAX package:

- the reference's ``tests/test_datavec.py``, ``test_datavec_joinreduce.py``
  and the shared part of ``test_datavec_breadth.py``, their bodies run
  against the port;
- the same files and records through both packages give the same
  records (types and values) and the same ``DataSet``s (CSV, sequence
  CSV, SVMLight, regex, collection readers; both iterators);
- ``Schema`` JSON written by either package loads in the other and
  ``Schema`` / ``TransformProcess`` JSON are byte-equal;
- every join type and reduce op gives the reference's rows, under the
  local, parallel and Spark executors;
- ``SparkTransformExecutor.executeDistributed`` /
  ``executeJoinDistributed`` at world size 1 (no process group) and in a
  two-process gloo group on the CPU, as ``tests/test_datavec_distributed.py``
  runs them with two JAX processes.
"""
import json
import os
import socket
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest

import deeplearning4j_tpu.datavec as J
import deeplearning4j_tpu_torch.datavec as T
from tests._torch_parity import _reference_tests, _run_reference_test

pytestmark = pytest.mark.torch_port

REPO = Path(__file__).resolve().parent.parent

_, _DATAVEC = _reference_tests("test_datavec.py")
_, _JOINREDUCE = _reference_tests("test_datavec_joinreduce.py")
# the breadth file's audio, columnar (JDBC, columnar files) and codec
# readers wait for ROADMAP "A12 datavec formats"; its resources test
# drives utils.resources (ROADMAP A12)
_, _BREADTH = _reference_tests(
    "test_datavec_breadth.py",
    exclude=("TestAudio", "TestColumnar",
             "TestCodecAndResources.test_codec_reads_gif_and_npy",
             "TestCodecAndResources.test_codec_ravel_and_resize",
             "TestCodecAndResources.test_resources_and_downloader"))
_CASES = [(f"datavec::{i}", c) for i, c in _DATAVEC] + \
    [(f"joinreduce::{i}", c) for i, c in _JOINREDUCE] + \
    [(f"breadth::{i}", c) for i, c in _BREADTH]


@pytest.mark.parametrize("case", [c for _, c in _CASES],
                         ids=[i for i, _ in _CASES])
def test_reference_datavec_tests_pass_on_the_port(case, tmp_path,
                                                  monkeypatch):
    _run_reference_test(case, tmp_path, monkeypatch)


def test_reference_cases_are_all_collected():
    assert (len(_DATAVEC), len(_JOINREDUCE), len(_BREADTH)) == (19, 20, 2)


# ---------------------------------------------------------------------------
# records and DataSets through both packages
# ---------------------------------------------------------------------------

def _rec(rec):
    """A record as comparable (type name, value) pairs."""
    out = []
    for w in rec:
        v = w.value
        if isinstance(v, np.ndarray):
            v = (v.shape, str(v.dtype), v.tobytes())
        out.append((type(w).__name__, v))
    return out


def _drain(rr):
    rr.reset()
    out = []
    while rr.hasNext():
        r = rr.next()
        out.append([_rec(s) for s in r] if r and isinstance(r[0], list)
                   else _rec(r))
    return out


def _csv_dir(tmp_path):
    rng = np.random.RandomState(5)
    d = tmp_path / "csv"
    d.mkdir()
    for k in range(3):
        rows = ["x,y,label,name"] + [
            f"{rng.randint(-50, 50)},{rng.randn():.6f},{rng.randint(0, 3)},"
            f"n{rng.randint(0, 9)}" for _ in range(7)]
        (d / f"part{k}.csv").write_text("\n".join(rows) + "\n")
    return d


def _seq_files(tmp_path, n=5):
    rng = np.random.RandomState(6)
    d = tmp_path / "seq"
    d.mkdir()
    for i in range(n):
        t = rng.randint(2, 7)
        (d / f"s_{i}.csv").write_text("\n".join(
            f"{rng.randn():.5f},{rng.randn():.5f},{rng.randint(0, 4)}"
            for _ in range(t)) + "\n")
    return d


READERS = {
    "csv_dir": lambda P, tmp: (P.CSVRecordReader(skipNumLines=1),
                               P.FileSplit(_csv_dir(tmp))),
    "csv_string_semicolon": lambda P, tmp: (
        P.CSVRecordReader(delimiter=";"),
        P.StringSplit("1;2.5;a\n-3;4e2;bb\n\n7;x;0\n")),
    "line": lambda P, tmp: (P.LineRecordReader(),
                            P.StringSplit("alpha\n\nbeta gamma\n")),
    "regex": lambda P, tmp: (
        P.RegexLineRecordReader(r"(\d+)-(\w+):(\S+)", skipNumLines=1),
        P.StringSplit("header\n12-ab:3.5\n7-cd:x\n")),
    "svmlight": lambda P, tmp: (P.SVMLightRecordReader(5),
                                P.StringSplit("1 1:0.5 4:2\n0 2:-1 5:3 # c\n")),
    "svmlight_zero_based": lambda P, tmp: (
        P.SVMLightRecordReader(3, zeroBasedIndexing=True),
        P.StringSplit("2 0:1 2:4\n")),
    "collection": lambda P, tmp: (
        P.CollectionRecordReader([[1, 2.5, "a", True], [3, -1.0, "b", False]]),
        None),
    "sequence_csv": lambda P, tmp: (P.CSVSequenceRecordReader(),
                                    P.FileSplit(_seq_files(tmp))),
    "numbered_sequence": lambda P, tmp: (
        P.CSVSequenceRecordReader(),
        P.NumberedFileInputSplit(str(_seq_files(tmp) / "s_%d.csv"), 1, 3)),
    "collection_sequence": lambda P, tmp: (
        P.CollectionSequenceRecordReader([[[1, 0.5], [2, 1.5]], [[3, 2.5]]]),
        None),
}


@pytest.mark.parametrize("name", sorted(READERS))
def test_reader_gives_the_reference_records(name, tmp_path):
    (tmp_path / "j").mkdir()
    (tmp_path / "t").mkdir()
    jr, js = READERS[name](J, tmp_path / "j")
    tr, ts = READERS[name](T, tmp_path / "t")
    jr.initialize(js)
    tr.initialize(ts)
    assert jr.streaming() == tr.streaming()
    want = _drain(jr)
    assert want and _drain(tr) == want
    for k in (0, 1):        # the pool's record shards
        try:
            js_, ts_ = jr.shard(k, 2), tr.shard(k, 2)
        except NotImplementedError:
            with pytest.raises(NotImplementedError):
                tr.shard(k, 2)
            continue
        assert _drain(ts_) == _drain(js_)


def test_csv_load_all_goes_through_the_ports_native_parser(tmp_path,
                                                           monkeypatch):
    d = tmp_path / "n"
    d.mkdir()
    (d / "a.csv").write_text("h1,h2\n" + "\n".join(
        f"{i},{i * 0.5}" for i in range(200)) + "\n")
    (d / "b.csv").write_text("h1,h2\n1,2\n3,4\n")
    jr, tr = J.CSVRecordReader(1), T.CSVRecordReader(1)
    jr.initialize(J.FileSplit(d))
    tr.initialize(T.FileSplit(d))
    calls = []
    from deeplearning4j_tpu_torch import native
    real = native.csv_parse
    monkeypatch.setattr(native, "csv_parse",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    got = tr.loadAll()
    assert calls and native.available()
    np.testing.assert_array_equal(got, jr.loadAll())
    assert got.shape == (202, 2)


def _ds_equal(t, j):
    for f in ("features", "labels", "featuresMask", "labelsMask"):
        a, b = getattr(t, f), getattr(j, f)
        assert (a is None) == (b is None), f
        if a is not None:
            assert a.torch.device.type == "cpu"
            np.testing.assert_array_equal(a.numpy(), np.asarray(b.numpy()),
                                          err_msg=f)


ITERATORS = {
    "classification": lambda P, tmp: P.RecordReaderDataSetIterator(
        _reader(P, "cls", tmp), 4, labelIndex=2, numPossibleLabels=3),
    "regression": lambda P, tmp: P.RecordReaderDataSetIterator(
        _reader(P, "reg", tmp), 5, labelIndex=1, regression=True),
    "regression_range": lambda P, tmp: P.RecordReaderDataSetIterator(
        _reader(P, "reg", tmp), 3, labelIndex=1, labelIndexTo=2,
        regression=True),
    "features_only": lambda P, tmp: P.RecordReaderDataSetIterator(
        _reader(P, "reg", tmp), 6),
    "sequence_classification": lambda P, tmp:
        P.SequenceRecordReaderDataSetIterator(
            _seq_reader(P, tmp), 2, numPossibleLabels=4, labelIndex=2),
    "sequence_regression": lambda P, tmp:
        P.SequenceRecordReaderDataSetIterator(
            _seq_reader(P, tmp), 3, numPossibleLabels=-1, labelIndex=0,
            regression=True),
}


def _reader(P, kind, tmp):
    rng = np.random.RandomState(9)
    if kind == "cls":
        rows = [[float(rng.randn()), float(rng.randn()), int(rng.randint(3))]
                for _ in range(10)]
    else:
        rows = [[float(v) for v in rng.randn(4)] for _ in range(12)]
    return P.CollectionRecordReader(rows)


def _seq_reader(P, tmp):
    rr = P.CSVSequenceRecordReader()
    rr.initialize(P.FileSplit(_seq_files(tmp, 7)))
    return rr


@pytest.mark.parametrize("name", sorted(ITERATORS))
def test_iterator_gives_the_reference_datasets(name, tmp_path):
    (tmp_path / "j").mkdir()
    (tmp_path / "t").mkdir()
    jit = ITERATORS[name](J, tmp_path / "j")
    tit = ITERATORS[name](T, tmp_path / "t")
    for _ in range(2):                  # and again after reset
        n = 0
        while jit.hasNext():
            assert tit.hasNext()
            _ds_equal(tit.next(), jit.next())
            n += 1
        assert n > 1 and not tit.hasNext()
        jit.reset()
        tit.reset()
    assert tit.streaming() == jit.streaming()


def test_async_iterator_gives_the_wrapped_batches_on_the_cpu():
    it = T.AsyncDataSetIterator(ITERATORS["classification"](T, None),
                                queueSize=2)
    ref = ITERATORS["classification"](J, None)
    n = 0
    while ref.hasNext():
        _ds_equal(it.next(), ref.next())
        n += 1
    assert n == 3 and not it.hasNext()


# ---------------------------------------------------------------------------
# JSON
# ---------------------------------------------------------------------------

def _schema(P):
    return (P.Schema.Builder().addColumnInteger("a")
            .addColumnDouble("b", "c").addColumnLong("d")
            .addColumnCategorical("cat", ["x", "y", "z"])
            .addColumnString("s").addColumnFloat("f").build())


def _process(P):
    return (P.TransformProcess.Builder(_schema(P))
            .removeColumns("d")
            .categoricalToOneHot("cat")
            .filter(P.ColumnCondition("a", P.ConditionOp.LessThan, 0))
            .doubleMathOp("b", "Multiply", 2.5)
            .integerMathOp("a", "Add", 7)
            .doubleMathFunction("c", "ABS")
            .renameColumn("f", "g")
            .duplicateColumn("b", "b2")
            .stringMapTransform("s", {"p": "q"})
            .conditionalReplaceValueTransform(
                "b2", 0.0, P.ColumnCondition("b2", P.ConditionOp.GreaterThan,
                                             3.0))
            .reorderColumns("g", "a")
            .build())


def test_schema_json_is_byte_equal_and_loads_in_the_other_package():
    js, ts = _schema(J).toJson(), _schema(T).toJson()
    assert js == ts
    assert T.Schema.fromJson(js).toJson() == js
    assert J.Schema.fromJson(ts).toJson() == ts
    seq = T.SequenceSchema.fromJson(js) if hasattr(T.SequenceSchema,
                                                   "fromJson") else None
    if seq is not None:
        assert seq.toJson() == J.SequenceSchema.fromJson(js).toJson()


def test_transform_process_json_is_byte_equal_both_ways():
    jt, tt = _process(J), _process(T)
    assert tt.toJson() == jt.toJson()
    d = json.loads(tt.toJson())
    # the initial schema inside either process's JSON loads in the other
    assert J.Schema.fromJson(json.dumps(d["initialSchema"])).toJson() == \
        _schema(J).toJson()
    assert T.Schema.fromJson(json.dumps(
        json.loads(jt.toJson())["initialSchema"])).toJson() == \
        _schema(T).toJson()
    assert tt.getFinalSchema().toJson() == jt.getFinalSchema().toJson()


def _rows(n=60, seed=2):
    rng = np.random.RandomState(seed)
    return [[int(rng.randint(-20, 40)), float(rng.randn()),
             float(rng.randn()), int(rng.randint(0, 9)),
             ["x", "y", "z"][rng.randint(3)], ["p", "o"][rng.randint(2)],
             float(rng.rand())] for _ in range(n)]


@pytest.mark.parametrize("executor", ["local", "parallel", "spark",
                                      "distributed_world_of_one"])
def test_transform_process_gives_the_reference_records(executor):
    rows = _rows()
    want = [_rec(r) for r in J.LocalTransformExecutor.execute(rows,
                                                              _process(J))]
    tp = _process(T)
    run = {"local": lambda: T.LocalTransformExecutor.execute(rows, tp),
           "parallel": lambda: T.LocalTransformExecutor.executeParallel(
               rows, tp, minChunk=7),
           "spark": lambda: T.SparkTransformExecutor.execute(
               rows, tp, numPartitions=4),
           "distributed_world_of_one":
               lambda: T.SparkTransformExecutor.executeDistributed(rows, tp)}
    got = [_rec(r) for r in run[executor]()]
    assert got == want and 0 < len(got) < len(rows)


JOIN_TYPES = ["Inner", "LeftOuter", "RightOuter", "FullOuter"]


def _join(P, jt):
    ls = P.Schema.Builder().addColumnInteger("id").addColumnString(
        "name").addColumnDouble("w").build()
    rs = P.Schema.Builder().addColumnInteger("id").addColumnDouble(
        "score").addColumnString("name").build()
    return (P.Join.Builder(getattr(P.JoinType, jt)).setJoinColumns("id")
            .setSchemas(ls, rs).build())


LEFT = [[i % 6, f"l{i}", i * 0.25] for i in range(14)]
RIGHT = [[(i * 3) % 9, i * 1.5, f"r{i}"] for i in range(10)]


@pytest.mark.parametrize("jt", JOIN_TYPES)
def test_join_gives_the_reference_rows(jt):
    jj, tj = _join(J, jt), _join(T, jt)
    assert tj.getOutputSchema().toJson() == jj.getOutputSchema().toJson()
    want = sorted(map(repr, map(_rec, J.LocalTransformExecutor.executeJoin(
        jj, LEFT, RIGHT))))
    for run in (T.LocalTransformExecutor.executeJoin,
                T.SparkTransformExecutor.executeJoin,
                T.SparkTransformExecutor.executeJoinDistributed):
        assert sorted(map(repr, map(_rec, run(tj, LEFT, RIGHT)))) == want


REDUCE_OPS = ["Sum", "Mean", "Min", "Max", "Count", "CountUnique", "Range",
              "Stdev", "TakeFirst", "TakeLast"]


@pytest.mark.parametrize("op", REDUCE_OPS)
def test_reduce_gives_the_reference_rows(op):
    def proc(P):
        s = (P.Schema.Builder().addColumnInteger("k").addColumnDouble("v")
             .addColumnInteger("n").build())
        r = P.Reducer.Builder(getattr(P.ReduceOp, op)).keyColumns("k") \
            .build()
        return P.TransformProcess.Builder(s).reduce(r).build()

    rng = np.random.RandomState(4)
    rows = [[int(rng.randint(0, 5)), float(rng.randn()),
             int(rng.randint(0, 4))] for _ in range(40)]
    jp, tp = proc(J), proc(T)
    assert tp.getFinalSchema().toJson() == jp.getFinalSchema().toJson()
    assert tp.toJson() == jp.toJson()
    want = sorted(map(repr, map(_rec, J.LocalTransformExecutor.execute(
        rows, jp))))
    for got in (T.LocalTransformExecutor.execute(rows, tp),
                T.SparkTransformExecutor.execute(rows, tp),
                T.SparkTransformExecutor.executeDistributed(rows, tp)):
        assert sorted(map(repr, map(_rec, got))) == want


def test_convert_to_sequence_gives_the_reference_sequences():
    def proc(P):
        s = (P.Schema.Builder().addColumnInteger("user")
             .addColumnInteger("t").addColumnDouble("v").build())
        return (P.TransformProcess.Builder(s)
                .convertToSequence("user",
                                   P.NumericalColumnComparator("t"))
                .doubleMathOp("v", "Multiply", 2.0).build())

    rng = np.random.RandomState(8)
    rows = [[int(rng.randint(0, 4)), int(rng.randint(0, 100)),
             float(rng.randn())] for _ in range(30)]
    want = [[_rec(s) for s in seq]
            for seq in J.LocalTransformExecutor.execute(rows, proc(J))]
    got = [[_rec(s) for s in seq]
           for seq in T.LocalTransformExecutor.execute(rows, proc(T))]
    assert got == want
    assert proc(T).toJson() == proc(J).toJson()


# ---------------------------------------------------------------------------
# two processes in a gloo group
# ---------------------------------------------------------------------------

def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    p = s.getsockname()[1]
    s.close()
    return p


_WORKER = textwrap.dedent("""
import json, sys
sys.path.insert(0, {root!r})
import torch.distributed as dist
rank = int(sys.argv[1])
dist.init_process_group("gloo", init_method="tcp://127.0.0.1:{port}",
                        world_size=2, rank=rank)
from deeplearning4j_tpu_torch.datavec import (
    DoubleWritable, IntWritable, Join, JoinType, ReduceOp, Reducer, Schema,
    SparkTransformExecutor, Text, TransformProcess)
schema = (Schema.Builder().addColumnInteger("a").addColumnDouble("b")
          .addColumnString("s").build())
records = [[IntWritable(i), DoubleWritable(i * 0.5), Text("r%d" % i)]
           for i in range(20)]
tp = (TransformProcess.Builder(schema).integerMathOp("a", "Add", 100)
      .removeColumns("s").build())
out = SparkTransformExecutor.executeDistributed(records, tp)
ls = Schema.Builder().addColumnInteger("id").addColumnString("n").build()
rs = Schema.Builder().addColumnInteger("id").addColumnDouble("v").build()
left = [[i % 7, "n%d" % i] for i in range(21)]
right = [[i % 7, i * 0.5] for i in range(14)]
j = (Join.Builder(JoinType.Inner).setJoinColumns("id")
     .setSchemas(ls, rs).build())
joined = SparkTransformExecutor.executeJoinDistributed(j, left, right)
tp2 = (TransformProcess.Builder(j.getOutputSchema())
       .reduce(Reducer.Builder(ReduceOp.TakeFirst).keyColumns("id")
               .sumColumns("v").countColumns("n").build()).build())
reduced = SparkTransformExecutor.executeDistributed(
    [[w.value for w in r] for r in joined], tp2)
print("SHARD", json.dumps({{
    "transform": [[w.value for w in r] for r in out],
    "reduce": [[w.value for w in r] for r in reduced]}}), flush=True)
dist.destroy_process_group()
""")


def test_distributed_executors_in_a_two_process_gloo_group():
    """Each rank transforms its round-robin partition (the union, in
    rank-interleaved order, is the single-process result) and joins and
    reduces the groups its key hash owns (the union equals the
    reference's single-process join + reduce); the row-count all-reduce
    runs on gloo."""
    script = _WORKER.format(root=str(REPO), port=_free_port())
    env = dict(os.environ, PYTHONPATH=str(REPO))
    procs = [subprocess.Popen([sys.executable, "-c", script, str(r)],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True, env=env) for r in range(2)]
    outs = []
    for p in procs:
        stdout, stderr = p.communicate(timeout=240)
        assert p.returncode == 0, stderr[-2000:]
        line = next(ln for ln in stdout.splitlines()
                    if ln.startswith("SHARD"))
        outs.append(json.loads(line[len("SHARD "):]))
    schema = (J.Schema.Builder().addColumnInteger("a").addColumnDouble("b")
              .addColumnString("s").build())
    tp = (J.TransformProcess.Builder(schema).integerMathOp("a", "Add", 100)
          .removeColumns("s").build())
    expected = [[w.value for w in r] for r in tp.execute(
        [[J.IntWritable(i), J.DoubleWritable(i * 0.5), J.Text(f"r{i}")]
         for i in range(20)])]
    merged = [outs[i % 2]["transform"][i // 2] for i in range(20)]
    assert merged == expected
    ls = J.Schema.Builder().addColumnInteger("id").addColumnString(
        "n").build()
    rs = J.Schema.Builder().addColumnInteger("id").addColumnDouble(
        "v").build()
    j = (J.Join.Builder(J.JoinType.Inner).setJoinColumns("id")
         .setSchemas(ls, rs).build())
    joined = J.LocalTransformExecutor.executeJoin(
        j, [[i % 7, f"n{i}"] for i in range(21)],
        [[i % 7, i * 0.5] for i in range(14)])
    tp2 = (J.TransformProcess.Builder(j.getOutputSchema())
           .reduce(J.Reducer.Builder(J.ReduceOp.TakeFirst).keyColumns("id")
                   .sumColumns("v").countColumns("n").build()).build())
    want = sorted([[w.value for w in r] for r in tp2.execute(joined)])
    assert sorted(outs[0]["reduce"] + outs[1]["reduce"]) == want
    assert outs[0]["reduce"] and outs[1]["reduce"]
