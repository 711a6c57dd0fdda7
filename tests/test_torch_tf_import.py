"""Port parity: the TF importer (``deeplearning4j_tpu_torch/imports``)
against tensorflow and against the reference's importer on the same bytes.

- The GraphDef decoder (``imports/graphdef.py``) against tensorflow's parse
  of the same bytes: every node's name, op, inputs and attrs, every Const
  against ``tensor_util.MakeNdarray``, on the committed BERT-base skeleton,
  on the mini frozen BERT of ``tests/test_bert_tf_import.py`` and on a
  graph written to hold every value encoding (float16, bfloat16 as its 16
  bits, int64, bool, strings, packed and unpacked repeated fields, -1 in a
  Reshape shape, a scalar padded to its shape).
- The graphs of the reference's TF tests (``tests/test_imports.py``,
  ``tests/test_import_breadth.py`` and the ``tests/test_tfgraph_corpus.py``
  corpus) through both importers: the port against TF at each test's own
  tolerance, and against the reference at atol 2e-5 / rtol 1e-4 (float32,
  summation order).
- The mini frozen BERT: its forward against TF (the reference test's 2e-3)
  and against the reference's import (2e-5), the same trainable variables,
  and one Adam fine-tune step's loss (1e-5 relative) and variables against
  the reference (Adam's first step moves each variable by about lr whatever
  its gradient, so 99.9 % hold to 1e-6 and every one to 2 lr + 1e-6).
- The committed skeleton refilled by ``chip_smoke._fill_stripped_consts``:
  the same op histogram and variables as the reference's import of the
  same refilled bytes (no forward: BERT-base runs on the card).
TF graphs are frozen once per module at mini widths.
"""
import functools
import inspect
import json
import os
import struct
from collections import Counter

import numpy as np
import pytest

tf = pytest.importorskip("tensorflow")

from tensorflow.core.framework import (attr_value_pb2, graph_pb2,  # noqa: E402
                                       tensor_pb2, tensor_shape_pb2,
                                       types_pb2)
from tensorflow.python.framework import tensor_util  # noqa: E402

import chip_smoke  # noqa: E402
from deeplearning4j_tpu.autodiff.samediff import (  # noqa: E402
    TrainingConfig as JTrainingConfig)
from deeplearning4j_tpu.datasets.dataset import (  # noqa: E402
    MultiDataSet as JMultiDataSet)
from deeplearning4j_tpu.imports import TFGraphMapper as JMapper  # noqa: E402
from deeplearning4j_tpu.learning import Adam as JAdam  # noqa: E402
from deeplearning4j_tpu_torch.autodiff import TrainingConfig  # noqa: E402
from deeplearning4j_tpu_torch.datasets import MultiDataSet  # noqa: E402
from deeplearning4j_tpu_torch.imports import TFGraphMapper  # noqa: E402
from deeplearning4j_tpu_torch.imports.graphdef import (  # noqa: E402
    GraphDef, decode_graphdef, dtype_name, tensor_value)
from deeplearning4j_tpu_torch.learning import Adam  # noqa: E402

import test_tfgraph_corpus as corpus  # noqa: E402
from _torch_parity import _np  # noqa: E402
from test_bert_tf_import import _frozen_bert  # noqa: E402

pytestmark = pytest.mark.torch_port

REF_TOL = dict(atol=2e-5, rtol=1e-4)
SKELETON = os.path.join(os.path.dirname(__file__), "fixtures",
                        "tf_bert_base_b32_t128_skeleton")


# ---------------------------------------------------------------------------
# the decoder
# ---------------------------------------------------------------------------
def _varint(v):
    v &= (1 << 64) - 1
    out = bytearray()
    while True:
        b, v = v & 0x7F, v >> 7
        out.append(b | (0x80 if v else 0))
        if not v:
            return bytes(out)


def _len(fnum, payload):
    return _varint((fnum << 3) | 2) + _varint(len(payload)) + payload


def _unpacked_const(name, dtype, dims, field, values, wire):
    """A NodeDef Const whose TensorProto repeats ``field`` unpacked, one
    key per value (the encoding proto2 writers use), written by hand."""
    shape = b"".join(_len(2, _varint(1 << 3) + _varint(d)) for d in dims)
    t = _varint(1 << 3) + _varint(dtype) + _len(2, shape)
    for v in values:
        if wire == 5:
            t += _varint((field << 3) | 5) + struct.pack("<f", v)
        else:
            t += _varint(field << 3) + _varint(int(v))
    attr = _len(1, b"value") + _len(2, _len(8, t))
    dt = _len(1, b"dtype") + _len(2, _varint(6 << 3) + _varint(dtype))
    return _len(1, name.encode()) + _len(2, b"Const") + _len(5, attr) \
        + _len(5, dt)


def _const(gd, name, proto):
    n = gd.node.add(name=name, op="Const")
    n.attr["value"].tensor.CopyFrom(proto)
    n.attr["dtype"].type = proto.dtype
    return n


def _shape(*dims, unknown_rank=False):
    s = tensor_shape_pb2.TensorShapeProto(unknown_rank=unknown_rank)
    for d in dims:
        s.dim.add(size=d)
    return s


def _encodings_graph() -> bytes:
    """A GraphDef that holds each value encoding the decoder reads."""
    gd = graph_pb2.GraphDef()
    P = tensor_pb2.TensorProto
    f16 = np.array([1.5, -2.25, 65504.0, 6e-5], np.float16)
    bf16_bits = np.array([0x3FC0, 0xC010, 0x7F7F, 0x0001], np.uint16)
    _const(gd, "f16_half_val", P(dtype=types_pb2.DT_HALF,
                                 tensor_shape=_shape(4),
                                 half_val=f16.view(np.uint16).tolist()))
    _const(gd, "f16_content", tensor_util.make_tensor_proto(f16))
    _const(gd, "bf16_half_val", P(dtype=types_pb2.DT_BFLOAT16,
                                  tensor_shape=_shape(2, 2),
                                  half_val=bf16_bits.tolist()))
    _const(gd, "bf16_content", P(dtype=types_pb2.DT_BFLOAT16,
                                 tensor_shape=_shape(4),
                                 tensor_content=bf16_bits.tobytes()))
    _const(gd, "i64", P(dtype=types_pb2.DT_INT64, tensor_shape=_shape(3),
                        int64_val=[-(2 ** 40), -1, 2 ** 62]))
    _const(gd, "i64_content", tensor_util.make_tensor_proto(
        np.array([[-7, 2 ** 50], [0, -1]], np.int64)))
    _const(gd, "reshape_shape", P(dtype=types_pb2.DT_INT32,
                                  tensor_shape=_shape(2), int_val=[-1, 4]))
    _const(gd, "bool", P(dtype=types_pb2.DT_BOOL, tensor_shape=_shape(3),
                         bool_val=[True, False, True]))
    _const(gd, "bool_fill", P(dtype=types_pb2.DT_BOOL,
                              tensor_shape=_shape(2, 2), bool_val=[True]))
    _const(gd, "strings", P(dtype=types_pb2.DT_STRING,
                            tensor_shape=_shape(3),
                            string_val=[b"ab", b"", b"\xff\x00"]))
    _const(gd, "string_fill", P(dtype=types_pb2.DT_STRING,
                                tensor_shape=_shape(2), string_val=[b"z"]))
    _const(gd, "scalar_fill", P(dtype=types_pb2.DT_FLOAT,
                                tensor_shape=_shape(2, 3), float_val=[1.5]))
    _const(gd, "empty_fill", P(dtype=types_pb2.DT_FLOAT,
                               tensor_shape=_shape(2)))
    _const(gd, "f64", P(dtype=types_pb2.DT_DOUBLE, tensor_shape=_shape(2),
                        double_val=[1e300, -3.25]))
    _const(gd, "u8", P(dtype=types_pb2.DT_UINT8, tensor_shape=_shape(2),
                       int_val=[0, 255]))
    _const(gd, "scalar", tensor_util.make_tensor_proto(np.float32(2.5)))
    n = gd.node.add(name="attrs", op="Placeholder")
    a = n.attr
    a["dtype"].type = types_pb2.DT_FLOAT
    a["shape"].shape.CopyFrom(_shape(-1, 4))
    a["unknown"].shape.CopyFrom(_shape(unknown_rank=True))
    a["s"].s = b"SAME"
    a["i"].i = -3
    a["f"].f = 0.125
    a["b"].b = True
    a["b_false"].b = False
    a["i_zero"].i = 0
    a["ints"].list.i.extend([1, -2, 3])
    a["floats"].list.f.extend([0.5, -1.5])
    a["strs"].list.s.extend([b"a", b"bc"])
    a["types"].list.type.extend([types_pb2.DT_INT32, types_pb2.DT_FLOAT])
    a["shapes"].list.shape.extend([_shape(2, -1), _shape()])
    a["empty_list"].list.CopyFrom(attr_value_pb2.AttrValue.ListValue())
    a["placeholder"].placeholder = "T"
    n.input.extend(["f16_half_val", "^bool"])
    raw = gd.SerializeToString()
    raw += _len(1, _unpacked_const("unpacked_f", types_pb2.DT_FLOAT, [3], 5,
                                   [0.5, -1.0, 3.25], 5))
    raw += _len(1, _unpacked_const("unpacked_i", types_pb2.DT_INT32, [2], 7,
                                   [-1, 4], 0))
    return raw


@functools.lru_cache(maxsize=None)
def _graph_bytes(which):
    if which == "skeleton":
        with open(SKELETON + ".pb", "rb") as f:
            return f.read()
    if which == "mini_bert":
        return _mini_bert()[1].SerializeToString()
    return _encodings_graph()


def _attr_equal(ours, theirs):
    arm = theirs.WhichOneof("value")
    assert ours.WhichOneof("value") == arm
    if arm in ("s", "i", "f", "b", "type", "placeholder"):
        assert getattr(ours, arm) == getattr(theirs, arm)
    elif arm == "shape":
        assert [d.size for d in ours.shape.dim] == \
            [d.size for d in theirs.shape.dim]
        assert ours.shape.unknown_rank == theirs.shape.unknown_rank
    elif arm == "tensor":
        _tensor_equal(ours.tensor, theirs.tensor)
    elif arm == "list":
        lo, lt = ours.list, theirs.list
        assert lo.s == list(lt.s) and lo.i == list(lt.i)
        assert lo.f == list(lt.f) and lo.b == list(lt.b)
        assert lo.type == list(lt.type)
        assert [[d.size for d in s.dim] for s in lo.shape] == \
            [[d.size for d in s.dim] for s in lt.shape]


def _tensor_equal(ours, theirs):
    assert ours.dtype == theirs.dtype
    mine, golden = tensor_value(ours), tensor_util.MakeNdarray(theirs)
    if dtype_name(ours.dtype) == "bfloat16":
        # numpy has no bfloat16: the decoder gives its float32 values
        golden = golden.astype(np.float32)
    assert mine.dtype == golden.dtype and mine.shape == golden.shape
    if mine.dtype == object:
        assert mine.tolist() == golden.tolist()
    else:
        np.testing.assert_array_equal(mine, golden)


@pytest.mark.parametrize("which", ["encodings", "mini_bert", "skeleton"])
def test_decoder_matches_tensorflows_parse(which):
    raw = _graph_bytes(which)
    ours = decode_graphdef(raw)
    theirs = graph_pb2.GraphDef.FromString(raw)
    assert len(ours.node) == len(theirs.node)
    for a, b in zip(ours.node, theirs.node):
        assert (a.name, a.op, a.input, a.device) == \
            (b.name, b.op, list(b.input), b.device)
        assert sorted(a.attr) == sorted(b.attr)
        for k in b.attr:
            _attr_equal(a.attr[k], b.attr[k])


def test_decoder_reads_every_encoding():
    gd = decode_graphdef(_graph_bytes("encodings"))
    nodes = {n.name: n for n in gd.node}

    def val(name):
        return tensor_value(nodes[name].attr["value"].tensor)
    np.testing.assert_array_equal(val("reshape_shape"), [-1, 4])
    np.testing.assert_array_equal(val("unpacked_i"), [-1, 4])
    np.testing.assert_array_equal(val("unpacked_f"), [0.5, -1.0, 3.25])
    np.testing.assert_array_equal(val("scalar_fill"), np.full((2, 3), 1.5))
    np.testing.assert_array_equal(val("bool_fill"), np.ones((2, 2), bool))
    assert val("string_fill").tolist() == [b"z", b"z"]
    np.testing.assert_array_equal(val("i64"), [-(2 ** 40), -1, 2 ** 62])
    np.testing.assert_array_equal(val("bf16_half_val"), np.array(
        [[1.5, -2.25], [3.3895314e38, 9.18355e-41]], np.float32))
    assert dtype_name(nodes["bf16_content"].attr["value"].tensor.dtype) == \
        "bfloat16"
    a = nodes["attrs"]
    assert a.input == ["f16_half_val", "^bool"]
    assert a.attr["i"].i == -3 and a.attr["ints"].list.i == [1, -2, 3]
    assert [d.size for d in a.attr["shape"].shape.dim] == [-1, 4]


def test_decoder_takes_bytes_paths_and_protobufs(tmp_path):
    raw = _graph_bytes("encodings")
    p = tmp_path / "g.pb"
    p.write_bytes(raw)
    for g in (raw, str(p), graph_pb2.GraphDef.FromString(raw),
              decode_graphdef(raw)):
        gd = decode_graphdef(g)
        assert isinstance(gd, GraphDef)
        assert [n.name for n in gd.node][-2:] == ["unpacked_f", "unpacked_i"]
    with pytest.raises(TypeError):
        decode_graphdef(3)


# ---------------------------------------------------------------------------
# the reference's TF test graphs through both importers
# ---------------------------------------------------------------------------
def _spec(*shape, dtype=tf.float32):
    return tf.TensorSpec(list(shape), dtype)


def _reference_test_graphs():
    """The graphs of tests/test_imports.py and tests/test_import_breadth.py
    as (fn, specs, feeds in argument order, output name, tolerance)."""
    R = np.random.RandomState
    g = {}
    w1 = tf.Variable(R(0).randn(8, 16).astype(np.float32) * 0.3)
    b1 = tf.Variable(np.zeros(16, np.float32))
    w2 = tf.Variable(R(1).randn(16, 4).astype(np.float32) * 0.3)
    g["mlp"] = (lambda x: tf.nn.softmax(tf.matmul(tf.nn.relu(
        tf.matmul(x, w1) + b1), w2), name="probs"), [_spec(None, 8)],
        [R(2).randn(5, 8).astype(np.float32)], "probs", 1e-5)
    gam = tf.Variable(np.ones(12, np.float32))
    bet = tf.Variable(np.zeros(12, np.float32))

    def ln(x):
        mu = tf.reduce_mean(x, axis=-1, keepdims=True)
        var = tf.reduce_mean(tf.math.squared_difference(x, mu), axis=-1,
                             keepdims=True)
        return tf.identity((x - mu) * tf.math.rsqrt(var + 1e-6) * gam + bet,
                           name="ln_out")
    g["layernorm"] = (ln, [_spec(None, 12)],
                      [R(3).randn(4, 12).astype(np.float32)], "ln_out",
                      1e-4)
    k = tf.Variable(R(4).randn(3, 3, 2, 4).astype(np.float32) * 0.3)
    g["conv_pool_nhwc"] = (lambda x: tf.nn.max_pool2d(tf.nn.relu(
        tf.nn.conv2d(x, k, strides=1, padding="SAME")), 2, 2, "VALID",
        name="pool_out"), [_spec(None, 8, 8, 2)],
        [R(5).randn(2, 8, 8, 2).astype(np.float32)], "pool_out", 1e-4)

    def attn(q, kv):
        w = tf.nn.softmax(tf.matmul(q, kv, transpose_b=True) / 4.0)
        return tf.identity(tf.matmul(w, kv), name="attn_out")
    g["attention_batchmatmul"] = (attn, [_spec(2, 5, 16), _spec(2, 7, 16)],
                                  [R(6).randn(2, 5, 16).astype(np.float32),
                                   R(7).randn(2, 7, 16).astype(np.float32)],
                                  "attn_out", 1e-4)
    g["shapes_gather_concat"] = (lambda x: tf.identity(tf.reduce_sum(tf.exp(
        tf.concat([tf.gather(tf.reshape(tf.transpose(x, [1, 0]), [-1]),
                             tf.constant([0, 3, 5]))] * 2, axis=0))),
        name="out"), [_spec(3, 4)], [R(8).randn(3, 4).astype(np.float32)],
        "out", 1e-4)
    B, T, H, nh = 2, 6, 16, 2
    dh = H // nh
    r = R(0)

    def mk(*s):
        return tf.Variable(r.randn(*s).astype(np.float32) * 0.2)
    Wq, Wk, Wv, Wo = mk(H, H), mk(H, H), mk(H, H), mk(H, H)
    g1, bb1 = tf.Variable(np.ones(H, np.float32)), \
        tf.Variable(np.zeros(H, np.float32))
    Wi, Bi = mk(H, 32), tf.Variable(np.zeros(32, np.float32))
    Wo2, Bo2 = mk(32, H), tf.Variable(np.zeros(H, np.float32))
    g2, bb2 = tf.Variable(np.ones(H, np.float32)), \
        tf.Variable(np.zeros(H, np.float32))

    def lnb(x, gg, b):
        mu = tf.reduce_mean(x, -1, keepdims=True)
        v = tf.reduce_mean(tf.math.squared_difference(x, mu), -1,
                           keepdims=True)
        return (x - mu) * tf.math.rsqrt(v + 1e-6) * gg + b

    def block(x):
        def proj(w):
            y = tf.reshape(tf.matmul(tf.reshape(x, [B * T, H]), w),
                           [B, T, nh, dh])
            return tf.transpose(y, [0, 2, 1, 3])
        q, kk, v = proj(Wq), proj(Wk), proj(Wv)
        s = tf.matmul(q, kk, transpose_b=True) / np.sqrt(dh).astype(
            np.float32)
        ctx = tf.reshape(tf.transpose(tf.matmul(tf.nn.softmax(s), v),
                                      [0, 2, 1, 3]), [B, T, H])
        a = tf.reshape(tf.matmul(tf.reshape(ctx, [B * T, H]), Wo), [B, T, H])
        x1 = lnb(x + a, g1, bb1)
        h = tf.nn.gelu(tf.matmul(tf.reshape(x1, [B * T, H]), Wi) + Bi)
        f = tf.matmul(h, Wo2) + Bo2
        return tf.identity(lnb(x1 + tf.reshape(f, [B, T, H]), g2, bb2),
                           name="block_out")
    g["transformer_block"] = (block, [_spec(B, T, H)],
                              [r.randn(B, T, H).astype(np.float32)],
                              "block_out", 1e-3)
    g["negative_index_shrink"] = (lambda x: tf.identity(x[-1], name="last"),
                                  [_spec(4, 3)],
                                  [R(0).randn(4, 3).astype(np.float32)],
                                  "last", 1e-4)
    # tests/test_import_breadth.py
    x35 = R(0).randn(3, 5).astype(np.float32)
    m = R(1).randn(4, 4)
    spd = (m @ m.T + 4 * np.eye(4)).astype(np.float32)
    xi = R(2).randint(0, 1000, (3, 4)).astype(np.int32)
    yi = R(3).randint(1, 1000, (3, 4)).astype(np.int32)
    xf = np.abs(R(4).randn(3, 4)).astype(np.float32) + 0.5
    yf = np.abs(R(5).randn(3, 4)).astype(np.float32) + 0.5
    i32 = tf.int32
    for name, fn, specs, feeds, tol in [
            ("roll", lambda v: tf.roll(v, [2], [1]), [_spec(3, 5)], [x35],
             1e-4),
            ("reverse", lambda v: tf.reverse(v, [1]), [_spec(3, 5)], [x35],
             1e-4),
            ("mirror_pad", lambda v: tf.pad(v, [[1, 1], [2, 2]],
                                            mode="REFLECT"),
             [_spec(3, 5)], [x35], 1e-4),
            ("det", tf.linalg.det, [_spec(4, 4)], [spd], 1e-2),
            ("inv", tf.linalg.inv, [_spec(4, 4)], [spd], 1e-3),
            ("cholesky", tf.linalg.cholesky, [_spec(4, 4)], [spd], 1e-3),
            ("band_part", lambda v: tf.linalg.band_part(v, 1, 1),
             [_spec(4, 4)], [spd], 1e-4),
            ("bitwise_xor", tf.bitwise.bitwise_xor,
             [_spec(3, 4, dtype=i32)] * 2, [xi, yi], 1e-4),
            ("left_shift", lambda a, b: tf.bitwise.left_shift(a, b % 8),
             [_spec(3, 4, dtype=i32)] * 2, [xi, yi], 1e-4),
            ("igamma", tf.math.igamma, [_spec(3, 4)] * 2, [xf, yf], 1e-3),
            ("asinh", tf.math.asinh, [_spec(3, 4)], [xf], 1e-4),
            ("top_k", lambda v: tf.math.top_k(v, k=3).values,
             [_spec(4, 7)], [R(6).randn(4, 7).astype(np.float32)], 1e-4),
            ("unsorted_segment_sum", lambda v: tf.math.unsorted_segment_sum(
                v, tf.constant([0, 1, 0, 2, 1, 0]), 3), [_spec(6, 3)],
             [R(7).randn(6, 3).astype(np.float32)], 1e-4),
            ("resize_bilinear_align", lambda v:
             tf.compat.v1.image.resize_bilinear(v, [12, 12],
                                                align_corners=True),
             [_spec(1, 6, 6, 2)], [R(8).rand(1, 6, 6, 2).astype(np.float32)],
             1e-3),
            ("lrn", lambda v: tf.nn.local_response_normalization(
                v, depth_radius=2, bias=1.0, alpha=1e-3, beta=0.75),
             [_spec(2, 4, 4, 8)],
             [np.abs(R(9).randn(2, 4, 4, 8)).astype(np.float32)], 1e-4),
            ("fft_roundtrip", lambda v: tf.signal.irfft(tf.signal.rfft(v)),
             [_spec(8)], [R(10).randn(8).astype(np.float32)], 1e-3)]:
        g[name] = (_named(fn, len(specs)), specs, feeds, "o", tol)
    return g


def _named(f, arity):
    """``f`` with its output named "o", taking one or two tensors."""
    if arity == 1:
        return lambda v: tf.identity(f(v), name="o")
    return lambda a, b: tf.identity(f(a, b), name="o")


@functools.lru_cache(maxsize=None)
def _frozen(name):
    """(frozen function, GraphDef, feeds by placeholder, output, atol) of a
    reference-test graph (``ref:<name>``) or a corpus entry
    (``corpus:<name>``)."""
    from tensorflow.python.framework.convert_to_constants import (
        convert_variables_to_constants_v2)
    kind, key = name.split(":", 1)
    if kind == "ref":
        fn, specs, feeds, out, atol = _REF_GRAPHS()[key]
        frozen = convert_variables_to_constants_v2(
            tf.function(fn).get_concrete_function(*specs))
        gd = frozen.graph.as_graph_def()
        names = list(inspect.signature(fn).parameters)
        feed = {n.name: feeds[names.index(n.name)] for n in gd.node
                if n.op == "Placeholder"}
        return frozen, gd, feed, feeds, out, atol
    fn, specs, feeds = corpus.CORPUS[key]()
    frozen, gd = corpus._freeze(fn, specs)
    vals = list(feeds.values())
    phs = [n.name for n in gd.node if n.op == "Placeholder"]
    feed = {p: feeds[p] for p in phs} if all(p in feeds for p in phs) \
        else dict(zip(phs, vals))
    out = [n.name for n in gd.node if n.op == "Identity"][-1]
    return frozen, gd, feed, vals, out, 1e-4


_REF_GRAPHS = functools.lru_cache(maxsize=None)(_reference_test_graphs)
GRAPHS = [f"ref:{k}" for k in (
    "mlp", "layernorm", "conv_pool_nhwc", "attention_batchmatmul",
    "shapes_gather_concat", "transformer_block", "negative_index_shrink",
    "roll", "reverse", "mirror_pad", "det", "inv", "cholesky", "band_part",
    "bitwise_xor", "left_shift", "igamma", "asinh", "top_k",
    "unsorted_segment_sum", "resize_bilinear_align", "lrn",
    "fft_roundtrip")] + [f"corpus:{k}" for k in sorted(corpus.CORPUS)]


@pytest.mark.parametrize("name", GRAPHS)
def test_reference_tf_graph_through_both_importers(name):
    frozen, gd, feed, vals, out, atol = _frozen(name)
    golden = frozen(*[tf.constant(v) for v in vals])
    golden = (golden[0] if isinstance(golden, (list, tuple))
              else golden).numpy()
    raw = gd.SerializeToString()
    j = np.asarray(JMapper.importGraph(raw).outputSingle(feed, out).numpy())
    t = _np(TFGraphMapper.importGraph(raw, device="cpu").outputSingle(
        feed, out))
    assert t.shape == golden.shape == j.shape
    rtol = 1e-3 if name.startswith("corpus:") else 1e-4
    np.testing.assert_allclose(t, golden, atol=atol, rtol=rtol)
    if t.dtype.kind in "iub":
        np.testing.assert_array_equal(t, j)
    else:
        np.testing.assert_allclose(t, j, **REF_TOL)


def reference_test_ops():
    """The TF ops the graphs of the reference's TF tests hold."""
    return {n.op for name in GRAPHS for n in _frozen(name)[1].node} | \
        {n.op for n in _mini_bert()[1].node}


def test_every_rule_is_held_somewhere():
    """Each of the port's TF rules has a graph here or in
    ``tests/test_torch_tf_rules.py``."""
    from deeplearning4j_tpu_torch.imports.tf_import import TF_OPS
    from test_torch_tf_rules import HANDMADE, RULES
    held = set(RULES) | set(HANDMADE) | reference_test_ops() | {"NoOp"}
    assert sorted(set(TF_OPS) - held) == []


def test_an_unsupported_op_names_itself():
    gd = graph_pb2.GraphDef()
    gd.node.add(name="x", op="Placeholder")
    gd.node.add(name="y", op="NoSuchOp", input=["x"])
    with pytest.raises(ValueError, match="unsupported op 'NoSuchOp'"):
        TFGraphMapper.importGraph(gd.SerializeToString(), device="cpu")


# ---------------------------------------------------------------------------
# the mini frozen BERT
# ---------------------------------------------------------------------------
@functools.lru_cache(maxsize=None)
def _mini_bert():
    return _frozen_bert()


def _bert_io(gd):
    phs = [n.name for n in gd.node if n.op == "Placeholder"]
    out = [n.name for n in gd.node if n.op == "Identity"][-1]
    return ([p for p in phs if "input_ids" in p][0],
            [p for p in phs if "attention_mask" in p][0], out)


def _bert_batch():
    rng = np.random.RandomState(0)
    ids = rng.randint(0, 512, (2, 16)).astype(np.int32)
    mask = np.ones((2, 16), np.int32)
    mask[1, 11:] = 0
    return ids, mask


def test_mini_bert_forward_matches_tf_and_the_reference():
    frozen, gd = _mini_bert()
    ids_ph, mask_ph, out = _bert_io(gd)
    ids, mask = _bert_batch()
    golden = frozen(tf.constant(ids), tf.constant(mask))
    golden = (golden[0] if isinstance(golden, (list, tuple))
              else golden).numpy()
    raw = gd.SerializeToString()
    js = JMapper.importGraph(raw)
    ts = TFGraphMapper.importGraph(raw, device="cpu")
    feed = {ids_ph: ids, mask_ph: mask}
    j = np.asarray(js.outputSingle(feed, out).numpy())
    t = _np(ts.outputSingle(feed, out))
    np.testing.assert_allclose(t, golden, atol=2e-3, rtol=1e-3)
    np.testing.assert_allclose(t, j, **REF_TOL)
    jv = {v.name(): v.shape for v in js.variables()
          if v.variableType == "VARIABLE"}
    tv = {n: tuple(a.shape) for n, a in ts._var_values().items()}
    assert len(tv) > 20 and tv == jv


def _with_head(sd, pkg, gd):
    ids_ph, mask_ph, out = _bert_io(gd)
    rng = np.random.RandomState(1)
    w = sd.var("cls/W", (rng.randn(64, 2) * 0.1).astype(np.float32))
    labels = sd.placeholder("labels", shape=[2, 2])
    logits = sd.getVariable(out).mean(1).mmul(w)
    loss = sd.loss().softmaxCrossEntropy(labels, logits, name="loss")
    sd.setLossVariables(loss)
    TC, A = (JTrainingConfig, JAdam) if pkg == "jax" else \
        (TrainingConfig, Adam)
    sd.setTrainingConfig(TC(updater=A(3e-4),
                            dataSetFeatureMapping=[ids_ph, mask_ph],
                            dataSetLabelMapping=["labels"]))
    return sd


def test_mini_bert_finetune_step_matches_the_reference():
    _, gd = _mini_bert()
    raw = gd.SerializeToString()
    ids, mask = _bert_batch()
    y = np.eye(2, dtype=np.float32)[[0, 1]]
    js = _with_head(JMapper.importGraph(raw), "jax", gd)
    ts = _with_head(TFGraphMapper.importGraph(raw, device="cpu"), "torch",
                    gd)
    lj = js.fit(JMultiDataSet([ids, mask], [y]), epochs=1).lossCurve()
    lt = ts.fit(MultiDataSet([ids, mask], [y]), epochs=1).lossCurve()
    assert len(lj) == len(lt) == 1
    np.testing.assert_allclose(lt, lj, rtol=1e-5)
    lr = 3e-4
    n_total = n_in = 0
    worst = 0.0
    for v in js.variables():
        if v.variableType != "VARIABLE":
            continue
        d = np.abs(_np(ts._arrays[v.name()])
                   - np.asarray(js._arrays[v.name()]))
        n_total += d.size
        n_in += int((d <= 1e-6).sum())
        worst = max(worst, float(d.max()))
    assert n_in / n_total >= 0.999 and worst <= 2 * lr + 1e-6, \
        (n_in / n_total, worst)


# ---------------------------------------------------------------------------
# the committed BERT-base skeleton, refilled
# ---------------------------------------------------------------------------
def test_refilled_skeleton_imports_as_the_reference_imports_it():
    with open(SKELETON + ".json") as f:
        manifest = json.load(f)
    with open(SKELETON + ".pb", "rb") as f:
        skeleton = f.read()
    # the refill the card makes on the decoder's GraphDef, and the same
    # refill on tensorflow's parse, whose bytes both importers read
    ours = chip_smoke._fill_stripped_consts(decode_graphdef(skeleton),
                                            manifest)
    theirs = chip_smoke._fill_stripped_consts(
        graph_pb2.GraphDef.FromString(skeleton), manifest)
    for a, b in zip(ours.node, theirs.node):
        if a.op == "Const":
            np.testing.assert_array_equal(
                tensor_value(a.attr["value"].tensor),
                tensor_util.MakeNdarray(b.attr["value"].tensor))
    raw = theirs.SerializeToString()
    del ours, theirs
    js = JMapper.importGraph(raw)
    ts = TFGraphMapper.importGraph(raw, device="cpu")
    hist = Counter(n.op for n in ts._ops)
    assert hist == Counter(n.op for n in js._ops)
    assert dict(hist) == chip_smoke.TF_BERT_OPS
    assert sum(hist.values()) == 1061 and len(hist) == 19
    jv = {v.name(): v.shape for v in js.variables()
          if v.variableType == "VARIABLE"}
    tv = {n: tuple(a.shape) for n, a in ts._var_values().items()}
    assert tv == jv and len(tv) == 199
    big = {e["name"] for e in manifest["stripped"]}
    assert big <= set(tv)
    for n in sorted(big)[:3]:      # the refilled values, bit for bit
        np.testing.assert_array_equal(_np(ts._arrays[n]),
                                      np.asarray(js._arrays[n]))
