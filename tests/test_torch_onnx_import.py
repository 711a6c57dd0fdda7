"""Port parity: the ONNX importer (``deeplearning4j_tpu_torch/imports/
onnx_import*.py``) against the reference's importer and torch's own
outputs, on the same bytes.

- The torch-exported fixtures (``tests/fixtures/torch_*.onnx``, the
  goldens of ``tests/test_onnx_oracle.py``) and the narrow BERT export of
  ``tests/fixtures/make_onnx_bert_skeleton.py`` through both packages: the
  port equal to the reference at atol 1e-5 (float32 summation order) and
  to torch's golden at the oracle's tolerance (1e-4; 2e-4 for the BERT
  mini), with the same trainable variables.
- ``bert_mini``, ``tiny_rnn`` and the narrow BERT fine-tuned for 4 Adam
  steps in both packages from the same imported weights: the losses to
  1e-5 relative; Adam moves a variable by about lr a step whatever its
  gradient's size, so every element is held to 2 lr a step and 99.9 % of
  them to 1e-5 (the key projections' biases apart: their exact gradient
  is 0, and each package's is rounding noise).
- The narrow BERT stripped as the generator strips BERT-base and refilled
  by ``chip_smoke._fill_stripped_initializers``: the refilled bytes carry
  the draws in the manifest's order and every other initializer unchanged,
  and they import and run alike in both packages.
- The committed BERT-base skeleton: its nodes decoded alike by both
  packages' readers and held to its manifest; refilled, its initializers'
  names, dtypes, shapes and bytes alike, the reference's SameDiff op
  histogram (``chip_smoke.ONNX_BERT_OPS``) and the same variables from both
  importers (no forward: BERT-base runs on the card).
- The reference's faults the port keeps, each shown in both packages:
  ROADMAP C9 (an integer ``Div`` folds with floor division, where ONNX
  truncates toward zero) and C14 (HF's default BERT export does not import:
  ``_fold_constants`` folds neither ``Equal`` nor ``Where``, so its
  attention mask's ``Expand`` has no constant shape).
"""
import json
import os
import sys
from collections import Counter

import numpy as np
import pytest

import chip_smoke
from deeplearning4j_tpu.autodiff.samediff import (
    TrainingConfig as JTrainingConfig, VariableType as JVariableType)
from deeplearning4j_tpu.datasets.dataset import (
    MultiDataSet as JMultiDataSet)
from deeplearning4j_tpu.imports import OnnxImporter as JImporter
from deeplearning4j_tpu.imports import onnx_import as jonnx
from deeplearning4j_tpu.learning import Adam as JAdam
from deeplearning4j_tpu_torch.autodiff import TrainingConfig, VariableType
from deeplearning4j_tpu_torch.datasets import MultiDataSet
from deeplearning4j_tpu_torch.imports import OnnxImporter
from deeplearning4j_tpu_torch.imports import onnx_import as tonnx
from deeplearning4j_tpu_torch.learning import Adam

from _torch_parity import _np

pytestmark = pytest.mark.torch_port

FIX = os.path.join(os.path.dirname(__file__), "fixtures")
sys.path.insert(0, FIX)
import make_onnx_bert_skeleton as gen  # noqa: E402

NARROW = "onnx_bert_narrow_b2_t16"
REF_ATOL = 1e-5
FIXTURES = dict(chip_smoke.ONNX_FIXTURES)


def _path(stem):
    return os.path.join(FIX, f"{stem}.onnx")


def _feeds(stem, ins):
    io = np.load(os.path.join(FIX, f"{stem}_io.npz"))
    return {n: io[n if n in io else "x"] for n in ins}, io["y"]


def _import_both(path):
    return (OnnxImporter.importModel(path, device="cpu"),
            JImporter.importModel(path))


def _variables(sd, kind):
    return {v.name(): v for v in sd.variables()
            if v.variableType == kind}


@pytest.mark.parametrize("stem", sorted(FIXTURES))
def test_fixture_matches_reference_and_torch(stem):
    (sd, ins, outs), (jsd, jins, jouts) = _import_both(_path(stem))
    assert (ins, outs) == (jins, jouts)
    feed, golden = _feeds(stem, ins)
    got = _np(sd.outputSingle(feed, outs[0]))
    want = np.asarray(jsd.output(feed, outs[0])[outs[0]].numpy())
    np.testing.assert_allclose(got, want, atol=REF_ATOL, rtol=0)
    np.testing.assert_allclose(got, golden, atol=FIXTURES[stem], rtol=0)
    tv = _variables(sd, VariableType.VARIABLE)
    jv = _variables(jsd, JVariableType.VARIABLE)
    assert sorted(tv) == sorted(jv) and tv
    for n in tv:
        np.testing.assert_array_equal(_np(sd._arrays[n]),
                                      np.asarray(jsd._arrays[n]))


def _fit_both(stem, steps=4, lr=1e-2):
    """Both packages' imports of ``stem`` fitted ``steps`` Adam steps on
    the golden's inputs: an MSE loss against zeros, or for a sequence
    output (BERT's last hidden state, LayerNorm's output, whose mean square
    is 1 whatever comes before) a cross-entropy of a fixed two-class head
    on the CLS row against seeded labels."""
    runs = {}
    for pkg, (sd, ins, outs) in zip(("torch", "jax"),
                                    _import_both(_path(stem))):
        feed, golden = _feeds(stem, ins)
        out = sd.getVariable(outs[0])
        y = sd.placeholder("target")
        if golden.ndim == 3:
            b, _, hidden = golden.shape
            rng = np.random.RandomState(1)
            head = sd.constant((rng.randn(hidden, 2) * 0.5).astype(
                np.float32))
            logits = out.get(slice(None), 0).reshape(b, hidden).mmul(head)
            tgt = np.eye(2, dtype=np.float32)[rng.randint(0, 2, b)]
            sd.loss().softmaxCrossEntropy(y, logits, name="loss")
        else:
            tgt = np.zeros_like(golden)
            sd.loss().meanSquaredError(out, y, name="loss")
        before = {n: np.array(_np(sd._arrays[n])) if pkg == "torch"
                  else np.array(sd._arrays[n])
                  for n in _variables(sd, "VARIABLE")}
        cfg, mds, upd = (TrainingConfig, MultiDataSet, Adam) \
            if pkg == "torch" else (JTrainingConfig, JMultiDataSet, JAdam)
        sd.setTrainingConfig(cfg(updater=upd(lr),
                                 dataSetFeatureMapping=list(ins),
                                 dataSetLabelMapping=["target"]))
        hist = sd.fit(mds(features=[feed[n] for n in ins], labels=[tgt]),
                      epochs=steps)
        runs[pkg] = (sd, np.asarray(hist.lossCurve(), np.float64), before)
    return runs


@pytest.mark.parametrize("stem", ["torch_bert_mini", "torch_tiny_rnn",
                                  NARROW])
def test_fine_tune_matches_reference(stem):
    runs = _fit_both(stem)
    (sd, tc, before), (jsd, jc, _) = runs["torch"], runs["jax"]
    assert len(tc) == len(jc) == 4 and tc[-1] < tc[0]
    np.testing.assert_allclose(tc, jc, rtol=1e-5)
    tv = _variables(sd, VariableType.VARIABLE)
    assert sorted(tv) == sorted(_variables(jsd, JVariableType.VARIABLE))
    moved = n_tight = n_total = 0
    for n in tv:
        t, j = _np(sd._arrays[n]), np.asarray(jsd._arrays[n])
        d = np.abs(t - j)
        assert d.max() <= ADAM_BOUND, (n, d.max())
        # a key projection's bias has an exact gradient of 0 (softmax does
        # not see a constant added to every score of a query): each
        # package's gradient there is rounding noise, held to the bound
        if not _key_bias(n):
            n_tight += int((d <= 1e-5).sum())
            n_total += d.size
        moved += not np.array_equal(t, before[n])
    assert moved == len(tv)
    assert n_tight >= 0.999 * n_total, (n_tight, n_total)


# Adam moves a variable by about lr a step whatever its gradient's size: a
# near-zero gradient that rounds differently in the two packages can move
# it the other way (4 steps at lr 1e-2)
ADAM_BOUND = 2 * 1e-2 * 4


def _key_bias(name):
    return name.endswith(("attn.k.bias", "attention.self.key.bias"))


# ---------------------------------------------------------------------------
# the refill, on the narrow BERT
# ---------------------------------------------------------------------------
def _initializers(model):
    _, inits, _, _ = jonnx._parse_model(model)
    return inits


def test_refilled_narrow_skeleton_through_both_packages(tmp_path):
    with open(_path(NARROW), "rb") as f:
        original = f.read()
    skeleton, manifest = gen.strip(original)
    assert len(skeleton) < len(original) and len(manifest["stripped"]) > 8
    model = chip_smoke._fill_stripped_initializers(skeleton, manifest,
                                                   seed=3, std=0.02)
    assert len(model) == len(original)
    before, after = _initializers(original), _initializers(model)
    assert sorted(before) == sorted(after)
    rng = np.random.RandomState(3)
    drawn = {e["name"]: rng.normal(0.0, 0.02, e["shape"]).astype(e["dtype"])
             for e in manifest["stripped"]}
    for n, a in after.items():
        np.testing.assert_array_equal(a, drawn.get(n, before[n]), err_msg=n)
    path = tmp_path / "refilled.onnx"
    path.write_bytes(model)
    (sd, ins, outs), (jsd, _, _) = _import_both(str(path))
    feed, _ = _feeds(NARROW, ins)
    got = _np(sd.outputSingle(feed, outs[0]))
    want = np.asarray(jsd.output(feed, outs[0])[outs[0]].numpy())
    assert np.isfinite(got).all() and got.shape == (2, 16, 64)
    np.testing.assert_allclose(got, want, atol=REF_ATOL, rtol=0)
    assert sorted(_variables(sd, VariableType.VARIABLE)) == \
        sorted(_variables(jsd, JVariableType.VARIABLE))


# ---------------------------------------------------------------------------
# the committed BERT-base skeleton
# ---------------------------------------------------------------------------
def _attrs_equal(a, b):
    assert sorted(a) == sorted(b)
    for k in a:
        if isinstance(a[k], np.ndarray) or isinstance(b[k], np.ndarray):
            assert np.asarray(a[k]).dtype == np.asarray(b[k]).dtype, k
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
        else:
            assert a[k] == b[k], k


@pytest.fixture(scope="module")
def bert_base():
    """(skeleton bytes, manifest, refilled bytes) of the committed
    skeleton."""
    skeleton, manifest = chip_smoke._onnx_skeleton()
    return skeleton, manifest, chip_smoke._fill_stripped_initializers(
        skeleton, manifest)


def _graph_nodes(mod, model):
    return [mod._Node(b) for b in
            mod._collect(mod._collect(model)[7][0]).get(1, [])]


def test_skeleton_decodes_as_the_reference_decodes_it(bert_base):
    skeleton, manifest, model = bert_base
    c = chip_smoke.ONNX_BERT
    ours, theirs = _graph_nodes(tonnx, skeleton), \
        _graph_nodes(jonnx, skeleton)
    assert len(ours) == len(theirs) == c["nodes"] == manifest["nodes"]
    for a, b in zip(ours, theirs):
        assert (a.name, a.op_type, a.inputs, a.outputs) == \
            (b.name, b.op_type, b.inputs, b.outputs)
        _attrs_equal(a.attrs, b.attrs)
    assert dict(Counter(n.op_type for n in ours)) == manifest["ops"]
    # the refilled model: initializers, inputs and outputs alike
    t_nodes, t_inits, t_in, t_out = tonnx._parse_model(model)
    _, j_inits, j_in, j_out = jonnx._parse_model(model)
    assert (t_in, t_out) == (j_in, j_out)
    assert [n for n, _ in t_in] == ["input_ids", "attention_mask",
                                    "token_type_ids"]
    assert list(t_inits) == list(j_inits)
    for n in t_inits:
        a, b = t_inits[n], j_inits[n]
        assert (a.dtype, a.shape) == (b.dtype, b.shape), n
        assert a.tobytes() == b.tobytes(), n
    stripped = {e["name"]: e for e in manifest["stripped"]}
    assert len(stripped) == c["stripped"]
    for n, e in stripped.items():
        assert (t_inits[n].dtype.name, list(t_inits[n].shape)) == \
            (e["dtype"], e["shape"])
    del t_nodes


def test_refilled_skeleton_imports_as_the_reference_imports_it(bert_base,
                                                               tmp_path):
    _, _, model = bert_base
    path = tmp_path / "bert_base.onnx"
    path.write_bytes(model)
    (sd, ins, outs), (jsd, jins, jouts) = _import_both(str(path))
    assert (ins, outs) == (jins, jouts) == (
        ["input_ids", "attention_mask", "token_type_ids"],
        ["last_hidden_state"])
    hist = Counter(n.op for n in sd._ops)
    assert dict(hist) == dict(Counter(n.op for n in jsd._ops)) == \
        chip_smoke.ONNX_BERT_OPS
    tv = _variables(sd, VariableType.VARIABLE)
    jv = _variables(jsd, JVariableType.VARIABLE)
    assert sorted(tv) == sorted(jv) and len(tv) == 78
    assert {n: tuple(sd._arrays[n].shape) for n in tv} == \
        {n: tuple(jsd._arrays[n].shape) for n in jv}
    assert sum(sd._arrays[n].numel() for n in tv) == 108_774_912


def test_skeleton_manifest_is_the_generators():
    with open(chip_smoke.ONNX_BERT["stem"] + ".json") as f:
        manifest = json.load(f)
    assert manifest["batch"] == 32 and manifest["seq"] == 128
    assert manifest["strip_bytes"] == gen.STRIP_BYTES == 4096
    nbytes = {"float32": 4, "int64": 8}
    for e in manifest["stripped"]:
        assert int(np.prod(e["shape"])) * nbytes[e["dtype"]] > 4096
    assert manifest["full_bytes"] > 400_000_000


# ---------------------------------------------------------------------------
# the reference's faults the port keeps
# ---------------------------------------------------------------------------
def test_c14_hf_default_bert_export_fails_in_both_packages():
    """HF's BertModel export builds its additive mask through
    ConstantOfShape -> Equal -> Where -> Expand; ``_fold_constants`` folds
    neither Equal nor Where, so Expand's shape is not a constant and both
    importers refuse the model with the same error (ROADMAP C14)."""
    path = _path("onnx_bert_narrow_hf_default")
    nodes, _, _, _ = tonnx._parse_model(open(path, "rb").read())
    ops = Counter(n.op_type for n in nodes)
    assert ops["Equal"] and ops["Where"] and ops["Expand"]
    errors = []
    for call in (lambda: OnnxImporter.importModel(path, device="cpu"),
                 lambda: JImporter.importModel(path)):
        with pytest.raises(ValueError, match="must be a constant "
                           "initializer") as e:
            call()
        errors.append(str(e.value))
    assert errors[0] == errors[1] == \
        "'/bert/Where_output_0' must be a constant initializer"


def test_c9_integer_div_folds_with_floor_division_in_both_packages(
        tmp_path):
    """ONNX's integer Div truncates toward zero (-7 / 2 = -3); the
    reference's fold floors (-4), and the port keeps it (ROADMAP C9)."""
    from test_imports import TestOnnxImport as T
    a, b = np.array([-7, 7, -9], np.int64), np.array([2, 2, 4], np.int64)
    blob = T._model(nodes=[T._node("Div", ["a", "b"], ["q"])],
                    inits=[T._tensor("a", a), T._tensor("b", b)],
                    inputs=[], outputs=[T._vinfo("q", (3,))])
    path = tmp_path / "div.onnx"
    path.write_bytes(blob)
    (sd, _, outs), (jsd, _, jouts) = _import_both(str(path))
    assert sd._ops == [] and jsd._ops == []          # folded, not emitted
    got = _np(sd.outputSingle({}, outs[0]))
    want = np.asarray(jsd.output({}, jouts[0])[jouts[0]].numpy())
    np.testing.assert_array_equal(got, [-4, 3, -3])
    np.testing.assert_array_equal(got, want)
    assert not np.array_equal(got, np.trunc(a / b).astype(np.int64))


def test_trainable_initializer_classification_matches_reference():
    """Only initializers consumed (possibly through layout ops) by
    weight-bearing ops fine-tune, and the embedding table feeding Gather;
    a table only multiplied in stays frozen (the oracle's case)."""
    from types import SimpleNamespace as N
    from deeplearning4j_tpu.autodiff.samediff import SameDiff as JSameDiff
    from deeplearning4j_tpu_torch.autodiff import SameDiff
    consts = {k: np.ones((4, 4), np.float32) for k in
              ["w_direct", "w_transposed", "bias_wrapped", "emb_table",
               "anchor_table"]}
    nodes = [
        N(op_type="Transpose", inputs=["w_transposed"], outputs=["wt"]),
        N(op_type="MatMul", inputs=["x", "wt"], outputs=["mm"]),
        N(op_type="Unsqueeze", inputs=["bias_wrapped"], outputs=["bu"]),
        N(op_type="Add", inputs=["mm", "bu"], outputs=["y"]),
        N(op_type="Gemm", inputs=["y", "w_direct"], outputs=["g"]),
        N(op_type="Gather", inputs=["emb_table", "ids"], outputs=["e"]),
        N(op_type="Mul", inputs=["g", "anchor_table"], outputs=["z"]),
    ]
    ours = tonnx._Ctx(SameDiff.create("cpu"), consts, nodes).trainable
    theirs = jonnx._Ctx(JSameDiff.create(), consts, nodes).trainable
    assert ours == theirs == {"w_direct", "w_transposed", "bias_wrapped",
                              "emb_table"}


def test_importer_reads_the_file_it_is_given(tmp_path):
    """``importOnnxModel(path, device)`` is ``OnnxImporter.importModel``;
    a missing file raises as the reference's does."""
    sd, ins, outs = tonnx.importOnnxModel(_path("torch_tiny_mlp"), "cpu")
    assert sd.device.type == "cpu" and ins and outs
    with pytest.raises(FileNotFoundError):
        OnnxImporter.importModel(str(tmp_path / "absent.onnx"),
                                 device="cpu")
    with pytest.raises(FileNotFoundError):
        JImporter.importModel(str(tmp_path / "absent.onnx"))
