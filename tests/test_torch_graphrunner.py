"""Port parity: ``GraphRunner`` (``deeplearning4j_tpu_torch/imports/
graphrunner.py``) against the reference's, on both backends, and the
import facade's refusals.

- ``backend="tensorflow"``: TF runs the frozen graph in both packages, so
  the outputs agree bit for bit with each other and with the frozen
  function.
- ``backend="samediff"``: the graph imported by each package's
  ``TFGraphMapper`` (the port's with ``device="cpu"``): atol 2e-5 / rtol
  1e-4 against the reference (float32, summation order) and 1e-4 against
  TF.
- With tensorflow hidden, the TF backend raises ``ImportError`` naming it,
  as on a card's machine, while the samediff backend runs.
"""
import sys

import numpy as np
import pytest

tf = pytest.importorskip("tensorflow")

from deeplearning4j_tpu.imports import GraphRunner as JGraphRunner  # noqa: E402
from deeplearning4j_tpu_torch.imports import GraphRunner  # noqa: E402
from deeplearning4j_tpu_torch.imports.graphdef import decode_graphdef  # noqa: E402

pytestmark = pytest.mark.torch_port

REF_TOL = dict(atol=2e-5, rtol=1e-4)


@pytest.fixture(scope="module")
def mlp():
    """A frozen two-layer MLP with a named output, its feed and TF's
    answer."""
    from tensorflow.python.framework.convert_to_constants import (
        convert_variables_to_constants_v2)
    r = np.random.RandomState(0)
    w1 = tf.Variable(r.randn(8, 16).astype(np.float32) * 0.3)
    w2 = tf.Variable(r.randn(16, 4).astype(np.float32) * 0.3)

    def f(x):
        return tf.nn.softmax(tf.matmul(tf.nn.relu(tf.matmul(x, w1)), w2),
                             name="probs")
    frozen = convert_variables_to_constants_v2(tf.function(f)
                                               .get_concrete_function(
        tf.TensorSpec([None, 8], tf.float32)))
    gd = frozen.graph.as_graph_def()
    x = r.randn(5, 8).astype(np.float32)
    golden = frozen(tf.constant(x))
    golden = (golden[0] if isinstance(golden, (list, tuple))
              else golden).numpy()
    return gd, x, golden


def test_tensorflow_backend_matches_the_reference(mlp):
    gd, x, golden = mlp
    ours = GraphRunner(gd.SerializeToString(), ["x"], ["probs"])
    ref = JGraphRunner(gd, ["x"], ["probs"])
    a, b = ours.run({"x": x})["probs"], ref.run({"x": x})["probs"]
    np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(a, golden)
    np.testing.assert_array_equal(ours.runTensorflowGraph({"x": x})["probs"],
                                  a)
    with pytest.raises(TypeError, match="decoded GraphDef"):
        GraphRunner(decode_graphdef(gd.SerializeToString()), ["x"],
                    ["probs"])


@pytest.mark.parametrize("form", ["bytes", "tf_graphdef", "decoded"])
def test_samediff_backend_matches_the_reference(mlp, form):
    gd, x, golden = mlp
    graph = {"bytes": gd.SerializeToString(), "tf_graphdef": gd,
             "decoded": decode_graphdef(gd.SerializeToString())}[form]
    ours = GraphRunner(graph, ["x"], ["probs"], backend="samediff",
                       device="cpu")
    ref = JGraphRunner(gd, ["x"], ["probs"], backend="samediff")
    a, b = ours.run({"x": x})["probs"], ref.run({"x": x})["probs"]
    assert isinstance(a, np.ndarray) and a.shape == b.shape == (5, 4)
    np.testing.assert_allclose(a, b, **REF_TOL)
    np.testing.assert_allclose(a, golden, atol=1e-4, rtol=1e-4)


def test_default_names_and_close(mlp):
    gd, x, _ = mlp
    ours = GraphRunner(gd, backend="samediff", device="cpu")
    ref = JGraphRunner(gd, backend="samediff")
    assert ours.getInputNames() == ref.getInputNames() == ["x"]
    assert ours.getOutputNames() == ref.getOutputNames()
    out = ours.getOutputNames()[0]
    np.testing.assert_allclose(ours.run({"x": x})[out],
                               ref.run({"x": x})[out], **REF_TOL)
    ours.close()
    with pytest.raises(ValueError, match="unknown GraphRunner backend"):
        GraphRunner(gd, backend="onnxruntime")


def test_tensorflow_backend_names_tensorflow_when_it_is_absent(
        mlp, monkeypatch):
    gd, x, golden = mlp
    raw = gd.SerializeToString()
    monkeypatch.setitem(sys.modules, "tensorflow", None)
    with pytest.raises(ImportError, match="tensorflow"):
        GraphRunner(raw, ["x"], ["probs"])
    runner = GraphRunner(raw, ["x"], ["probs"], backend="samediff",
                         device="cpu")
    np.testing.assert_allclose(runner.run({"x": x})["probs"], golden,
                               atol=1e-4, rtol=1e-4)


def test_samediff_backend_defaults_to_cuda(mlp):
    import torch
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is usable")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        GraphRunner(mlp[0], backend="samediff")


# the ONNX importer is ported (its entry points are held in
# test_torch_onnx_import.py), and so is the Keras importer (ROADMAP A12d,
# held in test_torch_keras_import.py): its entry points now read the file,
# so a missing one is a FileNotFoundError, not a refusal naming an item;
# the cases keep their ids
@pytest.mark.parametrize("call,item", [
    pytest.param(
        lambda m: m.KerasModelImport.importKerasModelAndWeights(
            "no_such_model.h5", device="cpu"),
        "A12d", id="call2-A12d"),
    pytest.param(
        lambda m: m.KerasModelImport.importKerasSequentialModelAndWeights(
            "no_such_model.h5", device="cpu"), "A12d", id="call3-A12d")])
def test_unported_importers_name_their_roadmap_item(call, item):
    import deeplearning4j_tpu_torch.imports as imports
    from deeplearning4j_tpu_torch.imports.keras_import import \
        KerasModelImport
    assert imports.KerasModelImport is KerasModelImport
    with pytest.raises(FileNotFoundError, match="no_such_model"):
        call(imports)
