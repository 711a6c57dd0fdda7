"""GraphRunner — execute a frozen TF graph in-process; the port of
``deeplearning4j_tpu/imports/graphrunner.py``.

Reference: ``nd4j-tensorflow`` ``org/nd4j/tensorflow/conversion/graphrunner/
GraphRunner.java`` (SURVEY.md §2.3): run a TensorFlow GraphDef for hybrid
pipelines, arrays in, arrays out.

Two modes:

- ``GraphRunner(graph)`` — TensorFlow executes the frozen graph (the
  reference's semantics), given as bytes, a path or a tensorflow
  ``GraphDef``.  It needs the tensorflow package, imported inside the
  call; where it is absent (the card's machine has none) the call raises
  ``ImportError`` naming it.
- ``GraphRunner(..., backend="samediff")`` — the graph is imported through
  :class:`TFGraphMapper` and run by the port on ``device`` (``cuda`` unless
  the caller asks for another).
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np

from deeplearning4j_tpu_torch.imports.graphdef import (GraphDef,
                                                       decode_graphdef)

__all__ = ["GraphRunner"]


class GraphRunner:
    def __init__(self, graph, inputNames: Optional[Sequence[str]] = None,
                 outputNames: Optional[Sequence[str]] = None,
                 backend: str = "tensorflow", device=None):
        self._gd = decode_graphdef(graph)
        self.backend = backend
        self.inputNames = list(inputNames) if inputNames else \
            [n.name for n in self._gd.node if n.op == "Placeholder"]
        self.outputNames = list(outputNames) if outputNames else \
            [[n.name for n in self._gd.node][-1]]
        self._sd = None
        self._fn = None
        if backend == "samediff":
            from deeplearning4j_tpu_torch.imports.tf_import import (
                TFGraphMapper)
            self._sd = TFGraphMapper.importGraph(self._gd, device=device)
        elif backend == "tensorflow":
            try:
                import tensorflow as tf
            except ImportError as e:
                raise ImportError(
                    "GraphRunner(backend='tensorflow') needs the tensorflow "
                    "package, which is not installed; "
                    "backend='samediff' runs the graph without it") from e
            if isinstance(graph, GraphDef):
                raise TypeError(
                    "GraphRunner(backend='tensorflow') takes the graph's "
                    "bytes, a path or a tensorflow GraphDef, not the "
                    "port's decoded GraphDef")
            if isinstance(graph, str):
                with open(graph, "rb") as f:
                    graph = f.read()
            gd = tf.compat.v1.GraphDef.FromString(
                graph if isinstance(graph, (bytes, bytearray))
                else graph.SerializeToString())

            def _imported():
                tf.graph_util.import_graph_def(gd, name="")

            wrapped = tf.compat.v1.wrap_function(_imported, [])
            g = wrapped.graph
            ins = [g.get_tensor_by_name(f"{n}:0") for n in self.inputNames]
            outs = [g.get_tensor_by_name(f"{n}:0")
                    for n in self.outputNames]
            self._fn = wrapped.prune(ins, outs)
            self._tf = tf
        else:
            raise ValueError(f"unknown GraphRunner backend {backend!r}")

    def run(self, inputs: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
        """Feed {input name: array}, get {output name: array}."""
        feeds = [np.asarray(inputs[n]) for n in self.inputNames]
        if self._sd is not None:
            res = self._sd.output(dict(zip(self.inputNames, feeds)),
                                  *self.outputNames)
            return {n: res[n].detach().cpu().numpy()
                    for n in self.outputNames}
        outs = self._fn(*[self._tf.constant(f) for f in feeds])
        if not isinstance(outs, (list, tuple)):
            outs = [outs]
        return {n: np.asarray(o) for n, o in zip(self.outputNames, outs)}

    # reference naming
    def runTensorflowGraph(self, inputs):
        return self.run(inputs)

    def getInputNames(self) -> List[str]:
        return list(self.inputNames)

    def getOutputNames(self) -> List[str]:
        return list(self.outputNames)

    def close(self) -> None:
        self._fn = None
        self._sd = None
