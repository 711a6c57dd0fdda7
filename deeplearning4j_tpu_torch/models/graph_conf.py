"""ComputationGraph configuration: a DAG of layers and vertices — the port
of ``deeplearning4j_tpu/models/graph_conf.py`` (the reference's
``ComputationGraphConfiguration.java``, its ``GraphBuilder`` and the vertex
configs of ``conf/graph/``).

The topological order is the reference's sorted-ready Kahn's algorithm, so
``ComputationGraph.params()`` lays its flat vector out as the JAX graph
does.  For the layers and vertices the port has, ``toJson()`` writes the
reference's JSON.  Every vertex of the reference is here: merge,
element-wise, subset, scale, shift, stack, unstack, L2-normalize and
preprocessor.
"""
from __future__ import annotations

import dataclasses
import json
from typing import Any, Dict, List, Optional, Tuple

import torch

from deeplearning4j_tpu_torch.learning.config import IUpdater
from deeplearning4j_tpu_torch.nn.conf import _auto_preprocessor
from deeplearning4j_tpu_torch.nn.conf.inputs import InputType
from deeplearning4j_tpu_torch.nn.conf.layers import Layer, layer_from_json
from deeplearning4j_tpu_torch.nn.conf.preprocessors import InputPreProcessor

__all__ = ["ComputationGraphConfiguration", "GraphBuilder", "GraphVertex",
           "MergeVertex", "ElementWiseVertex", "SubsetVertex", "ScaleVertex",
           "ShiftVertex", "StackVertex", "UnstackVertex", "L2NormalizeVertex",
           "PreprocessorVertex", "vertex_from_json"]


@dataclasses.dataclass
class GraphVertex:
    """Non-layer DAG node (reference: ``conf/graph/GraphVertex.java``)."""

    def getOutputType(self, *inputTypes: InputType) -> InputType:
        return inputTypes[0]

    def forward(self, *inputs):
        raise NotImplementedError

    def toJson(self) -> dict:
        d = dataclasses.asdict(self)
        d["@class"] = type(self).__name__
        return d


@dataclasses.dataclass
class MergeVertex(GraphVertex):
    """Concat along the feature dim (dim 1 for FF/CNN/RNN)."""

    def getOutputType(self, *its):
        k = its[0].kind
        if k == "FF":
            return InputType.feedForward(sum(i.size for i in its))
        if k == "CNN":
            return InputType.convolutional(its[0].height, its[0].width,
                                           sum(i.channels for i in its))
        if k == "RNN":
            return InputType.recurrent(sum(i.size for i in its),
                                       its[0].timeSeriesLength)
        return its[0]

    def forward(self, *inputs):
        return torch.cat(inputs, dim=1)


@dataclasses.dataclass
class ElementWiseVertex(GraphVertex):
    op: str = "Add"  # Add | Subtract | Product | Average | Max | Min

    def forward(self, *inputs):
        op = self.op.lower()
        if op == "add":
            out = inputs[0]
            for x in inputs[1:]:
                out = out + x
            return out
        if op == "subtract":
            return inputs[0] - inputs[1]
        if op == "product":
            out = inputs[0]
            for x in inputs[1:]:
                out = out * x
            return out
        if op == "average":
            return sum(inputs) / len(inputs)
        if op == "max":
            out = inputs[0]
            for x in inputs[1:]:
                out = torch.maximum(out, x)
            return out
        if op == "min":
            out = inputs[0]
            for x in inputs[1:]:
                out = torch.minimum(out, x)
            return out
        raise ValueError(f"Unknown ElementWiseVertex op {self.op}")


@dataclasses.dataclass
class SubsetVertex(GraphVertex):
    """Features ``fromIndex`` .. ``toIndex`` (inclusive, as the reference)
    along axis 1."""
    fromIndex: int = 0
    toIndex: int = 0

    def getOutputType(self, *its):
        n = self.toIndex - self.fromIndex + 1
        it = its[0]
        if it.kind == "CNN":
            return InputType.convolutional(it.height, it.width, n)
        if it.kind == "RNN":
            return InputType.recurrent(n, it.timeSeriesLength)
        return InputType.feedForward(n)

    def forward(self, *inputs):
        return inputs[0][:, self.fromIndex:self.toIndex + 1]


@dataclasses.dataclass
class ScaleVertex(GraphVertex):
    scaleFactor: float = 1.0

    def forward(self, *inputs):
        return inputs[0] * self.scaleFactor


@dataclasses.dataclass
class ShiftVertex(GraphVertex):
    shiftFactor: float = 0.0

    def forward(self, *inputs):
        return inputs[0] + self.shiftFactor


@dataclasses.dataclass
class StackVertex(GraphVertex):
    """Stack along axis 0 (the minibatch) — reference ``StackVertex``."""

    def forward(self, *inputs):
        return torch.cat(inputs, dim=0)


@dataclasses.dataclass
class UnstackVertex(GraphVertex):
    """Slice ``fromIndex`` of ``stackSize`` equal parts of the minibatch."""
    fromIndex: int = 0
    stackSize: int = 1

    def forward(self, *inputs):
        x = inputs[0]
        n = x.shape[0] // self.stackSize
        return x[self.fromIndex * n:(self.fromIndex + 1) * n]


@dataclasses.dataclass
class L2NormalizeVertex(GraphVertex):
    """x / (||x|| + eps), the norm over every axis but the minibatch."""
    eps: float = 1e-8

    def forward(self, *inputs):
        x = inputs[0]
        norm = torch.sqrt(torch.sum(x * x, dim=tuple(range(1, x.dim())),
                                    keepdim=True))
        return x / (norm + self.eps)


@dataclasses.dataclass
class PreprocessorVertex(GraphVertex):
    preProcessor: Optional[InputPreProcessor] = None

    def getOutputType(self, *its):
        return self.preProcessor.getOutputType(its[0])

    def forward(self, *inputs):
        return self.preProcessor.preProcess(inputs[0], inputs[0].shape[0])

    def toJson(self) -> dict:
        return {"@class": "PreprocessorVertex",
                "preProcessor": self.preProcessor.toJson()}


_VERTEX_REGISTRY = {c.__name__: c for c in [
    MergeVertex, ElementWiseVertex, SubsetVertex, ScaleVertex, ShiftVertex,
    StackVertex, UnstackVertex, L2NormalizeVertex]}


def vertex_from_json(d: dict) -> GraphVertex:
    d = dict(d)
    name = d.pop("@class")
    if name == "PreprocessorVertex":
        return PreprocessorVertex(InputPreProcessor.fromJson(
            d["preProcessor"]))
    return _VERTEX_REGISTRY[name](**d)


class GraphBuilder:
    """Reference: ``ComputationGraphConfiguration.GraphBuilder``."""

    def __init__(self, global_conf: Dict[str, Any]):
        self._g = global_conf
        self._inputs: List[str] = []
        self._inputTypes: List[InputType] = []
        # name -> (layer or vertex, input names)
        self._nodes: Dict[str, Tuple[Any, List[str]]] = {}
        self._outputs: List[str] = []
        self._preprocs: Dict[str, InputPreProcessor] = {}
        self._backpropType = "Standard"
        self._tbpttFwd = 20
        self._tbpttBack = 20

    def backpropType(self, bt: str):
        self._backpropType = bt
        return self

    def tBPTTForwardLength(self, n: int):
        self._tbpttFwd = int(n)
        return self

    def tBPTTBackwardLength(self, n: int):
        self._tbpttBack = int(n)
        return self

    def tBPTTLength(self, n: int):
        return self.tBPTTForwardLength(n).tBPTTBackwardLength(n)

    def addInputs(self, *names: str):
        self._inputs.extend(names)
        return self

    def setInputTypes(self, *types: InputType):
        self._inputTypes = list(types)
        return self

    def addLayer(self, name: str, layer: Layer, *inputs):
        # DL4J's optional preprocessor: addLayer(name, layer, preproc, *in)
        if inputs and isinstance(inputs[0], InputPreProcessor):
            self._preprocs[name] = inputs[0]
            inputs = inputs[1:]
        layer.name = name
        self._nodes[name] = (layer, list(inputs))
        return self

    def addVertex(self, name: str, vertex: GraphVertex, *inputs):
        self._nodes[name] = (vertex, list(inputs))
        return self

    def setOutputs(self, *names: str):
        self._outputs = list(names)
        return self

    def inputPreProcessor(self, layerName: str, p: InputPreProcessor):
        self._preprocs[layerName] = p
        return self

    def build(self) -> "ComputationGraphConfiguration":
        return ComputationGraphConfiguration(
            inputs=self._inputs, inputTypes=self._inputTypes,
            nodes=self._nodes, outputs=self._outputs,
            preProcessors=self._preprocs, globalConf=self._g,
            backpropType=self._backpropType, tbpttFwdLength=self._tbpttFwd,
            tbpttBackLength=self._tbpttBack)


class ComputationGraphConfiguration:
    def __init__(self, inputs: List[str], inputTypes: List[InputType],
                 nodes: Dict[str, Tuple[Any, List[str]]], outputs: List[str],
                 preProcessors: Dict[str, InputPreProcessor],
                 globalConf: Dict[str, Any],
                 backpropType: str = "Standard",
                 tbpttFwdLength: int = 20, tbpttBackLength: int = 20):
        self.inputs = inputs
        self.inputTypes = inputTypes
        self.nodes = nodes
        self.outputs = outputs
        self.preProcessors = preProcessors
        self.globalConf = globalConf
        self.backpropType = backpropType
        self.tbpttFwdLength = tbpttFwdLength
        self.tbpttBackLength = tbpttBackLength
        self.topoOrder: List[str] = []
        self.vertexInputTypes: Dict[str, InputType] = {}
        self.vertexOutputTypes: Dict[str, Optional[InputType]] = {}
        self._resolve()

    # -- topo sort + shape inference ------------------------------------
    def _resolve(self):
        indeg = {n: 0 for n in self.nodes}
        dependents: Dict[str, List[str]] = {n: [] for n in self.nodes}
        for name, (_, ins) in self.nodes.items():
            for i in ins:
                if i not in self.inputs and i not in self.nodes:
                    raise ValueError(f"Vertex {name}: unknown input {i!r}")
                if i in self.nodes:
                    indeg[name] += 1
                    dependents[i].append(name)
        ready = sorted(n for n, d in indeg.items() if d == 0)
        order = []
        while ready:
            n = ready.pop(0)
            order.append(n)
            for d in dependents[n]:
                indeg[d] -= 1
                if indeg[d] == 0:
                    ready.append(d)
        if len(order) != len(self.nodes):
            cyclic = sorted(set(self.nodes) - set(order))
            raise ValueError(f"Graph contains a cycle involving {cyclic}")
        self.topoOrder = order

        types = self.vertexOutputTypes   # name -> output InputType
        for i, name in enumerate(self.inputs):
            if i < len(self.inputTypes):
                types[name] = self.inputTypes[i]
        for name in order:
            node, ins = self.nodes[name]
            in_types = [types.get(i) for i in ins]
            if isinstance(node, Layer):
                node.applyGlobalDefaults(self.globalConf)
                it = in_types[0] if in_types else None
                if it is not None:
                    if name not in self.preProcessors:
                        p = _auto_preprocessor(it, node.preferredFormat())
                        if p is not None:
                            self.preProcessors[name] = p
                    if name in self.preProcessors:
                        it = self.preProcessors[name].getOutputType(it)
                    node.inferNIn(it)
                    self.vertexInputTypes[name] = it
                    types[name] = node.getOutputType(it)
            elif in_types and all(t is not None for t in in_types):
                types[name] = node.getOutputType(*in_types)
                self.vertexInputTypes[name] = in_types[0]

    # -- serde -----------------------------------------------------------
    def toJson(self) -> str:
        g = {k: (v.toJson() if isinstance(v, IUpdater) else v)
             for k, v in self.globalConf.items()}
        return json.dumps({
            "globalConf": g,
            "inputs": self.inputs,
            "inputTypes": [t.toJson() for t in self.inputTypes],
            "outputs": self.outputs,
            "backpropType": self.backpropType,
            "tbpttFwdLength": self.tbpttFwdLength,
            "tbpttBackLength": self.tbpttBackLength,
            "nodes": {name: {"node": node.toJson(), "inputs": ins,
                             "kind": "layer" if isinstance(node, Layer)
                             else "vertex"}
                      for name, (node, ins) in self.nodes.items()},
            "preProcessors": {k: v.toJson()
                              for k, v in self.preProcessors.items()},
        }, indent=2, default=str)

    @staticmethod
    def fromJson(s: str) -> "ComputationGraphConfiguration":
        d = json.loads(s)
        g = dict(d["globalConf"])
        if isinstance(g.get("updater"), dict):
            g["updater"] = IUpdater.fromJson(g["updater"])
        nodes = {}
        for name, nd in d["nodes"].items():
            node = layer_from_json(nd["node"]) if nd["kind"] == "layer" \
                else vertex_from_json(nd["node"])
            nodes[name] = (node, list(nd["inputs"]))
        return ComputationGraphConfiguration(
            inputs=list(d["inputs"]),
            inputTypes=[InputType.fromJson(t)
                        for t in d.get("inputTypes", [])],
            nodes=nodes, outputs=list(d["outputs"]),
            preProcessors={k: InputPreProcessor.fromJson(v)
                           for k, v in (d.get("preProcessors") or {}).items()},
            globalConf=g,
            backpropType=d.get("backpropType", "Standard"),
            tbpttFwdLength=int(d.get("tbpttFwdLength", 20)),
            tbpttBackLength=int(d.get("tbpttBackLength", 20)))
