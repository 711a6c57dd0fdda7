"""Transfer learning — surgery on trained networks; the port of
``deeplearning4j_tpu/models/transferlearning.py`` (deeplearning4j-nn's
``org/deeplearning4j/nn/transferlearning/{TransferLearning,
FineTuneConfiguration}.java`` and ``conf/layers/misc/FrozenLayer.java``):
freeze-up-to-layer feature extraction, output-head replacement
(``removeOutputLayer`` / ``nOutReplace`` / ``addLayer``), and a fine-tune
configuration overriding the global settings of the result.

Freezing is a flag the train step reads: a frozen layer's parameters
take no gradient, and its parameters and updater state pass through the
update unchanged.  Its forward runs in training mode, as the JAX
package's does, so a frozen BatchNormalization normalises with batch
statistics and moves its running statistics — where DL4J's
``FrozenLayer`` runs the layer as at inference (ROADMAP C17, kept).  The flag is not part of the layer's JSON (nor is it in
the reference).  ``build`` copies the kept parameters into a new network
on ``cuda`` unless the caller passes another device.
"""
from __future__ import annotations

import copy
from typing import Any, Dict, List, Optional

from deeplearning4j_tpu_torch.models.multilayer import (MultiLayerNetwork,
                                                        _clone_tree,
                                                        _sorted_leaves)
from deeplearning4j_tpu_torch.nn.conf import MultiLayerConfiguration

__all__ = ["FrozenLayer", "FineTuneConfiguration", "TransferLearning"]


def FrozenLayer(layer):
    """Mark a layer config frozen (reference: layers/misc/FrozenLayer.java —
    a wrapper layer; here a flag the train step honors)."""
    layer.frozen = True
    return layer


class FineTuneConfiguration:
    """Global-conf overrides applied to the transferred network.

    Reference: FineTuneConfiguration.java — builder mirrors
    NeuralNetConfiguration's global settings (updater, seed, activation,
    weightInit, l1/l2, ...).
    """

    def __init__(self, **overrides):
        self.overrides = overrides

    class Builder:
        def __init__(self):
            self._kw: Dict[str, Any] = {}

        def __getattr__(self, name):
            if name.startswith("_"):
                raise AttributeError(name)

            def setter(v):
                self._kw[name] = v
                return self

            return setter

        def build(self) -> "FineTuneConfiguration":
            return FineTuneConfiguration(**self._kw)

    @staticmethod
    def builder() -> "FineTuneConfiguration.Builder":
        return FineTuneConfiguration.Builder()

    def appliedTo(self, globalConf: Dict[str, Any]) -> Dict[str, Any]:
        g = dict(globalConf)
        g.update(self.overrides)
        return g


class TransferLearning:
    """Namespace matching the reference API: TransferLearning.Builder(net)."""

    class Builder:
        def __init__(self, net: MultiLayerNetwork):
            self._net = net
            self._ftc: Optional[FineTuneConfiguration] = None
            self._freezeUpTo = -1
            self._removeCount = 0
            self._added: List = []
            self._nOutReplace: Dict[int, tuple] = {}
            self._inputType = net.conf.inputType

        def fineTuneConfiguration(self, ftc: FineTuneConfiguration):
            self._ftc = ftc
            return self

        def setFeatureExtractor(self, layerIdx: int):
            """Freeze layers 0..layerIdx inclusive."""
            self._freezeUpTo = layerIdx
            return self

        def removeOutputLayer(self):
            self._removeCount += 1
            return self

        def removeLayersFromOutput(self, n: int):
            self._removeCount += n
            return self

        def addLayer(self, layer):
            self._added.append(layer)
            return self

        def nOutReplace(self, layerIdx: int, nOut: int, weightInit=None):
            self._nOutReplace[layerIdx] = (nOut, weightInit)
            return self

        def setInputType(self, inputType):
            self._inputType = inputType
            return self

        def build(self, device=None) -> MultiLayerNetwork:
            old = self._net
            keep = len(old.conf.layers) - self._removeCount
            if keep <= 0:
                raise ValueError("removed every layer")
            layers = [copy.deepcopy(l) for l in old.conf.layers[:keep]]

            fresh: set = set()  # layer indices that need re-initialization
            for idx, (nOut, wInit) in self._nOutReplace.items():
                if idx >= keep:
                    raise ValueError(f"nOutReplace index {idx} was removed")
                layers[idx].nOut = nOut
                if wInit is not None:
                    layers[idx].weightInit = wInit
                fresh.add(idx)
                # the next parameterized layer's fan-in changes too
                for j in range(idx + 1, keep):
                    if getattr(layers[j], "nOut", 0):
                        # with an InputType, _resolve re-infers (handles
                        # conv->dense spatial flattening); without one the
                        # direct fan-in is the replaced fan-out
                        layers[j].nIn = 0 if self._inputType is not None \
                            else nOut
                        fresh.add(j)
                        break

            first_new = len(layers)
            layers.extend(self._added)

            g = dict(old.conf.globalConf)
            if self._ftc is not None:
                g = self._ftc.appliedTo(g)

            for i in range(min(self._freezeUpTo + 1, len(layers))):
                layers[i].frozen = True

            pre = {i: p for i, p in old.conf.preProcessors.items()
                   if i < first_new}
            conf = MultiLayerConfiguration(
                layers=layers, globalConf=g, inputType=self._inputType,
                preProcessors=pre, backpropType=old.conf.backpropType,
                tbpttFwdLength=old.conf.tbpttFwdLength,
                tbpttBackLength=old.conf.tbpttBackLength)
            net = MultiLayerNetwork(conf, device=device)
            net.init()

            # the retained params as copies (fresh and new layers keep
            # their init), so training one net leaves the other as it was
            params = dict(net.params_)
            state = dict(net.state_)
            for i in range(first_new):
                li = str(i)
                if i in fresh or li not in old.params_:
                    continue
                params[li] = _clone_tree(old.params_[li], net.device)
                if li in old.state_:
                    state[li] = _clone_tree(old.state_[li], net.device)
            net.params_ = params
            net.state_ = state
            net._initOptState()  # updater state must match final params
            return net

    class GraphBuilder:
        """ComputationGraph surgery (reference:
        TransferLearning.GraphBuilder): freeze vertices, remove/replace
        outputs, add new layers/vertices, fine-tune the remainder."""

        def __init__(self, graph):
            self._graph = graph
            self._ftc: Optional[FineTuneConfiguration] = None
            self._frozen_until: Optional[str] = None
            self._removed: set = set()
            self._added: List[tuple] = []       # (name, layer_or_vertex, inputs)
            self._outputs: Optional[List[str]] = None

        def fineTuneConfiguration(self, ftc: FineTuneConfiguration):
            self._ftc = ftc
            return self

        def setFeatureExtractor(self, vertexName: str):
            """Freeze vertexName and every ancestor of it."""
            self._frozen_until = vertexName
            return self

        def removeVertexAndConnections(self, name: str):
            """Remove the vertex AND its edges: downstream vertices drop
            this input (a Merge keeps its remaining inputs) — reference
            semantics; a vertex left with NO inputs fails conf validation
            with a clear error, prompting a rewire."""
            self._removed.add(name)
            self._strip_edges = getattr(self, "_strip_edges", set())
            self._strip_edges.add(name)
            return self

        def removeVertexKeepConnections(self, name: str):
            """Remove the vertex but KEEP downstream references to its name
            — re-adding a vertex under the same name reconnects them
            (the reference's replace-in-place idiom)."""
            self._removed.add(name)
            return self

        def addLayer(self, name: str, layer, *inputs):
            self._added.append((name, layer, list(inputs)))
            return self

        def addVertex(self, name: str, vertex, *inputs):
            self._added.append((name, vertex, list(inputs)))
            return self

        def setOutputs(self, *names: str):
            self._outputs = list(names)
            return self

        def build(self, device=None):
            from deeplearning4j_tpu_torch.models.graph import \
                ComputationGraph
            from deeplearning4j_tpu_torch.models.graph_conf import \
                ComputationGraphConfiguration

            old = self._graph
            oc = old.conf
            strip = getattr(self, "_strip_edges", set())
            nodes = {n: (copy.deepcopy(node),
                         [i for i in ins if i not in strip])
                     for n, (node, ins) in oc.nodes.items()
                     if n not in self._removed}
            for name, node, ins in self._added:
                nodes[name] = (node, list(ins))
            outputs = self._outputs or [o for o in oc.outputs
                                        if o not in self._removed]
            g = dict(oc.globalConf)
            if self._ftc is not None:
                g = self._ftc.appliedTo(g)

            if self._frozen_until is not None:
                frozen = set()
                stack = [self._frozen_until]
                while stack:
                    n = stack.pop()
                    if n in frozen or n not in nodes:
                        continue
                    frozen.add(n)
                    stack.extend(i for i in nodes[n][1] if i in nodes)
                for n in frozen:
                    nodes[n][0].frozen = True

            pre = {n: p for n, p in oc.preProcessors.items() if n in nodes}
            conf = ComputationGraphConfiguration(
                inputs=list(oc.inputs), inputTypes=list(oc.inputTypes),
                nodes=nodes, outputs=outputs, preProcessors=pre,
                globalConf=g)
            net = ComputationGraph(conf, device=device)
            net.init()

            def shapes_match(a, b):
                la = [v for _p, v in _sorted_leaves(a)]
                lb = [v for _p, v in _sorted_leaves(b)]
                return len(la) == len(lb) and all(
                    x.shape == y.shape for x, y in zip(la, lb))

            new_names = {name for name, _n, _i in self._added}
            params = dict(net.params_)
            state = dict(net.state_)
            for n in nodes:
                if n in new_names:
                    continue        # fresh init for added vertices
                if n in old.params_ and n in params and \
                        shapes_match(old.params_[n], params[n]):
                    # transplant ONLY when surgery didn't resize this
                    # vertex (a changed fan-in keeps its fresh init)
                    params[n] = _clone_tree(old.params_[n], net.device)
                if n in old.state_ and n in state and \
                        shapes_match(old.state_[n], state[n]):
                    state[n] = _clone_tree(old.state_[n], net.device)
            net.params_ = params
            net.state_ = state
            net._initOptState()
            return net
