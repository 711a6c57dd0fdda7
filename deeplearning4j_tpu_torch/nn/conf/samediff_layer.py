"""SameDiffLayer — user-defined layers inside MultiLayerNetwork and
ComputationGraph; the port of ``deeplearning4j_tpu/nn/conf/samediff_layer.py``
(the reference's ``nn/layers/samediff/SameDiffLayer.java`` and
``conf/layers/samediff/AbstractSameDiffLayer.java``).

A subclass declares its parameters (``defineParameters``) and its forward
pass on a SameDiff graph (``defineLayer``); the framework owns their
initialization, gradients, updater state and serialization.  The graph's
inputs (the layer input and every parameter) are placeholders; it is
staged once per (train, device, dtype) on the net's device into a function
of tensors, so autograd of the whole net differentiates through it.  Under
a BFLOAT16 net the input and parameters arrive in bf16 already; staging
casts only the graph's own float32 constants.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch

from deeplearning4j_tpu_torch import resolve_device
from deeplearning4j_tpu_torch.nn.conf.inputs import InputType
from deeplearning4j_tpu_torch.nn.conf.layers import BaseLayer, register_layer
from deeplearning4j_tpu_torch.nn.weights import init_weight

__all__ = ["SDLayerParams", "SameDiffLayer", "SameDiffLambdaLayer"]

_INPUT = "layerInput"


class SDLayerParams:
    """The parameter shapes a SameDiffLayer declares in
    ``defineParameters`` (reference: ``SDLayerParams.java``)."""

    def __init__(self):
        self.weightParams: Dict[str, Tuple[int, ...]] = {}
        self.biasParams: Dict[str, Tuple[int, ...]] = {}

    def addWeightParam(self, name: str, *shape: int) -> "SDLayerParams":
        self.weightParams[name] = tuple(int(s) for s in shape)
        return self

    def addBiasParam(self, name: str, *shape: int) -> "SDLayerParams":
        self.biasParams[name] = tuple(int(s) for s in shape)
        return self


def _stage(layer, key, define):
    """The layer's graph staged for ``key`` = (train, device, dtype):
    ``define(sd, layerInput)`` builds it; cached on the layer."""
    cache = layer.__dict__.setdefault("_staged_fns", {})
    if key not in cache:
        from deeplearning4j_tpu_torch.autodiff.samediff import SameDiff
        train, device, dtype = key
        sd = SameDiff(device)
        out = define(sd, sd.placeholder(_INPUT, dtype=dtype))
        fn = sd._build_fn((out.name(),), training=train,
                          compute_dtype=None if dtype == torch.float32
                          else dtype)
        cache[key] = (fn, out.name())
    return cache[key]


@dataclasses.dataclass
class SameDiffLayer(BaseLayer):
    """Subclass and implement:

    - ``defineParameters(params: SDLayerParams)`` — the weight and bias
      shapes (``self.nIn`` is set by shape inference first);
    - ``defineLayer(sd, layerInput, paramTable) -> SDVariable`` — the
      forward pass with the SameDiff op surface;
    - ``getOutputType(inputType)``;
    - optionally ``initializeParameters(params) -> params`` (weights take
      the layer's or the global ``weightInit``, biases ``biasInit``).

    Subclasses register with ``layer_from_json`` as they are defined, so a
    checkpoint restores once the subclass is imported (the reference's
    class-name mapping).
    """
    nIn: int = 0

    def __init_subclass__(cls, **kw):
        super().__init_subclass__(**kw)
        register_layer(cls)

    # -- the user's contract ----------------------------------------------
    def defineParameters(self, params: SDLayerParams) -> None:
        raise NotImplementedError

    def defineLayer(self, sd, layerInput, paramTable):
        raise NotImplementedError

    def initializeParameters(self, params: Dict) -> Dict:
        return params

    # -- the framework's side ---------------------------------------------
    def preferredFormat(self) -> Optional[str]:
        return "FF"

    def inferNIn(self, inputType) -> None:
        if not self.nIn and hasattr(inputType, "size"):
            self.nIn = inputType.size

    def getOutputType(self, inputType) -> InputType:
        raise NotImplementedError(
            f"{type(self).__name__}.getOutputType must be implemented")

    def _declared(self) -> SDLayerParams:
        ps = SDLayerParams()
        self.defineParameters(ps)
        return ps

    def initParams(self, gen, inputType, dtype=torch.float32, device=None):
        dev = resolve_device(device)
        ps = self._declared()
        out: Dict = {}
        for name, shape in ps.weightParams.items():
            fan_in = int(shape[0]) if shape else 1
            fan_out = int(shape[-1]) if shape else 1
            out[name] = init_weight(gen, shape, fan_in, fan_out,
                                    self.weightInit or "XAVIER", dtype, dev)
        for name, shape in ps.biasParams.items():
            out[name] = torch.full(shape, float(self.biasInit or 0.0),
                                   dtype=dtype, device=dev)
        return self.initializeParameters(out)

    def _define(self, sd, inp):
        ps = self._declared()
        table = {n: sd.placeholder(n)
                 for n in list(ps.weightParams) + list(ps.biasParams)}
        return self.defineLayer(sd, inp, table)

    def forward(self, params, x, train, gen, state):
        x = self._dropin(x, train, gen)
        fn, out = _stage(self, (bool(train), x.device, x.dtype),
                         self._define)
        return fn({_INPUT: x, **params}, {}, 0)[out], state


@dataclasses.dataclass
class SameDiffLambdaLayer(SameDiffLayer):
    """The parameter-free form (reference: ``SameDiffLambdaLayer.java``):
    implement ``defineLayer(sd, layerInput)`` (and ``getOutputType`` where
    the shape changes)."""

    def defineParameters(self, params: SDLayerParams) -> None:
        pass

    def initParams(self, gen, inputType, dtype=torch.float32, device=None):
        return {}

    def getOutputType(self, inputType) -> InputType:
        return inputType

    def forward(self, params, x, train, gen, state):
        fn, out = _stage(self, (bool(train), x.device, x.dtype),
                         self.defineLayer)
        return fn({_INPUT: x}, {}, 0)[out], state

    def defineLayer(self, sd, layerInput):  # noqa: D102 (the user's hook)
        raise NotImplementedError
