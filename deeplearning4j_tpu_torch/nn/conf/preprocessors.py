"""Input pre-processors between layers of different activation formats —
the port of ``deeplearning4j_tpu/nn/conf/preprocessors.py`` (the
reference's ``conf/preprocessor/*PreProcessor.java``).

Each is a reshape (and for RNN formats a transpose) of the activations;
autograd carries the gradient back through it.  CnnToFeedForward flattens
NCHW row-major (c, h, w), as DL4J does.
"""
from __future__ import annotations

import dataclasses

from deeplearning4j_tpu_torch.nn.conf.inputs import InputType


@dataclasses.dataclass
class InputPreProcessor:
    def preProcess(self, x, miniBatch: int = -1):
        raise NotImplementedError

    def getOutputType(self, inputType: InputType) -> InputType:
        raise NotImplementedError

    def toJson(self) -> dict:
        d = dataclasses.asdict(self)
        d["@class"] = type(self).__name__
        return d

    @staticmethod
    def fromJson(d: dict) -> "InputPreProcessor":
        d = dict(d)
        return _REGISTRY[d.pop("@class")](**d)


@dataclasses.dataclass
class FeedForwardToCnnPreProcessor(InputPreProcessor):
    inputHeight: int
    inputWidth: int
    numChannels: int

    def preProcess(self, x, miniBatch: int = -1):
        if x.dim() == 4:
            return x
        return x.reshape(x.shape[0], self.numChannels, self.inputHeight,
                         self.inputWidth)

    def getOutputType(self, inputType: InputType) -> InputType:
        return InputType.convolutional(self.inputHeight, self.inputWidth,
                                       self.numChannels)


@dataclasses.dataclass
class CnnToFeedForwardPreProcessor(InputPreProcessor):
    inputHeight: int
    inputWidth: int
    numChannels: int

    def preProcess(self, x, miniBatch: int = -1):
        return x.reshape(x.shape[0], -1)

    def getOutputType(self, inputType: InputType) -> InputType:
        return InputType.feedForward(self.inputHeight * self.inputWidth *
                                     self.numChannels)


@dataclasses.dataclass
class FeedForwardToRnnPreProcessor(InputPreProcessor):
    """(b*t, n) -> (b, n, t); used when a dense layer feeds an RNN layer."""

    def preProcess(self, x, miniBatch: int = -1):
        if miniBatch <= 0:
            raise ValueError("FeedForwardToRnn requires known miniBatch")
        bt, n = x.shape
        return x.reshape(miniBatch, bt // miniBatch, n).permute(0, 2, 1)

    def getOutputType(self, inputType: InputType) -> InputType:
        return InputType.recurrent(inputType.size)


@dataclasses.dataclass
class RnnToFeedForwardPreProcessor(InputPreProcessor):
    """(b, n, t) -> (b*t, n)."""

    def preProcess(self, x, miniBatch: int = -1):
        b, n, t = x.shape
        return x.permute(0, 2, 1).reshape(b * t, n)

    def getOutputType(self, inputType: InputType) -> InputType:
        return InputType.feedForward(inputType.size)


@dataclasses.dataclass
class CnnToRnnPreProcessor(InputPreProcessor):
    inputHeight: int
    inputWidth: int
    numChannels: int

    def preProcess(self, x, miniBatch: int = -1):
        # (b*t, c, h, w) -> (b, c*h*w, t)
        if miniBatch <= 0:
            raise ValueError("CnnToRnn requires known miniBatch")
        bt = x.shape[0]
        flat = x.reshape(bt, -1)
        return flat.reshape(miniBatch, bt // miniBatch,
                            flat.shape[1]).permute(0, 2, 1)

    def getOutputType(self, inputType: InputType) -> InputType:
        return InputType.recurrent(self.inputHeight * self.inputWidth *
                                   self.numChannels)


@dataclasses.dataclass
class RnnToCnnPreProcessor(InputPreProcessor):
    inputHeight: int
    inputWidth: int
    numChannels: int

    def preProcess(self, x, miniBatch: int = -1):
        b, n, t = x.shape
        return x.permute(0, 2, 1).reshape(b * t, self.numChannels,
                                          self.inputHeight, self.inputWidth)

    def getOutputType(self, inputType: InputType) -> InputType:
        return InputType.convolutional(self.inputHeight, self.inputWidth,
                                       self.numChannels)


@dataclasses.dataclass
class Cnn3DToFeedForwardPreProcessor(InputPreProcessor):
    """NCDHW (b, c, d, h, w) -> (b, c*d*h*w)."""
    inputDepth: int
    inputHeight: int
    inputWidth: int
    numChannels: int

    def preProcess(self, x, miniBatch: int = -1):
        return x.reshape(x.shape[0], -1)

    def getOutputType(self, inputType: InputType) -> InputType:
        return InputType.feedForward(self.inputDepth * self.inputHeight
                                     * self.inputWidth * self.numChannels)


_REGISTRY = {c.__name__: c for c in [
    FeedForwardToCnnPreProcessor, CnnToFeedForwardPreProcessor,
    FeedForwardToRnnPreProcessor, RnnToFeedForwardPreProcessor,
    CnnToRnnPreProcessor, RnnToCnnPreProcessor,
    Cnn3DToFeedForwardPreProcessor]}
