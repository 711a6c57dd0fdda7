"""Input types — shape inference through the layer stack; the port of
``deeplearning4j_tpu/nn/conf/inputs.py`` (the reference's
``conf/inputs/InputType.java``: FF / CNN / CNNFlat / RNN / CNN3D variants
that drive nIn inference and preprocessor insertion in the builders).

Data conventions follow DL4J: FF ``(batch, size)``; CNN ``(batch, channels,
height, width)`` (NCHW); RNN ``(batch, size, timeSteps)`` (NCW).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class InputType:
    kind: str                       # FF | CNN | CNNFlat | RNN | CNN3D
    size: int = 0                   # FF/RNN feature size
    height: int = 0
    width: int = 0
    channels: int = 0
    timeSeriesLength: int = -1      # RNN; -1 = variable
    depth: int = 0                  # CNN3D (NCDHW)

    # -- factories (DL4J names) -----------------------------------------
    @staticmethod
    def feedForward(size: int) -> "InputType":
        return InputType("FF", size=int(size))

    @staticmethod
    def convolutional(height: int, width: int, channels: int) -> "InputType":
        return InputType("CNN", height=int(height), width=int(width),
                         channels=int(channels))

    @staticmethod
    def convolutionalFlat(height: int, width: int, channels: int) -> "InputType":
        return InputType("CNNFlat", height=int(height), width=int(width),
                         channels=int(channels))

    @staticmethod
    def recurrent(size: int, timeSeriesLength: int = -1) -> "InputType":
        return InputType("RNN", size=int(size),
                         timeSeriesLength=int(timeSeriesLength))

    @staticmethod
    def convolutional3D(depth: int, height: int, width: int,
                        channels: int) -> "InputType":
        """NCDHW (reference: InputType.convolutional3D, Convolution3D.java
        default data format)."""
        return InputType("CNN3D", depth=int(depth), height=int(height),
                         width=int(width), channels=int(channels))

    # -- helpers ---------------------------------------------------------
    def arrayElementsPerExample(self) -> int:
        if self.kind == "FF":
            return self.size
        if self.kind in ("CNN", "CNNFlat"):
            return self.height * self.width * self.channels
        if self.kind == "CNN3D":
            return self.depth * self.height * self.width * self.channels
        if self.kind == "RNN":
            t = max(self.timeSeriesLength, 1)
            return self.size * t
        raise ValueError(self.kind)

    def getShape(self, batch: int = -1) -> Tuple[int, ...]:
        if self.kind == "FF":
            return (batch, self.size)
        if self.kind == "CNN":
            return (batch, self.channels, self.height, self.width)
        if self.kind == "CNNFlat":
            return (batch, self.channels * self.height * self.width)
        if self.kind == "RNN":
            return (batch, self.size, self.timeSeriesLength)
        if self.kind == "CNN3D":
            return (batch, self.channels, self.depth, self.height, self.width)
        raise ValueError(self.kind)

    def toJson(self) -> dict:
        return dataclasses.asdict(self)

    @staticmethod
    def fromJson(d: dict) -> "InputType":
        return InputType(**d)
