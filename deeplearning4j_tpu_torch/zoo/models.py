"""Zoo architectures — the port of ``deeplearning4j_tpu/zoo/models.py``
(the reference's ``zoo/model/{LeNet,ResNet50}.java``: architectures built
with the config DSL).  ``init`` builds the model on ``cuda`` unless the
caller passes another device.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

from deeplearning4j_tpu_torch.learning.config import Adam, Nesterovs
from deeplearning4j_tpu_torch.models.graph import ComputationGraph
from deeplearning4j_tpu_torch.models.graph_conf import ElementWiseVertex
from deeplearning4j_tpu_torch.models.multilayer import MultiLayerNetwork
from deeplearning4j_tpu_torch.nn.conf import InputType, NeuralNetConfiguration
from deeplearning4j_tpu_torch.nn.conf.layers import (ActivationLayer,
                                                     BatchNormalization,
                                                     ConvolutionLayer,
                                                     ConvolutionMode,
                                                     DenseLayer,
                                                     GlobalPoolingLayer,
                                                     OutputLayer,
                                                     SubsamplingLayer,
                                                     _Builder)

__all__ = ["ZooModel", "LeNet", "ResNet50"]


@dataclasses.dataclass
class ZooModel:
    numClasses: int = 1000
    seed: int = 123
    inputShape: Tuple[int, int, int] = (3, 224, 224)  # (c, h, w)
    dataType: str = "FLOAT"   # "BFLOAT16" = bf16 compute over f32 masters

    @classmethod
    def builder(cls, **kw):
        return _Builder(cls, **kw)

    def init(self, device=None):
        raise NotImplementedError

    def initPretrained(self, pretrainedType: str = "IMAGENET",
                       path: Optional[str] = None):
        raise NotImplementedError(
            "pretrained zoo weights are not ported yet (ROADMAP A9)")

    def metaData(self):
        return {"name": type(self).__name__, "inputShape": self.inputShape,
                "numClasses": self.numClasses}

    def _it(self) -> InputType:
        c, h, w = self.inputShape
        return InputType.convolutional(h, w, c)


@dataclasses.dataclass
class LeNet(ZooModel):
    """Reference: zoo/model/LeNet.java (MNIST shape default)."""
    numClasses: int = 10
    inputShape: Tuple[int, int, int] = (1, 28, 28)

    def init(self, device=None) -> MultiLayerNetwork:
        c, h, w = self.inputShape
        conf = (NeuralNetConfiguration.builder().seed(self.seed)
                .updater(Adam(1e-3)).weightInit("XAVIER")
                .list()
                .layer(ConvolutionLayer.builder().nIn(c).nOut(20)
                       .kernelSize(5, 5).stride(1, 1).activation("relu")
                       .build())
                .layer(SubsamplingLayer.builder().poolingType("MAX")
                       .kernelSize(2, 2).stride(2, 2).build())
                .layer(ConvolutionLayer.builder().nOut(50).kernelSize(5, 5)
                       .stride(1, 1).activation("relu").build())
                .layer(SubsamplingLayer.builder().poolingType("MAX")
                       .kernelSize(2, 2).stride(2, 2).build())
                .layer(DenseLayer.builder().nOut(500).activation("relu")
                       .build())
                .layer(OutputLayer.builder("negativeloglikelihood")
                       .nOut(self.numClasses).activation("softmax").build())
                .setInputType(InputType.convolutionalFlat(h, w, c)).build())
        return MultiLayerNetwork(conf, device=device).init()


@dataclasses.dataclass
class ResNet50(ZooModel):
    """Reference: zoo/model/ResNet50.java — a ComputationGraph of bottleneck
    residual blocks (ElementWiseVertex Add), stages [3, 4, 6, 3]."""

    def graphBuilder(self):
        gb = (NeuralNetConfiguration.builder().seed(self.seed)
              .updater(Nesterovs(1e-1, momentum=0.9)).weightInit("RELU")
              .dataType(self.dataType)
              .graphBuilder())
        gb.addInputs("input").setInputTypes(self._it())

        def conv_bn(name, inp, nOut, k, s, pad="same", act="relu"):
            conv = ConvolutionLayer.builder().nOut(nOut).kernelSize(k, k) \
                .stride(s, s).convolutionMode(ConvolutionMode.Same
                                              if pad == "same" else
                                              ConvolutionMode.Truncate) \
                .hasBias(False).build()
            gb.addLayer(name + "_conv", conv, inp)
            gb.addLayer(name + "_bn",
                        BatchNormalization.builder().activation(act).build(),
                        name + "_conv")
            return name + "_bn"

        def bottleneck(name, inp, nOut, stride, downsample):
            x = conv_bn(name + "_a", inp, nOut, 1, stride)
            x = conv_bn(name + "_b", x, nOut, 3, 1)
            x = conv_bn(name + "_c", x, nOut * 4, 1, 1, act="identity")
            if downsample:
                sc = conv_bn(name + "_sc", inp, nOut * 4, 1, stride,
                             act="identity")
            else:
                sc = inp
            gb.addVertex(name + "_add", ElementWiseVertex("Add"), x, sc)
            gb.addLayer(name + "_relu",
                        ActivationLayer.builder().activation("relu").build(),
                        name + "_add")
            return name + "_relu"

        x = conv_bn("stem", "input", 64, 7, 2)
        gb.addLayer("stem_pool",
                    SubsamplingLayer.builder().poolingType("MAX")
                    .kernelSize(3, 3).stride(2, 2)
                    .convolutionMode(ConvolutionMode.Same).build(), x)
        x = "stem_pool"
        stages = [(64, 3, 1), (128, 4, 2), (256, 6, 2), (512, 3, 2)]
        for si, (nOut, reps, stride) in enumerate(stages):
            for r in range(reps):
                x = bottleneck(f"res{si}_{r}", x, nOut,
                               stride if r == 0 else 1, r == 0)
        gb.addLayer("avgpool",
                    GlobalPoolingLayer.builder().poolingType("AVG").build(), x)
        gb.addLayer("fc",
                    OutputLayer.builder("negativeloglikelihood")
                    .nOut(self.numClasses).activation("softmax").build(),
                    "avgpool")
        gb.setOutputs("fc")
        return gb

    def init(self, device=None) -> ComputationGraph:
        return ComputationGraph(self.graphBuilder().build(),
                                device=device).init()
