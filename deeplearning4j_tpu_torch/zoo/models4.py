"""Zoo architectures, part 4 — the port of ``deeplearning4j_tpu/zoo/
models4.py`` (the reference's ``zoo/model/{TextGenerationLSTM,
FaceNetNN4Small2,YOLO2}.java``).

YOLO2 is the full Darknet-19 detector: the backbone to 13x13, a 26x26
passthrough route reorganised by ``SpaceToDepthLayer(2)`` and concatenated
before the last 3x3, a 1x1 to B·(5 + C) channels and ``Yolo2OutputLayer``
with the reference's five COCO priors.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np

from deeplearning4j_tpu_torch.learning.config import Adam, RmsProp
from deeplearning4j_tpu_torch.models.graph_conf import (L2NormalizeVertex,
                                                        MergeVertex)
from deeplearning4j_tpu_torch.models.multilayer import MultiLayerNetwork
from deeplearning4j_tpu_torch.nn.conf import InputType, NeuralNetConfiguration
from deeplearning4j_tpu_torch.nn.conf.convolutional import (
    SpaceToDepthLayer, Yolo2OutputLayer)
from deeplearning4j_tpu_torch.nn.conf.layers import (BatchNormalization,
                                                     ConvolutionLayer,
                                                     ConvolutionMode,
                                                     DenseLayer,
                                                     GlobalPoolingLayer,
                                                     SubsamplingLayer)
from deeplearning4j_tpu_torch.nn.conf.recurrent import (GravesLSTM,
                                                        RnnOutputLayer)
from deeplearning4j_tpu_torch.zoo.models import ZooModel, _GraphZooModel

__all__ = ["TextGenerationLSTM", "FaceNetNN4Small2", "YOLO2"]


@dataclasses.dataclass
class TextGenerationLSTM(ZooModel):
    """Reference: zoo/model/TextGenerationLSTM.java — the char-level
    generator: two GravesLSTM(256) over one-hot characters, a per-timestep
    mcxent head, truncated BPTT 50."""
    numClasses: int = 77                 # totalUniqueCharacters default
    hiddenSize: int = 256
    tbpttLength: int = 50

    def init(self, device=None) -> MultiLayerNetwork:
        n = self.numClasses
        b = (NeuralNetConfiguration.builder().seed(self.seed)
             .updater(RmsProp(1e-3)).list()
             .layer(GravesLSTM.builder().nIn(n).nOut(self.hiddenSize)
                    .activation("tanh").build())
             .layer(GravesLSTM.builder().nOut(self.hiddenSize)
                    .activation("tanh").build())
             .layer(RnnOutputLayer.builder("mcxent").nOut(n)
                    .activation("softmax").build())
             .backpropType("TruncatedBPTT")
             .tBPTTLength(self.tbpttLength)
             .setInputType(InputType.recurrent(n)))
        return MultiLayerNetwork(b.build(), device=device).init()


@dataclasses.dataclass
class FaceNetNN4Small2(_GraphZooModel):
    """Reference: zoo/model/FaceNetNN4Small2.java (with FaceNetHelper's
    inception modules) — OpenFace's nn4.small2: stem, inception 3a/3b/3c,
    4a/4e, 5a/5b, average pool and an L2-normalised 128-d embedding."""
    numClasses: int = 128                # embeddingSize
    inputShape: Tuple[int, int, int] = (3, 96, 96)

    def graphBuilder(self):
        gb = (NeuralNetConfiguration.builder().seed(self.seed)
              .updater(Adam(1e-3)).weightInit("RELU")
              .convolutionMode(ConvolutionMode.Same).graphBuilder())
        gb.addInputs("input").setInputTypes(self._it())

        def conv_bn(name, inp, n, k, s=1):
            gb.addLayer(name, ConvolutionLayer.builder().nOut(n)
                        .kernelSize(k, k).stride(s, s).hasBias(False)
                        .build(), inp)
            gb.addLayer(name + "_bn", BatchNormalization.builder()
                        .activation("relu").build(), name)
            return name + "_bn"

        def inception(name, inp, n1, r3, n3, r5, n5, npool, pool="MAX",
                      stride=1):
            """3x3 and 5x5 reduce-expand branches, a pool projection, an
            optional 1x1 (n1 = 0 skips it, as 3c and 4e)."""
            branches = []
            if n1:
                branches.append(conv_bn(name + "_1x1", inp, n1, 1, stride))
            b3 = conv_bn(name + "_3x3r", inp, r3, 1)
            branches.append(conv_bn(name + "_3x3", b3, n3, 3, stride))
            if r5:
                b5 = conv_bn(name + "_5x5r", inp, r5, 1)
                branches.append(conv_bn(name + "_5x5", b5, n5, 5, stride))
            gb.addLayer(name + "_pool", SubsamplingLayer.builder()
                        .poolingType(pool).kernelSize(3, 3)
                        .stride(stride, stride).build(), inp)
            if npool:
                branches.append(conv_bn(name + "_poolp", name + "_pool",
                                        npool, 1))
            else:
                branches.append(name + "_pool")
            gb.addVertex(name, MergeVertex(), *branches)
            return name

        def pool(name, inp):
            gb.addLayer(name, SubsamplingLayer.builder()
                        .poolingType("MAX").kernelSize(3, 3).stride(2, 2)
                        .build(), inp)
            return name

        x = pool("stem_pool", conv_bn("stem1", "input", 64, 7, 2))
        x = conv_bn("stem2", conv_bn("stem2r", x, 64, 1), 192, 3)
        x = pool("stem_pool2", x)
        x = inception("3a", x, 64, 96, 128, 16, 32, 32)
        x = inception("3b", x, 64, 96, 128, 32, 64, 64, pool="AVG")
        x = inception("3c", x, 0, 128, 256, 32, 64, 0, stride=2)
        x = inception("4a", x, 256, 96, 192, 32, 64, 128, pool="AVG")
        x = inception("4e", x, 0, 160, 256, 64, 128, 0, stride=2)
        x = inception("5a", x, 256, 96, 384, 0, 0, 96, pool="AVG")
        x = inception("5b", x, 256, 96, 384, 0, 0, 96)
        gb.addLayer("avgpool", GlobalPoolingLayer.builder()
                    .poolingType("AVG").build(), x)
        gb.addLayer("bottleneck", DenseLayer.builder()
                    .nOut(self.numClasses).activation("identity").build(),
                    "avgpool")
        gb.addVertex("embeddings", L2NormalizeVertex(), "bottleneck")
        gb.setOutputs("embeddings")
        return gb


@dataclasses.dataclass
class YOLO2(_GraphZooModel):
    """Reference: zoo/model/YOLO2.java — the Darknet-19 detector with the
    reorganised 26x26 passthrough and five anchor boxes (the reference's
    COCO priors)."""
    numClasses: int = 80
    inputShape: Tuple[int, int, int] = (3, 416, 416)
    boundingBoxes: Tuple = ((0.57273, 0.677385), (1.87446, 2.06253),
                            (3.33843, 5.47434), (7.88282, 3.52778),
                            (9.77052, 9.16828))

    def graphBuilder(self):
        nB = len(self.boundingBoxes)
        gb = (NeuralNetConfiguration.builder().seed(self.seed)
              .updater(Adam(1e-3)).weightInit("RELU")
              .convolutionMode(ConvolutionMode.Same).graphBuilder())
        gb.addInputs("input").setInputTypes(self._it())

        def conv_bn(name, inp, n, k):
            gb.addLayer(name, ConvolutionLayer.builder().nOut(n)
                        .kernelSize(k, k).hasBias(False).build(), inp)
            gb.addLayer(name + "_bn", BatchNormalization.builder()
                        .activation("leakyrelu").build(), name)
            return name + "_bn"

        def pool(name, inp):
            gb.addLayer(name, SubsamplingLayer.builder().poolingType("MAX")
                        .kernelSize(2, 2).stride(2, 2).build(), inp)
            return name

        x = pool("p1", conv_bn("c1", "input", 32, 3))          # 208
        x = pool("p2", conv_bn("c2", x, 64, 3))                # 104
        x = conv_bn("c3", x, 128, 3)
        x = conv_bn("c4", x, 64, 1)
        x = pool("p3", conv_bn("c5", x, 128, 3))               # 52
        x = conv_bn("c6", x, 256, 3)
        x = conv_bn("c7", x, 128, 1)
        x = pool("p4", conv_bn("c8", x, 256, 3))               # 26
        for i, (n, k) in enumerate([(512, 3), (256, 1), (512, 3), (256, 1)]):
            x = conv_bn(f"c{9 + i}", x, n, k)
        route = conv_bn("c13", x, 512, 3)                      # 26x26x512
        x = pool("p5", route)                                  # 13
        for i, (n, k) in enumerate([(1024, 3), (512, 1), (1024, 3),
                                    (512, 1), (1024, 3), (1024, 3),
                                    (1024, 3)]):
            x = conv_bn(f"c{14 + i}", x, n, k)
        # passthrough: 26x26x64 -> space-to-depth(2) -> 13x13x256
        r = conv_bn("route_r", route, 64, 1)
        gb.addLayer("reorg", SpaceToDepthLayer.builder().blockSize(2)
                    .build(), r)
        gb.addVertex("concat", MergeVertex(), "reorg", x)
        x = conv_bn("c21", "concat", 1024, 3)
        gb.addLayer("pred", ConvolutionLayer.builder()
                    .nOut(nB * (5 + self.numClasses)).kernelSize(1, 1)
                    .build(), x)
        gb.addLayer("yolo", Yolo2OutputLayer.builder()
                    .boundingBoxes(np.asarray(self.boundingBoxes)).build(),
                    "pred")
        gb.setOutputs("yolo")
        return gb
