"""Zoo architectures, part 2 — the port of ``deeplearning4j_tpu/zoo/
models2.py`` (the reference's ``zoo/model/{VGG19,SqueezeNet,Darknet19,
TinyYOLO,UNet,Xception,InceptionResNetV1}.java``, and ``C3D``, the
reference's 3-D convolution classifier).  Each configuration is the
reference's, layer for layer, so its JSON is the reference's byte for byte;
``init`` builds it on ``cuda`` unless the caller passes another device.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np

from deeplearning4j_tpu_torch.learning.config import Adam, Nesterovs
from deeplearning4j_tpu_torch.models.graph_conf import (ElementWiseVertex,
                                                        MergeVertex)
from deeplearning4j_tpu_torch.models.multilayer import MultiLayerNetwork
from deeplearning4j_tpu_torch.nn.conf import InputType, NeuralNetConfiguration
from deeplearning4j_tpu_torch.nn.conf.convolutional import (
    CnnLossLayer, SeparableConvolution2D, Upsampling2D, Yolo2OutputLayer)
from deeplearning4j_tpu_torch.nn.conf.convolutional3d import (
    Convolution3D, Subsampling3DLayer)
from deeplearning4j_tpu_torch.nn.conf.layers import (ActivationLayer,
                                                     BatchNormalization,
                                                     ConvolutionLayer,
                                                     ConvolutionMode,
                                                     DenseLayer,
                                                     DropoutLayer,
                                                     GlobalPoolingLayer,
                                                     OutputLayer,
                                                     SubsamplingLayer)
from deeplearning4j_tpu_torch.zoo.models import (ZooModel, _GraphZooModel,
                                                  _vgg)

__all__ = ["VGG19", "SqueezeNet", "Darknet19", "TinyYOLO", "UNet",
           "Xception", "InceptionResNetV1", "C3D"]


@dataclasses.dataclass
class VGG19(ZooModel):
    """Reference: zoo/model/VGG19.java — VGG16 with [2,2,4,4,4] conv reps."""

    def init(self, device=None) -> MultiLayerNetwork:
        return _vgg(self, (2, 2, 4, 4, 4), device)


@dataclasses.dataclass
class SqueezeNet(_GraphZooModel):
    """Reference: zoo/model/SqueezeNet.java — fire modules: a 1x1 squeeze,
    then concatenated 1x1 / 3x3 expands (MergeVertex)."""

    def graphBuilder(self):
        gb = (NeuralNetConfiguration.builder().seed(self.seed)
              .updater(Adam(1e-3)).weightInit("RELU")
              .convolutionMode(ConvolutionMode.Same).graphBuilder())
        gb.addInputs("input").setInputTypes(self._it())

        def conv(name, inp, nOut, k, s=1, act="relu"):
            gb.addLayer(name, ConvolutionLayer.builder().nOut(nOut)
                        .kernelSize(k, k).stride(s, s).activation(act)
                        .build(), inp)
            return name

        def fire(name, inp, squeeze, expand):
            s = conv(name + "_sq", inp, squeeze, 1)
            e1 = conv(name + "_e1", s, expand, 1)
            e3 = conv(name + "_e3", s, expand, 3)
            gb.addVertex(name, MergeVertex(), e1, e3)
            return name

        def pool(name, inp):
            gb.addLayer(name, SubsamplingLayer.builder().poolingType("MAX")
                        .kernelSize(3, 3).stride(2, 2).build(), inp)
            return name

        x = pool("pool1", conv("conv1", "input", 64, 3, 2))
        x = fire("fire3", fire("fire2", x, 16, 64), 16, 64)
        x = pool("pool3", x)
        x = fire("fire5", fire("fire4", x, 32, 128), 32, 128)
        x = pool("pool5", x)
        x = fire("fire6", x, 48, 192)
        x = fire("fire7", x, 48, 192)
        x = fire("fire8", x, 64, 256)
        x = fire("fire9", x, 64, 256)
        x = conv("conv10", x, self.numClasses, 1)
        gb.addLayer("avgpool", GlobalPoolingLayer.builder()
                    .poolingType("AVG").build(), x)
        gb.addLayer("out", OutputLayer.builder("negativeloglikelihood")
                    .nIn(self.numClasses).nOut(self.numClasses)
                    .activation("softmax").build(), "avgpool")
        gb.setOutputs("out")
        return gb


def _darknet_backbone(b, filters):
    """conv-bn-leakyrelu stacks with interleaved max pools (the Darknet-19
    layout); ``filters`` is a list of (nOut, kernel) per block, None for a
    pool."""
    for item in filters:
        if item is None:
            b.layer(SubsamplingLayer.builder().poolingType("MAX")
                    .kernelSize(2, 2).stride(2, 2).build())
        else:
            nOut, k = item
            b.layer(ConvolutionLayer.builder().nOut(nOut).kernelSize(k, k)
                    .hasBias(False).build())
            b.layer(BatchNormalization.builder().activation("leakyrelu")
                    .build())
    return b


_DARKNET19 = [(32, 3), None, (64, 3), None, (128, 3), (64, 1), (128, 3),
              None, (256, 3), (128, 1), (256, 3), None, (512, 3), (256, 1),
              (512, 3), (256, 1), (512, 3), None, (1024, 3), (512, 1),
              (1024, 3), (512, 1), (1024, 3)]


@dataclasses.dataclass
class Darknet19(ZooModel):
    """Reference: zoo/model/Darknet19.java."""

    def init(self, device=None) -> MultiLayerNetwork:
        b = (NeuralNetConfiguration.builder().seed(self.seed)
             .updater(Nesterovs(1e-3, momentum=0.9)).weightInit("RELU")
             .convolutionMode(ConvolutionMode.Same).list())
        _darknet_backbone(b, _DARKNET19)
        b.layer(ConvolutionLayer.builder().nOut(self.numClasses)
                .kernelSize(1, 1).build())
        b.layer(GlobalPoolingLayer.builder().poolingType("AVG").build())
        b.layer(OutputLayer.builder("negativeloglikelihood")
                .nIn(self.numClasses).nOut(self.numClasses)
                .activation("softmax").build())
        return MultiLayerNetwork(b.setInputType(self._it()).build(),
                                 device=device).init()


@dataclasses.dataclass
class TinyYOLO(ZooModel):
    """Reference: zoo/model/TinyYOLO.java — a 9-conv darknet backbone and a
    Yolo2OutputLayer with 5 anchor boxes (VOC shape defaults)."""
    numClasses: int = 20
    inputShape: Tuple[int, int, int] = (3, 416, 416)
    # anchors (h, w) in grid units — the reference's default priors
    boundingBoxes: Tuple = ((1.08, 1.19), (3.42, 4.41), (6.63, 11.38),
                            (9.42, 5.11), (16.62, 10.52))

    def init(self, device=None) -> MultiLayerNetwork:
        nB = len(self.boundingBoxes)
        b = (NeuralNetConfiguration.builder().seed(self.seed)
             .updater(Adam(1e-3)).weightInit("RELU")
             .convolutionMode(ConvolutionMode.Same).list())
        _darknet_backbone(b, [(16, 3), None, (32, 3), None, (64, 3), None,
                              (128, 3), None, (256, 3), None, (512, 3),
                              (1024, 3), (1024, 3)])
        b.layer(ConvolutionLayer.builder().nOut(nB * (5 + self.numClasses))
                .kernelSize(1, 1).build())
        b.layer(Yolo2OutputLayer.builder()
                .boundingBoxes(np.asarray(self.boundingBoxes)).build())
        return MultiLayerNetwork(b.setInputType(self._it()).build(),
                                 device=device).init()


@dataclasses.dataclass
class UNet(_GraphZooModel):
    """Reference: zoo/model/UNet.java — encoder/decoder with skip-concat
    merges and a per-pixel sigmoid head (CnnLossLayer xent)."""
    numClasses: int = 1
    inputShape: Tuple[int, int, int] = (3, 128, 128)

    def graphBuilder(self):
        gb = (NeuralNetConfiguration.builder().seed(self.seed)
              .updater(Adam(1e-3)).weightInit("RELU")
              .convolutionMode(ConvolutionMode.Same).graphBuilder())
        gb.addInputs("input").setInputTypes(self._it())

        def conv2(name, inp, n):
            gb.addLayer(name + "_1", ConvolutionLayer.builder().nOut(n)
                        .kernelSize(3, 3).activation("relu").build(), inp)
            gb.addLayer(name + "_2", ConvolutionLayer.builder().nOut(n)
                        .kernelSize(3, 3).activation("relu").build(),
                        name + "_1")
            return name + "_2"

        skips = []
        x = "input"
        widths = (32, 64, 128, 256)
        for i, n in enumerate(widths):
            x = conv2(f"down{i}", x, n)
            skips.append(x)
            gb.addLayer(f"pool{i}", SubsamplingLayer.builder()
                        .poolingType("MAX").kernelSize(2, 2).stride(2, 2)
                        .build(), x)
            x = f"pool{i}"
        x = conv2("bottom", x, 512)
        for i, n in reversed(list(enumerate(widths))):
            gb.addLayer(f"up{i}_us", Upsampling2D.builder().size(2).build(),
                        x)
            gb.addLayer(f"up{i}_c", ConvolutionLayer.builder().nOut(n)
                        .kernelSize(2, 2).activation("relu").build(),
                        f"up{i}_us")
            gb.addVertex(f"up{i}_m", MergeVertex(), skips[i], f"up{i}_c")
            x = conv2(f"up{i}", f"up{i}_m", n)
        gb.addLayer("head", ConvolutionLayer.builder().nOut(self.numClasses)
                    .kernelSize(1, 1).activation("identity").build(), x)
        gb.addLayer("out", CnnLossLayer.builder("xent")
                    .activation("sigmoid").build(), "head")
        gb.setOutputs("out")
        return gb


def _conv_bn(gb, name, inp, n, k, s=1, act="relu"):
    """A bias-free conv (``k`` an int or an (h, w) pair) and a
    BatchNormalization carrying ``act``."""
    gb.addLayer(name, ConvolutionLayer.builder().nOut(n)
                .kernelSize(k if isinstance(k, tuple) else (k, k))
                .stride(s, s).hasBias(False).build(), inp)
    gb.addLayer(name + "_bn", BatchNormalization.builder().activation(act)
                .build(), name)
    return name + "_bn"


@dataclasses.dataclass
class Xception(_GraphZooModel):
    """Reference: zoo/model/Xception.java — separable-conv towers with
    residual 1x1-conv shortcuts (entry, middle (8 blocks) and exit
    flows)."""

    def graphBuilder(self):
        gb = (NeuralNetConfiguration.builder().seed(self.seed)
              .updater(Adam(1e-3)).weightInit("RELU")
              .convolutionMode(ConvolutionMode.Same).graphBuilder())
        gb.addInputs("input").setInputTypes(self._it())

        def sep_bn(name, inp, n, act="relu"):
            gb.addLayer(name, SeparableConvolution2D.builder().nOut(n)
                        .kernelSize(3, 3).hasBias(False).build(), inp)
            gb.addLayer(name + "_bn", BatchNormalization.builder()
                        .activation(act).build(), name)
            return name + "_bn"

        def entry_block(name, inp, n, first_relu=True):
            sc = _conv_bn(gb, name + "_sc", inp, n, 1, 2, act="identity")
            x = sep_bn(name + "_s1", inp, n,
                       act="relu" if first_relu else "identity")
            x = sep_bn(name + "_s2", x, n, act="identity")
            gb.addLayer(name + "_pool", SubsamplingLayer.builder()
                        .poolingType("MAX").kernelSize(3, 3).stride(2, 2)
                        .build(), x)
            gb.addVertex(name, ElementWiseVertex("Add"), name + "_pool", sc)
            return name

        x = _conv_bn(gb, "stem1", "input", 32, 3, 2)
        x = _conv_bn(gb, "stem2", x, 64, 3)
        x = entry_block("entry1", x, 128, first_relu=False)
        x = entry_block("entry2", x, 256)
        x = entry_block("entry3", x, 728)
        for i in range(8):          # middle flow
            inp = x
            y = sep_bn(f"mid{i}_1", inp, 728)
            y = sep_bn(f"mid{i}_2", y, 728)
            y = sep_bn(f"mid{i}_3", y, 728, act="identity")
            gb.addVertex(f"mid{i}", ElementWiseVertex("Add"), y, inp)
            x = f"mid{i}"
        sc = _conv_bn(gb, "exit_sc", x, 1024, 1, 2, act="identity")
        y = sep_bn("exit_s1", x, 728)
        y = sep_bn("exit_s2", y, 1024, act="identity")
        gb.addLayer("exit_pool", SubsamplingLayer.builder().poolingType("MAX")
                    .kernelSize(3, 3).stride(2, 2).build(), y)
        gb.addVertex("exit_add", ElementWiseVertex("Add"), "exit_pool", sc)
        x = sep_bn("exit_s3", "exit_add", 1536)
        x = sep_bn("exit_s4", x, 2048)
        gb.addLayer("avgpool", GlobalPoolingLayer.builder()
                    .poolingType("AVG").build(), x)
        gb.addLayer("out", OutputLayer.builder("negativeloglikelihood")
                    .nOut(self.numClasses).activation("softmax").build(),
                    "avgpool")
        gb.setOutputs("out")
        return gb


@dataclasses.dataclass
class InceptionResNetV1(_GraphZooModel):
    """Reference: zoo/model/InceptionResNetV1.java (FaceNet's backbone) —
    a stem and scaled-residual inception blocks with reduction blocks;
    block counts (5, 10, 5) as in the reference."""
    numClasses: int = 128            # the reference's embedding head

    def graphBuilder(self):
        gb = (NeuralNetConfiguration.builder().seed(self.seed)
              .updater(Adam(1e-3)).weightInit("RELU")
              .convolutionMode(ConvolutionMode.Same).graphBuilder())
        gb.addInputs("input").setInputTypes(self._it())

        def conv_bn(name, inp, n, k, s=1, act="relu"):
            return _conv_bn(gb, name, inp, n, k, s, act)

        def block_a(name, inp, width):
            b0 = conv_bn(name + "_b0", inp, 32, 1)
            b1 = conv_bn(name + "_b1b", conv_bn(name + "_b1a", inp, 32, 1),
                         32, 3)
            b2 = conv_bn(name + "_b2c",
                         conv_bn(name + "_b2b",
                                 conv_bn(name + "_b2a", inp, 32, 1), 32, 3),
                         32, 3)
            gb.addVertex(name + "_cat", MergeVertex(), b0, b1, b2)
            up = conv_bn(name + "_up", name + "_cat", width, 1,
                         act="identity")
            gb.addVertex(name, ElementWiseVertex("Add"), inp, up)
            gb.addLayer(name + "_relu", ActivationLayer.builder()
                        .activation("relu").build(), name)
            return name + "_relu"

        def reduction(name, inp, n):
            gb.addLayer(name + "_pool", SubsamplingLayer.builder()
                        .poolingType("MAX").kernelSize(3, 3).stride(2, 2)
                        .build(), inp)
            c = conv_bn(name + "_c", inp, n, 3, 2)
            gb.addVertex(name, MergeVertex(), name + "_pool", c)
            return name

        x = conv_bn("stem1", "input", 32, 3, 2)
        x = conv_bn("stem2", x, 64, 3)
        gb.addLayer("stem_pool", SubsamplingLayer.builder().poolingType("MAX")
                    .kernelSize(3, 3).stride(2, 2).build(), x)
        x = conv_bn("stem3", "stem_pool", 128, 1)
        width = 128
        for i in range(5):
            x = block_a(f"a{i}", x, width)
        x = reduction("redA", x, 128)
        width += 128
        for i in range(10):
            x = block_a(f"b{i}", x, width)
        x = reduction("redB", x, 128)
        width += 128
        for i in range(5):
            x = block_a(f"c{i}", x, width)
        gb.addLayer("avgpool", GlobalPoolingLayer.builder()
                    .poolingType("AVG").build(), x)
        gb.addLayer("drop", DropoutLayer.builder().dropOut(0.8).build(),
                    "avgpool")
        gb.addLayer("out", OutputLayer.builder("negativeloglikelihood")
                    .nOut(self.numClasses).activation("softmax").build(),
                    "drop")
        gb.setOutputs("out")
        return gb


@dataclasses.dataclass
class C3D(ZooModel):
    """A C3D-style 3-D convolutional video/volume classifier (the
    reference's own: its zoo has no 3-D model).  Input NCDHW."""
    numClasses: int = 10
    inputShape3d: Tuple[int, int, int, int] = (3, 8, 32, 32)  # (c, d, h, w)

    def init(self, device=None) -> MultiLayerNetwork:
        c, d, h, w = self.inputShape3d
        conf = (NeuralNetConfiguration.builder().seed(self.seed)
                .updater(Adam(1e-3)).weightInit("RELU")
                .dataType(self.dataType)
                .list()
                .layer(Convolution3D.builder().nIn(c).nOut(16)
                       .kernelSize(3, 3, 3).convolutionMode("Same")
                       .activation("relu").build())
                .layer(Subsampling3DLayer.builder().kernelSize(1, 2, 2)
                       .stride(1, 2, 2).build())
                .layer(Convolution3D.builder().nOut(32).kernelSize(3, 3, 3)
                       .convolutionMode("Same").activation("relu").build())
                .layer(Subsampling3DLayer.builder().kernelSize(2, 2, 2)
                       .stride(2, 2, 2).build())
                .layer(DenseLayer.builder().nOut(128).activation("relu")
                       .build())
                .layer(OutputLayer.builder("mcxent").nOut(self.numClasses)
                       .activation("softmax").build())
                .setInputType(InputType.convolutional3D(d, h, w, c)).build())
        return MultiLayerNetwork(conf, device=device).init()
