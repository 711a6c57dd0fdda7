"""Zoo architectures, part 3 — the port of ``deeplearning4j_tpu/zoo/
models3.py``: ``NASNet`` (the reference's ``zoo/model/NASNet.java`` with
``helper/NASNetHelper``'s normal and reduction cells) and ``SRGAN``
(``zoo/model/SRGAN.java``: the generator and its discriminator), whose
sub-pixel upsampling is ``PixelShuffleLayer``, a ``SameDiffLambdaLayer``
over the ``depthToSpace`` op (TF's DCR channel order, not
``F.pixel_shuffle``'s CRD).
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

from deeplearning4j_tpu_torch.learning.config import Adam
from deeplearning4j_tpu_torch.models.graph import ComputationGraph
from deeplearning4j_tpu_torch.models.graph_conf import (ElementWiseVertex,
                                                        MergeVertex)
from deeplearning4j_tpu_torch.models.multilayer import MultiLayerNetwork
from deeplearning4j_tpu_torch.nn.conf import (InputType,
                                              NeuralNetConfiguration,
                                              SameDiffLambdaLayer)
from deeplearning4j_tpu_torch.nn.conf.convolutional import (
    CnnLossLayer, SeparableConvolution2D)
from deeplearning4j_tpu_torch.nn.conf.convolutional3d import PReLULayer
from deeplearning4j_tpu_torch.nn.conf.layers import (ActivationLayer,
                                                     BatchNormalization,
                                                     ConvolutionLayer,
                                                     ConvolutionMode,
                                                     DenseLayer,
                                                     GlobalPoolingLayer,
                                                     OutputLayer,
                                                     SubsamplingLayer)
from deeplearning4j_tpu_torch.zoo.models import _GraphZooModel

__all__ = ["NASNet", "SRGAN", "PixelShuffleLayer"]


@dataclasses.dataclass
class NASNet(_GraphZooModel):
    """NASNet-A mobile-style cell stack (reference: zoo/model/NASNet.java,
    helper/NASNetHelper.normalA/reductionA): ``numBlocks`` normal cells per
    stage around two reduction cells, sized by ``penultimateFilters``."""
    numBlocks: int = 2
    stemFilters: int = 32
    penultimateFilters: int = 528    # mobile preset: 1056

    def graphBuilder(self):
        gb = (NeuralNetConfiguration.builder().seed(self.seed)
              .updater(Adam(1e-3)).weightInit("RELU")
              .convolutionMode(ConvolutionMode.Same).graphBuilder())
        gb.addInputs("input").setInputTypes(self._it())
        filters = self.penultimateFilters // 24

        def conv_bn(name, inp, n, k=1, s=1, act="relu"):
            gb.addLayer(name, ConvolutionLayer.builder().nOut(n)
                        .kernelSize(k, k).stride(s, s).hasBias(False)
                        .build(), inp)
            gb.addLayer(name + "_bn", BatchNormalization.builder()
                        .activation(act).build(), name)
            return name + "_bn"

        def sep(name, inp, n, k=3, s=1):
            gb.addLayer(name, SeparableConvolution2D.builder().nOut(n)
                        .kernelSize(k, k).stride(s, s).hasBias(False)
                        .build(), inp)
            gb.addLayer(name + "_bn", BatchNormalization.builder()
                        .activation("identity").build(), name)
            return name + "_bn"

        def pool(name, inp, ptype="AVG", s=1):
            gb.addLayer(name, SubsamplingLayer.builder().poolingType(ptype)
                        .kernelSize(3, 3).stride(s, s).build(), inp)
            return name

        def add(name, a, b):
            gb.addVertex(name, ElementWiseVertex("Add"), a, b)
            return name

        def normal_cell(name, h_prev, h, n, p_stride=1):
            """5 blocks -> 6-way concat; ``p_stride`` 2 right after a
            reduction cell (the skip input still has the pre-reduction
            size: a strided 1x1 conv adjusts it)."""
            p = conv_bn(name + "_adjp", h_prev, n, s=p_stride)
            hh = conv_bn(name + "_adjh", h, n)
            b1 = add(name + "_b1", sep(name + "_b1s5", hh, n, 5),
                     sep(name + "_b1s3", p, n, 3))
            b2 = add(name + "_b2", sep(name + "_b2s5", p, n, 5),
                     sep(name + "_b2s3", p, n, 3))
            b3 = add(name + "_b3", pool(name + "_b3p", hh), p)
            b4 = add(name + "_b4", pool(name + "_b4p1", p),
                     pool(name + "_b4p2", p))
            b5 = add(name + "_b5", sep(name + "_b5s3", hh, n, 3), hh)
            gb.addVertex(name, MergeVertex(), p, b1, b2, b3, b4, b5)
            return name

        def reduction_cell(name, h_prev, h, n):
            """stride-2 towers -> 4-way concat."""
            p = conv_bn(name + "_adjp", h_prev, n)
            hh = conv_bn(name + "_adjh", h, n)
            x1 = add(name + "_x1", sep(name + "_x1a", hh, n, 5, 2),
                     sep(name + "_x1b", p, n, 7, 2))
            x2 = add(name + "_x2", pool(name + "_x2a", hh, "MAX", 2),
                     sep(name + "_x2b", p, n, 7, 2))
            x3 = add(name + "_x3", pool(name + "_x3a", hh, "AVG", 2),
                     sep(name + "_x3b", p, n, 5, 2))
            x4 = add(name + "_x4", pool(name + "_x4a", x1, "AVG", 1), x2)
            x5 = add(name + "_x5", sep(name + "_x5a", x1, n, 3, 1), x3)
            gb.addVertex(name, MergeVertex(), x2, x3, x4, x5)
            return name

        stem = conv_bn("stem", "input", self.stemFilters, 3, 2)
        h_prev, h = stem, stem
        for stage, width in enumerate((filters, filters * 2, filters * 4)):
            if stage:
                red = reduction_cell(f"reduce{stage}", h_prev, h, width)
                h_prev, h = h, red
            for i in range(self.numBlocks):
                cell = normal_cell(f"normal{stage + 1}_{i}", h_prev, h,
                                   width,
                                   p_stride=2 if stage and i == 0 else 1)
                h_prev, h = h, cell
        gb.addLayer("relu_out", ActivationLayer.builder()
                    .activation("relu").build(), h)
        gb.addLayer("avgpool", GlobalPoolingLayer.builder()
                    .poolingType("AVG").build(), "relu_out")
        gb.addLayer("out", OutputLayer.builder("negativeloglikelihood")
                    .nOut(self.numClasses).activation("softmax").build(),
                    "avgpool")
        gb.setOutputs("out")
        return gb


@dataclasses.dataclass
class PixelShuffleLayer(SameDiffLambdaLayer):
    """Sub-pixel upsampling: (b, c·r², h, w) -> (b, c, h·r, w·r) by the
    ``depthToSpace`` op (reference SRGAN's PixelShuffle helper)."""
    blockSize: int = 2

    def preferredFormat(self):
        return "CNN"                 # keep the NCHW map (no FF flatten)

    def defineLayer(self, sd, layerInput):
        return sd._op("depthToSpace", [layerInput],
                      {"blockSize": self.blockSize, "dataFormat": "NCHW"})

    def getOutputType(self, inputType):
        r = self.blockSize
        return InputType.convolutional(inputType.height * r,
                                       inputType.width * r,
                                       inputType.channels // (r * r))


@dataclasses.dataclass
class SRGAN(_GraphZooModel):
    """Super-resolution GAN (reference: zoo/model/SRGAN.java): a residual
    PReLU generator with sub-pixel upsampling and a LeakyReLU conv
    discriminator.  ``init()`` returns the generator,
    ``initDiscriminator()`` the discriminator; SRResNet (Ledig et al.
    2017) is ``numResidualBlocks=16``."""
    inputShape: Tuple[int, int, int] = (3, 24, 24)
    numResidualBlocks: int = 4
    upscaleFactor: int = 4           # two x2 pixel-shuffle stages

    def graphBuilder(self):
        gb = (NeuralNetConfiguration.builder().seed(self.seed)
              .updater(Adam(1e-4)).weightInit("XAVIER")
              .convolutionMode(ConvolutionMode.Same).graphBuilder())
        gb.addInputs("input").setInputTypes(self._it())
        gb.addLayer("stem", ConvolutionLayer.builder().nOut(64)
                    .kernelSize(9, 9).build(), "input")
        gb.addLayer("stem_prelu", PReLULayer.builder().build(), "stem")
        x = "stem_prelu"
        for i in range(self.numResidualBlocks):
            gb.addLayer(f"res{i}_c1", ConvolutionLayer.builder().nOut(64)
                        .kernelSize(3, 3).hasBias(False).build(), x)
            gb.addLayer(f"res{i}_bn1", BatchNormalization.builder().build(),
                        f"res{i}_c1")
            gb.addLayer(f"res{i}_prelu", PReLULayer.builder().build(),
                        f"res{i}_bn1")
            gb.addLayer(f"res{i}_c2", ConvolutionLayer.builder().nOut(64)
                        .kernelSize(3, 3).hasBias(False).build(),
                        f"res{i}_prelu")
            gb.addLayer(f"res{i}_bn2", BatchNormalization.builder().build(),
                        f"res{i}_c2")
            gb.addVertex(f"res{i}", ElementWiseVertex("Add"),
                         f"res{i}_bn2", x)
            x = f"res{i}"
        gb.addLayer("post_conv", ConvolutionLayer.builder().nOut(64)
                    .kernelSize(3, 3).hasBias(False).build(), x)
        gb.addLayer("post_bn", BatchNormalization.builder().build(),
                    "post_conv")
        gb.addVertex("post", ElementWiseVertex("Add"), "post_bn",
                     "stem_prelu")
        x = "post"
        stages = {2: 1, 4: 2}.get(int(self.upscaleFactor))
        if stages is None:
            raise ValueError("upscaleFactor must be 2 or 4")
        for i in range(stages):
            gb.addLayer(f"up{i}_conv", ConvolutionLayer.builder().nOut(256)
                        .kernelSize(3, 3).build(), x)
            gb.addLayer(f"up{i}_shuffle", PixelShuffleLayer(blockSize=2),
                        f"up{i}_conv")
            gb.addLayer(f"up{i}_prelu", PReLULayer.builder().build(),
                        f"up{i}_shuffle")
            x = f"up{i}_prelu"
        gb.addLayer("sr_conv", ConvolutionLayer.builder().nOut(3)
                    .kernelSize(9, 9).activation("tanh").build(), x)
        gb.addLayer("sr", CnnLossLayer.builder("mse").build(), "sr_conv")
        gb.setOutputs("sr")
        return gb

    def init(self, device=None) -> ComputationGraph:
        return ComputationGraph(self.graphBuilder().build(),
                                device=device).init()

    def initDiscriminator(self, device=None) -> MultiLayerNetwork:
        c, h, w = self.inputShape
        b = (NeuralNetConfiguration.builder().seed(self.seed)
             .updater(Adam(1e-4)).weightInit("XAVIER")
             .convolutionMode(ConvolutionMode.Same).list())
        spec = [(64, 1), (64, 2), (128, 1), (128, 2),
                (256, 1), (256, 2), (512, 1), (512, 2)]
        for i, (n, s) in enumerate(spec):
            conv = ConvolutionLayer.builder().nOut(n).kernelSize(3, 3) \
                .stride(s, s)
            if i:
                # conv (identity) -> BN -> leakyrelu, as the reference lays
                # it out
                b.layer(conv.activation("identity").hasBias(False).build())
                b.layer(BatchNormalization.builder()
                        .activation("leakyrelu").build())
            else:
                b.layer(conv.activation("leakyrelu").build())
        b.layer(DenseLayer.builder().nOut(256).activation("leakyrelu")
                .build())
        b.layer(OutputLayer.builder("xent").nOut(1).activation("sigmoid")
                .build())
        conf = b.setInputType(InputType.convolutional(
            h * self.upscaleFactor, w * self.upscaleFactor, c)).build()
        return MultiLayerNetwork(conf, device=device).init()
