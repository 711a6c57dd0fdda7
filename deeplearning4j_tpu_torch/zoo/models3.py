"""Zoo architectures, part 3 — the port of ``deeplearning4j_tpu/zoo/
models3.py``: ``NASNet`` (the reference's ``zoo/model/NASNet.java`` with
``helper/NASNetHelper``'s normal and reduction cells).  ``SRGAN`` and its
``PixelShuffleLayer`` are built on ``SameDiffLambdaLayer``, which waits for
ROADMAP A12b; their names import and building one raises.
"""
from __future__ import annotations

import dataclasses

from deeplearning4j_tpu_torch import unported
from deeplearning4j_tpu_torch.learning.config import Adam
from deeplearning4j_tpu_torch.models.graph_conf import (ElementWiseVertex,
                                                        MergeVertex)
from deeplearning4j_tpu_torch.nn.conf import NeuralNetConfiguration
from deeplearning4j_tpu_torch.nn.conf.convolutional import \
    SeparableConvolution2D
from deeplearning4j_tpu_torch.nn.conf.layers import (ActivationLayer,
                                                     BatchNormalization,
                                                     ConvolutionLayer,
                                                     ConvolutionMode,
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


_NEEDS_SDL = "needs SameDiffLambdaLayer, which is not ported yet"
PixelShuffleLayer = unported("PixelShuffleLayer", "A12b", _NEEDS_SDL)
SRGAN = unported("SRGAN", "A12b", _NEEDS_SDL)
