"""Zoo architectures — the port of ``deeplearning4j_tpu/zoo/models.py``
(the reference's ``zoo/model/{LeNet,SimpleCNN,AlexNet,VGG16,ResNet50}.java``:
architectures built with the config DSL).  ``init`` and ``initPretrained``
build the model on ``cuda`` unless the caller passes another device.
``TwoTowerRecommender`` and ``DLRM`` are the recommender tier's models.
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
                                                     LocalResponseNormalization,
                                                     OutputLayer,
                                                     SubsamplingLayer,
                                                     _Builder)

__all__ = ["ZooModel", "LeNet", "SimpleCNN", "AlexNet", "VGG16", "ResNet50",
           "TwoTowerRecommender", "DLRM"]


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
                       path: Optional[str] = None, device=None):
        """Reference: ``ZooModel.initPretrained(PretrainedType)``: the
        checkpoint from the local weight repository
        (``$DL4J_TPU_DATA_DIR/pretrained``) or ``path``, restored onto
        ``device`` (``cuda`` unless the caller passes another).  See
        ``zoo/pretrained.py``."""
        from deeplearning4j_tpu_torch.zoo.pretrained import loadPretrained
        return loadPretrained(self, pretrainedType, path, device)

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
class SimpleCNN(ZooModel):
    """Reference: zoo/model/SimpleCNN.java."""
    numClasses: int = 10
    inputShape: Tuple[int, int, int] = (3, 48, 48)

    def init(self, device=None) -> MultiLayerNetwork:
        b = (NeuralNetConfiguration.builder().seed(self.seed)
             .updater(Adam(1e-3)).weightInit("RELU")
             .convolutionMode(ConvolutionMode.Same).list())
        for nOut in (16, 32, 64):
            b.layer(ConvolutionLayer.builder().nOut(nOut).kernelSize(3, 3)
                    .activation("relu").build())
            b.layer(BatchNormalization.builder().build())
            b.layer(SubsamplingLayer.builder().poolingType("MAX")
                    .kernelSize(2, 2).stride(2, 2).build())
        b.layer(GlobalPoolingLayer.builder().poolingType("AVG").build())
        b.layer(OutputLayer.builder("negativeloglikelihood")
                .nOut(self.numClasses).activation("softmax").build())
        return MultiLayerNetwork(b.setInputType(self._it()).build(),
                                 device=device).init()


@dataclasses.dataclass
class AlexNet(ZooModel):
    """Reference: zoo/model/AlexNet.java (one-tower variant)."""

    def init(self, device=None) -> MultiLayerNetwork:
        c, h, w = self.inputShape
        conf = (NeuralNetConfiguration.builder().seed(self.seed)
                .updater(Nesterovs(1e-2, momentum=0.9)).weightInit("NORMAL")
                .list()
                .layer(ConvolutionLayer.builder().nIn(c).nOut(96)
                       .kernelSize(11, 11).stride(4, 4).activation("relu")
                       .build())
                .layer(LocalResponseNormalization.builder().build())
                .layer(SubsamplingLayer.builder().kernelSize(3, 3)
                       .stride(2, 2).build())
                .layer(ConvolutionLayer.builder().nOut(256).kernelSize(5, 5)
                       .padding(2, 2).activation("relu").build())
                .layer(LocalResponseNormalization.builder().build())
                .layer(SubsamplingLayer.builder().kernelSize(3, 3)
                       .stride(2, 2).build())
                .layer(ConvolutionLayer.builder().nOut(384).kernelSize(3, 3)
                       .padding(1, 1).activation("relu").build())
                .layer(ConvolutionLayer.builder().nOut(384).kernelSize(3, 3)
                       .padding(1, 1).activation("relu").build())
                .layer(ConvolutionLayer.builder().nOut(256).kernelSize(3, 3)
                       .padding(1, 1).activation("relu").build())
                .layer(SubsamplingLayer.builder().kernelSize(3, 3)
                       .stride(2, 2).build())
                .layer(DenseLayer.builder().nOut(4096).activation("relu")
                       .dropOut(0.5).build())
                .layer(DenseLayer.builder().nOut(4096).activation("relu")
                       .dropOut(0.5).build())
                .layer(OutputLayer.builder("negativeloglikelihood")
                       .nOut(self.numClasses).activation("softmax").build())
                .setInputType(self._it()).build())
        return MultiLayerNetwork(conf, device=device).init()


def _vgg(model, reps, device):
    """VGG16 / VGG19: 3x3 SAME convs in five blocks of ``reps`` each, 2x2
    max pools, two dense 4096 and the softmax head."""
    b = (NeuralNetConfiguration.builder().seed(model.seed)
         .updater(Nesterovs(1e-2, momentum=0.9)).weightInit("XAVIER")
         .convolutionMode(ConvolutionMode.Same).list())
    for n, r in zip((64, 128, 256, 512, 512), reps):
        for _ in range(r):
            b.layer(ConvolutionLayer.builder().nOut(n).kernelSize(3, 3)
                    .activation("relu").build())
        b.layer(SubsamplingLayer.builder().poolingType("MAX")
                .kernelSize(2, 2).stride(2, 2).build())
    b.layer(DenseLayer.builder().nOut(4096).activation("relu").build())
    b.layer(DenseLayer.builder().nOut(4096).activation("relu").build())
    b.layer(OutputLayer.builder("negativeloglikelihood")
            .nOut(model.numClasses).activation("softmax").build())
    return MultiLayerNetwork(b.setInputType(model._it()).build(),
                             device=device).init()


@dataclasses.dataclass
class VGG16(ZooModel):
    """Reference: zoo/model/VGG16.java."""

    def init(self, device=None) -> MultiLayerNetwork:
        return _vgg(self, (2, 2, 3, 3, 3), device)


class _GraphZooModel(ZooModel):
    """A zoo model that is a ComputationGraph of its ``graphBuilder``."""

    def init(self, device=None) -> ComputationGraph:
        return ComputationGraph(self.graphBuilder().build(),
                                device=device).init()


@dataclasses.dataclass
class ResNet50(_GraphZooModel):
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


@dataclasses.dataclass
class TwoTowerRecommender(ZooModel):
    """Two-tower retrieval model over a shared hashed-id embedding table
    (the recommender tier): the user-feature bag and the item-feature bag
    pool through ONE ``ShardedEmbeddingBag``, scored by the dot-product
    affinity head with binary cross-entropy.  Input: (b, 2*bagSize)
    float-encoded hashed ids — user bag | item bag; labels (b, 1)
    click/no-click.  Serve with ``RetrievalLM.from_two_tower(net)``."""
    numClasses: int = 1
    numEmbeddings: int = 8192
    embeddingDim: int = 16
    bagSize: int = 16

    def init(self, device=None) -> MultiLayerNetwork:
        from deeplearning4j_tpu_torch.models.recsys import DotProductScorer
        from deeplearning4j_tpu_torch.nn.conf.embedding import \
            ShardedEmbeddingBag
        conf = (NeuralNetConfiguration.builder().seed(self.seed)
                .updater(Adam(1e-3)).weightInit("XAVIER")
                .list()
                .layer(ShardedEmbeddingBag.builder()
                       .numEmbeddings(self.numEmbeddings)
                       .embeddingDim(self.embeddingDim)
                       .numFields(2).build())
                .layer(DotProductScorer.builder()
                       .embeddingDim(self.embeddingDim).build())
                .setInputType(InputType.feedForward(2 * self.bagSize))
                .build())
        return MultiLayerNetwork(conf, device=device).init()


@dataclasses.dataclass
class DLRM(ZooModel):
    """DLRM-style ranking model (the recommender tier): embedding bags per
    categorical field, pairwise-dot feature interaction, dense MLP head
    (no bottom MLP: the reference's zoo model has none).  Input:
    (b, numFields*bagSize) hashed ids; labels (b, numClasses) one-hot."""
    numClasses: int = 2
    numEmbeddings: int = 8192
    embeddingDim: int = 16
    numFields: int = 4
    bagSize: int = 8
    denseUnits: Tuple[int, ...] = (64, 32)

    def init(self, device=None) -> MultiLayerNetwork:
        from deeplearning4j_tpu_torch.models.recsys import \
            FeatureInteractionLayer
        from deeplearning4j_tpu_torch.nn.conf.embedding import \
            ShardedEmbeddingBag
        b = (NeuralNetConfiguration.builder().seed(self.seed)
             .updater(Adam(1e-3)).weightInit("XAVIER")
             .list()
             .layer(ShardedEmbeddingBag.builder()
                    .numEmbeddings(self.numEmbeddings)
                    .embeddingDim(self.embeddingDim)
                    .numFields(self.numFields).build())
             .layer(FeatureInteractionLayer.builder()
                    .numFields(self.numFields).build()))
        for nOut in self.denseUnits:
            b.layer(DenseLayer.builder().nOut(nOut)
                    .activation("relu").build())
        conf = (b.layer(OutputLayer.builder("mcxent")
                        .nOut(self.numClasses).activation("softmax")
                        .build())
                .setInputType(InputType.feedForward(
                    self.numFields * self.bagSize))
                .build())
        return MultiLayerNetwork(conf, device=device).init()
