"""Model zoo (the port of ``deeplearning4j_tpu/zoo``).  So far ``LeNet``,
``ResNet50`` and BERT (``BertConfig``, ``Bert``, ``BertBase``, a SameDiff
graph); the other architectures and the pretrained weights wait for
ROADMAP A9."""
from deeplearning4j_tpu_torch.zoo.bert import (  # noqa: F401
    Bert, BertBase, BertConfig)
from deeplearning4j_tpu_torch.zoo.models import (  # noqa: F401
    LeNet, ResNet50, ZooModel)
